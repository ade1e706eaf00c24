"""Ray-axis data parallelism over torch.distributed (PyTorch).

Counterpart of startrax/parallel/mesh.py. startrax runs one process over a
1-D device mesh: it shards the batch's ray keys, replicates everything else,
and XLA's psum makes the sharded step the same computation as the unsharded
one. The port runs one process a rank and keeps that meaning: an N-rank step
computes the one-process step on the global batch, up to float summation
order. Each rank's loss is its share of the global loss (train.loop), the
optimizer all-reduces the concatenated grads (train.optim), the random draws
are made at the global batch shape and sliced (models.star), and the eval
tiles are split over the ranks and all-gathered (eval.render).

The backend rule: ``nccl`` when each rank has a card of its own (rank r of a
node takes cuda:LOCAL_RANK; fewer cards than local ranks raises); ``gloo``
only where the caller names it, on the CPU or for several ranks on one card
(NCCL refuses two ranks on one device). A process group that the launcher
has already made is used as it is. Every process group is made with a
timeout, so a collective that hangs fails instead of waiting for ever.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve
from ..utils.tree import tree_leaves

RAY_AXIS = "rays"

# Batch keys whose leading axis is the ray axis. Sharding is decided by key,
# not by shape: a divisibility rule would ray-shard any replicated table whose
# leading dim happens to be divisible by the world size (a [K, ...] or
# [F, ...] pose table).
RAY_SHARDED_KEYS = frozenset({
    "rays_o", "rays_d", "target", "target_depth", "radii", "mask",
    "frame",  # per-ray frame indices of mixed-frame batches ([N]); a
              # scalar frame (ndim 0) stays whole
    "viewdirs", "car_mask",
})

# seconds a collective may wait before it fails
COLLECTIVE_TIMEOUT = 300.0


@dataclasses.dataclass(frozen=True)
class RayGroup:
    """One process's handle on the ray axis: its rank, the world size, the
    device its tensors live on and the backend of the default process
    group."""

    rank: int
    world: int
    device: torch.device
    backend: str

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` (equal shapes) concatenated along axis 0 in rank
        order, on every rank."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t)
        return torch.cat(parts, dim=0)

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (picklable) on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def barrier(self) -> None:
        dist.barrier()


def _check_nccl_cards(local_world: int) -> None:
    n = torch.cuda.device_count()
    if n < local_world:
        raise RuntimeError(f"nccl needs a card a rank: this node runs {local_world} ranks and "
                           f"has {n} CUDA devices (name the gloo backend to share a card)")


def init_ray_group(backend: Optional[str] = None, device=None, rank: Optional[int] = None,
                   world: Optional[int] = None, init_method: Optional[str] = None,
                   timeout: float = COLLECTIVE_TIMEOUT) -> RayGroup:
    """The ray group of this process. When a default process group exists it
    is used as it is (its backend; ``backend`` must be None or the same);
    otherwise one is made with ``backend`` (None: nccl), ``rank`` and
    ``world`` (None: the launcher's RANK and WORLD_SIZE), ``init_method``
    (None: env://) and a timeout of ``timeout`` seconds. Under nccl the
    device is cuda:LOCAL_RANK, made current (``device`` must be None or
    that device); under gloo it is ``device`` (None: the card,
    device.resolve)."""
    if dist.is_initialized():
        have = dist.get_backend()
        if backend is not None and backend != have:
            raise ValueError(f"the process group's backend is {have}, not {backend}")
        backend, rank, world = have, dist.get_rank(), dist.get_world_size()
    else:
        backend = backend or "nccl"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world = int(os.environ["WORLD_SIZE"]) if world is None else world
    if backend == "nccl":
        _check_nccl_cards(int(os.environ.get("LOCAL_WORLD_SIZE", world)))
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        if device is not None and torch.device(device) != dev:
            raise ValueError(f"under nccl this rank's device is {dev}, not {device}")
        torch.cuda.set_device(dev)
    elif backend == "gloo":
        dev = resolve(device)
    else:
        raise ValueError(f"backend must be nccl or gloo, got {backend}")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world, timeout=timedelta(seconds=timeout))
    return RayGroup(rank=rank, world=world, device=dev, backend=backend)


def shard_batch(batch: Dict[str, Any], group: RayGroup, extra_ray_keys=()) -> Dict[str, Any]:
    """This rank's part of a host batch: keys in RAY_SHARDED_KEYS (plus
    extra_ray_keys) give their contiguous slice of axis 0, rank r rows
    [r n / W, (r + 1) n / W); everything else (scalars, pose tables, aux
    arrays of any shape) stays whole. Values keep their type (numpy arrays
    or tensors)."""
    ray_keys = RAY_SHARDED_KEYS | frozenset(extra_ray_keys)

    def place(key, x):
        if key not in ray_keys or np.ndim(x) < 1:
            return x
        n = x.shape[0]
        if n % group.world != 0:
            raise ValueError(f"batch[{key!r}] leading dim {n} not divisible by the world size "
                             f"{group.world} (pad with pad_rays_to_multiple)")
        m = n // group.world
        return x[group.rank * m:(group.rank + 1) * m]

    return {k: place(k, v) for k, v in batch.items()}


def replicate_params(params, group: RayGroup):
    """Every leaf of ``params`` set to rank 0's, bit for bit, in place (one
    broadcast a leaf); returns params."""
    with torch.no_grad():
        for leaf in tree_leaves(params):
            dist.broadcast(leaf.data, src=0)
    return params


def params_spread(params, group: RayGroup) -> float:
    """The largest absolute difference between any rank's parameters and
    rank 0's (0.0 when every rank holds the same values): one all-gather of
    the flattened leaves."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tree_leaves(params)])
    gathered = group.all_gather_rows(flat[None])
    return float((gathered - gathered[0]).abs().max())


def pad_rays_to_multiple(n_rays: int, n_devices: int, tile: int = 8) -> int:
    """Smallest ray count >= n_rays divisible by n_devices * tile."""
    m = n_devices * tile
    return ((n_rays + m - 1) // m) * m


def _rank_main(fn, rank, world, backend, init_method, device, timeout, args, results):
    try:
        group = init_ray_group(backend, device, rank=rank, world=world,
                               init_method=init_method, timeout=timeout)
        if group.device.type == "cpu":
            # ranks are processes: one thread each keeps them off each other
            torch.set_num_threads(1)
        try:
            out = fn(group, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, backend: str, args: Sequence = (), device=None,
              timeout: float = COLLECTIVE_TIMEOUT, join_timeout: float = 600.0) -> list:
    """fn(group, *args) in ``world`` spawned processes, one a rank, over a
    process group of ``backend`` (nccl, or gloo on ``device``) that meets
    through a file in a temporary directory and whose collectives time out
    after ``timeout`` seconds. fn must be importable (a module-level
    function) and its result picklable. Returns the ranks' results in rank
    order. Raises RuntimeError with the traceback of the first rank that
    failed, and TimeoutError when the ranks have not all answered within
    ``join_timeout`` seconds; either way every process is ended."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="startrax_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, backend, init_method,
                                                      device, timeout, tuple(args), results))
                 for r in range(world)]
        for p in procs:
            p.start()
        done: Dict[int, Any] = {}
        deadline = time.monotonic() + join_timeout
        try:
            while len(done) < world:
                try:
                    rank, ok, out = results.get(timeout=max(deadline - time.monotonic(), 0.01))
                except queue.Empty:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(done))} did not "
                                       f"answer within {join_timeout} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
                done[rank] = out
        finally:
            for p in procs:
                p.join(timeout=10.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [done[r] for r in range(world)]

"""The fused-MLP kernels' weight ring and its producer warp, read from the
CUDA source on the CPU.

``fwd_kernel`` and ``bwd_kernel`` run NT consumer threads and one producer
warp, which copies the weight chunks into the ring and then leaves
(csrc/fused_mlp.cu). A block barrier over all threads after it has left
would wait for threads that never come, so every barrier of the consumers
is the named barrier over NT threads; the only block barrier of each kernel
is the one before the producer warp leaves. These tests hold the source to
that, and the launches to the producer's extra warp.
"""

import os
import re

import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "startrax_torch",
                   "kernels", "csrc", "fused_mlp.cu")


def _source():
    with open(SRC) as fp:
        src = fp.read()
    # the fused kernels' part: before the weight-gradient GEMM
    return src, src[:src.index("// (B) The weight-gradient GEMM")]


def _body(src, name):
    """The text of __global__ function `name`, from its signature to its
    closing brace at column 0."""
    start = re.search(rf"__global__ void [^\n]*\b{name}\(", src).start()
    return src[start:src.index("\n}\n", start)]


@pytest.mark.parametrize("kernel", ["fwd_kernel", "bwd_kernel"])
def test_one_block_barrier_before_the_producer_warp_leaves(kernel):
    _, fused = _source()
    body = _body(fused, kernel)
    leave = body.index("    ring_produce(ring);\n    return;\n")
    assert body.count("__syncthreads()") == 1
    assert body.index("__syncthreads()") < leave
    assert "if (tid >= NT) {" in body[:leave]


def test_the_fused_kernels_helpers_use_the_consumers_barrier():
    """Outside the two kernels' prologues, the fused part of the source has
    no block barrier: tile_sync and every consumer barrier is bar.sync 1
    over NT threads, an id no other barrier uses."""
    _, fused = _source()
    calls = [m.start() for m in re.finditer(r"__syncthreads\(\);", fused)]
    assert len(calls) == 2
    assert re.search(r"void consumer_sync\(\) \{ bar_sync\(1, NT\); \}", fused)
    tile_sync = fused[fused.index("void tile_sync()"):]
    assert tile_sync[:tile_sync.index("\n}\n")].count("consumer_sync();") == 1
    ids = re.findall(r"\bbar_sync\((?!int )([^,]+),", fused)
    assert sorted(set(ids)) == ["1", "5 + wg"]


@pytest.mark.parametrize("kernel", ["fwd_kernel", "bwd_kernel"])
def test_the_fused_launches_add_the_producer_warp(kernel):
    src, fused = _source()
    assert re.search(r"constexpr int NP = 32;", src)
    assert re.search(rf"__launch_bounds__\(NT \+ NP, 1\) {kernel}\(", fused)
    launches = re.findall(r"kernel<<<grid, ([^,]+), smem", src)
    assert launches == ["NT + NP", "NT + NP"]


def test_the_producer_waits_for_every_consumer_warp():
    """A slot's "empty" barrier counts one arrival a consumer warp; the
    producer waits on it one round of NSLOT chunks back, and a consumer
    arrives on it once a chunk, after its wgmma has retired."""
    _, fused = _source()
    assert 'mbarrier.init.shared::cta.b64 [%0], %1;\\n" ::"r"(smem_u32(&r->empty[s])), "r"(NT / 32)' in fused
    produce = fused[fused.index("void ring_produce(Ring* r)"):]
    produce = produce[:produce.index("\n}\n")]
    assert "if (g >= NSLOT) mbar_wait(&r->empty[slot], (g / NSLOT - 1) & 1);" in produce
    core = fused[fused.index("__device__ void gemm_core("):]
    core = core[:core.index("\n}\n")]
    assert core.index("wgmma.wait_group.sync.aligned 0;") < core.index("release(f, g);")

#!/usr/bin/env python3
"""Two trees' fused-MLP kernels side by side on one card: ptxas resources and
times of the raw-point instances.

    python3 scripts/torch_kernel_ab.py PARENT_ROOT [CHANGE_ROOT] [--json PATH]
    python3 scripts/torch_kernel_ab.py --variants [PARENT_ROOT] [--json PATH]

PARENT_ROOT and CHANGE_ROOT (default: this checkout) are roots of two
checkouts of the repository, for example the parent commit unpacked with
``git archive`` into ``runs/parent``. The script

1. compiles each tree's ``startrax_torch/kernels/csrc/fused_mlp.cu`` with
   ``-Xptxas -v`` to a cubin (both at once) and prints every kernel
   instance's registers, stack frame and spills;
2. disassembles both cubins with ``cuobjdump -sass`` and says, for each
   kernel instance the two trees share (the one-field and field-axis
   instances on raw points, the weight-gradient GEMM at a width that is a
   multiple of 64, the partial sums), whether its machine code is the same
   instruction for instruction (the weight-gradient GEMM and the sums
   were rebuilt, so their instances differ by name or code);
3. times each tree in its own process, in turns (parent, change, change,
   parent, twice over), every instance of the fused kernels at its path's
   shapes: the per-field kernels at the shared-pose step's shapes
   (chip_smoke phase 3: static 8x256 and dynamic 4x256 with the warp, on
   256,000 and 512,000 points) and at the online app's (phase 3d); the
   field-axis kernels at the per-ray step's (phase 3b: K = 2 dynamic 4x128
   fields on 131,072 and 262,144 points per field); the pre-encoded
   kernels at the nerf_time step's coarse and fine calls (phase 5) and the
   field-axis pre-encoded ones at phase 3e's (K = 2, input grads); the
   occgrid app's static field at budget 128 (4,096 rays x 128 samples,
   random points along bench-style rays) and the grid update's forward
   (one point a cell of the 128^3 grid, under no_grad; phase 9a). The
   forward runs with grad on, saving its activations as a training step
   does; the backward is one ``torch.autograd.grad`` of the parity
   cotangent. CUDA events over 10 launches after one warm-up; and the
   device time of the same calls, the sum of their kernels' times in a
   torch.profiler trace of 3 launches (``fwd_device``, ``bwd_device``),
   which host gaps between launches do not reach: a backward whose kernels
   finish before the host has queued the next ones reads the host's pace
   on the events, not the card's;
4. in the same processes, each tree's chip_smoke phase 3c (``parts``): the
   weight-gradient GEMM's and the ordered sums' times summed over one
   shared-pose step's calls, with their plain versions' and the library
   yardsticks' (torch.mm, torch.sum) in the same process;
5. then chip_smoke's three training steps (``step_times``: shared-pose,
   per-ray joint, nerf_time), each the median of event-timed steps and one
   step's device time, with the device time and launches of its
   ``wgrad_kernel`` and ``sum_rows_kernel`` in that step, so that a step's
   change is read against the parent on one machine, its host included.

It prints one line per process and, with ``--json PATH``, writes every
reading to PATH.

With ``--variants``, it times variants of this checkout's source against
the source itself (and PARENT_ROOT's, when given): the readings behind the
kernels' design choices. Each variant is a list of text substitutions
(``VARIANTS``; an anchor that does not occur as often as the table says
raises). Some are alternatives that compute the same thing; the ones named
"ablation" drop work and give wrong results, so the time they save is what
that work costs. All copies are built at once into a temporary directory
outside the checkout (``torch_cu_copies.py``); each is loaded in a process
of its own in place of the library, and ``fwd_kernel`` and ``bwd_kernel``
are timed by device time (a trace of 5 calls, by kernel name) on the
static field calls of the shared-pose step (8x256, fine: 512,000 points)
and of the online app's (8x128, coarse and fine: 131,072 and 262,144
points), with grad on as a step runs them. The builds run in turns: each
once in order, then again in the reverse order; it prints each build's
mean a case.

Needs one CUDA card and nvcc.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

import torch_cu_copies as cu_copies

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join("startrax_torch", "kernels", "csrc", "fused_mlp.cu")
CUBIN_DIR = os.path.join(HERE, "runs", "ptxas")
REPS = 10
STEPS, STEP_WARMUP = 14, 4
ORDER = ("parent", "change", "change", "parent") * 2

# --variants: name -> [(text to find, its replacement, how many times it occurs), ...]
VARIANTS = {
    "saved rows by 16-byte stores at every width": [
        ("  if (cols < 256) {\n    strip_sync(wr);", "  if (true) {\n    strip_sync(wr);", 1)],
    "saved rows by bulk copies at every width": [
        ("  if (cols < 256) {\n    strip_sync(wr);", "  if (false) {\n    strip_sync(wr);", 1)],
    "the epilogue passed by reference": [
        ("__device__ void gemm_core(const Seg* segs, int nseg, Feed& f, const Epi epi) {",
         "__device__ void gemm_core(const Seg* segs, int nseg, Feed& f, const Epi& epi) {", 1),
        ("int nout, Feed& f, const Epi epi) {", "int nout, Feed& f, const Epi& epi) {", 1)],
    "a block barrier in place of the strip barrier": [
        ("__device__ __forceinline__ void strip_sync(int wr) { bar_sync(1 + wr, 64); }",
         "__device__ __forceinline__ void strip_sync(int wr) { asm volatile(\"bar.sync 0;\" ::: \"memory\"); }",
         1)],
    "ablation: no column sums": [
        ("  halve_xor<M / 2>(v, 16);\n", "  if (v) return;\n  halve_xor<M / 2>(v, 16);\n", 1)],
    "ablation: no saved rows written": [
        ("  if (cols < 256) {\n    strip_sync(wr);",
         "  if (cols) {\n    strip_sync(wr);\n    return;\n  }\n  if (cols < 256) {\n    strip_sync(wr);", 1)],
}
VARIANT_CASES = (("carla_star_online_multi.txt", 1), ("synthetic_star_online.txt", 0),
                 ("synthetic_star_online.txt", 1))  # (config, index into chip_smoke.kernel_cases)


def ptxas(roots):
    """Each tree's kernel instances -> (registers, stack bytes, spill
    stores, spill loads), compiled at once."""
    from startrax_torch.kernels.build import NVCC_FLAGS, _nvcc

    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    os.makedirs(CUBIN_DIR, exist_ok=True)
    procs = [subprocess.Popen([_nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
                               os.path.join(CUBIN_DIR, f"{i}.cubin"), os.path.join(r, SRC)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i, r in enumerate(roots)]
    result = []
    for p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(text)
        kernels, name = {}, None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name:
                kernels.setdefault(name, {}).update(stack=int(m.group(1)),
                                                    spill_st=int(m.group(2)),
                                                    spill_ld=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                kernels.setdefault(name, {})["registers"] = int(m.group(1))
        result.append(kernels)
    return result


def _instance(mangled):
    """A kernel's mangled name -> a name shared by both trees' instances of
    it: fwd<0> and fwd<1> for the one-field and field-axis raw-point
    forward (template <bool STACKED> in a tree without the pre-encoded mode,
    <bool STACKED, bool ENC = false> in one with it), fwd<0,enc> for the
    pre-encoded one, wgrad and wgrad<ktail>, sum_rows."""
    m = re.search(r"(fwd|bwd)_kernelILb([01])E(?:Lb([01])E)?", mangled)
    if m:
        return f"{m.group(1)}<{m.group(2)}{',enc' if m.group(3) == '1' else ''}>"
    if "wgrad_kernel" in mangled:
        return "wgrad<ktail>" if "wgrad_kernelILb1E" in mangled else "wgrad"
    return "sum_rows" if "sum_rows_kernel" in mangled else mangled


def sass(cubin):
    """{instance: its SASS instructions, without addresses and encodings}."""
    from startrax_torch.kernels.build import _nvcc

    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _instance(m.group(1))
            funcs[name] = []
            continue
        ins = re.sub(r"/\*.*?\*/", "", line).strip()
        if name and ins and not ins.startswith("."):
            funcs[name].append(ins)
    return funcs


def device_ms(fn, reps=3, by_name=()):
    """Mean device time of fn's kernels, from a torch.profiler trace; with
    by_name, also {name: (ms, launches)} a call of the kernels whose names
    contain it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    total = sum(e.self_device_time_total for e in events) / 1e3 / reps
    if not by_name:
        return total
    return total, {name: (sum(e.self_device_time_total for e in events if name in e.key) / 1e3 / reps,
                          sum(e.count for e in events if name in e.key) / reps)
                   for name in by_name}


def once(root):
    """Times one tree's kernels (run in a process of its own)."""
    import importlib.util

    import torch

    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from startrax_torch.kernels import fused_mlp as fm, parity
    from startrax_torch.utils import config as port_config

    def star(name):
        cfg = port_config.Config(**port_config.parse_config_file(
            os.path.join(root, "startrax", "configs", name)))
        return cfg, port_config.star_config_from(cfg)

    torch.backends.cuda.matmul.allow_tf32 = False
    fm.build()
    flag_cfg, flag = star("carla_star_online_multi.txt")
    slice_cfg, slice_star = star("synthetic_star_online_scaled.txt")
    import dataclasses

    slice_star = dataclasses.replace(slice_star, end_barf=-1)
    cases = []
    for i, case in enumerate(cs.kernel_cases(flag, flag_cfg.N_rand)[:4]):
        cases.append((f"{case[0]} {case[1].depth}x{case[1].width} N={case[2]}",
                      cs.case_inputs(flag, case, i), False))
    for i, case in enumerate(cs.stacked_cases(slice_star, slice_cfg.N_rand, flag,
                                              flag_cfg.N_rand)[:2]):
        cases.append((f"stacked {case[0]} K=2 {case[1].depth}x{case[1].width} "
                      f"N={case[2] * case[3]}/field", cs.stacked_case_inputs(slice_star, case, i),
                      True))
    on_cfg, on_star = star(cs.ONLINE_CONFIG)
    on_star = dataclasses.replace(on_star, end_barf=-1)
    for i, case in enumerate(cs.kernel_cases(on_star, on_cfg.N_rand)[:4]):
        cases.append((f"online {case[0]} {case[1].depth}x{case[1].width} N={case[2]}",
                      cs.case_inputs(on_star, case, 20 + i), False))
    nt_cfg, nt_star = star("carla_nerf_time.txt")
    for i, case in enumerate(cs.nerf_time_cases(nt_star, nt_cfg.N_rand)[:2]):
        cases.append((f"nerf_time {case[0]} {case[1].depth}x{case[1].width} N={case[2]}",
                      cs.nerf_time_case_inputs(nt_star, case, i, nt_cfg.num_frames), False))
    for i, (name, fcfg, n_points, _) in enumerate(cs.stacked_enc_cases(nt_star, nt_cfg.N_rand)[:2]):
        cases.append((f"stacked pre-encoded {name} K={cs.STACKED_ENC_K} {fcfg.depth}x{fcfg.width} "
                      f"N={n_points}/field",
                      cs.stacked_enc_inputs(nt_star, fcfg, n_points, i, nt_cfg.num_frames), True))
    from startrax_torch.apps import occgrid_init

    occ_cfg = port_config.Config(**port_config.parse_config_file(
        os.path.join(root, "startrax", "configs", cs.OCC_CONFIG)))
    occ_field = occgrid_init.field_config(occ_cfg)
    x, d = cs._points(4096 * 128, occ_cfg.near, occ_cfg.far, seed=77)
    cases.append((f"occgrid budget 128 {occ_field.depth}x{occ_field.width} N={x.shape[0]}",
                  {"params": cs._field(occ_field, seed=78), "x": x, "d": d,
                   "n_blocks": occ_field.n_blocks, "pe": (occ_field.multires, occ_field.multires_views),
                   "pe_masks": None, "warp": None}, False))
    times = {}
    for label, inp, stacked in cases:
        _, run = parity.compare(**inp, stacked=stacked)

        def fwd():
            if stacked:
                return fm.fused_stacked_apply(inp["params"], inp["x"], inp["d"], inp["n_blocks"],
                                              inp["pe"], pe_masks=inp["pe_masks"])
            return fm.fused_field_apply(inp["params"], inp["x"], inp["d"], inp["n_blocks"],
                                        inp["pe"], pe_masks=inp["pe_masks"], warp=inp["warp"])

        def bwd():
            return torch.autograd.grad(run["out_k"], run["leaves"], run["cot"], retain_graph=True)

        times[label] = {"fwd": cs._cuda_ms(fwd, REPS), "bwd": cs._cuda_ms(bwd, REPS),
                        "fwd_device": device_ms(fwd), "bwd_device": device_ms(bwd)}
        del run
        torch.cuda.empty_cache()
    times.update(grid_update(cs, fm, occ_cfg, occ_field))
    parts = cs.phase_backward_parts(cs.backward_part_cases(
        flag, flag_cfg.N_rand, on_star, on_cfg.N_rand, slice_star, slice_cfg.N_rand, nt_star,
        nt_cfg.N_rand, port_config.star_config_from(occ_cfg).static_field()))
    parts = {k: {key: v[key] for key in ("ms", "plain_ms", "library_ms")} for k, v in parts.items()}
    torch.cuda.empty_cache()
    steps = step_times(cs, (flag_cfg, flag), (slice_cfg, slice_star), (nt_cfg, nt_star))
    print(json.dumps({"root": root, "times": times, "parts": parts, "steps": steps}), flush=True)


def grid_update(cs, fm, occ_cfg, field_cfg):
    """chip_smoke phase 9a's grid update: the occgrid field's forward on one
    jittered point a cell of the grid, along (0, 0, -1), under no_grad
    (nothing saved); its events and device time."""
    import torch

    from startrax_torch.apps import occgrid_init
    from startrax_torch.kernels import occgrid

    grid_cfg = occgrid_init.occgrid_config(occ_cfg)
    g = torch.Generator(device="cuda").manual_seed(79)
    centers = occgrid._cell_centers(grid_cfg, "cuda")
    cell = (grid_cfg.aabb_max[0] - grid_cfg.aabb_min[0]) / grid_cfg.resolution
    x = (centers + (torch.rand(centers.shape, generator=g, device="cuda") - 0.5) * cell)
    x = x.reshape(-1, 3).contiguous()
    d = x.new_tensor([[0.0, 0.0, -1.0]]).expand(x.shape[0], 3).contiguous()
    params = cs._field(field_cfg, seed=79)
    pe = (field_cfg.multires, field_cfg.multires_views)

    def fwd():
        with torch.no_grad():
            return fm.fused_field_apply(params, x, d, field_cfg.n_blocks, pe)

    label = f"occgrid grid update fwd {field_cfg.depth}x{field_cfg.width} N={x.shape[0]} (no_grad)"
    out = {label: {"fwd": cs._cuda_ms(fwd, REPS), "fwd_device": device_ms(fwd)}}
    del x, d, params, centers
    torch.cuda.empty_cache()
    return out


def step_times(cs, flag, per_ray, nerf_time):
    """chip_smoke's three training steps on their fixed batches, each
    (Config, StarConfig): the shared-pose online step (phase 4), the per-ray
    joint step (phase 4b, accumulation as configured) and the nerf_time step
    (phase 5). For each, the median of STEPS event-timed steps after
    STEP_WARMUP, and the device time of one more step (device_ms), whose gap
    to the median is host time the card waits for."""
    import torch

    from startrax_torch.models.nerf_time import init_nerf_time
    from startrax_torch.train import loop, optim
    from startrax_torch.utils.config import loss_config_from
    from startrax_torch.utils.tree import tree_leaves

    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}

    def timed(name, step, *args, **kw):
        _, ms = cs._timed_steps(step, STEPS, *args, **kw)
        dev, kernels = device_ms(lambda: step(*args, **kw), 1, ("wgrad_kernel", "sum_rows_kernel"))
        out[name] = {"step": statistics.median(ms[STEP_WARMUP:]), "step_device": dev,
                     **{f"{k}_device": v[0] for k, v in kernels.items()},
                     **{f"{k}_launches": v[1] for k, v in kernels.items()}}
        torch.cuda.empty_cache()

    cfg, star = flag
    params, _, step = cs._online(star, loss_config_from(cfg), cfg, seed=0)
    timed("shared-pose step", step, params, cs._batch(cfg.N_rand), epoch=0, generator=gen)
    cfg, star = per_ray
    params, opt = cs._per_ray_online(cfg, star, seed=4)
    timed("per-ray joint step", loop.make_online_train_step(star, loss_config_from(cfg), opt),
          params, cs._batch(cfg.N_rand, cfg.num_frames, star.near, star.far), epoch=cfg.end_barf,
          generator=gen)
    cfg, star = nerf_time
    params = init_nerf_time(star, generator=torch.Generator(device="cuda").manual_seed(5),
                            device="cuda")
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt = optim.make_appinit_optimizer(params, cfg.lrate, steps_per_epoch=cfg.steps_per_epoch,
                                       decay_rate=cfg.lrate_decay_rate, decay_epochs=cfg.lrate_decay,
                                       decay_milestones=cfg.lrate_decay_steps)
    timed("nerf_time step", loop.make_nerf_time_train_step(star, loss_config_from(cfg), opt,
                                                            cfg.num_frames),
          params, cs._batch(cfg.N_rand), generator=gen)
    return out


def variant_once(so):
    """fwd_kernel's and bwd_kernel's device ms on each of VARIANT_CASES with
    the library so in place of this checkout's (run in a process of its
    own)."""
    import dataclasses
    import importlib.util

    import torch

    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from startrax_torch.kernels import fused_mlp as fm
    from startrax_torch.utils.config import Config, parse_config_file, star_config_from

    torch.backends.cuda.matmul.allow_tf32 = False
    cu_copies.load_in_place(so)
    out = {}
    for name, index in VARIANT_CASES:
        cfg = Config(**parse_config_file(os.path.join(HERE, "startrax", "configs", name)))
        star = dataclasses.replace(star_config_from(cfg), end_barf=-1)
        case = cs.kernel_cases(star, cfg.N_rand)[index]
        inp = cs.case_inputs(star, case, 20 + index)
        leaves = list(fm.flatten_params(inp["params"], inp["n_blocks"]))

        def fwd():
            a, r = fm.fused_field_apply(inp["params"], inp["x"], inp["d"], inp["n_blocks"], inp["pe"],
                                        pe_masks=inp["pe_masks"], warp=inp["warp"])
            return torch.sin(a).sum() + (r * r).sum()

        loss = fwd()
        _, f = device_ms(fwd, 5, ("fwd_kernel",))
        _, b = device_ms(lambda: torch.autograd.grad(loss, leaves, retain_graph=True), 5,
                         ("bwd_kernel",))
        label = f"{case[0]} {case[1].depth}x{case[1].width} N={case[2]}"
        out[label] = {"fwd_kernel": f["fwd_kernel"][0], "bwd_kernel": b["bwd_kernel"][0]}
        del loss
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def variants(parent, report):
    """The --variants mode: every variant, this checkout's source and
    parent's (when not None) timed in turns; their readings and means go
    into report."""
    with open(os.path.join(HERE, SRC)) as fp:
        src = fp.read()
    texts = {}
    if parent:
        with open(os.path.join(parent, SRC)) as fp:
            texts["parent"] = fp.read()
    texts["this checkout"] = src
    texts.update((name, cu_copies.substitute(src, edits, f"variant {name!r}"))
                 for name, edits in VARIANTS.items())
    runs = {name: [] for name in texts}
    with tempfile.TemporaryDirectory(prefix="stx_variants_") as out_dir:
        libs = cu_copies.build(texts, out_dir)
        for name in list(texts) + list(reversed(texts)):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--variant-once",
                                  libs[name]], capture_output=True, text=True, cwd=HERE)
            if out.returncode != 0:
                raise RuntimeError(f"{name}: the run failed:\n{out.stderr[-2000:]}")
            runs[name].append(json.loads(out.stdout.strip().splitlines()[-1]))
    report.update(runs=runs, means={})
    for name, readings in runs.items():
        means = {label: {k: statistics.mean(r[label][k] for r in readings) for k in readings[0][label]}
                 for label in readings[0]}
        report["means"][name] = means
        print(f"{name}: " + "; ".join(f"{label} fwd {v['fwd_kernel']:.4f} bwd {v['bwd_kernel']:.4f} ms"
                                      for label, v in means.items()), flush=True)


def write_json(report, json_path):
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
        with open(json_path, "w") as fp:
            json.dump(report, fp, indent=1)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--once":
        once(os.path.abspath(sys.argv[2]))
        return 0
    if len(sys.argv) > 2 and sys.argv[1] == "--variant-once":
        variant_once(sys.argv[2])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    json_path = None
    if "--json" in args:
        i = args.index("--json")
        json_path = args[i + 1]
        del args[i:i + 2]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    if "--variants" in args:
        args.remove("--variants")
        sys.path.insert(0, HERE)
        report = {"card": card}
        variants(os.path.abspath(args[0]) if args else None, report)
        write_json(report, json_path)
        return 0
    parent = os.path.abspath(args[0])
    change = os.path.abspath(args[1]) if len(args) > 1 else HERE
    sys.path.insert(0, change)
    report = {"card": card, "ptxas": {}, "same_sass": {}}
    for tree, kernels in zip(("parent", "change"), ptxas([parent, change])):
        report["ptxas"][tree] = {_instance(k): v for k, v in kernels.items()}
        for name, r in sorted(report["ptxas"][tree].items()):
            print(f"ptxas {tree} {name}: {r}", flush=True)
    code = [sass(os.path.join(CUBIN_DIR, f"{i}.cubin")) for i in range(2)]
    for name in sorted(set(code[0]) & set(code[1])):
        same = code[0][name] == code[1][name]
        report["same_sass"][name] = same
        print(f"sass {name}: {len(code[0][name])} and {len(code[1][name])} instructions, "
              f"{'the same' if same else 'different'}", flush=True)
    runs = []
    for tree in ORDER:
        root = parent if tree == "parent" else change
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--once", root],
                             capture_output=True, text=True, cwd=root)
        if out.returncode != 0:
            raise RuntimeError(f"{tree} run failed:\n{out.stdout}\n{out.stderr}")
        line = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append({"tree": tree, "times": line["times"], "parts": line["parts"],
                     "steps": line["steps"]})
        print(f"{tree}: " + "; ".join(f"{k} " + ", ".join(f"{side} {v[side]:.3f}" for side in v)
                                      for k, v in line["times"].items())
              + "; " + "; ".join(f"{k} {v['step']:.3f} ms (device {v['step_device']:.3f})"
                                 for k, v in line["steps"].items()), flush=True)
    report["runs"] = runs
    for key, sides in (("times", ("fwd", "bwd", "fwd_device", "bwd_device")),
                       ("parts", ("ms", "plain_ms", "library_ms")),
                       ("steps", ("step", "step_device", "wgrad_kernel_device",
                                  "wgrad_kernel_launches", "sum_rows_kernel_device",
                                  "sum_rows_kernel_launches"))):
        for label in runs[0][key]:
            for side in sides:
                if side not in runs[0][key][label]:
                    continue
                p, c = (statistics.mean(r[key][label][side] for r in runs if r["tree"] == tree)
                        for tree in ("parent", "change"))
                print(f"{label} {side}: parent {p:.4f}, change {c:.4f} "
                      f"({100 * (c / p - 1):+.2f}%)", flush=True)
    write_json(report, json_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())

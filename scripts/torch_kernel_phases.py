#!/usr/bin/env python3
"""Where a fused-MLP CTA spends its cycles: clock64() stamps in a copy of the
kernels, on the static fine case of the shared-pose step.

    python3 scripts/torch_kernel_phases.py [ROOT] [--json PATH]

ROOT (default: this checkout) is the root of a checkout of the repository,
for example the parent commit unpacked with ``git archive`` into
``runs/parent``; its GEMM core must be the wgmma weight ring. The script
writes a copy of ROOT's ``startrax_torch/kernels/csrc/fused_mlp.cu`` into a
temporary directory outside the checkout, inserts the stamps by text
substitution (each anchor must occur as often as the table says, or the
script raises), builds the copy with the library's nvcc flags and loads it
in place of the library (``torch_cu_copies.py``). It then runs the static
fine field of ``carla_star_online_multi.txt`` (8x256, 1000 rays x 512
samples = 512,000 points) forward, with grad on as a step runs it, and
backward (``torch.autograd.grad``), one warm-up each.

Thread 0 of every CTA of ``fwd_kernel`` and ``bwd_kernel`` stamps:
- the kernel's cycles, from its first statement to its end;
- the cycles inside the GEMM core (``tile_gemm``);
- of those, the cycles spent waiting for a weight chunk: the wait on a
  slot's "full" barrier, and the filler's wait on a slot's "empty" barrier.
Per CTA it splits the kernel's cycles into the wait, the rest of the GEMM
core (the matrix loop) and everything outside the core, and prints the
shares averaged over the CTAs, with the mean cycles per CTA and per weight
chunk. Thread 0 takes part in every barrier, so its wait includes the
slowest warp's arrival. The stamps cost a few instructions per chunk; the
readings are shares, not times. Needs one CUDA card and nvcc.
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch_cu_copies as cu_copies

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join("startrax_torch", "kernels", "csrc", "fused_mlp.cu")
MAXC = 1 << 16  # CTAs stamped per launch (the static fine grid has 8,000)

PREAMBLE = r"""
#include <cuda_runtime.h>
__device__ unsigned long long stx_cyc[4][%d];  // kernel, gemm core, chunk wait, chunks
__device__ __forceinline__ int stx_cta() { return blockIdx.y * gridDim.x + blockIdx.x; }
__device__ __forceinline__ long long stx_clock() {
  long long t = 0;
#ifdef __CUDA_ARCH__
  asm volatile("mov.u64 %%0, %%%%clock64;" : "=l"(t));
#endif
  return t;
}
struct StxKernel {  // the kernel's cycles, from construction to scope exit
  long long t0;
  __device__ StxKernel() : t0(stx_clock()) {}
  __device__ ~StxKernel() {
    if (threadIdx.x == 0 && stx_cta() < %d) stx_cyc[0][stx_cta()] += stx_clock() - t0;
  }
};
struct StxCore {  // one call of the GEMM core, from construction to scope exit
  long long t0;
  __device__ StxCore() : t0(stx_clock()) {}
  __device__ ~StxCore() {
    if (threadIdx.x == 0 && stx_cta() < %d) stx_cyc[1][stx_cta()] += stx_clock() - t0;
  }
};
// a wait that began at w0 ended now (chunks: 1 for the wait on a chunk)
__device__ __forceinline__ void stx_add_wait(long long w0, int chunks) {
  if (threadIdx.x == 0 && stx_cta() < %d) {
    stx_cyc[2][stx_cta()] += stx_clock() - w0;
    stx_cyc[3][stx_cta()] += chunks;
  }
}
// the weight-gradient GEMM (wgrad_kernel): kernel, slab wait, wgmma loop,
// copies issued, partial store, slabs; thread 0 of each CTA
__device__ unsigned long long stx_wg[6][%d];
__device__ __forceinline__ void stx_wg_add(int what, long long t0) {
  if (threadIdx.x == 0 && stx_cta() < %d) stx_wg[what][stx_cta()] += what == 5 ? 1 : stx_clock() - t0;
}
""" % (MAXC, MAXC, MAXC, MAXC, MAXC, MAXC)

EPILOGUE = r"""
extern "C" int stx_phase_reset() {
  static unsigned long long zeros[4][%d];
  return (int)cudaMemcpyToSymbol(stx_cyc, zeros, sizeof(zeros));
}
extern "C" int stx_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, stx_cyc, sizeof(unsigned long long) * 4 * %d);
}
extern "C" int stx_wg_reset() {
  static unsigned long long zeros[6][%d];
  return (int)cudaMemcpyToSymbol(stx_wg, zeros, sizeof(zeros));
}
extern "C" int stx_wg_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, stx_wg, sizeof(unsigned long long) * 6 * %d);
}
""" % (MAXC, MAXC, MAXC, MAXC)

KERNEL_ANCHOR = ("  extern __shared__ __align__(128) unsigned char smem[];\n  const int W = all_in.width",
                 "  extern __shared__ __align__(128) unsigned char smem[];\n  StxKernel stx_k;\n"
                 "  const int W = all_in.width", 2)

# The GEMM core's anchors: (text to find, its replacement, how many times it occurs).
CORE_ANCHORS = [
    ("__device__ void tile_gemm(const Seg* segs, int nseg, int nout, Feed& f, float* c, int ldc) {\n",
     "__device__ void tile_gemm(const Seg* segs, int nseg, int nout, Feed& f, float* c, int ldc) {\n"
     "  StxCore stx_c;\n", 1),
    ("      mbar_wait(&r->full[slot], (g / NSLOT) & 1);\n",
     "      { const long long stx_w0 = stx_clock(); mbar_wait(&r->full[slot], (g / NSLOT) & 1);"
     " stx_add_wait(stx_w0, 1); }\n", 1),
    ("    mbar_wait(&r->empty[slot], (g / NSLOT) & 1);\n",
     "    { const long long stx_w0 = stx_clock(); mbar_wait(&r->empty[slot], (g / NSLOT) & 1);"
     " stx_add_wait(stx_w0, 0); }\n", 1),
]

# The weight-gradient GEMM's anchors: the kernel's cycles (1: slab wait, the
# slab's mbarrier and the block barrier; 3: the math, ldmatrix, masks and
# wgmma to their retirement; 2: of it, thread 0 issuing the next slab's
# copies while the wgmma run; 4: the partial store; 5: slabs counted).
WGRAD_ANCHORS = [
    ("  const WgTable& t = prm.t;\n", "  const WgTable& t = prm.t;\n  const long long stx_k0 = stx_clock();\n", 1),
    ("wg_tile<64>(t, L, xm, ym, blockIdx.y, split, rt, ring, full, wpart); break;\n  }\n",
     "wg_tile<64>(t, L, xm, ym, blockIdx.y, split, rt, ring, full, wpart); break;\n  }\n"
     "  stx_wg_add(0, stx_k0);\n", 1),
    ("    mbar_wait(full + b, (s / WG_STAGES) & 1);  // slab s has landed\n"
     "    __syncthreads();  // slab s - 1's stage is free\n",
     "    const long long stx_w0 = stx_clock();\n    mbar_wait(full + b, (s / WG_STAGES) & 1);\n"
     "    __syncthreads();\n    stx_wg_add(1, stx_w0);\n    stx_wg_add(5, 0);\n", 1),
    ("    if (!active) continue;  // (thread 0 is always active)\n",
     "    if (!active) continue;\n    const long long stx_m0 = stx_clock();\n", 1),
    ("      if (threadIdx.x == 0 && s2 < slabs)\n        wg_load<N>(x_map, dy_map, c0, kc, row0 + s2 * WG_P,"
     " ring + b2 * WG_STAGE, full + b2);\n    }\n",
     "      const long long stx_l0 = stx_clock();\n      if (threadIdx.x == 0 && s2 < slabs)\n"
     "        wg_load<N>(x_map, dy_map, c0, kc, row0 + s2 * WG_P, ring + b2 * WG_STAGE, full + b2);\n"
     "      stx_wg_add(2, stx_l0);\n    }\n", 1),
    ("      asm volatile(\"\" ::\"r\"(a[k][0]), \"r\"(a[k][1]), \"r\"(a[k][2]), \"r\"(a[k][3]) : \"memory\");\n  }\n"
     "  if (!active) return;\n",
     "      asm volatile(\"\" ::\"r\"(a[k][0]), \"r\"(a[k][1]), \"r\"(a[k][2]), \"r\"(a[k][3]) : \"memory\");\n"
     "    stx_wg_add(3, stx_m0);\n  }\n  const long long stx_s0 = stx_clock();\n  if (!active) return;\n", 1),
    ("make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);\n  }\n}\n",
     "make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);\n  }\n  stx_wg_add(4, stx_s0);\n}\n", 1),
]


def instrument(src):
    """fused_mlp.cu's text -> the stamped copy's text."""
    out = cu_copies.substitute(src, [KERNEL_ANCHOR, *CORE_ANCHORS, *WGRAD_ANCHORS], "the stamps")
    head = out.index("namespace {")
    return out[:head] + PREAMBLE + out[head:] + EPILOGUE


def split(cyc, n_cta):
    """Per-CTA stamps -> the shares and means of the launch's CTAs."""
    kernel, gemm, wait, chunks = (cyc[i][:n_cta] for i in range(4))
    shares = {"wait": [], "matrix": [], "outside": []}
    for k, g, w in zip(kernel, gemm, wait):
        shares["wait"].append(w / k)
        shares["matrix"].append((g - w) / k)
        shares["outside"].append((k - g) / k)
    return {"ctas": n_cta, **{f"{k}_share": statistics.mean(v) for k, v in shares.items()},
            "kernel_cycles": statistics.mean(kernel), "gemm_cycles": statistics.mean(gemm),
            "wait_cycles": statistics.mean(wait), "chunks": statistics.mean(chunks),
            "cycles_per_chunk": statistics.mean(g / max(c, 1) for g, c in zip(gemm, chunks))}


def split_wgrad(cyc, n_cta):
    """Per-CTA stamps of the weight-gradient GEMM -> the shares of its
    cycles: the slab wait (the slab's mbarrier and the block barrier), the
    math (ldmatrix, masks, wgmma to retirement) less thread 0's issuing of
    the next slab's copies inside it, that issuing, the partial store, and
    the rest."""
    kernel, wait, issue, math, store, slabs = (cyc[i][:n_cta] for i in range(6))
    shares = {"wait": [], "issue": [], "wgmma": [], "store": [], "other": []}
    for k, w, i, m, st in zip(kernel, wait, issue, math, store):
        for key, v in (("wait", w), ("issue", i), ("wgmma", m - i), ("store", st),
                       ("other", k - w - m - st)):
            shares[key].append(v / k)
    return {"ctas": n_cta, **{f"{k}_share": statistics.mean(v) for k, v in shares.items()},
            "kernel_cycles": statistics.mean(kernel), "slabs": statistics.mean(slabs),
            "cycles_per_slab": statistics.mean(k / max(s, 1) for k, s in zip(kernel, slabs))}


def main():
    args = sys.argv[1:]
    json_path = None
    if "--json" in args:
        i = args.index("--json")
        json_path = args[i + 1]
        del args[i:i + 2]
    root = os.path.abspath(args[0]) if args else HERE
    sys.path.insert(0, root)
    import importlib.util

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    from startrax_torch.kernels import fused_mlp as fm
    from startrax_torch.utils.config import Config, parse_config_file, star_config_from

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; tree {root}", flush=True)
    with open(os.path.join(root, SRC)) as fp:
        text = instrument(fp.read())
    with tempfile.TemporaryDirectory(prefix="stx_phases_") as out_dir:
        lib = cu_copies.load_in_place(cu_copies.build({"stamped": text}, out_dir)["stamped"])
    lib.stx_phase_read.argtypes = [ctypes.c_void_p]
    lib.stx_wg_read.argtypes = [ctypes.c_void_p]

    cfg = Config(**parse_config_file(os.path.join(root, "startrax", "configs",
                                                  "carla_star_online_multi.txt")))
    star = star_config_from(cfg)
    case = cs.kernel_cases(star, cfg.N_rand)[1]  # static fine
    inp = cs.case_inputs(star, case, 1)
    n = case[2]
    n_cta = -(-n // 64)
    buf = (ctypes.c_ulonglong * (4 * MAXC))()

    def read():
        torch.cuda.synchronize()
        if lib.stx_phase_read(ctypes.addressof(buf)) != 0:
            raise RuntimeError("stx_phase_read failed")
        return [buf[i * MAXC:(i + 1) * MAXC] for i in range(4)]

    def fwd():
        a, r = fm.fused_field_apply(inp["params"], inp["x"], inp["d"], inp["n_blocks"], inp["pe"],
                                    pe_masks=inp["pe_masks"], warp=inp["warp"])
        return torch.sin(a).sum() + (r * r).sum()

    leaves = list(fm.flatten_params(inp["params"], inp["n_blocks"]))
    report = {"card": card, "root": root, "case": f"static fine 8x256 N={n}"}
    fwd()
    lib.stx_phase_reset()
    loss = fwd()
    report["fwd"] = split(read(), n_cta)
    torch.autograd.grad(loss, leaves, retain_graph=True)
    lib.stx_phase_reset()
    lib.stx_wg_reset()
    torch.autograd.grad(loss, leaves)
    report["bwd"] = split(read(), n_cta)
    wg = (ctypes.c_ulonglong * (6 * MAXC))()
    if lib.stx_wg_read(ctypes.addressof(wg)) != 0:
        raise RuntimeError("stx_wg_read failed")
    shapes = fm.wgrad_shapes(case[1].width, case[1].n_blocks, fm.EW)
    lay = fm.wgrad_layout(shapes, n, 1)
    report["wgrad"] = split_wgrad([wg[i * MAXC:(i + 1) * MAXC] for i in range(6)],
                                  lay["tiles"] * lay["splits"])
    for side in ("fwd", "bwd"):
        r = report[side]
        print(f"static fine {side}: wait {100 * r['wait_share']:.2f}%, matrix loop "
              f"{100 * r['matrix_share']:.2f}%, outside the core {100 * r['outside_share']:.2f}% "
              f"(mean of {r['ctas']} CTAs; {r['kernel_cycles']:.0f} cycles a CTA, "
              f"{r['chunks']:.1f} chunks, {r['cycles_per_chunk']:.0f} cycles a chunk in the core)",
              flush=True)
    r = report["wgrad"]
    print(f"static fine wgrad: slab wait {100 * r['wait_share']:.2f}%, copies issued (while the "
          f"wgmma run) {100 * r['issue_share']:.2f}%, the rest of the math "
          f"{100 * r['wgmma_share']:.2f}%, partial store "
          f"{100 * r['store_share']:.2f}%, other {100 * r['other_share']:.2f}% (mean of {r['ctas']} "
          f"CTAs; {r['kernel_cycles']:.0f} cycles a CTA, {r['slabs']:.1f} slabs, "
          f"{r['cycles_per_slab']:.0f} cycles a slab)", flush=True)
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
        with open(json_path, "w") as fp:
            json.dump(report, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

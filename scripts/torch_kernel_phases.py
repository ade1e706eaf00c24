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
""" % (MAXC, MAXC, MAXC, MAXC)

EPILOGUE = r"""
extern "C" int stx_phase_reset() {
  static unsigned long long zeros[4][%d];
  return (int)cudaMemcpyToSymbol(stx_cyc, zeros, sizeof(zeros));
}
extern "C" int stx_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, stx_cyc, sizeof(unsigned long long) * 4 * %d);
}
""" % (MAXC, MAXC)

KERNEL_ANCHOR = ("  extern __shared__ __align__(128) unsigned char smem[];\n",
                 "  extern __shared__ __align__(128) unsigned char smem[];\n  StxKernel stx_k;\n", 2)

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


def instrument(src):
    """fused_mlp.cu's text -> the stamped copy's text."""
    out = cu_copies.substitute(src, [KERNEL_ANCHOR, *CORE_ANCHORS], "the stamps")
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
    torch.autograd.grad(loss, leaves)
    report["bwd"] = split(read(), n_cta)
    for side in ("fwd", "bwd"):
        r = report[side]
        print(f"static fine {side}: wait {100 * r['wait_share']:.2f}%, matrix loop "
              f"{100 * r['matrix_share']:.2f}%, outside the core {100 * r['outside_share']:.2f}% "
              f"(mean of {r['ctas']} CTAs; {r['kernel_cycles']:.0f} cycles a CTA, "
              f"{r['chunks']:.1f} chunks, {r['cycles_per_chunk']:.0f} cycles a chunk in the core)",
              flush=True)
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
        with open(json_path, "w") as fp:
            json.dump(report, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

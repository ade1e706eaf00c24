#!/usr/bin/env python3
"""Where a fused-MLP CTA spends its cycles: clock64() stamps in a copy of the
kernels, on the static fine case of the shared-pose step.

    python3 scripts/torch_kernel_phases.py [ROOT] [--ablate] [--json PATH]

ROOT (default: this checkout) is the root of a checkout of the repository,
for example the parent commit unpacked with ``git archive`` into
``runs/parent``; its kernels must be this source's (the wgmma weight ring
read with A from shared memory and refilled by a producer warp, the
epilogues in registers on its accumulators: ``ANCHORS``); an older source
takes the script of its own commit (``runs/parent/scripts/...``). The script
writes a copy of ROOT's ``startrax_torch/kernels/csrc/fused_mlp.cu`` into a
temporary directory outside the checkout, inserts the stamps by text
substitution (each anchor must occur as often as the table says, or the
script raises), builds the copy with the library's nvcc flags and loads it
in place of the library (``torch_cu_copies.py``). It then runs the static
fine field of ``carla_star_online_multi.txt`` (8x256, 1000 rays x 512
samples = 512,000 points) forward, with grad on as a step runs it, and
backward (``torch.autograd.grad``), one warm-up each.

Thread 0 of every CTA of ``fwd_kernel`` and ``bwd_kernel`` attributes each
of its cycles, from the kernel's first statement to its end, to one
category: a stamp switches the category and adds the cycles since the last
switch to the one it leaves (the state lives in a few words of static
shared memory). The categories:
- ``core``: the GEMM core's chunk loop (wgmma issue and retirement, the
  slot's release; the producer warp refills it);
- ``wait``: inside it, waiting for a weight chunk (the slot's "full"
  barrier);
- ``encoding``: loading the points, the warp and the input encoding (the
  backward's encodings for the weight-gradient GEMM);
- ``epilogues``: the per-layer elementwise work after each GEMM (bias,
  relu, residual, bf16 rounding, the saved activations and dY stores, also
  where the core stores them during its first chunks);
- ``heads``: the alpha and rgb heads (the backward's rgb head pass);
- ``sums``: the column sums (bias grads) and the narrow weight grads
  (dW_a, dW_r, the b_a and b_r sums);
- ``enc_bwd``: the encoding backward, the unwarp and the pose sums;
- ``barriers``: waits in barriers (``__syncthreads`` and the named
  barriers of a row strip or a warpgroup);
- ``act_wait``: in the backward, the epilogues' wait for the prefetched
  saved activation to land;
- ``other``: the rest (the ring's set-up, the cotangent's load, the drain).
Thread 0 takes part in every barrier, so its waits include the slowest
warp's arrival. "Outside the core" is every category but core and wait.
Thread 0 also counts the chunks whose "full" barrier had not completed when
it came to wait for them (``spun_share``: how often the ring starved it).
The stamps cost a few instructions each; the readings are shares, not
times.

With ``--ablate`` a second copy is stamped and run after the first: the
same, but after the first NSLOT copies the producer warp only arrives on
a slot's "full" barrier and copies nothing (the slot keeps an earlier
chunk, so the results are wrong). Its cycles a chunk are the core's with
the weights' L2 supply taken away: wgmma's issue to retirement and the
ring's barriers. Needs one CUDA card and nvcc.
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
CATS = ("other", "core", "wait", "encoding", "epilogues", "heads", "sums", "enc_bwd", "barriers",
        "act_wait")
OUTSIDE = ("encoding", "epilogues", "heads", "sums", "enc_bwd", "barriers", "act_wait", "other")

PREAMBLE = r"""
#include <cuda_runtime.h>
constexpr int STX_NCAT = %d;
// per CTA: cycles by category, then the kernel's cycles, the chunks consumed
// and the chunks whose "full" wait found the barrier incomplete
__device__ unsigned long long stx_cyc[STX_NCAT + 3][%d];
// thread 0's state: [0, STX_NCAT) cycles by category, then the last stamp,
// the current category, the chunks, the kernel's first clock, the spun
// chunks (128 bytes, so that the dynamic shared memory after it keeps its
// alignment)
__shared__ unsigned long long stx_sh[16];
__device__ __forceinline__ int stx_cta() { return blockIdx.y * gridDim.x + blockIdx.x; }
__device__ __forceinline__ long long stx_clock() {
  long long t = 0;
#ifdef __CUDA_ARCH__
  asm volatile("mov.u64 %%0, %%%%clock64;" : "=l"(t));
#endif
  return t;
}
// switches thread 0's category to cat
__device__ __forceinline__ void stx_to(int cat) {
  if (threadIdx.x == 0) {
    const long long now = stx_clock();
    stx_sh[(int)stx_sh[STX_NCAT + 1]] += now - (long long)stx_sh[STX_NCAT];
    stx_sh[STX_NCAT] = now;
    stx_sh[STX_NCAT + 1] = cat;
  }
}
__device__ __forceinline__ int stx_cur() { return threadIdx.x == 0 ? (int)stx_sh[STX_NCAT + 1] : 0; }
__device__ __forceinline__ void stx_chunk() { if (threadIdx.x == 0) stx_sh[STX_NCAT + 2] += 1; }
// counts a chunk whose "full" barrier has not completed the phase of this parity
__device__ __forceinline__ void stx_spin(unsigned long long* bar, unsigned parity) {
  if (threadIdx.x != 0) return;
  unsigned ok;
  asm volatile("{\n.reg .pred p;\nmbarrier.test_wait.parity.shared::cta.b64 p, [%%1], %%2;\n"
               "selp.u32 %%0, 1, 0, p;\n}\n"
               : "=r"(ok) : "r"((unsigned)__cvta_generic_to_shared(bar)), "r"(parity) : "memory");
  if (!ok) stx_sh[STX_NCAT + 4] += 1;
}
__device__ __forceinline__ void stx_sync() {
  const int p = stx_cur();
  stx_to(8);
  __syncthreads();
  stx_to(p);
}
struct StxKernel {  // the kernel's cycles, from construction to scope exit
  __device__ StxKernel() {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 16; ++i) stx_sh[i] = 0;
      stx_sh[STX_NCAT] = stx_sh[STX_NCAT + 3] = stx_clock();
    }
  }
  __device__ ~StxKernel() {
    stx_to(0);
    if (threadIdx.x == 0 && stx_cta() < %d) {
      for (int i = 0; i < STX_NCAT; ++i) stx_cyc[i][stx_cta()] += stx_sh[i];
      stx_cyc[STX_NCAT][stx_cta()] += stx_clock() - (long long)stx_sh[STX_NCAT + 3];
      stx_cyc[STX_NCAT + 1][stx_cta()] += stx_sh[STX_NCAT + 2];
      stx_cyc[STX_NCAT + 2][stx_cta()] += stx_sh[STX_NCAT + 4];
    }
  }
};
struct StxScope {  // a category for a scope, the previous one restored at its exit
  int p;
  __device__ explicit StxScope(int cat) : p(stx_cur()) { stx_to(cat); }
  __device__ ~StxScope() { stx_to(p); }
};
// the weight-gradient GEMM (wgrad_kernel): kernel, slab wait, wgmma loop,
// copies issued, partial store, slabs; thread 0 of each CTA
__device__ unsigned long long stx_wg[6][%d];
__device__ __forceinline__ void stx_wg_add(int what, long long t0) {
  if (threadIdx.x == 0 && stx_cta() < %d) stx_wg[what][stx_cta()] += what == 5 ? 1 : stx_clock() - t0;
}
""" % (len(CATS), MAXC, MAXC, MAXC, MAXC)

EPILOGUE = r"""
extern "C" int stx_phase_reset() {
  static unsigned long long zeros[STX_NCAT + 3][%d];
  return (int)cudaMemcpyToSymbol(stx_cyc, zeros, sizeof(zeros));
}
extern "C" int stx_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, stx_cyc, sizeof(unsigned long long) * (STX_NCAT + 3) * %d);
}
extern "C" int stx_wg_reset() {
  static unsigned long long zeros[6][%d];
  return (int)cudaMemcpyToSymbol(stx_wg, zeros, sizeof(zeros));
}
extern "C" int stx_wg_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, stx_wg, sizeof(unsigned long long) * 6 * %d);
}
""" % (MAXC, MAXC, MAXC, MAXC)

# The fused kernels' anchors: (text to find, its replacement, how many
# times it occurs). Category numbers follow CATS. The stores of the last
# epilogue's output during a GEMM's first chunks count as epilogue work.
ANCHORS = [
    ("  extern __shared__ __align__(128) unsigned char smem[];\n  const int W = all_in.width",
     "  extern __shared__ __align__(128) unsigned char smem[];\n  StxKernel stx_k;\n"
     "  const int W = all_in.width", 2),
    ("      mbar_wait(&r->full[slot], (g / NSLOT) & 1);\n",
     "      stx_to(2); stx_spin(&r->full[slot], (g / NSLOT) & 1); mbar_wait(&r->full[slot], (g / NSLOT) & 1);"
     " stx_to(1); stx_chunk();\n", 1),
    ("  f.g = g;\n  epi.template run<N>(acc);\n", "  f.g = g;\n  stx_to(4);\n  epi.template run<N>(acc);\n", 1),
    ("  if constexpr (!ENC) load_points(", "  stx_to(3);\n  if constexpr (!ENC) load_points(", 1),
    ("  stage_bf16(vec + vo.w_a, w.w_a, W);\n", "  stx_to(0);\n  stage_bf16(vec + vo.w_a, w.w_a, W);\n", 1),
    ("  const unsigned g0 = f.g;\n", "  stx_to(1);\n  const unsigned g0 = f.g;\n", 1),
    ("      sv.run((int)(g - g0));\n",
     "      if ((int)(g - g0) < sv.panels) {\n        stx_to(4);\n        sv.run((int)(g - g0));\n        stx_to(1);\n      }\n",
     1),
    ("  if constexpr (ENC) {\n    stage_encoded<true>(in.x, in.fx, XW, in.n, row0, as0, 0, false);",
     "  stx_to(3);\n  if constexpr (ENC) {\n    stage_encoded<true>(in.x, in.fx, XW, in.n, row0, as0, 0, false);",
     1),
    ("  tile_sync();  // the heads' partials of both warpgroups, and hv_in for its tensor copies\n"
     "  Save{nxt, &maps.m[2 * nb + 3], (int)row0, k, W2 / 64}.run();\n",
     "  tile_sync();  // the heads' partials of both warpgroups, and hv_in for its tensor copies\n  stx_to(4);\n"
     "  Save{nxt, &maps.m[2 * nb + 3], (int)row0, k, W2 / 64}.run();\n  stx_to(5);\n", 1),
    ("    sv.run();  // no GEMM follows\n", "    stx_to(4);\n    sv.run();  // no GEMM follows\n", 1),
    ("__device__ __forceinline__ void head_rows(float (*s)[HEADS], int r0, float* hp) {\n",
     "__device__ __forceinline__ void head_rows(float (*s)[HEADS], int r0, float* hp) {\n"
     "  StxScope stx_s(5);\n", 1),
    ("  const Frag f(N);\n  if (threadIdx.x < 64) {  // the cotangent's column sums",
     "  stx_to(5);\n  const Frag f(N);\n  if (threadIdx.x < 64) {  // the cotangent's column sums", 1),
    ("void colsum_frag(float* v, int c0, float* cb, int ldcb, float* out, int stride) {\n",
     "void colsum_frag(float* v, int c0, float* cb, int ldcb, float* out, int stride) {\n"
     "  StxScope stx_s(6);\n", 1),
    ("                                       int F, float* out3) {\n",
     "                                       int F, float* out3) {\n  stx_to(7);\n", 1),
    ("{ mbar_wait(full, n & 1); }",
     "{ const int stx_p = stx_cur(); stx_to(9); mbar_wait(full, n & 1); stx_to(stx_p); }", 1),
    ("__syncthreads();", "stx_sync();", 2),
    ("  asm volatile(\"bar.sync %0, %1;\" ::\"r\"(id), \"r\"(n) : \"memory\");\n",
     "  const int stx_p = stx_cur();\n  stx_to(8);\n"
     "  asm volatile(\"bar.sync %0, %1;\" ::\"r\"(id), \"r\"(n) : \"memory\");\n  stx_to(stx_p);\n", 1),
]
# --ablate: after the first NSLOT copies the producer warp arrives on a
# slot's "full" barrier without copying.
ABLATION = [("      ring_copy(r, slot, m, c);\n",
             "      if (g < NSLOT) ring_copy(r, slot, m, c); else mbar_arrive(&r->full[slot]);\n", 1)]

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

GEMM_MARK = "// (B) The weight-gradient GEMM"  # the fused kernels' part of the source ends here


def instrument(src, ablate=False):
    """fused_mlp.cu's text -> the stamped copy's text (with ablate, the
    ring's copies after the first NSLOT skipped). The category anchors
    apply to the fused kernels' part of the source only (before the
    weight-gradient GEMM), whose block barriers they all stamp."""
    cut = src.index(GEMM_MARK)
    head = cu_copies.substitute(src[:cut], ANCHORS + (ABLATION if ablate else []), "the stamps")
    out = head + cu_copies.substitute(src[cut:], WGRAD_ANCHORS, "the stamps")
    at = out.index("namespace {")
    return out[:at] + PREAMBLE + out[at:] + EPILOGUE


def split(cyc, n_cta):
    """Per-CTA stamps -> the mean share of each category and of everything
    outside the core, with the mean cycles per CTA and per weight chunk and
    the share of chunks whose "full" wait found the slot not yet filled."""
    cats = [cyc[i][:n_cta] for i in range(len(CATS))]
    kernel, chunks = cyc[len(CATS)][:n_cta], cyc[len(CATS) + 1][:n_cta]
    spun = cyc[len(CATS) + 2][:n_cta]
    out = {"ctas": n_cta}
    for name, v in zip(CATS, cats):
        out[f"{name}_share"] = statistics.mean(c / max(k, 1) for c, k in zip(v, kernel))
    out["outside_share"] = sum(out[f"{name}_share"] for name in OUTSIDE)
    core = [a + b for a, b in zip(cats[1], cats[2])]
    out.update(kernel_cycles=statistics.mean(kernel), core_cycles=statistics.mean(core),
               chunks=statistics.mean(chunks),
               cycles_per_chunk=statistics.mean(g / max(c, 1) for g, c in zip(core, chunks)),
               spun_share=sum(spun) / max(sum(chunks), 1),
               attributed=statistics.mean(sum(c[i] for c in cats) / max(k, 1)
                                          for i, k in enumerate(kernel)))
    return out


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
    ablate = "--ablate" in args
    if ablate:
        args.remove("--ablate")
    root = os.path.abspath(args[0]) if args else HERE
    sys.path.insert(0, root)
    import importlib.util

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    with open(os.path.join(root, SRC)) as fp:
        src = fp.read()
    print(f"card: {card}; tree {root}", flush=True)
    texts = {"stamped": instrument(src)}
    if ablate:
        texts["ablated"] = instrument(src, ablate=True)
    with tempfile.TemporaryDirectory(prefix="stx_phases_") as out_dir:
        libs = cu_copies.build(texts, out_dir)
        report = measure(cu_copies.load_in_place(libs["stamped"]), root, cs)
        if ablate:
            print("the same, the ring's copies after the first NSLOT skipped (results wrong):", flush=True)
            report["ablated"] = measure(cu_copies.load_in_place(libs["ablated"]), root, cs)
    report.update(card=card, root=root)
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
        with open(json_path, "w") as fp:
            json.dump(report, fp, indent=1)
    return 0


def measure(lib, root, cs):
    """Runs the static fine case forward and backward on the stamped library
    lib (loaded in place of the fused-MLP library; cs is ROOT's chip_smoke
    module) and prints and returns the CTAs' splits."""
    import torch

    from startrax_torch.kernels import fused_mlp as fm
    from startrax_torch.utils.config import Config, parse_config_file, star_config_from

    lib.stx_phase_read.argtypes = [ctypes.c_void_p]
    lib.stx_wg_read.argtypes = [ctypes.c_void_p]

    cfg = Config(**parse_config_file(os.path.join(root, "startrax", "configs",
                                                  "carla_star_online_multi.txt")))
    star = star_config_from(cfg)
    case = cs.kernel_cases(star, cfg.N_rand)[1]  # static fine
    inp = cs.case_inputs(star, case, 1)
    n = case[2]
    n_cta = -(-n // 64)
    rows = len(CATS) + 3
    buf = (ctypes.c_ulonglong * (rows * MAXC))()

    def read():
        torch.cuda.synchronize()
        if lib.stx_phase_read(ctypes.addressof(buf)) != 0:
            raise RuntimeError("stx_phase_read failed")
        return [buf[i * MAXC:(i + 1) * MAXC] for i in range(rows)]

    def fwd():
        a, r = fm.fused_field_apply(inp["params"], inp["x"], inp["d"], inp["n_blocks"], inp["pe"],
                                    pe_masks=inp["pe_masks"], warp=inp["warp"])
        return torch.sin(a).sum() + (r * r).sum()

    leaves = list(fm.flatten_params(inp["params"], inp["n_blocks"]))
    report = {"case": f"static fine 8x256 N={n}"}
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
        shares = ", ".join(f"{name} {100 * r[name + '_share']:.2f}%" for name in CATS)
        print(f"static fine {side}: {shares}; outside the core "
              f"{100 * r['outside_share']:.2f}% (mean of {r['ctas']} CTAs; "
              f"{r['kernel_cycles']:.0f} cycles a CTA, {r['chunks']:.1f} chunks, "
              f"{r['cycles_per_chunk']:.0f} cycles a chunk in the core, "
              f"{100 * r['spun_share']:.2f}% of the chunks waited for; "
              f"{100 * r['attributed']:.2f}% of the cycles attributed)", flush=True)
    r = report["wgrad"]
    print(f"static fine wgrad: slab wait {100 * r['wait_share']:.2f}%, copies issued (while the "
          f"wgmma run) {100 * r['issue_share']:.2f}%, the rest of the math "
          f"{100 * r['wgmma_share']:.2f}%, partial store "
          f"{100 * r['store_share']:.2f}%, other {100 * r['other_share']:.2f}% (mean of {r['ctas']} "
          f"CTAs; {r['kernel_cycles']:.0f} cycles a CTA, {r['slabs']:.1f} slabs, "
          f"{r['cycles_per_slab']:.0f} cycles a slab)", flush=True)
    return report


if __name__ == "__main__":
    sys.exit(main())

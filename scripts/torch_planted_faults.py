#!/usr/bin/env python3
"""Planted faults in the fused-MLP kernels' pre-encoded mode, in their GEMM
core's weight ring and in the backward's weight-gradient GEMM, read through
startrax_torch.kernels.parity: the readings that set ``parity.ENC_LIMITS``;
and, for every build, the weight-gradient GEMM's own reading against its
plain version (chip_smoke.PART_TOL["wgrad"]).

    python3 scripts/torch_planted_faults.py [--only WORD,...] [--json PATH]

Each fault is a textual change to a copy of
``startrax_torch/kernels/csrc/fused_mlp.cu`` written to a temporary
directory outside the checkout (whose source is not touched) and removed at
the end; all copies, and the sound source, are built at once with the
library's nvcc flags. Each build is then loaded, in a process of its own,
in place of the library and run through ``parity.compare`` on the
pre-encoded cases of chip_smoke.py phase 5 (carla_nerf_time.txt's 8x256
fields) and on 3,000 ragged points at widths 128 and 256 with in_ch 84 and
63, with and without input grads (the ring's faults break every mode
alike, so the same cases read them). Three of the ring's faults refill a
slot while a wgmma that reads it may still be in flight. The refill's copy
lands about a microsecond after it is issued, long after that read, so
these faults are built with the slot poisoned at its refill (``POISON``:
the producer warp overwrites the whole slot with NaN once its "empty" wait
has returned, then fences it for the copy), which lands within a few dozen
cycles; the sound source is built a second time so poisoned, which must
read as the sound one. With ``--only`` the sound source and the builds
whose names hold one of the words are run. The sound builds and the ring's
faults also run the card tests that hold the kernels bit for bit to the
parent's digests (``tests/test_torch_cuda.py -k bit_for_bit``, by pytest
in a process of its own with the build in place of the library). For
every build the script prints the largest reading of each measure and the
cases that fail ``ENC_LIMITS`` and, with ``--json PATH``, writes them to
PATH. A build whose run fails (a consumer waiting for a chunk that never
comes traps its wait after about ten seconds) is reported with its error:
caught before parity reads it. The copies are made
and loaded by ``torch_cu_copies.py``. Needs one CUDA card and nvcc.
"""

import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import torch_cu_copies as cu_copies

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# The producer warp overwrites each slot it refills with NaN, once the
# slot's "empty" wait has returned and before the copy, all 32 lanes in a
# scattered order so that every part of it is hit within a few dozen
# cycles, then fences the stores for the copy. Harmless where every wgmma
# that reads the slot has retired; a read still in flight reads NaN. WAIT
# is the empty wait's phase parity (a fault may move it).
PRODUCER = ("  if ((threadIdx.x & 31) != 0) return;\n  unsigned g = 0;\n"
            "  for (int m = 0; m < r->n_mats; ++m)\n"
            "    for (int c = 0; c < r->mats[m].chunks; ++c, ++g) {\n"
            "      const int slot = g % NSLOT;\n"
            "      if (g >= NSLOT) mbar_wait(&r->empty[slot], (g / NSLOT - 1) & 1);\n"
            "      ring_copy(r, slot, m, c);\n    }\n")


def poisoned(wait="(g / NSLOT - 1) & 1"):
    return [(PRODUCER,
             "  const int lane = threadIdx.x & 31;\n  unsigned g = 0;\n"
             "  for (int m = 0; m < r->n_mats; ++m)\n"
             "    for (int c = 0; c < r->mats[m].chunks; ++c, ++g) {\n"
             "      const int slot = g % NSLOT;\n"
             "      if (g >= NSLOT) {\n"
             f"        if (lane == 0) mbar_wait(&r->empty[slot], {wait});\n"
             "        __syncwarp();\n"
             "        uint4* q = reinterpret_cast<uint4*>(r->slots + slot * r->slot_elems);\n"
             "        const int nq = r->slot_elems / 8;\n"
             "        for (int i = lane; i < nq; i += 32)\n"
             "          q[(i * 37) % nq] = make_uint4(0x7fc07fc0u, 0x7fc07fc0u, 0x7fc07fc0u, 0x7fc07fc0u);\n"
             "        asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n"
             "        __syncwarp();\n"
             "      }\n"
             "      if (lane == 0) ring_copy(r, slot, m, c);\n    }\n", 1)]


POISON = poisoned()
SOUND_POISONED = "sound, the ring's slots poisoned at refill"

# name -> [(text to find, its replacement, how many times it occurs), ...]
FAULTS = {
    "lin_in reads 64 rows (drops columns 64-83)": [
        ("const Seg s = {cur, in_rows<ENC>()};", "const Seg s = {cur, EW};", 1),
        ("ring_add(ring, w.w_in, in_rows<ENC>(), W);", "ring_add(ring, w.w_in, EW, W);", 1)],
    "pad columns left unzeroed": [
        ("    if (skip_tail && p >= n) continue;",
         "    if ((skip_tail && p >= n) || j >= cols) continue;", 1)],
    "dd_emb left at zero": [
        ("gr.dd[(row0 + t) * in.fd + c] = dhs[t * (EW + 8) + c];",
         "gr.dd[(row0 + t) * in.fd + c] = 0.f;", 1)],
    "xe written at stride 64": [
        ("stage_encoded<false>(in.x, in.fx, XW, in.n, row0, gr.xe + row0 * XW, XW, true);",
         "stage_encoded<false>(in.x, in.fx, XW, in.n, row0, gr.xe + row0 * EW, EW, true);", 1)],
    "the last ragged tile runs past n": [
        ("const int nrow = (int)min((long)T, (long)in.n - row0);",
         "const int nrow = T;", 2)],
    "ring: the producer refills a slot once the first consumer warp has released it": [
        ("\"r\"(smem_u32(&r->empty[s])), \"r\"(NT / 32)", "\"r\"(smem_u32(&r->empty[s])), \"r\"(1)", 1)] + POISON,
    "ring: the producer skips one chunk at each matrix boundary": [
        ("    for (int c = 0; c < r->mats[m].chunks; ++c, ++g) {", "    for (int c = m > 0; c < r->mats[m].chunks; ++c, ++g) {", 1)],
    "ring: a slot released before its wgmma group has retired (no wait_group)": [
        ("      asm volatile(\"wgmma.wait_group.sync.aligned 0;\\n\" ::: \"memory\");\n"
         "      fence_acc<N>(acc);\n      release(f, g);\n",
         "      release(f, g);\n      asm volatile(\"wgmma.wait_group.sync.aligned 0;\\n\" ::: \"memory\");\n"
         "      fence_acc<N>(acc);\n", 1)] + POISON,
    "ring: the producer refills a slot without waiting for its release (the empty wait a phase early)":
        poisoned("(g / NSLOT) & 1"),
    "ring: a refill arrives on its slot's full barrier without the copy's bytes": [
        ("  asm volatile(\"mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n\" ::\"r\"(bar), \"r\"(mt.bytes)\n"
         "               : \"memory\");\n",
         "  asm volatile(\"mbarrier.arrive.shared::cta.b64 _, [%0];\\n\" ::\"r\"(bar) : \"memory\");\n", 1)],
    "wgrad: each split runs one point past its end": [
        ("const long p_end = min((long)t.n, p_begin + (long)t.per_split);",
         "const long p_end = min((long)t.n, p_begin + (long)t.per_split + 1);", 1)],
    "wgrad: relu dropped on X": [("if (L.relu) v = __hmax2", "if (false) v = __hmax2", 1)],
    "wgrad: points past the split's end not zeroed": [
        ("if (p >= valid) v.x", "if (false) v.x", 1), ("if (p + 1 >= valid) v.y", "if (false) v.y", 1)],
    "wgrad: dY read without the transpose bit": [("p, 1, 1, 1;", "p, 1, 1, 0;", 3)],
}
# the weight-gradient GEMM's own reading: (width, n_blocks, lin_in's rows,
# fields, points per field) of grouped launches, each against its plain
# version, scaled by the plain result's largest magnitude
WGRAD_CASES = [(256, 4, 64, 1, 3000), (256, 4, 96, 1, 65536), (128, 2, 64, 2, 65536),
               (256, 2, 64, 1, 100000)]
MEASURES = ("fwd", "fwd_rms", "w", "input", "input_rms")


def build_all(src_path, out_dir, only=None):
    """The sound source, the sound source poisoned and every faulty copy
    (with only, those whose names hold one of its words), built in out_dir
    -> {name: shared library}."""
    with open(src_path) as fp:
        src = fp.read()
    texts = {"sound": src}
    edits_of = {SOUND_POISONED: POISON, **FAULTS}
    texts.update((name, cu_copies.substitute(src, edits, f"build {name!r}"))
                 for name, edits in edits_of.items()
                 if only is None or any(w in name for w in only))
    return cu_copies.build(texts, out_dir)


def cases(cs):
    """(label, parity.compare inputs) of every case."""
    import torch

    from startrax_torch import convert
    from startrax_torch.models import fields
    from startrax_torch.ops.encoding import positional_encoding
    from startrax_torch.utils.config import Config, parse_config_file, star_config_from

    cfg = Config(**parse_config_file(os.path.join(HERE, "startrax", "configs", cs.NT_CONFIG)))
    star = star_config_from(cfg)
    out = []
    for i, case in enumerate(cs.nerf_time_cases(star, cfg.N_rand)):
        out.append((f"step {case[0]} N={case[2]}",
                    cs.nerf_time_case_inputs(star, case, i, cfg.num_frames)))
    for width in (128, 256):
        for in_ch in (84, 63):
            for grads in (False, True):
                dims = in_ch // 21
                fcfg = fields.FieldConfig(depth=4, width=width, input_dims=dims)
                g = torch.Generator().manual_seed(9)
                params = fields.init_field(fcfg, g, device="cpu")
                for blk in params["blocks"]:
                    blk["fc1"]["w"] = 0.02 * torch.randn(blk["fc1"]["w"].shape, generator=g)
                params = convert.params_from_numpy(convert.params_to_numpy(params), device="cuda",
                                                   requires_grad=True)
                x = positional_encoding(torch.randn(3000, dims, generator=g), 10).cuda()
                d = positional_encoding(
                    torch.nn.functional.normalize(torch.randn(3000, 3, generator=g), dim=-1),
                    4).cuda()
                out.append((f"card 4x{width} in_ch {in_ch} N=3000{' input grads' if grads else ''}",
                            {"params": params, "x": x.requires_grad_(grads),
                             "d": d.requires_grad_(grads), "n_blocks": fcfg.n_blocks, "pe": None}))
    return out


def one(name, so):
    """One build through every case (run in a process of its own, so that a
    fault that breaks the CUDA context leaves the other builds alone)."""
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from startrax_torch.kernels import parity

    torch.backends.cuda.matmul.allow_tf32 = False
    cu_copies.load_in_place(so)
    all_cases = cases(cs)
    worst, failing = dict.fromkeys(MEASURES, 0.0), []
    for label, inp in all_cases:
        errs, _ = parity.compare(**inp)
        torch.cuda.synchronize()
        for k in MEASURES:
            if k in errs:
                worst[k] = max(worst[k], errs[k])
        bad = parity.failures(errs)
        if bad:
            failing.append(f"{label}: {bad} " + ", ".join(f"{k} {errs[k]:.3e}" for k in MEASURES
                                                           if k in errs))
    print(json.dumps({"name": name, "worst": worst, "failing": failing,
                      "cases": len(all_cases), "wgrad": wgrad_reading()}), flush=True)


def wgrad_reading():
    """The largest scaled error of the grouped weight-gradient GEMM against
    its plain version over WGRAD_CASES (random bf16 X and dY)."""
    import torch

    from startrax_torch.kernels import fused_mlp as fm

    g = torch.Generator(device="cuda").manual_seed(11)
    worst = 0.0
    for width, n_blocks, in_rows, fields, n in WGRAD_CASES:
        shapes = fm.wgrad_shapes(width, n_blocks, in_rows)
        xs = [torch.randn((fields, n, k), generator=g, device="cuda").to(torch.bfloat16)
              for k, _, _ in shapes]
        dys = [torch.randn((fields, n, m), generator=g, device="cuda").to(torch.bfloat16)
               for _, _, m in shapes]
        relus = [r for _, r, _ in shapes]
        got = fm.wgrad(xs, dys, relus)
        want = fm.wgrad_grouped_plain(xs, dys, relus, fm.wgrad_layout(shapes, n, fields)["splits"])
        worst = max(worst, float((got - want).abs().max() / want.abs().max()))
    return worst


def card_tests(so, xml):
    """The card tests that hold the kernels bit for bit to the parent's
    digests (tests/test_torch_cuda.py, ``-k bit_for_bit``), run by pytest
    with the library so in place of this checkout's (in a process of its
    own); their results go to the JUnit file xml."""
    import pytest

    cu_copies.load_in_place(so)
    return pytest.main(["--noconftest", "-p", "no:cacheprovider", "-q", "-m", "cuda", "-k",
                        "bit_for_bit", f"--junitxml={xml}",
                        os.path.join(HERE, "tests", "test_torch_cuda.py")])


def card_test_counts(name, so, out_dir):
    """card_tests' passes, failures and errors for one build."""
    import xml.etree.ElementTree as ET

    xml = os.path.join(out_dir, f"card_tests_{abs(hash(name))}.xml")
    subprocess.run([sys.executable, os.path.abspath(__file__), "--card-tests", so, xml],
                   capture_output=True, text=True, cwd=HERE)
    if not os.path.exists(xml):
        return {"error": "pytest wrote no results"}
    suite = ET.parse(xml).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    n, f, e, sk = (int(suite.get(k, 0)) for k in ("tests", "failures", "errors", "skipped"))
    return {"passed": n - f - e - sk, "failed": f, "errors": e, "skipped": sk}


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        one(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) == 4 and sys.argv[1] == "--card-tests":
        return card_tests(sys.argv[2], sys.argv[3])
    import torch

    if not torch.cuda.is_available():
        print("torch_planted_faults: no CUDA device", file=sys.stderr)
        return 1
    from startrax_torch.kernels import parity

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    part_tol = cs.PART_TOL["wgrad"]
    report = {"card": card, "limits": parity.ENC_LIMITS, "wgrad_tol": part_tol, "builds": {}}
    only = sys.argv[sys.argv.index("--only") + 1].split(",") if "--only" in sys.argv else None
    with tempfile.TemporaryDirectory(prefix="stx_faults_") as out_dir:
        libs = build_all(os.path.join(HERE, "startrax_torch", "kernels", "csrc", "fused_mlp.cu"),
                         out_dir, only)
        for name, so in libs.items():
            tests = None
            if name.startswith(("ring", "sound")):
                tests = card_test_counts(name, so, out_dir)
                print(f"{name}: card tests -k bit_for_bit: {tests}", flush=True)
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", name, so],
                                 capture_output=True, text=True, cwd=HERE)
            if out.returncode != 0:  # the fault broke the run itself
                tail = (out.stderr.strip().splitlines() or ["?"])[-1]
                report["builds"][name] = {"error": tail, "card_tests": tests}
                print(f"{name}: the run failed: {tail}", flush=True)
                continue
            r = json.loads(out.stdout.strip().splitlines()[-1])
            r["card_tests"] = tests
            report["builds"][name] = r
            print(f"{name}: worst " + ", ".join(f"{k} {v:.3e}" for k, v in r["worst"].items())
                  + f"; fails in {len(r['failing'])} of {r['cases']} cases; wgrad "
                  f"{r['wgrad']:.3e} (PART_TOL {part_tol})", flush=True)
            for f in r["failing"]:
                print(f"    {f}", flush=True)
    if "--json" in sys.argv:
        path = sys.argv[sys.argv.index("--json") + 1]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fp:
            json.dump(report, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Changed copies of the fused-MLP kernels' CUDA source, built and loaded in
place of the library: the step that ``torch_planted_faults.py``,
``torch_kernel_phases.py`` and ``torch_kernel_ab.py --variants`` share.
Each script keeps its own table of text substitutions; the copies go to a directory the caller gives (a temporary
one outside the checkout), never into the repository's source.
"""

import ctypes
import os
import subprocess


def substitute(text, edits, what):
    """Applies [(text to find, its replacement, how many times it occurs),
    ...] to text in turn; raises when an anchor occurs another number of
    times (the source has moved under the table)."""
    for old, new, count in edits:
        if text.count(old) != count:
            raise RuntimeError(f"{what}: {old!r} occurs {text.count(old)} times, not {count}")
        text = text.replace(old, new)
    return text


def build(texts, out_dir):
    """{name: CUDA source text} -> {name: shared library}: every copy
    written to out_dir and built at once with the library's nvcc flags."""
    from startrax_torch.kernels.build import NVCC_FLAGS, _nvcc

    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu, so = os.path.join(out_dir, f"copy{i}.cu"), os.path.join(out_dir, f"libcopy{i}.so")
        with open(cu, "w") as fp:
            fp.write(text)
        procs[name] = (so, subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{out}")
        libs[name] = so
    return libs


def load_in_place(so):
    """Loads the shared library so in place of the fused-MLP library of the
    startrax_torch on sys.path, for the rest of the process; returns it."""
    from startrax_torch.kernels import build as kbuild, fused_mlp as fm

    lib = ctypes.CDLL(so)
    kbuild._libs["fused_mlp"] = lib
    fm._lib_handle = None
    fm._partial_offsets.cache_clear()
    return lib

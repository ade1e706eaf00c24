"""Nothing the benchmark runs imports JAX or the JAX package (startrax),
compared by whole top-level names (startrax_torch begins with startrax);
the reference imports nothing of the program either."""

import ast
import glob
import os

from benchmark.run import FORBIDDEN

from .conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _files(sub=""):
    return sorted(glob.glob(os.path.join(BENCH, sub, "**", "*.py"), recursive=True))


def test_no_jax_anywhere():
    found = {(os.path.relpath(p, ROOT), m) for p in _files() for m in _imports(p)
             if m in FORBIDDEN}
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    files = _files("reference")
    assert files
    found = {(os.path.relpath(p, ROOT), m) for p in files for m in _imports(p)
             if m in ("startrax_torch", "benchmark") or m in FORBIDDEN}
    assert not found


def test_whole_names_are_compared():
    assert "startrax_torch".split(".")[0] not in FORBIDDEN
    assert "startrax" in FORBIDDEN and "jax" in FORBIDDEN

"""No module under benchmark/ imports JAX or the JAX package (by whole
top-level name), and nothing under benchmark/reference/ imports the
program under test, directly or through what it imports."""

import ast
import os
import subprocess
import sys

from benchmark.harness import common

FORBIDDEN = {"jax", "jaxlib", "flax", "multimodal_segmentation_tpu"}
PROGRAM = "multimodal_segmentation_torch"


def _modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    root = os.path.join(common.BENCH_DIR, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for path in _sources():
        tops = {m.split(".")[0] for m in _modules(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for m in _modules(path):
            assert m.split(".")[0] != PROGRAM, (path, m)
            if m.split(".")[0] == "benchmark":
                assert m.startswith("benchmark.reference"), (path, m)
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.train, benchmark.reference.batches; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & set(%r)); "
            "sys.exit(1 if bad else 0)" % (common.REPO, sorted(FORBIDDEN | {PROGRAM})))
    assert subprocess.run([sys.executable, "-c", code], timeout=300).returncode == 0

"""What the benchmark loads: never JAX or the JAX package (by top-level
name, compared whole: the port's name begins with the JAX package's), and
the reference nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from conftest import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dnsplatter_tpu"}
REFERENCE_SIDE = ("harness/reference.py", "harness/scene.py",
                  "harness/work.py")
# What takes its reference from the configuration (`cells.reference`).
REFERENCE_BY_CONFIG = ("run.py", "calibrate.py", "harness/driving.py",
                       "drivers/train.py", "drivers/render.py")


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_run_and_what_it_drives_load_no_jax():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(BENCH_DIR)!r}, {str(ROOT)!r}]\n"
        "import run, calibrate\n"
        "from harness import cells, driving, reference, scene, trace, work\n"
        "bench = cells.load_benchmark()\n"
        "for w in bench['workloads']:\n"
        "    cells.driver(cells.traffic(w['traffic'])['kind'])\n"
        "    cells.reference(cells.config(bench, w['config']))\n"
        "import dnsplatter_torch.train.trainer, dnsplatter_torch.configs\n"
        "import dnsplatter_torch.eval.evaluator\n"
        "import dnsplatter_torch.models.dn_model\n"
        "for m in bench['per_layer']:\n"
        "    cells.reader(m['name'])\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    top = _loaded(code)
    assert "dnsplatter_torch" in top
    assert not (top & FORBIDDEN), top & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(BENCH_DIR)!r}]\n"
        "from harness import reference, scene, work\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    top = _loaded(code)
    assert not (top & (FORBIDDEN | {"dnsplatter_torch"}))


def test_reference_side_sources_import_no_program():
    for rel in REFERENCE_SIDE:
        tree = ast.parse((BENCH_DIR / rel).read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {
                    "dnsplatter_torch"}, (rel, n)


def _imported(rel: str) -> list:
    out = []
    for node in ast.walk(ast.parse((BENCH_DIR / rel).read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            out += [node.module] + [f"{node.module}.{a.name}"
                                    for a in node.names]
    return out


def test_drivers_take_the_reference_the_configuration_names():
    for rel in REFERENCE_BY_CONFIG:
        assert "harness.reference" not in _imported(rel), rel

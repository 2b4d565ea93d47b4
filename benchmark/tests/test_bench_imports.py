"""What the benchmark loads: no JAX and nothing of the JAX package, compared
by whole top-level module names (the port's name begins with the JAX
package's), and a reference that loads nothing of the program."""

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "plenoctree_tpu"}


def _imports(path):
    """Top-level names of the modules a file imports."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _files(sub=""):
    for d, _, names in os.walk(os.path.join(BENCH, sub)):
        for n in names:
            if n.endswith(".py") and "tests" not in d:
                yield os.path.join(d, n)


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["plenoctree_tpu_torch", "plenoctree_tpu_torch.engine",
                                  "jaxtyping", "flaxen", "torch"]) == []
    assert run.forbidden_modules(["plenoctree_tpu.engine", "jax.numpy", "jaxlib",
                                  "flax.linen"]) == ["flax", "jax", "jaxlib", "plenoctree_tpu"]


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in _files():
        assert not (_imports(path) & FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in _files("reference"):
        assert not (_imports(path) & (FORBIDDEN | {"plenoctree_tpu_torch"})), path
        for name in _imports(path) - {"math", "numpy", "torch"}:
            assert name == "benchmark", (path, name)
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.octree_ref, "
            "benchmark.reference.nerf_ref, benchmark.scene, benchmark.roofline; "
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % ROOT)
    loaded = set(json.loads(subprocess.run([sys.executable, "-c", code], check=True,
                                           capture_output=True, text=True).stdout))
    assert not loaded & (FORBIDDEN | {"plenoctree_tpu_torch"})


def test_a_run_loads_no_jax():
    """A whole run of a cell (CPU, small sizes) in a fresh process: nothing
    of JAX or the JAX package in sys.modules once it has printed."""
    code = (
        "import sys, json, torch; sys.path.insert(0, %r)\n"
        "from benchmark import run\n"
        "ov = {'config': {'tree': {'depth': 4}}, 'traffic': {'height': 17, 'width': 17, "
        "'grid_c': 16, 'warmup_frames': 1, 'check_frames': 1, 'check_pixels': 50}}\n"
        "out = run.execute('sh16-serve-800', 3, 0.0, False, torch.device('cpu'), "
        "manifest={'end_to_end': [], 'per_layer': []}, overrides=ov)\n"
        "print(json.dumps({'found': run.forbidden_modules(), 'correct': out['correct'],\n"
        "                  'port': 'plenoctree_tpu_torch' in sys.modules}))\n" % ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["found"] == [] and got["port"]


def test_cli_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        return
    res = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "sh16-serve-800", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True)
    assert res.returncode != 0 and res.stdout.strip() == ""

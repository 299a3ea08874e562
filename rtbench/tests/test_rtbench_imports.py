"""Nothing the benchmark imports is JAX or the JAX package, and the
reference imports nothing of the port."""
import ast
import os
import subprocess
import sys

from rtbench.core import spec

ROOT = spec.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "raytracevs_tpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(sub):
    for dirpath, _, files in os.walk(os.path.join(ROOT, "rtbench", sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_source_imports_jax_and_the_reference_none_of_the_port():
    for path in sources(""):
        tops = set(imported_tops(path))
        assert not tops & FORBIDDEN, path
        if os.sep + "reference" + os.sep in path:
            assert "raytracevs_tpu_torch" not in tops and "rtbench" not in tops, path


def test_a_cell_run_loads_no_jax_module():
    """A whole run of a small cell on the CPU, then sys.modules by whole
    top-level names (raytracevs_tpu_torch begins with raytracevs_tpu)."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(1)\n"
        "from rtbench.core import runner, spec\n"
        "cell = spec.load_cell('demo.orbit')\n"
        "res = runner.run_cell(cell, 5, 2.0, False, 'cpu', time.perf_counter(), size=(16, 8))\n"
        "assert res['correct'], res['check']\n"
        "assert 'raytracevs_tpu_torch' in sys.modules\n"
        "print('FORBIDDEN', runner.forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, OMP_NUM_THREADS="1"), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_the_reference_alone_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import rtbench.reference.frame, rtbench.core.check\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'raytracevs_tpu_torch', 'raytracevs_tpu', 'jax'}))\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("[]")

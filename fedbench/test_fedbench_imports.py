"""What the benchmark loads: nothing of JAX or of the JAX package, whose
top-level name ``repro`` is compared whole (``repro_torch`` starts with
it); and the reference loads nothing of the program either."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "fedbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _sources():
    return sorted(str(p.relative_to(ROOT)) for p in BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", _sources())
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(ROOT / path)}
    assert not tops & FORBIDDEN, (path, sorted(tops & FORBIDDEN))


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (BENCH / "reference").rglob("*.py")))
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(ROOT / path)}
    assert "repro_torch" not in tops, path
    inner = {name for name in _imports(ROOT / path)
             if name.startswith("fedbench")}
    assert all(name.startswith("fedbench.reference") for name in inner)


def test_a_run_loads_no_jax_module():
    code = ("import sys, time\n"
            "sys.path[:0] = [%r, %r]\n"
            "import torch; torch.set_num_threads(1)\n"
            "from fedbench.conftest import toy_run\n"
            "toy_run('cnn-cifar10.paper4x28', trace=True)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "%r)\n"
            "print('BAD', bad)\n" % (str(ROOT), str(ROOT / "src"),
                                     tuple(sorted(FORBIDDEN))))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout


def test_the_command_refuses_a_machine_without_cards():
    out = subprocess.run(
        [sys.executable, "fedbench/run.py", "--workload",
         "cnn-cifar10.paper4x28", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=str(ROOT), env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout

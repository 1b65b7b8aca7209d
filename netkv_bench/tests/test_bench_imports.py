"""Nothing the benchmark runs imports JAX, Flax or the JAX package
(``repro``), by top-level name compared whole; the reference imports
nothing of the program."""

import ast
import subprocess
import sys

import pytest

import _paths
from nkb import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in _paths.BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(_paths.BENCH)))
def test_no_forbidden_import(path):
    found = set(_imports(path)) & FORBIDDEN
    assert not found, found
    if "reference" in path.parts:
        assert not set(_imports(path)) & {"repro_torch", "nkb"}


def test_whole_names():
    sys.modules.setdefault("repro_torch_fake_for_test", sys)
    try:
        assert "repro_torch_fake_for_test" not in harness.forbidden_modules()
    finally:
        del sys.modules["repro_torch_fake_for_test"]


def _child(code):
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=_paths.ROOT, timeout=600)


def test_a_run_loads_no_jax():
    code = (f"import sys; sys.path[:0] = [{str(_paths.BENCH)!r}, {str(_paths.ROOT / 'src')!r}]\n"
            "from nkb import harness\n"
            "r = harness.run_cell('dense-smoke.smoke-open', 3, 1.0, True, device='cpu')\n"
            "print(harness.forbidden_modules(), 'repro_torch' in sys.modules)\n")
    out = _child(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_reference_loads_no_program():
    code = (f"import sys; sys.path[:0] = [{str(_paths.BENCH)!r}]\n"
            "import reference.model, reference.decision\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'nkb'}))\n")
    out = _child(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"

"""Nothing the benchmark runs imports the JAX stack or the JAX package
(by whole top-level name: ``mtl_tpu_torch`` is the program, ``mtl_tpu``
is not), and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "mtl_tpu"}


def _files():
    out = []
    for dirpath, dirs, names in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _files(),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_imports(path):
    roots = set(_roots(path))
    assert not roots & FORBIDDEN, f"{path} imports {roots & FORBIDDEN}"
    if os.sep + "reference" + os.sep in path:
        assert "mtl_tpu_torch" not in roots, f"{path} imports the program"


def test_top_level_names_compared_whole(monkeypatch):
    import types

    import harness

    monkeypatch.setitem(sys.modules, "mtl_tpu_torch_probe.x",
                        types.ModuleType("probe"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mtl_tpu.probe",
                        types.ModuleType("probe"))
    assert harness.forbidden_modules() == ["mtl_tpu.probe"]


def test_a_run_loads_no_jax(tmp_path):
    """A whole CPU run in a fresh process, then its modules."""
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{BENCH!r}, {ROOT!r}, {os.path.dirname(__file__)!r}]\n"
        "import harness, conftest\n"
        "b = harness.load_json(conftest.ROOT + '/BENCHMARK.json')\n"
        f"conftest.tiny_run(b, 'meta.flagship', 1, {str(tmp_path)!r})\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"

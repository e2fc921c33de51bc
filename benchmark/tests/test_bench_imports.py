"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: every import statement of
every module under benchmark/, by whole top-level name."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "cam_nor_physics_tpu"}
PORT = "cam_nor_physics_tpu_torch"


def imported(path: Path) -> set[str]:
    """Top-level names of the absolute imports in `path` (importlib's
    string imports too)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


def modules():
    return sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & JAX


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert PORT not in imported(path), path
        assert "benchmark" not in imported(path), path


def test_run_refuses_loaded_jax_modules(monkeypatch):
    import sys
    import types

    from benchmark import run
    monkeypatch.setitem(sys.modules, "cam_nor_physics_tpu_torch_x",
                        types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cam_nor_physics_tpu.models",
                        types.ModuleType("y"))
    assert run.forbidden_modules() == ["cam_nor_physics_tpu.models"]


def test_exit_4_is_for_jax_alone(monkeypatch):
    """A JAX module exits 4; a missing module of the port raises."""
    from benchmark import run

    def leak(args):
        raise run.ForbiddenModules("benchmark: JAX modules loaded: jax")

    def missing(args):
        raise ModuleNotFoundError(
            "No module named 'cam_nor_physics_tpu_torch'")
    argv = ["--workload", "hs_f05.climate", "--seed", "1", "--seconds", "1"]
    monkeypatch.setattr(run, "run_cell", leak)
    assert run.main(argv) == 4
    monkeypatch.setattr(run, "run_cell", missing)
    with pytest.raises(ModuleNotFoundError):
        run.main(argv)

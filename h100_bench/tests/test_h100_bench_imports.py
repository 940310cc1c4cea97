"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: `gmix_tpu_torch` is not `gmix_tpu`), and the
reference imports nothing of the program either."""
import ast
import pytest

from h100_bench import registry, run

FORBIDDEN = {"jax", "jaxlib", "flax", "gmix_tpu"}
MODULES = sorted(p for p in registry.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.relative_to(registry.HERE).as_posix())
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((registry.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_stands_alone(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"gmix_tpu_torch", "h100_bench"})


def test_the_runs_check_compares_whole_names():
    assert run.loaded_forbidden(["torch", "gmix_tpu_torch", "gmix_tpu_torch.core.codec", "jaxtyping"]) == []
    assert run.loaded_forbidden(["gmix_tpu_torch", "gmix_tpu.config", "jax.numpy"]) == ["gmix_tpu", "jax"]

"""No module of the benchmark loads JAX or the JAX package, and the plain
reference loads nothing of the program: import names compared by their
whole top-level part (lightgbm_tpu_torch begins with lightgbm_tpu)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "lightgbm_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module",) and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_jax_import(path):
    assert not FORBIDDEN & set(_imports(path)), path


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "lightgbm_tpu_torch" not in set(_imports(path)), path


def test_whole_name_compare(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import lightgbm_tpu_torch\n"
                 "from lightgbm_tpu_torch.ops import x\n")
    assert set(_imports(p)) == {"lightgbm_tpu_torch"}
    assert not FORBIDDEN & set(_imports(p))
    p.write_text("import jax.numpy as jnp\n")
    assert FORBIDDEN & set(_imports(p)) == {"jax"}

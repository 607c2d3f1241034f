"""No module of the benchmark imports JAX or the JAX package, and no module
of the reference imports the port. Each import's top-level name is
compared whole: ``movae_tpu_torch`` is not ``movae_tpu``."""

import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "movae_tpu"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


MODULES = sorted(PB.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "movae_tpu_torch" not in set(top_level_imports(path))


def test_the_check_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import movae_tpu_torch.models\nfrom movae_tpu.x import y\n")
    assert list(top_level_imports(f)) == ["movae_tpu_torch", "movae_tpu"]

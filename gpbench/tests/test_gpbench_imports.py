"""No file of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: each import's top-level name,
the part before the first dot, compared whole."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)
    assert "gpbench" not in top_level_imports(path)


def test_whole_names_compared():
    """``repro_torch`` begins with ``repro`` and is allowed; ``repro`` is not."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "m.py"
        p.write_text("import repro_torch.gp\nfrom repro_torch import ExactGP\n")
        assert not top_level_imports(p) & FORBIDDEN
        p.write_text("from repro.core import mbcg\n")
        assert top_level_imports(p) & FORBIDDEN == {"repro"}

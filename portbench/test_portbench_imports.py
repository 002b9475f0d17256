"""What the benchmark may import and where it refuses to run."""
import ast
import pathlib
import subprocess
import sys

import pytest

from portbench.harness import chip

PACKAGE = pathlib.Path(__file__).resolve().parent
FOREIGN = {"jax", "jaxlib", "flax", "repro"}


def _top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


SOURCES = sorted(PACKAGE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PACKAGE)))
def test_no_jax_or_jax_package(path):
    assert not set(_top_level_imports(path)) & FOREIGN


def test_reference_imports_nothing_of_the_port():
    for path in (PACKAGE / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_top_level_imports(path)), path
        assert "portbench" not in set(_top_level_imports(path)), path


def test_foreign_modules_compare_whole_top_level_names():
    mods = {"repro_torch.core": 1, "jaxtyping": 1, "numpy": 1}
    assert chip.foreign_modules(mods) == []
    assert chip.foreign_modules({**mods, "jax.numpy": 1, "repro.core": 1}) \
        == ["jax", "repro"]


def test_run_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would measure")
    out = subprocess.run(
        [sys.executable, str(PACKAGE / "run.py"), "--workload",
         "xl500-train-b32", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

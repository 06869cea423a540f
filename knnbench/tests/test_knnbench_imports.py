"""Nothing the benchmark runs imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``), and the
yardstick imports nothing of the program."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: modules that judge the program: they may not import it
YARDSTICK = {"reference.py", "compare.py", "roofline.py", "data.py", "traffic.py",
             "stats.py", "trace.py", "energy.py", "spec.py", "control.py"}


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("name", sorted(YARDSTICK))
def test_the_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in imported(HERE / name)


def test_the_check_compares_top_level_names_whole():
    from knnbench.harness import FORBIDDEN as RUNTIME

    assert set(RUNTIME) == FORBIDDEN
    assert "repro_torch".split(".")[0] not in FORBIDDEN

"""Nothing under bench_torch/ imports JAX or the JAX package, and the
yardstick (references, metric readers, counts) imports nothing of the
program: only the harness reaches the port, through its public package."""

import ast
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH_DIR.rglob("*.py"))


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def top(name: str) -> str:
    return name.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    bad = {n for n in imported(path) if top(n) in ("jax", "jaxlib", "bhr_tpu")}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name in ("reference", "metrics")],
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert not {n for n in imported(path) if top(n) == "bhr_tpu_torch"}


def test_only_the_harness_reaches_the_program():
    users = {p.name for p in FILES if p.parent == BENCH_DIR
             and any(top(n) == "bhr_tpu_torch" for n in imported(p))}
    assert users == {"harness.py"}

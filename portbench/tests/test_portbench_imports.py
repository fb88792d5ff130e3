"""Nothing under portbench/ imports JAX or the JAX package, and nothing
under portbench/reference/ imports the program under test: each import's
top-level module name compared whole."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(HERE) for f in fs
               if f.endswith(".py"))


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(imported_tops(path)) & {"jax", "jaxlib", "flax",
                                           "st_ito_tpu"}


@pytest.mark.parametrize("path", [p for p in FILES if os.sep + "reference"
                                  + os.sep in p],
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_takes_nothing_of_the_program(path):
    assert "st_ito_torch" not in set(imported_tops(path))


def test_top_level_names_are_compared_whole():
    src = "import st_ito_torch_x\nfrom jaxy import a\n"
    tmp = os.path.join(HERE, "tests", "_probe_imports.txt")
    with open(tmp, "w") as f:
        f.write(src)
    try:
        assert set(imported_tops(tmp)) == {"st_ito_torch_x", "jaxy"}
    finally:
        os.remove(tmp)

"""``examples/generate_notebooks.py``: one notebook an example, as the
reference's generator writes them (``nbformat`` v4: the docstring as a
markdown cell, the source, and ``main([])``), each valid and each code
cell valid Python."""

import ast
import os

import pytest

from optimization_dynamics_tpu.examples import (
    generate_notebooks as jax_generate)
from optimization_dynamics_tpu_torch.examples import generate_notebooks as gen

nbf = pytest.importorskip("nbformat")


def test_same_examples_as_the_reference():
    assert gen.EXAMPLES == jax_generate.EXAMPLES


def test_every_notebook_parses(tmp_path):
    gen.main(str(tmp_path))
    names = sorted(f[:-6] for f in os.listdir(tmp_path))
    assert names == sorted(gen.EXAMPLES)
    for name in gen.EXAMPLES:
        nb = nbf.read(str(tmp_path / (name + ".ipynb")), as_version=4)
        nbf.validate(nb)
        kinds = [c.cell_type for c in nb.cells]
        assert kinds == ["markdown", "code", "code"], name
        assert nb.cells[0].source.startswith("# ")
        for cell in nb.cells[1:]:
            ast.parse(cell.source)
        # in a kernel sys.argv holds the kernel's arguments: the closing
        # cell passes the example its defaults explicitly
        assert nb.cells[2].source == "main([])"
        assert "import jax" not in nb.cells[1].source

"""Generate Jupyter notebooks from the example modules.

Port of ``optimization_dynamics_tpu/examples/generate_notebooks.py``: each
example in ``EXAMPLES`` becomes a notebook of its module docstring (a
markdown cell), its source (a code cell) and a closing cell that runs
its ``main``. The port's mains parse their arguments, and in a notebook
kernel ``sys.argv`` holds the kernel's own (``-f <kernel.json>``), so the
closing cell is ``main([])``: the example's defaults, on the card.

It needs ``nbformat``; it writes files and runs nothing, a host tool.
The default ``outdir`` is ``notebooks_torch``, beside the reference's
``notebooks``.

Usage: python -m optimization_dynamics_tpu_torch.examples.generate_notebooks [outdir]
"""

from __future__ import annotations

import os
import sys

EXAMPLES = ["acrobot", "cartpole", "planar_push", "rocket", "hopper",
            "sweep"]


def module_to_notebook(py_path: str, nb_path: str) -> None:
    import nbformat as nbf

    with open(py_path) as f:
        src = f.read()
    nb = nbf.v4.new_notebook()
    cells = []

    # module docstring -> intro markdown
    body = src
    if body.startswith('"""'):
        end = body.index('"""', 3)
        doc = body[3:end].strip()
        cells.append(nbf.v4.new_markdown_cell("# " + doc))
        body = body[end + 3:]

    code = body.strip()
    if code:
        cells.append(nbf.v4.new_code_cell(code))
        cells.append(nbf.v4.new_code_cell("main([])"))

    nb["cells"] = cells
    with open(nb_path, "w") as f:
        nbf.write(nb, f)


def main(outdir: str = "notebooks_torch") -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(outdir, exist_ok=True)
    for name in EXAMPLES:
        py = os.path.join(here, name + ".py")
        if not os.path.exists(py):
            continue
        nb = os.path.join(outdir, name + ".ipynb")
        module_to_notebook(py, nb)
        print("wrote", nb)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "notebooks_torch")

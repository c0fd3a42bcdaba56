"""Import rules of the PyTorch port, checked on the source (AST).

The port and its chip smoke script import neither JAX (nor flax, optax,
orbax) nor anything of the JAX package, and none of the libraries the
machine with the card lacks (safetensors, ml_dtypes, pydantic). Every CUDA
source under csrc/ is built.
"""

import ast
import os

import pytest

from specforge_tpu_torch.ops import cuda_lib

REPO = os.path.join(os.path.dirname(__file__), "..")
PKG = os.path.join(REPO, "specforge_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes",
             "safetensors", "pydantic", "specforge_tpu")


def _sources():
    for root, _dirs, files in os.walk(PKG):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", list(_sources()), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_jax_or_jax_package_imports(path):
    bad = sorted({m for m in _top_level_imports(path) if m in FORBIDDEN})
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_every_cuda_source_is_built():
    csrc = os.path.join(PKG, "csrc")
    on_disk = sorted(
        n for n in os.listdir(csrc) if n.endswith((".cu", ".cuh"))
    )
    assert sorted(n for n in on_disk if n.endswith(".cu")) == sorted(
        cuda_lib.SOURCES
    )
    for name in on_disk:
        text = open(os.path.join(csrc, name)).read()
        assert "Replaces" in text and "bound" in text, (
            f"{name} lacks its note: the TPU kernel it replaces and what "
            "bounds it"
        )

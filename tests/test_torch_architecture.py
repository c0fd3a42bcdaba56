"""Import rules of the PyTorch port, checked on the source (AST).

The port and its chip smoke script import neither JAX (nor flax, optax,
orbax) nor anything of the JAX package, and none of the libraries the
machine with the card lacks (safetensors, ml_dtypes, pydantic). Every CUDA
source under csrc/ is built, and none uses an atomic operation.
"""

import ast
import os
import re

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
    yield os.path.join(REPO, "kernel_compare.py")


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
    # every header is hashed into the library's name, so an edited header
    # is rebuilt
    assert sorted(n for n in on_disk if n.endswith(".cuh")) == sorted(
        cuda_lib.HEADERS
    )
    for name in on_disk:
        text = open(os.path.join(csrc, name)).read()
        assert "Replaces" in text and "bound" in text, (
            f"{name} lacks its note: the TPU kernel it replaces and what "
            "bounds it"
        )


def _hopper_kernels():
    """The kernels of csrc/ launched one block an SM
    (``__launch_bounds__(..., 1)``): the warp-specialised Hopper designs."""
    for name in cuda_lib.SOURCES:
        text = _code_without_comments(
            open(os.path.join(PKG, "csrc", name)).read())
        yield from re.findall(
            r"__launch_bounds__\(\s*\w+\s*,\s*1\s*\)\s*(\w+)\s*\(", text)


def test_every_hopper_kernel_is_reported_by_chip_smoke():
    """chip_smoke.py's build phase reports registers and spills of, and
    fails on a wgmma serialization note in, every Hopper kernel: its
    HOPPER_KERNELS names each of them, and nothing else."""
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    named = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and any(getattr(t, "id", None) == "HOPPER_KERNELS"
                         for t in node.targets))
    found = sorted(_hopper_kernels())
    assert {"dflash_bwd_dq_kernel", "cod_bwd_dq_kernel",
            "ttt_bwd_dq_kernel", "lse_bwd_dq_kernel",
            "lse_bwd_dkv_kernel"} <= set(found)
    assert found == sorted(named)


@pytest.mark.parametrize("kernel,stream", [
    ("lse_bwd_dq_kernel", "dq_stream_block"),
    ("lse_bwd_dkv_kernel", "dkv_stream_block"),
])
def test_lse_backward_kernels_run_on_the_streams(kernel, stream):
    """The LSE ring hop's backward kernels are Hopper designs (one block an
    SM, which HOPPER_KERNELS names: the test above) whose bodies hand the
    block to the shared dq or dk/dv stream."""
    text = _code_without_comments(
        open(os.path.join(PKG, "csrc", "lse_attention.cu")).read())
    assert kernel in re.findall(
        r"__launch_bounds__\(\s*\w+\s*,\s*1\s*\)\s*(\w+)\s*\(", text)
    body = text[text.index(kernel + "("):]
    body = body[:body.index("\n}\n")]
    assert stream + "<D>(" in body


@pytest.mark.parametrize("source,kernel", [
    ("lse_attention.cu", "lse_fwd_kernel"),
    ("peagle_attention.cu", "cod_fwd_kernel"),
    ("dflash_attention.cu", "dflash_fwd_kernel"),
])
def test_forwards_run_on_the_forward_stream(source, kernel):
    """The LSE, COD and DFlash forwards are Hopper designs (one block an SM,
    which HOPPER_KERNELS names) whose bodies hand the block to the shared
    forward stream, and the first design's cp.async is gone from their
    sources, and its mma.sync too, but for the DFlash dq kernel's draft
    dk/dv sums (DFlashDq::chunk_done) in dflash_attention.cu."""
    text = _code_without_comments(
        open(os.path.join(PKG, "csrc", source)).read())
    assert kernel in re.findall(
        r"__launch_bounds__\(\s*\w+\s*,\s*1\s*\)\s*(\w+)\s*\(", text)
    body = text[text.index(kernel + "("):]
    body = body[:body.index("\n}\n")]
    assert "fwd_stream_block<D>(" in body
    assert "cp.async.cg" not in text
    if source != "dflash_attention.cu":
        assert "mma.sync" not in text


def test_usp_slice_is_built_and_imports_nothing_of_jax():
    """The LSE ring-hop source is built, and the parallel package (the
    process runtime, the rank grid, USP, fsdp) is among the checked
    sources."""
    assert "lse_attention.cu" in cuda_lib.SOURCES
    parallel = sorted(p for p in _sources()
                      if os.sep + "parallel" + os.sep in p)
    assert [os.path.basename(p) for p in parallel] == [
        "__init__.py", "fsdp.py", "mesh.py", "multihost.py", "usp.py"]
    for path in parallel:
        assert not {m for m in _top_level_imports(path) if m in FORBIDDEN}


#: atomic operations in CUDA C++ (atomicAdd, atomicCAS, ...) and in inline
#: PTX (atom, red, the bulk reductions cp.reduce.async.bulk)
ATOMIC = re.compile(
    r"\batomic[A-Z]\w*\s*\(|\batom\.|\bred\.|cp\.reduce\.async|"
    r"\bcuda::atomic|std::atomic")


def _code_without_comments(text):
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


@pytest.mark.parametrize("name",
                         sorted(cuda_lib.SOURCES + cuda_lib.HEADERS))
def test_no_cuda_source_uses_atomics(name):
    """The port's determinism rule: every sum is taken in a fixed order, so
    two runs (and a resume) give the same bits; no kernel may use an atomic
    operation, whose order changes from run to run."""
    text = open(os.path.join(PKG, "csrc", name)).read()
    found = ATOMIC.findall(_code_without_comments(text))
    assert not found, f"{name} uses atomic operations: {found}"


def test_atomic_pattern_finds_what_it_must():
    """The check above is not vacuous: it finds the forms it forbids, and
    not the words of a comment."""
    for code in ("atomicAdd(p, 1.f);", "asm(\"red.global.add.f32 [%0], %1;\");",
                 "asm(\"atom.global.cas.b32 %0, [%1], %2, %3;\");",
                 "asm(\"cp.reduce.async.bulk.global.shared::cta.add.f32\");"):
        assert ATOMIC.search(_code_without_comments(code)), code
    assert not ATOMIC.search(_code_without_comments(
        "// no atomics: red. and atomicAdd( in a comment\nint x = 0;"))

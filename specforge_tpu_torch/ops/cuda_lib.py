"""Build and load the port's hand-written CUDA kernels.

Every ``.cu`` file of :data:`SOURCES` (under ``specforge_tpu_torch/csrc/``) is
compiled by ``nvcc`` for ``sm_90a`` into an object, all of them at once, and
the objects are linked into one shared library with a plain C interface,
loaded with :mod:`ctypes`. The build happens at first use, into
``specforge_tpu_torch/_build/`` (listed in ``.gitignore``); the library's name
carries a hash of the sources and flags, so an edited source is rebuilt.

Nothing here runs when the module is imported: the CPU tests import every
module, and ``nvcc`` is only reached when a kernel is first launched on a
CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

#: every kernel source of the library; tests check that csrc/ holds no other
SOURCES = ("ttt_attention.cu", "fused_ce.cu", "dflash_attention.cu",
           "peagle_attention.cu", "lse_attention.cu")
#: the headers the sources include
HEADERS = ("hopper.cuh", "dkv_stream.cuh", "dq_stream.cuh",
           "fwd_stream.cuh")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: compiler output of the last build (ptxas register/spill report), and its
#: wall time in seconds; None when the library came from an earlier build
build_log: Optional[str] = None
build_seconds: Optional[float] = None


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the port's kernels are built from "
        "specforge_tpu_torch/csrc at first use"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link the shared library."""
    global build_log, build_seconds
    so = BUILD_DIR / f"libspecforge_kernels-{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}-{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    logs = []
    failed = []
    for name, _obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(logs)
        )
    tmp = BUILD_DIR / f"{so.name}.tmp.{os.getpid()}"
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         *[str(obj) for _, obj, _ in procs], "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}")
    os.replace(tmp, so)
    build_log = "\n".join(logs)
    build_seconds = time.perf_counter() - t0
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.ttt_attention_fwd.argtypes = [
                p, p, p, p, i, p, p, p, p, p, p, i, i, i, i, i, p,
            ]
            lib.ttt_attention_fwd.restype = i
            # dq: dq, branch dk, branch dv and the fp32 workspace; dk/dv: dk, dv
            for name, n_out in (("ttt_attention_bwd_dq", 4),
                                ("ttt_attention_bwd_dkv", 2)):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, p, p, i, p, p, p, p, p, p, p,
                               *[p] * n_out, i, i, i, i, i, p]
                fn.restype = i
            ll = ctypes.c_longlong
            lib.fused_ce_fwd.argtypes = [p, i, p, p, p, p, p, p, i, i, i, ll,
                                         p]
            lib.fused_ce_fwd.restype = i
            lib.fused_ce_bwd.argtypes = [p, i, p, p, p, p, p, p, p, i, i, i,
                                         ll, p]
            lib.fused_ce_bwd.restype = i
            # tensors (5 pointers), strides (15 int64), anchors, keep, ...
            lib.dflash_attention_fwd.argtypes = [p, p, p, p, p, p, p,
                                                 *[i] * 8, p]
            lib.dflash_attention_fwd.restype = i
            # ... dout, m, l, delta, then dq, draft dk, draft dv, the fp32
            # workspace and the resident heads; or the context dk, dv
            lib.dflash_attention_bwd_dq.argtypes = [p] * 12 + [i] * 9 + [p]
            lib.dflash_attention_bwd_dq.restype = i
            lib.dflash_attention_bwd_dkv.argtypes = [p] * 10 + [i] * 8 + [p]
            lib.dflash_attention_bwd_dkv.restype = i
            # tensors (3 pointers), strides (9 int64), props, tiles, the
            # full-tile flags, the block order, out, m, l, ...
            lib.cod_attention_fwd.argtypes = [p] * 9 + [i] * 5 + [p]
            lib.cod_attention_fwd.restype = i
            # ... the full-tile flags, the block order, dout, m, l, delta
            # and the outputs (dq; dk, dv)
            lib.cod_attention_bwd_dq.argtypes = [p] * 11 + [i] * 5 + [p]
            lib.cod_attention_bwd_dq.restype = i
            lib.cod_attention_bwd_dkv.argtypes = [p] * 12 + [i] * 5 + [p]
            lib.cod_attention_bwd_dkv.restype = i
            # q, k, v, valid, outputs..., BH, Sq, Sk, D, row_off, col_off
            lib.lse_attention_fwd.argtypes = [p, p, p, p, p, p, *[i] * 6, p]
            lib.lse_attention_fwd.restype = i
            lib.lse_attention_bwd_dq.argtypes = [p, p, p, p, p, p, p, p,
                                                 *[i] * 6, p]
            lib.lse_attention_bwd_dq.restype = i
            lib.lse_attention_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, p,
                                                  *[i] * 6, p]
            lib.lse_attention_bwd_dkv.restype = i
            lib.specforge_cuda_error_string.argtypes = [i]
            lib.specforge_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(status: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if status != 0:
        msg = library().specforge_cuda_error_string(status).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {status} ({msg})")

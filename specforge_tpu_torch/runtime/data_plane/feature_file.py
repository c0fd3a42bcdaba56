"""On-disk feature files for offline training (``{sample_id}.sft``, and the
reference's ``.ckpt`` / ``.ckpt.gz``).

Counterpart of ``specforge_tpu/runtime/data_plane/feature_file.py``. The
native ``.sft`` files use the safetensors layout, read and written here
directly so the port needs neither ``safetensors`` nor ``ml_dtypes``:

    8-byte little-endian header length N | N bytes of JSON header | raw data

The header maps each tensor name to ``{"dtype", "shape", "data_offsets"}``
(offsets into the data section) plus an optional ``"__metadata__"`` dict of
strings; it is padded with spaces to a multiple of 8 bytes. Tensors are
``torch`` tensors on the CPU; bf16 travels as its raw 2-byte patterns.

The reference writes its offline hidden states as ``torch.save`` pickles of
a dict of tensors (gzipped for ``.ckpt.gz``); :func:`load_feature_file`
reads them with ``weights_only=True``, bf16 as it was stored, with empty
metadata, and :func:`convert_ckpt_to_safetensors` rewrites one as ``.sft``.
"""

from __future__ import annotations

import gzip
import io
import json
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import torch

from specforge_tpu_torch.runtime.contracts import FeatureSpec

_CODES = {
    torch.bfloat16: "BF16", torch.float32: "F32", torch.float16: "F16",
    torch.float64: "F64", torch.int64: "I64", torch.int32: "I32",
    torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8",
    torch.uint16: "U16", torch.uint32: "U32", torch.bool: "BOOL",
}
_DTYPES = {code: dtype for dtype, code in _CODES.items()}
#: safetensors code → the data plane's dtype names
DTYPE_NAMES = {
    "BF16": "bfloat16", "F32": "float32", "F16": "float16", "F64": "float64",
    "I64": "int64", "I32": "int32", "I16": "int16", "I8": "int8",
    "U8": "uint8", "U16": "uint16", "U32": "uint32", "BOOL": "bool",
}


def save_feature_file(
    path: str,
    tensors: Mapping[str, torch.Tensor],
    metadata: Optional[Mapping[str, str]] = None,
) -> None:
    """Write CPU tensors (and string metadata) as one feature file,
    published by an atomic rename."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        if t.dtype not in _CODES:
            raise TypeError(f"feature {name!r} has unsupported dtype {t.dtype}")
        # the tensor's own bytes, written without a copy
        raw = t.reshape(-1).view(torch.uint8).numpy()
        header[name] = {
            "dtype": _CODES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + raw.nbytes],
        }
        blobs.append(raw)
        offset += raw.nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    os.replace(tmp, path)


def _read_header(f) -> Tuple[Dict[str, dict], Dict[str, str], int]:
    (n,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(n))
    metadata = header.pop("__metadata__", None) or {}
    return header, dict(metadata), 8 + n


def read_feature_specs(path: str) -> Tuple[Dict[str, FeatureSpec], Dict[str, str]]:
    """Header-only read: specs + metadata without loading tensor bytes."""
    with open(path, "rb") as f:
        header, metadata, _ = _read_header(f)
    specs = {
        name: FeatureSpec(name=name, shape=tuple(info["shape"]),
                          dtype=DTYPE_NAMES[info["dtype"]])
        for name, info in header.items()
    }
    return specs, metadata


def read_safetensors_keys(path: str) -> Tuple[str, ...]:
    """Tensor names of a safetensors file (header only)."""
    with open(path, "rb") as f:
        header, _, _ = _read_header(f)
    return tuple(header)


def read_safetensors_tensors(path: str, names) -> Dict[str, torch.Tensor]:
    """The tensors ``names`` of a safetensors file (a target checkpoint
    shard): the bytes from the first of them to the last read in one go
    into one buffer, each tensor a view of it (a copy where its offset
    does not suit its dtype's alignment)."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        header, _, start = _read_header(f)
        missing = [n for n in names if n not in header]
        if missing:
            raise KeyError(f"{missing} not in {path}")
        spans = [header[n]["data_offsets"] for n in names]
        base = min((lo for lo, _ in spans), default=0)
        blob = torch.empty(max((hi for _, hi in spans), default=0) - base,
                           dtype=torch.uint8)
        f.seek(start + base)
        if f.readinto(blob.numpy()) != blob.numel():
            raise ValueError(f"{path} ends before its tensors' data")
    for name in names:
        info = header[name]
        lo, hi = info["data_offsets"]
        dtype = _DTYPES[info["dtype"]]
        raw = blob[lo - base:hi - base]
        if (lo - base) % dtype.itemsize:
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def read_safetensors_header(path: str) -> Dict[str, dict]:
    """The tensor entries of a safetensors file's header (dtype code,
    shape, data offsets)."""
    with open(path, "rb") as f:
        header, _, _ = _read_header(f)
    return header


def read_safetensors_slices(
    path: str, slices: Mapping[str, Optional[Tuple[int, int, int]]]
) -> Dict[str, torch.Tensor]:
    """The tensors named in ``slices`` of a safetensors file, each whole
    (value None) or cut to ``(dim, start, length)`` along one dimension.
    The file is mapped, not read: a cut touches only the pages that hold
    its bytes (a strided cut, its rows' runs of them)."""
    import numpy as np

    with open(path, "rb") as f:
        header, _, start = _read_header(f)
    missing = [n for n in slices if n not in header]
    if missing:
        raise KeyError(f"{missing} not in {path}")
    out: Dict[str, torch.Tensor] = {}
    for name, cut in slices.items():
        info = header[name]
        dtype = _DTYPES[info["dtype"]]
        shape = list(info["shape"])
        lo, hi = info["data_offsets"]
        if hi == lo:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = np.memmap(path, dtype=np.uint8, mode="r", offset=start + lo,
                        shape=(hi - lo,))
        # the element's bytes as a last axis, so any dtype cuts alike
        view = raw.reshape(shape + [dtype.itemsize])
        if cut is not None:
            dim, first, length = cut
            view = view[(slice(None),) * dim + (slice(first,
                                                      first + length),)]
            shape[dim] = length
        data = torch.from_numpy(np.array(view, order="C"))  # a copy
        del raw, view
        out[name] = data.reshape(-1).view(dtype).reshape(shape)
    return out


def _load_torch_ckpt(path: str) -> Dict[str, torch.Tensor]:
    """A reference-format ``torch.save`` dict (gzip for ``.gz``) as CPU
    tensors; a value that is not a tensor becomes one."""
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            src = io.BytesIO(f.read())
    else:
        src = path
    obj = torch.load(src, map_location="cpu", weights_only=True)
    return {key: value.detach().contiguous() if isinstance(value, torch.Tensor)
            else torch.as_tensor(value)
            for key, value in obj.items()}


def load_feature_file(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """Load tensors (CPU) and metadata of one feature file: ``.sft``
    (native), or ``.ckpt`` / ``.ckpt.gz`` (reference, no metadata)."""
    if path.endswith((".ckpt", ".ckpt.gz")):
        return _load_torch_ckpt(path), {}
    with open(path, "rb") as f:
        header, metadata, start = _read_header(f)
        f.seek(start)
        data = bytearray(f.read())
    tensors: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        lo, hi = info["data_offsets"]
        dtype = _DTYPES[info["dtype"]]
        if hi > lo:
            raw = torch.frombuffer(data, dtype=torch.uint8, count=hi - lo,
                                   offset=lo).clone()
        else:
            raw = torch.empty(0, dtype=torch.uint8)
        tensors[name] = raw.view(dtype).reshape(info["shape"])
    return tensors, metadata


def convert_ckpt_to_safetensors(
    src: str, dst: str, metadata: Optional[Mapping[str, str]] = None
) -> None:
    """Rewrite a reference ``.ckpt`` / ``.ckpt.gz`` feature file as ``.sft``."""
    save_feature_file(dst, _load_torch_ckpt(src), metadata)

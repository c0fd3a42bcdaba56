"""On-disk feature files for offline training (``{sample_id}.sft``).

Counterpart of ``specforge_tpu/runtime/data_plane/feature_file.py``, for the
``.sft`` format only. The files use the safetensors layout, read and written
here directly so the port needs neither ``safetensors`` nor ``ml_dtypes``:

    8-byte little-endian header length N | N bytes of JSON header | raw data

The header maps each tensor name to ``{"dtype", "shape", "data_offsets"}``
(offsets into the data section) plus an optional ``"__metadata__"`` dict of
strings; it is padded with spaces to a multiple of 8 bytes. Tensors are
``torch`` tensors on the CPU; bf16 travels as its raw 2-byte patterns.
"""

from __future__ import annotations

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
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {
            "dtype": _CODES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + len(raw)],
        }
        blobs.append(raw)
        offset += len(raw)
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


def load_feature_file(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """Load tensors (CPU) and metadata of one ``.sft`` feature file."""
    if not path.endswith(".sft"):
        raise ValueError(
            f"{path}: only .sft feature files are read by the port (the "
            "reference .ckpt reader is not ported yet)"
        )
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

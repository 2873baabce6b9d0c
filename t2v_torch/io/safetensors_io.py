"""Safetensors reading and writing (LoRA files, weights, train states).

Self-contained: the format is a u64 header length, a JSON header mapping
names to {dtype, shape, data_offsets}, then a flat byte buffer; no
``safetensors`` package is needed. ``load_safetensors`` is the port's own
copy of the JAX package's reader (numpy out, bf16 through ``ml_dtypes``
where that is installed); ``save_safetensors`` is the writer beside it;
``load_torch`` / ``save_torch`` carry torch tensors, bfloat16 included,
without ``ml_dtypes``.
"""

from __future__ import annotations

import json
import struct
from typing import Mapping

import numpy as np

try:
    import ml_dtypes

    _BF16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    _BF16 = None

_DTYPES = {
    "F64": np.dtype("<f8"),
    "F32": np.dtype("<f4"),
    "F16": np.dtype("<f2"),
    "BF16": _BF16,
    "I64": np.dtype("<i8"),
    "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"),
    "U8": np.dtype("u1"),
    "BOOL": np.dtype("bool"),
}


def read_safetensors_metadata(path: str) -> dict[str, str] | None:
    """The ``__metadata__`` of a file's header (None when it has none),
    reading only the header. Raises ``ValueError`` on a file that is not
    safetensors."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: too short for a safetensors header")
        (header_len,) = struct.unpack("<Q", head)
        raw = f.read(header_len)
    header = json.loads(raw)  # a ValueError where the bytes are no JSON
    if len(raw) != header_len or not isinstance(header, dict):
        raise ValueError(f"{path}: malformed safetensors header")
    return header.get("__metadata__")


def load_safetensors(
    path: str, *, float32: bool = True
) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Returns (tensors, metadata)."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        body = f.read()

    metadata = header.pop("__metadata__", {}) or {}
    tensors: dict[str, np.ndarray] = {}
    for name, info in header.items():
        dtype = _DTYPES[info["dtype"]]
        if dtype is None:
            raise ValueError(f"bf16 tensor {name} needs ml_dtypes")
        start, end = info["data_offsets"]
        arr = np.frombuffer(body[start:end], dtype=dtype).reshape(info["shape"])
        if float32 and info["dtype"] in ("F16", "BF16"):
            arr = arr.astype(np.float32)
        tensors[name] = arr
    return tensors, metadata


# the reference writer lays tensors out by dtype, widest first (its dtype
# enum's order, reversed), then by name
_WRITE_ORDER = ("U64", "I64", "F64", "F32", "U32", "I32", "BF16", "F16", "U16", "I16", "I8",
                "U8", "BOOL")


def _write(path: str, entries: list[tuple[str, str, tuple[int, ...], bytes]],
           metadata: Mapping[str, str] | None) -> str:
    entries = sorted(entries, key=lambda e: (_WRITE_ORDER.index(e[1]), e[0]))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, tag, shape, raw in entries:
        header[name] = {"dtype": tag, "shape": list(shape),
                        "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the buffer starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, _, _, raw in entries:
            f.write(raw)
    return path


def save_safetensors(path: str, tensors: Mapping[str, np.ndarray],
                     metadata: Mapping[str, str] | None = None) -> str:
    """Write numpy arrays, laid out as the reference writer lays them out."""
    tags = {v: k for k, v in _DTYPES.items() if v is not None}
    entries = []
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])  # tobytes() below is C-ordered
        dtype = arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">" else arr.dtype
        if dtype not in tags:
            raise ValueError(f"{name}: dtype {arr.dtype} has no safetensors tag")
        entries.append((name, tags[dtype], arr.shape, arr.astype(dtype, copy=False).tobytes()))
    return _write(path, entries, metadata)


def _torch_tags():
    import torch

    return {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
            torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
            torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


def save_torch(path: str, tensors: Mapping, metadata: Mapping[str, str] | None = None) -> str:
    """Write torch tensors (any device) in their own dtypes; bfloat16 goes
    out as its raw 16-bit words."""
    import torch

    tags = _torch_tags()
    entries = []
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        entries.append((name, tags[t.dtype], tuple(t.shape), raw.numpy().tobytes()))
    return _write(path, entries, metadata)


def load_torch(path: str) -> tuple[dict, dict[str, str]]:
    """Returns (tensors, metadata) with torch CPU tensors in the file's dtypes."""
    import torch

    by_tag = {v: k for k, v in _torch_tags().items()}
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        body = f.read()
    metadata = header.pop("__metadata__", {}) or {}
    tensors = {}
    for name, info in header.items():
        start, end = info["data_offsets"]
        dtype = by_tag[info["dtype"]]
        raw = np.frombuffer(body[start:end],
                            dtype=np.int16 if dtype == torch.bfloat16 else _DTYPES[info["dtype"]])
        t = torch.from_numpy(raw.copy())
        if dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        tensors[name] = t.reshape(info["shape"])
    return tensors, metadata

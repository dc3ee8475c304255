"""Pipeline folder persistence, in the JAX package's on-disk layout.

Counterpart of ``phendiff_tpu/pipelines/io.py``: a ``model_index.json``
naming the components, and per component a ``config.json`` plus a
``params.safetensors`` of the flattened Flax param tree ('/'-joined keys,
float32).  The safetensors format is read and written here by a small
codec of its own (the ``safetensors`` package is not a dependency of the
port): an 8-byte little-endian header length, a JSON header giving each
tensor's dtype, shape and byte range, then the raw little-endian bytes.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

WEIGHTS_NAME = "params.safetensors"
CONFIG_NAME = "config.json"
MODEL_INDEX = "model_index.json"

_DTYPES = {
    "F64": np.dtype("<f8"),
    "F32": np.dtype("<f4"),
    "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"),
    "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"),
    "U8": np.dtype("u1"),
    "BOOL": np.dtype("?"),
}
_CODES = {v: k for k, v in _DTYPES.items()}
_MAX_HEADER = 100 * 1024 * 1024


def save_safetensors(tensors: Mapping[str, np.ndarray], path: str) -> None:
    header, chunks, offset = {}, [], 0
    for name in sorted(tensors):
        a = np.asarray(tensors[name])
        dt = a.dtype.newbyteorder("<") if a.dtype.byteorder == ">" else a.dtype
        if dt not in _CODES:
            raise TypeError(f"{name}: dtype {a.dtype} not supported")
        raw = np.ascontiguousarray(a, dtype=dt).tobytes()
        header[name] = {
            "dtype": _CODES[dt], "shape": list(a.shape),
            "data_offsets": [offset, offset + len(raw)],
        }
        chunks.append(raw)
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for raw in chunks:
            f.write(raw)


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: truncated safetensors file")
    (n,) = struct.unpack("<Q", data[:8])
    if n > _MAX_HEADER or 8 + n > len(data):
        raise ValueError(f"{path}: bad safetensors header length {n}")
    header = json.loads(data[8:8 + n])
    body = memoryview(data)[8 + n:]
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _DTYPES:
            raise TypeError(f"{name}: dtype {meta['dtype']} not supported")
        dt = _DTYPES[meta["dtype"]]
        start, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        if not 0 <= start <= end <= len(body) or end - start != dt.itemsize * int(np.prod(shape)):
            raise ValueError(f"{path}: bad byte range for {name}")
        out[name] = np.frombuffer(body[start:end], dtype=dt).reshape(shape).copy()
    return out


def save_component(dirpath: str, config: dict,
                   params: Optional[Mapping[str, np.ndarray]] = None) -> None:
    """Write ``config.json`` and, given flat params, ``params.safetensors``."""
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, CONFIG_NAME), "w") as f:
        json.dump(config, f, indent=2, sort_keys=True)
    if params is not None:
        save_safetensors(params, os.path.join(dirpath, WEIGHTS_NAME))


def load_component(dirpath: str) -> Tuple[dict, Optional[Dict[str, np.ndarray]]]:
    """(config, flat params or None)."""
    with open(os.path.join(dirpath, CONFIG_NAME)) as f:
        config = json.load(f)
    weights_path = os.path.join(dirpath, WEIGHTS_NAME)
    params = load_safetensors(weights_path) if os.path.exists(weights_path) else None
    return config, params


def save_model_index(dirpath: str, class_name: str, components: Dict[str, str]) -> None:
    os.makedirs(dirpath, exist_ok=True)
    index = {"_class_name": class_name, "_framework": "phendiff_tpu_torch"}
    index.update(components)
    with open(os.path.join(dirpath, MODEL_INDEX), "w") as f:
        json.dump(index, f, indent=2, sort_keys=True)


def load_model_index(dirpath: str) -> dict:
    with open(os.path.join(dirpath, MODEL_INDEX)) as f:
        return json.load(f)

"""Reader and writer of the safetensors file layout, without the package.

A file is an 8-byte little-endian header length, a JSON header that maps
each tensor's name to its ``dtype``, ``shape`` and ``data_offsets`` (begin,
end into the data that follows; an optional ``__metadata__`` maps strings to
strings), the header padded with spaces to a multiple of 8 bytes, then the
tensors' raw little-endian bytes. Hugging Face weights
(``model*.safetensors``) and PEFT adapters (``adapter_model.safetensors``)
use it; the port reads and writes them with torch alone.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, Mapping, Optional

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I8": torch.int8}
_NAMES = {v: k for k, v in DTYPES.items()}


def _header(f) -> tuple:
    (n,) = struct.unpack("<Q", f.read(8))
    return json.loads(f.read(n)), 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, on the CPU."""
    out = {}
    with open(path, "rb") as f:
        header, base = _header(f)
        header.pop("__metadata__", None)
        for name, info in header.items():
            if info["dtype"] not in DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                                 f"not one of {sorted(DTYPES)}")
            begin, end = info["data_offsets"]
            f.seek(base + begin)
            raw = bytearray(f.read(end - begin))
            flat = (torch.frombuffer(raw, dtype=DTYPES[info["dtype"]]) if raw
                    else torch.empty(0, dtype=DTYPES[info["dtype"]]))
            out[name] = flat.reshape(info["shape"])
    return out


def load_metadata(path: str) -> Dict[str, str]:
    """The file's ``__metadata__`` (empty when it has none)."""
    with open(path, "rb") as f:
        return _header(f)[0].get("__metadata__") or {}


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (each made contiguous and moved to the CPU) and
    ``metadata`` to ``path``."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name here")
        raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)

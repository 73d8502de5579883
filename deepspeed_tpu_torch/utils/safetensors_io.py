"""A writer and header reader of the safetensors file format.

The format: an 8-byte little-endian header length, a JSON header with
``dtype``, ``shape`` and ``data_offsets`` for each tensor (and an optional
``__metadata__`` of strings), padded with spaces to a multiple of 8 bytes,
then the tensors' raw little-endian bytes.  Tensors are laid out as the
``safetensors`` package lays them out (larger items first, then by name),
so a file written here reads with ``safetensors.torch.load_file``.  The
training engine's ``save_16bit_model`` writes through this module; the
port does not depend on the ``safetensors`` package.
"""

import json
import struct
from typing import Dict, Optional

import torch

DTYPES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
          torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
          torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; bf16 from its raw 16-bit view) to
    ``path`` as one safetensors file."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    blobs, offset = [], 0
    for key in order:
        t = tensors[key].detach()
        if t.dtype not in DTYPES:
            raise TypeError(f"safetensors: no dtype code for {t.dtype} ({key})")
        raw = t.to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[key] = {"dtype": DTYPES[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(text)))
        fh.write(text)
        for raw in blobs:
            fh.write(raw)


def read_header(path: str) -> Dict[str, object]:
    """The JSON header of a safetensors file (tensor entries and any
    ``__metadata__``)."""
    with open(path, "rb") as fh:
        (n, ) = struct.unpack("<Q", fh.read(8))
        return json.loads(fh.read(n))

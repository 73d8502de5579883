"""Memory-mapped indexed dataset (Megatron ``MMIDIDX`` binary format), a copy
of ``deepspeed_tpu/runtime/data_pipeline/indexed_dataset.py``: a file either
package writes, the other reads, byte for byte.

Torch-free re-implementation of the reference's mmap dataset
(runtime/data_pipeline/data_sampling/indexed_dataset.py:369
``MMapIndexedDataset`` + its Index writer and ``MMapIndexedDatasetBuilder``).
The ON-DISK FORMAT is kept byte-compatible — ``<prefix>.idx``::

    9B magic "MMIDIDX\\x00\\x00" | u64 version=1 | u8 dtype-code
    | u64 num_sequences | u64 num_docs
    | int32[num_sequences] sizes | int64[num_sequences] byte pointers
    | int64[num_docs] doc offsets

with token data flat in ``<prefix>.bin`` — so corpora tokenized by
Megatron/DeepSpeed tooling load directly, and datasets built here load there.
Reads are zero-copy ``np.memmap`` views; there is no torch Dataset base —
``__getitem__``/``__len__`` duck-type for any loader, including
runtime/dataloader.py.
"""

import os
import struct
from typing import List, Optional, Sequence, Union

import numpy as np

_MAGIC = b"MMIDIDX\x00\x00"
_VERSION = 1

# dtype codes shared with the reference format (indexed_dataset.py:101)
DTYPES = {
    1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32, 5: np.int64,
    6: np.float64, 7: np.double, 8: np.uint16, 9: np.uint32, 10: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in DTYPES.items()}


def best_fitting_dtype(vocab_size: Optional[int] = None):
    """uint16 token storage for small vocabs (halves corpus bytes)."""
    if vocab_size is not None and vocab_size < 65500:
        return np.uint16
    return np.int32


def index_file_path(prefix: str) -> str:
    return prefix + ".idx"


def data_file_path(prefix: str) -> str:
    return prefix + ".bin"


def dataset_exists(prefix: str) -> bool:
    return os.path.exists(index_file_path(prefix)) and os.path.exists(data_file_path(prefix))


class MMapIndexedDataset:
    """Zero-copy reader over a (prefix.idx, prefix.bin) pair."""

    def __init__(self, prefix: str):
        self._prefix = prefix
        with open(index_file_path(prefix), "rb") as fh:
            magic = fh.read(9)
            if magic != _MAGIC:
                raise ValueError(f"{prefix}.idx is not an MMIDIDX index (bad magic)")
            (version,) = struct.unpack("<Q", fh.read(8))
            if version != _VERSION:
                raise ValueError(f"unsupported MMIDIDX version {version}")
            (code,) = struct.unpack("<B", fh.read(1))
            self._dtype = np.dtype(DTYPES[code])
            (self._len,) = struct.unpack("<Q", fh.read(8))
            (ndocs,) = struct.unpack("<Q", fh.read(8))
            offset = fh.tell()
        idx_map = np.memmap(index_file_path(prefix), mode="r")
        self._sizes = np.frombuffer(idx_map, np.int32, count=self._len, offset=offset)
        self._pointers = np.frombuffer(idx_map, np.int64, count=self._len,
                                       offset=offset + self._sizes.nbytes)
        self._doc_idx = np.frombuffer(idx_map, np.int64, count=ndocs,
                                      offset=offset + self._sizes.nbytes + self._pointers.nbytes)
        # np.memmap refuses zero-byte files; an empty dataset is still valid
        # (e.g. an idle DataAnalyzer worker's partial shard)
        if os.path.getsize(data_file_path(prefix)) == 0:
            self._data = np.zeros(0, np.uint8)
        else:
            self._data = np.memmap(data_file_path(prefix), mode="r")

    # ------------------------------------------------------------ reading
    def __len__(self) -> int:
        return self._len

    def __getitem__(self, idx: Union[int, slice]):
        if isinstance(idx, slice):
            return [self[i] for i in range(*idx.indices(self._len))]
        if idx < 0:
            idx += self._len
        if not 0 <= idx < self._len:
            raise IndexError(f"sample {idx} out of range [0, {self._len})")
        ptr, size = int(self._pointers[idx]), int(self._sizes[idx])
        return np.frombuffer(self._data, self._dtype, count=size, offset=ptr)

    def get(self, idx: int, offset: int = 0, length: Optional[int] = None) -> np.ndarray:
        """Sub-sequence read without materializing the whole sample."""
        ptr, size = int(self._pointers[idx]), int(self._sizes[idx])
        if length is None:
            length = size - offset
        if offset < 0 or length < 0 or offset + length > size:
            raise IndexError(f"window [{offset}, {offset + length}) outside sample of size {size}")
        return np.frombuffer(self._data, self._dtype, count=length,
                             offset=ptr + offset * self._dtype.itemsize)

    @property
    def sizes(self) -> np.ndarray:
        return self._sizes

    @property
    def doc_idx(self) -> np.ndarray:
        return self._doc_idx

    @property
    def dtype(self):
        return self._dtype

    def num_tokens(self, idx: int) -> int:
        return int(self._sizes[idx])


class MMapIndexedDatasetBuilder:
    """Streaming writer producing the same (idx, bin) pair."""

    def __init__(self, out_prefix_or_bin: str, dtype=np.int32):
        bin_path = (out_prefix_or_bin if out_prefix_or_bin.endswith(".bin")
                    else data_file_path(out_prefix_or_bin))
        self._bin_path = bin_path
        self._file = open(bin_path, "wb")
        self._dtype = np.dtype(dtype)
        if self._dtype not in _CODES:
            raise ValueError(f"unsupported dtype {dtype}")
        self._sizes: List[int] = []
        self._doc_idx: List[int] = [0]

    def add_item(self, tokens) -> None:
        arr = np.asarray(tokens, dtype=self._dtype)
        self._file.write(arr.tobytes(order="C"))
        self._sizes.append(arr.size)

    def end_document(self) -> None:
        self._doc_idx.append(len(self._sizes))

    def merge_file_(self, other_prefix: str) -> None:
        """Append another dataset built with the same dtype (reference
        merge_file_:293 — multi-worker corpus shards concatenated)."""
        other = MMapIndexedDataset(other_prefix)
        if other.dtype != self._dtype:
            raise ValueError(f"dtype mismatch: {other.dtype} vs {self._dtype}")
        base_docs = len(self._sizes)
        self._sizes.extend(int(s) for s in other.sizes)
        self._doc_idx.extend(base_docs + int(d) for d in other.doc_idx[1:])
        with open(data_file_path(other_prefix), "rb") as fh:
            while True:
                chunk = fh.read(1 << 24)
                if not chunk:
                    break
                self._file.write(chunk)

    def finalize(self, index_path: Optional[str] = None) -> None:
        self._file.close()
        if index_path is None:
            index_path = self._bin_path[:-4] + ".idx"
        sizes = np.asarray(self._sizes, np.int32)
        pointers = np.zeros(len(sizes), np.int64)
        if len(sizes) > 1:
            # int64 accumulate — int32 sizes * itemsize overflows past 2 GiB
            np.cumsum(sizes[:-1].astype(np.int64) * self._dtype.itemsize, out=pointers[1:])
        with open(index_path, "wb") as fh:
            fh.write(_MAGIC)
            fh.write(struct.pack("<Q", _VERSION))
            fh.write(struct.pack("<B", _CODES[self._dtype]))
            fh.write(struct.pack("<Q", len(sizes)))
            fh.write(struct.pack("<Q", len(self._doc_idx)))
            fh.write(sizes.tobytes(order="C"))
            fh.write(pointers.tobytes(order="C"))
            fh.write(np.asarray(self._doc_idx, np.int64).tobytes(order="C"))

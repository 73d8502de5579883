"""Async file I/O for tensor offload (``deepspeed_tpu/ops/aio``, the reference's
``deepspeed/ops/aio`` + ``csrc/aio``).

``AsyncIOHandle`` drives the threaded pread/pwrite library ``csrc/aio.cpp``
(a copy of the JAX package's), built with g++ at first use: ``pwrite`` and
``pread`` take a path and a contiguous CPU tensor (pinned or not) or numpy
array and return a request id at once; ``wait(id)`` joins one and returns its
byte count (an ``OSError`` for a failed request), ``wait_all()`` drains the
queue.  Each buffer is held until it has been waited on.  ``use_odirect``
routes the bulk of each transfer through O_DIRECT via an aligned staging
buffer; a filesystem that refuses O_DIRECT gets buffered I/O, per file and
without a word.

``build_aio_handle`` raises where the JAX one falls back to a Python thread
pool; ``PyAsyncIOHandle``, that pool, is kept as the plain version for the
tests only.
"""

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Union

import numpy as np
import torch

from .. import _build

LIBRARY = "aio"

Buffer = Union[torch.Tensor, np.ndarray]


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIBRARY)
    if not getattr(lib, "_bound", False):
        lib.dstpu_aio_open_ex.restype = ctypes.c_void_p
        lib.dstpu_aio_open_ex.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.dstpu_aio_close.argtypes = [ctypes.c_void_p]
        lib.dstpu_aio_close.restype = None
        for fn in (lib.dstpu_aio_pwrite, lib.dstpu_aio_pread):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.dstpu_aio_wait.restype = ctypes.c_longlong
        lib.dstpu_aio_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.dstpu_aio_wait_all.restype = ctypes.c_int
        lib.dstpu_aio_wait_all.argtypes = [ctypes.c_void_p]
        lib._bound = True
    return lib


def _pointer(buf: Buffer, writable: bool):
    """(address, nbytes) of a contiguous CPU buffer."""
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError(f"aio buffers must be contiguous CPU tensors, got {buf.device} "
                             f"(contiguous={buf.is_contiguous()})")
        return buf.data_ptr(), buf.numel() * buf.element_size()
    if not isinstance(buf, np.ndarray) or not buf.flags["C_CONTIGUOUS"]:
        raise ValueError("aio buffers must be contiguous tensors or numpy arrays")
    if writable and not buf.flags["WRITEABLE"]:
        raise ValueError("aio read into a read-only numpy array")
    return buf.ctypes.data, buf.nbytes


class AsyncIOHandle:
    """ctypes wrapper over the native aio library.  ``requests`` counts the
    reads and writes submitted in this process, over every handle."""

    requests = 0

    def __init__(self, num_threads: int = 4, use_odirect: bool = False):
        self._lib = _lib()
        self._h = self._lib.dstpu_aio_open_ex(num_threads, int(use_odirect))
        self._keepalive: Dict[int, Buffer] = {}

    def pwrite(self, path: str, buf: Buffer) -> int:
        if isinstance(buf, np.ndarray):
            buf = np.ascontiguousarray(buf)
        addr, nbytes = _pointer(buf, writable=False)
        rid = self._lib.dstpu_aio_pwrite(self._h, os.fsencode(path), addr, nbytes)
        AsyncIOHandle.requests += 1
        self._keepalive[rid] = buf  # held until waited on
        return rid

    def pread(self, path: str, buf: Buffer) -> int:
        addr, nbytes = _pointer(buf, writable=True)
        rid = self._lib.dstpu_aio_pread(self._h, os.fsencode(path), addr, nbytes)
        AsyncIOHandle.requests += 1
        self._keepalive[rid] = buf
        return rid

    def wait(self, rid: int) -> int:
        out = int(self._lib.dstpu_aio_wait(self._h, rid))
        self._keepalive.pop(rid, None)
        if out < 0:
            raise OSError(-out, os.strerror(-out))
        return out

    def wait_all(self) -> None:
        failures = self._lib.dstpu_aio_wait_all(self._h)
        self._keepalive = {}
        if failures:
            raise OSError(f"{failures} async IO requests failed")

    def close(self):
        if getattr(self, "_h", None):
            self._lib.dstpu_aio_close(self._h)  # joins the workers: no request outlives it
            self._h = None
            self._keepalive = {}

    def __del__(self):
        try:
            self.close()
        except (AttributeError, TypeError):  # interpreter teardown: ctypes may be gone
            pass


class PyAsyncIOHandle:
    """The plain version (a Python thread pool) with the same surface, for the
    tests only."""

    def __init__(self, num_threads: int = 4):
        self._pool = ThreadPoolExecutor(max_workers=num_threads)
        self._futs: Dict[int, object] = {}
        self._next = 1

    def _submit(self, fn) -> int:
        rid = self._next
        self._next += 1
        self._futs[rid] = self._pool.submit(fn)
        return rid

    @staticmethod
    def _bytes(buf: Buffer) -> np.ndarray:
        arr = buf.numpy() if isinstance(buf, torch.Tensor) else buf
        return arr.reshape(-1).view(np.uint8)

    def pwrite(self, path: str, buf: Buffer) -> int:
        data = self._bytes(buf).tobytes()

        def write():
            with open(path, "wb") as fh:
                return fh.write(data)

        return self._submit(write)

    def pread(self, path: str, buf: Buffer) -> int:
        def read():
            out = self._bytes(buf)
            with open(path, "rb") as fh:
                data = fh.read(out.nbytes)
            out[:len(data)] = np.frombuffer(data, np.uint8)
            return len(data)

        return self._submit(read)

    def wait(self, rid: int) -> int:
        return int(self._futs.pop(rid).result())

    def wait_all(self) -> None:
        for rid in list(self._futs):
            self.wait(rid)

    def close(self):
        self._pool.shutdown(wait=True)


def build_aio_handle(num_threads: int = 4, use_odirect: bool = False) -> AsyncIOHandle:
    """The native handle; a failed build raises (no fallback)."""
    return AsyncIOHandle(num_threads, use_odirect=use_odirect)

"""The port's async file I/O (``csrc/aio.cpp`` through ``ops/aio``) on the
CPU: round trips of tensors and numpy arrays with and without O_DIRECT, the
O_DIRECT cases of the JAX package's ``tests/unit/test_offload.py`` (zero
bytes, a short read with no stale bytes, a missing file's error), the plain
``PyAsyncIOHandle``, and files that cross between the two packages' handles
in both directions."""

import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.aio import AsyncIOHandle as JaxAsyncIOHandle
from deepspeed_tpu.ops.aio import build_aio_handle as jax_build_aio_handle
from deepspeed_tpu_torch.ops.aio import AsyncIOHandle, PyAsyncIOHandle, build_aio_handle

SIZES = (0, 7, 1024, 4096 * 2 // 4 + 25, (16 << 20) // 4 + 333)  # the last crosses a staging chunk


@pytest.fixture
def handle():
    h = build_aio_handle(2, use_odirect=True)
    yield h
    h.close()


@pytest.mark.parametrize("odirect", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_round_trips(tmp_path, odirect, n):
    h = build_aio_handle(3, use_odirect=odirect)
    assert isinstance(h, AsyncIOHandle)
    src = torch.arange(n, dtype=torch.float32) * 0.5 - 3.0
    out = torch.full((n, ), -1.0)
    path = str(tmp_path / "t.bin")
    assert h.wait(h.pwrite(path, src)) == 4 * n
    assert os.path.getsize(path) == 4 * n
    assert h.wait(h.pread(path, out)) == 4 * n
    assert torch.equal(out, src)
    arr = np.random.default_rng(n).integers(0, 255, 3 * n + 1, dtype=np.uint8)
    back = np.zeros_like(arr)
    rids = [h.pwrite(str(tmp_path / "a.bin"), arr)]
    h.wait(rids[0])
    h.wait(h.pread(str(tmp_path / "a.bin"), back))
    np.testing.assert_array_equal(back, arr)
    h.close()


def test_many_requests_in_flight_and_wait_all(tmp_path, handle):
    bufs = [torch.full((5000 + i, ), float(i)) for i in range(12)]
    for i, b in enumerate(bufs):
        handle.pwrite(str(tmp_path / f"{i}.bin"), b)
    handle.wait_all()
    outs = [torch.empty_like(b) for b in bufs]
    rids = [handle.pread(str(tmp_path / f"{i}.bin"), o) for i, o in enumerate(outs)]
    assert [handle.wait(r) for r in reversed(rids)] == [4 * o.numel() for o in reversed(outs)]
    for b, o in zip(bufs, outs):
        assert torch.equal(b, o)


def test_zero_bytes_create_the_file_and_missing_files_raise(tmp_path, handle):
    """Zero-byte writes create the file; a read of a missing file fails,
    zero bytes or not (JAX ``test_aio_odirect_zero_byte_semantics``)."""
    empty = torch.empty(0)
    assert handle.wait(handle.pwrite(str(tmp_path / "zero.bin"), empty)) == 0
    assert (tmp_path / "zero.bin").exists()
    with pytest.raises(OSError):
        handle.wait(handle.pread(str(tmp_path / "missing.bin"), empty))
    with pytest.raises(OSError):
        handle.wait(handle.pread(str(tmp_path / "missing.bin"), torch.empty(10)))
    handle.pread(str(tmp_path / "missing.bin"), torch.empty(10))
    with pytest.raises(OSError, match="1 async IO requests failed"):
        handle.wait_all()


def test_short_read_copies_no_stale_bytes(tmp_path):
    """A read past the end of the file leaves the rest of the buffer as it
    was, not the staging buffer's old bytes (JAX
    ``test_aio_odirect_short_read_no_stale_bytes``)."""
    h = build_aio_handle(1, use_odirect=True)
    junk = torch.full((8192 // 4, ), 77, dtype=torch.int32)
    h.wait(h.pwrite(str(tmp_path / "junk.bin"), junk))
    h.wait(h.pread(str(tmp_path / "junk.bin"), torch.empty_like(junk)))
    h.wait(h.pwrite(str(tmp_path / "short.bin"), torch.full((1024, ), 5, dtype=torch.int32)))
    out = torch.zeros(8192 // 4, dtype=torch.int32)
    assert h.wait(h.pread(str(tmp_path / "short.bin"), out)) == 4096
    assert torch.equal(out[:1024], torch.full((1024, ), 5, dtype=torch.int32))
    assert not out[1024:].any()
    h.close()


def test_buffers_are_checked(handle, tmp_path):
    with pytest.raises(ValueError, match="contiguous"):
        handle.pwrite(str(tmp_path / "x"), torch.zeros(4, 4).t())
    with pytest.raises(ValueError, match="read-only"):
        ro = np.zeros(4, np.float32)
        ro.flags.writeable = False
        handle.pread(str(tmp_path / "x"), ro)


@pytest.mark.parametrize("odirect", [False, True])
def test_files_cross_between_the_packages(tmp_path, odirect):
    """What the port writes, JAX's native handle reads back, and the
    reverse; the plain Python handle reads and writes the same bytes."""
    jh = jax_build_aio_handle(2, use_odirect=odirect)
    assert isinstance(jh, JaxAsyncIOHandle), "the JAX package's native aio did not build"
    h = build_aio_handle(2, use_odirect=odirect)
    plain = PyAsyncIOHandle(2)
    rng = np.random.default_rng(7)
    for n in (3, 5000, 70_001):
        a = rng.normal(size=n).astype(np.float32)
        h.wait(h.pwrite(str(tmp_path / "port.bin"), torch.from_numpy(a)))
        jout = np.empty_like(a)
        assert jh.wait(jh.pread(str(tmp_path / "port.bin"), jout)) == a.nbytes
        np.testing.assert_array_equal(jout, a)
        jh.wait(jh.pwrite(str(tmp_path / "jax.bin"), a[::-1].copy()))
        out = torch.empty(n)
        assert h.wait(h.pread(str(tmp_path / "jax.bin"), out)) == a.nbytes
        np.testing.assert_array_equal(out.numpy(), a[::-1])
        plain.wait(plain.pwrite(str(tmp_path / "plain.bin"), torch.from_numpy(a)))
        assert (tmp_path / "plain.bin").read_bytes() == (tmp_path / "port.bin").read_bytes()
        pout = torch.zeros(n + 5)
        assert plain.wait(plain.pread(str(tmp_path / "port.bin"), pout)) == a.nbytes
        np.testing.assert_array_equal(pout[:n].numpy(), a)
        assert not pout[n:].any()
    plain.close()
    h.close()
    jh.close()

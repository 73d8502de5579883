"""Block quantization, int8 and int4, symmetric with per-group scales.

Counterpart of ``deepspeed_tpu/ops/quantizer/quantize.py`` for what one
device runs: weight-only quantization of the v1 inference engine
(``inference/quantization.py``).  A buffer is viewed flat as ``[groups,
group_size]`` (the last group zero-padded); each group gets one fp32 abs-max
scale.  On CUDA tensors :func:`quantize_int8` launches the hand-written kernel
in ``csrc/quantize.cu``; on CPU tensors it runs
:func:`quantize_int8_reference`, the plain version.  The kernel serves any
group size (the Pallas kernel takes multiples of 128 and leaves the others to
the same math in XLA), so one dispatch rule covers them all.  Dequantization
and int4 are XLA-composed in the JAX package and plain torch here.

The plain version divides by tensors, never by Python numbers: PyTorch on
CUDA turns a division by a Python number into a multiplication by its
reciprocal, which rounds differently from the kernel's true division.
"""

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build, use_kernel

QMAX8 = 127.0
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LIB: Optional[ctypes.CDLL] = None


def _view_groups(x, group_size: int):
    """(x flat, zero-padded to whole groups, as [groups, g], n) with g =
    min(group_size, n)."""
    n = x.numel()
    g = min(group_size, n)
    n_pad = -(-n // g) * g
    return F.pad(x.reshape(-1), (0, n_pad - n)).reshape(n_pad // g, g), n


def _absmax_quantize(xg, qmax):
    """Codes and scales of ``xg`` [groups, g] fp32: scale = absmax / qmax (1
    where absmax is 0), code = clip(round(x / scale), +-qmax), round half to
    even; the codes still fp32."""
    qmax = torch.tensor(qmax, dtype=torch.float32, device=xg.device)
    absmax = xg.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax / qmax)
    return torch.clamp(torch.round(xg / scale), -qmax, qmax), scale


def quantize_int8_reference(x, group_size: int = 2048):
    """Plain version of :func:`quantize_int8` (``quantize.py:45-50``)."""
    xg, n = _view_groups(x, group_size)
    q, scale = _absmax_quantize(xg.float(), QMAX8)
    return q.to(torch.int8), scale, n


def quantize_int8(x, group_size: int = 2048):
    """x: any shape, fp32/bf16/fp16 -> (q int8 [G, g], scales fp32 [G, 1], n)
    with n = x.numel() and g = min(group_size, n)."""
    if not use_kernel(x):
        return quantize_int8_reference(x, group_size)
    _check(x, group_size)
    n = x.numel()
    g = min(group_size, n)
    groups = -(-n // g)
    q = torch.empty((groups, g), dtype=torch.int8, device=x.device)
    scales = torch.empty((groups, 1), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _lib().quantize_int8_launch(_DTYPE_CODES[x.dtype], x.data_ptr(), q.data_ptr(),
                                         scales.data_ptr(), n, g, stream)
    if rc != 0:
        raise RuntimeError(f"quantize_int8 kernel launch failed: cudaError_t {rc}")
    quantize_int8.launches += 1
    return q, scales, n


quantize_int8.launches = 0  # kernel launches in this process (the CPU path never counts)


def dequantize_int8(q, scales, orig_size, shape=None, dtype=torch.float32):
    x = (q.float() * scales).reshape(-1)[:orig_size].to(dtype)
    return x.reshape(shape) if shape is not None else x


def quantize_int4(x, group_size: int = 2048):
    """Symmetric int4 ([-7, 7]) with two values packed per int8: returns
    (packed int8 [G, g // 2], scales [G, 1], n)."""
    if x.numel() < group_size and x.numel() % 2 == 1:
        group_size = x.numel() + 1  # keep the group width even for nibble pairing
    xg, n = _view_groups(x, group_size)
    if xg.shape[1] % 2 == 1:
        xg = F.pad(xg, (0, 1))
    q, scale = _absmax_quantize(xg.float(), 7.0)
    q = q.to(torch.int32)
    lo, hi = q[:, 0::2], q[:, 1::2]
    return ((hi & 0xF) << 4 | (lo & 0xF)).to(torch.int8), scale, n


def unpack_int4(packed):
    """int8 [G, h] of nibble pairs -> fp32 codes [G, 2 h], sign-extended."""
    p = packed.to(torch.int32)
    lo = (p << 28) >> 28
    hi = (p << 24) >> 28
    g, half = packed.shape
    return torch.stack([lo, hi], dim=-1).reshape(g, half * 2).float()


def dequantize_int4(packed, scales, orig_size, shape=None, dtype=torch.float32):
    x = (unpack_int4(packed) * scales).reshape(-1)[:orig_size].to(dtype)
    return x.reshape(shape) if shape is not None else x


def _check(x, group_size):
    """Raise on anything the kernel does not take."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"quantize_int8 kernel: x must be one of {list(_DTYPE_CODES)}, got "
                        f"{x.dtype}")
    if x.numel() == 0 or group_size < 1:
        raise ValueError(f"quantize_int8 kernel: x must be non-empty and group_size >= 1, got "
                         f"{x.numel()} elements, group_size {group_size}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("quantize_int8 kernel: x must be contiguous and start on a 16-byte "
                         "boundary")


def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signature declared."""
    global _LIB
    if _LIB is None:
        lib = _build.load("quantize")
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.quantize_int8_launch.argtypes = [ctypes.c_int, p, p, p, ll, ll, p]
        lib.quantize_int8_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB

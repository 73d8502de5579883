"""Fused AdamW over flat parameter buffers, in place.

Counterpart of ``deepspeed_tpu/ops/adam/fused_adam.py::fused_adamw_flat``.  On
CUDA tensors it launches the hand-written kernel in ``csrc/fused_adam.cu``;
on CPU tensors it runs :func:`fused_adamw_flat_reference`, the plain version.
Both update p, m and v in place (the JAX function returns new buffers; here
the engine owns them and nothing else reads the old values).

The seven scalars follow the Pallas kernel: lr, beta1, beta2, eps and the
weight decay as float32, and the bias corrections ``bc = 1 - beta**step``
computed in float32 (``fused_adam.py:75-77``), not in Python's float64.
"""

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import _build, use_kernel

_GRAD_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LIB: Optional[ctypes.CDLL] = None


def adamw_scalars(lr, beta1, beta2, eps, weight_decay, step):
    """(lr, beta1, beta2, eps, wd, bc1, bc2, 1 - beta1, 1 - beta2) as float32
    values (Python floats that are exact float32 numbers)."""
    f32 = np.float32
    b1, b2 = f32(beta1), f32(beta2)
    bc1 = f32(1.0) - np.power(b1, f32(step))
    bc2 = f32(1.0) - np.power(b2, f32(step))
    return tuple(float(x) for x in (f32(lr), b1, b2, f32(eps), f32(weight_decay), bc1, bc2,
                                    f32(1.0) - b1, f32(1.0) - b2))


def fused_adamw_flat_reference(p, m, v, g, *, lr, beta1=0.9, beta2=0.999, eps=1e-8,
                               weight_decay=0.0, step=1):
    """Plain version of the kernel, operation for operation (each a float32
    rounding): ``fused_adam.py:57-65``."""
    lr, b1, b2, eps, wd, bc1, bc2, omb1, omb2 = adamw_scalars(lr, beta1, beta2, eps,
                                                              weight_decay, step)
    gf = g.float()
    m_new = b1 * m + omb1 * gf
    v_new = b2 * v + omb2 * gf * gf
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) + wd * p
    p.sub_(lr * update)
    m.copy_(m_new)
    v.copy_(v_new)
    return p, m, v


def fused_adamw_flat(p, m, v, g, *, lr, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0,
                     step=1):
    """One AdamW step on flat fp32 buffers p/m/v with an fp32 or bf16 grad g,
    in place; returns (p, m, v).  ``step`` is 1-based."""
    if not use_kernel(p, m, v, g):
        return fused_adamw_flat_reference(p, m, v, g, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                                          weight_decay=weight_decay, step=step)
    _check(p, m, v, g)
    lr, b1, b2, eps, wd, bc1, bc2, _, _ = adamw_scalars(lr, beta1, beta2, eps, weight_decay,
                                                        step)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    with torch.cuda.device(p.device):
        rc = _lib().fused_adamw_launch(_GRAD_CODES[g.dtype], p.data_ptr(), m.data_ptr(),
                                       v.data_ptr(), g.data_ptr(), p.numel(), lr, b1, b2, eps,
                                       wd, bc1, bc2, stream)
    if rc != 0:
        raise RuntimeError(f"fused_adamw kernel launch failed: cudaError_t {rc}")
    fused_adamw_flat.launches += 1
    return p, m, v


fused_adamw_flat.launches = 0  # kernel launches in this process (the CPU path never counts)


def _check(p, m, v, g):
    """Raise on anything the kernel does not take."""
    for name, x in (("p", p), ("m", m), ("v", v)):
        if x.dtype != torch.float32:
            raise TypeError(f"fused_adamw kernel: {name} must be float32, got {x.dtype}")
    if g.dtype not in _GRAD_CODES:
        raise TypeError(f"fused_adamw kernel: grad must be one of {list(_GRAD_CODES)}, got "
                        f"{g.dtype}")
    n = p.numel()
    shapes = {tuple(x.shape) for x in (p, m, v, g)}
    if p.dim() != 1 or len(shapes) != 1 or n == 0:
        raise ValueError(f"fused_adamw kernel: p/m/v/g must be flat [n] of one length n > 0, "
                         f"got {sorted(shapes)}")
    if len({x.device for x in (p, m, v, g)}) != 1:
        raise ValueError("fused_adamw kernel: buffers on several devices")
    for name, x in (("p", p), ("m", m), ("v", v), ("g", g)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"fused_adamw kernel: {name} must be contiguous and start on a "
                             f"16-byte boundary")


def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signature declared."""
    global _LIB
    if _LIB is None:
        lib = _build.load("fused_adam")
        p, f = ctypes.c_void_p, ctypes.c_float
        lib.fused_adamw_launch.argtypes = [ctypes.c_int, p, p, p, p, ctypes.c_longlong, f, f, f,
                                           f, f, f, f, p]
        lib.fused_adamw_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB

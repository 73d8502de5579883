"""Fused AdamW and Lion over flat parameter buffers, in place.

Counterpart of ``deepspeed_tpu/ops/adam/fused_adam.py::fused_adamw_flat`` and
``::fused_lion_flat``.  On CUDA tensors each launches its hand-written kernel
in ``csrc/fused_adam.cu``; on CPU tensors it runs its plain version
(:func:`fused_adamw_flat_reference`, :func:`fused_lion_flat_reference`).
Both update the buffers in place (the JAX functions return new buffers; here
the caller owns them and nothing else reads the old values).

The scalars follow the Pallas kernels: lr, the betas, eps and the weight
decay as float32, ``1 - beta`` subtracted in float32, and AdamW's bias
corrections ``bc = 1 - beta**step`` computed in float32
(``fused_adam.py:75-77``), not in Python's float64.  The XLA fallbacks beside
the Pallas kernels fold ``1 - beta`` from Python doubles instead.
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
    _check("fused_adamw", (("p", p), ("m", m), ("v", v)), g)
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


def lion_scalars(lr, beta1, beta2, weight_decay):
    """(lr, beta1, beta2, wd, 1 - beta1, 1 - beta2) as float32 values (Python
    floats that are exact float32 numbers)."""
    f32 = np.float32
    b1, b2 = f32(beta1), f32(beta2)
    return tuple(float(x) for x in (f32(lr), b1, b2, f32(weight_decay), f32(1.0) - b1,
                                    f32(1.0) - b2))


def fused_lion_flat_reference(p, m, g, *, lr, beta1=0.9, beta2=0.99, weight_decay=0.0):
    """Plain version of the Lion kernel, operation for operation (each a
    float32 rounding; sign(0) = 0): ``fused_adam.py:90-95``."""
    lr, b1, b2, wd, omb1, omb2 = lion_scalars(lr, beta1, beta2, weight_decay)
    gf = g.float()
    c = b1 * m + omb1 * gf
    p.sub_(lr * (torch.sign(c) + wd * p))
    m.copy_(b2 * m + omb2 * gf)
    return p, m


def fused_lion_flat(p, m, g, *, lr, beta1=0.9, beta2=0.99, weight_decay=0.0):
    """One Lion step on flat fp32 buffers p/m with an fp32 or bf16 grad g, in
    place; returns (p, m)."""
    if not use_kernel(p, m, g):
        return fused_lion_flat_reference(p, m, g, lr=lr, beta1=beta1, beta2=beta2,
                                         weight_decay=weight_decay)
    _check("fused_lion", (("p", p), ("m", m)), g)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    with torch.cuda.device(p.device):
        rc = _lib().fused_lion_launch(_GRAD_CODES[g.dtype], p.data_ptr(), m.data_ptr(),
                                      g.data_ptr(), p.numel(),
                                      *lion_scalars(lr, beta1, beta2, weight_decay), stream)
    if rc != 0:
        raise RuntimeError(f"fused_lion kernel launch failed: cudaError_t {rc}")
    fused_lion_flat.launches += 1
    return p, m


fused_lion_flat.launches = 0  # kernel launches in this process (the CPU path never counts)


def _check(kernel, states, g):
    """Raise on anything the kernel does not take: ``states`` are the (name,
    tensor) pairs of the fp32 buffers, ``g`` the grad."""
    for name, x in states:
        if x.dtype != torch.float32:
            raise TypeError(f"{kernel} kernel: {name} must be float32, got {x.dtype}")
    if g.dtype not in _GRAD_CODES:
        raise TypeError(f"{kernel} kernel: grad must be one of {list(_GRAD_CODES)}, got "
                        f"{g.dtype}")
    buffers = (*states, ("g", g))
    shapes = {tuple(x.shape) for _, x in buffers}
    if states[0][1].dim() != 1 or len(shapes) != 1 or g.numel() == 0:
        raise ValueError(f"{kernel} kernel: {'/'.join(n for n, _ in buffers)} must be flat [n] "
                         f"of one length n > 0, got {sorted(shapes)}")
    if len({x.device for _, x in buffers}) != 1:
        raise ValueError(f"{kernel} kernel: buffers on several devices")
    for name, x in buffers:
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{kernel} kernel: {name} must be contiguous and start on a "
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
        lib.fused_lion_launch.argtypes = [ctypes.c_int, p, p, p, ctypes.c_longlong, f, f, f, f,
                                          f, f, p]
        lib.fused_lion_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB

"""Fused AdamW with blockwise 8-bit moments, in place.

Counterpart of ``deepspeed_tpu/ops/adam/adam8bit.py``.  Both moments live as
int8 codes ``[groups, 1024]`` with one fp32 scale ``[groups, 1]`` per group
of 1024 elements: the first moment m as signed abs-max codes, the second in
the sqrt domain (``u = sqrt(v)``), about 2.01 bytes a param instead of 8.  On
CUDA tensors :func:`fused_adamw8bit_flat` launches the hand-written kernel in
``csrc/adam8bit.cu``; on CPU tensors it runs
:func:`fused_adamw8bit_flat_reference`, the plain version.  Both update p, the
codes and the scales in place (the Pallas call aliases them,
``adam8bit.py:131``).

The plain version follows the Pallas body (``_adamw8_kernel``), not the XLA
fallback beside it: the scalars are float32, so ``1 - beta2`` is a float32
subtraction (the fallback folds it from a Python double, 1.3e-5 relative
apart), and every operation is one float32 rounding in the body's order.  Its
scalars are 0-d tensors on the buffers' device, so that on CUDA a division is
a division (PyTorch turns a division by a Python number into a multiplication
by its reciprocal there) and the codes and scales equal the kernel's bit for
bit.
"""

import ctypes
from typing import Optional

import torch

from .. import _build, use_kernel
from .fused_adam import adamw_scalars

GROUP = 1024  # elements per quantisation group (one fp32 scale each)
QMAX = 127.0
_GRAD_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LIB: Optional[ctypes.CDLL] = None


def init_quantized_moment(n: int, group_size: int = GROUP, device=None):
    """Zeroed int8 codes ``[ceil(n / group_size), group_size]`` and unit fp32
    scales ``[groups, 1]`` for a flat buffer of ``n`` elements."""
    groups = -(-n // group_size)
    return (torch.zeros((groups, group_size), dtype=torch.int8, device=device),
            torch.ones((groups, 1), dtype=torch.float32, device=device))


def _requant(x, qmax):
    """Abs-max int8 codes and scales of ``x`` [groups, group_size] fp32:
    scale = absmax / qmax (1 where absmax is 0), code = clip(round(x / scale))
    with round half to even."""
    absmax = x.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax / qmax)
    return torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8), scale


def _step_groups(p, m8, v8, sm, sv, g, s):
    """One step over whole groups: p and g [k, 1024] fp32 views or copies,
    codes and scales of the same k groups; writes the codes and scales in
    place and returns the new p."""
    lr, b1, b2, eps, wd, bc1, bc2, omb1, omb2, qmax = s
    m = m8.float() * sm
    u = v8.float() * sv  # u = sqrt(v)
    m_new = b1 * m + omb1 * g
    v_new = b2 * (u * u) + (omb2 * g) * g
    u_new = torch.sqrt(v_new)
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) + wd * p
    p_new = p - lr * update
    for codes, scales, x in ((m8, sm, m_new), (v8, sv, u_new)):
        q, scale = _requant(x, qmax)
        codes.copy_(q)
        scales.copy_(scale)
    return p_new


def fused_adamw8bit_flat_reference(p, m8, v8, sm, sv, g, *, lr, beta1=0.9, beta2=0.999,
                                   eps=1e-8, weight_decay=0.0, step=1):
    """Plain version of the kernel, in place; returns (p, m8, v8, sm, sv).
    Whole groups are computed on views of p and g; a tail group (n not a
    multiple of 1024) on a zero-padded copy of its own elements only, as the
    Pallas call pads p and g with zeros."""
    s = tuple(torch.tensor(x, dtype=torch.float32, device=p.device)
              for x in adamw_scalars(lr, beta1, beta2, eps, weight_decay, step) + (QMAX, ))
    n, group = p.numel(), m8.shape[1]
    full = n // group
    gf = g.float()
    if full:
        p_new = _step_groups(p[:full * group].view(full, group), m8[:full], v8[:full], sm[:full],
                             sv[:full], gf[:full * group].view(full, group), s)
        p[:full * group].copy_(p_new.view(-1))
    tail = n - full * group
    if tail:
        pt = torch.zeros((1, group), dtype=torch.float32, device=p.device)
        gt = torch.zeros((1, group), dtype=torch.float32, device=p.device)
        pt[0, :tail] = p[full * group:]
        gt[0, :tail] = gf[full * group:]
        p_new = _step_groups(pt, m8[full:], v8[full:], sm[full:], sv[full:], gt, s)
        p[full * group:].copy_(p_new[0, :tail])
    return p, m8, v8, sm, sv


def fused_adamw8bit_flat(p, m8, v8, sm, sv, g, *, lr, beta1=0.9, beta2=0.999, eps=1e-8,
                         weight_decay=0.0, step=1):
    """One AdamW step on a flat fp32 master ``p`` [n] with int8 moments
    ``m8``/``v8`` [ceil(n / 1024), 1024], fp32 scales ``sm``/``sv`` [groups,
    1] and a flat fp32 or bf16 grad ``g`` [n], all updated in place; returns
    (p, m8, v8, sm, sv).  ``step`` is 1-based."""
    if not use_kernel(p, m8, v8, sm, sv, g):
        return fused_adamw8bit_flat_reference(p, m8, v8, sm, sv, g, lr=lr, beta1=beta1,
                                              beta2=beta2, eps=eps, weight_decay=weight_decay,
                                              step=step)
    _check(p, m8, v8, sm, sv, g)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    with torch.cuda.device(p.device):
        rc = _lib().adamw8bit_launch(
            _GRAD_CODES[g.dtype], p.data_ptr(), m8.data_ptr(), v8.data_ptr(), sm.data_ptr(),
            sv.data_ptr(), g.data_ptr(), p.numel(),
            *adamw_scalars(lr, beta1, beta2, eps, weight_decay, step), stream)
    if rc != 0:
        raise RuntimeError(f"adamw8bit kernel launch failed: cudaError_t {rc}")
    fused_adamw8bit_flat.launches += 1
    return p, m8, v8, sm, sv


fused_adamw8bit_flat.launches = 0  # kernel launches in this process (the CPU path never counts)


def dequantize_moments(m8, v8, sm, sv, n: int):
    """The fp32 (m, v) flat buffers [n] that the codes and scales stand for."""
    m = (m8.float() * sm).reshape(-1)[:n]
    u = (v8.float() * sv).reshape(-1)[:n]
    return m, u * u


def _check(p, m8, v8, sm, sv, g):
    """Raise on anything the kernel does not take."""
    if p.dtype != torch.float32 or sm.dtype != torch.float32 or sv.dtype != torch.float32:
        raise TypeError(f"adamw8bit kernel: p and the scales must be float32, got {p.dtype}, "
                        f"{sm.dtype}, {sv.dtype}")
    if m8.dtype != torch.int8 or v8.dtype != torch.int8:
        raise TypeError(f"adamw8bit kernel: the moments must be int8, got {m8.dtype}, "
                        f"{v8.dtype}")
    if g.dtype not in _GRAD_CODES:
        raise TypeError(f"adamw8bit kernel: grad must be one of {list(_GRAD_CODES)}, got "
                        f"{g.dtype}")
    n = p.numel()
    groups = -(-n // GROUP)
    if (p.dim() != 1 or g.shape != p.shape or n == 0
            or tuple(m8.shape) != (groups, GROUP) or tuple(v8.shape) != (groups, GROUP)
            or tuple(sm.shape) != (groups, 1) or tuple(sv.shape) != (groups, 1)):
        raise ValueError(f"adamw8bit kernel: p/g flat [n > 0], codes [{groups}, {GROUP}] and "
                         f"scales [{groups}, 1] expected, got p {tuple(p.shape)}, g "
                         f"{tuple(g.shape)}, codes {tuple(m8.shape)}/{tuple(v8.shape)}, scales "
                         f"{tuple(sm.shape)}/{tuple(sv.shape)}")
    buffers = (("p", p), ("m8", m8), ("v8", v8), ("sm", sm), ("sv", sv), ("g", g))
    if len({x.device for _, x in buffers}) != 1:
        raise ValueError("adamw8bit kernel: buffers on several devices")
    for name, x in buffers:
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"adamw8bit kernel: {name} must be contiguous and start on a "
                             f"16-byte boundary")


def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signature declared."""
    global _LIB
    if _LIB is None:
        lib = _build.load("adam8bit")
        p, f = ctypes.c_void_p, ctypes.c_float
        lib.adamw8bit_launch.argtypes = [ctypes.c_int, p, p, p, p, p, p, ctypes.c_longlong,
                                         f, f, f, f, f, f, f, f, f, p]
        lib.adamw8bit_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB

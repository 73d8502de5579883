"""Flash attention, forward and backward, for dense (training) attention.

Counterpart of ``deepspeed_tpu/ops/attention/flash.py``.  Layouts are the
model's: q ``[B, Sq, H, D]``, k/v ``[B, Sk, KV, D]`` (GQA when KV < H, q head h
reads kv head ``h // (H // KV)``); the logsumexp is ``[B, H, Sq]`` fp32.
Causal masking is on absolute positions with the queries at the end of the
keys (query i sees keys ``<= i + Sk - Sq``).

On CUDA tensors the three wrappers (:func:`flash_fwd`, :func:`flash_bwd_dkdv`,
:func:`flash_bwd_dq`) launch the hand-written kernels in
``csrc/flash_attention.cu``; on CPU tensors they run the plain versions
beside them, which repeat the Pallas kernels' arithmetic: fp32 scores, the
``-1e30`` mask value, ``l == 0 -> 1`` and ``lse = m + log(l_safe)``.  A row that
sees no key (only possible when causal with Sq > Sk) comes out as zeros with
``lse = -1e30``.  :func:`flash_attention` and :func:`flash_attention_with_lse`
are differentiable through one ``torch.autograd.Function`` that returns both
out and lse.

Which kernel a CUDA tensor reaches is decided by its dtype alone
(:func:`uses_tensor_cores`): bf16 and fp16 inputs go to the tensor-core
forward, dK/dV and dQ kernels, which round P (and dS) to the input type
before the second product; fp32 inputs go to the CUDA-core kernels, whose
results differ from the plain versions only by the order of summation.  There
is no fallback between them.  The tensor-core kernels are held to
:func:`tensor_core_limit`.
"""

import ctypes
import math
from typing import Optional

import torch

from .. import _build, use_kernel

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128)
_TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)
_LIB: Optional[ctypes.CDLL] = None


def uses_tensor_cores(dtype: torch.dtype) -> bool:
    """The dispatch rule of the three kernels: bf16 and fp16 run on tensor
    cores, fp32 on CUDA cores."""
    return dtype in _TENSOR_CORE_DTYPES


# ------------------------------------------------------------ plain versions
def _visible(sq, sk, causal, device):
    """[Sq, Sk] bool: key j visible from query i, or None when all are."""
    if not causal:
        return None
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    return torch.arange(sk, device=device)[None, :] <= qpos


def _expand_kv(x, group):
    return torch.repeat_interleave(x, group, dim=2) if group > 1 else x


def _round(x, dtype):
    """``x`` rounded to ``dtype`` and back to fp32, or ``x`` when dtype is None."""
    return x if dtype is None else x.to(dtype).float()


def flash_fwd_reference(q, k, v, scale, causal, round_to: Optional[torch.dtype] = None):
    """Plain version of the forward kernel: (out in q's dtype, lse fp32).

    ``round_to`` gives the operand-rounding version of the tensor-core kernel:
    fp32 math, with P rounded to that dtype before ``P V`` (l sums the
    unrounded P)."""
    group = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _expand_kv(k.float(), group)) * scale
    mask = _visible(q.shape[1], k.shape[1], causal, q.device)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bhqk,bkhd->bqhd", _round(p, round_to), _expand_kv(v.float(), group))
    out = out / l_safe.permute(0, 2, 1, 3)
    return out.to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def _probs_and_dscores(q, k, v, do, lse, delta, scale, causal):
    """p = exp(s - lse) (0 where masked) and ds = p * (dp - delta) * scale,
    both [B, H, Sq, Sk] fp32, as the backward kernels compute them."""
    group = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _expand_kv(k.float(), group)) * scale
    p = torch.exp(s - lse[..., None])
    mask = _visible(q.shape[1], k.shape[1], causal, q.device)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), _expand_kv(v.float(), group))
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dkdv_reference(q, k, v, do, lse, delta, scale, causal,
                             round_to: Optional[torch.dtype] = None):
    """Plain version of the dK/dV kernel: per q head in fp32, then summed over
    the heads of each GQA group (flash.py:280-281).  ``round_to`` gives the
    operand-rounding version: P and dS (computed in fp32) rounded to that dtype
    before ``P^T dO`` and ``dS^T Q``."""
    b, sk, kvh, d = k.shape
    group = q.shape[2] // kvh
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", _round(p, round_to), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", _round(ds, round_to), q.float())
    dk = dk.reshape(b, sk, kvh, group, d).sum(3)
    dv = dv.reshape(b, sk, kvh, group, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, scale, causal,
                           round_to: Optional[torch.dtype] = None):
    """Plain version of the dQ kernel.  ``round_to`` gives the operand-rounding
    version of the tensor-core kernel: dS (computed in fp32) rounded to that
    dtype before ``dS K``."""
    group = q.shape[2] // k.shape[2]
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", _round(ds, round_to), _expand_kv(k.float(), group))
    return dq.to(q.dtype)


def dq_fp32_floor(q, k, v, do, lse, delta, scale, causal):
    """[B, Sq, H, D] fp32: how far dQ may move when S = Q K^T and dP = dO V^T
    are summed over D in another order than the plain version's (the tensor
    cores' order).  Each such sum may move by the fp32 dot-product bound
    gamma_D = D u (u = 2^-24) times the sum of its terms' magnitudes; carried
    through dS = P (dP - delta) scale and dQ = dS K that is
    ``gamma_D scale sum_k (P |dO|.|V| + |dS| |Q|.|K|) |K|``.  It matters only
    where a row's terms cancel: a query that sees one key has dQ = 0 exactly
    (P = 1, dP = delta), and both sides hold fp32 noise there."""
    group = q.shape[2] // k.shape[2]
    gamma = q.shape[-1] * 2.0**-24
    ka = _expand_kv(k.float(), group).abs()
    va = _expand_kv(v.float(), group).abs()
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale, causal)
    terms = (p * torch.einsum("bqhd,bkhd->bhqk", do.float().abs(), va)
             + ds.abs() * torch.einsum("bqhd,bkhd->bhqk", q.float().abs(), ka))
    return gamma * scale * torch.einsum("bhqk,bkhd->bqhd", terms, ka)


def tensor_core_limit(got, ref, rounded, floor=None):
    """The limit of a tensor-core kernel's output, FlashAttention's own test
    rule taken row by row.  A row is the last axis: one (batch, query, head)
    of out or dQ, one (batch, key, kv head) of dK or dV.  Every element of a row
    must satisfy ``|got - ref| <= 2 max_row|rounded - ref| + eps max_row|ref|``
    (``+ floor`` where given: dQ's :func:`dq_fp32_floor`).
    ``ref`` is the fp32 plain version (fp32 inputs' values, no rounding),
    ``rounded`` the operand-rounding plain version (``round_to=`` the kernel's
    dtype, fp32 out) and eps one ulp of the output dtype, for the store (at
    least the ulp of its smallest normal).  Per row, because magnitudes differ
    by rows: under a causal mask the late keys' dK/dV are a hundredth of the
    early ones', so one limit for the tensor would pass a zeroed key tile.
    Returns (within the limit and finite, max |got - ref|, the largest
    |got - ref| / limit, the median row limit)."""
    info = torch.finfo(got.dtype)
    got, ref, rounded = got.float(), ref.float(), rounded.float()
    err = (got - ref).abs()
    limit = (2.0 * (rounded - ref).abs().amax(-1, keepdim=True)
             + info.eps * ref.abs().amax(-1, keepdim=True).clamp_min(info.tiny))
    if floor is not None:
        limit = limit + floor.float()
    ok = bool(torch.isfinite(got).all()) and bool((err <= limit).all())
    return ok, err.max().item(), (err / limit).max().item(), limit.median().item()


# ---------------------------------------------------------------- wrappers
def flash_fwd(q, k, v, scale: float, causal: bool):
    """(out [B, Sq, H, D] in q's dtype, lse [B, H, Sq] fp32)."""
    if not use_kernel(q, k, v):
        return flash_fwd_reference(q, k, v, scale, causal)
    _check(q, k, v)
    b, sq, hq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _lib().flash_fwd_launch(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq,
                                     k.shape[1], hq, k.shape[2], d, float(scale), int(causal),
                                     stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError_t {rc}")
    flash_fwd.launches += 1
    flash_fwd.tc_launches += uses_tensor_cores(q.dtype)
    return out, lse


def flash_bwd_dkdv(q, k, v, do, lse, delta, scale: float, causal: bool):
    """(dk, dv) [B, Sk, KV, D] in k's dtype, from the saved lse and
    ``delta = rowsum(do * out)`` [B, H, Sq] fp32."""
    if not use_kernel(q, k, v, do, lse, delta):
        return flash_bwd_dkdv_reference(q, k, v, do, lse, delta, scale, causal)
    _check(q, k, v, do, lse, delta)
    b, sq, hq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _lib().flash_bwd_dkdv_launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, k.shape[1],
            hq, k.shape[2], d, float(scale), int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkdv kernel launch failed: cudaError_t {rc}")
    flash_bwd_dkdv.launches += 1
    flash_bwd_dkdv.tc_launches += uses_tensor_cores(q.dtype)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, scale: float, causal: bool):
    """dq [B, Sq, H, D] in q's dtype."""
    if not use_kernel(q, k, v, do, lse, delta):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, scale, causal)
    _check(q, k, v, do, lse, delta)
    b, sq, hq, d = q.shape
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _lib().flash_bwd_dq_launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, sq, k.shape[1], hq, k.shape[2],
            d, float(scale), int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: cudaError_t {rc}")
    flash_bwd_dq.launches += 1
    flash_bwd_dq.tc_launches += uses_tensor_cores(q.dtype)
    return dq


# kernel launches in this process (the CPU path never counts); tc_launches
# counts those of them that went to the tensor-core kernels
flash_fwd.launches = flash_fwd.tc_launches = 0
flash_bwd_dkdv.launches = flash_bwd_dkdv.tc_launches = 0
flash_bwd_dq.launches = flash_bwd_dq.tc_launches = 0


class _Flash(torch.autograd.Function):
    """(out, lse); grads are not materialised, so an lse that the caller
    drops gives ``g_lse = None``."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        ctx.set_materialize_grads(False)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        """dq, dk, dv.  ``delta = rowsum(do * out)`` is a torch reduction
        (XLA-composed in JAX, flash.py:231); the lse cotangent folds into it
        (flash.py:233-234)."""
        q, k, v, out, lse = ctx.saved_tensors
        do = torch.zeros_like(out) if g_out is None else g_out.contiguous()
        delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2)
        if g_lse is not None:
            delta = delta - g_lse.float()
        delta = delta.contiguous()
        dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def _scale(q, softmax_scale):
    return softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def flash_attention_with_lse(q, k, v, causal: bool = True,
                             softmax_scale: Optional[float] = None):
    """(out [B, Sq, H, D], lse [B, H, Sq] fp32), differentiable in both: the lse
    cotangent folds into the backward kernels' delta term."""
    return _Flash.apply(q, k, v, _scale(q, softmax_scale), causal)


def flash_attention(q, k, v, causal: bool = True, mask=None,
                    softmax_scale: Optional[float] = None):
    """Drop-in for ``models.transformer.sdpa``: q/k/v [B, S, H, D], GQA allowed.
    A dense ``mask`` goes to ``sdpa`` (flash.py:389-390), which the JAX package
    leaves to XLA."""
    if mask is not None:
        from ...models.transformer import sdpa
        return sdpa(q, k, v, causal=causal, mask=mask, softmax_scale=softmax_scale)
    return flash_attention_with_lse(q, k, v, causal=causal, softmax_scale=softmax_scale)[0]


# ------------------------------------------------------------------ checks
def _check(q, k, v, do=None, lse=None, delta=None):
    """Raise on anything the kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash kernels: q [B, Sq, H, D] and k/v [B, Sk, KV, D] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash kernels: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    kvh = k.shape[2]
    if kvh == 0 or hq % kvh:
        raise ValueError(f"flash kernels: {hq} q heads over {kvh} kv heads")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernels: q/k/v must share one of {list(_DTYPE_CODES)}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernels: head_dim {d} not in {_HEAD_DIMS}")
    if do is not None:
        if do.shape != q.shape or do.dtype != q.dtype:
            raise ValueError(f"flash kernels: do must be {tuple(q.shape)} {q.dtype}, got "
                             f"{tuple(do.shape)} {do.dtype}")
        for name, x in (("lse", lse), ("delta", delta)):
            if x.dtype != torch.float32 or tuple(x.shape) != (b, hq, sq):
                raise ValueError(f"flash kernels: {name} must be float32 {(b, hq, sq)}, got "
                                 f"{x.dtype} {tuple(x.shape)}")
    tensors = [("q", q), ("k", k), ("v", v), ("do", do), ("lse", lse), ("delta", delta)]
    tensors = [(name, x) for name, x in tensors if x is not None]
    devices = {x.device for _, x in tensors}
    if len(devices) != 1:
        raise ValueError(f"flash kernels: inputs on several devices {devices}")
    for name, x in tensors:
        if not x.is_contiguous():
            raise ValueError(f"flash kernels: {name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"flash kernels: {name} must start on a 16-byte boundary")


def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures declared."""
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd_launch.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, f, i, p]
        lib.flash_fwd_launch.restype = i
        for name in ("flash_bwd_dkdv_launch", "flash_bwd_dq_launch"):
            n_out = 2 if name == "flash_bwd_dkdv_launch" else 1
            fn = getattr(lib, name)
            fn.argtypes = [i, p, p, p, p, p, p] + [p] * n_out + [i, i, i, i, i, i, f, i, p]
            fn.restype = i
        _LIB = lib
    return _LIB

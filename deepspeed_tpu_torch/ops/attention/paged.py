"""Paged (blocked-KV) attention for ragged serving.

Counterpart of ``deepspeed_tpu/ops/attention/paged.py``.  ``paged_attention``
keeps the JAX signature and layouts: q ``[N, T, H, Dh]`` (T = the SplitFuse
chunk, 1 at decode); one layer's KV pool ``[NB, KV, bs, Dh]``; block tables
``[N, MAXB]`` int32 whose padded entries point at the trash block and are
never read past ``lengths``; ``lengths``/``start_pos``/``n_tokens`` ``[N]``
int32.  Causality is on absolute positions, so chunked prefill and decode
share one function.

On CUDA tensors it launches one of the two hand-written kernels in
``csrc/paged_attention.cu``, chosen by one shape rule
(:func:`uses_prefill_tensor_cores`, no fallback between them): bf16/fp16
chunks of at least 16 tokens with head_dim 64 or 128 go to the tensor-core
prefill kernel, which rounds P to the input type before ``P V`` and is held
to ``flash.tensor_core_limit``; decode (T < 16), fp32 and head_dim 32 or 256
go to the CUDA-core kernel.  On CPU tensors it runs
:func:`paged_attention_reference`, the plain version.
"""

import ctypes
import math
from typing import Optional

import torch

from .. import _build, use_kernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (32, 64, 128, 256)
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
_TC_DTYPES = (torch.bfloat16, torch.float16)
_TC_HEAD_DIMS = (64, 128)
TC_MIN_CHUNK = 16   # chunk tokens from which the tensor-core prefill kernel runs
_TC_MAX_GROUP = 64  # q heads of one kv head that one tensor-core block can hold
_LIB: Optional[ctypes.CDLL] = None


def uses_prefill_tensor_cores(dtype: torch.dtype, head_dim: int, chunk: int, group: int) -> bool:
    """The dispatch rule: bf16/fp16 chunks of at least ``TC_MIN_CHUNK`` tokens
    with head_dim 64 or 128 and at most 64 q heads per kv head run on the
    tensor-core prefill kernel; everything else on the CUDA-core kernel."""
    return (dtype in _TC_DTYPES and head_dim in _TC_HEAD_DIMS and chunk >= TC_MIN_CHUNK
            and group <= _TC_MAX_GROUP)


def paged_attention_reference(q, kpool, vpool, tables, lengths, start_pos, n_tokens, scale,
                              window, alibi_slopes=None, round_to: Optional[torch.dtype] = None):
    """Plain PyTorch version (the JAX package's ``_dense_fallback``): gather
    each sequence's whole block table into a dense context and run masked
    sdpa.  The math runs in fp32 from the stored values, as the kernel's
    does, and the result is cast to q's dtype.

    ``round_to`` gives the operand-rounding version of the tensor-core
    kernel: the same masked softmax written out, with P rounded to that dtype
    before ``P V`` (l sums the unrounded P; a row with l == 0 is zero)."""
    from ...models.transformer import sdpa
    n, t, hq, dh = q.shape
    maxb = tables.shape[1]
    kvh, bs = kpool.shape[1], kpool.shape[2]
    idx = tables.long()
    ctx_k = kpool[idx].transpose(2, 3).reshape(n, maxb * bs, kvh, dh).float()
    ctx_v = vpool[idx].transpose(2, 3).reshape(n, maxb * bs, kvh, dh).float()
    ar = torch.arange(t, device=q.device)
    positions = start_pos.long()[:, None] + ar[None, :]
    qpos = torch.where(ar[None, :] < n_tokens.long()[:, None], positions, -1)
    kpos = torch.arange(maxb * bs, device=q.device)[None, None, :]
    qp = qpos[:, :, None]
    mask = (kpos <= qp) & (kpos < lengths.long()[:, None, None]) & (qp >= 0)
    if window is not None:
        mask = mask & (kpos > qp - window)
    bias = None
    if alibi_slopes is not None:
        bias = (alibi_slopes.float()[None, :, None, None]
                * torch.arange(maxb * bs, device=q.device, dtype=torch.float32)[None, None, None, :])
    if round_to is None:
        out = sdpa(q.float(), ctx_k, ctx_v, causal=False, mask=mask[:, None, :, :],
                   softmax_scale=scale, bias=bias)
    else:
        group = hq // kvh
        ctx_k = torch.repeat_interleave(ctx_k, group, dim=2)
        ctx_v = torch.repeat_interleave(ctx_v, group, dim=2)
        s = torch.einsum("nthd,nkhd->nhtk", q.float(), ctx_k) * scale
        if bias is not None:
            s = s + bias
        vis = mask[:, None, :, :]
        s = torch.where(vis, s, -1e30)
        p = torch.where(vis, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        out = torch.einsum("nhtk,nkhd->nthd", p.to(round_to).float(), ctx_v)
        out = out / torch.where(l == 0.0, 1.0, l).permute(0, 2, 1, 3)
    return torch.where((qp >= 0)[..., None], out, 0.0).to(q.dtype)


def paged_attention(q, kpool, vpool, tables, lengths, start_pos, n_tokens, *, block_size: int,
                    softmax_scale: Optional[float] = None, window: Optional[int] = None,
                    alibi_slopes=None):
    """q [N, T, H, Dh]; kpool/vpool [NB, KV, bs, Dh]; tables [N, MAXB] int32;
    lengths/start_pos/n_tokens [N] int32.  Returns [N, T, H, Dh] in q's dtype
    (rows at t >= n_tokens[n] are zero).  ``window`` = sliding-window size
    (Mistral); ``alibi_slopes`` [H] fp32 adds slope_h * key_index to the
    scores."""
    n, t, hq, dh = q.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(dh)
    ints = (tables, lengths, start_pos, n_tokens)
    operands = (q, kpool, vpool, *ints) + ((alibi_slopes, ) if alibi_slopes is not None else ())
    if not use_kernel(*operands):
        return paged_attention_reference(q, kpool, vpool, tables, lengths, start_pos, n_tokens,
                                         scale, window, alibi_slopes)
    _check(q, kpool, vpool, ints, alibi_slopes, block_size, window)
    tc = uses_prefill_tensor_cores(q.dtype, dh, t, hq // kpool.shape[1])
    launch = _lib().paged_prefill_tc_launch if tc else _lib().paged_attention_launch
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), start_pos.data_ptr(), n_tokens.data_ptr(),
            alibi_slopes.data_ptr() if alibi_slopes is not None else None, out.data_ptr(),
            n, t, hq, kpool.shape[1], dh, kpool.shape[2], tables.shape[1], float(scale),
            int(window) if window is not None else 0, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError_t {rc}")
    paged_attention.launches += 1
    paged_attention.tc_launches += tc
    return out


# kernel launches in this process (the CPU path never counts); tc_launches
# counts those of them that went to the tensor-core prefill kernel
paged_attention.launches = paged_attention.tc_launches = 0


def _check(q, kpool, vpool, ints, alibi_slopes, block_size, window):
    """Raise on anything the kernel does not take."""
    n, t, hq, dh = q.shape
    if q.dtype not in _DTYPE_CODES or kpool.dtype != q.dtype or vpool.dtype != q.dtype:
        raise TypeError(f"paged_attention kernel: q/kpool/vpool must share one of "
                        f"{list(_DTYPE_CODES)}, got {q.dtype}/{kpool.dtype}/{vpool.dtype}")
    if kpool.dim() != 4 or kpool.shape != vpool.shape or kpool.shape[3] != dh:
        raise ValueError(f"paged_attention kernel: pools must be [NB, KV, bs, {dh}], got "
                         f"{tuple(kpool.shape)} and {tuple(vpool.shape)}")
    kvh, bs = kpool.shape[1], kpool.shape[2]
    if bs != block_size:
        raise ValueError(f"paged_attention kernel: block_size={block_size} but the pool holds "
                         f"blocks of {bs}")
    group = hq // kvh if kvh else 0
    if kvh == 0 or hq % kvh or (group > 32 and group % 32):
        raise ValueError(f"paged_attention kernel: {hq} q heads over {kvh} kv heads")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head_dim {dh} not in {_HEAD_DIMS}")
    if bs < 1 or bs > 128 or bs & (bs - 1):
        raise ValueError(f"paged_attention kernel: block_size {bs} must be a power of two <= 128")
    smem = _lib().paged_attention_smem_bytes(dh, bs)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged_attention kernel: head_dim {dh} with block_size {bs} needs "
                         f"{smem} bytes of shared memory (> {_SMEM_LIMIT})")
    if window is not None and window < 1:
        raise ValueError(f"paged_attention kernel: window must be >= 1, got {window}")
    tables = ints[0]
    if tables.dim() != 2 or tables.shape[0] != n:
        raise ValueError(f"paged_attention kernel: tables must be [{n}, MAXB], got "
                         f"{tuple(tables.shape)}")
    for name, x in zip(("tables", "lengths", "start_pos", "n_tokens"), ints):
        if x.dtype != torch.int32:
            raise TypeError(f"paged_attention kernel: {name} must be int32, got {x.dtype}")
        if name != "tables" and tuple(x.shape) != (n, ):
            raise ValueError(f"paged_attention kernel: {name} must be [{n}], got {tuple(x.shape)}")
    if alibi_slopes is not None and (alibi_slopes.dtype != torch.float32
                                     or tuple(alibi_slopes.shape) != (hq, )):
        raise ValueError(f"paged_attention kernel: alibi_slopes must be float32 [{hq}], got "
                         f"{alibi_slopes.dtype} {tuple(alibi_slopes.shape)}")
    if q.data_ptr() % 16 or kpool.data_ptr() % 16 or vpool.data_ptr() % 16:
        raise ValueError("paged_attention kernel: q and the pools must start on a 16-byte "
                         "boundary")
    devices = {x.device for x in (q, kpool, vpool, *ints)}
    if len(devices) != 1:
        raise ValueError(f"paged_attention kernel: inputs on several devices {devices}")
    named = (("q", q), ("kpool", kpool), ("vpool", vpool), ("alibi_slopes", alibi_slopes),
             *zip(("tables", "lengths", "start_pos", "n_tokens"), ints))
    for name, x in named:
        if x is not None and not x.is_contiguous():
            raise ValueError(f"paged_attention kernel: {name} must be contiguous")


def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures declared."""
    global _LIB
    if _LIB is None:
        lib = _build.load("paged_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.paged_attention_launch, lib.paged_prefill_tc_launch):
            fn.argtypes = [i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, p]
            fn.restype = i
        lib.paged_attention_smem_bytes.argtypes = [i, i]
        lib.paged_attention_smem_bytes.restype = i
        _LIB = lib
    return _LIB

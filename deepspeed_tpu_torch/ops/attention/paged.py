"""Paged (blocked-KV) attention for ragged serving.

Counterpart of ``deepspeed_tpu/ops/attention/paged.py``.  ``paged_attention``
keeps the JAX signature and layouts: q ``[N, T, H, Dh]`` (T = the SplitFuse
chunk, 1 at decode); one layer's KV pool ``[NB, KV, bs, Dh]``; block tables
``[N, MAXB]`` int32 whose padded entries point at the trash block and are
never read past ``lengths``; ``lengths``/``start_pos``/``n_tokens`` ``[N]``
int32.  Causality is on absolute positions, so chunked prefill and decode
share one function.

On CUDA tensors it launches one of three hand-written routes in
``csrc/paged_attention.cu``, chosen by one shape rule (:func:`paged_route`,
no fallback between them): chunks of fewer than ``TC_MIN_CHUNK`` tokens
(decode) go to the split-K decode kernel and its merge, for every dtype and
head dim; bf16/fp16 chunks of at least 16 tokens with head_dim 64 or 128 and
a GQA group of at most 64 to the tensor-core prefill kernel, which rounds P
to the input type before ``P V`` and is held to ``flash.tensor_core_limit``;
the rest (fp32, head_dim 32 or 256 at T >= 16) to the CUDA-core kernel.  On
CPU tensors it runs :func:`paged_attention_reference`, the plain version.

The split-K decode is sized on the host from shapes alone
(:func:`decode_split`: no value of ``lengths`` is read back): each block
takes one (split of the key range, kv head, block of rows, sequence) and
writes its partial ``(m, l, acc)`` in fp32; the merge combines each row's
partials by their weights (:func:`merge_decode_splits` is its plain
version).
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
# split-K decode: a launch aims at DECODE_BLOCKS_PER_SM blocks an SM (several
# waves, so that sequences of 1 and 4096 keys even out), splits of whole 64-key
# tiles and whole table slots, none shorter than DECODE_MIN_SPLIT keys.
# chip_smoke.py's split_ab times the rule against half and twice its split.
# With 32 blocks an SM and 128 keys at least, twice the split was 8-9 % faster
# at the Mistral decode shape and the serve's decode step, hence these values;
# with them the rule beats half its split at both and matches or beats twice
# it. At the Llama-2 decode shape (1,024 sequence x kv head pairs) the split
# size moved the time by under 10 % either way, and half of it can win there.
DECODE_BLOCKS_PER_SM = 16
DECODE_MIN_SPLIT = 256
DECODE_TILE = 64  # keys of the decode kernel's largest tile (kDecodeMaxKeys)
_SM_COUNT = {}
_LIB: Optional[ctypes.CDLL] = None


def uses_prefill_tensor_cores(dtype: torch.dtype, head_dim: int, chunk: int, group: int) -> bool:
    """The tensor-core prefill part of :func:`paged_route`: bf16/fp16 chunks
    of at least ``TC_MIN_CHUNK`` tokens with head_dim 64 or 128 and at most
    64 q heads per kv head."""
    return (dtype in _TC_DTYPES and head_dim in _TC_HEAD_DIMS and chunk >= TC_MIN_CHUNK
            and group <= _TC_MAX_GROUP)


def paged_route(dtype: torch.dtype, head_dim: int, chunk: int, group: int) -> str:
    """The dispatch rule: ``"decode"`` (split-K decode kernel and merge) for
    T < 16, ``"prefill_tc"`` (tensor-core prefill kernel) for bf16/fp16 chunks
    of T >= 16 with head_dim 64/128 and a group <= 64, ``"cuda_core"`` (the
    CUDA-core kernel) for the rest."""
    if chunk < TC_MIN_CHUNK:
        return "decode"
    return "prefill_tc" if uses_prefill_tensor_cores(dtype, head_dim, chunk, group) else "cuda_core"


def decode_rows(head_dim: int, rows: int) -> int:
    """Rows (token x q head of one kv group) one decode block holds when a
    (sequence, kv head) has ``rows`` of them: every warp keeps an fp32
    accumulator of head_dim / 32 values a lane for each row, 32 values and
    8 rows at most; up to 4 rows (T = 1 with a group of 1-4) take a kernel
    sized for 4 (decode_rows / kDecSmallRows in csrc/paged_attention.cu)."""
    if rows <= 4:
        return 4
    return min(8, 1024 // head_dim)


def decode_split(context: int, block_size: int, n: int, kv_heads: int, row_blocks: int,
                 sms: int) -> tuple:
    """The host rule that sizes a split-K decode launch: (keys a split,
    splits).  ``context`` is the block table's reach (``tables.shape[1] *
    block_size``); no value of ``lengths`` is read.  The launch has
    ``splits x kv_heads x row_blocks x n`` blocks; the rule takes the fewest
    splits that give at least ``DECODE_BLOCKS_PER_SM x sms`` of them, rounds
    a split down to whole table slots and whole 64-key tiles (so the count
    only grows), and keeps a split at ``DECODE_MIN_SPLIT`` keys or more.
    Split s covers keys [s * keys, (s + 1) * keys); one past a sequence's
    length, or wholly before its window, leaves an empty partial (l = 0)."""
    unit = max(block_size, DECODE_TILE)
    want = max(1, -(-DECODE_BLOCKS_PER_SM * sms // max(1, n * kv_heads * row_blocks)))
    keys = max(context // want // unit * unit, -(-DECODE_MIN_SPLIT // unit) * unit)
    return keys, max(1, -(-context // keys))


def merge_decode_splits(ml, acc, n_tokens):
    """Plain version of the merge kernel: ``ml`` [N, T, H, S, 2] holds each
    split's running max m (in log2 units: scores x scale x log2 e, ALiBi
    included) and sum l, ``acc`` [N, T, H, S, D] its unnormalised fp32 sum of
    P V.  Returns fp32 [N, T, H, D]: the splits weighted by 2^(m - max m),
    divided by the weighted l; a row whose splits are all empty (l = 0) and a
    row at t >= n_tokens are zeros."""
    m, l = ml[..., 0], ml[..., 1]
    w = torch.exp2(m - m.amax(dim=-1, keepdim=True))
    num = (acc * w[..., None]).sum(dim=-2)
    den = (l * w).sum(dim=-1)[..., None]
    out = num / torch.where(den == 0.0, 1.0, den)
    t = ml.shape[1]
    live = torch.arange(t, device=ml.device)[None, :] < n_tokens.long()[:, None]
    return torch.where(live[:, :, None, None], out, 0.0)


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
    route = paged_route(q.dtype, dh, t, hq // kpool.shape[1])
    _check(q, kpool, vpool, ints, alibi_slopes, block_size, window, route)
    if route == "decode":
        keys, splits = decode_split(tables.shape[1] * block_size, block_size, n,
                                    kpool.shape[1], _row_blocks(q, kpool), _sms(q.device))
        ml, acc = _decode_partials(q, kpool, vpool, ints, alibi_slopes, scale, window, keys,
                                   splits)
        out = _merge(ml, acc, n_tokens, q.dtype)
    else:
        out = torch.empty_like(q)
        launch = (_lib().paged_prefill_tc_launch if route == "prefill_tc"
                  else _lib().paged_attention_launch)
        with torch.cuda.device(q.device):
            rc = launch(
                _DTYPE_CODES[q.dtype], q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                tables.data_ptr(), lengths.data_ptr(), start_pos.data_ptr(), n_tokens.data_ptr(),
                _ptr(alibi_slopes), out.data_ptr(), n, t, hq, kpool.shape[1], dh,
                kpool.shape[2], tables.shape[1], float(scale),
                int(window) if window is not None else 0, _stream(q))
        _raise_on(rc, route)
    paged_attention.launches += 1
    paged_attention.tc_launches += route == "prefill_tc"
    paged_attention.decode_launches += route == "decode"
    return out


def _ptr(x):
    return x.data_ptr() if x is not None else None


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"paged_attention {what} kernel launch failed: cudaError_t {rc}")


def _sms(device) -> int:
    """The card's SM count, read once per device (a host value)."""
    index = torch.device(device).index or 0
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNT[index]


def _row_blocks(q, kpool) -> int:
    """Decode blocks a (sequence, kv head) needs for its group x T rows."""
    rows = q.shape[2] // kpool.shape[1] * q.shape[1]
    return -(-rows // decode_rows(q.shape[3], rows))


def _decode_partials(q, kpool, vpool, ints, alibi_slopes, scale, window, keys, splits):
    """The split-K decode kernel alone: (ml [N, T, H, splits, 2], acc [N, T,
    H, splits, D]) fp32, the partials :func:`merge_decode_splits` combines.
    ``keys`` a split must be a multiple of 64 and of the block size."""
    n, t, hq, dh = q.shape
    tables, lengths, start_pos, n_tokens = ints
    ml = torch.empty((n, t, hq, splits, 2), dtype=torch.float32, device=q.device)
    acc = torch.empty((n, t, hq, splits, dh), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().paged_decode_launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), start_pos.data_ptr(), n_tokens.data_ptr(),
            _ptr(alibi_slopes), ml.data_ptr(), acc.data_ptr(), n, t, hq, kpool.shape[1], dh,
            kpool.shape[2], tables.shape[1], float(scale),
            int(window) if window is not None else 0, keys, splits, _stream(q))
    _raise_on(rc, "decode")
    return ml, acc


def _merge(ml, acc, n_tokens, dtype):
    """The merge kernel: out [N, T, H, D] in ``dtype`` from the partials."""
    n, t, hq, splits, dh = acc.shape
    out = torch.empty((n, t, hq, dh), dtype=dtype, device=acc.device)
    with torch.cuda.device(acc.device):
        rc = _lib().paged_decode_merge_launch(_DTYPE_CODES[dtype], ml.data_ptr(), acc.data_ptr(),
                                              n_tokens.data_ptr(), out.data_ptr(), n, t, hq, dh,
                                              splits, _stream(acc))
    _raise_on(rc, "decode merge")
    return out


# kernel launches in this process (the CPU path never counts), one a call
# (the decode route's merge included); tc_launches counts those that went to
# the tensor-core prefill kernel, decode_launches those of the split-K decode
paged_attention.launches = paged_attention.tc_launches = paged_attention.decode_launches = 0


def _check(q, kpool, vpool, ints, alibi_slopes, block_size, window, route):
    """Raise on anything the route's kernel does not take."""
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
    if route == "cuda_core" and smem > _SMEM_LIMIT:
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
        lib.paged_decode_launch.argtypes = [i] + [p] * 10 + [i] * 7 + [ctypes.c_float] + \
            [i] * 3 + [p]
        lib.paged_decode_merge_launch.argtypes = [i, p, p, p, p, i, i, i, i, i, p]
        for fn in (lib.paged_decode_launch, lib.paged_decode_merge_launch):
            fn.restype = i
        lib.paged_attention_smem_bytes.argtypes = [i, i]
        lib.paged_attention_smem_bytes.restype = i
        _LIB = lib
    return _LIB

"""Block-sparse self-attention, forward and backward.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/attention.py``.  Layouts
are the model's: q ``[B, S, H, D]``, k/v ``[B, S, KV, D]`` (GQA when KV < H),
the logsumexp ``[B, H, S]`` fp32; the block layout is uint8 ``[H or 1, NB,
NB]`` from a ``SparsityConfig`` (``layout[h, i, j]``: query block i of head h
may attend to key block j).  Element masks inside live blocks: keys past S
and, with causal, keys after the query.  Only self-attention (sq == sk).

The host tables (:class:`_Tables`) are built once per (layout, block, heads,
kv heads) and kept as int32 device tensors, cached with the JAX package's
64-entry bound, so a step uploads nothing.  On CUDA tensors the three
wrappers (:func:`sparse_fwd`, :func:`sparse_bwd_dkdv`, :func:`sparse_bwd_dq`)
launch the hand-written kernels in ``csrc/sparse_attention.cu``; on CPU
tensors they run the plain versions beside them, which repeat the Pallas
kernels' arithmetic: fp32 scores, the ``-1e30`` mask value, ``l == 0 -> 1``,
``lse = m + log(l_safe)``.  :func:`sparse_attention` is differentiable
through one ``torch.autograd.Function`` (the JAX ``_sparse`` custom VJP).

Which kernel a CUDA tensor reaches is decided by its dtype alone, by
flash's rule (:func:`flash.uses_tensor_cores`): bf16 and fp16 go to the
tensor-core forward, dK/dV and dQ kernels, which round P (and dS) to the
input type before the second products (held to
:func:`flash.tensor_core_limit` against the plain versions with
``round_to=``, dQ with :func:`sparse_dq_fp32_floor`); fp32 goes to the
CUDA-core ones.  There is no fallback between them.
"""

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from .. import _build, count_kernel, use_kernel
from ..attention import flash
from ..attention.flash import _round

NEG_INF = -1e30
TILE = 64  # positions of a kernel tile (kTile in csrc/sparse_attention.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128)
_LIB: Optional[ctypes.CDLL] = None


# ----------------------------------------------------------------- host tables
def _owner_order(live: np.ndarray) -> np.ndarray:
    """Owner blocks sorted by (last live walked block, first live walked
    block, index), so that blocks with alike live sets share a tile."""
    n, w = live.shape
    has = live.any(axis=1)
    first = np.where(has, live.argmax(axis=1), -1)
    last = np.where(has, w - 1 - live[:, ::-1].argmax(axis=1), -1)
    return np.lexsort((np.arange(n), first, last)).astype(np.int32)


def _tile_walks(live: np.ndarray, order: np.ndarray, block: int, n_tiles: int):
    """For each 64-position tile of the owner blocks taken in ``order``: the
    union of the walked blocks live for any of its blocks, as a boolean
    [n_tiles, NB_walk] array."""
    nb = order.size
    f = np.arange(n_tiles * TILE)
    owner = order[np.minimum(f // block, nb - 1)]
    member = np.zeros((n_tiles, nb), dtype=np.int32)
    valid = f < nb * block
    member[(f // TILE)[valid], owner[valid]] = 1
    return (member @ live.astype(np.int32)) > 0


def tile_positions(order: np.ndarray, block: int, s: int, t: int) -> np.ndarray:
    """[64] int: the positions that the kernels gather for tile ``t`` of a
    block ``order`` (one row of ``q_order`` or ``k_order``), -1 past the list
    or past ``s`` (``list_pos`` in csrc/sparse_attention.cu)."""
    f = t * TILE + np.arange(TILE)
    pos = order[np.minimum(f // block, order.size - 1)] * block + f % block
    return np.where((f < order.size * block) & (pos < s), pos, -1)


def _longest_first(cnt: np.ndarray) -> np.ndarray:
    """[heads, T] walk lengths -> [heads, T] int32: each row's tile indices
    sorted by walk length, longest first (ties by index)."""
    return np.argsort(-cnt, axis=1, kind="stable").astype(np.int32)


def _padded_lists(union: np.ndarray):
    """[H, T, NB] bool -> (ascending indices [H, T, width] int32, counts [H, T])."""
    cnt = union.sum(axis=2).astype(np.int32)
    width = max(1, int(cnt.max()))
    idx = np.argsort(~union, axis=2, kind="stable")[..., :width].astype(np.int32)
    idx = np.where(np.arange(width)[None, None, :] < cnt[..., None], idx, 0)
    return np.ascontiguousarray(idx, dtype=np.int32), cnt


class _Tables:
    """Compacted active-block tables for one (layout, block, heads, kv heads).

    As in JAX (``attention.py:39-71``):
      kvmap [H, NQ, A]  : for q-block iq, the a-th live kv block index
      cnt   [H, NQ]     : how many of the A slots are live
      qmap  [H, NK, At] : transpose — for kv-block ik, the live q blocks
      cnt_t [H, NK]
    For the CUDA kernels, whose tile (64 positions) is not the layout block:
      q_order [H, NB]   : query blocks in tile order (forward, dQ)
      k_walk, k_cnt     : per (q head, query tile) the sorted union of live key
                          blocks [H, T, A'] and its length [H, T]
      k_order [KV, NB]  : key blocks in tile order (dK/dV), one order per kv
                          head so that its GQA group shares the tiles
      q_walk, q_cnt     : per (q head, key tile) the union of live query blocks
      q_tile_order [H, T], k_tile_order [KV, T] : the launch order of the
                          tensor-core forward and dQ (q_tile_order) and dK/dV
                          (k_tile_order) kernels, the tiles sorted
                          by walk length (k_cnt; q_cnt summed over the GQA
                          group), longest first
    with T = ceil(NB * block / 64).
    """

    def __init__(self, layout: np.ndarray, n_heads: int, block: int = 16,
                 n_kv_heads: Optional[int] = None):
        layout = np.asarray(layout, dtype=np.uint8)
        lh, nq, nk = layout.shape
        if nq != nk:
            raise ValueError(f"sparse attention needs a square layout, got {layout.shape}")
        layout = np.broadcast_to(layout, (n_heads, nq, nk)) if lh != n_heads else layout
        self.layout = np.ascontiguousarray(layout)
        self.block = block
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads or n_heads
        if n_heads % self.n_kv_heads:
            raise ValueError(f"{n_heads} q heads over {self.n_kv_heads} kv heads")
        live = self.layout.astype(bool)
        cnt = live.sum(axis=2).astype(np.int32)
        cnt_t = live.sum(axis=1).astype(np.int32)
        self.kvmap = np.zeros((n_heads, nq, max(1, int(cnt.max()))), dtype=np.int32)
        self.qmap = np.zeros((n_heads, nk, max(1, int(cnt_t.max()))), dtype=np.int32)
        for h in range(n_heads):
            for i in range(nq):
                (on,) = np.nonzero(live[h, i])
                self.kvmap[h, i, :on.size] = on
            for j in range(nk):
                (on,) = np.nonzero(live[h, :, j])
                self.qmap[h, j, :on.size] = on
        self.cnt, self.cnt_t = cnt, cnt_t

        self.n_tiles = -(-nq * block // TILE)
        group = n_heads // self.n_kv_heads
        self.q_order = np.stack([_owner_order(live[h]) for h in range(n_heads)])
        self.k_walk, self.k_cnt = _padded_lists(np.stack(
            [_tile_walks(live[h], self.q_order[h], block, self.n_tiles) for h in range(n_heads)]))
        live_t = live.transpose(0, 2, 1)  # [H, key block, query block]
        self.k_order = np.stack([_owner_order(live_t[g * group:(g + 1) * group].any(axis=0))
                                 for g in range(self.n_kv_heads)])
        self.q_walk, self.q_cnt = _padded_lists(np.stack(
            [_tile_walks(live_t[h], self.k_order[h // group], block, self.n_tiles)
             for h in range(n_heads)]))
        self.q_tile_order = _longest_first(self.k_cnt)
        self.k_tile_order = _longest_first(
            self.q_cnt.reshape(self.n_kv_heads, group, self.n_tiles).sum(axis=1))
        self.key = (self.layout.tobytes(), self.layout.shape, block, self.n_kv_heads)
        self._device = {}

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, _Tables) and self.key == other.key

    def on(self, device) -> dict:
        """The kernels' tables as device tensors, uploaded once per device."""
        device = torch.device(device)
        if device not in self._device:
            names = ("layout", "q_order", "k_walk", "k_cnt", "k_order", "q_walk", "q_cnt",
                     "q_tile_order", "k_tile_order")
            self._device[device] = {n: torch.from_numpy(getattr(self, n)).to(device)
                                    for n in names}
        return self._device[device]

    def element_mask(self, s: int, causal: bool, device) -> torch.Tensor:
        """[H, S, S] bool: the (query, key) pairs the kernels compute."""
        return _layout_element_mask(self.layout, self.block, s, self.n_heads, device, causal)[0]


_tables_cache = {}
_TABLES_CACHE_MAX = 64  # bounds host memory for variable-seq-len serving


def _get_tables(layout: np.ndarray, n_heads: int, block: int = 16,
                n_kv_heads: Optional[int] = None) -> _Tables:
    layout = np.asarray(layout, dtype=np.uint8)
    key = (layout.tobytes(), layout.shape, n_heads, block, n_kv_heads or n_heads)
    if key not in _tables_cache:
        if len(_tables_cache) >= _TABLES_CACHE_MAX:
            _tables_cache.pop(next(iter(_tables_cache)))
        _tables_cache[key] = _Tables(layout, n_heads, block, n_kv_heads)
    return _tables_cache[key]


def live_pairs(layout: np.ndarray, block: int, s: int, causal: bool, n_heads: int) -> int:
    """(query, key) element pairs that a sparse attention over ``layout``
    computes for one batch row, summed over ``n_heads`` heads: the work the
    kernels must do, 4 D operations per pair forward, 8 D for dK/dV and 6 D for
    dQ."""
    layout = np.broadcast_to(np.asarray(layout, dtype=np.int64),
                             (n_heads,) + np.shape(layout)[1:])
    nb = layout.shape[1]
    rows = np.arange(s)
    starts = np.arange(nb) * block
    widths = np.clip(s - starts, 0, block)  # keys of each key block below S
    if causal:
        per_row = np.clip(rows[:, None] - starts[None, :] + 1, 0, widths[None, :])
    else:
        per_row = np.broadcast_to(widths[None, :], (s, nb))
    pairs = np.zeros((nb, nb), dtype=np.int64)  # [query block, key block]
    np.add.at(pairs, rows // block, per_row)
    return int((layout * pairs[None]).sum())


# ------------------------------------------------------------ plain versions
def _expand_kv(x, group):
    return torch.repeat_interleave(x, group, dim=2) if group > 1 else x


def sparse_fwd_reference(q, k, v, tables: _Tables, scale, causal,
                         round_to: Optional[torch.dtype] = None):
    """Plain version of the forward kernel: (out in q's dtype, lse fp32).
    ``round_to`` gives the operand-rounding version of the tensor-core
    kernel: the same masked softmax, with P (computed in fp32) rounded to that
    dtype before ``P V``; l sums the unrounded P."""
    group = q.shape[2] // k.shape[2]
    mask = tables.element_mask(q.shape[1], causal, q.device)[None]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _expand_kv(k.float(), group)) * scale
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bhqk,bkhd->bqhd", _round(p, round_to), _expand_kv(v.float(), group))
    out = out / l_safe.permute(0, 2, 1, 3)
    return out.to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def _probs_and_dscores(q, k, v, do, lse, delta, tables, scale, causal):
    """p = exp(s - lse) (0 where masked) and ds = p * (dp - delta) * scale,
    both [B, H, S, S] fp32, as the backward kernels compute them."""
    group = q.shape[2] // k.shape[2]
    mask = tables.element_mask(q.shape[1], causal, q.device)[None]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _expand_kv(k.float(), group)) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), _expand_kv(v.float(), group))
    return p, p * (dp - delta[..., None]) * scale


def sparse_bwd_dkdv_reference(q, k, v, do, lse, delta, tables: _Tables, scale, causal,
                              round_to: Optional[torch.dtype] = None):
    """Plain version of the dK/dV kernel: per q head in fp32, then summed over
    the heads of each GQA group (attention.py:318-319).  ``round_to`` gives the
    operand-rounding version of the tensor-core kernel: P and dS (computed in
    fp32) rounded to that dtype before ``P^T dO`` and ``dS^T Q``."""
    b, s, kvh, d = k.shape
    group = q.shape[2] // kvh
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, tables, scale, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", _round(p, round_to), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", _round(ds, round_to), q.float())
    dk = dk.reshape(b, s, kvh, group, d).sum(3)
    dv = dv.reshape(b, s, kvh, group, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def sparse_bwd_dq_reference(q, k, v, do, lse, delta, tables: _Tables, scale, causal,
                            round_to: Optional[torch.dtype] = None):
    """Plain version of the dQ kernel.  ``round_to`` gives the operand-rounding
    version of the tensor-core kernel: dS (computed in fp32) rounded to that
    dtype before ``dS K``."""
    group = q.shape[2] // k.shape[2]
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, tables, scale, causal)
    return torch.einsum("bhqk,bkhd->bqhd", _round(ds, round_to),
                        _expand_kv(k.float(), group)).to(q.dtype)


def sparse_dq_fp32_floor(q, k, v, do, lse, delta, tables: _Tables, scale, causal):
    """[B, S, H, D] fp32: :func:`flash.dq_fp32_floor` over the layout's
    element mask: how far dQ may move when S and dP are summed over D in
    another order than the plain version's, ``gamma_D scale sum_k (P
    |dO|.|V| + |dS| |Q|.|K|) |K|`` with gamma_D = D 2^-24.  Query 0 sees only
    key 0, so its dQ is 0 exactly and both sides hold fp32 noise there."""
    group = q.shape[2] // k.shape[2]
    gamma = q.shape[-1] * 2.0**-24
    ka = _expand_kv(k.float(), group).abs()
    va = _expand_kv(v.float(), group).abs()
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, tables, scale, causal)
    terms = (p * torch.einsum("bqhd,bkhd->bhqk", do.float().abs(), va)
             + ds.abs() * torch.einsum("bqhd,bkhd->bhqk", q.float().abs(), ka))
    return gamma * scale * torch.einsum("bhqk,bkhd->bqhd", terms, ka)


# ---------------------------------------------------------------- wrappers
def sparse_fwd(q, k, v, tables: _Tables, scale: float, causal: bool):
    """(out [B, S, H, D] in q's dtype, lse [B, H, S] fp32)."""
    if not use_kernel(q, k, v):
        return sparse_fwd_reference(q, k, v, tables, scale, causal)
    _check(q, k, v, tables)
    b, s, hq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    t = tables.on(q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _lib().sparse_fwd_launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), t["layout"].data_ptr(), t["q_order"].data_ptr(),
            t["k_walk"].data_ptr(), t["k_cnt"].data_ptr(), t["q_tile_order"].data_ptr(), b, s,
            hq, k.shape[2], d, tables.layout.shape[1], tables.block, tables.k_walk.shape[2],
            float(scale), int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"sparse_fwd kernel launch failed: cudaError_t {rc}")
    sparse_fwd.launches += 1
    sparse_fwd.tc_launches += flash.uses_tensor_cores(q.dtype)
    count_kernel(sparse_fwd_reference, (q, k, v, tables, scale, causal), (out, lse))
    return out, lse


def sparse_bwd_dkdv(q, k, v, do, lse, delta, tables: _Tables, scale: float, causal: bool):
    """(dk, dv) [B, S, KV, D] in k's dtype, from the saved lse and
    ``delta = rowsum(do * out)`` [B, H, S] fp32."""
    if not use_kernel(q, k, v, do, lse, delta):
        return sparse_bwd_dkdv_reference(q, k, v, do, lse, delta, tables, scale, causal)
    _check(q, k, v, tables, do, lse, delta)
    b, s, hq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    t = tables.on(q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _lib().sparse_bwd_dkdv_launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            t["layout"].data_ptr(), t["k_order"].data_ptr(), t["q_walk"].data_ptr(),
            t["q_cnt"].data_ptr(), t["k_tile_order"].data_ptr(), b, s, hq, k.shape[2], d,
            tables.layout.shape[1],
            tables.block, tables.q_walk.shape[2], float(scale), int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"sparse_bwd_dkdv kernel launch failed: cudaError_t {rc}")
    sparse_bwd_dkdv.launches += 1
    sparse_bwd_dkdv.tc_launches += flash.uses_tensor_cores(q.dtype)
    count_kernel(sparse_bwd_dkdv_reference, (q, k, v, do, lse, delta, tables, scale, causal),
                 (dk, dv))
    return dk, dv


def sparse_bwd_dq(q, k, v, do, lse, delta, tables: _Tables, scale: float, causal: bool):
    """dq [B, S, H, D] in q's dtype."""
    if not use_kernel(q, k, v, do, lse, delta):
        return sparse_bwd_dq_reference(q, k, v, do, lse, delta, tables, scale, causal)
    _check(q, k, v, tables, do, lse, delta)
    b, s, hq, d = q.shape
    dq = torch.empty_like(q)
    t = tables.on(q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _lib().sparse_bwd_dq_launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), t["layout"].data_ptr(),
            t["q_order"].data_ptr(), t["k_walk"].data_ptr(), t["k_cnt"].data_ptr(),
            t["q_tile_order"].data_ptr(), b, s, hq, k.shape[2], d, tables.layout.shape[1],
            tables.block, tables.k_walk.shape[2],
            float(scale), int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"sparse_bwd_dq kernel launch failed: cudaError_t {rc}")
    sparse_bwd_dq.launches += 1
    sparse_bwd_dq.tc_launches += flash.uses_tensor_cores(q.dtype)
    count_kernel(sparse_bwd_dq_reference, (q, k, v, do, lse, delta, tables, scale, causal),
                 (dq, ))
    return dq


# kernel launches in this process (the CPU path never counts); tc_launches
# counts those that went to the tensor-core kernels; each launch adds its
# plain version's FLOPs and its own bytes to an open count (ops.count_kernel)
sparse_fwd.launches = sparse_fwd.tc_launches = 0
sparse_bwd_dkdv.launches = sparse_bwd_dkdv.tc_launches = 0
sparse_bwd_dq.launches = sparse_bwd_dq.tc_launches = 0


class _Sparse(torch.autograd.Function):
    """out; the backward is the dK/dV and dQ kernels from the saved lse
    (the JAX ``_sparse`` custom VJP, attention.py:356-367).  Differentiable
    once: a second derivative raises."""

    @staticmethod
    def forward(ctx, q, k, v, tables, scale, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = sparse_fwd(q, k, v, tables, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.tables, ctx.scale, ctx.causal = tables, scale, causal
        return out

    @staticmethod
    def backward(ctx, g_out):
        """``delta = rowsum(do * out)`` in fp32 is a torch reduction (XLA-composed
        in JAX, attention.py:268-269)."""
        if torch.is_grad_enabled():
            raise RuntimeError(
                "block-sparse attention is differentiable once: a second derivative "
                "(create_graph=True) would differentiate the backward kernels, which have no "
                "derivative of their own (JAX's jvp of the custom_vjp Pallas call raises too); "
                "take Hessian products through plain attention (models.transformer.sdpa)")
        q, k, v, out, lse = ctx.saved_tensors
        do = g_out.contiguous()
        delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
        dk, dv = sparse_bwd_dkdv(q, k, v, do, lse, delta, ctx.tables, ctx.scale, ctx.causal)
        dq = sparse_bwd_dq(q, k, v, do, lse, delta, ctx.tables, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None


# ------------------------------------------------------------------ public API
def _layout_element_mask(layout: np.ndarray, block: int, s: int, n_heads: int, device=None,
                         causal: bool = False):
    """Expand a block layout to a [1, H, S, S] bool element mask (its first S
    rows and columns; with causal, only the lower triangle)."""
    lay = torch.from_numpy(np.ascontiguousarray(layout)).to(device=device, dtype=torch.bool)
    mask = lay.repeat_interleave(block, 1).repeat_interleave(block, 2)[:, :s, :s]
    if causal:
        mask = mask & torch.ones((s, s), dtype=torch.bool, device=device).tril()
    return mask.expand(n_heads, s, s)[None]


def _scale(d, softmax_scale):
    return softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)


def sparse_attention(q, k, v, layout, block: int, *, causal: bool = False,
                     softmax_scale: Optional[float] = None, mask=None):
    """Block-sparse attention.  q/k/v [B, S, H, D] (GQA allowed), ``layout``
    uint8 [H or 1, NB, NB] from a SparsityConfig, ``block`` its block size.

    NB * block must cover S (the rows past S are masked).  A dense element
    ``mask``, or a block that is not a multiple of 8, goes to ``sdpa`` with the
    layout expanded to an element mask (attention.py:412-423); otherwise the
    kernels run on CUDA tensors and their plain versions on CPU tensors.
    """
    b, s, hq, d = q.shape
    if k.shape[1] != s:
        raise NotImplementedError(
            "sparse_attention supports self-attention only (sq == sk), as in the "
            "reference (sparse_self_attention.py:121) — the block layout has no "
            "meaning for a query/cache length mismatch (decode)")
    layout = np.asarray(layout, dtype=np.uint8)
    nb = layout.shape[1]
    if nb * block < s:
        raise ValueError(f"layout covers {nb * block} positions < seq_len {s}")
    scale = _scale(d, softmax_scale)
    if mask is not None or block % 8 != 0:
        from ...models.transformer import sdpa
        lm = _layout_element_mask(layout, block, s, hq, q.device)
        if mask is not None:
            lm = torch.logical_and(lm, mask)
        return sdpa(q, k, v, causal=causal, mask=lm, softmax_scale=scale)
    tables = _get_tables(layout, hq, block, k.shape[2])
    return _Sparse.apply(q, k, v, tables, scale, causal)


def make_sparse_attention_fn(config, max_seq_length: int):
    """An ``attention_fn`` for ``models.transformer.attention_block`` from a
    SparsityConfig: the layout is made once at ``max_seq_length`` and sliced
    per call (attention.py:428-442)."""
    master = config.make_layout(max_seq_length)

    def attention_fn(q, k, v, causal=True, mask=None, softmax_scale=None):
        s = q.shape[1]
        nb = -(-s // config.block)
        return sparse_attention(q, k, v, master[:, :nb, :nb], config.block, causal=causal,
                                softmax_scale=softmax_scale, mask=mask)

    return attention_fn


def make_config_attention_fn(section):
    """An ``attention_fn`` straight from the training config's
    ``sparse_attention`` section (``runtime/config.py::SparseAttentionConfig``),
    as attention.py:445-470: the layout is built at the first call of each
    (heads, seq) and its tables kept with it.  Decode-shaped calls (sq != sk)
    and sequences not divisible by ``block`` take the dense default."""
    layouts, tables = {}, {}

    def attention_fn(q, k, v, causal=True, mask=None, softmax_scale=None):
        s, h, kvh = q.shape[1], q.shape[2], k.shape[2]
        if q.shape[1] != k.shape[1] or s % section.block != 0:
            from ...models.transformer import default_attention
            return default_attention(q.device)(q, k, v, causal=causal, mask=mask,
                                               softmax_scale=softmax_scale)
        if (h, s) not in layouts:
            layouts[(h, s)] = section.build(h).make_layout(s)
        if mask is not None:
            return sparse_attention(q, k, v, layouts[(h, s)], section.block, causal=causal,
                                    softmax_scale=softmax_scale, mask=mask)
        if (h, kvh, s) not in tables:  # kept here: no layout hashing at each call
            tables[(h, kvh, s)] = _get_tables(layouts[(h, s)], h, section.block, kvh)
        return _Sparse.apply(q, k, v, tables[(h, kvh, s)], _scale(q.shape[3], softmax_scale),
                             causal)

    return attention_fn


def pad_to_block_size(block: int, x, pad_token_id: int = 0):
    """Right-pad token ids [B, S] to a multiple of ``block`` (attention.py:473).
    Returns (padded, pad_len)."""
    s = x.shape[1]
    pad = (-s) % block
    if pad == 0:
        return x, 0
    x = torch.as_tensor(x)
    return torch.nn.functional.pad(x, (0, pad), value=pad_token_id), pad


# ------------------------------------------------------------------ checks
def _check(q, k, v, tables: _Tables, do=None, lse=None, delta=None):
    """Raise on anything the kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"sparse kernels: q [B, S, H, D] and k/v [B, S, KV, D] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, hq, d = q.shape
    kvh = k.shape[2]
    if (tables.n_heads, tables.n_kv_heads) != (hq, kvh):
        raise ValueError(f"sparse kernels: tables for {tables.n_heads} q / {tables.n_kv_heads} "
                         f"kv heads, inputs have {hq} / {kvh}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"sparse kernels: q/k/v must share one of {list(_DTYPE_CODES)}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"sparse kernels: head_dim {d} not in {_HEAD_DIMS}")
    if tables.block % 8 or tables.layout.shape[1] * tables.block < s:
        raise ValueError(f"sparse kernels: block {tables.block} must be a multiple of 8 and the "
                         f"layout's {tables.layout.shape[1]} blocks must cover S={s}")
    if do is not None:
        if do.shape != q.shape or do.dtype != q.dtype:
            raise ValueError(f"sparse kernels: do must be {tuple(q.shape)} {q.dtype}, got "
                             f"{tuple(do.shape)} {do.dtype}")
        for name, x in (("lse", lse), ("delta", delta)):
            if x.dtype != torch.float32 or tuple(x.shape) != (b, hq, s):
                raise ValueError(f"sparse kernels: {name} must be float32 {(b, hq, s)}, got "
                                 f"{x.dtype} {tuple(x.shape)}")
    tensors = [("q", q), ("k", k), ("v", v), ("do", do), ("lse", lse), ("delta", delta)]
    tensors = [(name, x) for name, x in tensors if x is not None]
    if len({x.device for _, x in tensors}) != 1:
        raise ValueError("sparse kernels: inputs on several devices")
    for name, x in tensors:
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"sparse kernels: {name} must be contiguous and start on a 16-byte "
                             f"boundary")


def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures declared."""
    global _LIB
    if _LIB is None:
        lib = _build.load("sparse_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i] * 8 + [f, i, p]  # B, S, H, KV, D, NB, block, width, scale, causal, stream
        lib.sparse_fwd_launch.argtypes = [i] + [p] * 10 + tail
        lib.sparse_bwd_dkdv_launch.argtypes = [i] + [p] * 13 + tail
        lib.sparse_bwd_dq_launch.argtypes = [i] + [p] * 12 + tail
        for fn in (lib.sparse_fwd_launch, lib.sparse_bwd_dkdv_launch, lib.sparse_bwd_dq_launch):
            fn.restype = i
        _LIB = lib
    return _LIB

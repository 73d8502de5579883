"""The limit that holds the tensor-core block-sparse kernels (bf16/fp16
forward, dK/dV and dQ) to account, on the CPU.  The kernels round P (and dS)
to the input type before the second products, as flash's tensor-core kernels
do, so they are held to ``flash.tensor_core_limit`` row by row against the
fp32 plain version, with the rounding plain version (``round_to=``) for
``rounded`` and, for dQ, ``sparse_dq_fp32_floor``.  These tests show that the
rounding plain versions, and a tile-by-tile emulation of the kernels' walk
(64-position tiles gathered from the host tables in launch order, the causal
chunk skip or stop, P and dS rounded, fp32 sums), pass that limit on the
layouts the port runs, and that it rejects the faults a kernel could
plausibly have.  The fp32 plain forward and backward the limit measures
against are held to the JAX package's ``_sparse_fwd`` and ``_sparse`` custom
VJP, their Pallas kernels in interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import _pallas
from deepspeed_tpu.ops.sparse_attention import attention as jattn
from deepspeed_tpu_torch.ops.attention import flash
from deepspeed_tpu_torch.ops.sparse_attention import attention as sp
from deepspeed_tpu_torch.runtime.config import SparseAttentionConfig

DTYPES = [torch.bfloat16, torch.float16]
# the [train-sparse] section: DeepSpeed's documented `fixed` example, causal
TRAIN_SPARSE = {"mode": "fixed", "block": 16, "different_layout_per_head": True,
                "num_local_blocks": 4, "num_global_blocks": 1,
                "num_different_global_patterns": 4, "horizontal_global_attention": False,
                "attention": "unidirectional"}
BIGBIRD = {"mode": "bigbird", "block": 32, "attention": "bidirectional", "num_random_blocks": 2}
# (name, B, S, H, KV, D, causal, layout keys over TRAIN_SPARSE)
LAYOUTS = [
    ("train_fixed_s512", 1, 512, 4, 4, 128, True, {}),
    ("gqa_h4_kv2", 2, 256, 4, 2, 64, True, {}),
    ("block8_tail_s100", 2, 100, 2, 1, 64, True,
     {"block": 8, "num_local_blocks": 2, "num_different_global_patterns": 2}),
    ("block24_tail_s209", 1, 209, 4, 2, 64, True, {"block": 24}),
    ("bigbird_noncausal", 1, 256, 4, 4, 64, False, BIGBIRD),
]


def _ids(cases):
    return [c[0] for c in cases]


def _tables(S, H, KV, layout_keys):
    cfg = SparseAttentionConfig(**{**TRAIN_SPARSE, **layout_keys})
    layout = cfg.build(H).make_layout(-(-S // cfg.block) * cfg.block)
    return sp._get_tables(layout, H, cfg.block, KV)


def _inputs(seed, dtype, B, S, H, KV, D):
    """q, k, v, do in ``dtype`` from numpy normals."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
                 for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))


def _live(tables, h, qp, kp, causal):
    """[len(qp), len(kp)] bool: the element mask of the gathered positions."""
    qa, ka = np.meshgrid(qp, kp, indexing="ij")
    ok = (qa >= 0) & (ka >= 0)
    ok[ok] &= tables.layout[h, qa[ok] // tables.block, ka[ok] // tables.block].astype(bool)
    if causal:
        ok &= ka <= qa
    return torch.from_numpy(ok)


def _gather(x, pos, head):
    """x[:, pos, head] as fp32 with zero rows where pos < 0 (the zero-filled rows)."""
    rows = x[:, np.maximum(pos, 0), head].float()
    return rows * torch.from_numpy(pos >= 0)[None, :, None]


def _walk(tables, walk, cnt, h, t):
    return walk[h, t, :cnt[h, t]]


def emulate_dkdv(q, k, v, do, lse, delta, tables, scale, causal, fault=None):
    """The tensor-core dK/dV kernel's walk: for each kv head, the 64-key tiles
    of ``k_order`` in launch order; for each q head of the group, the 64-query
    chunks of ``q_walk`` from the first that reaches the tile's first key; P
    and dS in fp32 from lse and delta under the element mask, rounded to the
    input type before ``P^T dO`` and ``dS^T Q``, fp32 sums.  ``fault``:
    ``"first_chunk_skipped"`` starts each walk one chunk late (a causal skip
    off by one chunk)."""
    B, S, H, D = q.shape
    KV, dt, bs = k.shape[2], q.dtype, tables.block
    group = H // KV
    dk = torch.zeros(B, S, KV, D)
    dv = torch.zeros(B, S, KV, D)
    for g in range(KV):
        for t in tables.k_tile_order[g]:
            kp = sp.tile_positions(tables.k_order[g], bs, S, int(t))
            if not (kp >= 0).any():
                continue
            kmin = kp[kp >= 0].min()
            kt, vt = _gather(k, kp, g), _gather(v, kp, g)
            acc_k, acc_v = torch.zeros(B, sp.TILE, D), torch.zeros(B, sp.TILE, D)
            for h in range(g * group, (g + 1) * group):
                walk = _walk(tables, tables.q_walk, tables.q_cnt, h, t)
                n_chunks = -(-walk.size * bs // sp.TILE)
                first = 0
                if causal:  # chunks that end before the tile's first key are skipped
                    raw = (walk[:, None] * bs + np.arange(bs)).reshape(-1)
                    above = np.nonzero(raw >= kmin)[0]
                    first = above[0] // sp.TILE if above.size else n_chunks
                if fault == "first_chunk_skipped":
                    first += 1
                for c in range(first, n_chunks):
                    qp = sp.tile_positions(walk, bs, S, c)
                    qt, dot = _gather(q, qp, h), _gather(do, qp, h)
                    lse_c = lse[:, h, np.maximum(qp, 0)][..., None]
                    delta_c = delta[:, h, np.maximum(qp, 0)][..., None]
                    live = _live(tables, h, qp, kp, causal)[None]
                    s = torch.einsum("bqd,bkd->bqk", qt, kt) * scale
                    p = torch.where(live, torch.exp(s - lse_c), 0.0)
                    dp = torch.einsum("bqd,bkd->bqk", dot, vt)
                    ds = p * (dp - delta_c) * scale
                    acc_v += torch.einsum("bqk,bqd->bkd", p.to(dt).float(), dot)
                    acc_k += torch.einsum("bqk,bqd->bkd", ds.to(dt).float(), qt)
            on = kp >= 0
            dk[:, kp[on], g] = acc_k[:, on]
            dv[:, kp[on], g] = acc_v[:, on]
    return dk.to(dt), dv.to(dt)


def emulate_dq(q, k, v, do, lse, delta, tables, scale, causal, fault=None, other_order=False):
    """The tensor-core dQ kernel's walk: for each q head, the 64-query tiles of
    ``q_order`` in launch order, each walking the 64-key chunks of ``k_walk``
    up to the tile's last query; dS in fp32 under the element mask, rounded
    to the input type before ``dS K``, fp32 sums.  ``fault``:
    ``"last_chunk_dropped"`` stops each walk one chunk early.  With
    ``other_order`` S and dP are summed over D in float64 and rounded once:
    another order than the plain version's fp32 sums, as the tensor cores'
    is."""
    dots = torch.float64 if other_order else torch.float32
    B, S, H, D = q.shape
    KV, dt, bs = k.shape[2], q.dtype, tables.block
    group = H // KV
    dq = torch.zeros(B, S, H, D)
    for h in range(H):
        g = h // group
        for t in tables.q_tile_order[h]:
            qp = sp.tile_positions(tables.q_order[h], bs, S, int(t))
            if not (qp >= 0).any():
                continue
            walk = _walk(tables, tables.k_walk, tables.k_cnt, h, t)
            n_chunks = -(-walk.size * bs // sp.TILE)
            if causal:  # chunks that start past the tile's last query are not walked
                raw = (walk[:, None] * bs + np.arange(bs)).reshape(-1)
                n_chunks = -(-int((raw <= qp.max()).sum()) // sp.TILE)
            if fault == "last_chunk_dropped":
                n_chunks -= 1
            qt, dot = _gather(q, qp, h), _gather(do, qp, h)
            lse_t = lse[:, h, np.maximum(qp, 0)][..., None]
            delta_t = delta[:, h, np.maximum(qp, 0)][..., None]
            acc = torch.zeros(B, sp.TILE, D)
            for c in range(n_chunks):
                kp = sp.tile_positions(walk, bs, S, c)
                kt, vt = _gather(k, kp, g), _gather(v, kp, g)
                live = _live(tables, h, qp, kp, causal)[None]
                s = torch.einsum("bqd,bkd->bqk", qt.to(dots), kt.to(dots)).float()
                dp = torch.einsum("bqd,bkd->bqk", dot.to(dots), vt.to(dots)).float()
                p = torch.where(live, torch.exp(s * scale - lse_t), 0.0)
                ds = p * (dp - delta_t) * scale
                acc += torch.einsum("bqk,bkd->bqd", ds.to(dt).float(), kt)
            on = qp >= 0
            dq[:, qp[on], h] = acc[:, on]
    return dq.to(dt)


def emulate_fwd(q, k, v, tables, scale, causal, fault=None):
    """The tensor-core forward's walk: for each q head, the 64-query tiles of
    ``q_order`` in launch order (``q_tile_order``), each walking the 64-key
    chunks of ``k_walk`` up to the tile's last query; per chunk the element
    mask, an online softmax in fp32, P rounded to the input type before ``P
    V``, l summing the fp32 P; out = acc / l (0 where l = 0), lse = m +
    log l (-1e30 where l = 0).  ``fault``: ``"last_chunk_dropped"`` stops
    each walk one chunk early."""
    B, S, H, D = q.shape
    KV, dt, bs = k.shape[2], q.dtype, tables.block
    group = H // KV
    out = torch.zeros(B, S, H, D)
    lse = torch.zeros(B, H, S)
    for h in range(H):
        g = h // group
        for t in tables.q_tile_order[h]:
            qp = sp.tile_positions(tables.q_order[h], bs, S, int(t))
            if not (qp >= 0).any():
                continue
            walk = _walk(tables, tables.k_walk, tables.k_cnt, h, t)
            n_chunks = -(-walk.size * bs // sp.TILE)
            if causal:  # chunks that start past the tile's last query are not walked
                raw = (walk[:, None] * bs + np.arange(bs)).reshape(-1)
                n_chunks = -(-int((raw <= qp.max()).sum()) // sp.TILE)
            if fault == "last_chunk_dropped":
                n_chunks -= 1
            qt = _gather(q, qp, h)
            m = torch.full((B, sp.TILE, 1), flash.NEG_INF)
            l = torch.zeros(B, sp.TILE, 1)
            acc = torch.zeros(B, sp.TILE, D)
            for c in range(n_chunks):
                kp = sp.tile_positions(walk, bs, S, c)
                kt, vt = _gather(k, kp, g), _gather(v, kp, g)
                live = _live(tables, h, qp, kp, causal)[None]
                s = torch.where(live, torch.einsum("bqd,bkd->bqk", qt, kt) * scale,
                                flash.NEG_INF)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                p = torch.where(live, torch.exp(s - m_new), 0.0)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + torch.einsum("bqk,bkd->bqd", p.to(dt).float(), vt)
                m = m_new
            on = qp >= 0
            out[:, qp[on], h] = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)[:, on]
            lse[:, h, qp[on]] = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)),
                                            flash.NEG_INF)[:, on, 0]
    return out.to(dt), lse


def _references(q, k, v, do, tables, scale, causal):
    """{part: (fp32 plain, rounding plain[, floor])} on the inputs' values, and
    the lse/delta the backward takes."""
    f = [x.float() for x in (q, k, v, do)]
    out, lse = sp.sparse_fwd_reference(*f[:3], tables, scale, causal)
    delta = (f[3] * out).sum(-1).transpose(1, 2).contiguous()
    args = (*f, lse, delta, tables, scale, causal)
    dk, dv = sp.sparse_bwd_dkdv_reference(*args)
    dk_r, dv_r = sp.sparse_bwd_dkdv_reference(*args, round_to=q.dtype)
    dq, dq_r = (sp.sparse_bwd_dq_reference(*args, round_to=r) for r in (None, q.dtype))
    floor = sp.sparse_dq_fp32_floor(*args)
    out_r = sp.sparse_fwd_reference(*f[:3], tables, scale, causal, round_to=q.dtype)[0]
    return ({"out": (out, out_r), "dk": (dk, dk_r), "dv": (dv, dv_r), "dq": (dq, dq_r, floor)},
            lse, delta)


@functools.lru_cache(maxsize=None)
def _case(name, dtype):
    """(inputs, tables, references, lse, delta, emulated dk, dv, dq) of a LAYOUTS case."""
    _, B, S, H, KV, D, causal, keys = next(c for c in LAYOUTS if c[0] == name)
    tables = _tables(S, H, KV, keys)
    q, k, v, do = _inputs(len(name), dtype, B, S, H, KV, D)
    scale = 1.0 / np.sqrt(D)
    refs, lse, delta = _references(q, k, v, do, tables, scale, causal)
    args = (q, k, v, do, lse, delta, tables, scale, causal)
    emulated = dict(zip(("dk", "dv"), emulate_dkdv(*args)), dq=emulate_dq(*args))
    emulated["out"], emulated["lse"] = emulate_fwd(q, k, v, tables, scale, causal)
    return (q, k, v, do), tables, refs, lse, delta, emulated


def _within(got, refs):
    ok, _, ratio, _ = flash.tensor_core_limit(got, *refs)
    return ok, ratio


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16"])
@pytest.mark.parametrize("name,B,S,H,KV,D,causal,keys", LAYOUTS, ids=_ids(LAYOUTS))
def test_rounding_versions_and_emulation_pass_the_limit(dtype, name, B, S, H, KV, D, causal,
                                                        keys):
    """The rounding plain versions stored in the input type, and the tile
    emulation of the three kernels, within the row limit (dQ with its
    floor); the emulated forward's lse within 1e-4 of the plain lse."""
    (q, k, v, do), tables, refs, lse, delta, emulated = _case(name, dtype)
    scale = 1.0 / np.sqrt(D)
    args = (q, k, v, do, lse, delta, tables, scale, causal)
    dk_r, dv_r = sp.sparse_bwd_dkdv_reference(*args, round_to=dtype)
    dq_r = sp.sparse_bwd_dq_reference(*args, round_to=dtype)
    out_r = sp.sparse_fwd_reference(q, k, v, tables, scale, causal, round_to=dtype)[0]
    assert {x.dtype for x in (dk_r, dv_r, dq_r, out_r)} == {dtype}
    for part, got in (("dk", dk_r), ("dv", dv_r), ("dq", dq_r), ("out", out_r),
                      ("dk", emulated["dk"]), ("dv", emulated["dv"]), ("dq", emulated["dq"]),
                      ("out", emulated["out"])):
        ok, ratio = _within(got, refs[part])
        assert ok, f"{part}: {ratio:.3f} of the limit"
    torch.testing.assert_close(emulated["lse"], lse, atol=1e-4, rtol=1e-4)


def _last_block(tables, S):
    return np.arange((tables.layout.shape[1] - 1) * tables.block, S)


def _local_tile(tables, S):
    """Positions of kv head 0's key tile with the shortest walk (seen by no
    global query block), the tile a kernel that mishandled the launch order
    or a short walk would leave empty."""
    for t in tables.k_tile_order[0][::-1]:
        pos = sp.tile_positions(tables.k_order[0], tables.block, S, int(t))
        if (pos >= 0).any():
            return pos[pos >= 0]


def _spoil(fault, x, tables, S):
    bad = x.clone()
    if fault.startswith("last_block_zeroed"):
        bad[:, _last_block(tables, S)] = 0
    elif fault.startswith("local_tile_zeroed"):
        bad[:, _local_tile(tables, S), :1] = 0
    else:  # late rows of dQ or out scaled by 1.05
        bad[:, -64:] = (bad[:, -64:].float() * 1.05).to(bad.dtype)
    return bad


SPOILS = [("last_block_zeroed", "dk"), ("last_block_zeroed", "dv"), ("local_tile_zeroed", "dk"),
          ("local_tile_zeroed", "dv"), ("dq_last_rows_x1.05", "dq"),
          ("out_last_rows_x1.05", "out")]
FAULT_LAYOUTS = ["train_fixed_s512", "block24_tail_s209"]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16"])
@pytest.mark.parametrize("name", FAULT_LAYOUTS)
@pytest.mark.parametrize("fault,part", SPOILS, ids=[f"{f}-{p}" for f, p in SPOILS])
def test_limit_rejects_spoiled_outputs(dtype, name, fault, part):
    """The emulated kernels pass; the faults ``chip_smoke.py`` injects into the
    kernels' outputs on the card fail (a limit for the whole tensor passes the
    last block zeroed: under the causal mask its keys' dK/dV are small)."""
    (q, *_), tables, refs, _, _, emulated = _case(name, dtype)
    assert _within(emulated[part], refs[part])[0]
    ok, ratio = _within(_spoil(fault, emulated[part], tables, q.shape[1]), refs[part])
    assert not ok, f"{fault} passed at {ratio:.3f} of the limit on {part}"


WALK_FAULTS = [("first_chunk_skipped", "dk"), ("first_chunk_skipped", "dv"),
               ("last_chunk_dropped", "dq"), ("last_chunk_dropped", "out")]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16"])
@pytest.mark.parametrize("fault,part", WALK_FAULTS, ids=[f"{f}-{p}" for f, p in WALK_FAULTS])
def test_limit_rejects_walk_faults(dtype, fault, part):
    """A causal skip or stop one chunk off, in the emulated walk, fails."""
    (q, k, v, do), tables, refs, lse, delta, _ = _case("train_fixed_s512", dtype)
    args = (q, k, v, do, lse, delta, tables, 1.0 / np.sqrt(q.shape[-1]), True)
    if part == "dq":
        bad = emulate_dq(*args, fault=fault)
    elif part == "out":
        bad = emulate_fwd(q, k, v, tables, args[7], True, fault=fault)[0]
    else:
        bad = emulate_dkdv(*args, fault=fault)[part == "dv"]
    ok, ratio = _within(bad, refs[part])
    assert not ok, f"{fault} passed at {ratio:.3f} of the limit on {part}"


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16"])
@pytest.mark.parametrize("name", FAULT_LAYOUTS)
def test_limit_rejects_a_forward_with_the_last_block_of_kv_zeroed(dtype, name):
    """The emulated forward on K and V whose last layout block is zeroed
    (the fault ``chip_smoke.py`` injects into the kernel's inputs) fails the
    limit against the plain version on the true inputs."""
    (q, k, v, _), tables, refs, _, _, _ = _case(name, dtype)
    last = _last_block(tables, q.shape[1])
    k0, v0 = k.clone(), v.clone()
    k0[:, last] = 0
    v0[:, last] = 0
    bad = emulate_fwd(q, k0, v0, tables, 1.0 / np.sqrt(q.shape[-1]),
                      next(c for c in LAYOUTS if c[0] == name)[6])[0]
    ok, ratio = _within(bad, refs["out"])
    assert not ok, f"passed at {ratio:.3f} of the limit"


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16"])
def test_dq_needs_its_floor_at_row_0(dtype):
    """The emulated dQ with S and dP summed in another order than the plain
    version's: without the fp32 floor the limit rejects it, and only at query
    0 (which sees key 0 alone: dQ = 0 exactly, fp32 noise on both sides);
    with the floor it passes."""
    (q, k, v, do), tables, refs, lse, delta, _ = _case("train_fixed_s512", dtype)
    ref, rounded, floor = refs["dq"]
    dq = emulate_dq(q, k, v, do, lse, delta, tables, 1.0 / np.sqrt(q.shape[-1]), True,
                    other_order=True)
    assert flash.tensor_core_limit(dq, ref, rounded, floor)[0]
    assert not flash.tensor_core_limit(dq, ref, rounded)[0]
    assert flash.tensor_core_limit(dq[:, 1:], ref[:, 1:], rounded[:, 1:])[0]
    assert float(ref[:, 0].abs().max()) < 1e-5  # noise around an exact 0


def test_round_to_none_is_the_plain_version_bit_for_bit():
    """``round_to=None`` is the plain version as it was before ``round_to``
    existed (its formula copied here), bit for bit."""
    (q, k, v, do), tables, _, lse, delta, _ = _case("gqa_h4_kv2", torch.bfloat16)
    scale = 0.125
    args = (q, k, v, do, lse, delta, tables, scale, True)
    p, ds = sp._probs_and_dscores(*args)
    b, s, kvh, d = k.shape
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float()).reshape(b, s, kvh, 2, d).sum(3)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).reshape(b, s, kvh, 2, d).sum(3)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, sp._expand_kv(k.float(), 2))
    got_dk, got_dv = sp.sparse_bwd_dkdv_reference(*args, round_to=None)
    assert torch.equal(got_dk, dk.to(k.dtype)) and torch.equal(got_dv, dv.to(v.dtype))
    assert torch.equal(sp.sparse_bwd_dq_reference(*args, round_to=None), dq.to(q.dtype))
    assert torch.equal(sp.sparse_bwd_dq_reference(*args), dq.to(q.dtype))
    # the forward as it stood before round_to
    mask = tables.element_mask(q.shape[1], True, q.device)[None]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), sp._expand_kv(k.float(), 2)) * scale
    s = torch.where(mask, s, sp.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l_safe = torch.where(p.sum(-1, keepdim=True) == 0.0, 1.0, p.sum(-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bqhd", p, sp._expand_kv(v.float(), 2))
    out = (out / l_safe.permute(0, 2, 1, 3)).to(q.dtype)
    for got in (sp.sparse_fwd_reference(q, k, v, tables, scale, True),
                sp.sparse_fwd_reference(q, k, v, tables, scale, True, round_to=None)):
        assert torch.equal(got[0], out)
        assert torch.equal(got[1], (m + torch.log(l_safe)).squeeze(-1))


@pytest.mark.parametrize("name,B,S,H,KV,D,causal,keys", LAYOUTS, ids=_ids(LAYOUTS))
def test_fp32_backward_matches_jax_custom_vjp(name, B, S, H, KV, D, causal, keys, monkeypatch):
    """The fp32 plain backward (dQ, dK, dV from the plain forward's lse and
    delta) against the JAX package's ``_sparse`` custom VJP with its Pallas
    forward, dK/dV and dQ kernels in interpret mode, on the same values, at
    1e-4."""
    monkeypatch.setattr(_pallas, "INTERPRET", True)
    D = 16  # the layout is the point; a narrow head keeps interpret mode quick
    tables = _tables(S, H, KV, keys)
    q, k, v, do = (x.float() for x in _inputs(3, torch.float32, 1, S, H, KV, D))
    scale = 1.0 / np.sqrt(D)
    layout = tables.layout

    def jfn(q, k, v):
        return jattn._sparse(q, k, v, jattn._get_tables(layout, H), scale, causal, tables.block)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    jdq, jdk, jdv = vjp(jnp.asarray(do.numpy()))
    out, lse = sp.sparse_fwd_reference(q, k, v, tables, scale, causal)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, tables, scale, causal)
    dk, dv = sp.sparse_bwd_dkdv_reference(*args)
    dq = sp.sparse_bwd_dq_reference(*args)
    for got, ref, which in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4,
                                   err_msg=which)


@pytest.mark.parametrize("name,B,S,H,KV,D,causal,keys", LAYOUTS, ids=_ids(LAYOUTS))
def test_launch_order_is_longest_walk_first(name, B, S, H, KV, D, causal, keys):
    """Each head's launch order is a permutation of its tiles with walk
    lengths that never increase: k_cnt for dQ, q_cnt summed over the GQA group
    for dK/dV."""
    tables = _tables(S, H, KV, keys)
    group = H // KV
    k_len = tables.q_cnt.reshape(KV, group, tables.n_tiles).sum(1)
    for order, lengths in ((tables.q_tile_order, tables.k_cnt), (tables.k_tile_order, k_len)):
        assert order.shape == lengths.shape and order.dtype == np.int32
        for row, length in zip(order, lengths):
            assert sorted(row.tolist()) == list(range(tables.n_tiles))
            assert (np.diff(length[row]) <= 0).all()
    assert set(tables.on("cpu")) >= {"q_tile_order", "k_tile_order"}


def test_cpu_calls_count_no_launches():
    """bf16 and fp16 take the tensor-core kernels on CUDA, fp32 the CUDA-core
    ones; a CPU call runs the plain versions and counts nothing."""
    assert flash.uses_tensor_cores(torch.bfloat16) and not flash.uses_tensor_cores(torch.float32)
    (q, k, v, do), tables, _, lse, delta, _ = _case("gqa_h4_kv2", torch.bfloat16)
    fns = (sp.sparse_fwd, sp.sparse_bwd_dkdv, sp.sparse_bwd_dq)
    counts = [(fn.launches, fn.tc_launches) for fn in fns]
    out, _ = sp.sparse_fwd(q, k, v, tables, 0.125, True)
    dk, dv = sp.sparse_bwd_dkdv(q, k, v, do, lse, delta, tables, 0.125, True)
    dq = sp.sparse_bwd_dq(q, k, v, do, lse, delta, tables, 0.125, True)
    assert [(fn.launches, fn.tc_launches) for fn in fns] == counts
    assert out.dtype == dk.dtype == dv.dtype == dq.dtype == torch.bfloat16


@pytest.mark.parametrize("name,B,S,H,KV,D,causal,keys", LAYOUTS, ids=_ids(LAYOUTS))
def test_fp32_forward_matches_jax_kernel(name, B, S, H, KV, D, causal, keys, monkeypatch):
    """The fp32 plain forward's out and lse against the JAX package's
    ``_sparse_fwd`` with its Pallas kernel in interpret mode, at the
    tolerance of test_torch_sparse_attention.py's forward test (2e-5)."""
    monkeypatch.setattr(_pallas, "INTERPRET", True)
    D = 16  # the layout is the point; a narrow head keeps interpret mode quick
    tables = _tables(S, H, KV, keys)
    q, k, v, _ = (x.float() for x in _inputs(5, torch.float32, 1, S, H, KV, D))
    scale = 1.0 / np.sqrt(D)
    jout, jlse = jattn._sparse_fwd(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                   jattn._get_tables(tables.layout, H), scale, causal,
                                   tables.block)
    out, lse = sp.sparse_fwd_reference(q, k, v, tables, scale, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=2e-5, rtol=2e-5)

"""The limit that holds the tensor-core flash kernels (bf16/fp16 forward,
dK/dV and dQ) to account, on the CPU: ``flash.tensor_core_limit``,
FlashAttention's own test rule taken row by row.  The kernels round P (and,
backward, dS) to the input type before the second product, so against the
fp32 plain version
each row of their output may be off by twice what the operand-rounding plain
version is off in that row, plus an ulp of the store.  These tests show that
the rounding versions, and a tile-by-tile emulation of the kernels'
arithmetic, pass that limit, and that it rejects the faults a kernel could
plausibly have, at small shapes and at the training shape's causal length.  The fp32 plain version the limit
measures against is itself held to the JAX package's Pallas kernel (interpret
mode) on the same inputs."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import _pallas
from deepspeed_tpu.ops.attention import flash as jflash
from deepspeed_tpu_torch.ops.attention import flash

DTYPES = [torch.bfloat16, torch.float16]
KEY_TILE = 128  # keys a tile in the tensor-core forward kernel (64 at head dim 256)
DQ_TILE = 64  # query rows a block and keys a tile in the tensor-core dQ kernel
LATE = 64  # the late rows or keys a fault spoils: a query tile of a warpgroup, a dK/dV key block

# (name, B, Sq, Sk, H, KV, D, causal): ragged tails, GQA, sq < sk, sq > sk
# (causal rows that see no key), non-causal; Phi-2's head dim 80 and
# GPT-J-6B's 256 among them
SHAPES = [
    ("causal_gqa_s200", 1, 200, 200, 4, 2, 64, True),
    ("causal_sq90_lt_sk130", 2, 90, 130, 4, 2, 64, True),
    ("causal_sq130_gt_sk70", 1, 130, 70, 2, 1, 64, True),
    ("full_s77_d128", 1, 77, 77, 2, 2, 128, False),
    ("causal_gqa_s200_d80", 1, 200, 200, 4, 2, 80, True),
    ("full_sq90_lt_sk130_d80", 1, 90, 130, 2, 1, 80, False),
    ("causal_sq130_gt_sk70_d256", 1, 130, 70, 2, 1, 256, True),
    ("full_s77_gqa_d256", 1, 77, 77, 4, 2, 256, False),
]


def _ids(shapes):
    return [s[0] for s in shapes]


def _inputs(seed, dtype, B, Sq, Sk, H, KV, D):
    """q, k, v, do in ``dtype`` from numpy normals."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
                 for shape in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D), (B, Sq, H, D)))


def _visible(sq, sk, causal, shift=0):
    if not causal:
        return torch.ones(sq, sk, dtype=torch.bool)
    return torch.arange(sk)[None, :] <= torch.arange(sq)[:, None] + (sk - sq) + shift


def emulate_fwd(q, k, v, scale, causal, fault=None):
    """The tensor-core forward kernel's arithmetic: 128-key tiles (64 at head
    dim 256), a running max, P relative to it rounded to the input type
    before ``P V``, l summing the fp32 P, the correction applied to l and the
    accumulator.  ``fault``:
    ``"mask_off_by_one"`` lets each row see one key past the diagonal;
    ``"stale_max"`` drops the accumulator's correction, so P of earlier tiles
    stays summed against their stale max."""
    B, Sq, H, D = q.shape
    Sk, group, dt = k.shape[1], H // k.shape[2], q.dtype
    vf = v.float().repeat_interleave(group, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float().repeat_interleave(group, 2)) * scale
    vis = _visible(Sq, Sk, causal, shift=1 if fault == "mask_off_by_one" else 0)
    m = torch.full((B, H, Sq), flash.NEG_INF)
    l = torch.zeros(B, H, Sq)
    acc = torch.zeros(B, H, Sq, D)
    tile = KEY_TILE // 2 if D >= 256 else KEY_TILE
    for k0 in range(0, Sk, tile):
        tile_vis = vis[:, k0:k0 + tile]
        st = torch.where(tile_vis, s[..., k0:k0 + tile], flash.NEG_INF)
        m_new = torch.maximum(m, st.amax(-1))
        p = torch.where(tile_vis, torch.exp(st - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc_corr = torch.ones_like(corr) if fault == "stale_max" else corr
        acc = acc * acc_corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(dt).float(), vf[:, k0:k0 + tile])
        m = m_new
    l_safe = torch.where(l == 0, 1.0, l)
    out = (acc / l_safe[..., None]).permute(0, 2, 1, 3).to(dt)
    return out, torch.where(l == 0, flash.NEG_INF, m + torch.log(l_safe))


def emulate_dkdv(q, k, v, do, lse, delta, scale, causal, fault=None):
    """The tensor-core dK/dV kernel's arithmetic: P and dS in fp32 from lse and
    delta, rounded to the input type before ``P^T dO`` and ``dS^T Q``, summed
    over each GQA group in fp32.  ``fault``: ``"p_without_lse"`` (P = exp(s)),
    ``"ds_without_scale"``, ``"one_gqa_head"`` (dK/dV of the group's first
    head instead of the group's sum)."""
    B, Sq, H, D = q.shape
    Sk, KV, dt = k.shape[1], k.shape[2], q.dtype
    group = H // KV
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float().repeat_interleave(group, 2)) * scale
    shift = 0.0 if fault == "p_without_lse" else lse[..., None]
    p = torch.where(_visible(Sq, Sk, causal), torch.exp(s - shift), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float().repeat_interleave(group, 2))
    ds = p * (dp - delta[..., None]) * (1.0 if fault == "ds_without_scale" else scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do.float()).reshape(B, Sk, KV, group, D)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(dt).float(), q.float()).reshape(B, Sk, KV, group, D)
    if fault == "one_gqa_head":
        return dk[:, :, :, 0].to(dt), dv[:, :, :, 0].to(dt)
    return dk.sum(3).to(dt), dv.sum(3).to(dt)


def emulate_dq(q, k, v, do, lse, delta, scale, causal, fault=None):
    """The tensor-core dQ kernel's arithmetic: 64-row query tiles walking
    64-key tiles, P and dS in fp32 from lse and delta, dS rounded to the input
    type before ``dS K``, the tiles' products summed in fp32.  ``fault``:
    ``"mask_off_by_one"`` lets each row see one key past the diagonal;
    ``"diagonal_tile_dropped"`` skips the key tile a query tile's diagonal
    starts in; ``"delta_omitted"`` takes dS = P dP scale."""
    B, Sq, H, D = q.shape
    Sk, group, dt = k.shape[1], H // k.shape[2], q.dtype
    kf = k.float().repeat_interleave(group, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    vis = _visible(Sq, Sk, causal, shift=1 if fault == "mask_off_by_one" else 0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float().repeat_interleave(group, 2))
    dq = torch.zeros(B, H, Sq, D)
    for q0 in range(0, Sq, DQ_TILE):
        rows = slice(q0, q0 + DQ_TILE)
        diag = (q0 + Sk - Sq) // DQ_TILE * DQ_TILE
        for k0 in range(0, Sk, DQ_TILE):
            if fault == "diagonal_tile_dropped" and k0 == diag:
                continue
            keys = slice(k0, k0 + DQ_TILE)
            p = torch.where(vis[rows, keys], torch.exp(s[:, :, rows, keys] - lse[:, :, rows, None]),
                            0.0)
            shift = 0.0 if fault == "delta_omitted" else delta[:, :, rows, None]
            ds = p * (dp[:, :, rows, keys] - shift) * scale
            dq[:, :, rows] += torch.einsum("bhqk,bkhd->bhqd", ds.to(dt).float(), kf[:, keys])
    return dq.permute(0, 2, 1, 3).to(dt)


def _references(q, k, v, do, scale, causal):
    """fp32 plain versions, operand-rounding plain versions (both unrounded on
    the store; for dQ also its fp32 floor), and the lse/delta the backward
    takes."""
    f = [x.float() for x in (q, k, v, do)]
    out, lse = flash.flash_fwd_reference(*f[:3], scale, causal)
    out_r, _ = flash.flash_fwd_reference(*f[:3], scale, causal, round_to=q.dtype)
    delta = (f[3] * out).sum(-1).transpose(1, 2).contiguous()
    args = (*f, lse, delta, scale, causal)
    dk, dv = flash.flash_bwd_dkdv_reference(*args)
    dk_r, dv_r = flash.flash_bwd_dkdv_reference(*args, round_to=q.dtype)
    dq, dq_r = (flash.flash_bwd_dq_reference(*args, round_to=r) for r in (None, q.dtype))
    dq_floor = flash.dq_fp32_floor(*args)
    return ({"out": (out, out_r), "dk": (dk, dk_r), "dv": (dv, dv_r), "dq": (dq, dq_r, dq_floor)},
            lse, delta)


def _within(got, refs):
    ok, _, ratio, _ = flash.tensor_core_limit(got, *refs)
    return ok, ratio


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16"])
@pytest.mark.parametrize("name,B,Sq,Sk,H,KV,D,causal", SHAPES, ids=_ids(SHAPES))
def test_rounding_versions_pass_the_limit(dtype, name, B, Sq, Sk, H, KV, D, causal):
    """The operand-rounding plain versions stored in the input type, and the
    tile emulation of the forward and dK/dV kernels, within the limit; lse
    within 1e-4."""
    q, k, v, do = _inputs(len(name), dtype, B, Sq, Sk, H, KV, D)
    scale = 1.0 / np.sqrt(D)
    refs, lse, delta = _references(q, k, v, do, scale, causal)
    out_r, _ = flash.flash_fwd_reference(q, k, v, scale, causal, round_to=dtype)
    assert out_r.dtype == dtype
    dk_r, dv_r = flash.flash_bwd_dkdv_reference(q, k, v, do, lse, delta, scale, causal,
                                                round_to=dtype)
    out_e, lse_e = emulate_fwd(q, k, v, scale, causal)
    dk_e, dv_e = emulate_dkdv(q, k, v, do, lse, delta, scale, causal)
    for part, got in (("out", out_r), ("dk", dk_r), ("dv", dv_r),
                      ("out", out_e), ("dk", dk_e), ("dv", dv_e)):
        ok, ratio = _within(got, refs[part])
        assert ok, f"{part}: {ratio:.3f} of the limit"
    torch.testing.assert_close(lse_e, lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16"])
@pytest.mark.parametrize("name,B,Sq,Sk,H,KV,D,causal", SHAPES, ids=_ids(SHAPES))
def test_dq_rounding_versions_pass_the_limit(dtype, name, B, Sq, Sk, H, KV, D, causal):
    """dQ's operand-rounding plain version stored in the input type, and the
    tile emulation of the tensor-core dQ kernel, within the limit."""
    q, k, v, do = _inputs(len(name) + 1, dtype, B, Sq, Sk, H, KV, D)
    scale = 1.0 / np.sqrt(D)
    refs, lse, delta = _references(q, k, v, do, scale, causal)
    dq_r = flash.flash_bwd_dq_reference(q, k, v, do, lse, delta, scale, causal, round_to=dtype)
    assert dq_r.dtype == dtype
    for got in (dq_r, emulate_dq(q, k, v, do, lse, delta, scale, causal)):
        ok, ratio = _within(got, refs["dq"])
        assert ok, f"dq: {ratio:.3f} of the limit"


def test_dq_floor_covers_dp_summed_in_another_order():
    """dQ with dP summed over D in another order (float64, rounded once) than
    the plain version's fp32 sum passes the limit with the fp32 floor.  Query
    0 sees one key, so its dQ is 0 exactly and both sides hold fp32 noise
    there, which the rest of the limit (scaled by the row's own size) cannot
    absorb; the other rows pass without the floor, and the floor stays small
    beside the rest of the limit."""
    q, k, v, do = _inputs(11, torch.bfloat16, 1, 256, 256, 2, 2, 128)
    scale = 1.0 / np.sqrt(128)
    refs, lse, delta = _references(q, k, v, do, scale, True)
    f = [x.float() for x in (q, k, v, do)]
    s = torch.einsum("bqhd,bkhd->bhqk", f[0], f[1]) * scale
    p = torch.where(_visible(256, 256, True), torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.double(), v.double()).float()
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(q.dtype).float(), f[1]).to(q.dtype)
    ref, rounded, floor = refs["dq"]
    assert flash.tensor_core_limit(dq, ref, rounded, floor)[0]
    assert flash.tensor_core_limit(dq[:, 1:], ref[:, 1:], rounded[:, 1:])[0]
    assert float(ref[:, 0].abs().max()) < 1e-5  # noise around an exact 0
    assert float(floor.median()) < 0.1 * flash.tensor_core_limit(dq, ref, rounded)[3]


DQ_FAULTS = ["mask_off_by_one", "diagonal_tile_dropped", "delta_omitted"]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16"])
@pytest.mark.parametrize("fault", DQ_FAULTS)
def test_limit_rejects_dq_faults(dtype, fault):
    q, k, v, do = _inputs(9, dtype, *FAULT_SHAPE[:-1])
    scale = 1.0 / np.sqrt(FAULT_SHAPE[5])
    refs, lse, delta = _references(q, k, v, do, scale, True)
    assert _within(emulate_dq(q, k, v, do, lse, delta, scale, True), refs["dq"])[0]
    bad = emulate_dq(q, k, v, do, lse, delta, scale, True, fault=fault)
    ok, ratio = _within(bad, refs["dq"])
    assert not ok, f"{fault} passed at {ratio:.3f} of the limit"


FWD_FAULTS = ["mask_off_by_one", "stale_max"]
BWD_FAULTS = [("p_without_lse", "dv"), ("ds_without_scale", "dk"), ("one_gqa_head", "dk"),
              ("one_gqa_head", "dv")]
FAULT_SHAPE = (1, 192, 192, 4, 2, 64, True)  # two forward key tiles, a GQA group of 2, causal


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16"])
@pytest.mark.parametrize("fault", FWD_FAULTS)
def test_limit_rejects_forward_faults(dtype, fault):
    q, k, v, do = _inputs(3, dtype, *FAULT_SHAPE[:-1])
    scale = 1.0 / np.sqrt(FAULT_SHAPE[5])
    refs, _, _ = _references(q, k, v, do, scale, True)
    assert _within(emulate_fwd(q, k, v, scale, True)[0], refs["out"])[0]
    ok, ratio = _within(emulate_fwd(q, k, v, scale, True, fault=fault)[0], refs["out"])
    assert not ok, f"{fault} passed at {ratio:.3f} of the limit"


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16"])
@pytest.mark.parametrize("fault,part", BWD_FAULTS, ids=[f"{f}-{p}" for f, p in BWD_FAULTS])
def test_limit_rejects_backward_faults(dtype, fault, part):
    q, k, v, do = _inputs(4, dtype, *FAULT_SHAPE[:-1])
    scale = 1.0 / np.sqrt(FAULT_SHAPE[5])
    refs, lse, delta = _references(q, k, v, do, scale, True)
    index = {"dk": 0, "dv": 1}[part]
    good = emulate_dkdv(q, k, v, do, lse, delta, scale, True)[index]
    assert _within(good, refs[part])[0]
    bad = emulate_dkdv(q, k, v, do, lse, delta, scale, True, fault=fault)[index]
    ok, ratio = _within(bad, refs[part])
    assert not ok, f"{fault} passed at {ratio:.3f} of the limit on {part}"


# the training shape's sequence, head dim and mask (S = 2048, D = 128, causal)
# with two heads of one batch: under the mask the late keys' dK/dV and the
# late rows' out are far smaller than the early ones', which a limit for the
# whole tensor would not see
TRAIN_SHAPE = (1, 2048, 2048, 2, 2, 128)
TRAIN_FAULTS = ["out_last_rows_x1.05", "dk_last_keys_zeroed", "dv_last_keys_zeroed",
                "dq_last_rows_x1.05"]


@functools.lru_cache(maxsize=2)
def _train_shape_outputs(dtype):
    """(references, emulated kernel outputs) at TRAIN_SHAPE, causal."""
    q, k, v, do = _inputs(8, dtype, *TRAIN_SHAPE)
    scale = 1.0 / np.sqrt(TRAIN_SHAPE[-1])
    refs, lse, delta = _references(q, k, v, do, scale, True)
    out = emulate_fwd(q, k, v, scale, True)[0]
    dk, dv = emulate_dkdv(q, k, v, do, lse, delta, scale, True)
    dq = emulate_dq(q, k, v, do, lse, delta, scale, True)
    return refs, {"out": out, "dk": dk, "dv": dv, "dq": dq}


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16"])
@pytest.mark.parametrize("fault", TRAIN_FAULTS)
def test_limit_rejects_late_tile_faults_at_the_train_shape(dtype, fault):
    """The emulated kernels pass; the last 64 query rows' out or dQ scaled by
    1.05, or the last 64 keys' dK or dV zeroed, fail (``chip_smoke.py`` does
    the same to the kernels' outputs on the card)."""
    refs, good = _train_shape_outputs(dtype)
    part = fault[:fault.index("_")]
    assert _within(good[part], refs[part])[0]
    bad = good[part].clone()
    if part in ("out", "dq"):
        bad[:, -LATE:] = (bad[:, -LATE:].float() * 1.05).to(dtype)
    else:
        bad[:, -LATE:] = 0
    ok, ratio = _within(bad, refs[part])
    assert not ok, f"{fault} passed at {ratio:.3f} of the limit"


# a head dim's columns a kernel could drop: at D = 80 the 16 past the first
# 64-column block (a forward that took D / 64 blocks, or an n64 product
# alone, would leave them out), at D = 256 the upper half
COLUMN_FAULTS = {80: slice(64, 80), 256: slice(128, 256)}


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16"])
@pytest.mark.parametrize("d", sorted(COLUMN_FAULTS))
def test_limit_rejects_dropped_head_dim_columns(dtype, d):
    """The emulated kernels pass at head dims 80 and 256; the same outputs
    with the columns of ``COLUMN_FAULTS`` zeroed fail the limit on each of
    out, dK, dV and dQ (``chip_smoke.py`` does the same on the card)."""
    q, k, v, do = _inputs(12, dtype, 1, 160, 160, 4, 2, d)
    scale = 1.0 / np.sqrt(d)
    refs, lse, delta = _references(q, k, v, do, scale, True)
    dk, dv = emulate_dkdv(q, k, v, do, lse, delta, scale, True)
    good = {"out": emulate_fwd(q, k, v, scale, True)[0], "dk": dk, "dv": dv,
            "dq": emulate_dq(q, k, v, do, lse, delta, scale, True)}
    for part, got in good.items():
        assert _within(got, refs[part])[0], part
        bad = got.clone()
        bad[..., COLUMN_FAULTS[d]] = 0
        ok, ratio = _within(bad, refs[part])
        assert not ok, f"{part}: columns {COLUMN_FAULTS[d]} zeroed passed at {ratio:.3f}"


def test_limit_takes_the_store_and_refuses_non_finite():
    ref = torch.from_numpy(np.random.default_rng(5).normal(size=(4, 33)).astype(np.float32))
    stored = ref.to(torch.bfloat16)
    assert flash.tensor_core_limit(stored, ref, ref)[0]  # no operand rounding: the store alone
    nudged = (ref * (1 + 2 * torch.finfo(torch.bfloat16).eps)).to(torch.bfloat16)
    assert not flash.tensor_core_limit(nudged, ref, ref)[0]
    stored[1, 2] = float("nan")
    assert not flash.tensor_core_limit(stored, ref, ref)[0]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16"])
def test_fp32_reference_matches_jax_kernel(dtype, monkeypatch):
    """The fp32 plain version the limit measures against, on inputs of the
    kernel's type, against the JAX package's Pallas flash kernel (interpret
    mode) on the same values; ``round_to=None`` is the plain version itself."""
    monkeypatch.setattr(_pallas, "INTERPRET", True)
    q, k, v, _ = _inputs(6, dtype, 1, 40, 48, 4, 2, 16)
    f = [x.float() for x in (q, k, v)]
    jout, jlse = jflash.flash_attention_with_lse(*(jnp.asarray(x.numpy()) for x in f),
                                                 causal=True, block_q=16, block_k=16)
    out, lse = flash.flash_fwd_reference(*f, 0.25, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=2e-5, rtol=2e-5)
    same, _ = flash.flash_fwd_reference(*f, 0.25, True, round_to=None)
    assert torch.equal(same, out)


def test_fp32_dq_reference_matches_jax_kernel(monkeypatch):
    """The fp32 plain dQ against the JAX package's Pallas ``_bwd_dq_kernel``
    (interpret mode) on the same q, k, v, dO, lse and delta, at the JAX
    package's 1e-4, causal with GQA and a ragged tail."""
    monkeypatch.setattr(_pallas, "INTERPRET", True)
    q, k, v, do = (x.float() for x in _inputs(10, torch.float32, 1, 40, 48, 4, 2, 16))
    scale = 0.25
    out, lse = flash.flash_fwd_reference(q, k, v, scale, True)
    jx = [jnp.asarray(x.numpy()) for x in (q, k, v, out, lse)]
    jdq, _, _ = jflash._flash_bwd(scale, True, 16, 16, tuple(jx), jnp.asarray(do.numpy()))
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    dq = flash.flash_bwd_dq_reference(q, k, v, do, lse, delta, scale, True)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), atol=1e-4, rtol=1e-4)
    assert torch.equal(flash.flash_bwd_dq_reference(q, k, v, do, lse, delta, scale, True,
                                                    round_to=None), dq)


def test_dispatch_rule_and_cpu_counts():
    """bf16 and fp16 take the tensor-core kernels, fp32 the CUDA-core ones;
    CPU tensors launch nothing and count nothing."""
    assert flash.uses_tensor_cores(torch.bfloat16) and flash.uses_tensor_cores(torch.float16)
    assert not flash.uses_tensor_cores(torch.float32)
    q, k, v, do = _inputs(7, torch.bfloat16, 1, 16, 16, 2, 2, 64)
    fns = (flash.flash_fwd, flash.flash_bwd_dkdv, flash.flash_bwd_dq)
    counts = [(fn.launches, fn.tc_launches) for fn in fns]
    out, lse = flash.flash_fwd(q, k, v, 0.125, True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    flash.flash_bwd_dkdv(q, k, v, do, lse, delta, 0.125, True)
    flash.flash_bwd_dq(q, k, v, do, lse, delta, 0.125, True)
    assert [(fn.launches, fn.tc_launches) for fn in fns] == counts

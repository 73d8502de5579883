"""The split-K paged decode, on the CPU.  On the card every chunk of fewer
than 16 tokens goes to ``paged_decode_kernel``: one block per (split of the
key range, kv head, block of rows, sequence) writes its partial ``(m, l,
acc)`` and a merge kernel combines a row's partials by their weights.  The
splits are sized on the host by ``paged.decode_split`` from shapes alone.
These tests emulate that split-and-merge with the same rule and the plain
merge (``paged.merge_decode_splits``) and hold it to the plain version at
1e-5 in fp32 on the edges a split can meet (a window across a split, a length
on a split boundary, lengths 0 and 1, head dims 32-256, blocks of 8-128 keys,
GQA groups of 1-64); show that the row limit the card's bf16/fp16 check uses
rejects a dropped split and an unweighted merge; check the dispatch rule of
the three routes; and hold the fp32 plain version to the JAX package's paged
attention (dense fallback and the Pallas kernel in interpret mode) on a
decode case."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import _pallas
from deepspeed_tpu.ops.attention.paged import _dense_fallback
from deepspeed_tpu.ops.attention.paged import paged_attention as jax_paged_attention
from deepspeed_tpu_torch.ops.attention import flash, paged

SMS = 132  # the H100's SM count, which the rule reads from the card
LOG2E = 1.4426950408889634


def _inputs(seed, N, T, H, KV, Dh, bs, lengths, n_tokens, alibi, context=None, dtype=None):
    """q, pools and int32 tables (padded slots point at the trash block); the
    tables are ``context`` keys wide when given."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    n_tokens = np.asarray(n_tokens, np.int32)
    need = [-(-int(n) // bs) for n in lengths]
    maxb = max(1, max(need), -(-(context or 0) // bs))
    nb = sum(need) + 1
    tables = np.full((N, maxb), nb - 1, np.int32)
    perm = rng.permutation(nb - 1)
    at = 0
    for i, k in enumerate(need):
        tables[i, :k] = perm[at:at + k]
        at += k
    x = {"q": rng.normal(size=(N, T, H, Dh)).astype(np.float32),
         "kpool": rng.normal(size=(nb, KV, bs, Dh)).astype(np.float32),
         "vpool": rng.normal(size=(nb, KV, bs, Dh)).astype(np.float32),
         "tables": tables, "lengths": lengths, "start_pos": lengths - n_tokens,
         "n_tokens": n_tokens,
         "slopes": (2.0**(-8.0 * (np.arange(H) + 1) / H)).astype(np.float32) if alibi else None}
    t = {k: torch.from_numpy(v) for k, v in x.items() if v is not None}
    if dtype is not None:
        for name in ("q", "kpool", "vpool"):
            t[name] = t[name].to(dtype)
    return x, t


def _args(t, window):
    return (t["q"], t["kpool"], t["vpool"], t["tables"], t["lengths"], t["start_pos"],
            t["n_tokens"], 1.0 / np.sqrt(t["q"].shape[-1]), window, t.get("slopes"))


def _split(t):
    """(keys a split, splits) by the wrapper's rule for these inputs."""
    n, T, H, Dh = t["q"].shape
    kv, bs = t["kpool"].shape[1], t["kpool"].shape[2]
    row_blocks = -(-(H // kv) * T // paged.decode_rows(Dh, H // kv * T))
    return paged.decode_split(t["tables"].shape[1] * bs, bs, n, kv, row_blocks, SMS)


def decode_partials(q, kpool, vpool, tables, lengths, start_pos, n_tokens, scale, window,
                    alibi_slopes, keys, splits):
    """The decode kernel's partials: for each split s, the keys [s * keys,
    (s + 1) * keys) that a row sees, their running max m (log2 units) and sum
    l of 2^(score - m), and acc = sum of 2^(score - m) v, in fp32; an empty
    split is (m = -1e30, l = 0, acc = 0).  [N, T, H, splits, 2] and [N, T,
    H, splits, D]."""
    n, t, hq, dh = q.shape
    kvh, bs = kpool.shape[1], kpool.shape[2]
    maxb = tables.shape[1]
    group = hq // kvh
    idx = tables.long()
    ctx_k = kpool[idx].transpose(2, 3).reshape(n, maxb * bs, kvh, dh).float()
    ctx_v = vpool[idx].transpose(2, 3).reshape(n, maxb * bs, kvh, dh).float()
    ctx_k, ctx_v = (x.repeat_interleave(group, 2) for x in (ctx_k, ctx_v))
    ar = torch.arange(t)
    qpos = (start_pos.long()[:, None] + ar[None, :])[:, None, :, None]  # [n, 1, t, 1]
    live = (ar[None, :] < n_tokens.long()[:, None])[:, None, :, None]
    kpos = torch.arange(maxb * bs)[None, None, None, :]
    vis = live & (kpos < lengths.long()[:, None, None, None]) & (kpos <= qpos)
    if window is not None:
        vis = vis & (kpos > qpos - window)
    s2 = torch.einsum("nthd,nkhd->nhtk", q.float(), ctx_k) * (scale * LOG2E)
    if alibi_slopes is not None:
        s2 = s2 + (alibi_slopes.float() * LOG2E)[None, :, None, None] * kpos.float()
    ml = torch.zeros(n, hq, t, splits, 2)
    acc = torch.zeros(n, hq, t, splits, dh)
    for s in range(splits):
        lo, hi = s * keys, min((s + 1) * keys, maxb * bs)
        v_s = vis[..., lo:hi]
        x = torch.where(v_s, s2[..., lo:hi], flash.NEG_INF)
        m = x.amax(-1, keepdim=True) if hi > lo else torch.full((n, hq, t, 1), flash.NEG_INF)
        p = torch.where(v_s, torch.exp2(x - m), 0.0)
        ml[..., s, 0] = m[..., 0]
        ml[..., s, 1] = p.sum(-1)
        acc[..., s, :] = torch.einsum("nhtk,nkhd->nhtd", p, ctx_v[:, lo:hi])
    return ml.permute(0, 2, 1, 3, 4), acc.permute(0, 2, 1, 3, 4)


def emulate_decode(*args, fault=None):
    """The split-and-merge the card runs, by the wrapper's split rule, in
    fp32.  ``fault``: ``"last_split_dropped"`` (each sequence's last split
    that holds a live key left out of the merge) or ``"unweighted_merge"``
    (partials summed without their 2^(m - max m) weights)."""
    t = dict(zip(("q", "kpool", "vpool", "tables", "lengths", "start_pos", "n_tokens"), args))
    keys, splits = _split(t)
    ml, acc = decode_partials(*args, keys, splits)
    n_tokens = args[6]
    if fault == "last_split_dropped":
        for n, length in enumerate(args[4].tolist()):
            if length > 0:
                last = (length - 1) // keys
                ml[n, :, :, last] = torch.tensor([flash.NEG_INF, 0.0])
                acc[n, :, :, last] = 0.0
    if fault == "unweighted_merge":
        den = ml[..., 1].sum(-1)[..., None]
        out = acc.sum(-2) / torch.where(den == 0, 1.0, den)
        live = torch.arange(ml.shape[1])[None, :] < n_tokens.long()[:, None]
        return torch.where(live[:, :, None, None], out, 0.0)
    return paged.merge_decode_splits(ml, acc, n_tokens)


def _case_with_split(name, N, H, KV, Dh, bs, window_after, alibi, T=1):
    """A decode case whose lengths sit on the split rule's edges: the table
    reaches 4096 keys; lengths 0, 1, one split exactly, one split + 1, two
    splits exactly and a long one; ``window_after`` keys of window (one that
    starts inside a split) when given."""
    probe = {"q": torch.zeros(N, T, H, Dh), "kpool": torch.zeros(1, KV, bs, Dh),
             "tables": torch.zeros(N, 4096 // bs, dtype=torch.int32)}
    keys, _ = _split(probe)
    base = [0, 1, keys, keys + 1, 2 * keys, min(4096, 3 * keys + 77)]
    lengths = (base * -(-N // len(base)))[:N]
    lengths[-1] = 4096
    n_tokens = [min(T, x) for x in lengths]
    return _inputs(len(name), N, T, H, KV, Dh, bs, lengths, n_tokens, alibi, context=4096), \
        window_after, keys


# (name, N, H, KV, Dh, bs, window, alibi, T): D 32-256, blocks 8-128, groups 1-64
EDGES = [
    ("mha_d128_bs16", 6, 4, 4, 128, 16, None, False, 1),
    ("gqa4_d128_bs16_window", 6, 8, 2, 128, 16, 150, False, 1),
    ("gqa8_d64_bs8_alibi", 7, 8, 1, 64, 8, None, True, 1),
    ("mqa32_d32_bs32_window", 6, 32, 1, 32, 32, 300, True, 1),
    ("mqa64_d64_bs64", 6, 64, 1, 64, 64, None, False, 1),
    ("gqa4_d256_bs128_window", 6, 8, 2, 256, 128, 700, False, 1),
    ("gqa4_d64_t5_bs16_window", 6, 8, 2, 64, 16, 90, True, 5),
]


@pytest.mark.parametrize("name,N,H,KV,Dh,bs,window,alibi,T", EDGES, ids=[e[0] for e in EDGES])
def test_split_and_merge_equals_the_plain_version(name, N, H, KV, Dh, bs, window, alibi, T):
    """The emulated split-K decode equals ``paged_attention_reference`` at
    1e-5 in fp32: it differs only in the order of summation.  With ALiBi the
    scores reach slope x key ~ 2048 at 4096 keys, where one fp32 ulp is
    2.4e-4: both sides round the scores (the kernel in log2 units), so the
    tolerance adds 4 ulps of the largest bias times max|v| (0 without ALiBi)."""
    (_, t), window, keys = _case_with_split(name, N, H, KV, Dh, bs, window, alibi, T)
    _, splits = _split(t)
    assert splits > 1 and keys % 64 == 0 and keys % bs == 0
    args = _args(t, window)
    ref = paged.paged_attention_reference(*args)
    got = emulate_decode(*args)
    bias_ulps = 0.0
    if alibi:
        bias = float(t["slopes"].max()) * float(t["lengths"].max())
        bias_ulps = 4 * bias * 2.0**-23 * float(t["vpool"].abs().max())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5 + bias_ulps, rtol=1e-5)
    assert bool((got[t["lengths"] == 0] == 0).all())


@pytest.mark.parametrize("context,bs,N,KV,row_blocks", [
    (4096, 16, 32, 32, 1), (4096, 16, 32, 8, 1), (4096, 16, 16, 8, 1), (256, 16, 1, 1, 1),
    (4096, 128, 3, 2, 4), (4096, 8, 1, 1, 1), (100, 8, 4, 2, 1), (8192, 64, 64, 8, 2)])
def test_split_rule(context, bs, N, KV, row_blocks):
    """Whole 64-key tiles and table slots, at least DECODE_MIN_SPLIT keys,
    the context covered, and DECODE_BLOCKS_PER_SM blocks an SM wherever the
    minimum split allows it."""
    keys, splits = paged.decode_split(context, bs, N, KV, row_blocks, SMS)
    assert keys % 64 == 0 and keys % bs == 0 and keys >= paged.DECODE_MIN_SPLIT
    assert splits * keys >= context and (splits - 1) * keys < max(context, 1)
    blocks = splits * N * KV * row_blocks
    assert blocks >= paged.DECODE_BLOCKS_PER_SM * SMS or keys <= max(paged.DECODE_MIN_SPLIT,
                                                                      bs)


def test_split_rule_at_the_main_path_shapes():
    """Mistral-7B decode (N=32, KV=8, a 4096-key table), Llama-2-7B decode
    (KV=32) and the serve's decode step (N=16): at least two waves of the
    four blocks an SM holds."""
    for n, kv in ((32, 8), (32, 32), (16, 8)):
        keys, splits = paged.decode_split(4096, 16, n, kv, 1, SMS)
        assert splits * n * kv >= 2 * 4 * SMS
    assert paged.decode_split(4096, 16, 32, 32, 1, SMS) == (1344, 4)
    assert paged.decode_split(4096, 16, 32, 8, 1, SMS) == (448, 10)
    assert paged.decode_split(4096, 16, 16, 8, 1, SMS) == (256, 16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("fault", ["last_split_dropped", "unweighted_merge"])
def test_limit_rejects_merge_faults(dtype, fault):
    """The card's bf16/fp16 decode check (``flash.tensor_core_limit`` row by
    row, ``rounded`` = the fp32 plain version: only the store's ulp) passes
    the emulated split-and-merge stored in the input type and rejects a
    dropped split and an unweighted merge."""
    (_, t), window, _ = _case_with_split("fault", 6, 8, 2, 128, 16, 150, False)
    t = {k: (v.to(dtype) if k in ("q", "kpool", "vpool") else v) for k, v in t.items()}
    f = dict(t, q=t["q"].float(), kpool=t["kpool"].float(), vpool=t["vpool"].float())
    ref = paged.paged_attention_reference(*_args(f, window))
    ok, _, ratio, _ = flash.tensor_core_limit(emulate_decode(*_args(t, window)).to(dtype), ref,
                                              ref)
    assert ok, f"{ratio:.3f} of the limit"
    bad = emulate_decode(*_args(t, window), fault=fault).to(dtype)
    ok, _, ratio, _ = flash.tensor_core_limit(bad, ref, ref)
    assert not ok, f"{fault} passed at {ratio:.3f} of the limit"


def test_merge_of_all_empty_splits_is_zero():
    """A row whose splits are all empty (l = 0, m = -1e30) and a row past
    n_tokens come out as zeros, as the plain version's l_safe gives."""
    ml = torch.tensor([flash.NEG_INF, 0.0]).expand(2, 2, 3, 4, 2).clone()
    acc = torch.zeros(2, 2, 3, 4, 8)
    ml[1, 0, :, 0] = torch.tensor([0.5, 2.0])
    acc[1, :, :, 0] = 1.0
    out = paged.merge_decode_splits(ml, acc, torch.tensor([2, 1], dtype=torch.int32))
    assert bool((out[0] == 0).all()) and bool((out[1, 1] == 0).all())
    assert torch.allclose(out[1, 0], torch.full((3, 8), 0.5))


def test_dispatch_rule_and_cpu_counts():
    """T < 16 takes the decode route for every dtype and head dim; bf16/fp16
    chunks of T >= 16 with head dim 64/128 and a group <= 64 the tensor-core
    prefill; the rest the CUDA-core kernel.  CPU calls count nothing."""
    route = paged.paged_route
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for dh in (32, 64, 128, 256):
            assert route(dtype, dh, 1, 4) == route(dtype, dh, 15, 64) == "decode"
            assert route(dtype, dh, 5, 128) == "decode"
    for dtype in (torch.bfloat16, torch.float16):
        assert route(dtype, 128, 16, 4) == route(dtype, 64, 512, 64) == "prefill_tc"
        assert route(dtype, 32, 16, 4) == route(dtype, 256, 64, 1) == "cuda_core"
        assert route(dtype, 128, 64, 128) == "cuda_core"
    assert route(torch.float32, 128, 512, 4) == "cuda_core"
    _, t = _inputs(3, 2, 1, 4, 2, 64, 16, [40, 16], [1, 1], False)
    fn = paged.paged_attention
    before = (fn.launches, fn.tc_launches, fn.decode_launches)
    fn(t["q"], t["kpool"], t["vpool"], t["tables"], t["lengths"], t["start_pos"], t["n_tokens"],
       block_size=16)
    assert (fn.launches, fn.tc_launches, fn.decode_launches) == before


def test_fp32_plain_version_matches_jax_on_a_decode_case():
    """A Mistral-shaped decode step (GQA 4, window, lengths 1-700 over a
    table of several slots): the fp32 plain version, and the emulated
    split-and-merge, against the JAX package's dense fallback and its Pallas
    kernel in interpret mode at 1e-5."""
    N, T, H, KV, Dh, bs, window = 4, 1, 8, 2, 64, 16, 300
    x, t = _inputs(21, N, T, H, KV, Dh, bs, [1, 17, 450, 700], [1, 1, 1, 1], False)
    got = paged.paged_attention(t["q"], t["kpool"], t["vpool"], t["tables"], t["lengths"],
                                t["start_pos"], t["n_tokens"], block_size=bs,
                                window=window).numpy()
    jx = {k: jnp.asarray(v) for k, v in x.items() if v is not None}
    ints = (jx["tables"], jx["lengths"], jx["start_pos"], jx["n_tokens"])
    dense = np.asarray(_dense_fallback(jx["q"], jx["kpool"], jx["vpool"], *ints,
                                       1.0 / np.sqrt(Dh), window))
    np.testing.assert_allclose(got, dense, atol=1e-5, rtol=0)
    old = _pallas.INTERPRET
    _pallas.INTERPRET = True
    try:
        kern = np.asarray(jax_paged_attention(jx["q"], jx["kpool"], jx["vpool"], *ints,
                                              block_size=bs, window=window))
    finally:
        _pallas.INTERPRET = old
    np.testing.assert_allclose(got, kern, atol=1e-5, rtol=0)
    np.testing.assert_allclose(emulate_decode(*_args(t, window)).numpy(), dense, atol=1e-5,
                               rtol=0)

"""The limit that holds the paged-attention kernels' bf16/fp16 results to
account, on the CPU: ``flash.tensor_core_limit`` taken row by row, a row being
one (sequence, token, q head) over the head dim.  The tensor-core prefill
kernel rounds P to the input type before ``P V``; its limit is twice the error
of the plain version that rounds P the same way (``paged_attention_reference(
..., round_to=)``) plus an ulp of the store.  These tests show that
``round_to=None`` leaves the plain version as it was, that the rounding
versions and a tile emulation of the prefill kernel pass the limit, that the
limit rejects the faults such a kernel could plausibly have, and that the fp32
plain version still equals the JAX package's paged attention (the Pallas
kernel in interpret mode and its dense fallback) on prefill-shaped cases,
and that the host geometry of the kernel's row blocks and key ranges covers
every row and key for any group."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import _pallas
from deepspeed_tpu.ops.attention.paged import _dense_fallback
from deepspeed_tpu.ops.attention.paged import paged_attention as jax_paged_attention
from deepspeed_tpu_torch.models.transformer import sdpa
from deepspeed_tpu_torch.ops.attention import flash, paged

DTYPES = [torch.bfloat16, torch.float16]
ALIBI = [0.5, 0.25, 0.125, 0.0625]

# (name, N, T, H, KV, Dh, bs, lengths, n_tokens, window, alibi): chunks that
# start off a key tile, GQA, MHA, a window, ALiBi, padding and zero-length
# rows, at every head dim the tensor-core kernel takes (D = 256 with its
# 32-key tiles) and a group of 128 (a token's heads over two row blocks)
CASES = [
    ("gqa_window_ragged_start", 2, 80, 4, 2, 64, 16, [200, 90], [80, 50], 64, False),
    ("mha_alibi_padding", 3, 32, 4, 4, 64, 8, [150, 32, 0], [32, 7, 0], None, True),
    ("mqa_window_alibi", 2, 16, 4, 1, 64, 32, [300, 16], [16, 16], 100, True),
    ("d256_gqa4_window_padding", 3, 16, 8, 2, 256, 16, [40, 300, 0], [16, 9, 0], 100, False),
    ("d32_mha_alibi_window", 3, 20, 4, 4, 32, 8, [20, 57, 300], [20, 11, 1], 30, True),
    ("mqa128_alibi_padding", 2, 16, 128, 1, 64, 16, [100, 16], [16, 7], None, True),
]


def _ids(cases):
    return [c[0] for c in cases]


def _inputs(seed, N, T, H, KV, Dh, bs, lengths, n_tokens, alibi, dtype=torch.float32):
    """q, pools and int32 tables from numpy; each sequence's blocks scattered
    over the pool, padded table slots pointing at the trash block."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    n_tokens = np.asarray(n_tokens, np.int32)
    need = [-(-int(n) // bs) for n in lengths]
    maxb = max(1, max(need))
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
         "slopes": np.asarray([ALIBI[h % 4] for h in range(H)], np.float32) if alibi else None}
    t = {k: torch.from_numpy(v) for k, v in x.items() if v is not None}
    for name in ("q", "kpool", "vpool"):
        t[name] = t[name].to(dtype)
    return x, t


def _args(t, Dh, window):
    return (t["q"], t["kpool"], t["vpool"], t["tables"], t["lengths"], t["start_pos"],
            t["n_tokens"], 1.0 / np.sqrt(Dh), window, t.get("slopes"))


def plain_before_round_to(q, kpool, vpool, tables, lengths, start_pos, n_tokens, scale, window,
                          alibi_slopes=None):
    """The plain version as it stood before ``round_to`` (gather, masked sdpa)."""
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
    out = sdpa(q.float(), ctx_k, ctx_v, causal=False, mask=mask[:, None, :, :],
               softmax_scale=scale, bias=bias)
    return torch.where((qp >= 0)[..., None], out, 0.0).to(q.dtype)


def emulate_prefill(q, kpool, vpool, tables, lengths, start_pos, n_tokens, scale, window,
                    alibi_slopes=None, fault=None):
    """The tensor-core prefill kernel's arithmetic, block by block: each
    (sequence, kv head)'s T x group rows cut into blocks of ``paged.TC_ROWS``
    (``paged.prefill_tc_blocks``), each block reading the keys of
    ``paged.prefill_tc_keys`` in tiles of ``paged.prefill_tc_key_tile(Dh)``
    through the block table (keys of a tile past the block's range come in
    as zeros and are masked); per row a running max, P relative to it rounded to the input type before
    ``P V``, l summing the fp32 P, the correction applied to l and the
    accumulator, masks by each row's own token and head; rows with l == 0
    and padding rows are zero.  ``fault``: ``"last_block_dropped"`` (the
    last 16 keys of every sequence unseen), ``"causal_off_by_one"`` (one key
    past the query seen), ``"window_off_by_one"`` (one key before the window
    seen), ``"alibi_dropped"``, ``"stale_max"`` (the accumulator not
    corrected when the max moves)."""
    n, t, hq, dh = q.shape
    kvh, bs = kpool.shape[1], kpool.shape[2]
    maxb = tables.shape[1]
    group = hq // kvh
    tile = paged.prefill_tc_key_tile(dh)
    reach = 1 if fault == "causal_off_by_one" else 0
    early = 1 if fault == "window_off_by_one" else 0
    idx = tables.long()
    ctx_k = kpool[idx].transpose(2, 3).reshape(n, maxb * bs, kvh, dh).float()
    ctx_v = vpool[idx].transpose(2, 3).reshape(n, maxb * bs, kvh, dh).float()
    out = torch.zeros(n, t, hq, dh)
    for i in range(n):
        length = int(lengths[i]) - (16 if fault == "last_block_dropped" else 0)
        keys = min(max(0, length), maxb * bs)
        start, live = int(start_pos[i]), min(t, int(n_tokens[i]))
        for g in range(kvh):
            for b in range(paged.prefill_tc_blocks(t, group)):
                begin, end = paged.prefill_tc_keys(b, t, group, start, keys, live, window)
                r = torch.arange(b * paged.TC_ROWS, min((b + 1) * paged.TC_ROWS, t * group))
                tok, head = r // group, g * group + r % group
                qpos = (start + tok)[:, None]
                qr = q[i, tok, head].float()
                m = torch.full((len(r), 1), flash.NEG_INF)
                l = torch.zeros(len(r), 1)
                acc = torch.zeros(len(r), dh)
                for k0 in range(begin // tile * tile, end, tile):
                    kpos = torch.arange(k0, k0 + tile)[None, :]
                    read = (kpos[0] < end)[:, None]  # keys past the range come in as zeros
                    kt = torch.where(read, ctx_k[i, kpos[0].clamp_max(keys - 1), g], 0.0)
                    vt = torch.where(read, ctx_v[i, kpos[0].clamp_max(keys - 1), g], 0.0)
                    vis = (tok < live)[:, None] & (kpos < keys) & (kpos <= qpos + reach)
                    if window is not None:
                        vis = vis & (kpos > qpos - window - early)
                    s = qr @ kt.T * scale
                    if alibi_slopes is not None and fault != "alibi_dropped":
                        s = s + alibi_slopes.float()[head][:, None] * kpos.float()
                    s = torch.where(vis, s, flash.NEG_INF)
                    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                    p = torch.where(vis, torch.exp(s - m_new), 0.0)
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(-1, keepdim=True)
                    acc = (acc * (1.0 if fault == "stale_max" else corr)
                           + p.to(q.dtype).float() @ vt)
                    m = m_new
                out[i, tok, head] = torch.where((l > 0) & (tok < live)[:, None],
                                                acc / torch.where(l > 0, l, 1.0), 0.0)
    return out.to(q.dtype)


def _limits(t, Dh, window, dtype):
    """(fp32 plain version, P-rounding plain version) on fp32 copies."""
    f = dict(t, q=t["q"].float(), kpool=t["kpool"].float(), vpool=t["vpool"].float())
    ref = paged.paged_attention_reference(*_args(f, Dh, window))
    rounded = paged.paged_attention_reference(*_args(f, Dh, window), round_to=dtype)
    return ref, rounded


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("name,N,T,H,KV,Dh,bs,lengths,n_tokens,window,alibi", CASES,
                         ids=_ids(CASES))
def test_round_to_none_is_the_plain_version_bit_for_bit(dtype, name, N, T, H, KV, Dh, bs, lengths,
                                                        n_tokens, window, alibi):
    _, t = _inputs(len(name), N, T, H, KV, Dh, bs, lengths, n_tokens, alibi, dtype)
    args = _args(t, Dh, window)
    got = paged.paged_attention_reference(*args)
    assert torch.equal(got, plain_before_round_to(*args))
    assert torch.equal(paged.paged_attention_reference(*args, round_to=None), got)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16"])
@pytest.mark.parametrize("name,N,T,H,KV,Dh,bs,lengths,n_tokens,window,alibi", CASES,
                         ids=_ids(CASES))
def test_rounding_versions_and_prefill_emulation_pass_the_limit(dtype, name, N, T, H, KV, Dh, bs,
                                                                lengths, n_tokens, window, alibi):
    """The P-rounding plain version stored in the input type and the tile
    emulation of the prefill kernel within the limit; both keep padding rows
    exact zeros."""
    _, t = _inputs(len(name) + 1, N, T, H, KV, Dh, bs, lengths, n_tokens, alibi, dtype)
    ref, rounded = _limits(t, Dh, window, dtype)
    args = _args(t, Dh, window)
    stored = paged.paged_attention_reference(*args, round_to=dtype)
    assert stored.dtype == dtype
    emulated = emulate_prefill(*args)
    pad = torch.arange(T)[None, :] >= t["n_tokens"].long()[:, None]
    for got in (stored, emulated):
        ok, _, ratio, _ = flash.tensor_core_limit(got, ref, rounded)
        assert ok, f"{ratio:.3f} of the limit"
        assert bool((got[pad] == 0).all())


FAULTS = ["last_block_dropped", "causal_off_by_one", "window_off_by_one", "alibi_dropped",
          "stale_max"]
# each with a window, ALiBi and rows that see several key tiles, so that
# every fault shows: GQA at head dim 64, head dim 256 (32-key tiles), head
# dim 32, a group of 128
FAULT_CASES = [
    ("fault", 2, 80, 4, 2, 64, 16, [200, 90], [80, 50], 64, True),
    ("fault_d256", 3, 16, 8, 2, 256, 16, [40, 300, 0], [16, 9, 0], 30, True),
    ("fault_d32", 3, 20, 4, 4, 32, 8, [20, 150, 300], [20, 11, 1], 30, True),
    ("fault_mqa128", 2, 16, 128, 1, 64, 16, [100, 40], [16, 7], 30, True),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16"])
@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("case", FAULT_CASES, ids=_ids(FAULT_CASES))
def test_limit_rejects_prefill_faults(dtype, fault, case):
    name, N, T, H, KV, Dh, bs, lengths, n_tokens, window, alibi = case
    _, t = _inputs(11 + FAULT_CASES.index(case), N, T, H, KV, Dh, bs, lengths, n_tokens, alibi,
                   dtype)
    ref, rounded = _limits(t, Dh, window, dtype)
    args = _args(t, Dh, window)
    assert flash.tensor_core_limit(emulate_prefill(*args), ref, rounded)[0]
    ok, _, ratio, _ = flash.tensor_core_limit(emulate_prefill(*args, fault=fault), ref, rounded)
    assert not ok, f"{fault} passed at {ratio:.3f} of the limit"


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16"])
def test_decode_limit_is_the_store_and_rejects_a_dropped_block(dtype):
    """The CUDA-core decode kernel rounds nothing but its store: with
    ``rounded`` the fp32 plain version the limit is an ulp of the row's
    largest value, which the plain version stored in the input type meets
    and a dropped last block of 16 keys does not."""
    _, t = _inputs(12, 4, 1, 8, 2, 128, 16, [1, 300, 2000, 4096], [1, 1, 1, 1], False, dtype)
    f = dict(t, q=t["q"].float(), kpool=t["kpool"].float(), vpool=t["vpool"].float())
    ref = paged.paged_attention_reference(*_args(f, 128, None))
    stored = paged.paged_attention_reference(*_args(t, 128, None))
    assert flash.tensor_core_limit(stored, ref, ref)[0]
    dropped = paged.paged_attention_reference(*_args(dict(t, lengths=(t["lengths"] - 16)
                                                          .clamp_min(0)), 128, None))
    assert not flash.tensor_core_limit(dropped, ref, ref)[0]


# small enough for the JAX kernel's interpret mode (a grid of N x H x table
# slots): CASES[0], head dim 256 and a group of 128
JAX_CASES = [
    CASES[0],
    ("d256_gqa4_window", 2, 16, 8, 2, 256, 16, [40, 100], [16, 9], 50, False),
    ("mqa128_window", 1, 16, 128, 1, 64, 32, [40], [16], 20, False),
]


@pytest.mark.parametrize("case", JAX_CASES, ids=_ids(JAX_CASES))
def test_fp32_plain_version_matches_jax_on_a_prefill_case(case):
    """Several key tiles, GQA, a window and a chunk that starts off a tile;
    head dim 256; a group of 128: the fp32 plain version against the JAX
    package's Pallas kernel (interpret mode) and dense fallback at 2e-5, as
    tests/test_torch_paged_attention.py does at decode sizes."""
    name, N, T, H, KV, Dh, bs, lengths, n_tokens, window, _ = case
    x, t = _inputs(13, N, T, H, KV, Dh, bs, lengths, n_tokens, False)
    got = paged.paged_attention(t["q"], t["kpool"], t["vpool"], t["tables"], t["lengths"],
                                t["start_pos"], t["n_tokens"], block_size=bs,
                                window=window).numpy()
    jx = {k: jnp.asarray(v) for k, v in x.items() if v is not None}
    ints = (jx["tables"], jx["lengths"], jx["start_pos"], jx["n_tokens"])
    dense = np.asarray(_dense_fallback(jx["q"], jx["kpool"], jx["vpool"], *ints,
                                       1.0 / np.sqrt(Dh), window))
    np.testing.assert_allclose(got, dense, atol=2e-5, rtol=0)
    old = _pallas.INTERPRET
    _pallas.INTERPRET = True
    try:
        kern = np.asarray(jax_paged_attention(jx["q"], jx["kpool"], jx["vpool"], *ints,
                                              block_size=bs, window=window))
    finally:
        _pallas.INTERPRET = old
    np.testing.assert_allclose(got, kern, atol=2e-5, rtol=0)


def test_dispatch_rule_and_cpu_counts():
    """bf16/fp16 chunks of 16 or more tokens take the tensor-core prefill
    kernel at every head dim and group (the rule reads neither); decode and
    fp32 chunks do not.  CPU tensors launch nothing and count nothing."""
    rule = paged.uses_prefill_tensor_cores
    for dtype in DTYPES:
        assert rule(dtype, 16) and rule(dtype, 512)
        assert not (rule(dtype, 15) or rule(dtype, 1))
    assert not (rule(torch.float32, 512) or rule(torch.float32, 16))
    _, t = _inputs(14, 2, 16, 4, 2, 64, 16, [40, 16], [16, 16], False, torch.bfloat16)
    before = (paged.paged_attention.launches, paged.paged_attention.tc_launches)
    paged.paged_attention(t["q"], t["kpool"], t["vpool"], t["tables"], t["lengths"],
                          t["start_pos"], t["n_tokens"], block_size=16)
    assert (paged.paged_attention.launches, paged.paged_attention.tc_launches) == before


def _old_tiling(t, group, start, keys, n_tokens, window):
    """The tensor-core kernel's blocks before any group was taken (groups
    dividing 64 only): block b held tokens [b q_tile, (b + 1) q_tile), q_tile
    = 64 / group, and read keys from the window start of its first token to
    the causal end of its last live one; (first token, last token, begin,
    end) a block."""
    q_tile = paged.TC_ROWS // group
    out = []
    for b in range(-(-t // q_tile)):
        t0 = b * q_tile
        t_hi = min(t0 + q_tile, min(t, n_tokens))
        begin = end = 0
        if t_hi > t0:
            end = min(keys, start + t_hi)
            begin = max(0, start + t0 - window + 1) if window else 0
        out.append((t0, min(t0 + q_tile, t) - 1, begin, end))
    return out


@pytest.mark.parametrize("group", [1, 4, 7, 64, 128])
def test_prefill_row_blocks_and_key_ranges(group):
    """The tensor-core prefill kernel's host geometry at T = 16, 64 and 512:
    every row of the T x group row space lies in one block of 64 (the last
    short); each block's key range starts at its first row's window start
    and ends at its last live row's causal end, so it holds every key any of
    its live rows sees, and is (0, 0) for a block with no live row.  For
    groups that divide 64 the blocks and ranges equal the old tiling of
    64 / group whole tokens a block."""
    for t in (16, 64, 512):
        blocks = paged.prefill_tc_blocks(t, group)
        assert (blocks - 1) * paged.TC_ROWS < t * group <= blocks * paged.TC_ROWS
        # (start, keys, live tokens, window): a whole chunk, a ragged one
        # with a window, a decode row padded into the chunk, an empty one
        for start, keys, live, window in ((0, t, t, None), (100, 100 + t - 3, t - 3, 50),
                                          (36, 37, 1, 20), (0, 0, 0, None)):
            ranges = [paged.prefill_tc_keys(b, t, group, start, keys, live, window)
                      for b in range(blocks)]
            for b, (begin, end) in enumerate(ranges):
                rows = range(b * paged.TC_ROWS, min((b + 1) * paged.TC_ROWS, t * group))
                toks = sorted({r // group for r in rows if r // group < live})
                if not toks:
                    assert (begin, end) == (0, 0)
                    continue
                for tok in toks:  # the keys the row's token sees lie in the range
                    lo = max(0, start + tok - window + 1) if window else 0
                    assert begin <= lo and min(keys, start + tok + 1) <= end
                assert begin == (max(0, start + toks[0] - window + 1) if window else 0)
                assert end == min(keys, start + toks[-1] + 1)
            if paged.TC_ROWS % group == 0:
                old = _old_tiling(t, group, start, keys, live, window)
                assert len(old) == blocks
                for b, (t0, t1, begin, end) in enumerate(old):
                    assert (t0, t1) == (b * paged.TC_ROWS // group,
                                        (min((b + 1) * paged.TC_ROWS, t * group) - 1) // group)
                    assert (begin, end) == ranges[b]

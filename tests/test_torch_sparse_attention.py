"""The port's block-sparse attention on the CPU against the JAX package, on
the same numpy inputs: the six layout generators (bit-identical layouts), the
forward output and logsumexp of the plain versions against the JAX Pallas
kernel run in interpret mode (atol=rtol=2e-5) and the gradients through it
(1e-4), the JAX package's own kernel-vs-dense limits; the routing of
``sparse_attention`` and ``make_config_attention_fn``; and the tables the
CUDA kernels walk, emulated here: every live (query, key) pair is visited
exactly once, at every block size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import _pallas
from deepspeed_tpu.ops.sparse_attention import attention as jattn
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu.runtime.config import SparseAttentionConfig as JSparseAttentionConfig
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.ops.sparse_attention import attention
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc
from deepspeed_tpu_torch.runtime.config import SparseAttentionConfig

FWD_TOL = 2e-5
GRAD_TOL = 1e-4

UNI, BI = "unidirectional", "bidirectional"
# (class name, constructor kwargs, seq_len)
LAYOUTS = [
    ("DenseSparsityConfig", dict(num_heads=2, block=16), 64),
    ("DenseSparsityConfig", dict(num_heads=3, block=8, different_layout_per_head=True), 48),
    ("FixedSparsityConfig", dict(num_heads=4, block=16, num_local_blocks=4, num_global_blocks=1,
                                 attention=UNI), 256),
    ("FixedSparsityConfig", dict(num_heads=4, block=16, different_layout_per_head=True,
                                 num_local_blocks=4, num_global_blocks=1, attention=UNI,
                                 num_different_global_patterns=4), 256),
    ("FixedSparsityConfig", dict(num_heads=2, block=16, num_local_blocks=4, num_global_blocks=2,
                                 attention=BI, horizontal_global_attention=True), 192),
    ("FixedSparsityConfig", dict(num_heads=4, block=32, different_layout_per_head=True,
                                 num_local_blocks=2, num_global_blocks=1, attention=BI,
                                 num_different_global_patterns=2), 256),
    ("VariableSparsityConfig", dict(num_heads=2, block=16, num_random_blocks=2,
                                    local_window_blocks=[1, 2], global_block_indices=[0],
                                    attention=BI, seed=7), 160),
    ("VariableSparsityConfig", dict(num_heads=3, block=16, different_layout_per_head=True,
                                    num_random_blocks=1, local_window_blocks=[2, 3],
                                    global_block_indices=[1, 5], global_block_end_indices=[2, 7],
                                    attention=UNI, horizontal_global_attention=False, seed=3),
     192),
    ("BigBirdSparsityConfig", dict(num_heads=2, block=16, num_random_blocks=2,
                                   num_sliding_window_blocks=3, num_global_blocks=1,
                                   attention=BI, seed=11), 160),
    ("BigBirdSparsityConfig", dict(num_heads=4, block=16, different_layout_per_head=True,
                                   num_random_blocks=1, num_sliding_window_blocks=3,
                                   num_global_blocks=2, attention=UNI, seed=5), 128),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=16, num_sliding_window_blocks=3,
                                        global_block_indices=[0, 2],
                                        global_block_end_indices=[1, 4], attention=BI), 128),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=16, different_layout_per_head=True,
                                        num_sliding_window_blocks=5, attention=UNI), 160),
    ("LocalSlidingWindowSparsityConfig", dict(num_heads=2, block=16,
                                              num_sliding_window_blocks=3, attention=UNI), 128),
    ("LocalSlidingWindowSparsityConfig", dict(num_heads=2, block=8, num_sliding_window_blocks=4,
                                              attention=BI), 96),
]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(_pallas, "INTERPRET", True)


@pytest.mark.parametrize("name,kw,seq", LAYOUTS,
                         ids=[f"{n.replace('SparsityConfig', '')}-{i}"
                              for i, (n, _, _) in enumerate(LAYOUTS)])
def test_layouts_equal_jax(name, kw, seq):
    got = getattr(sc, name)(**kw).make_layout(seq)
    ref = getattr(jsc, name)(**kw).make_layout(seq)
    assert got.dtype == np.asarray(ref).dtype
    assert np.array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("mode", ["dense", "fixed", "variable", "bigbird", "bslongformer",
                                  "local"])
def test_config_section_builds_the_jax_layout(mode):
    kw = dict(mode=mode, block=16, different_layout_per_head=True, num_random_blocks=2, seed=9)
    got = SparseAttentionConfig(**kw).build(4).make_layout(128)
    assert np.array_equal(got, np.asarray(JSparseAttentionConfig(**kw).build(4).make_layout(128)))
    with pytest.raises(ValueError, match="multiple of 8"):
        SparseAttentionConfig(mode=mode, block=20)


def _inputs(seed, B, S, H, KV, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))


# (name, sparsity config, seq, B, H, KV, D, causal)
CASES = [
    ("fixed_causal", sc.FixedSparsityConfig(num_heads=4, block=16, num_local_blocks=2,
                                            num_global_blocks=1, attention=UNI), 64, 2, 4, 4, 16,
     True),
    ("fixed_noncausal", sc.FixedSparsityConfig(num_heads=4, block=16, num_local_blocks=2,
                                               num_global_blocks=1, attention=BI), 64, 1, 4, 4,
     16, False),
    ("bigbird_gqa", sc.BigBirdSparsityConfig(num_heads=4, block=16, num_random_blocks=1,
                                             num_sliding_window_blocks=3, num_global_blocks=1),
     80, 1, 4, 2, 16, False),
    ("longformer_unpadded_s", sc.BSLongformerSparsityConfig(num_heads=2, block=16), 53, 1, 2, 2,
     16, True),
]


def _layout(cfg, s):
    return cfg.make_layout(-(-s // cfg.block) * cfg.block)


@pytest.mark.parametrize("name,cfg,S,B,H,KV,D,causal", CASES, ids=[c[0] for c in CASES])
def test_forward_and_lse_match_jax_kernel(name, cfg, S, B, H, KV, D, causal):
    q, k, v = _inputs(len(name), B, S, H, KV, D)
    layout = _layout(cfg, S)
    scale = 1.0 / np.sqrt(D)
    jout, jlse = jattn._sparse_fwd(*(jnp.asarray(x) for x in (q, k, v)),
                                   jattn._get_tables(layout, H), scale, causal, cfg.block)
    tables = attention._get_tables(layout, H, cfg.block, KV)
    launches = attention.sparse_fwd.launches
    out, lse = attention.sparse_fwd(*(torch.from_numpy(x) for x in (q, k, v)), tables, scale,
                                    causal)
    assert attention.sparse_fwd.launches == launches  # the CPU path never launches
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=FWD_TOL, rtol=FWD_TOL)
    got = attention.sparse_attention(*(torch.from_numpy(x) for x in (q, k, v)), layout, cfg.block,
                                     causal=causal)
    np.testing.assert_array_equal(got.numpy(), out.numpy())


@pytest.mark.parametrize("name,cfg,S,B,H,KV,D,causal", CASES, ids=[c[0] for c in CASES])
def test_grads_match_jax_kernel(name, cfg, S, B, H, KV, D, causal):
    q, k, v = _inputs(100 + len(name), B, S, H, KV, D)
    layout = _layout(cfg, S)

    def jloss(q, k, v):
        return jnp.sum(jattn.sparse_attention(q, k, v, layout, cfg.block, causal=causal)**2)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    counts = (attention.sparse_bwd_dkdv.launches, attention.sparse_bwd_dq.launches)
    attention.sparse_attention(tq, tk, tv, layout, cfg.block, causal=causal).pow(2).sum().backward()
    assert (attention.sparse_bwd_dkdv.launches, attention.sparse_bwd_dq.launches) == counts
    for got, ref, which in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{which}")


def test_plain_backward_matches_autograd_of_sdpa():
    """The backward plain versions (which hold the CUDA kernels to account on
    the card) against torch autograd through sdpa with the layout's element
    mask, GQA and causal, with a padded tail."""
    cfg = sc.BigBirdSparsityConfig(num_heads=4, block=8, num_random_blocks=1, seed=2)
    S, D = 45, 8
    layout = _layout(cfg, S)
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _inputs(3, 2, S, 4, 2, D))
    do = torch.from_numpy(np.random.default_rng(4).normal(size=(2, S, 4, D)).astype(np.float32))
    mask = attention._layout_element_mask(layout, 8, S, 4)
    tf.sdpa(q, k, v, causal=True, mask=mask).backward(do)
    tables = attention._get_tables(layout, 4, 8, 2)
    scale = 1.0 / np.sqrt(D)
    out, lse = attention.sparse_fwd_reference(q.detach(), k.detach(), v.detach(), tables, scale,
                                              True)
    delta = (do * out).sum(-1).transpose(1, 2)
    args = (q.detach(), k.detach(), v.detach(), do, lse, delta, tables, scale, True)
    dk, dv = attention.sparse_bwd_dkdv_reference(*args)
    dq = attention.sparse_bwd_dq_reference(*args)
    for got, want in ((dq, q.grad), (dk, k.grad), (dv, v.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FWD_TOL, rtol=FWD_TOL)


def test_routing_and_refusals():
    cfg = sc.FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=2, attention=UNI)
    layout = cfg.make_layout(32)
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, 1, 32, 2, 2, 8))
    mask = torch.from_numpy(np.random.default_rng(6).random((1, 1, 32, 32)) > 0.3)
    mask[..., 0] = True
    counts = attention.sparse_fwd.launches
    got = attention.sparse_attention(q, k, v, layout, 16, causal=True, mask=mask)
    want = tf.sdpa(q, k, v, causal=True,
                   mask=attention._layout_element_mask(layout, 16, 32, 2) & mask)
    torch.testing.assert_close(got, want)
    assert attention.sparse_fwd.launches == counts
    with pytest.raises(NotImplementedError, match="self-attention"):
        attention.sparse_attention(q[:, :16], k, v, layout, 16)
    with pytest.raises(ValueError, match="covers 32 positions"):
        attention.sparse_attention(*(torch.cat([x, x], 1) for x in (q, k, v)), layout, 16)


def test_config_attention_fn_takes_the_dense_default_off_the_block_grid():
    section = SparseAttentionConfig(mode="fixed", block=16, num_local_blocks=2, attention=UNI)
    fn = attention.make_config_attention_fn(section)
    q, k, v = (torch.from_numpy(x) for x in _inputs(7, 1, 40, 2, 1, 8))
    torch.testing.assert_close(fn(q, k, v, causal=True), tf.sdpa(q, k, v, causal=True))
    q, k, v = (x[:, :32] for x in (q, k, v))
    layout = section.build(2).make_layout(32)
    torch.testing.assert_close(fn(q, k, v, causal=True),
                               attention.sparse_attention(q, k, v, layout, 16, causal=True))
    torch.testing.assert_close(fn(q[:, :8], k, v, causal=True),
                               tf.sdpa(q[:, :8], k, v, causal=True))  # sq != sk: dense
    master = sc.FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=2, attention=UNI)
    torch.testing.assert_close(attention.make_sparse_attention_fn(master, 64)(q, k, v),
                               attention.sparse_attention(q, k, v, master.make_layout(64)[:, :2,
                                                                                          :2],
                                                          16, causal=True))


def test_pad_to_block_size_matches_jax():
    ids = np.arange(10, dtype=np.int32).reshape(2, 5)
    got, pad = attention.pad_to_block_size(8, torch.from_numpy(ids), pad_token_id=-1)
    ref, jpad = jattn.pad_to_block_size(8, jnp.asarray(ids), pad_token_id=-1)
    assert pad == jpad == 3
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    same, zero = attention.pad_to_block_size(5, torch.from_numpy(ids))
    assert zero == 0 and same.shape == (2, 5)


def test_tables_match_jax_and_stay_cached():
    cfg = sc.BigBirdSparsityConfig(num_heads=3, block=16, different_layout_per_head=True, seed=4)
    layout = cfg.make_layout(128)
    jt = jattn._Tables(layout, 3)
    tables = attention._get_tables(layout, 3, 16, 3)
    for name in ("kvmap", "cnt", "qmap", "cnt_t"):
        np.testing.assert_array_equal(getattr(tables, name), getattr(jt, name), err_msg=name)
    assert attention._get_tables(layout, 3, 16, 3) is tables
    assert tables.on("cpu") is tables.on("cpu")  # uploaded once per device


# ------------------------------------------------------------------ kernel walk
def _walk_counts(tables, s, causal):
    """How often the CUDA kernels' loops (csrc/sparse_attention.cu) visit each
    (head, query, key) pair, forward and dK/dV: the dQ kernel walks the
    forward's tables."""
    tile = attention.TILE
    bs, nb, H = tables.block, tables.layout.shape[1], tables.n_heads
    group = H // tables.n_kv_heads
    live = tables.layout.astype(bool)

    def positions(order, n, f0):
        return attention.tile_positions(order[:n], bs, s, f0 // tile)

    def visit(counts, h, qp, kp):
        qa, ka = np.meshgrid(qp, kp, indexing="ij")
        ok = (qa >= 0) & (ka >= 0)
        ok[ok] &= live[h, qa[ok] // bs, ka[ok] // bs] & ((not causal) | (ka[ok] <= qa[ok]))
        np.add.at(counts, (h, qa[ok], ka[ok]), 1)

    fwd, bwd = np.zeros((H, s, s), int), np.zeros((H, s, s), int)
    for h in range(H):
        for t in range(tables.n_tiles):
            qp = positions(tables.q_order[h], nb, t * tile)
            n, walk = tables.k_cnt[h, t], tables.k_walk[h, t]
            for f0 in range(0, n * bs, tile):
                if causal and walk[f0 // bs] * bs + f0 % bs > qp.max():
                    break
                visit(fwd, h, qp, positions(walk, n, f0))
    for g in range(tables.n_kv_heads):
        for t in range(tables.n_tiles):
            kp = positions(tables.k_order[g], nb, t * tile)
            kmin = kp[kp >= 0].min() if (kp >= 0).any() else s
            for h in range(g * group, (g + 1) * group):
                n, walk = tables.q_cnt[h, t], tables.q_walk[h, t]
                for f0 in range(0, n * bs, tile):
                    last = min(f0 + tile, n * bs) - 1
                    if causal and walk[last // bs] * bs + last % bs < kmin:
                        continue
                    visit(bwd, h, positions(walk, n, f0), kp)
    return fwd, bwd


WALKS = [
    ("fixed_b16", sc.FixedSparsityConfig(4, 16, True, 4, 1, UNI, False, 4), 256, True, 4),
    ("bigbird_b24_tail", sc.BigBirdSparsityConfig(4, 24, True, 1, 3, 1, BI), 163, False, 2),
    ("fixed_b8", sc.FixedSparsityConfig(2, 8, False, 4, 1, BI, False, 1), 120, True, 1),
    ("fixed_b128_tail", sc.FixedSparsityConfig(2, 128, False, 2, 1, BI, False, 1), 300, True, 2),
    ("fixed_b40_noncausal", sc.FixedSparsityConfig(2, 40, False, 2, 1, BI), 200, False, 2),
    ("longformer_b64", sc.BSLongformerSparsityConfig(2, 64, True, 3, [0], None, UNI), 256, True,
     1),
]


@pytest.mark.parametrize("name,cfg,S,causal,KV", WALKS, ids=[w[0] for w in WALKS])
def test_kernel_walk_visits_every_live_pair_once(name, cfg, S, causal, KV):
    layout = _layout(cfg, S)
    tables = attention._get_tables(layout, cfg.num_heads, cfg.block, KV)
    want = tables.element_mask(S, causal, "cpu").numpy().astype(int)
    fwd, bwd = _walk_counts(tables, S, causal)
    np.testing.assert_array_equal(fwd, want)
    np.testing.assert_array_equal(bwd, want)
    assert attention.live_pairs(layout, cfg.block, S, causal, cfg.num_heads) == want.sum()

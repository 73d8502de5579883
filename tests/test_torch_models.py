"""The port's model code on the CPU against the JAX package, on the same numpy
inputs and weights (carried by ``params_from_jax``): the transformer blocks,
and ``forward_paged`` of Llama and Mistral over a prefill chunk and two
decode steps.  fp32; the JAX side runs its off-TPU paths (the dense-gather
attention fallback)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import mistral as jmistral
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.models import llama, mistral
from deepspeed_tpu_torch.models import transformer as tf

ATOL = RTOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64, )).astype(np.float32)
    ref = np.asarray(jtf.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = tf.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


def test_apply_rotary_with_positions_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 4, 2, 16)).astype(np.float32)
    pos = rng.integers(0, 64, (3, 4)).astype(np.int32)
    cos, sin = tf.rotary_tables(16, 64, 10000.0)
    jcos, jsin = jtf.rotary_tables(16, 64, 10000.0)
    np.testing.assert_array_equal(cos, jcos)
    ref = np.asarray(jtf.apply_rotary(jnp.asarray(x), jcos, jsin, jnp.asarray(pos)))
    got = tf.apply_rotary(torch.from_numpy(x), cos, sin, torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    ref0 = np.asarray(jtf.apply_rotary(jnp.asarray(x), jcos, jsin))
    got0 = tf.apply_rotary(torch.from_numpy(x), cos, sin).numpy()
    np.testing.assert_allclose(got0, ref0, atol=1e-6, rtol=1e-6)


def test_swiglu_mlp_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    p = {k: (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)
         for k, shape in (("w_gate", (32, 64)), ("w_up", (32, 64)), ("w_down", (64, 32)))}
    ref = np.asarray(jtf.swiglu_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    got = tf.swiglu_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_paged_chunk_indices_match_jax():
    tokens = np.zeros((3, 4), np.int32)
    n_tokens = np.asarray([4, 1, 0], np.int32)
    start_pos = np.asarray([2, 9, 0], np.int32)
    tables = np.asarray([[3, 5, 15, 15], [1, 2, 4, 15], [15, 15, 15, 15]], np.int32)
    ref = jtf.paged_chunk_indices(*(jnp.asarray(a) for a in (tokens, n_tokens, start_pos,
                                                              tables)), 16, 4)
    got = tf.paged_chunk_indices(*(torch.from_numpy(a) for a in (tokens, n_tokens, start_pos,
                                                                  tables)), 16, 4)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _run_steps(jmod, mod, jcfg, cfg, prompts, *, block_size=4, num_blocks=24, maxb=6):
    """A prefill chunk (with a zero-length padding row, as the engine's pow2
    bucketing makes) then two greedy decode steps through both packages;
    returns the largest logit and KV differences seen."""
    jparams = jmod.init_params(jcfg, jax.random.PRNGKey(3))
    params = mod.params_from_jax(cfg, _np_tree(jparams), "cpu")
    jkv = jmod.init_paged_cache(jcfg, num_blocks, block_size, dtype=jnp.float32)
    kv = mod.init_paged_cache(cfg, num_blocks, block_size, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    trash = num_blocks - 1
    perm = rng.permutation(trash)
    n = len(prompts) + 1
    tables = np.full((n, maxb), trash, np.int32)
    for i in range(len(prompts)):
        tables[i] = perm[i * maxb:(i + 1) * maxb]
    t = max(len(p) for p in prompts)
    tokens = np.zeros((n, t), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    n_tokens = np.asarray([len(p) for p in prompts] + [0], np.int32)
    start = np.zeros(n, np.int32)
    for _ in range(3):
        args = (tokens, n_tokens, start, tables)
        jlogits, jkv = jmod.forward_paged(jcfg, jparams, *(jnp.asarray(a) for a in args), jkv,
                                          block_size=block_size)
        logits, kv = mod.forward_paged(cfg, params, *(torch.from_numpy(a) for a in args), kv,
                                       block_size=block_size)
        valid = np.arange(tokens.shape[1])[None, :] < n_tokens[:, None]
        np.testing.assert_allclose(logits.numpy()[valid], np.asarray(jlogits)[valid],
                                   atol=ATOL, rtol=RTOL)
        # every block but the trash block, which takes the padded tokens'
        # colliding writes in an order neither framework defines
        for name in ("k", "v"):
            np.testing.assert_allclose(kv[name].numpy()[:, :trash],
                                       np.asarray(jkv[name])[:, :trash], atol=ATOL, rtol=RTOL)
        last = np.maximum(n_tokens - 1, 0)
        picks = np.asarray(jlogits)[np.arange(n), last].argmax(-1).astype(np.int32)
        start = start + n_tokens
        tokens = picks[:, None]
        n_tokens = np.asarray([1] * len(prompts) + [0], np.int32)


def test_llama_forward_paged_matches_jax():
    jcfg = jllama.LlamaConfig.tiny(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, seq=64)
    cfg = llama.LlamaConfig.tiny(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, seq=64)
    _run_steps(jllama, llama, jcfg, cfg, [[5, 9, 2, 7, 1, 3, 8], [11, 4, 6]])


def test_mistral_forward_paged_windowed_matches_jax():
    jcfg = jmistral.MistralConfig.tiny(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2,
                                       seq=64, window=8)
    cfg = mistral.MistralConfig.tiny(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2,
                                     seq=64, window=8)
    _run_steps(jmistral, mistral, jcfg, cfg,
               [list(range(20, 33)), [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]])


def test_params_from_jax_keeps_layouts_and_counts():
    jcfg = jllama.LlamaConfig.tiny(vocab=96, hidden=64, layers=3, heads=4, kv_heads=2, seq=64)
    cfg = llama.LlamaConfig.tiny(vocab=96, hidden=64, layers=3, heads=4, kv_heads=2, seq=64)
    jparams = _np_tree(jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    params = llama.params_from_jax(cfg, jparams, "cpu")
    assert params["layers"]["attn"]["wk"].shape == (3, 64, 32)  # stacked [L, in, out]
    np.testing.assert_array_equal(params["layers"]["mlp"]["w_up"].numpy(),
                                  jparams["layers"]["mlp"]["w_up"])
    total = sum(v.numel() for v in jax.tree_util.tree_leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert total == llama.num_params(cfg) == jllama.num_params(jcfg)
    g = torch.Generator().manual_seed(0)
    own = llama.init_params(cfg, g)
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda x: 0, own)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda x: 0, jparams))
    with pytest.raises(KeyError, match="lm_head"):
        llama.params_from_jax(cfg, {k: v for k, v in jparams.items() if k != "lm_head"}, "cpu")


def test_kv_from_jax_roundtrip():
    jcfg = jllama.LlamaConfig.tiny(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, seq=64)
    jkv = jllama.init_paged_cache(jcfg, 8, 4, dtype=jnp.float32)
    jkv = {k: v + jnp.arange(v.size, dtype=jnp.float32).reshape(v.shape) for k, v in jkv.items()}
    kv = llama.kv_from_jax(_np_tree(jkv), "cpu")
    assert kv["k"].shape == (2, 8, 2, 4, 16)  # [L, NB, KV, bs, Dh]
    np.testing.assert_array_equal(kv["v"].numpy(), np.asarray(jkv["v"]))

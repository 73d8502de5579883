"""Checks that hold one model family of the port against the JAX package on
the CPU, shared by the ``tests/test_torch_<family>.py`` files.

Weights are drawn by the JAX ``init_params`` and then every leaf is moved by
seeded noise (so zero biases, unit norms and zero-initialised heads carry
information), carried across by the port's ``params_from_jax``; inputs are
seeded numpy.  The JAX side runs its off-TPU paths: the dense sdpa and the
dense-gather paged attention, each under ``jax.jit`` (an eager
``lax.scan`` dispatch costs seconds a call here).  fp32 throughout, atol =
rtol = 1e-4; HF parity at the 2e-3 of
``tests/unit/test_model_families.py::_hf_parity``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu_torch.inference.v2 import build_engine, build_hf_engine
from deepspeed_tpu_torch.runtime.tree import tree_leaves, tree_map

ATOL = RTOL = 1e-4
HF_TOL = 2e-3
JAX_REFERENCE_LOOP = {"dtype": "float32", "serving_fastpath": {"enabled": False},
                      "serving_prefix_cache": {"enabled": False}}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def pair_params(jmod, mod, jcfg, cfg, seed=0, noise=0.05):
    """(JAX params, the port's params) with the same values."""
    jparams = jmod.init_params(jcfg, jax.random.PRNGKey(seed))
    leaves, treedef = jax.tree_util.tree_flatten(jparams)
    rng = np.random.default_rng(seed + 100)
    leaves = [np.asarray(x) + noise * rng.standard_normal(x.shape).astype(np.float32)
              for x in leaves]
    jparams = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in leaves])
    return jparams, mod.params_from_jax(cfg, np_tree(jparams), "cpu")


def check_config(cfg, jcfg):
    """Every field of the port's config equals the JAX config's, Llama's
    ``remat_policy`` included."""
    import dataclasses
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def check_num_params(jmod, mod, jcfg, cfg, jparams, params):
    n = sum(x.size for x in jax.tree_util.tree_leaves(jparams))
    assert mod.num_params(cfg) == n
    if hasattr(jmod, "num_params"):  # JAX's mixtral has none
        assert jmod.num_params(jcfg) == n
    assert sum(t.numel() for t in tree_leaves(params)) == n
    gen = torch.Generator().manual_seed(0)
    assert sum(t.numel() for t in tree_leaves(mod.init_params(cfg, gen))) == n


def token_ids(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def first(out):
    """The logits of a forward that returns (logits, aux) or logits."""
    return out[0] if isinstance(out, tuple) else out


def check_forward(jmod, mod, jcfg, cfg, jparams, params, attention_fns=None, **kw):
    """``attention_fns``: (JAX's, the port's) ``attention_fn`` for the two
    forwards, where each should take another than its default."""
    ids = token_ids(cfg, (2, 12))
    jkw, pkw = dict(kw), dict(kw)
    if attention_fns is not None:
        jkw["attention_fn"], pkw["attention_fn"] = attention_fns
    ref = jax.jit(jmod.forward, static_argnums=0, static_argnames=tuple(jkw))(
        jcfg, jparams, jnp.asarray(ids), **jkw)
    got = mod.forward(cfg, params, torch.from_numpy(ids), **pkw)
    if isinstance(ref, tuple):
        np.testing.assert_allclose(float(got[1]), float(ref[1]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(first(got).detach().numpy(), np.asarray(first(ref)), atol=ATOL,
                               rtol=RTOL)


def check_loss_and_grads(jmod, mod, jcfg, cfg, jparams, params, has_aux=False, batch=None,
                         attention_fns=None):
    """The loss and every leaf of its gradient against ``jax.value_and_grad``
    of the JAX loss function, on ``batch`` (numpy leaves) or a next-token
    batch with an ignored label; ``attention_fns`` as in
    :func:`check_forward`."""
    if batch is None:
        batch = mod.causal_lm_batch(token_ids(cfg, (2, 13), seed=1))
        batch["labels"] = np.array(batch["labels"])
        batch["labels"][0, 2] = -100
    jkw, pkw = {}, {}
    if attention_fns is not None:
        jkw["attention_fn"], pkw["attention_fn"] = attention_fns
    jloss_fn = jmod.make_loss_fn(jcfg, **jkw)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jout, jgrads = jax.jit(jax.value_and_grad(lambda p: jloss_fn(p, jbatch, None),
                                              has_aux=has_aux))(jparams)
    params = tree_map(lambda t: t.clone().requires_grad_(True), params)
    out = mod.make_loss_fn(cfg, **pkw)(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                       None)
    loss, jloss = (out[0], jout[0]) if has_aux else (out, jout)
    if has_aux:
        np.testing.assert_allclose(out[1]["aux_loss"].item(), float(jout[1]["aux_loss"]),
                                   atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL, rtol=RTOL)
    loss.backward()
    # jax flattens dicts in sorted key order; take the port's grads the same way
    got = jax.tree_util.tree_leaves(tree_map(lambda t: t.grad.numpy(), params))
    ref = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    assert len(got) == len(ref) == len(tree_leaves(params))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=RTOL)


def check_forward_paged(jmod, mod, jcfg, cfg, jparams, params, prompts, *, block_size=4,
                        num_blocks=24, maxb=6):
    """A prefill chunk (with a zero-length padding row, as the engine's pow2
    bucketing makes) then two greedy decode steps through both packages'
    ``forward_paged``: logits of every live row and every KV block but the
    trash block (which takes the padded tokens' writes in an order neither
    framework defines) within 1e-4."""
    jkv = jmod.init_paged_cache(jcfg, num_blocks, block_size, dtype=jnp.float32)
    kv = mod.init_paged_cache(cfg, num_blocks, block_size, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    trash = num_blocks - 1
    perm = rng.permutation(trash)
    n = len(prompts) + 1
    tables = np.full((n, maxb), trash, np.int32)
    for i in range(len(prompts)):
        tables[i] = perm[i * maxb:(i + 1) * maxb]
    tokens = np.zeros((n, max(len(p) for p in prompts)), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    n_tokens = np.asarray([len(p) for p in prompts] + [0], np.int32)
    start = np.zeros(n, np.int32)
    jforward_paged = jax.jit(jmod.forward_paged, static_argnums=0, static_argnames=("block_size", ))
    for _ in range(3):
        args = (tokens, n_tokens, start, tables)
        jlogits, jkv = jforward_paged(jcfg, jparams, *(jnp.asarray(a) for a in args), jkv,
                                      block_size=block_size)
        logits, kv = mod.forward_paged(cfg, params, *(torch.from_numpy(a) for a in args), kv,
                                       block_size=block_size)
        valid = np.arange(tokens.shape[1])[None, :] < n_tokens[:, None]
        np.testing.assert_allclose(logits.numpy()[valid], np.asarray(jlogits)[valid],
                                   atol=ATOL, rtol=RTOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(kv[name].numpy()[:, :trash],
                                       np.asarray(jkv[name])[:, :trash], atol=ATOL, rtol=RTOL)
        last = np.maximum(n_tokens - 1, 0)
        start = start + n_tokens
        tokens = np.asarray(jlogits)[np.arange(n), last].argmax(-1).astype(np.int32)[:, None]
        n_tokens = np.asarray([1] * len(prompts) + [0], np.int32)


ENGINE_KW = dict(num_blocks=48, block_size=8, max_blocks_per_seq=8, token_budget=16,
                 max_seqs_per_step=4)


def check_engine_generate(key, jmod, cfg, jcfg, jparams, params, vocab):
    """Greedy ``generate`` of the port's engine (built by ``build_engine``
    under the JAX key, fast path) token-identical to the JAX engine's
    reference loop; the 20-token prompt takes two steps at a budget of 16,
    and the pool is reclaimed."""
    jeng = JaxEngine(jmod, jcfg, jparams, config=JAX_REFERENCE_LOOP, **ENGINE_KW)
    eng = build_engine(key, cfg, params, config={"dtype": "float32"}, device="cpu", **ENGINE_KW)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, vocab, n).tolist() for n in (20, 3, 9)]
    ref = jeng.generate(prompts, max_new_tokens=5)
    got = eng.generate(prompts, max_new_tokens=5)
    assert got == ref
    assert eng.forward_steps > 5  # the long prompt split across steps
    assert eng.manager.allocator.free_blocks == ENGINE_KW["num_blocks"] - 1
    assert not eng.manager.seqs


def hf_greedy(hf_model, prompt, n):
    """HF's own greedy continuation of one prompt, ``n`` tokens."""
    ids = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            logits = hf_model(torch.tensor([ids])).logits[0, -1]
            ids.append(int(logits.argmax()))
    return ids


def check_hf(mod, hf_model, forward_kw=None, config=None):
    """``config_from_hf`` + ``from_hf_state_dict`` + ``forward`` against the
    HF model's logits at 2e-3 (``config`` replaces the converted config for
    the forward), and ``build_hf_engine`` on the same instance: its greedy
    ``generate`` equals HF's greedy continuation."""
    hf_model.eval()
    cfg = config or mod.config_from_hf(hf_model.config)
    params = mod.from_hf_state_dict(cfg, hf_model.state_dict())
    ids = np.random.default_rng(0).integers(0, hf_model.config.vocab_size, (2, 12))
    with torch.no_grad():
        ref = hf_model(torch.tensor(ids)).logits.float().numpy()
        got = first(mod.forward(cfg, params, torch.from_numpy(ids), **(forward_kw or {})))
    np.testing.assert_allclose(got.numpy(), ref, atol=HF_TOL, rtol=HF_TOL)
    engine = build_hf_engine(hf_model, config={"dtype": "float32"}, device="cpu", **ENGINE_KW)
    assert engine.model is mod
    prompts = [ids[0, :7].tolist(), ids[1, :12].tolist()]
    got = engine.generate(prompts, max_new_tokens=4)
    assert got == [hf_greedy(hf_model, p, 4) for p in prompts]

"""The port's BLOOM (``deepspeed_tpu_torch.models.bloom``) on the CPU
against the JAX package's: the config and parameter count, the ALiBi slopes
(bit for bit, power-of-two head counts and the interleaved extras), the
dense forward (embedding LayerNorm, per-head fused QKV, ALiBi through the
biased attention, tied head), the loss and its grads, the v1
``forward_with_cache`` over a prefill and three decode steps, the paged
forward (ALiBi on the paged attention's ``alibi_slopes``) over a prefill
chunk and two decode steps, greedy ``generate`` through the v1 engine and
through ``InferenceEngineV2(bloom, ...)``, ``build_engine``'s refusal, and
HF parity on a ``BloomForCausalLM`` built in the test.  fp32 at 1e-4 (HF at
2e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngine as JInferenceEngine
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngineV2
from deepspeed_tpu.models import bloom as jbloom
from deepspeed_tpu_torch.inference import init_inference
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, build_engine, build_hf_engine
from deepspeed_tpu_torch.models import bloom
from tests import torch_family_checks as fam

CFG = bloom.BloomConfig.tiny(vocab=96, hidden=32, layers=2, heads=4, seq=64)
JCFG = jbloom.BloomConfig.tiny(vocab=96, hidden=32, layers=2, heads=4, seq=64)
V1_CONF = {"dtype": "float32", "max_seq_len": 64}


@pytest.fixture(scope="module")
def weights():
    return fam.pair_params(jbloom, bloom, JCFG, CFG)


def test_config_and_param_count_match_jax(weights):
    fam.check_config(CFG, JCFG)
    fam.check_config(bloom.BloomConfig.bloom_7b1(), jbloom.BloomConfig.bloom_7b1())
    fam.check_num_params(jbloom, bloom, JCFG, CFG, *weights)
    b7 = bloom.BloomConfig.bloom_7b1()
    assert bloom.num_params(b7) == jbloom.num_params(jbloom.BloomConfig.bloom_7b1())
    kv = bloom.init_paged_cache(CFG, 6, 4, dtype=torch.float32, device="cpu")
    assert tuple(kv["k"].shape) == (CFG.num_layers, 6, 4, 4, 8)


@pytest.mark.parametrize("heads", [4, 6, 12, 32, 112])
def test_alibi_slopes_bit_equal_to_jax(heads):
    got, ref = bloom.alibi_slopes(heads), jbloom.alibi_slopes(heads)
    assert got.dtype == ref.dtype == np.float32 and got.shape == (heads, )
    np.testing.assert_array_equal(got, ref)
    dev = bloom.device_alibi_slopes(heads, "cpu")
    assert dev is bloom.device_alibi_slopes(heads, "cpu")  # built once
    np.testing.assert_array_equal(dev.numpy(), ref)


def test_forward_matches_jax(weights):
    fam.check_forward(jbloom, bloom, JCFG, CFG, *weights)


def test_loss_and_grads_match_jax(weights):
    fam.check_loss_and_grads(jbloom, bloom, JCFG, CFG, *weights)


def test_forward_with_cache_matches_jax_and_the_dense_forward(weights):
    """A 6-token prefill and three decode steps through both packages'
    ``forward_with_cache``: logits and caches within 1e-4 of JAX's, each
    step's logits equal to the dense forward's last row (3e-4, the JAX
    test's), the cache written in place."""
    jparams, params = weights
    ids = fam.token_ids(CFG, (2, 9), seed=2)
    cache = bloom.init_cache(CFG, 2, max_seq=32, dtype=torch.float32)
    k_buf = cache["k"]
    jcache = jbloom.init_cache(JCFG, 2, max_seq=32, dtype=jnp.float32)
    jforward_with_cache = jax.jit(jbloom.forward_with_cache, static_argnums=0)
    for lo, hi in [(0, 6), (6, 7), (7, 8), (8, 9)]:
        logits, cache = bloom.forward_with_cache(CFG, params, torch.from_numpy(ids[:, lo:hi]),
                                                 cache)
        jlogits, jcache = jforward_with_cache(JCFG, jparams, jnp.asarray(ids[:, lo:hi]), jcache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
        assert cache["len"] == int(jcache["len"]) == hi and cache["k"] is k_buf
        full = bloom.forward(CFG, params, torch.from_numpy(ids[:, :hi])).detach()
        np.testing.assert_allclose(logits[:, -1].numpy(), full[:, -1].numpy(), atol=3e-4,
                                   rtol=3e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), atol=1e-5,
                                   rtol=1e-5)


def test_forward_paged_matches_jax(weights):
    fam.check_forward_paged(jbloom, bloom, JCFG, CFG, *weights,
                            prompts=[[5, 9, 2, 7, 1, 3, 8], [11, 4, 6]])


def test_v1_engine_greedy_generate_matches_jax(weights):
    jparams, params = weights
    jeng = JInferenceEngine(jbloom, JCFG, jparams, config=V1_CONF)
    eng = init_inference(model_module=bloom, model_config=CFG, params=params, config=V1_CONF,
                         device="cpu")
    prompt = fam.token_ids(CFG, (2, 7), seed=3)
    out = eng.generate(prompt, max_new_tokens=6, temperature=0.0)
    assert out.shape == (2, 13)
    np.testing.assert_array_equal(out, jeng.generate(prompt, max_new_tokens=6, temperature=0.0))


def test_v2_engine_greedy_generate_matches_jax_engine(weights):
    """``InferenceEngineV2(bloom, ...)`` (fast path) token-identical to the
    JAX engine's reference loop; the 20-token prompt takes two steps at a
    budget of 16, and the pool is reclaimed."""
    jparams, params = weights
    jeng = JEngineV2(jbloom, JCFG, jparams, config=fam.JAX_REFERENCE_LOOP, **fam.ENGINE_KW)
    eng = InferenceEngineV2(bloom, CFG, params, config={"dtype": "float32"}, device="cpu",
                            **fam.ENGINE_KW)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, CFG.vocab_size, n).tolist() for n in (20, 3, 9)]
    assert eng.generate(prompts, max_new_tokens=5) == jeng.generate(prompts, max_new_tokens=5)
    assert eng.forward_steps > 5
    assert eng.manager.allocator.free_blocks == fam.ENGINE_KW["num_blocks"] - 1
    assert not eng.manager.seqs


def test_build_engine_refuses_bloom_as_jax_does(weights):
    with pytest.raises(ValueError, match="v2 serving supports"):
        build_engine("bloom", CFG, weights[1], device="cpu", **fam.ENGINE_KW)


def test_hf_parity_and_v2_engine_on_hf_weights():
    """``config_from_hf`` + ``from_hf_state_dict`` + ``forward`` against HF's
    logits at 2e-3, the importer equal to JAX's, ``build_hf_engine``
    refusing the family, and ``InferenceEngineV2(bloom, ...)`` on the
    converted weights continuing each prompt as HF's own greedy decode."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.BloomForCausalLM(transformers.BloomConfig(vocab_size=99, hidden_size=32,
                                                                n_layer=2, n_head=4)).eval()
    cfg = bloom.config_from_hf(hf.config)
    assert cfg == bloom.BloomConfig(**vars(jbloom.config_from_hf(hf.config)))
    params = bloom.from_hf_state_dict(cfg, hf.state_dict())
    ref = jbloom.from_hf_state_dict(jbloom.config_from_hf(hf.config), hf.state_dict())
    for name in ("w_qkv", "b_qkv", "fc2"):
        np.testing.assert_array_equal(params["layers"][name].numpy(),
                                      np.asarray(ref["layers"][name]))
    ids = np.random.default_rng(0).integers(0, 99, (2, 12))
    with torch.no_grad():
        hf_logits = hf(torch.tensor(ids)).logits.float().numpy()
        got = bloom.forward(cfg, params, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, hf_logits, atol=fam.HF_TOL, rtol=fam.HF_TOL)
    with pytest.raises(ValueError, match="v2 serving supports"):
        build_hf_engine(hf, device="cpu", **fam.ENGINE_KW)
    engine = InferenceEngineV2(bloom, cfg, params, config={"dtype": "float32"}, device="cpu",
                               **fam.ENGINE_KW)
    prompts = [ids[0, :7].tolist(), ids[1, :12].tolist()]
    assert engine.generate(prompts, max_new_tokens=4) == [fam.hf_greedy(hf, p, 4)
                                                          for p in prompts]

"""The port's v2 serving engine on the CPU against the JAX package's.

Host-side pieces (allocator, manager, SplitFuse) replay the JAX package's own
scenarios; greedy ``generate`` must be token-identical to the JAX engine on
its reference loop (fast path and prefix cache off) with the same weights;
sampling agrees in distribution (threefry and Philox share no bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.engine import _filter_logits as jax_filter_logits
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import mistral as jmistral
from deepspeed_tpu_torch.inference.config import load_inference_config
from deepspeed_tpu_torch.inference.engine import _filter_logits, _sample
from deepspeed_tpu_torch.inference.v2 import (BlockedAllocator, InferenceEngineV2,
                                              RaggedStateManager, SplitFuseScheduler,
                                              build_engine)
from deepspeed_tpu_torch.models import llama, mistral

JAX_REFERENCE_LOOP = {"dtype": "float32", "serving_fastpath": {"enabled": False},
                      "serving_prefix_cache": {"enabled": False}}


def _pair(jmod, mod, jcfg, cfg, seed):
    jparams = jmod.init_params(jcfg, jax.random.PRNGKey(seed))
    params = mod.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jparams, params


def _engines(jmod, mod, jcfg, cfg, seed, **kw):
    jparams, params = _pair(jmod, mod, jcfg, cfg, seed)
    jeng = JaxEngine(jmod, jcfg, jparams, config=JAX_REFERENCE_LOOP, **kw)
    eng = InferenceEngineV2(mod, cfg, params, config={"dtype": "float32"}, device="cpu", **kw)
    return jeng, eng


# ------------------------------------------------------- host-side scenarios
def test_blocked_allocator_roundtrip():
    a = BlockedAllocator(10)
    got = a.allocate(4)
    assert len(got) == 4 and a.free_blocks == 5  # trash excluded
    a.free(got[:2])
    assert a.free_blocks == 7
    with pytest.raises(RuntimeError):
        a.allocate(100)
    with pytest.raises(ValueError):
        a.free([a.trash_block])
    with pytest.raises(ValueError, match="double free"):
        a.free(got[:1])


def test_blocked_allocator_refcounts():
    a = BlockedAllocator(4)
    (b, ) = a.allocate(1)
    a.incref(b)
    assert a.free([b]) == [] and a.refcount(b) == 1  # one mapping left
    assert a.free([b]) == [b] and a.free_blocks == 3
    with pytest.raises(ValueError, match="not currently allocated"):
        a.incref(b)


def test_manager_block_growth_and_retire():
    m = RaggedStateManager(num_blocks=16, block_size=4, max_blocks_per_seq=8)
    seq = m.add_sequence(7, list(range(10)))
    m.ensure_blocks(seq, 10)  # 10 tokens / bs4 -> 3 blocks
    assert len(seq.blocks) == 3
    row = m.block_table_row(seq)
    assert list(row[:3]) == seq.blocks and row[3] == m.trash_block
    free_before = m.allocator.free_blocks
    m.retire(7)
    assert m.allocator.free_blocks == free_before + 3
    with pytest.raises(KeyError, match="already retired"):
        m.retire(7)


def test_splitfuse_prefers_decodes_and_splits_prompts():
    m = RaggedStateManager(num_blocks=64, block_size=4, max_blocks_per_seq=16)
    sched = SplitFuseScheduler(token_budget=8, max_seqs_per_step=8)
    decode = m.add_sequence(1, list(range(5)))
    decode.seen_tokens = 4  # one pending token -> decoding
    m.ensure_blocks(decode, 5)
    m.add_sequence(2, list(range(20)))  # long prompt
    chunks = sched.schedule(m)
    by_uid = {c.uid: c.n_tokens for c in chunks}
    assert by_uid[1] == 1          # decode scheduled first
    assert by_uid[2] == 7          # prompt chunk fills the remaining budget (split!)


# ------------------------------------------------- token identity with JAX
def test_ragged_generation_matches_jax_engine():
    jcfg = jllama.LlamaConfig.tiny(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, seq=128)
    cfg = llama.LlamaConfig.tiny(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, seq=128)
    jeng, eng = _engines(jllama, llama, jcfg, cfg, 0, num_blocks=64, block_size=8,
                         max_blocks_per_seq=8, token_budget=16, max_seqs_per_step=4)
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 10, 11], [20, 21, 22, 23, 24]]
    ref = jeng.generate(prompts, max_new_tokens=6)
    got = eng.generate(prompts, max_new_tokens=6)
    assert got == ref
    assert eng.manager.allocator.free_blocks == 63 and not eng.manager.seqs


def test_splitfuse_long_prompt_across_steps_matches_jax_engine():
    """A prompt longer than the budget takes multiple steps before decoding;
    each step's emitted tokens equal the JAX engine's."""
    jcfg = jllama.LlamaConfig.tiny(vocab=64, hidden=32, layers=1, heads=2, kv_heads=2, seq=128)
    cfg = llama.LlamaConfig.tiny(vocab=64, hidden=32, layers=1, heads=2, kv_heads=2, seq=128)
    jeng, eng = _engines(jllama, llama, jcfg, cfg, 1, num_blocks=32, block_size=8,
                         max_blocks_per_seq=16, token_budget=8, max_seqs_per_step=4)
    for e in (jeng, eng):
        e.put([0], [list(range(1, 21))])  # 20-token prompt, budget 8
    outs = [(eng.step(), jeng.step()) for _ in range(5)]
    assert outs[0][0] == {} and outs[1][0] == {}  # 8, then 16 tokens prefilled
    assert 0 in outs[2][0] and 0 in outs[3][0]    # finishes the prompt, then decodes
    assert [o for o, _ in outs] == [r for _, r in outs]
    assert eng.forward_steps == 5
    eng.flush(0)
    assert eng.manager.allocator.free_blocks == 31


def test_mistral_window_generation_matches_jax_engine():
    jcfg = jmistral.MistralConfig.tiny(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2,
                                       seq=128, window=8)
    cfg = mistral.MistralConfig.tiny(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2,
                                     seq=128, window=8)
    jeng, eng = _engines(jmistral, mistral, jcfg, cfg, 0, num_blocks=64, block_size=8,
                         max_blocks_per_seq=8, token_budget=16, max_seqs_per_step=4)
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 10, 11], list(range(20, 32))]
    assert eng.generate(prompts, max_new_tokens=5) == jeng.generate(prompts, max_new_tokens=5)


@pytest.mark.parametrize("num_blocks,statuses", [(12, ["ok", "ok", "ok"]),
                                                 (8, ["ok", "ok", "failed"])])
def test_kv_tight_pool_preemption_matches_jax_engine(num_blocks, statuses):
    """A pool too small for every request at once: a starved decode preempts
    the newest prefill (rolled back, requeued).  With 12 blocks everyone
    finishes; with 8 the long prompt can never fit and the stall watchdog
    fails it.  Tokens and statuses equal the JAX engine's."""
    jcfg = jllama.LlamaConfig.tiny(vocab=64, hidden=32, layers=1, heads=2, kv_heads=2, seq=128)
    cfg = llama.LlamaConfig.tiny(vocab=64, hidden=32, layers=1, heads=2, kv_heads=2, seq=128)
    jeng, eng = _engines(jllama, llama, jcfg, cfg, 5, num_blocks=num_blocks, block_size=4,
                         max_blocks_per_seq=16, token_budget=8, max_seqs_per_step=4)
    prompts = [[1, 2, 3], [4, 5, 6, 7], list(range(10, 40))]
    ref = jeng.generate(prompts, max_new_tokens=8, strict=False)
    got = eng.generate(prompts, max_new_tokens=8, strict=False)
    assert [r.status for r in got] == [r.status for r in ref] == statuses
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    assert eng.scheduler.preempted_total == jeng.scheduler.preempted_total >= 1
    assert eng.manager.allocator.free_blocks == num_blocks - 1


def test_engine_factory_registry():
    jcfg = jmistral.MistralConfig.tiny(vocab=64, hidden=32, layers=1, heads=2, kv_heads=2)
    cfg = mistral.MistralConfig.tiny(vocab=64, hidden=32, layers=1, heads=2, kv_heads=2)
    _, params = _pair(jmistral, mistral, jcfg, cfg, 0)
    eng = build_engine("mistral", cfg, params, config={"dtype": "float32"}, device="cpu",
                       num_blocks=16, block_size=8, max_blocks_per_seq=4)
    out = eng.generate([[1, 2, 3]], max_new_tokens=2)
    assert len(out[0]) == 5
    with pytest.raises(ValueError, match="v2 serving supports"):
        build_engine("bloom", cfg, params, device="cpu")


# ------------------------------------------------------------- sampling
@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 1.0), (0.7, 5, 1.0),
                                                     (1.3, 0, 0.8), (0.9, 8, 0.6)])
def test_filter_logits_masks_match_jax(temperature, top_k, top_p):
    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(4, 32)) * 2).astype(np.float32)
    ref = np.asarray(jax_filter_logits(jnp.asarray(logits), temperature=temperature,
                                       top_k=top_k, top_p=top_p))
    got = _filter_logits(torch.from_numpy(logits), temperature=temperature, top_k=top_k,
                         top_p=top_p).numpy()
    np.testing.assert_array_equal(got <= -1e29, ref <= -1e29)
    kept = ref > -1e29
    np.testing.assert_allclose(got[kept], ref[kept], rtol=1e-6)


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 1.0), (0.8, 6, 1.0),
                                                     (1.0, 0, 0.7)])
def test_sampled_tokens_within_tv_band_of_jax_distribution(temperature, top_k, top_p):
    rng = np.random.default_rng(8)
    vocab, draws = 24, 20000
    row = (rng.normal(size=(1, vocab)) * 1.5).astype(np.float32)
    target = np.asarray(jax.nn.softmax(jax_filter_logits(
        jnp.asarray(row), temperature=temperature, top_k=top_k, top_p=top_p), axis=-1))[0]
    gen = torch.Generator().manual_seed(0)
    toks = _sample(torch.from_numpy(np.repeat(row, draws, axis=0)), gen,
                   temperature=temperature, top_k=top_k, top_p=top_p).numpy()
    empirical = np.bincount(toks, minlength=vocab) / draws
    tv = 0.5 * np.abs(empirical - target).sum()
    assert tv < 0.08, tv
    assert set(np.flatnonzero(empirical)) <= set(np.flatnonzero(target > 0))


def test_sampled_generate_is_seeded_and_in_vocab():
    jcfg = jllama.LlamaConfig.tiny(vocab=64, hidden=32, layers=1, heads=2, kv_heads=2, seq=64)
    cfg = llama.LlamaConfig.tiny(vocab=64, hidden=32, layers=1, heads=2, kv_heads=2, seq=64)
    _, params = _pair(jllama, llama, jcfg, cfg, 2)
    conf = {"dtype": "float32", "temperature": 1.0, "top_k": 20, "seed": 3}
    runs = [InferenceEngineV2(llama, cfg, params, config=conf, device="cpu", num_blocks=32,
                              block_size=8, max_blocks_per_seq=8, token_budget=16)
            .generate([[1, 2, 3], [4, 5]], max_new_tokens=6, greedy=False) for _ in range(2)]
    assert runs[0] == runs[1]
    assert all(0 <= t < 64 for out in runs[0] for t in out)


# ------------------------------------------------------------- device & config
def test_engine_defaults_to_cuda_and_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig.tiny(vocab=64, hidden=32, layers=1, heads=2, kv_heads=2)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngineV2(llama, cfg, params, config={"dtype": "float32"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine("llama", cfg, params)


def test_config_unknown_key_and_unported_sections_raise():
    with pytest.raises(ValueError, match="unknown config field 'max_out_tokenz'"):
        load_inference_config({"max_out_tokenz": 8})
    # serving_perf, serving_qos, serving_fleet and serving_spec_decode are
    # ported: they load, the last with the JAX package's defaults
    assert load_inference_config({"serving_perf": {"enabled": True}}).serving_perf.enabled
    assert load_inference_config({"serving_qos": {"enabled": True}}).serving_qos.enabled
    assert load_inference_config({"serving_fleet": {"replicas": 3}}).serving_fleet.replicas == 3
    from deepspeed_tpu.runtime.config import ServingSpecDecodeConfig as JaxSpecConfig
    spec = load_inference_config({"serving_spec_decode": {"enabled": False}}).serving_spec_decode
    fields = lambda c: {k: v for k, v in vars(c).items() if not k.startswith("_")}  # noqa: E731
    assert fields(spec) == fields(JaxSpecConfig())
    with pytest.raises(ValueError, match="not in"):
        load_inference_config({"dtype": "float64"})
    cfg = load_inference_config({"serving_resilience": {"max_preemptions": 3}})
    assert cfg.serving_resilience.max_preemptions == 3 and cfg.dtype == "bfloat16"


def test_generate_sheds_over_cap_prompt_and_expires_deadlines():
    cfg = llama.LlamaConfig.tiny(vocab=64, hidden=32, layers=1, heads=2, kv_heads=2, seq=64)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    now = [0.0]

    def clock():
        now[0] += 1.0  # every read advances the fake clock one second
        return now[0]

    eng = InferenceEngineV2(llama, cfg, params, config={"dtype": "float32"}, device="cpu",
                            num_blocks=16, block_size=4, max_blocks_per_seq=4,
                            token_budget=8, clock=clock)
    res = eng.generate([[1] * 20, [2, 3]], max_new_tokens=3, strict=False)
    assert res[0].status == "shed" and res[0].shed_code == "prompt_over_cap"
    assert res[1].status == "ok" and len(res[1].tokens) == 5
    with pytest.raises(RuntimeError, match="shed"):
        eng.generate([[1] * 20], max_new_tokens=3)
    res = eng.generate([[2, 3]], max_new_tokens=50, strict=False, ttl_s=4.0)
    assert res[0].status == "deadline_expired" and res[0].retryable
    assert eng.manager.allocator.free_blocks == 15 and not eng.manager.seqs


def test_factory_serves_the_jax_keys_but_falcon_and_phi(tmp_path):
    """``build_engine`` serves the JAX registry's keys whose heads the paged
    kernel takes; Falcon and Phi raise, naming the served keys.
    ``build_hf_engine`` also takes a local checkpoint directory."""
    from deepspeed_tpu.inference.v2 import engine_factory as jfactory
    from deepspeed_tpu_torch.inference.v2 import build_hf_engine
    from deepspeed_tpu_torch.inference.v2.engine_factory import REGISTRY
    assert set(REGISTRY) == set(jfactory._registry()) - {"falcon", "phi"}
    cfg = llama.LlamaConfig.tiny(vocab=64, hidden=32, layers=1, heads=2, kv_heads=2)
    for key in ("falcon", "phi"):
        with pytest.raises(ValueError, match="gptj"):
            build_engine(key, cfg, {}, device="cpu")
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    transformers.OPTForCausalLM(transformers.OPTConfig(
        vocab_size=64, hidden_size=32, ffn_dim=64, num_hidden_layers=1, num_attention_heads=2,
        max_position_embeddings=64)).save_pretrained(tmp_path)
    engine = build_hf_engine(str(tmp_path), config={"dtype": "float32"}, device="cpu",
                             num_blocks=16, block_size=8, max_blocks_per_seq=4)
    assert engine.model.__name__.endswith(".opt")
    assert len(engine.generate([[5, 6, 7]], max_new_tokens=3)[0]) == 6

"""The port's hybrid engine on the CPU against the JAX package's, the same
tiny fp32 Llama and adapters (carried numpy leaf by leaf): ``eval_forward``
before training within 1e-5 of JAX's, greedy ``generate`` token-identical
before and after two train steps, the masters after the steps within the
Adam rule (every element within 2 x sum(lr), 99.9 % within 1e-5), LoRA-fused
logits within 2e-5, unfuse and fuse again bit for bit, one inference engine
for the engine's life, the train step on the base weights, the adapter
refusals with JAX's messages, and the ``offload_optimizer: cpu`` branch
serving the compute copy it pushes.  The JAX engine, built once for the
module, runs its Pallas kernels in interpret mode on a one-device
topology."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.ops import _pallas
from deepspeed_tpu.parallel.mesh import MeshTopology, reset_topology
from deepspeed_tpu.runtime import hybrid_engine as jhybrid
from deepspeed_tpu.runtime.config import load_config as jload_config
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.runtime.config import load_config
from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine
from deepspeed_tpu_torch.runtime.tree import tree_map

SHAPE = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, seq=32)
CONF = {"train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "adamw", "params": {"lr": 5e-3}},
        "zero_optimization": {"stage": 3}, "bf16": {"enabled": False}}
INFERENCE = {"dtype": "float32", "max_seq_len": 32}
STEPS = 2
R = 4


def _configs():
    return (dataclasses.replace(jllama.LlamaConfig.tiny(**SHAPE), remat=False),
            dataclasses.replace(llama.LlamaConfig.tiny(**SHAPE), remat=False))


def _lora_np(cfg, seed=7):
    rng = np.random.default_rng(seed)
    L, D = cfg.num_layers, cfg.hidden_size
    kv = cfg.num_kv_heads * (D // cfg.num_heads)
    return {"layers": {"attn": {
        "wq": {"a": rng.normal(size=(L, D, R)).astype(np.float32) * 0.1,
               "b": rng.normal(size=(L, R, D)).astype(np.float32) * 0.1, "alpha": 8.0},
        "wv": {"a": rng.normal(size=(L, D, R)).astype(np.float32) * 0.1,
               "b": rng.normal(size=(L, R, kv)).astype(np.float32) * 0.1, "alpha": 8.0}}}}


def _lora_torch(lora):
    return tree_map(lambda x: torch.from_numpy(x) if isinstance(x, np.ndarray) else x, lora)


def _prompts(seed, rows=2, length=6):
    return np.random.default_rng(seed).integers(1, SHAPE["vocab"], (rows, length))


def _batch(seed, rows=2):
    return llama.causal_lm_batch(
        np.random.default_rng(seed).integers(0, SHAPE["vocab"], (rows, SHAPE["seq"])))


def _port_engine(cfg, params, conf=CONF, inference=INFERENCE):
    return DeepSpeedHybridEngine(loss_fn=llama.make_loss_fn(cfg), params=params,
                                 config=load_config(conf), device="cpu", model_module=llama,
                                 model_config=cfg, inference_config=inference)


def _drive(engine, lora, to_np):
    """The same drive on either engine: logits and greedy rollouts before
    training, LoRA fused / unfused / fused again, then steps with the
    adapters attached, rollouts and logits after."""
    ids = _prompts(3)
    out = {"logits0": to_np(engine.eval_forward(ids)),
           "gen0": np.asarray(engine.generate(_prompts(4), max_new_tokens=6, temperature=0.0))}
    inf = engine._inf_engine
    engine.set_lora(lora)
    out["fused"] = to_np(engine.eval_forward(ids))
    engine.unfuse_lora_weight()
    out["unfused"] = to_np(engine.eval_forward(ids))
    engine.fuse_lora_weight()
    out["refused"] = to_np(engine.eval_forward(ids))
    engine.unfuse_lora_weight()
    out["lrs"] = []
    out["losses"] = []
    for s in range(STEPS):
        m = engine.train_batch(_batch(10 + s))
        out["lrs"].append(float(m.lr))
        out["losses"].append(float(m.loss))
    out["gen1"] = np.asarray(engine.generate(_prompts(4), max_new_tokens=6, temperature=0.0))
    out["logits1"] = to_np(engine.eval_forward(ids))
    out["same_inference_engine"] = engine._inf_engine is inf
    out["params"] = tree_map(np.asarray, engine.get_fp32_params())
    return out


@pytest.fixture(scope="module")
def runs():
    monkey = pytest.MonkeyPatch()
    monkey.setattr(_pallas, "INTERPRET", True)
    jcfg, cfg = _configs()
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    lora = _lora_np(cfg)
    topo = MeshTopology.from_axis_dict({"data": 1}, devices=jax.devices()[:1])
    try:
        jeng = jhybrid.DeepSpeedHybridEngine(
            loss_fn=jllama.make_loss_fn(jcfg), params=jparams, config=jload_config(CONF),
            topology=topo, model_module=jllama, model_config=jcfg, inference_config=INFERENCE)
        want = _drive(jeng, lora, np.asarray)
    finally:
        reset_topology()
        monkey.undo()
    eng = _port_engine(cfg, llama.params_from_jax(cfg, np_params, "cpu"))
    got = _drive(eng, _lora_torch(lora), lambda t: t.numpy())
    return {"got": got, "want": want, "cfg": cfg, "np_params": np_params, "lora": lora,
            "jax_engine": jeng}


def test_eval_forward_before_training_matches_jax(runs):
    np.testing.assert_allclose(runs["got"]["logits0"], runs["want"]["logits0"], atol=1e-5)


def test_greedy_rollouts_match_jax_before_and_after_training(runs):
    got, want = runs["got"], runs["want"]
    np.testing.assert_array_equal(got["gen0"], want["gen0"])
    np.testing.assert_array_equal(got["gen1"], want["gen1"])
    assert not np.array_equal(got["gen0"], got["gen1"]) or not np.allclose(
        got["logits0"], got["logits1"])


def test_masters_after_steps_pass_the_adam_rule(runs):
    got, want = runs["got"], runs["want"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    lrs = got["lrs"]
    diffs = np.concatenate([np.abs(g - np.asarray(w)).ravel() for g, w in zip(
        jax.tree_util.tree_leaves(got["params"]), jax.tree_util.tree_leaves(want["params"]))])
    assert diffs.max() <= 2 * sum(lrs), diffs.max()
    assert (diffs <= 1e-5).mean() >= 0.999


def test_lora_fuse_matches_jax_and_toggles_exactly(runs):
    got, want = runs["got"], runs["want"]
    np.testing.assert_allclose(got["fused"], want["fused"], atol=2e-5)
    assert not np.allclose(got["fused"], got["logits0"])
    np.testing.assert_array_equal(got["unfused"], got["logits0"])
    np.testing.assert_array_equal(got["refused"], got["fused"])
    assert got["same_inference_engine"] and want["same_inference_engine"]


@pytest.mark.parametrize("serve_dtype", ["bfloat16", "float32"])
def test_fused_logits_equal_a_manual_fuse(runs, serve_dtype):
    """bf16 training: the fuse runs in the compute dtype, then the weights
    take the serving dtype (the default serves bf16; float32 serves the bf16
    values widened, as JAX casts its params16 again)."""
    cfg = runs["cfg"]
    eng = _port_engine(cfg, llama.params_from_jax(cfg, runs["np_params"], "cpu"),
                       conf={**CONF, "bf16": {"enabled": True}},
                       inference={"max_seq_len": 32, "dtype": serve_dtype})
    lora = _lora_torch(runs["lora"])
    eng.set_lora(lora)
    ids = torch.from_numpy(_prompts(5))
    served = eng.eval_forward(ids)
    base16 = tree_map(lambda p: p.to(torch.bfloat16), eng.state.params)
    fused = DeepSpeedHybridEngine._fuse_lora_tree(base16, lora)
    want = getattr(torch, serve_dtype)
    manual = llama.forward(cfg, tree_map(lambda p: p.to(want), fused), ids)
    assert served.dtype == want
    assert torch.equal(served, manual)
    # the train step sees the base weights: the same loss with and without
    batch = _batch(20)
    _, with_lora = eng.accumulate_gradients(batch)
    eng.set_lora(None)
    _, without = eng.accumulate_gradients(batch)
    assert torch.equal(with_lora, without)


def test_adapter_refusals_match_jax(runs):
    cfg = runs["cfg"]
    eng = _port_engine(cfg, llama.params_from_jax(cfg, runs["np_params"], "cpu"))
    jeng = runs["jax_engine"]
    L, D = cfg.num_layers, cfg.hidden_size
    bad = [{"layers": {"attn": {"q_proj": {"a": np.zeros((L, D, 2)), "b": np.zeros((L, 2, D))}}}},
           {"layers": {"attn": {"wq": {"a": np.zeros((L, 8, 2)), "b": np.zeros((L, 2, 8))}}}},
           {"layers": {"attn": {"wq": {"a": np.zeros((3, D, 2)), "b": np.zeros((3, 2, D))}}}},
           {"layers": {"attn": "wq"}},
           {"layers": {"attn": {"wq": {"a": np.zeros((L, D, 2)), "b": np.zeros((L, 3, D))}}}},
           {"embed": {"wq": {"a": np.zeros((D, 2)), "b": np.zeros((2, D))}}}]
    for lora in bad:
        with pytest.raises(ValueError) as jerr:
            jeng.set_lora(lora)
        with pytest.raises(ValueError) as perr:
            eng.set_lora(lora)
        assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="call set_lora first"):
        eng.fuse_lora_weight()
    with pytest.raises(ValueError, match="needs model_module"):
        DeepSpeedHybridEngine(loss_fn=llama.make_loss_fn(cfg), params=eng.state.params,
                              config=load_config(CONF), device="cpu")
    # a shared adapter (no layer dim) broadcasts over the stacked layers
    rng = np.random.default_rng(1)
    eng.set_lora({"layers": {"attn": {"wq": {"a": rng.normal(size=(D, 2)) * 0.1,
                                             "b": rng.normal(size=(2, D)) * 0.1}}}})
    shared = eng.eval_forward(_prompts(7))
    eng.unfuse_lora_weight()
    assert not torch.allclose(shared, eng.eval_forward(_prompts(7)))


def test_offloaded_engine_serves_its_pushed_compute_copy(runs):
    cfg = runs["cfg"]
    conf = {**CONF, "zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}}}
    eng = _port_engine(cfg, llama.params_from_jax(cfg, runs["np_params"], "cpu"), conf=conf)
    ids = torch.from_numpy(_prompts(8))

    def compute_forward():
        return llama.forward(cfg, tree_map(lambda p: p.detach().clone(), eng._compute), ids)

    before = eng.eval_forward(ids)
    assert torch.equal(before, compute_forward())
    eng.train_batch(_batch(30))
    after = eng.eval_forward(ids)
    assert torch.equal(after, compute_forward()) and not torch.equal(after, before)
    # fusing writes the serving buffers only: the compute copy is untouched
    snapshot = tree_map(lambda p: p.detach().clone(), eng._compute)
    eng.set_lora(_lora_torch(runs["lora"]))
    eng.eval_forward(ids)
    for a, b in zip(jax.tree_util.tree_leaves(snapshot),
                    jax.tree_util.tree_leaves(tree_map(lambda p: p.detach(), eng._compute))):
        assert torch.equal(a, b)


def test_streaming_engine_refuses_generation_and_lora(tmp_path, runs):
    """Under ``offload_param: nvme`` no weights stay on the device: LoRA and
    generation raise JAX's ``ValueError`` (``hybrid_engine.py:58-62``)."""
    conf = {"train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": False},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": 3, "offload_param": {"device": "nvme",
                                                                "nvme_path": str(tmp_path)}}}
    gen = torch.Generator().manual_seed(0)
    params = {"layers": {"w": torch.randn(2, 4, 4, generator=gen)},
              "out": torch.randn(4, 2, generator=gen)}
    eng = DeepSpeedHybridEngine(
        loss_fn=lambda p, b, r: 0.0, params=params, config=load_config(conf), device="cpu",
        layer_fn=lambda p, x: torch.tanh(x @ p["w"]),
        head_fn=lambda h, x, y: ((x @ h["out"]) - y).pow(2).mean(),
        model_module=llama, model_config=runs["cfg"])
    message = "not available on the offload_param:nvme streaming path"
    with pytest.raises(ValueError, match=message):
        eng.set_lora({"layers": {"w": {"a": np.zeros((2, 4, 1)), "b": np.zeros((2, 1, 4))}}})
    with pytest.raises(ValueError, match=message):
        eng.generate(_prompts(9), max_new_tokens=2)


def test_a_loaded_checkpoint_is_served(runs, tmp_path):
    """Loading a checkpoint changes the weights at the same step count: the
    next generation serves the loaded weights."""
    cfg = runs["cfg"]
    donor = _port_engine(cfg, llama.params_from_jax(cfg, runs["np_params"], "cpu"))
    donor.train_batch(_batch(40))
    donor.save_checkpoint(str(tmp_path))
    eng = _port_engine(cfg, llama.params_from_jax(cfg, runs["np_params"], "cpu"))
    eng.train_batch(_batch(41))
    ids = torch.from_numpy(_prompts(10))
    before = eng.eval_forward(ids)
    eng.load_checkpoint(str(tmp_path))
    assert eng.global_steps == 1
    served = eng.eval_forward(ids)
    assert not torch.equal(served, before)
    assert torch.equal(served, llama.forward(cfg, eng.state.params, ids))

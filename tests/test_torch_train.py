"""The port's training path on the CPU against the JAX package, same numpy
inputs and weights (carried by ``params_from_jax``): the dense Llama forward
and the gradient of its loss, the transformer pieces it adds, and
``train_batch`` steps of ``deepspeed_tpu_torch.initialize(device="cpu")``
against ``deepspeed_tpu.initialize`` with fused_adam or fused_adam8bit,
block-sparse attention from the config, WarmupLR, gradient accumulation and
clipping.  The JAX side runs its Pallas kernels (flash, sparse attention,
fused AdamW, AdamW-8bit) in interpret mode, on a one-device topology so that
its engine takes the fused optimizer step (``engine.py:544``).  fp32
throughout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.ops import _pallas
from deepspeed_tpu.parallel.mesh import MeshTopology, reset_topology
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.ops.attention.flash import flash_attention
from deepspeed_tpu_torch.ops.sparse_attention import attention as sparse
from deepspeed_tpu_torch.runtime.config import SparseAttentionConfig, load_config
from deepspeed_tpu_torch.runtime.engine import TrainState
from deepspeed_tpu_torch.runtime.optimizers import adam8bit_state_from_jax, adam_state_from_jax
from deepspeed_tpu_torch.runtime.tree import tree_leaves, tree_map

VOCAB, SEQ = 96, 32
LR = 1e-3


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(_pallas, "INTERPRET", True)


@pytest.fixture
def one_device():
    """A one-device JAX topology (tests/conftest.py forces 8 CPU devices)."""
    topo = MeshTopology.from_axis_dict({"data": 1}, devices=jax.devices()[:1])
    yield topo
    reset_topology()


def _configs(**kw):
    shape = dict(vocab=VOCAB, hidden=64, layers=2, heads=4, kv_heads=2, seq=SEQ)
    return (jllama.LlamaConfig.tiny(**shape),
            dataclasses.replace(llama.LlamaConfig.tiny(**shape), **kw))


def _params(jcfg, cfg, seed=0):
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, llama.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _ids(seed, rows, seq=SEQ):
    return np.random.default_rng(seed).integers(0, VOCAB, (rows, seq)).astype(np.int32)


def _flat(tree):
    return {k: np.asarray(v) for k, v in zip(_paths(tree), jax.tree_util.tree_leaves(tree))}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix


@pytest.mark.parametrize("attention", ["default", "flash"])
def test_llama_forward_logits_match_jax(attention):
    jcfg, cfg = _configs()
    jparams, params = _params(jcfg, cfg)
    ids = _ids(1, 2)
    ref = np.asarray(jllama.forward(jcfg, jparams, jnp.asarray(ids)))
    fn = flash_attention if attention == "flash" else None
    got = llama.forward(cfg, params, torch.from_numpy(ids), attention_fn=fn)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("remat", [True, False])
def test_llama_loss_grads_match_jax(remat):
    jcfg, cfg = _configs(remat=remat)
    jparams, params = _params(jcfg, cfg, seed=2)
    batch = llama.causal_lm_batch(_ids(3, 2))
    jloss, jgrads = jax.value_and_grad(jllama.make_loss_fn(jcfg))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = llama.make_loss_fn(cfg)(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                   None)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = _flat(jgrads)
    for name, g in zip(_paths(params), grads):
        np.testing.assert_allclose(g.numpy(), ref[name], atol=1e-4, rtol=1e-4, err_msg=name)


def test_cross_entropy_and_batches_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, 2] = labels[1, 4] = -100
    for z_loss in (0.0, 1e-3):
        ref = jtf.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), z_loss=z_loss)
        got = tf.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                    z_loss=z_loss)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    ids = _ids(5, 3, seq=7)
    for port, jax_fn in ((llama.causal_lm_batch, jllama.causal_lm_batch),
                         (tf.causal_lm_batch, jtf.causal_lm_batch)):
        got, ref = port(ids), jax_fn(ids)
        for key in ("input_ids", "labels"):
            np.testing.assert_array_equal(got[key], np.asarray(ref[key]))
    assert llama.causal_lm_batch(ids)["labels"].shape == (3, 7)
    assert tf.causal_lm_batch(ids)["labels"].shape == (3, 6)
    jcfg, cfg = _configs()
    assert llama.flops_per_token(cfg, 2048) == jllama.flops_per_token(jcfg, 2048)


def _config(**kw):
    conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "bf16": {"enabled": False}, "steps_per_print": 100,
            "optimizer": {"type": "fused_adam", "params": {"lr": LR, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_max_lr": LR, "warmup_num_steps": 5}}}
    conf.update(kw)
    return conf


def _assert_params_close(got_tree, ref_tree, lrs):
    """Every element within 2 x sum(lr) (Adam's m/sqrt(v) turns a sign flip
    of a near-zero grad into a full-lr step) and 99.9 % within 1e-5."""
    ref = _flat(ref_tree)
    worst, close, total = 0.0, 0, 0
    for name, p in zip(_paths(got_tree), tree_leaves(got_tree)):
        diff = np.abs(p.detach().numpy() - ref[name])
        worst = max(worst, float(diff.max()))
        close += int((diff <= 1e-5).sum())
        total += diff.size
    assert worst <= 2 * sum(lrs), worst
    assert close >= 0.999 * total, close / total


def test_train_batch_matches_jax_engine(one_device):
    jcfg, cfg = _configs()
    jparams, params = _params(jcfg, cfg, seed=6)
    conf = _config()
    jengine, _, _, jsched = deepspeed_tpu.initialize(loss_fn=jllama.make_loss_fn(jcfg),
                                                     model_parameters=jparams, config=conf,
                                                     topology=one_device)
    engine, optimizer, loader, sched = deepspeed_tpu_torch.initialize(
        loss_fn=llama.make_loss_fn(cfg), model_parameters=params, config=conf, device="cpu")
    assert loader is None and optimizer.name == "fused_adam" and optimizer.step_fn is not None
    lrs = []
    for step in range(3):
        batch = llama.causal_lm_batch(_ids(10 + step, 4))
        jm = jengine.train_batch(batch)
        m = engine.train_batch(batch)
        np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-5)
        np.testing.assert_allclose(float(m.grad_norm), float(jm.grad_norm), rtol=1e-4)
        np.testing.assert_allclose(m.lr, float(jm.lr), rtol=1e-6)  # float32 log: an ulp
        lrs.append(m.lr)
    assert engine.global_steps == 3 and engine.global_samples == 12 and engine.state.step == 3
    assert sched.last_step == jsched.last_step == 3
    np.testing.assert_allclose(engine.lr, jengine.lr, rtol=1e-6)
    assert engine.get_global_grad_norm() == float(m.grad_norm)
    _assert_params_close(engine.state.params, jengine.state.params, lrs)
    batch = llama.causal_lm_batch(_ids(20, 4))
    np.testing.assert_allclose(float(engine.eval_batch(batch)),
                               float(jengine.eval_batch(batch)), rtol=1e-5)


def test_resume_from_jax_state(one_device):
    """Two JAX steps, then the port continues from the JAX params and AdamState
    (``adam_state_from_jax``) and matches the JAX engine's third step."""
    jcfg, cfg = _configs()
    jparams, _ = _params(jcfg, cfg, seed=7)
    conf = _config(gradient_clipping=0.0)
    jengine, *_ = deepspeed_tpu.initialize(loss_fn=jllama.make_loss_fn(jcfg),
                                           model_parameters=jparams, config=conf,
                                           topology=one_device)
    for step in range(2):
        jengine.train_batch(llama.causal_lm_batch(_ids(30 + step, 4)))
    state_np = jax.tree_util.tree_map(np.asarray, jengine.state)
    params = llama.params_from_jax(cfg, state_np.params, "cpu")
    engine, *_ = deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg),
                                                model_parameters=params, config=conf,
                                                device="cpu")
    engine.state = TrainState(step=int(state_np.step), params=engine.state.params,
                              opt_state=adam_state_from_jax(state_np.opt_state, "cpu"))
    batch = llama.causal_lm_batch(_ids(32, 4))
    jm, m = jengine.train_batch(batch), engine.train_batch(batch)
    np.testing.assert_allclose(m.lr, float(jm.lr), rtol=1e-6)
    np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-5)
    _assert_params_close(engine.state.params, jengine.state.params, [m.lr])


def test_adamw_delta_form_and_gas_layout_match_jax(one_device):
    """The delta-form optimizer (no fused step), no scheduler, a batch given as
    [gas, micro, ...]."""
    jcfg, cfg = _configs(remat=False)
    jparams, params = _params(jcfg, cfg, seed=8)
    conf = _config(optimizer={"type": "adamw", "params": {"lr": LR, "weight_decay": 0.1}},
                   scheduler=None, train_batch_size=4)
    jengine, *_ = deepspeed_tpu.initialize(loss_fn=jllama.make_loss_fn(jcfg),
                                           model_parameters=jparams, config=conf,
                                           topology=one_device)
    engine, optimizer, _, _ = deepspeed_tpu_torch.initialize(
        loss_fn=llama.make_loss_fn(cfg), model_parameters=params, config=conf, device="cpu")
    assert optimizer.step_fn is None
    batch = llama.causal_lm_batch(_ids(40, 4))
    gas_batch = {k: v.reshape(2, 2, -1) for k, v in batch.items()}
    jm, m = jengine.train_batch(batch), engine.train_batch(gas_batch)
    np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-5)
    _assert_params_close(engine.state.params, jengine.state.params, [LR])


def test_engine_refuses_what_is_not_ported():
    _, cfg = _configs()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    kw = dict(loss_fn=llama.make_loss_fn(cfg), model_parameters=params)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            deepspeed_tpu_torch.initialize(config=_config(), **kw)  # device defaults to cuda
    with pytest.raises(NotImplementedError, match="dataloader"):
        deepspeed_tpu_torch.initialize(config=_config(), training_data=[1], device="cpu", **kw)
    for bad in ({"fp16": {"enabled": True}},
                {"data_efficiency": {"enabled": True}}, {"telemetry": {}},
                {"ops_server": {"enabled": True}},
                {"zero_optimization": {"stage": 3, "offload_optimizer": {"device": "cpu"}}},
                {"optimizer": {"type": "onebitadam", "params": {"lr": 1e-3}}}):
        with pytest.raises(NotImplementedError):
            deepspeed_tpu_torch.initialize(config=_config(**bad), device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown config field"):
        load_config(_config(zero_optimization={"stage": 2, "bucket": 1}))


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_every_zero_stage_runs_the_same_step(stage):
    _, cfg = _configs()
    params = llama.init_params(cfg, torch.Generator().manual_seed(1))
    batch = llama.causal_lm_batch(_ids(50, 4))
    losses = []
    for conf in (_config(), _config(zero_optimization={"stage": stage})):
        engine, *_ = deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg),
                                                    model_parameters=params, config=conf,
                                                    device="cpu")
        assert engine.compute_dtype == torch.float32
        losses.append([float(engine.train_batch(batch).loss) for _ in range(2)])
    assert losses[0] == losses[1]
    assert engine.zero_stage == stage


def test_batch_triple_resolution():
    assert load_config({"train_batch_size": 8, "gradient_accumulation_steps": 4}) \
        .resolve_batch_sizes(1) == (8, 2, 4)
    assert load_config({"train_micro_batch_size_per_gpu": 3}).resolve_batch_sizes(1) == (3, 3, 1)
    with pytest.raises(ValueError, match="train_batch_size"):
        load_config({"train_batch_size": 8, "train_micro_batch_size_per_gpu": 3,
                     "gradient_accumulation_steps": 2}).resolve_batch_sizes(1)
    assert load_config({"train_batch_size": 2}).precision_dtype == torch.bfloat16


# block 8 over SEQ = 32: four blocks a row, per-head global columns, GQA (4 q / 2 kv heads)
SPARSE = {"mode": "fixed", "block": 8, "different_layout_per_head": True, "num_local_blocks": 2,
          "num_global_blocks": 1, "num_different_global_patterns": 2,
          "attention": "unidirectional"}
ADAM8 = {"type": "fused_adam8bit", "params": {"lr": LR, "weight_decay": 0.01}}


def test_sparse_attention_and_adam8bit_train_batch_match_jax_engine(one_device):
    """The slice's two config levers together: the block-sparse kernels as the
    engine's attention and AdamW with 8-bit moments, 3 steps."""
    jcfg, cfg = _configs()
    jparams, params = _params(jcfg, cfg, seed=9)
    conf = _config(sparse_attention=SPARSE, optimizer=ADAM8)
    jengine, *_ = deepspeed_tpu.initialize(loss_fn=jllama.make_loss_fn(jcfg),
                                           model_parameters=jparams, config=conf,
                                           topology=one_device)
    engine, optimizer, _, _ = deepspeed_tpu_torch.initialize(
        loss_fn=llama.make_loss_fn(cfg), model_parameters=params, config=conf, device="cpu")
    assert optimizer.name == "fused_adam8bit" and optimizer.step_fn is not None
    counts = (sparse.sparse_fwd.launches, sparse.sparse_bwd_dq.launches)
    lrs = []
    for step in range(3):
        batch = llama.causal_lm_batch(_ids(60 + step, 4))
        jm, m = jengine.train_batch(batch), engine.train_batch(batch)
        np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-4)
        np.testing.assert_allclose(float(m.grad_norm), float(jm.grad_norm), rtol=1e-4)
        lrs.append(m.lr)
    assert (sparse.sparse_fwd.launches, sparse.sparse_bwd_dq.launches) == counts  # CPU: plain
    assert tf.configured_attention_engaged()
    _assert_params_close(engine.state.params, jengine.state.params, lrs)
    dense, *_ = deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg),
                                               model_parameters=params, config=_config(),
                                               device="cpu")
    batch = llama.causal_lm_batch(_ids(70, 4))
    assert float(dense.eval_batch(batch)) != float(
        deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg), model_parameters=params,
                                       config=conf, device="cpu")[0].eval_batch(batch))


def test_resume_adam8bit_from_jax_state(one_device):
    """Two JAX steps with fused_adam8bit, then the port continues from the
    JAX params and Adam8bitState and matches the JAX engine's third step."""
    jcfg, cfg = _configs()
    jparams, _ = _params(jcfg, cfg, seed=10)
    conf = _config(gradient_clipping=0.0, optimizer=ADAM8)
    jengine, *_ = deepspeed_tpu.initialize(loss_fn=jllama.make_loss_fn(jcfg),
                                           model_parameters=jparams, config=conf,
                                           topology=one_device)
    for step in range(2):
        jengine.train_batch(llama.causal_lm_batch(_ids(80 + step, 4)))
    state_np = jax.tree_util.tree_map(np.asarray, jengine.state)
    engine, *_ = deepspeed_tpu_torch.initialize(
        loss_fn=llama.make_loss_fn(cfg), model_parameters=llama.params_from_jax(
            cfg, state_np.params, "cpu"), config=conf, device="cpu")
    engine.state = TrainState(step=int(state_np.step), params=engine.state.params,
                              opt_state=adam8bit_state_from_jax(state_np.opt_state, "cpu"))
    batch = llama.causal_lm_batch(_ids(82, 4))
    jm, m = jengine.train_batch(batch), engine.train_batch(batch)
    np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-5)
    _assert_params_close(engine.state.params, jengine.state.params, [m.lr])


def _grads(cfg, params, batch, attention_scope):
    loss_fn = tf.scoped_default_attention(llama.make_loss_fn(cfg), attention_scope)
    leaves = [p.detach().clone().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    tree = tree_map(lambda _: next(it), params)
    loss = loss_fn(tree, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def test_remat_recompute_runs_the_configured_sparse_attention():
    """Under a configured sparse function, the grads with remat (the layer is
    recomputed in the backward, after the scope has closed) equal those
    without, and differ from dense attention's: the recompute stayed sparse."""
    _, cfg = _configs(remat=False)
    params = llama.init_params(cfg, torch.Generator().manual_seed(3))
    batch = llama.causal_lm_batch(_ids(90, 2))
    sparse_fn = sparse.make_config_attention_fn(SparseAttentionConfig(**SPARSE))
    tf.set_default_attention(None)
    plain = _grads(cfg, params, batch, sparse_fn)
    assert tf.configured_attention_engaged()
    remat = _grads(dataclasses.replace(cfg, remat=True), params, batch, sparse_fn)
    dense = _grads(dataclasses.replace(cfg, remat=True), params, batch, None)
    for a, b in zip(plain, remat):
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-6)
    assert any(not np.allclose(a, b, atol=1e-4) for a, b in zip(plain, dense))
    assert tf._CONFIGURED_ATTENTION["fn"] is None  # the scope closed after each call

"""fp16 loss scaling and the sgd, adagrad and lamb optimizers of the port on
the CPU against the JAX package: ``init_loss_scale``, ``update_loss_scale``
and ``has_overflow`` state for state on seeded overflow sequences; tiny-Llama
fp16 ``train_batch`` against the JAX engine with a static scale (no skips;
every step skipped; sgd, whose update shows the unscale), a dynamic one
(skips, halvings, growth) carried across the packages' checkpoints, grad
norms held to JAX's on every step; and three delta-form steps of sgd
(momentum, Nesterov), adagrad and lamb."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.ops import _pallas
from deepspeed_tpu.parallel.mesh import MeshTopology, reset_topology
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime import optimizers as joptim
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.runtime import config, optimizers
from deepspeed_tpu_torch.runtime.checkpointing import flatten_with_keys
from deepspeed_tpu_torch.runtime.engine import TrainState
from deepspeed_tpu_torch.runtime.tree import tree_leaves

from .test_torch_train import (LR, _assert_params_close, _config, _flat, _ids, _no_remat_configs,
                               _params, _paths)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(_pallas, "INTERPRET", True)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tiny engines' ops are far smaller than a
    thread pool's wake-up, and the suite runs several workers on the box's
    cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def one_device():
    topo = MeshTopology.from_axis_dict({"data": 1}, devices=jax.devices()[:1])
    yield topo
    reset_topology()


SCALERS = {
    "hysteresis_1": {"initial_scale_power": 12, "hysteresis": 1, "loss_scale_window": 4},
    "hysteresis_2": {"initial_scale_power": 12, "hysteresis": 2, "loss_scale_window": 4},
    "consecutive_hysteresis": {"initial_scale_power": 12, "hysteresis": 3,
                               "consecutive_hysteresis": True, "loss_scale_window": 3},
    "window_growth": {"initial_scale_power": 2, "hysteresis": 2, "loss_scale_window": 2},
    "minimum": {"initial_scale_power": 3, "hysteresis": 1, "min_loss_scale": 2.0,
                "loss_scale_window": 50},
    "static": {"loss_scale": 128.0, "hysteresis": 1},
}


@pytest.mark.parametrize("case", sorted(SCALERS))
def test_loss_scaler_matches_jax_state_for_state(case):
    fp16 = dict(SCALERS[case], enabled=True)
    cfg, jcfg = config.FP16Config(**fp16), jconfig.FP16Config(**fp16)
    state, jstate = optimizers.init_loss_scale(cfg), joptim.init_loss_scale(jcfg)
    update = jax.jit(lambda s, o: joptim.update_loss_scale(s, o, jcfg))
    flags = np.random.default_rng(len(case)).random(48) < 0.35
    flags[:6] = [True, True, True, False, False, False]  # halvings, then growth
    scales = set()
    for overflow in [None] + list(flags):
        if overflow is not None:
            state = optimizers.update_loss_scale(state, bool(overflow), cfg)
            jstate = update(jstate, jnp.asarray(overflow))
        assert state == optimizers.loss_scale_from_jax(jax.tree_util.tree_map(np.asarray, jstate))
        assert type(state.cur_scale) is float and type(state.hysteresis) is int
        scales.add(state.cur_scale)
    assert (len(scales) == 1) == (case == "static")
    if case == "minimum":
        assert min(scales) == 2.0
    if case == "window_growth":
        assert max(scales) > 4.0


def test_has_overflow_matches_jax():
    rng = np.random.default_rng(0)
    for bad in (None, np.inf, -np.inf, np.nan):
        tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
                "b": {"c": rng.normal(size=(5, )).astype(np.float16)}}
        if bad is not None:
            tree["b"]["c"][2] = bad
        got = optimizers.has_overflow({"a": torch.from_numpy(tree["a"]),
                                       "b": {"c": torch.from_numpy(tree["b"]["c"])}})
        assert got.dtype == torch.bool and got.dim() == 0
        assert bool(got) == bool(joptim.has_overflow(tree)) == (bad is not None)


def _assert_params_within(got_tree, ref_tree, lrs, init=None):
    """fp16 Adam: every element within 2 x sum(lr) and, given the params
    ``init`` before the steps, the update's sign equal to JAX's in 99 % of
    the elements (Adam moves each by about lr, so the first bound alone
    would pass an update of the wrong sign).  The grads are rounded to fp16
    in different places by XLA and by torch on the CPU, so the fp32 runs'
    second bound (99.9 % within 1e-5) does not apply."""
    ref = _flat(ref_tree)
    worst, agree, total = 0.0, 0, 0
    for name, p in zip(_paths(got_tree), tree_leaves(got_tree)):
        got = p.detach().numpy()
        worst = max(worst, float(np.abs(got - ref[name]).max()))
        if init is not None:
            agree += int((np.sign(got - init[name]) == np.sign(ref[name] - init[name])).sum())
            total += got.size
    assert worst <= 2 * sum(lrs), worst
    assert init is None or agree >= 0.99 * total, agree / total


def _assert_deltas_close(got_tree, ref_tree, init, rel=1e-2):
    """fp16 sgd: each leaf's update within ``rel`` of the largest element of
    JAX's update of that leaf.  sgd's update is lr x the unscaled grad, so a
    grad left scaled, or unscaled twice, misses it by the scale."""
    ref = _flat(ref_tree)
    for name, p in zip(_paths(got_tree), tree_leaves(got_tree)):
        delta, ref_delta = p.detach().numpy() - init[name], ref[name] - init[name]
        worst = float(np.abs(delta - ref_delta).max())
        assert worst <= rel * float(np.abs(ref_delta).max()), (name, worst)


def _assert_norms_match(m, jm):
    """The grad norm is taken after the unscale (by gas x scale) and before
    clipping: held to JAX's at the loss's fp16 tolerance, and non-finite in
    both on an overflow."""
    norm, jnorm = float(m.grad_norm), float(jm.grad_norm)
    assert np.isfinite(norm) == np.isfinite(jnorm), (norm, jnorm)
    if np.isfinite(jnorm):
        np.testing.assert_allclose(norm, jnorm, rtol=2e-3)


def _engines(one_device, fp16, seed, **conf_kw):
    jcfg, cfg = _no_remat_configs()
    jparams, params = _params(jcfg, cfg, seed=seed)
    conf = _config(fp16=dict(fp16, enabled=True), **conf_kw)
    conf.pop("bf16")  # bf16 defaults to off when fp16 is on, in both packages
    jengine = deepspeed_tpu.initialize(loss_fn=jllama.make_loss_fn(jcfg), model_parameters=jparams,
                                       config=conf, topology=one_device)[0]
    engine = deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg),
                                            model_parameters=params, config=conf,
                                            device="cpu")[0]
    assert engine.compute_dtype == torch.float16 and engine.fp16_enabled
    return jengine, engine


def test_fp16_static_scale_steps_match_jax(one_device):
    """A static scale of 128: no step skips in either package, losses and
    grad norms within rtol 2e-3 (fp16 rounding differs between XLA and torch
    on the CPU), params every element within 2 x sum(lr) and updates of
    JAX's sign."""
    jengine, engine = _engines(one_device, {"loss_scale": 128}, seed=21)
    init = _flat(jax.tree_util.tree_map(np.asarray, jengine.state.params))
    lrs = []
    for step in range(3):
        batch = llama.causal_lm_batch(_ids(200 + step, 4))
        jm, m = jengine.train_batch(batch), engine.train_batch(batch)
        assert not m.skipped and not bool(jm.skipped) and m.loss_scale == 128.0
        np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=2e-3)
        _assert_norms_match(m, jm)
        lrs.append(m.lr)
    assert engine.state.step == int(jengine.state.step) == 3
    assert engine.state.loss_scale == optimizers.LossScaleState(128.0, 0, 2)
    _assert_params_within(engine.state.params, jengine.state.params, lrs, init)


def test_fp16_sgd_steps_match_jax(one_device):
    """sgd with momentum at a static scale of 128: its update is lr x the
    unscaled grad, so it shows the unscale that Adam's m/sqrt(v) and the
    clipping hide.  After one step the params are held to JAX at the fp32
    runs' tolerance, after the second (momentum) each leaf's update within
    1e-2 of JAX's largest; grad norms at rtol 2e-3."""
    sgd = {"type": "sgd", "params": {"lr": 0.05, "momentum": 0.9}}
    jengine, engine = _engines(one_device, {"loss_scale": 128}, seed=26, optimizer=sgd,
                               scheduler=None)
    init = _flat(jax.tree_util.tree_map(np.asarray, jengine.state.params))
    for step in range(2):
        batch = llama.causal_lm_batch(_ids(260 + step, 4))
        jm, m = jengine.train_batch(batch), engine.train_batch(batch)
        assert not m.skipped and not bool(jm.skipped)
        np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=2e-3)
        _assert_norms_match(m, jm)
        if step == 0:
            _assert_params_close(engine.state.params, jengine.state.params, [0.05])
    _assert_deltas_close(engine.state.params, jengine.state.params, init)


def test_fp16_overflow_skips_every_step_like_jax(one_device):
    """A static scale of 2^30 overflows every step in both packages: the step
    count, params and moments stay put, the host counters advance."""
    jengine, engine = _engines(one_device, {"loss_scale": 2.0**30}, seed=22)
    before = {k: v.clone() for k, v in _flat_torch(engine.state).items()}
    jbefore = jax.tree_util.tree_map(np.asarray, (jengine.state.params, jengine.state.opt_state))
    for step in range(2):
        batch = llama.causal_lm_batch(_ids(210 + step, 4))
        jm, m = jengine.train_batch(batch), engine.train_batch(batch)
        assert m.skipped and bool(jm.skipped)
        np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=2e-3)
    assert engine.state.step == int(jengine.state.step) == 0
    assert engine.global_steps == jengine.global_steps == 2
    assert engine.global_samples == 8 and engine.lr_scheduler.last_step == 2
    for key, value in _flat_torch(engine.state).items():
        assert torch.equal(value, before[key]), key
    for a, b in zip(jax.tree_util.tree_leaves(jbefore),
                    jax.tree_util.tree_leaves((jengine.state.params, jengine.state.opt_state))):
        np.testing.assert_array_equal(a, np.asarray(b))


def _flat_torch(state: TrainState):
    return {k: v for k, v in flatten_with_keys((state.params, state.opt_state))
            if isinstance(v, torch.Tensor)}


def test_fp16_dynamic_scale_matches_jax_across_checkpoints(one_device, tmp_path):
    """A dynamic scale from 2^20 with hysteresis 1 and a window of 2: the
    same steps skip in both packages and the scale follows the same path;
    the loss-scale leaves carry across the packages' checkpoints both
    ways, and the next step matches."""
    fp16 = {"initial_scale_power": 20, "hysteresis": 1, "loss_scale_window": 2}
    jengine, engine = _engines(one_device, fp16, seed=23)
    init = _flat(jax.tree_util.tree_map(np.asarray, jengine.state.params))
    skips, lrs = [], []
    for step in range(9):
        batch = llama.causal_lm_batch(_ids(220 + step, 4))
        jm, m = jengine.train_batch(batch), engine.train_batch(batch)
        assert m.skipped == bool(jm.skipped) and m.loss_scale == float(jm.loss_scale)
        np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=2e-3)
        _assert_norms_match(m, jm)
        skips.append(m.skipped)
        lrs += [] if m.skipped else [m.lr]
        jls = optimizers.loss_scale_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                    jengine.state.loss_scale))
        assert engine.state.loss_scale == jls and engine.state.step == int(jengine.state.step)
    assert skips[0] and not all(skips), skips
    _assert_params_within(engine.state.params, jengine.state.params, lrs, init)
    engine.save_checkpoint(str(tmp_path / "port"))
    jengine.save_checkpoint(str(tmp_path / "jax"))
    for key in ("cur_scale", "growth_counter", "hysteresis"):
        path = f"global_step9/loss_scale.{key}.npy"
        assert (tmp_path / "port" / path).read_bytes() == (tmp_path / "jax" / path).read_bytes()
    jcfg, cfg = _no_remat_configs()
    other = deepspeed_tpu_torch.initialize(
        loss_fn=llama.make_loss_fn(cfg), model_parameters=_params(jcfg, cfg, seed=24)[1],
        config=dict(_config(fp16=dict(fp16, enabled=True)), bf16={"enabled": False}),
        device="cpu")[0]
    other.load_checkpoint(str(tmp_path / "jax"))
    assert other.state.loss_scale == engine.state.loss_scale
    jengine.load_checkpoint(str(tmp_path / "port"))
    batch = llama.causal_lm_batch(_ids(240, 4))
    jm, m, m_other = jengine.train_batch(batch), engine.train_batch(batch), other.train_batch(batch)
    assert m.skipped == m_other.skipped == bool(jm.skipped)
    np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=2e-3)
    np.testing.assert_allclose(float(m_other.loss), float(jm.loss), rtol=2e-3)


DELTA_OPTIMIZERS = {
    "sgd_momentum": {"type": "sgd", "params": {"lr": 0.05, "momentum": 0.9,
                                               "weight_decay": 0.01}},
    "sgd_nesterov": {"type": "sgd", "params": {"lr": 0.05, "momentum": 0.9, "nesterov": True}},
    "adagrad": {"type": "adagrad", "params": {"lr": 0.01, "weight_decay": 0.01}},
    "lamb": {"type": "lamb", "params": {"lr": LR, "weight_decay": 0.01}},
}


@pytest.mark.parametrize("name", sorted(DELTA_OPTIMIZERS))
def test_sgd_adagrad_lamb_match_jax(name, one_device):
    """Three delta-form steps against the JAX engine's ``update``, fp32; the
    JAX optimizer state comes over through ``*_state_from_jax`` and agrees
    with the port's leaf for leaf."""
    jcfg, cfg = _no_remat_configs()
    jparams, params = _params(jcfg, cfg, seed=25)
    conf = _config(optimizer=DELTA_OPTIMIZERS[name], scheduler=None)
    jengine = deepspeed_tpu.initialize(loss_fn=jllama.make_loss_fn(jcfg), model_parameters=jparams,
                                       config=conf, topology=one_device)[0]
    engine, optimizer, _, _ = deepspeed_tpu_torch.initialize(
        loss_fn=llama.make_loss_fn(cfg), model_parameters=params, config=conf, device="cpu")
    assert optimizer.step_fn is None and optimizer.name == DELTA_OPTIMIZERS[name]["type"]
    lr = DELTA_OPTIMIZERS[name]["params"]["lr"]
    for step in range(3):
        batch = llama.causal_lm_batch(_ids(250 + step, 4))
        jm, m = jengine.train_batch(batch), engine.train_batch(batch)
        np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-5)
    _assert_params_close(engine.state.params, jengine.state.params, [lr] * 3)
    jstate = jax.tree_util.tree_map(np.asarray, jengine.state.opt_state)
    from_jax = {"sgd": optimizers.sgd_state_from_jax, "adagrad": optimizers.adagrad_state_from_jax,
                "lamb": optimizers.lamb_state_from_jax}[optimizer.name](jstate, "cpu")
    assert type(from_jax) is type(engine.state.opt_state)
    got, ref = dict(flatten_with_keys(engine.state.opt_state)), dict(flatten_with_keys(from_jax))
    assert list(got) == list(ref) and len(got) >= 9
    for key, value in ref.items():
        if isinstance(value, int):  # LAMB's step
            assert got[key] == value == 3
        else:
            np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=1e-3, atol=1e-5,
                                       err_msg=key)

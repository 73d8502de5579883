"""The port's Lion against the JAX package on the same numpy inputs: the
fused flat step (its plain version on the CPU) against the JAX
``fused_lion_flat`` running its Pallas kernel in interpret mode, the
delta-form ``lion`` optimizer, and ``train_batch`` steps of
``deepspeed_tpu_torch.initialize`` against ``deepspeed_tpu.initialize`` with
``{"optimizer": {"type": "lion"}}``, from the start and resumed from a JAX
``LionState``.  fp32 throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.ops import _pallas
from deepspeed_tpu.ops.adam import fused_adam as jfused_adam
from deepspeed_tpu.parallel.mesh import MeshTopology, reset_topology
from deepspeed_tpu.runtime import optimizers as joptim
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.ops.adam import fused_adam, fused_lion_flat
from deepspeed_tpu_torch.runtime import optimizers
from deepspeed_tpu_torch.runtime.engine import TrainState
from deepspeed_tpu_torch.runtime.tree import tree_leaves

TOL = 1e-6  # the JAX package's own fused-optimizer kernel tolerance
VOCAB, SEQ, LR = 96, 32, 1e-3


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(_pallas, "INTERPRET", True)


@pytest.fixture
def one_device():
    """A one-device JAX topology (tests/conftest.py forces 8 CPU devices)."""
    topo = MeshTopology.from_axis_dict({"data": 1}, devices=jax.devices()[:1])
    yield topo
    reset_topology()


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_fused_lion_flat_matches_jax_kernel(grad_dtype, weight_decay):
    n = 1000  # not a multiple of 128: the JAX kernel pads, the port does not
    rng = np.random.default_rng(int(weight_decay * 10))
    p, m, g = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    m[:7] = g[:7] = 0.0  # sign(0) = 0: p moves by its decay alone
    tg, jg = torch.from_numpy(g), jnp.asarray(g)
    if grad_dtype == "bfloat16":
        tg, jg = tg.bfloat16(), jg.astype(jnp.bfloat16)
    hyper = dict(lr=1e-3, beta1=0.9, beta2=0.99, weight_decay=weight_decay)
    jp, jm = jfused_adam.fused_lion_flat(jnp.asarray(p), jnp.asarray(m), jg, **hyper)
    tp, tm = torch.from_numpy(p.copy()), torch.from_numpy(m.copy())
    launches = fused_lion_flat.launches
    out = fused_lion_flat(tp, tm, tg, **hyper)
    assert out[0] is tp and out[1] is tm  # in place
    assert fused_lion_flat.launches == launches  # the CPU path never launches
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(tp.numpy()[:7], p[:7] - np.float32(1e-3) * (
        np.float32(weight_decay) * p[:7]))


def test_lion_scalars_are_float32():
    lr, b1, b2, wd, omb1, omb2 = fused_adam.lion_scalars(1e-3, 0.9, 0.99, 0.1)
    assert omb1 == float(np.float32(1.0) - np.float32(0.9)) and omb1 != float(np.float32(0.1))
    assert (lr, b2) == (float(np.float32(1e-3)), float(np.float32(0.99)))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(8, 6)).astype(np.float32),
            "sub": {"b": rng.normal(size=(5, )).astype(np.float32),
                    "s": rng.normal(size=(3, 4, 2)).astype(np.float32)}}


@pytest.mark.parametrize("name", ["lion", "FusedLion"])
def test_lion_optimizer_matches_jax(name):
    jopt = joptim.get_optimizer(name, betas=(0.8, 0.95), weight_decay=0.1)
    opt = optimizers.get_optimizer(name, lr=1.0, betas=[0.8, 0.95], weight_decay=0.1)
    assert opt.name == "lion" and opt.step_fn is None  # delta form only, as in JAX
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    to_t = lambda t: jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)), t)
    jparams, params = to_j(_tree(0)), to_t(_tree(0))
    jstate, state = jopt.init(jparams), opt.init(params)
    for step in range(3):
        grads = _tree(step + 1)
        jupd, jstate = jopt.update(to_j(grads), jstate, jparams, jnp.float32(1e-2))
        upd, state = opt.update(to_t(grads), state, params, 1e-2)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, jupd)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
    for got, ref in zip(tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    for got, ref in zip(tree_leaves(state.exp_avg), jax.tree_util.tree_leaves(jstate.exp_avg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def _configs():
    shape = dict(vocab=VOCAB, hidden=64, layers=2, heads=4, kv_heads=2, seq=SEQ)
    return jllama.LlamaConfig.tiny(**shape), llama.LlamaConfig.tiny(**shape)


def _ids(seed, rows):
    return np.random.default_rng(seed).integers(0, VOCAB, (rows, SEQ)).astype(np.int32)


def _config(**kw):
    conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "bf16": {"enabled": False}, "steps_per_print": 100,
            "optimizer": {"type": "lion", "params": {"lr": LR, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_max_lr": LR, "warmup_num_steps": 5}}}
    conf.update(kw)
    return conf


def _assert_params_close(got_tree, ref_tree, lrs):
    """Every element within 2 x sum(lr) (a sign flip of a near-zero
    interpolation moves an element by 2 lr) and 99.9 % within 1e-5."""
    worst, close, total = 0.0, 0, 0
    for p, ref in zip(tree_leaves(got_tree), jax.tree_util.tree_leaves(ref_tree)):
        diff = np.abs(p.detach().numpy() - np.asarray(ref))
        worst = max(worst, float(diff.max()))
        close += int((diff <= 1e-5).sum())
        total += diff.size
    assert worst <= 2 * sum(lrs), worst
    assert close >= 0.999 * total, close / total


def test_lion_train_batch_matches_jax_engine(one_device):
    jcfg, cfg = _configs()
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    params = llama.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    conf = _config()
    jengine, *_ = deepspeed_tpu.initialize(loss_fn=jllama.make_loss_fn(jcfg),
                                           model_parameters=jparams, config=conf,
                                           topology=one_device)
    engine, optimizer, _, _ = deepspeed_tpu_torch.initialize(
        loss_fn=llama.make_loss_fn(cfg), model_parameters=params, config=conf, device="cpu")
    assert optimizer.name == "lion" and optimizer.step_fn is None
    lrs = []
    for step in range(3):
        batch = llama.causal_lm_batch(_ids(40 + step, 4))
        jm, m = jengine.train_batch(batch), engine.train_batch(batch)
        np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-5)
        lrs.append(m.lr)
    assert isinstance(engine.state.opt_state, optimizers.LionState)
    _assert_params_close(engine.state.params, jengine.state.params, lrs)
    # the momentum does not go through a sign: it agrees as the grads do
    for m, jm in zip(tree_leaves(engine.state.opt_state.exp_avg),
                     jax.tree_util.tree_leaves(jengine.state.opt_state.exp_avg)):
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-6, rtol=1e-4)


def test_lion_resumes_from_jax_state(one_device):
    """Two JAX steps, then the port continues from the JAX params and LionState
    (``lion_state_from_jax``) and matches the JAX engine's third step."""
    jcfg, cfg = _configs()
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(4))
    conf = _config(gradient_clipping=0.0)
    jengine, *_ = deepspeed_tpu.initialize(loss_fn=jllama.make_loss_fn(jcfg),
                                           model_parameters=jparams, config=conf,
                                           topology=one_device)
    for step in range(2):
        jengine.train_batch(llama.causal_lm_batch(_ids(50 + step, 4)))
    state_np = jax.tree_util.tree_map(np.asarray, jengine.state)
    params = llama.params_from_jax(cfg, state_np.params, "cpu")
    engine, *_ = deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg),
                                                model_parameters=params, config=conf,
                                                device="cpu")
    engine.state = TrainState(step=int(state_np.step), params=engine.state.params,
                              opt_state=optimizers.lion_state_from_jax(state_np.opt_state, "cpu"))
    batch = llama.causal_lm_batch(_ids(52, 4))
    jm, m = jengine.train_batch(batch), engine.train_batch(batch)
    np.testing.assert_allclose(m.lr, float(jm.lr), rtol=1e-6)
    np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-5)
    _assert_params_close(engine.state.params, jengine.state.params, [m.lr])


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


LION_FAULTS = {
    "stale_m": lambda before, out: (out[0], before[1]),
    "p_without_decay": lambda before, out: (out[0] + 1e-4 * 0.1 * before[0], out[1]),
    "one_flipped_sign": lambda before, out: (out[0].index_add(0, torch.tensor([5]),
                                                              torch.tensor([2e-4])), out[1]),
}


@pytest.mark.parametrize("fault", [None, *LION_FAULTS])
def test_chip_smoke_lion_check_sees_a_faulty_buffer(fault):
    """chip_smoke.py's Lion check (bit for bit), at the magnitudes its
    ``[kernel]`` phase draws, passes the plain result and rejects each fault."""
    smoke = _chip_smoke()
    *before, grad = smoke.lion_state(torch.Generator().manual_seed(0), 50_000, "cpu")
    plain = [x.clone() for x in before]
    fused_adam.fused_lion_flat_reference(*plain, grad, **smoke.LION_HYPER)
    if fault is None:
        assert smoke.check_bitwise("plain", [x.clone() for x in plain], plain, "pm") == 0.0
        return
    with pytest.raises(AssertionError, match="disagrees"):
        smoke.check_bitwise(fault, list(LION_FAULTS[fault](before, plain)), plain, "pm")

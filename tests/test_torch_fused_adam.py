"""The port's fused AdamW (its plain version on the CPU), optimizers, lr
schedules and clipping against the JAX package on the same numpy inputs;
the JAX fused AdamW runs its Pallas kernel in interpret mode.  Tolerance
1e-6, the JAX package's own fused-AdamW kernel test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import _pallas
from deepspeed_tpu.ops.adam import fused_adam as jfused_adam
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime import optimizers as joptim
from deepspeed_tpu_torch.ops.adam import fused_adam
from deepspeed_tpu_torch.runtime import lr_schedules, optimizers
from deepspeed_tpu_torch.runtime.tree import tree_leaves

TOL = 1e-6


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(_pallas, "INTERPRET", True)


def _state(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n).astype(np.float32), (rng.normal(size=n) * 0.1).astype(np.float32),
            (np.abs(rng.normal(size=n)) * 0.01).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [1, 7])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_fused_adamw_flat_matches_jax_kernel(grad_dtype, step, weight_decay):
    n = 1000  # not a multiple of 128: the JAX kernel pads, the port does not
    p, m, v, g = _state(step + int(weight_decay * 100), n)
    tg, jg = torch.from_numpy(g), jnp.asarray(g)
    if grad_dtype == "bfloat16":  # both round the same fp32 values to nearest even
        tg, jg = tg.bfloat16(), jg.astype(jnp.bfloat16)
    hyper = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=weight_decay, step=step)
    jp, jm, jv = jfused_adam.fused_adamw_flat(jnp.asarray(p), jnp.asarray(m), jnp.asarray(v), jg,
                                              **hyper)
    tp, tm, tv = (torch.from_numpy(x.copy()) for x in (p, m, v))
    launches = fused_adam.fused_adamw_flat.launches
    out = fused_adam.fused_adamw_flat(tp, tm, tv, tg, **hyper)
    assert out[0] is tp and out[1] is tm and out[2] is tv  # in place
    for got, ref in zip((tp, tm, tv), (jp, jm, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    assert fused_adam.fused_adamw_flat.launches == launches  # the CPU path never launches


def test_bias_corrections_are_float32():
    scal = fused_adam.adamw_scalars(1e-3, 0.9, 0.999, 1e-8, 0.0, 7)
    bc2 = np.float32(1.0) - np.power(np.float32(0.999), np.float32(7))
    assert scal[6] == float(bc2) and scal[6] != 1.0 - 0.999**7


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(8, 6)).astype(np.float32),
            "sub": {"b": rng.normal(size=(5, )).astype(np.float32),
                    "s": rng.normal(size=(3, 4, 2)).astype(np.float32)}}


def _jtree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _ttree(t):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)), t)


def _assert_trees_close(got, ref, tol=TOL):
    ref_leaves = jax.tree_util.tree_leaves(ref)
    for a, b in zip(tree_leaves(got), ref_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=tol)


@pytest.mark.parametrize("name,hyper", [
    ("fused_adam", {"betas": [0.9, 0.95], "weight_decay": 0.1}),
    ("adamw", {"weight_decay": 0.01, "eps": 1e-6}),
    ("adam", {"weight_decay": 0.01}),
])
def test_optimizer_steps_match_jax(name, hyper):
    params = _tree(0)
    jopt, topt = joptim.get_optimizer(name, **hyper), optimizers.get_optimizer(name, **hyper)
    jparams, tparams = _jtree(params), _ttree(params)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for step in range(3):
        grads = _tree(10 + step)
        lr = 1e-2 * (step + 1)
        if jopt.step_fn is not None:
            jparams, jstate = jopt.step_fn(_jtree(grads), jstate, jparams, jnp.float32(lr))
            tparams, tstate = topt.step_fn(_ttree(grads), tstate, tparams, lr)
        else:
            jup, jstate = jopt.update(_jtree(grads), jstate, jparams, jnp.float32(lr))
            jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, jup)
            tup, tstate = topt.update(_ttree(grads), tstate, tparams, lr)
            tparams = _add(tparams, tup)
    assert tstate.step == int(jstate.step) == 3
    _assert_trees_close(tparams, jparams)
    _assert_trees_close(tstate.exp_avg, jstate.exp_avg)
    _assert_trees_close(tstate.exp_avg_sq, jstate.exp_avg_sq)
    assert (topt.step_fn is not None) == (name == "fused_adam")


def _add(a, b):
    if isinstance(a, dict):
        return {k: _add(a[k], b[k]) for k in a}
    return a + b


def test_adam_state_from_jax_resumes():
    params = _tree(1)
    jopt = joptim.get_optimizer("fused_adam", weight_decay=0.1)
    jparams, jstate = _jtree(params), jopt.init(_jtree(params))
    jparams, jstate = jopt.step_fn(_jtree(_tree(2)), jstate, jparams, jnp.float32(1e-2))
    state = optimizers.adam_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    assert state.step == 1
    _assert_trees_close(state.exp_avg, jstate.exp_avg, tol=0)
    topt = optimizers.get_optimizer("fused_adam", weight_decay=0.1)
    tparams = _ttree(jax.tree_util.tree_map(np.asarray, jparams))
    tparams, state = topt.step_fn(_ttree(_tree(3)), state, tparams, 1e-2)
    jparams, jstate = jopt.step_fn(_jtree(_tree(3)), jstate, jparams, jnp.float32(1e-2))
    _assert_trees_close(tparams, jparams)
    assert state.step == 2


def test_get_optimizer_refuses_unported_and_unknown():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optimizers.get_optimizer("sgd")
    with pytest.raises(NotImplementedError):
        optimizers.get_optimizer("lamb")
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizers.get_optimizer("adamax")
    opt = optimizers.get_optimizer("FusedAdam", lr=1.0, torch_adam=True, betas=[0.8, 0.9])
    assert opt.name == "fused_adam" and opt.step_fn is not None
    assert optimizers.get_optimizer("fused_adam", bias_correction=False).step_fn is None


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clipping_match_jax(max_norm):
    grads = _tree(4)
    jclipped, jnorm = joptim.clip_by_global_norm(_jtree(grads), max_norm)
    tclipped, tnorm = optimizers.clip_by_global_norm(_ttree(grads), max_norm)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=TOL)
    np.testing.assert_allclose(float(optimizers.global_grad_norm(_ttree(grads))),
                               float(joptim.global_grad_norm(_jtree(grads))), rtol=TOL)
    _assert_trees_close(tclipped, jclipped)


SCHEDULES = [
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 3e-4, "warmup_num_steps": 10}),
    ("WarmupLR", {"warmup_max_lr": 3e-4, "warmup_num_steps": 10, "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 30, "warmup_max_lr": 1e-3, "warmup_num_steps": 7}),
    ("WarmupCosineLR", {"total_num_steps": 30, "warmup_num_steps": 5,
                        "warmup_min_ratio": 0.05, "cos_min_ratio": 0.01}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3, "cycle_first_step_size": 6,
                  "decay_lr_rate": 0.1, "decay_step_size": 3}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 4,
                     "lr_range_test_step_rate": 2.0, "lr_range_test_staircase": True}),
    (None, {}),
]


@pytest.mark.parametrize("kind,params", SCHEDULES,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(SCHEDULES)])
def test_lr_schedules_match_jax_in_float32(kind, params):
    jfn = jlr.build_lr_schedule(kind, params, base_lr=2e-4)
    fn = lr_schedules.build_lr_schedule(kind, params, base_lr=2e-4)
    for step in range(40):
        got, ref = fn(step), np.asarray(jfn(step))
        assert np.asarray(got).dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0, err_msg=f"step {step}")
    sched = lr_schedules.LRScheduler(fn)
    sched.step(3)
    assert sched.get_lr() == [float(fn(3))] and sched.state_dict() == {"last_step": 3}


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown scheduler"):
        lr_schedules.build_lr_schedule("Cosine", {})


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ADAMW_FAULTS = {
    "stale_v": lambda p0, m0, v0, out: (out[0], out[1], v0),
    "zero_v": lambda p0, m0, v0, out: (out[0], out[1], torch.zeros_like(v0)),
    "v_without_g2": lambda p0, m0, v0, out: (out[0], out[1], 0.999 * v0),
    "stale_m": lambda p0, m0, v0, out: (out[0], m0, out[2]),
    "p_without_decay": lambda p0, m0, v0, out: (out[0] + 3e-4 * 0.1 * p0, out[1], out[2]),
}


@pytest.mark.parametrize("fault", [None, *ADAMW_FAULTS])
def test_chip_smoke_adamw_check_sees_a_faulty_buffer(fault):
    """chip_smoke.py's AdamW check, at the magnitudes its ``[kernel]`` phase
    draws, passes the plain result and rejects each faulty buffer."""
    check_adamw = _chip_smoke().check_adamw
    g = torch.Generator().manual_seed(0)
    n = 100_000
    p0 = torch.randn(n, generator=g) * 0.02
    m0 = torch.randn(n, generator=g) * 1e-3
    v0 = torch.rand(n, generator=g) * 1e-6
    grad = torch.randn(n, generator=g) * 1e-3
    plain = [x.clone() for x in (p0, m0, v0)]
    fused_adam.fused_adamw_flat_reference(*plain, grad, lr=3e-4, beta1=0.9, beta2=0.999,
                                          eps=1e-8, weight_decay=0.1, step=3)
    if fault is None:
        assert check_adamw("plain", [x.clone() for x in plain], plain) == 0.0
        return
    with pytest.raises(AssertionError, match="disagrees"):
        check_adamw(fault, list(ADAMW_FAULTS[fault](p0, m0, v0, plain)), plain)

"""The port's AdamW with 8-bit moments (its plain version on the CPU) against
the JAX package's Pallas kernel run in interpret mode, on the same numpy
inputs; the ``fused_adam8bit`` optimizer against the JAX optimizer; and the
check that ``chip_smoke.py`` holds the CUDA kernel to.  The int8 codes may
differ by 1 where XLA's CPU code rounds a product differently (a contracted
multiply-add); the scales and p agree at rtol 1e-6 plus 1e-6 of the buffer's
largest value (an element of p near 0 is a few ulps of the largest apart)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import _pallas
from deepspeed_tpu.ops.adam import adam8bit as jadam8
from deepspeed_tpu.runtime import optimizers as joptim
from deepspeed_tpu_torch.ops.adam import adam8bit
from deepspeed_tpu_torch.runtime import optimizers
from deepspeed_tpu_torch.runtime.tree import tree_leaves

TOL = 1e-6
MAX_CODE_FLIPS = 0.002  # share of codes one apart from XLA's


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(_pallas, "INTERPRET", True)


def _state(seed, n):
    """p, grad, int8 codes and scales of a state some steps in."""
    rng = np.random.default_rng(seed)
    groups = -(-n // adam8bit.GROUP)
    p = (rng.normal(size=n) * 0.02).astype(np.float32)
    g = (rng.normal(size=n) * 1e-3).astype(np.float32)
    m8 = rng.integers(-127, 128, (groups, adam8bit.GROUP)).astype(np.int8)
    v8 = rng.integers(0, 128, (groups, adam8bit.GROUP)).astype(np.int8)
    sm = (rng.random((groups, 1)) * 1e-3 / 127).astype(np.float32)
    sv = (rng.random((groups, 1)) * 1e-3 / 127).astype(np.float32)
    return p, g, m8, v8, sm, sv


def _assert_close(got, ref, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=TOL * float(np.abs(ref).max()), rtol=TOL,
                               err_msg=what)


def _assert_codes_close(got, ref, what):
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    flips = int((diff != 0).sum())
    assert diff.max() <= 1, f"{what}: a code {diff.max()} apart"
    assert flips <= MAX_CODE_FLIPS * diff.size, f"{what}: {flips} of {diff.size} codes differ"
    return flips


@pytest.mark.parametrize("n", [1000, 2048 + 17, 4096])
@pytest.mark.parametrize("step", [1, 5])
@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_fused_adamw8bit_flat_matches_jax_kernel(n, step, grad_dtype):
    p, g, m8, v8, sm, sv = _state(n + step, n)
    tg, jg = torch.from_numpy(g), jnp.asarray(g)
    if grad_dtype == "bfloat16":  # both round the same fp32 values to nearest even
        tg, jg = tg.bfloat16(), jg.astype(jnp.bfloat16)
    hyper = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01, step=step)
    ref = jadam8.fused_adamw8bit_flat(*(jnp.asarray(x) for x in (p, m8, v8, sm, sv)), jg,
                                      use_kernel=True, **hyper)
    bufs = [torch.from_numpy(x.copy()) for x in (p, m8, v8, sm, sv)]
    launches = adam8bit.fused_adamw8bit_flat.launches
    out = adam8bit.fused_adamw8bit_flat(*bufs, tg, **hyper)
    assert all(a is b for a, b in zip(out, bufs))  # in place
    assert adam8bit.fused_adamw8bit_flat.launches == launches  # the CPU path never launches
    jp, jm8, jv8, jsm, jsv = (np.asarray(x) for x in ref)
    _assert_close(bufs[0].numpy(), jp, "p")
    _assert_codes_close(bufs[1].numpy(), jm8, "m codes")
    _assert_codes_close(bufs[2].numpy(), jv8, "sqrt(v) codes")
    _assert_close(bufs[3].numpy(), jsm, "m scales")
    _assert_close(bufs[4].numpy(), jsv, "sqrt(v) scales")


def test_codes_from_zero_state_equal_jax_over_steps():
    """From zeroed moments over three steps (tail group included): the codes
    XLA computes differ from the port's in at most a few places, each by 1,
    and p stays within the limit."""
    n = 3000
    rng = np.random.default_rng(0)
    p = rng.normal(size=n).astype(np.float32)
    jstate = [jnp.asarray(p), *jadam8.init_quantized_moment(n)[:1],
              *jadam8.init_quantized_moment(n)[:1], *jadam8.init_quantized_moment(n)[1:],
              *jadam8.init_quantized_moment(n)[1:]]
    m8, sm = adam8bit.init_quantized_moment(n)
    v8, sv = adam8bit.init_quantized_moment(n)
    np.testing.assert_array_equal(m8.numpy(), np.asarray(jstate[1]))
    np.testing.assert_array_equal(sm.numpy(), np.asarray(jstate[3]))
    bufs = [torch.from_numpy(p.copy()), m8, v8, sm, sv]
    flips = 0
    for step in (1, 2, 3):
        g = rng.normal(size=n).astype(np.float32)
        jstate = list(jadam8.fused_adamw8bit_flat(*jstate, jnp.asarray(g), lr=1e-2,
                                                  weight_decay=0.01, step=step))
        adam8bit.fused_adamw8bit_flat(*bufs, torch.from_numpy(g), lr=1e-2, weight_decay=0.01,
                                      step=step)
        _assert_close(bufs[0].numpy(), jstate[0], f"p, step {step}")
        for i in (1, 2):
            flips += _assert_codes_close(bufs[i].numpy(), np.asarray(jstate[i]), f"step {step}")
    m, v = adam8bit.dequantize_moments(*bufs[1:], n)
    jm, jv = jadam8.dequantize_moments(*jstate[1:], n)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=2 * float(bufs[3].max()), rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0,
                               atol=3 * float(bufs[4].max()) * float(np.sqrt(np.asarray(jv).max())))
    assert flips <= 12


def test_requant_rounds_half_to_even():
    x = torch.tensor([[2.5, -0.5, 127.0, 1.5] + [0.0] * 1020])
    q, scale = adam8bit._requant(x, torch.tensor(127.0))
    assert scale.item() == 1.0 and q[0, :4].tolist() == [2, 0, 127, 2]
    q0, scale0 = adam8bit._requant(torch.zeros((1, 8)), torch.tensor(127.0))
    assert scale0.item() == 1.0 and not q0.any()


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(40, 30)) * scale).astype(np.float32),
            "sub": {"b": (rng.normal(size=(5, )) * scale).astype(np.float32),
                    "s": (rng.normal(size=(3, 400, 2)) * scale).astype(np.float32)}}


def _jtree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _ttree(t):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)), t)


def _assert_trees_close(got, ref, tol=TOL):
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=tol)


@pytest.mark.parametrize("form", ["step_fn", "update"])
def test_fused_adam8bit_optimizer_matches_jax(form):
    """Three steps of the optimizer.  ``step_fn``: the JAX Pallas kernel
    against the port's kernel path (plain on the CPU).  ``update``: the delta
    form, whose JAX math is the XLA fallback with ``1 - beta`` folded in
    double precision (1.3e-5 relative apart from the kernel's float32), so
    params agree to 1e-6 absolute at these magnitudes."""
    hyper = {"betas": [0.9, 0.95], "weight_decay": 0.1}
    jopt = joptim.get_optimizer("fused_adam8bit", **hyper)
    topt = optimizers.get_optimizer("fused_adam8bit", **hyper)
    assert topt.name == "fused_adam8bit" and topt.step_fn is not None
    params = _tree(0)
    jparams, tparams = _jtree(params), _ttree(params)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for step in range(3):
        grads = _tree(10 + step, 1e-2)
        lr = 1e-2 * (step + 1)
        if form == "step_fn":
            jparams, jstate = jopt.step_fn(_jtree(grads), jstate, jparams, jnp.float32(lr))
            tparams, tstate = topt.step_fn(_ttree(grads), tstate, tparams, lr)
        else:
            jup, jstate = jopt.update(_jtree(grads), jstate, jparams, jnp.float32(lr))
            jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, jup)
            tup, tstate = topt.update(_ttree(grads), tstate, tparams, lr)
            tparams = jax.tree_util.tree_map(lambda p, u: p + u, tparams, tup)
    assert tstate.step == int(jstate.step) == 3
    _assert_trees_close(tparams, jparams)
    for name in ("exp_avg", "exp_avg_sq"):
        for a, b in zip(tree_leaves(getattr(tstate, name)),
                        jax.tree_util.tree_leaves(getattr(jstate, name))):
            _assert_codes_close(a.numpy(), np.asarray(b), name)
    for name in ("scale_m", "scale_v"):
        _assert_trees_close(getattr(tstate, name), getattr(jstate, name), tol=1e-5)


def test_adam8bit_state_from_jax_resumes():
    params = _tree(1)
    jopt = joptim.get_optimizer("adam8bit", weight_decay=0.1)
    jparams, jstate = _jtree(params), jopt.init(_jtree(params))
    jparams, jstate = jopt.step_fn(_jtree(_tree(2, 1e-2)), jstate, jparams, jnp.float32(1e-2))
    state = optimizers.adam8bit_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    assert state.step == 1
    for a, b in zip(tree_leaves(state.exp_avg), jax.tree_util.tree_leaves(jstate.exp_avg)):
        assert a.dtype == torch.int8 and np.array_equal(a.numpy(), np.asarray(b))
    topt = optimizers.get_optimizer("fusedadam8bit", weight_decay=0.1)
    tparams = _ttree(jax.tree_util.tree_map(np.asarray, jparams))
    tparams, state = topt.step_fn(_ttree(_tree(3, 1e-2)), state, tparams, 1e-2)
    jparams, jstate = jopt.step_fn(_jtree(_tree(3, 1e-2)), jstate, jparams, jnp.float32(1e-2))
    _assert_trees_close(tparams, jparams)
    assert state.step == 2


def test_fused_adam8bit_refuses_what_the_kernel_does_not_do():
    with pytest.raises(ValueError, match="bias correction"):
        optimizers.get_optimizer("fused_adam8bit", bias_correction=False)
    with pytest.raises(NotImplementedError, match="1024"):
        optimizers.get_optimizer("fused_adam8bit", group_size=256)


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ADAMW8_FAULTS = {
    "stale_m_codes": lambda before, out: (out[0], before[1], *out[2:]),
    "stale_v_scales": lambda before, out: (*out[:4], before[4]),
    "m_code_off_by_one": lambda before, out: (out[0], out[1] + (out[1] < 127).to(torch.int8),
                                              *out[2:]),
    "p_without_decay": lambda before, out: (out[0] + 3e-4 * 0.1 * before[0], *out[1:]),
    "zero_v": lambda before, out: (*out[:2], torch.zeros_like(out[2]), *out[3:]),
}


@pytest.mark.parametrize("fault", [None, *ADAMW8_FAULTS])
def test_chip_smoke_adamw8_check_sees_a_faulty_buffer(fault):
    """chip_smoke.py's AdamW-8bit check, at the magnitudes its ``[kernel]``
    phase draws, passes the plain result and rejects each faulty buffer."""
    smoke = _chip_smoke()
    before = smoke.adamw8_state(torch.Generator().manual_seed(0), 50_000, "cpu")
    grad = before.pop()
    plain = [x.clone() for x in before]
    adam8bit.fused_adamw8bit_flat_reference(*plain, grad, **smoke.ADAMW8_HYPER)
    if fault is None:
        assert smoke.check_adamw8("plain", [x.clone() for x in plain], plain, 50_000) == 0.0
        return
    with pytest.raises(AssertionError):
        smoke.check_adamw8(fault, list(ADAMW8_FAULTS[fault](before, plain)), plain, 50_000)

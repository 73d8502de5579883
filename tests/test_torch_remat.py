"""The port's named remat policies and host-offload remat on the CPU against
the JAX package: the policy names and their errors, the tiny Llama's logits
and grads under each policy (weights carried by ``params_from_jax``), which
products the backward recomputes, ``offload_checkpoint`` and the
``activation_checkpointing`` config section.  fp32 throughout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.runtime import activation_checkpointing as jac
from deepspeed_tpu.runtime.config import ActivationCheckpointingConfig as JActConfig
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac
from deepspeed_tpu_torch.runtime.config import ActivationCheckpointingConfig, load_config
from deepspeed_tpu_torch.runtime.tree import tree_leaves

VOCAB, SEQ, LAYERS = 96, 32, 3

# every name jax's resolve_policy takes, and names it refuses (factories among them)
JAX_NAMES = ("nothing_saveable", "dots_saveable", "dots_with_no_batch_dims_saveable",
             "everything_saveable", "checkpoint_dots", "checkpoint_dots_with_no_batch_dims",
             "save_anything_except_these_names", "offload_dot", "offload_residuals",
             "cpu_checkpointing")
REFUSED = ("bogus_policy", "save_only_these_names", "offload_dot_with_no_batch_dims",
           "save_and_offload_only_these_names", "save_from_both_policies")
# the policies the Llama forward takes, the host-offload one included
LLAMA_POLICIES = ("nothing_saveable", "dots_with_no_batch_dims_saveable", "dots_saveable",
                  "everything_saveable", "save_anything_except_these_names", "checkpoint_dots",
                  "offload_inputs")


def _configs(policy):
    shape = dict(vocab=VOCAB, hidden=64, layers=LAYERS, heads=4, kv_heads=2, seq=SEQ)
    return (dataclasses.replace(jllama.LlamaConfig.tiny(**shape), remat_policy=policy),
            dataclasses.replace(llama.LlamaConfig.tiny(**shape), remat_policy=policy))


@pytest.fixture(scope="module")
def weights():
    """(JAX params, their numpy leaves, a batch, JAX's logits): a policy
    changes only what the backward keeps, so the forward is computed once."""
    jcfg, cfg = _configs(None)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    ids = np.random.default_rng(4).integers(0, VOCAB, (2, SEQ)).astype(np.int32)
    logits = np.asarray(jax.jit(lambda p: jllama.forward(jcfg, p, jnp.asarray(ids)))(jparams))
    return (jparams, jax.tree_util.tree_map(np.asarray, jparams), llama.causal_lm_batch(ids),
            logits)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix


def _port_loss_and_grads(cfg, params_np, batch):
    params = llama.params_from_jax(cfg, params_np, "cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = llama.forward(cfg, params, tbatch["input_ids"])
    loss = llama.make_loss_fn(cfg)(params, tbatch, None)
    return logits.detach().numpy(), loss, dict(zip(_paths(params),
                                                   torch.autograd.grad(loss, leaves)))


def test_policy_names_and_errors_match_jax():
    for name in JAX_NAMES + (None, ""):
        theirs = jac.resolve_policy(name)
        if name in ("offload_dot", "offload_residuals", "cpu_checkpointing"):
            with pytest.raises(NotImplementedError, match="ROADMAP item 9e"):
                ac.resolve_policy(name)  # never a silent recompute
            continue
        ours = ac.resolve_policy(name)
        # both full recompute (None) or both a real policy
        assert (ours is None) == (theirs is None or name == "nothing_saveable"), name
    assert ac.resolve_policy("everything_saveable").remat is False
    for name in REFUSED:
        with pytest.raises(ValueError) as theirs:
            jac.resolve_policy(name)
        with pytest.raises(ValueError) as ours:
            ac.resolve_policy(name)
        assert str(ours.value) == str(theirs.value)
    assert ac.RESIDUAL_NAMES == jac.RESIDUAL_NAMES
    assert llama.LlamaConfig().remat_policy == jllama.LlamaConfig().remat_policy \
        == "dots_with_no_batch_dims_saveable"


@pytest.mark.parametrize("policy", LLAMA_POLICIES)
def test_llama_logits_and_grads_match_jax_under_policy(policy, weights):
    jcfg, cfg = _configs(policy)
    jparams, params_np, batch, jlogits = weights
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss_fn = jllama.make_loss_fn(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jloss_fn(p, jbatch, None)))(jparams)
    logits, loss, grads = _port_loss_and_grads(cfg, params_np, batch)
    np.testing.assert_allclose(logits, jlogits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = dict(zip(_paths(jgrads), jax.tree_util.tree_leaves(jgrads)))
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[name]), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


class _Products(TorchDispatchMode):
    """Counts the aten products that run under it."""

    def __init__(self):
        super().__init__()
        self.mm = self.bmm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
        self.bmm += func is torch.ops.aten.bmm.default
        return func(*args, **(kwargs or {}))


# (x @ W products, batched attention products) recomputed a layer in the
# backward: nothing_saveable stops at the last activation the backward needs
# (w_down's product is not rerun); offload_inputs recomputes the whole layer;
# the attention's two products are batched, so only dots_saveable keeps them
RECOMPUTED = {"nothing_saveable": (6, 2), "dots_with_no_batch_dims_saveable": (0, 2),
              "dots_saveable": (0, 0), "everything_saveable": (0, 0),
              "save_anything_except_these_names": (0, 0), "offload_inputs": (7, 2)}


def test_backward_recomputes_the_policy_s_products(weights):
    _, params_np, batch, _ = weights
    counts = {}
    for policy in RECOMPUTED:
        _, cfg = _configs(policy)
        params = llama.params_from_jax(cfg, params_np, "cpu")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss = llama.make_loss_fn(cfg)(params, {k: torch.from_numpy(v)
                                                for k, v in batch.items()}, None)
        with _Products() as seen:
            loss.backward()
        counts[policy] = (seen.mm, seen.bmm)
    # the backward's own products: 2 a weight product (7 a layer), 2 for the
    # lm_head, 4 a layer for the attention
    base_mm, base_bmm = 2 * 7 * LAYERS + 2, 4 * LAYERS
    got = {p: ((mm - base_mm) / LAYERS, (bmm - base_bmm) / LAYERS)
           for p, (mm, bmm) in counts.items()}
    assert got == RECOMPUTED


def test_checkpoint_name_is_the_identity_outside_a_naming_policy():
    x = torch.randn(3, 4)
    assert ac.checkpoint_name(x, "attn_resid") is x
    seen = []

    def fn(x):
        y = ac.checkpoint_name(x * 2, "attn_resid")
        seen.append(y.grad_fn is not None and "checkpoint_name" in y.grad_fn.name())
        return (y * y).sum()

    x.requires_grad_(True)
    ac.checkpoint(fn, "save_anything_except_these_names")(x).backward()
    assert seen == [True, True]  # planted in the forward and in its recompute
    torch.testing.assert_close(x.grad, 8 * x.detach())


def _tanh_layer(x, p, scale=None):
    y = torch.tanh(x @ p["w"] + p["b"])
    return y if scale is None else y * scale


def test_offload_checkpoint_matches_plain_grads():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(16, 16)).astype(np.float32) * 0.4
    x0 = rng.normal(size=(4, 16)).astype(np.float32)
    wrapped = ac.offload_checkpoint(_tanh_layer)
    grads = {}
    for name, layer in (("plain", _tanh_layer), ("offload", wrapped)):
        p = {"w": torch.tensor(w, requires_grad=True), "b": torch.zeros(16, requires_grad=True)}
        x = torch.tensor(x0, requires_grad=True)
        h = x
        for _ in range(3):
            h = layer(h, p)
        loss = (h * h).sum()
        grads[name] = (loss.item(), *torch.autograd.grad(loss, [p["w"], p["b"], x]))
    assert grads["offload"][0] == pytest.approx(grads["plain"][0], rel=1e-6)
    for a, b in zip(grads["offload"][1:], grads["plain"][1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    # the JAX wrapper on the same layer and inputs
    jwrapped = jac.offload_checkpoint(lambda x, p: (jnp.tanh(x @ p["w"] + p["b"]), None))

    def jloss(p, x):
        for _ in range(3):
            x, _ = jwrapped(x, p)
        return jnp.sum(x * x)

    jl, jg = jax.jit(jax.value_and_grad(jloss))({"w": jnp.asarray(w), "b": jnp.zeros(16)},
                                               jnp.asarray(x0))
    np.testing.assert_allclose(grads["offload"][0], float(jl), rtol=1e-6)
    np.testing.assert_allclose(grads["offload"][1].numpy(), np.asarray(jg["w"]), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_offload_checkpoint_rejects_float_extras(dtype):
    wrapped = ac.offload_checkpoint(_tanh_layer)
    p = {"w": torch.eye(4, requires_grad=True), "b": torch.zeros(4)}
    with pytest.raises(TypeError, match="no gradient"):
        wrapped(torch.ones(2, 4), p, torch.tensor(2.0, dtype=dtype))
    # integer extras (positions) pass
    out = ac.offload_checkpoint(lambda x, p, pos: x @ p["w"] + pos[:, None])(
        torch.ones(2, 4), p, torch.arange(2))
    assert out.shape == (2, 4)


def test_activation_checkpointing_section_loads():
    section = {"partition_activations": True, "cpu_checkpointing": False,
               "policy": "dots_saveable", "number_checkpoints": 4}
    conf = load_config({"train_batch_size": 2, "activation_checkpointing": section})
    ours, theirs = conf.activation_checkpointing, JActConfig(**section)
    assert list(type(ours)._fields) == list(type(theirs)._fields)
    for field in type(theirs)._fields:
        assert getattr(ours, field) == getattr(theirs, field), field
    assert ac.policy_from_config(ours).name == "dots_saveable"
    assert ac.policy_from_config(ActivationCheckpointingConfig()) is None
    with pytest.raises(ValueError):
        ActivationCheckpointingConfig(policy="bogus")
    with pytest.raises(NotImplementedError, match="9e"):
        ac.policy_from_config(ActivationCheckpointingConfig(cpu_checkpointing=True))

"""The port's MoE pieces (``deepspeed_tpu_torch.moe``) and Mixtral
(``deepspeed_tpu_torch.models.mixtral``) on the CPU against the JAX
package's, at world size 1: top-1 and top-2 gating (combine weights,
dispatch mask, expert counts, aux loss; capacity dropping with
``drop_tokens`` on and off), ``moe_layer``, ``MoE`` with its PR-MoE
residual, ``dense_moe_ffn``; Mixtral's forward (``train=True`` and
``train=False``, with capacity drops), its loss and grads, the paged
forward, greedy ``generate`` through ``build_engine("mixtral", ...)``
against the JAX engine, and HF parity.  fp32 at 1e-4 (HF at 2e-3).  The
JAX side runs on a one-way data topology, as ``tests/unit/test_moe.py``
sets it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import mixtral as jmixtral
from deepspeed_tpu.moe import MoE as JaxMoE
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu.moe.experts import gelu_experts as jgelu_experts
from deepspeed_tpu.moe.experts import swiglu_experts as jswiglu_experts
from deepspeed_tpu.parallel import MeshTopology, set_topology
from deepspeed_tpu_torch.models import mixtral
from deepspeed_tpu_torch.moe import MoE, TopKGate, moe_layer, top1gating, top2gating
from deepspeed_tpu_torch.moe.experts import gelu_experts, swiglu_experts
from deepspeed_tpu_torch.runtime.tree import tree_map
from tests import torch_family_checks as fam

ATOL = RTOL = 1e-4
CFG = mixtral.MixtralConfig.tiny(vocab=96)
JCFG = jmixtral.MixtralConfig.tiny(vocab=96)


@pytest.fixture(autouse=True)
def _topology():
    set_topology(MeshTopology.from_axis_dict({"data": 1}, devices=jax.devices()[:1]))


@pytest.fixture(scope="module")
def weights():
    return fam.pair_params(jmixtral, mixtral, JCFG, CFG)


def _logits(s, e, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=(s, e))).astype(np.float32)


def _same_gate(got, ref):
    np.testing.assert_allclose(got.combine_weights.numpy(), np.asarray(ref.combine_weights),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got.dispatch_mask.numpy(), np.asarray(ref.dispatch_mask))
    np.testing.assert_array_equal(got.exp_counts.numpy(), np.asarray(ref.exp_counts))
    assert got.exp_counts.dtype == torch.int32
    np.testing.assert_allclose(float(got.l_aux), float(ref.l_aux), atol=1e-6, rtol=1e-6)


# (tokens, experts, capacity_factor, min_capacity, drop_tokens): ample
# capacity; a capacity that drops tokens; drops off (the count keeps every
# token, the combine has no column past the capacity)
GATE_CASES = [(16, 4, 4.0, 4, True), (32, 4, 0.5, 2, True), (32, 4, 0.5, 2, False),
              (24, 8, 1.0, 4, True)]


@pytest.mark.parametrize("s,e,cf,min_cap,drop", GATE_CASES)
def test_top1gating_matches_jax(s, e, cf, min_cap, drop):
    x = _logits(s, e, seed=s + e)
    ref = jsm.top1gating(jnp.asarray(x), cf, min_cap, drop_tokens=drop)
    got = top1gating(torch.from_numpy(x), cf, min_cap, drop_tokens=drop)
    _same_gate(got, ref)


@pytest.mark.parametrize("s,e,cf,min_cap,drop", GATE_CASES)
def test_top2gating_matches_jax(s, e, cf, min_cap, drop):
    x = _logits(s, e, seed=2 * s + e)
    ref = jsm.top2gating(jnp.asarray(x), cf, min_cap, drop_tokens=drop)
    got = top2gating(torch.from_numpy(x), cf, min_cap, drop_tokens=drop)
    _same_gate(got, ref)


def test_gating_ties_take_the_first_expert_as_jax_does():
    """Rows of equal logits: ``torch.argmax`` and ``jnp.argmax`` both take
    the first maximum, for the first and (with it masked) second expert."""
    x = np.zeros((8, 4), np.float32)
    x[4:, 2:] = 1.0  # ties between experts 2 and 3
    for fn, jfn in ((top1gating, jsm.top1gating), (top2gating, jsm.top2gating)):
        _same_gate(fn(torch.from_numpy(x), 4.0), jfn(jnp.asarray(x), 4.0))


def test_noisy_top1_gating_draws_from_the_generator():
    """``noisy_gate_policy="RSample"`` picks each token's expert from
    Gumbel-perturbed logits drawn from the given ``torch.Generator`` (the
    JAX package draws from a threefry key: no bit is shared, so no value is
    compared): one seed gives one routing, the aux loss keeps the clean
    gates' mean, and at eval ``TopKGate`` routes by argmax."""
    x = torch.from_numpy(_logits(64, 4, seed=11, scale=0.2))
    noisy = [top1gating(x, 8.0, noisy_gate_policy="RSample",
                        rng=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    clean = top1gating(x, 8.0)
    picks = [g.combine_weights.sum(-1).argmax(-1) for g in (*noisy, clean)]
    assert torch.equal(picks[0], picks[1]) and not torch.equal(picks[0], picks[2])
    assert not torch.equal(picks[0], picks[3])
    np.testing.assert_allclose(noisy[0].combine_weights.sum().item(),
                               torch.softmax(x, -1).gather(1, picks[0][:, None]).sum().item(),
                               rtol=1e-6)
    gate = TopKGate(4, 4, k=1, capacity_factor=8.0, eval_capacity_factor=8.0,
                    noisy_gate_policy="RSample")
    eye = {"wg": torch.eye(4)}
    _same_gate(gate(eye, x, train=False, rng=torch.Generator().manual_seed(0)), clean)


def test_topk_gate_train_and_eval_capacity_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(32, 16)).astype(np.float32)
    wg = (0.5 * rng.normal(size=(16, 4))).astype(np.float32)
    for k in (1, 2):
        args = dict(k=k, capacity_factor=0.5, eval_capacity_factor=2.0, min_capacity=2)
        gate, jgate = TopKGate(16, 4, **args), jsm.TopKGate(16, 4, **args)
        for train in (True, False):
            _same_gate(gate({"wg": torch.from_numpy(wg)}, torch.from_numpy(x), train=train),
                       jgate({"wg": jnp.asarray(wg)}, jnp.asarray(x), train=train))
    with pytest.raises(ValueError, match="k=1 or k=2"):
        TopKGate(16, 4, k=3)


def _expert_params(kind, e, m, h, seed):
    rng = np.random.default_rng(seed)
    if kind == "swiglu":
        shapes = {"w_gate": (e, m, h), "w_up": (e, m, h), "w_down": (e, h, m)}
    else:
        shapes = {"w_fc1": (e, m, h), "b_fc1": (e, h), "w_fc2": (e, h, m), "b_fc2": (e, m)}
    return {k: (rng.normal(size=s) / np.sqrt(s[-2] if len(s) == 3 else 4)).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_experts_match_jax(kind):
    p = _expert_params(kind, 4, 16, 32, seed=5)
    tokens = np.random.default_rng(6).normal(size=(4, 6, 16)).astype(np.float32)
    fn, jfn = {"swiglu": (swiglu_experts, jswiglu_experts),
               "gelu": (gelu_experts, jgelu_experts)}[kind]
    ref = jfn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(tokens))
    got = fn({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k,cf", [(1, 0.75), (2, 4.0), (2, 0.5)])
def test_moe_layer_matches_jax(k, cf):
    rng = np.random.default_rng(7)
    params = {"gate": {"wg": (0.5 * rng.normal(size=(16, 4))).astype(np.float32)},
              "experts": _expert_params("swiglu", 4, 16, 32, seed=8)}
    x = rng.normal(size=(2, 12, 16)).astype(np.float32)
    gate, jgate = TopKGate(16, 4, k=k, capacity_factor=cf), jsm.TopKGate(16, 4, k=k,
                                                                         capacity_factor=cf)
    ref, jaux = jsm.moe_layer(jgate, jax.tree_util.tree_map(jnp.asarray, params),
                              jnp.asarray(x), expert_fn=jswiglu_experts)
    got, aux = moe_layer(gate, tree_map(torch.from_numpy, params), torch.from_numpy(x),
                         expert_fn=swiglu_experts)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)
    with pytest.raises(NotImplementedError, match="item 11"):
        moe_layer(gate, tree_map(torch.from_numpy, params), torch.from_numpy(x),
                  expert_fn=swiglu_experts, ep_size=2)


@pytest.mark.parametrize("use_residual,kind", [(True, "swiglu"), (False, "gelu")])
def test_moe_facade_matches_jax(use_residual, kind):
    """``MoE`` (k 2, capacity 1.0: some tokens dropped) with its JAX params
    carried over; the PR-MoE residual mixes in the dense MLP."""
    args = dict(hidden_size=16, expert_intermediate_size=32, num_experts=4, k=2,
                capacity_factor=1.0, use_residual=use_residual, expert_kind=kind)
    jmoe, moe = JaxMoE(**args), MoE(**args)
    jparams = jmoe.init(jax.random.PRNGKey(4))
    params = tree_map(lambda a: torch.from_numpy(np.array(a)), jparams)
    ours = moe.init(torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_structure(tree_map(np.asarray, ours)) == \
        jax.tree_util.tree_structure(fam.np_tree(jparams))
    x = np.random.default_rng(9).normal(size=(3, 8, 16)).astype(np.float32)
    ref, jaux = jmoe(jparams, jnp.asarray(x))
    got, aux = moe(params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        MoE(hidden_size=8, num_experts=6, ep_size=4)
    with pytest.raises(NotImplementedError, match="item 11"):
        MoE(hidden_size=8, num_experts=8, ep_size=2)


def test_dense_moe_ffn_matches_jax_and_breaks_ties_as_jax_top_k(weights):
    """``dense_moe_ffn`` against JAX on random rows, and on rows whose gate
    probabilities tie (a zero router): ``jax.lax.top_k`` takes the lower
    experts first; ``torch.topk`` does not specify its order on ties (some
    builds pick [2, 3] of four equal values), so the port sorts stably.
    torch's pick is printed, not gated: only the port's result is held to
    JAX's."""
    jparams, params = weights
    jmoe = jax.tree_util.tree_map(lambda w: w[0], jparams["layers"]["moe"])
    moe = tree_map(lambda w: w[0], params["layers"]["moe"])
    x = np.random.default_rng(10).normal(size=(10, CFG.hidden_size)).astype(np.float32)
    ref = jmixtral.dense_moe_ffn(jmoe, jnp.asarray(x), CFG.top_k)
    got = mixtral.dense_moe_ffn(moe, torch.from_numpy(x), CFG.top_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    flat = np.full((3, CFG.num_experts), 1.0 / CFG.num_experts, np.float32)
    assert np.asarray(jax.lax.top_k(jnp.asarray(flat), 2)[1]).tolist() == [[0, 1]] * 3
    picked = torch.topk(torch.from_numpy(flat), 2).indices[0].tolist()
    print(f"top 2 of four equal values: torch.topk {picked}, jax.lax.top_k [0, 1]")
    jmoe["gate"]["wg"] = jnp.zeros_like(jmoe["gate"]["wg"])
    moe = dict(moe, gate={"wg": torch.zeros_like(moe["gate"]["wg"])})
    ref = jmixtral.dense_moe_ffn(jmoe, jnp.asarray(x), CFG.top_k)
    got = mixtral.dense_moe_ffn(moe, torch.from_numpy(x), CFG.top_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_config_and_param_count_match_jax(weights):
    fam.check_config(CFG, JCFG)
    fam.check_config(mixtral.MixtralConfig.mixtral_8x7b(), jmixtral.MixtralConfig.mixtral_8x7b())
    fam.check_num_params(jmixtral, mixtral, JCFG, CFG, *weights)
    assert weights[1]["layers"]["moe"]["experts"]["w_gate"].shape == (2, 4, 64, 128)


@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_jax_with_capacity_drops(weights, train):
    """The default capacity factor (1.25, k 2, 4 experts over 24 tokens)
    drops tokens; a factor of 0.5 drops more."""
    fam.check_forward(jmixtral, mixtral, JCFG, CFG, *weights, train=train)
    narrow = dataclasses.replace(CFG, capacity_factor=0.5)
    jnarrow = dataclasses.replace(JCFG, capacity_factor=0.5)
    fam.check_forward(jmixtral, mixtral, jnarrow, narrow, *weights, train=train)


def test_loss_and_grads_match_jax(weights):
    fam.check_loss_and_grads(jmixtral, mixtral, JCFG, CFG, *weights, has_aux=True)


def test_forward_paged_matches_jax(weights):
    fam.check_forward_paged(jmixtral, mixtral, JCFG, CFG, *weights,
                            prompts=[[5, 9, 2, 7, 1, 3, 8], [11, 4, 6]])


def test_engine_generate_matches_jax_engine(weights):
    fam.check_engine_generate("mixtral", jmixtral, CFG, JCFG, *weights, vocab=CFG.vocab_size)


def test_hf_parity_and_build_hf_engine():
    """HF Mixtral drops no token: the dense forward is compared at a
    capacity factor of E (no drops), and ``build_hf_engine`` serves through
    ``dense_moe_ffn``."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.MixtralForCausalLM(transformers.MixtralConfig(
        vocab_size=99, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2, max_position_embeddings=64))
    cfg = mixtral.config_from_hf(hf.config)
    assert (cfg.num_experts, cfg.top_k, cfg.num_kv_heads) == (4, 2, 2)
    # the capacity factor is not an HF field: forward reads it from the config
    fam.check_hf(mixtral, hf, forward_kw={"train": False},
                 config=dataclasses.replace(cfg, capacity_factor=4.0))

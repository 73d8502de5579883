"""The port's Phi (``deepspeed_tpu_torch.models.phi``) on the CPU against the
JAX package's: the config (Phi-2's partial rotary of 32 of 80 head dims),
the partial rotary, the dense forward (parallel residual, biases
everywhere, tanh GELU, biased untied head), the loss and its grads, the
paged forward over a prefill chunk and two decode steps, greedy
``generate`` through ``build_engine("phi", ...)`` against the JAX engine,
HF parity and ``build_hf_engine`` on a Phi model built in the test, and the
importer's guards.  fp32 at 1e-4 (HF at 2e-3), the JAX tiny config (head
dim 16, 8 of it rotated)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import phi as jphi
from deepspeed_tpu_torch.models import phi
from deepspeed_tpu_torch.models import transformer as tf
from tests import torch_family_checks as fam

CFG = phi.PhiConfig.tiny(vocab=96)
JCFG = jphi.PhiConfig.tiny(vocab=96)


@pytest.fixture(scope="module")
def weights():
    return fam.pair_params(jphi, phi, JCFG, CFG)


def test_config_and_param_count_match_jax(weights):
    fam.check_config(CFG, JCFG)
    fam.check_config(phi.PhiConfig.phi_2(), jphi.PhiConfig.phi_2())
    fam.check_num_params(jphi, phi, JCFG, CFG, *weights)
    assert phi.num_params(phi.PhiConfig.phi_2()) == jphi.num_params(jphi.PhiConfig.phi_2())
    p2 = phi.PhiConfig.phi_2()
    assert (p2.hidden_size // p2.num_heads, p2.rotary_dim) == (80, 32)
    assert CFG.rotary_dim == JCFG.rotary_dim == 8


def test_partial_rotary_matches_jax():
    from deepspeed_tpu.models import transformer as jtf
    x = np.random.default_rng(0).normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = np.random.default_rng(1).integers(0, 64, (2, 5)).astype(np.int32)
    jcos, jsin = jtf.rotary_tables(8, 64, 10000.0)
    cos, sin = tf.device_rotary_tables(8, 64, 10000.0, "cpu")
    for positions in (None, pos):
        ref = jphi.partial_rotary(jnp.asarray(x), jcos, jsin, 8,
                                  None if positions is None else jnp.asarray(pos))
        got = phi.partial_rotary(torch.from_numpy(x), cos, sin, 8,
                                 None if positions is None else torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(got.numpy()[..., 8:], x[..., 8:])


def test_forward_matches_jax(weights):
    fam.check_forward(jphi, phi, JCFG, CFG, *weights)


def test_loss_and_grads_match_jax(weights):
    fam.check_loss_and_grads(jphi, phi, JCFG, CFG, *weights)


def test_forward_paged_matches_jax(weights):
    fam.check_forward_paged(jphi, phi, JCFG, CFG, *weights,
                            prompts=[[5, 9, 2, 7, 1, 3, 8], [11, 4, 6]])


def test_engine_generate_matches_jax_engine(weights):
    fam.check_engine_generate("phi", jphi, CFG, JCFG, *weights, vocab=CFG.vocab_size)


def test_hf_parity_and_build_hf_engine():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.PhiForCausalLM(transformers.PhiConfig(
        vocab_size=99, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, partial_rotary_factor=0.5, max_position_embeddings=64))
    fam.check_hf(phi, hf)


def test_hf_guards_match_jax():
    transformers = pytest.importorskip("transformers")
    for kw in ({}, {"layer_norm_eps": 2e-6}):
        hf_cfg = transformers.PhiConfig(**kw)
        assert phi.config_from_hf(hf_cfg) == phi.PhiConfig(**vars(jphi.config_from_hf(hf_cfg)))
    assert phi.config_from_hf(transformers.PhiConfig(layer_norm_eps=2e-6)).ln_eps == 2e-6
    with pytest.raises(NotImplementedError, match="qk_layernorm"):
        phi.config_from_hf(transformers.PhiConfig(qk_layernorm=True))
    with pytest.raises(NotImplementedError, match="GQA"):
        phi.config_from_hf(transformers.PhiConfig(num_attention_heads=8, num_key_value_heads=2))

"""The port's OPT (``deepspeed_tpu_torch.models.opt``) on the CPU against
the JAX package's: the dense forward (learned positions at offset 2,
pre-LayerNorm, ReLU, tied head), the loss and its grads, the paged forward
over a prefill chunk and two decode steps, greedy ``generate`` through
``build_engine("opt", ...)`` against the JAX engine, and HF parity on an OPT
model built in the test.  fp32 at 1e-4 (HF at 2e-3), the JAX tiny config."""

import numpy as np
import pytest
import torch

from deepspeed_tpu.models import opt as jopt
from deepspeed_tpu_torch.models import opt
from deepspeed_tpu_torch.models import transformer as tf
from tests import torch_family_checks as fam

CFG = opt.OPTConfig.tiny(vocab=96)
JCFG = jopt.OPTConfig.tiny(vocab=96)


@pytest.fixture(scope="module")
def weights():
    return fam.pair_params(jopt, opt, JCFG, CFG)


def test_config_and_param_count_match_jax(weights):
    fam.check_config(CFG, JCFG)
    fam.check_config(opt.OPTConfig.opt_125m(), jopt.OPTConfig.opt_125m())
    fam.check_num_params(jopt, opt, JCFG, CFG, *weights)
    assert opt.POS_OFFSET == jopt.POS_OFFSET == 2
    assert weights[1]["pos_embed"].shape == (CFG.max_seq_len + 2, CFG.hidden_size)


def test_layer_norm_matches_jax():
    import jax.numpy as jnp
    from deepspeed_tpu.models import transformer as jtf
    rng = np.random.default_rng(0)
    x, w, b = (rng.normal(size=s).astype(np.float32) for s in ((2, 5, 64), (64, ), (64, )))
    x = x * 3.0 + 1.5  # a mean and a scale for the norm to remove
    ref = np.asarray(jtf.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5))
    got = tf.layer_norm(*(torch.from_numpy(a) for a in (x, w, b)), 1e-5).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_forward_matches_jax(weights):
    fam.check_forward(jopt, opt, JCFG, CFG, *weights)


def test_loss_and_grads_match_jax(weights):
    fam.check_loss_and_grads(jopt, opt, JCFG, CFG, *weights)


def test_forward_paged_matches_jax(weights):
    fam.check_forward_paged(jopt, opt, JCFG, CFG, *weights,
                            prompts=[[5, 9, 2, 7, 1, 3, 8], [11, 4, 6]])


def test_engine_generate_matches_jax_engine(weights):
    fam.check_engine_generate("opt", jopt, CFG, JCFG, *weights, vocab=CFG.vocab_size)


def test_hf_parity_and_build_hf_engine():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.OPTForCausalLM(transformers.OPTConfig(
        vocab_size=99, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=64, do_layer_norm_before=True))
    fam.check_hf(opt, hf)
    with pytest.raises(NotImplementedError, match="post-LN"):
        opt.config_from_hf(transformers.OPTConfig(do_layer_norm_before=False))
    with pytest.raises(NotImplementedError, match="word_embed_proj_dim"):
        opt.config_from_hf(transformers.OPTConfig(word_embed_proj_dim=256, hidden_size=512))

"""The port's GPT-J (``deepspeed_tpu_torch.models.gptj``) on the CPU against
the JAX package's: the interleaved rotary tables and rotation, the dense
forward (parallel residual, tanh GELU, biased untied head), the loss and
its grads, the paged forward over a prefill chunk and two decode steps,
greedy ``generate`` through ``build_engine("gptj", ...)`` against the JAX
engine, and HF parity on a GPT-J model built in the test.  fp32 at 1e-4 (HF
at 2e-3), the JAX tiny config (partial rotary: 8 of 16 head dims)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gptj as jgptj
from deepspeed_tpu_torch.models import gptj
from tests import torch_family_checks as fam

CFG = gptj.GPTJConfig.tiny(vocab=96)
JCFG = jgptj.GPTJConfig.tiny(vocab=96)


@pytest.fixture(scope="module")
def weights():
    return fam.pair_params(jgptj, gptj, JCFG, CFG)


def test_config_and_param_count_match_jax(weights):
    fam.check_config(CFG, JCFG)
    fam.check_config(gptj.GPTJConfig.gptj_6b(), jgptj.GPTJConfig.gptj_6b())
    fam.check_num_params(jgptj, gptj, JCFG, CFG, *weights)


def test_interleaved_rotary_matches_jax():
    cos, sin = gptj.interleaved_rotary_tables(8, 64)
    jcos, jsin = jgptj.interleaved_rotary_tables(8, 64)
    np.testing.assert_array_equal(cos, np.asarray(jcos))
    np.testing.assert_array_equal(sin, np.asarray(jsin))
    x = np.random.default_rng(0).normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = np.random.default_rng(1).integers(0, 64, (2, 5)).astype(np.int32)
    tcos, tsin = gptj.device_interleaved_rotary_tables(8, 64, "cpu")
    for positions in (None, pos):
        ref = jgptj.apply_rotary_interleaved(jnp.asarray(x), jcos, jsin,
                                             None if positions is None else jnp.asarray(pos))
        got = gptj.apply_rotary_interleaved(torch.from_numpy(x), tcos, tsin,
                                            None if positions is None else torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_forward_matches_jax(weights):
    fam.check_forward(jgptj, gptj, JCFG, CFG, *weights)


def test_loss_and_grads_match_jax(weights):
    fam.check_loss_and_grads(jgptj, gptj, JCFG, CFG, *weights)


def test_forward_paged_matches_jax(weights):
    fam.check_forward_paged(jgptj, gptj, JCFG, CFG, *weights,
                            prompts=[[5, 9, 2, 7, 1, 3, 8], [11, 4, 6]])


def test_engine_generate_matches_jax_engine(weights):
    fam.check_engine_generate("gptj", jgptj, CFG, JCFG, *weights, vocab=CFG.vocab_size)


def test_hf_parity_and_build_hf_engine():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.GPTJForCausalLM(transformers.GPTJConfig(
        vocab_size=99, n_embd=32, n_layer=2, n_head=4, rotary_dim=4, n_positions=64,
        n_inner=None))
    fam.check_hf(gptj, hf)

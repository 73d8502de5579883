"""The port's Qwen2 (``deepspeed_tpu_torch.models.qwen``) on the CPU against
the JAX package's: the dense forward, the loss and its grads, the paged
forward over a prefill chunk and two decode steps, greedy ``generate``
through ``build_engine("qwen2", ...)`` against the JAX engine, and HF
parity (config, weights, logits, ``build_hf_engine``) on a Qwen2 model built
in the test.  fp32 at 1e-4 (HF at 2e-3), the JAX tiny config; and one bf16
forward against the JAX bf16 forward from the same fp32 weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import qwen as jqwen
from deepspeed_tpu_torch.models import qwen
from deepspeed_tpu_torch.runtime.tree import tree_map
from tests import torch_family_checks as fam

CFG = qwen.QwenConfig.tiny(vocab=96)
JCFG = jqwen.QwenConfig.tiny(vocab=96)


@pytest.fixture(scope="module")
def weights():
    return fam.pair_params(jqwen, qwen, JCFG, CFG)


def test_config_and_param_count_match_jax(weights):
    fam.check_config(CFG, JCFG)
    fam.check_config(qwen.QwenConfig.qwen2_7b(), jqwen.QwenConfig.qwen2_7b())
    fam.check_num_params(jqwen, qwen, JCFG, CFG, *weights)
    assert set(weights[1]["layers"]["attn"]) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}


def test_forward_matches_jax(weights):
    fam.check_forward(jqwen, qwen, JCFG, CFG, *weights)


def test_loss_and_grads_match_jax(weights):
    fam.check_loss_and_grads(jqwen, qwen, JCFG, CFG, *weights)


def test_forward_paged_matches_jax(weights):
    fam.check_forward_paged(jqwen, qwen, JCFG, CFG, *weights,
                            prompts=[[5, 9, 2, 7, 1, 3, 8], [11, 4, 6]])


def test_engine_generate_matches_jax_engine(weights):
    fam.check_engine_generate("qwen2", jqwen, CFG, JCFG, *weights, vocab=CFG.vocab_size)


def test_hf_parity_and_build_hf_engine():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        vocab_size=99, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        tie_word_embeddings=False))
    for name, p in hf.named_parameters():  # HF zero-initialises the q/k/v biases
        if name.endswith("bias"):
            torch.nn.init.normal_(p, std=0.1)
    fam.check_hf(qwen, hf)


# bf16: both packages round every product, norm output and residual to bf16
# (8 significant bits, unit roundoff u = 2^-8) but fuse and order the fp32
# work between the roundings differently, so the two differ by a few
# roundings of the values they hold.  A logit is the sum of D products of the
# final norm's output with the head; through 2 layers the differences stay
# within BF16_ULPS units of 2^-7 (one bf16 ulp at 1.0) of the row's largest
# |logit|.
BF16_ULPS = 4


def test_bf16_forward_matches_jax_within_bf16_rounding(weights):
    jparams, params = weights
    ids = fam.token_ids(CFG, (4, 16), seed=5)
    ref = np.asarray(jqwen.forward(JCFG, jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16), jparams), jnp.asarray(ids)).astype(jnp.float32))
    got = qwen.forward(CFG, tree_map(lambda t: t.to(torch.bfloat16), params),
                       torch.from_numpy(ids)).float().detach().numpy()
    row_max = np.abs(ref).max(axis=-1, keepdims=True)
    err = np.abs(got - ref)
    ulps = err / (row_max * 2.0**-7)
    assert ulps.max() <= BF16_ULPS, f"max {ulps.max():.2f} bf16 ulps of the row's largest logit"
    # the greedy pick: report the share where the two packages agree; both
    # runs are deterministic, so it is gated at what rounding allows (a row
    # whose two largest logits lie within the limit may flip)
    picks, jpicks = got.argmax(-1), ref.argmax(-1)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    near_tie = (top2[..., 1] - top2[..., 0]) <= 2 * BF16_ULPS * row_max[..., 0] * 2.0**-7
    share = float((picks == jpicks).mean())
    print(f"bf16 qwen forward: max {ulps.max():.2f} ulps, argmax agrees at {share:.4f} of "
          f"{picks.size} positions ({int(near_tie.sum())} near ties)")
    assert np.all((picks == jpicks) | near_tie)

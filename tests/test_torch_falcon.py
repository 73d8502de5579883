"""The port's Falcon (``deepspeed_tpu_torch.models.falcon``) on the CPU
against the JAX package's: the config (Falcon-7B's 71 q heads over one kv
head), the dense forward (parallel residual off one LayerNorm, multi-query
attention, the exact erf GELU, no biases, tied head), the loss and its
grads, the paged forward over a prefill chunk and two decode steps (a pool
of one kv head), greedy ``generate`` through ``build_engine("falcon", ...)``
against the JAX engine, HF parity and ``build_hf_engine`` on the
multi-query and the full-MHA variants built in the test (their fused
``query_key_value`` split two ways), and the importer's four guards.  fp32
at 1e-4 (HF at 2e-3), the JAX tiny config (head dim 16, 4 q heads over 1 kv
head)."""

import numpy as np
import pytest
import torch

from deepspeed_tpu.models import falcon as jfalcon
from deepspeed_tpu_torch.models import falcon
from tests import torch_family_checks as fam

CFG = falcon.FalconConfig.tiny(vocab=96)
JCFG = jfalcon.FalconConfig.tiny(vocab=96)
HF_BASE = dict(vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               parallel_attn=True, new_decoder_architecture=False, bias=False, alibi=False,
               max_position_embeddings=64)


@pytest.fixture(scope="module")
def weights():
    return fam.pair_params(jfalcon, falcon, JCFG, CFG)


def test_config_and_param_count_match_jax(weights):
    fam.check_config(CFG, JCFG)
    fam.check_config(falcon.FalconConfig.falcon_7b(), jfalcon.FalconConfig.falcon_7b())
    fam.check_num_params(jfalcon, falcon, JCFG, CFG, *weights)
    f7 = falcon.FalconConfig.falcon_7b()
    assert falcon.num_params(f7) == jfalcon.num_params(jfalcon.FalconConfig.falcon_7b())
    assert (f7.hidden_size // f7.num_heads, f7.num_heads // f7.num_kv_heads) == (64, 71)
    kv = falcon.init_paged_cache(CFG, 6, 4, dtype=torch.float32, device="cpu")
    assert tuple(kv["k"].shape) == (CFG.num_layers, 6, 1, 4, 16)


def test_forward_matches_jax(weights):
    fam.check_forward(jfalcon, falcon, JCFG, CFG, *weights)


def test_loss_and_grads_match_jax(weights):
    fam.check_loss_and_grads(jfalcon, falcon, JCFG, CFG, *weights)


def test_forward_paged_matches_jax(weights):
    fam.check_forward_paged(jfalcon, falcon, JCFG, CFG, *weights,
                            prompts=[[5, 9, 2, 7, 1, 3, 8], [11, 4, 6]])


def test_engine_generate_matches_jax_engine(weights):
    fam.check_engine_generate("falcon", jfalcon, CFG, JCFG, *weights, vocab=CFG.vocab_size)


@pytest.mark.parametrize("multi_query", [True, False], ids=["multi_query", "mha"])
def test_hf_parity_and_build_hf_engine(multi_query):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.FalconForCausalLM(transformers.FalconConfig(multi_query=multi_query,
                                                                  **HF_BASE))
    cfg = falcon.config_from_hf(hf.config)
    assert cfg.num_kv_heads == (1 if multi_query else 4)
    fam.check_hf(falcon, hf)
    # the split of the fused projection equals the JAX importer's
    ref = jfalcon.from_hf_state_dict(jfalcon.config_from_hf(hf.config), hf.state_dict())
    got = falcon.from_hf_state_dict(cfg, hf.state_dict())
    for name in ("wq", "wk", "wv"):
        np.testing.assert_array_equal(got["layers"][name].numpy(),
                                      np.asarray(ref["layers"][name]))


def test_hf_guards_match_jax():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.FalconConfig(layer_norm_epsilon=3e-6, multi_query=True,
                                       parallel_attn=True, new_decoder_architecture=False,
                                       bias=False, alibi=False)
    assert falcon.config_from_hf(hf_cfg).ln_eps == 3e-6
    assert falcon.config_from_hf(hf_cfg) == falcon.FalconConfig(
        **vars(jfalcon.config_from_hf(hf_cfg)))
    for kw, match in (({"new_decoder_architecture": True}, "new-decoder"),
                      ({"alibi": True}, "alibi"), ({"bias": True}, "bias=True"),
                      ({"parallel_attn": False}, "parallel_attn")):
        with pytest.raises(NotImplementedError, match=match):
            falcon.config_from_hf(transformers.FalconConfig(**kw))

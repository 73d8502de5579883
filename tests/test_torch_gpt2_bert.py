"""The port's GPT-2 and BERT (``deepspeed_tpu_torch.models.gpt2`` /
``.bert``) on the CPU against the JAX package's: the dense forward, the loss
and every grad (GPT-2 causal; BERT post-LN and non-causal, with token types
and a padding mask, whose masked keys leave the unmasked logits unchanged),
and a few steps of the port's training engine with the loss falling
(``tests/unit/test_models.py``'s drives).  fp32 at 1e-4 on the JAX tiny
configs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import bert, gpt2, llama
from deepspeed_tpu_torch.runtime.tree import tree_map
from tests import torch_family_checks as fam

FAMILIES = {"gpt2": (jgpt2, gpt2, jgpt2.GPT2Config.tiny(vocab=96), gpt2.GPT2Config.tiny(vocab=96)),
            "bert": (jbert, bert, jbert.BertConfig.tiny(vocab=96), bert.BertConfig.tiny(vocab=96))}


@pytest.fixture(scope="module")
def weights():
    return {key: fam.pair_params(jmod, mod, jcfg, cfg)
            for key, (jmod, mod, jcfg, cfg) in FAMILIES.items()}


def _bert_extras(seed=5):
    """Token types and a padding mask for a [2, 12] batch: row 1 pads its
    last 4 keys."""
    rng = np.random.default_rng(seed)
    types = rng.integers(0, 2, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 8:] = 0
    return types, mask


@pytest.mark.parametrize("key", sorted(FAMILIES))
def test_config_param_count_and_forward_match_jax(weights, key):
    jmod, mod, jcfg, cfg = FAMILIES[key]
    fam.check_config(cfg, jcfg)
    big = {"gpt2": (gpt2.GPT2Config.gpt2_350m(), jgpt2.GPT2Config.gpt2_350m()),
           "bert": (bert.BertConfig.bert_base(), jbert.BertConfig.bert_base())}[key]
    fam.check_config(*big)
    fam.check_num_params(jmod, mod, jcfg, cfg, *weights[key])
    fam.check_forward(jmod, mod, jcfg, cfg, *weights[key])


@pytest.mark.parametrize("key", sorted(FAMILIES))
def test_loss_and_grads_match_jax(weights, key):
    jmod, mod, jcfg, cfg = FAMILIES[key]
    batch = llama.causal_lm_batch(fam.token_ids(cfg, (2, 12), seed=1))
    batch["labels"][0, 2] = -100
    if key == "bert":
        batch["token_type_ids"], batch["attention_mask"] = _bert_extras()
    fam.check_loss_and_grads(jmod, mod, jcfg, cfg, *weights[key], batch=batch)


def test_bert_token_types_and_mask_match_jax_and_masked_keys_change_nothing(weights):
    """BERT's forward with token types and a padding mask equals JAX's; a
    token changed behind the mask leaves row 1's unmasked logits as they
    were (1e-5, the JAX test's), while the same change in the open moves
    them."""
    jparams, params = weights["bert"]
    _, _, jcfg, cfg = FAMILIES["bert"]
    ids = fam.token_ids(cfg, (2, 12), seed=4)
    types, mask = _bert_extras()
    kw = dict(token_type_ids=torch.from_numpy(types), attention_mask=torch.from_numpy(mask))
    got = bert.forward(cfg, params, torch.from_numpy(ids), **kw).detach()
    ref = jbert.forward(jcfg, jparams, jnp.asarray(ids), token_type_ids=jnp.asarray(types),
                        attention_mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=fam.ATOL, rtol=fam.RTOL)
    for pos, moves in ((10, False), (3, True)):
        ids2 = ids.copy()
        ids2[1, pos] = (ids2[1, pos] + 7) % cfg.vocab_size
        other = bert.forward(cfg, params, torch.from_numpy(ids2), **kw).detach()
        kept = [i for i in range(8) if i != pos]
        diff = np.abs(other[1, kept].numpy() - got[1, kept].numpy()).max()
        assert (diff > 1e-3) if moves else (diff <= 1e-5), (pos, diff)


@pytest.mark.parametrize("key", sorted(FAMILIES))
def test_engine_steps_lower_the_loss(weights, key):
    """A few ``train_batch`` steps of the port's engine (fp32, AdamW) on a
    fixed batch: finite losses that fall."""
    _, mod, _, cfg = FAMILIES[key]
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        loss_fn=mod.make_loss_fn(cfg), device="cpu",
        model_parameters=tree_map(lambda t: t.clone(), weights[key][1]),
        config={"train_micro_batch_size_per_gpu": 2,
                "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
                "bf16": {"enabled": False}})
    ids = fam.token_ids(cfg, (engine.train_batch_size, 16), seed=2)
    if key == "gpt2":
        batch = llama.causal_lm_batch(ids)
    else:  # predict every 4th token, as the JAX drive does
        labels = np.full_like(ids, -100)
        labels[:, ::4] = ids[:, ::4]
        batch = {"input_ids": ids, "labels": labels}
    losses = [float(engine.train_batch(batch).loss) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses

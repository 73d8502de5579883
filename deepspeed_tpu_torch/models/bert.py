"""BERT-style bidirectional encoder with a masked-LM head.

Counterpart of ``deepspeed_tpu/models/bert.py``: token, position and
token-type embeddings under a LayerNorm, post-LN blocks (attention, add and
norm, MLP, add and norm) with GPT-2's leaves (``models/gpt2.py``), and an
untied ``mlm_head`` [D, V].  The attention is non-causal: without an
``attention_mask`` the flash kernels on CUDA, with one (a [B, S] padding
mask, broadcast to [B, 1, 1, S]) ``flash_attention`` hands it to plain
``sdpa``, as the JAX package leaves a dense mask to XLA.
"""

import dataclasses
import functools
from typing import Callable

import torch

from ..runtime.activation_checkpointing import checkpoint
from ..runtime.tree import tree_map
from .gpt2 import attn_mlp_layers, self_attention
from .transformer import (count_params, cross_entropy_loss, gelu_mlp, init_linear, layer_norm,
                          resolve_attention, tree_to_torch)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 512
    type_vocab_size: int = 2
    ln_eps: float = 1e-12
    remat: bool = True

    @staticmethod
    def bert_base():
        return BertConfig()

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, seq=64):
        return BertConfig(vocab_size=vocab, hidden_size=hidden, num_layers=layers,
                          num_heads=heads, max_seq_len=seq)


def init_params(config: BertConfig, generator, dtype=torch.float32, device=None):
    D, V = config.hidden_size, config.vocab_size

    def randn(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device).mul_(0.02)

    return {
        "tok_emb": randn(V, D),
        "pos_emb": randn(config.max_seq_len, D),
        "type_emb": randn(config.type_vocab_size, D),
        "emb_ln_w": torch.ones((D, ), dtype=dtype, device=device),
        "emb_ln_b": torch.zeros((D, ), dtype=dtype, device=device),
        "layers": attn_mlp_layers(generator, config.num_layers, D, dtype, device),
        "mlm_head": init_linear(generator, D, V, dtype=dtype, device=device),
    }


def num_params(config: BertConfig) -> int:
    return count_params(lambda: init_params(config, None))


def params_from_jax(config: BertConfig, params_np, device, dtype=torch.float32):
    """The JAX params pytree (numpy leaves) -> this package's, same layout."""
    missing = {"tok_emb", "pos_emb", "type_emb", "emb_ln_w", "emb_ln_b", "layers",
               "mlm_head"} - set(params_np)
    if missing:
        raise KeyError(f"params_from_jax: the JAX params lack {sorted(missing)}")
    return tree_to_torch(params_np, device, dtype)


def _layer(config: BertConfig, attention_fn, mask, x, lp):
    att = self_attention(config.num_heads, attention_fn, x, lp["attn"], causal=False, mask=mask)
    x = layer_norm(x + att, lp["ln1_w"], lp["ln1_b"], config.ln_eps)
    return layer_norm(x + gelu_mlp(lp["mlp"], x), lp["ln2_w"], lp["ln2_b"], config.ln_eps)


def forward(config: BertConfig, params, input_ids, token_type_ids=None, attention_mask=None,
            attention_fn=None):
    """input_ids [B, S] -> MLM logits [B, S, V]; ``token_type_ids`` [B, S]
    and ``attention_mask`` [B, S] (nonzero = a key every query may see) are
    optional."""
    attention_fn = resolve_attention(attention_fn, params["tok_emb"].device)
    s = input_ids.shape[1]
    x = params["tok_emb"][input_ids.long()] + params["pos_emb"][:s][None]
    if token_type_ids is not None:
        x = x + params["type_emb"][token_type_ids.long()]
    x = layer_norm(x, params["emb_ln_w"], params["emb_ln_b"], config.ln_eps)
    mask = None if attention_mask is None else attention_mask[:, None, None, :].bool()
    layer = functools.partial(_layer, config, attention_fn, mask)
    if config.remat:
        layer = checkpoint(layer)
    per_layer = tree_map(lambda w: w.unbind(0), params["layers"])
    for i in range(config.num_layers):
        x = layer(x, tree_map(lambda ws: ws[i], per_layer))
    return x @ params["mlm_head"].to(x.dtype)


def make_loss_fn(config: BertConfig, attention_fn=None) -> Callable:
    """MLM loss; batch: {input_ids, labels[, token_type_ids, attention_mask]}."""

    def loss_fn(params, batch, rng=None):
        logits = forward(config, params, batch["input_ids"],
                         token_type_ids=batch.get("token_type_ids"),
                         attention_mask=batch.get("attention_mask"), attention_fn=attention_fn)
        return cross_entropy_loss(logits, batch["labels"])

    return loss_fn

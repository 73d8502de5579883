"""GPT-2 style causal LM: learned positions, pre-LayerNorm blocks, a fused
biased QKV, the tanh-GELU MLP and a tied head.

Counterpart of ``deepspeed_tpu/models/gpt2.py`` (the dense training forward;
the JAX package serves no GPT-2).  Layer leaves are stacked ``[L, ...]`` in
``layers.attn`` / ``layers.mlp``, weights ``[in, out]``.  The attention is
causal and goes through ``transformer.resolve_attention``: the flash kernels
on CUDA, plain ``sdpa`` on the CPU.
"""

import dataclasses
import functools
from typing import Callable

import torch

from ..runtime.activation_checkpointing import checkpoint
from ..runtime.tree import tree_map
from .transformer import (count_params, cross_entropy_loss, gelu_mlp, init_linear, layer_norm,
                          resolve_attention, tree_to_torch)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    max_seq_len: int = 1024
    ln_eps: float = 1e-5
    remat: bool = True

    @staticmethod
    def gpt2_350m():
        return GPT2Config()

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, seq=64):
        return GPT2Config(vocab_size=vocab, hidden_size=hidden, num_layers=layers,
                          num_heads=heads, max_seq_len=seq)


def attn_mlp_layers(generator, L, D, dtype, device):
    """The stacked ``attn`` (fused qkv and output projection) and ``mlp``
    (fc1, fc2) leaves of GPT-2 and BERT, biases zero."""

    def stack(in_dim, out_dim):
        return init_linear(generator, in_dim, out_dim, dtype=dtype, device=device, layers=L)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "ln1_w": ones(L, D), "ln1_b": zeros(L, D), "ln2_w": ones(L, D), "ln2_b": zeros(L, D),
        "attn": {"w_qkv": stack(D, 3 * D), "b_qkv": zeros(L, 3 * D),
                 "w_proj": stack(D, D), "b_proj": zeros(L, D)},
        "mlp": {"w_fc1": stack(D, 4 * D), "b_fc1": zeros(L, 4 * D),
                "w_fc2": stack(4 * D, D), "b_fc2": zeros(L, D)},
    }


def init_params(config: GPT2Config, generator, dtype=torch.float32, device=None):
    D = config.hidden_size

    def randn(*shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device).mul_(scale)

    return {
        "wte": randn(config.vocab_size, D, scale=0.02),
        "wpe": randn(config.max_seq_len, D, scale=0.01),
        "layers": attn_mlp_layers(generator, config.num_layers, D, dtype, device),
        "lnf_w": torch.ones((D, ), dtype=dtype, device=device),
        "lnf_b": torch.zeros((D, ), dtype=dtype, device=device),
    }


def num_params(config: GPT2Config) -> int:
    return count_params(lambda: init_params(config, None))


def params_from_jax(config: GPT2Config, params_np, device, dtype=torch.float32):
    """The JAX params pytree (numpy leaves) -> this package's, same layout."""
    missing = {"wte", "wpe", "layers", "lnf_w", "lnf_b"} - set(params_np)
    if missing:
        raise KeyError(f"params_from_jax: the JAX params lack {sorted(missing)}")
    return tree_to_torch(params_np, device, dtype)


def self_attention(num_heads, attention_fn, x, attn, **kw):
    """``attention_fn`` over the heads of ``x @ w_qkv + b_qkv`` (q, k and v
    side by side), then the biased output projection."""
    b, s, D = x.shape
    qkv = x @ attn["w_qkv"].to(x.dtype) + attn["b_qkv"].to(x.dtype)
    q, k, v = (t.reshape(b, s, num_heads, D // num_heads) for t in qkv.chunk(3, dim=-1))
    out = attention_fn(q, k, v, **kw).reshape(b, s, D)
    return out @ attn["w_proj"].to(x.dtype) + attn["b_proj"].to(x.dtype)


def _layer(config: GPT2Config, attention_fn, x, lp):
    h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], config.ln_eps)
    x = x + self_attention(config.num_heads, attention_fn, h, lp["attn"], causal=True)
    return x + gelu_mlp(lp["mlp"], layer_norm(x, lp["ln2_w"], lp["ln2_b"], config.ln_eps))


def forward(config: GPT2Config, params, input_ids, attention_fn=None):
    """input_ids [B, S] -> logits [B, S, V] (positions 0..S-1).  The
    attention is resolved once, here, so that the remat recompute runs the
    forward's (``llama.forward``)."""
    attention_fn = resolve_attention(attention_fn, params["wte"].device)
    s = input_ids.shape[1]
    x = params["wte"][input_ids.long()] + params["wpe"][:s][None]
    layer = functools.partial(_layer, config, attention_fn)
    if config.remat:
        layer = checkpoint(layer)
    per_layer = tree_map(lambda w: w.unbind(0), params["layers"])
    for i in range(config.num_layers):
        x = layer(x, tree_map(lambda ws: ws[i], per_layer))
    x = layer_norm(x, params["lnf_w"], params["lnf_b"], config.ln_eps)
    return x @ params["wte"].T.to(x.dtype)  # tied head


def make_loss_fn(config: GPT2Config, attention_fn=None) -> Callable:
    """loss_fn(params, batch, rng) for the engine; ``rng`` is unused."""

    def loss_fn(params, batch, rng=None):
        logits = forward(config, params, batch["input_ids"], attention_fn=attention_fn)
        return cross_entropy_loss(logits, batch["labels"])

    return loss_fn

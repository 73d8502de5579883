"""OPT causal LM (facebook/opt family).

Counterpart of ``deepspeed_tpu/models/opt.py``: learned positional
embeddings (with OPT's offset of 2), pre-LayerNorm blocks with biases,
standard multi-head attention (no GQA, no rotary), a ReLU fc1/fc2 MLP and a
tied unembedding.  Layer leaves are flat and stacked ``[L, ...]``
(``layers.wq``, ``layers.bq``, ``layers.ln1_w`` ...), weights ``[in, out]``.
"""

import dataclasses
import functools
import math
from typing import Callable

import torch

from ..ops.attention.paged import paged_attention
from ..runtime.activation_checkpointing import checkpoint
from ..runtime.tree import tree_map
from .transformer import (causal_lm_batch, count_params, cross_entropy_loss, hf_stack, hf_tensor,
                          init_paged_kv_pool, layer_norm, paged_chunk_indices, paged_cost,
                          paged_write_index, resolve_attention, tree_to_torch)

POS_OFFSET = 2  # OPT reserves the first two position slots (HF modeling_opt)


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 2048
    ln_eps: float = 1e-5
    remat: bool = True

    @staticmethod
    def opt_125m():
        return OPTConfig()

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, seq=64):
        return OPTConfig(vocab_size=vocab, hidden_size=hidden, ffn_dim=hidden * 4,
                         num_layers=layers, num_heads=heads, max_seq_len=seq)


def init_params(config: OPTConfig, generator, dtype=torch.float32, device=None):
    D, F, L = config.hidden_size, config.ffn_dim, config.num_layers
    s = D**-0.5

    def randn(*shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device).mul_(scale)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "embed": randn(config.vocab_size, D, scale=0.02),
        "pos_embed": randn(config.max_seq_len + POS_OFFSET, D, scale=0.02),
        "layers": {
            "ln1_w": ones(L, D), "ln1_b": zeros(L, D),
            "ln2_w": ones(L, D), "ln2_b": zeros(L, D),
            "wq": randn(L, D, D, scale=s), "wk": randn(L, D, D, scale=s),
            "wv": randn(L, D, D, scale=s), "wo": randn(L, D, D, scale=s),
            "bq": zeros(L, D), "bk": zeros(L, D), "bv": zeros(L, D), "bo": zeros(L, D),
            "fc1": randn(L, D, F, scale=s), "b_fc1": zeros(L, F),
            "fc2": randn(L, F, D, scale=s), "b_fc2": zeros(L, D),
        },
        "final_ln_w": ones(D), "final_ln_b": zeros(D),
    }


def num_params(config: OPTConfig) -> int:
    return count_params(lambda: init_params(config, None))


def params_from_jax(config: OPTConfig, params_np, device, dtype=torch.float32):
    """The JAX params pytree (numpy leaves) -> this package's, same layout."""
    missing = {"embed", "pos_embed", "layers", "final_ln_w", "final_ln_b"} - set(params_np)
    if missing:
        raise KeyError(f"params_from_jax: the JAX params lack {sorted(missing)}")
    return tree_to_torch(params_np, device, dtype)


# ------------------------------------------------------------------ training
def _block(config: OPTConfig, attention_fn, x, lp):
    b, s, D = x.shape
    H = config.num_heads
    Dh = D // H
    h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], config.ln_eps)
    q = (h @ lp["wq"].to(x.dtype) + lp["bq"].to(x.dtype)).reshape(b, s, H, Dh)
    k = (h @ lp["wk"].to(x.dtype) + lp["bk"].to(x.dtype)).reshape(b, s, H, Dh)
    v = (h @ lp["wv"].to(x.dtype) + lp["bv"].to(x.dtype)).reshape(b, s, H, Dh)
    attn = attention_fn(q, k, v, causal=True)
    x = x + attn.reshape(b, s, D) @ lp["wo"].to(x.dtype) + lp["bo"].to(x.dtype)
    h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], config.ln_eps)
    h = torch.relu(h @ lp["fc1"].to(x.dtype) + lp["b_fc1"].to(x.dtype))
    return x + h @ lp["fc2"].to(x.dtype) + lp["b_fc2"].to(x.dtype)


def forward(config: OPTConfig, params, input_ids, attention_fn=None):
    """input_ids [B, S] -> logits [B, S, V] (positions 0..S-1)."""
    attention_fn = resolve_attention(attention_fn, params["embed"].device)
    s = input_ids.shape[1]
    x = params["embed"][input_ids.long()]
    x = x + params["pos_embed"][POS_OFFSET:POS_OFFSET + s][None].to(x.dtype)
    block = functools.partial(_block, config, attention_fn)
    if config.remat:
        block = checkpoint(block)
    per_layer = tree_map(lambda w: w.unbind(0), params["layers"])
    for i in range(config.num_layers):
        x = block(x, tree_map(lambda ws: ws[i], per_layer))
    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"], config.ln_eps)
    return x @ params["embed"].T.to(x.dtype)  # tied unembedding


def make_loss_fn(config: OPTConfig, attention_fn=None) -> Callable:
    """loss_fn(params, batch, rng) for the engine; ``rng`` is unused."""

    def loss_fn(params, batch, rng=None):
        logits = forward(config, params, batch["input_ids"], attention_fn=attention_fn)
        return cross_entropy_loss(logits, batch["labels"])

    return loss_fn


# --------------------------------------------------------- paged (ragged) serve
def init_paged_cache(config: OPTConfig, num_blocks: int, block_size: int, dtype=torch.bfloat16,
                     device=None):
    return init_paged_kv_pool(config.num_layers, config.num_heads,
                              config.hidden_size // config.num_heads, num_blocks, block_size,
                              dtype=dtype, device=device)


def forward_paged(config: OPTConfig, params, tokens, n_tokens, start_pos, block_tables,
                  kv_cache, *, block_size: int):
    """Ragged chunked OPT forward (learned positions, no rotary); the
    arguments, the in-place pool update and graph safety are
    ``llama.forward_paged``'s."""
    b, tchunk = tokens.shape
    D, H = config.hidden_size, config.num_heads
    Dh = D // H
    safe_pos, valid, lengths, blk, off = paged_chunk_indices(
        tokens, n_tokens, start_pos, block_tables, kv_cache["k"].shape[1], block_size)
    write_idx = paged_write_index(blk, off, H)
    scale = 1.0 / math.sqrt(Dh)
    layers = params["layers"]
    x = params["embed"][tokens.long()].to(kv_cache["k"].dtype)
    x = x + params["pos_embed"][(safe_pos + POS_OFFSET).long()].to(x.dtype)
    for i in range(config.num_layers):
        lp = {k: w[i] for k, w in layers.items()}
        h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], config.ln_eps)
        q = (h @ lp["wq"].to(x.dtype) + lp["bq"].to(x.dtype)).reshape(b, tchunk, H, Dh)
        k = (h @ lp["wk"].to(x.dtype) + lp["bk"].to(x.dtype)).reshape(b, tchunk, H, Dh)
        v = (h @ lp["wv"].to(x.dtype) + lp["bv"].to(x.dtype)).reshape(b, tchunk, H, Dh)
        kpool, vpool = kv_cache["k"][i], kv_cache["v"][i]
        kpool.index_put_(write_idx, k)
        vpool.index_put_(write_idx, v)
        out = paged_attention(q.contiguous(), kpool, vpool, block_tables, lengths, start_pos,
                              n_tokens, block_size=block_size, softmax_scale=scale)
        x = x + out.reshape(b, tchunk, D) @ lp["wo"].to(x.dtype) + lp["bo"].to(x.dtype)
        h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], config.ln_eps)
        h = torch.relu(h @ lp["fc1"].to(x.dtype) + lp["b_fc1"].to(x.dtype))
        x = x + h @ lp["fc2"].to(x.dtype) + lp["b_fc2"].to(x.dtype)
    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"], config.ln_eps)
    return x @ params["embed"].T.to(x.dtype), kv_cache


def paged_bucket_cost(config: OPTConfig, n: int, t: int, b: int, block_size: int, dtype):
    """(FLOPs, bytes) of one :func:`forward_paged` over an ``(n, t, b)``
    bucket (``transformer.paged_cost``)."""
    D, F, L, V = config.hidden_size, config.ffn_dim, config.num_layers, config.vocab_size
    H = config.num_heads
    return paged_cost(n=n, t=t, b=b, block_size=block_size, dtype=dtype, layers=L, heads=H,
                      kv_heads=H, head_dim=D // H, layer_weights=4 * D * D + 2 * D * F,
                      hidden=D, vocab=V, n_params=num_params(config))


# ----------------------------------------------------------------- HF import
def config_from_hf(hf_config) -> OPTConfig:
    if not getattr(hf_config, "do_layer_norm_before", True):
        raise NotImplementedError(
            "post-LN OPT variants (do_layer_norm_before=False, e.g. opt-350m) are not supported: "
            "this implementation is pre-LN")
    if getattr(hf_config, "word_embed_proj_dim", hf_config.hidden_size) != hf_config.hidden_size:
        raise NotImplementedError(
            "OPT variants with word_embed_proj_dim != hidden_size (project_in/out layers, e.g. "
            "opt-350m) are not supported")
    return OPTConfig(vocab_size=hf_config.vocab_size, hidden_size=hf_config.hidden_size,
                     ffn_dim=hf_config.ffn_dim, num_layers=hf_config.num_hidden_layers,
                     num_heads=hf_config.num_attention_heads,
                     max_seq_len=hf_config.max_position_embeddings)


def from_hf_state_dict(config: OPTConfig, state_dict, dtype=torch.float32):
    """An OPTForCausalLM state dict -> this package's params on the CPU.  HF's
    learned positional table already holds the 2 offset rows; torch Linear
    [out, in] is transposed to [in, out]."""
    t = lambda name: hf_tensor(state_dict, name)  # noqa: E731
    pre = "model.decoder.layers.{}"
    stack = lambda fmt, transpose=True: hf_stack(state_dict, fmt, config.num_layers,  # noqa: E731
                                                 dtype, transpose)
    return {
        "embed": t("model.decoder.embed_tokens.weight").to(dtype),
        "pos_embed": t("model.decoder.embed_positions.weight").to(dtype),
        "layers": {
            "ln1_w": stack(pre + ".self_attn_layer_norm.weight", False),
            "ln1_b": stack(pre + ".self_attn_layer_norm.bias", False),
            "ln2_w": stack(pre + ".final_layer_norm.weight", False),
            "ln2_b": stack(pre + ".final_layer_norm.bias", False),
            "wq": stack(pre + ".self_attn.q_proj.weight"),
            "wk": stack(pre + ".self_attn.k_proj.weight"),
            "wv": stack(pre + ".self_attn.v_proj.weight"),
            "wo": stack(pre + ".self_attn.out_proj.weight"),
            "bq": stack(pre + ".self_attn.q_proj.bias", False),
            "bk": stack(pre + ".self_attn.k_proj.bias", False),
            "bv": stack(pre + ".self_attn.v_proj.bias", False),
            "bo": stack(pre + ".self_attn.out_proj.bias", False),
            "fc1": stack(pre + ".fc1.weight"),
            "b_fc1": stack(pre + ".fc1.bias", False),
            "fc2": stack(pre + ".fc2.weight"),
            "b_fc2": stack(pre + ".fc2.bias", False),
        },
        "final_ln_w": t("model.decoder.final_layer_norm.weight").to(dtype),
        "final_ln_b": t("model.decoder.final_layer_norm.bias").to(dtype),
    }

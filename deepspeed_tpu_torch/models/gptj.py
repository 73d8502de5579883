"""GPT-J causal LM (EleutherAI/gpt-j-6B family).

Counterpart of ``deepspeed_tpu/models/gptj.py``: a parallel attention + MLP
block off one shared LayerNorm, partial rotary with GPT-J's interleaved
convention (pairs (2i, 2i+1) rotate together, not Llama's half split), no
attention biases, a biased fc_in/fc_out MLP with the tanh GELU, and an
untied head with a bias.  Layer leaves are flat and stacked ``[L, ...]``.
"""

import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention.paged import paged_attention
from ..runtime.activation_checkpointing import checkpoint
from ..runtime.tree import tree_map
from .transformer import (causal_lm_batch, count_params, cross_entropy_loss, hf_stack, hf_tensor,
                          init_paged_kv_pool, layer_norm, paged_chunk_indices, paged_cost,
                          paged_write_index, resolve_attention, tree_to_torch)


@dataclasses.dataclass(frozen=True)
class GPTJConfig:
    vocab_size: int = 50400
    hidden_size: int = 4096
    ffn_dim: int = 16384
    num_layers: int = 28
    num_heads: int = 16
    rotary_dim: int = 64
    max_seq_len: int = 2048
    ln_eps: float = 1e-5
    remat: bool = True

    @staticmethod
    def gptj_6b():
        return GPTJConfig()

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, seq=64, rotary_dim=8):
        return GPTJConfig(vocab_size=vocab, hidden_size=hidden, ffn_dim=hidden * 4,
                          num_layers=layers, num_heads=heads, rotary_dim=rotary_dim,
                          max_seq_len=seq)


def interleaved_rotary_tables(rotary_dim: int, max_seq: int, base: float = 10000.0):
    """GPT-J's cos/sin tables [max_seq, rotary_dim] with each frequency
    repeated at dims (2i, 2i+1), as numpy float32 computed in float64 as the
    JAX package computes them (bit-identical)."""
    inv_freq = 1.0 / (base**(np.arange(0, rotary_dim, 2) / rotary_dim))
    freqs = np.einsum("i,j->ij", np.arange(max_seq), inv_freq)
    return (np.repeat(np.cos(freqs), 2, axis=1).astype(np.float32),
            np.repeat(np.sin(freqs), 2, axis=1).astype(np.float32))


@functools.lru_cache(maxsize=8)
def device_interleaved_rotary_tables(rotary_dim: int, max_seq: int, device: str):
    """:func:`interleaved_rotary_tables` as fp32 tensors on ``device``,
    uploaded once per process and configuration: a CUDA-graph capture finds
    them built (its warm-up run builds them)."""
    cos, sin = interleaved_rotary_tables(rotary_dim, max_seq)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def _rotate_every_two(x):
    return torch.stack((-x[..., 1::2], x[..., ::2]), dim=-1).flatten(-2)


def apply_rotary_interleaved(x, cos, sin, positions=None):
    """x [B, S, H, rotary_dim]; cos/sin [max_seq, rotary_dim] tensors;
    positions [B, S] (default 0..S-1).  GPT-J's pairwise rotation, with
    cos/sin cast to x's dtype first."""
    if positions is None:
        s = x.shape[1]
        c, sn = cos[:s][None, :, None, :], sin[:s][None, :, None, :]
    else:
        c, sn = cos[positions.long()][:, :, None, :], sin[positions.long()][:, :, None, :]
    c, sn = c.to(x.dtype), sn.to(x.dtype)
    return x * c + _rotate_every_two(x) * sn


def _rotate_qk(config: GPTJConfig, q, k, cos, sin, positions=None):
    rd = config.rotary_dim
    q = torch.cat([apply_rotary_interleaved(q[..., :rd], cos, sin, positions), q[..., rd:]], -1)
    k = torch.cat([apply_rotary_interleaved(k[..., :rd], cos, sin, positions), k[..., rd:]], -1)
    return q, k


def init_params(config: GPTJConfig, generator, dtype=torch.float32, device=None):
    D, F_, L, V = config.hidden_size, config.ffn_dim, config.num_layers, config.vocab_size
    s = D**-0.5

    def randn(*shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device).mul_(scale)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "embed": randn(V, D, scale=0.02),
        "layers": {
            "ln_w": torch.ones((L, D), dtype=dtype, device=device), "ln_b": zeros(L, D),
            "wq": randn(L, D, D, scale=s), "wk": randn(L, D, D, scale=s),
            "wv": randn(L, D, D, scale=s), "wo": randn(L, D, D, scale=s),
            "fc_in": randn(L, D, F_, scale=s), "b_fc_in": zeros(L, F_),
            "fc_out": randn(L, F_, D, scale=s), "b_fc_out": zeros(L, D),
        },
        "final_ln_w": torch.ones((D, ), dtype=dtype, device=device), "final_ln_b": zeros(D),
        "lm_head": randn(D, V, scale=s),
        "lm_head_b": zeros(V),
    }


def num_params(config: GPTJConfig) -> int:
    return count_params(lambda: init_params(config, None))


def params_from_jax(config: GPTJConfig, params_np, device, dtype=torch.float32):
    """The JAX params pytree (numpy leaves) -> this package's, same layout."""
    missing = {"embed", "layers", "final_ln_w", "final_ln_b", "lm_head",
               "lm_head_b"} - set(params_np)
    if missing:
        raise KeyError(f"params_from_jax: the JAX params lack {sorted(missing)}")
    return tree_to_torch(params_np, device, dtype)


# ------------------------------------------------------------------ training
def _block(config: GPTJConfig, cos, sin, attention_fn, x, lp):
    b, s, D = x.shape
    H = config.num_heads
    Dh = D // H
    h = layer_norm(x, lp["ln_w"], lp["ln_b"], config.ln_eps)
    q = (h @ lp["wq"].to(x.dtype)).reshape(b, s, H, Dh)
    k = (h @ lp["wk"].to(x.dtype)).reshape(b, s, H, Dh)
    v = (h @ lp["wv"].to(x.dtype)).reshape(b, s, H, Dh)
    q, k = _rotate_qk(config, q, k, cos, sin)
    attn = attention_fn(q, k, v, causal=True)
    attn_out = attn.reshape(b, s, D) @ lp["wo"].to(x.dtype)
    mlp = F.gelu(h @ lp["fc_in"].to(x.dtype) + lp["b_fc_in"].to(x.dtype), approximate="tanh")
    mlp_out = mlp @ lp["fc_out"].to(x.dtype) + lp["b_fc_out"].to(x.dtype)
    return x + attn_out + mlp_out  # parallel residual


def forward(config: GPTJConfig, params, input_ids, attention_fn=None):
    """input_ids [B, S] -> logits [B, S, V]."""
    device = params["embed"].device
    attention_fn = resolve_attention(attention_fn, device)
    cos, sin = device_interleaved_rotary_tables(config.rotary_dim, config.max_seq_len,
                                                str(device))
    x = params["embed"][input_ids.long()]
    block = functools.partial(_block, config, cos, sin, attention_fn)
    if config.remat:
        block = checkpoint(block)
    per_layer = tree_map(lambda w: w.unbind(0), params["layers"])
    for i in range(config.num_layers):
        x = block(x, tree_map(lambda ws: ws[i], per_layer))
    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"], config.ln_eps)
    return x @ params["lm_head"].to(x.dtype) + params["lm_head_b"].to(x.dtype)


def make_loss_fn(config: GPTJConfig, attention_fn=None) -> Callable:
    """loss_fn(params, batch, rng) for the engine; ``rng`` is unused."""

    def loss_fn(params, batch, rng=None):
        logits = forward(config, params, batch["input_ids"], attention_fn=attention_fn)
        return cross_entropy_loss(logits, batch["labels"])

    return loss_fn


# --------------------------------------------------------- paged (ragged) serve
def init_paged_cache(config: GPTJConfig, num_blocks: int, block_size: int, dtype=torch.bfloat16,
                     device=None):
    return init_paged_kv_pool(config.num_layers, config.num_heads,
                              config.hidden_size // config.num_heads, num_blocks, block_size,
                              dtype=dtype, device=device)


def forward_paged(config: GPTJConfig, params, tokens, n_tokens, start_pos, block_tables,
                  kv_cache, *, block_size: int):
    """Ragged chunked GPT-J forward: the interleaved partial rotary feeds the
    paged kernel; the arguments, the in-place pool update and graph safety
    are ``llama.forward_paged``'s (the rotary tables are
    :func:`device_interleaved_rotary_tables`)."""
    b, tchunk = tokens.shape
    D, H = config.hidden_size, config.num_heads
    Dh = D // H
    scale = 1.0 / math.sqrt(Dh)
    cos, sin = device_interleaved_rotary_tables(config.rotary_dim, config.max_seq_len,
                                                str(tokens.device))
    safe_pos, valid, lengths, blk, off = paged_chunk_indices(
        tokens, n_tokens, start_pos, block_tables, kv_cache["k"].shape[1], block_size)
    write_idx = paged_write_index(blk, off, H)
    layers = params["layers"]
    x = params["embed"][tokens.long()].to(kv_cache["k"].dtype)
    for i in range(config.num_layers):
        lp = {k: w[i] for k, w in layers.items()}
        h = layer_norm(x, lp["ln_w"], lp["ln_b"], config.ln_eps)
        q = (h @ lp["wq"].to(x.dtype)).reshape(b, tchunk, H, Dh)
        k = (h @ lp["wk"].to(x.dtype)).reshape(b, tchunk, H, Dh)
        v = (h @ lp["wv"].to(x.dtype)).reshape(b, tchunk, H, Dh)
        q, k = _rotate_qk(config, q, k, cos, sin, safe_pos)
        kpool, vpool = kv_cache["k"][i], kv_cache["v"][i]
        kpool.index_put_(write_idx, k)
        vpool.index_put_(write_idx, v)
        out = paged_attention(q.contiguous(), kpool, vpool, block_tables, lengths, start_pos,
                              n_tokens, block_size=block_size, softmax_scale=scale)
        attn_out = out.reshape(b, tchunk, D) @ lp["wo"].to(x.dtype)
        mlp = F.gelu(h @ lp["fc_in"].to(x.dtype) + lp["b_fc_in"].to(x.dtype),
                     approximate="tanh")
        mlp_out = mlp @ lp["fc_out"].to(x.dtype)
        x = x + (attn_out + mlp_out) + lp["b_fc_out"].to(x.dtype)
    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"], config.ln_eps)
    logits = x @ params["lm_head"].to(x.dtype) + params["lm_head_b"].to(x.dtype)
    return logits, kv_cache


def paged_bucket_cost(config: GPTJConfig, n: int, t: int, b: int, block_size: int, dtype):
    """(FLOPs, bytes) of one :func:`forward_paged` over an ``(n, t, b)``
    bucket (``transformer.paged_cost``)."""
    D, F_, L, V = config.hidden_size, config.ffn_dim, config.num_layers, config.vocab_size
    H = config.num_heads
    return paged_cost(n=n, t=t, b=b, block_size=block_size, dtype=dtype, layers=L, heads=H,
                      kv_heads=H, head_dim=D // H, layer_weights=4 * D * D + 2 * D * F_,
                      hidden=D, vocab=V, n_params=num_params(config))


# ----------------------------------------------------------------- HF import
def config_from_hf(hf_config) -> GPTJConfig:
    return GPTJConfig(vocab_size=hf_config.vocab_size, hidden_size=hf_config.n_embd,
                      ffn_dim=hf_config.n_inner or 4 * hf_config.n_embd,
                      num_layers=hf_config.n_layer, num_heads=hf_config.n_head,
                      rotary_dim=hf_config.rotary_dim or hf_config.n_embd // hf_config.n_head,
                      max_seq_len=hf_config.n_positions,
                      ln_eps=getattr(hf_config, "layer_norm_epsilon", 1e-5))


def from_hf_state_dict(config: GPTJConfig, state_dict, dtype=torch.float32):
    """A GPTJForCausalLM state dict (no attention biases; biased fc_in,
    fc_out and lm_head; torch Linear [out, in] -> [in, out]) -> this
    package's params on the CPU."""
    t = lambda name: hf_tensor(state_dict, name)  # noqa: E731
    pre = "transformer.h.{}"
    stack = lambda fmt, transpose=True: hf_stack(state_dict, fmt, config.num_layers,  # noqa: E731
                                                 dtype, transpose)
    return {
        "embed": t("transformer.wte.weight").to(dtype),
        "layers": {
            "ln_w": stack(pre + ".ln_1.weight", False),
            "ln_b": stack(pre + ".ln_1.bias", False),
            "wq": stack(pre + ".attn.q_proj.weight"),
            "wk": stack(pre + ".attn.k_proj.weight"),
            "wv": stack(pre + ".attn.v_proj.weight"),
            "wo": stack(pre + ".attn.out_proj.weight"),
            "fc_in": stack(pre + ".mlp.fc_in.weight"),
            "b_fc_in": stack(pre + ".mlp.fc_in.bias", False),
            "fc_out": stack(pre + ".mlp.fc_out.weight"),
            "b_fc_out": stack(pre + ".mlp.fc_out.bias", False),
        },
        "final_ln_w": t("transformer.ln_f.weight").to(dtype),
        "final_ln_b": t("transformer.ln_f.bias").to(dtype),
        "lm_head": t("lm_head.weight").T.contiguous().to(dtype),
        "lm_head_b": t("lm_head.bias").to(dtype),
    }

"""Llama-family causal LM: the paged (ragged) serving forward.

Counterpart of ``deepspeed_tpu/models/llama.py`` for the v2 serving path.
Params are the JAX package's pytree as nested dicts of tensors: per-layer
leaves stacked on dim 0, weight matrices ``[in, out]``, so
:func:`params_from_jax` carries JAX weights across without reshuffling.  The
layer stack is a Python loop over those stacked leaves.
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..ops.attention.paged import paged_attention
from .transformer import (device_rotary_tables, init_linear, init_paged_kv_pool,
                          paged_chunk_indices, rms_norm, rotate_half, swiglu_mlp)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False

    @staticmethod
    def llama2_7b():
        return LlamaConfig()

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, kv_heads=2, seq=64):
        return LlamaConfig(vocab_size=vocab, hidden_size=hidden, intermediate_size=hidden * 2,
                           num_layers=layers, num_heads=heads, num_kv_heads=kv_heads,
                           max_seq_len=seq)


def init_params(config: LlamaConfig, generator: torch.Generator, dtype=torch.float32,
                device=None):
    """Random params drawn from ``generator`` (on ``device``, which must be
    the generator's device); per-layer leaves stacked on dim 0."""
    L, D, F = config.num_layers, config.hidden_size, config.intermediate_size
    H, KV = config.num_heads, config.num_kv_heads
    head_dim = D // H

    def stack(in_dim, out_dim):
        return init_linear(generator, in_dim, out_dim, dtype=dtype, device=device, layers=L)

    embed = torch.randn((config.vocab_size, D), generator=generator, dtype=dtype,
                        device=device).mul_(0.02)
    params = {
        "embed": embed,
        "layers": {
            "attn": {"wq": stack(D, H * head_dim), "wk": stack(D, KV * head_dim),
                     "wv": stack(D, KV * head_dim), "wo": stack(H * head_dim, D)},
            "mlp": {"w_gate": stack(D, F), "w_up": stack(D, F), "w_down": stack(F, D)},
            "attn_norm": torch.ones((L, D), dtype=dtype, device=device),
            "mlp_norm": torch.ones((L, D), dtype=dtype, device=device),
        },
        "final_norm": torch.ones((D, ), dtype=dtype, device=device),
    }
    if not config.tie_embeddings:
        params["lm_head"] = init_linear(generator, D, config.vocab_size, dtype=dtype,
                                        device=device)
    return params


def num_params(config: LlamaConfig) -> int:
    D, F, L, V = config.hidden_size, config.intermediate_size, config.num_layers, config.vocab_size
    H, KV = config.num_heads, config.num_kv_heads
    head_dim = D // H
    per_layer = (D * (H * head_dim) + 2 * D * (KV * head_dim) + (H * head_dim) * D
                 + D * F * 2 + F * D + 2 * D)
    total = V * D + L * per_layer + D
    if not config.tie_embeddings:
        total += D * V
    return total


def _tree_to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device=device, dtype=dtype)


def params_from_jax(config: LlamaConfig, params_np, device, dtype=torch.float32):
    """The JAX params pytree (leaves as numpy arrays, or anything
    ``np.array`` takes) -> this package's params, same layout."""
    missing = {"embed", "layers", "final_norm"} - set(params_np)
    if not config.tie_embeddings:
        missing |= {"lm_head"} - set(params_np)
    if missing:
        raise KeyError(f"params_from_jax: the JAX params lack {sorted(missing)}")
    return _tree_to_torch(params_np, device, dtype)


def kv_from_jax(kv_np, device, dtype=torch.float32):
    """A JAX paged KV pool {"k", "v"} [L, NB, KV, bs, Dh] -> tensors."""
    return {"k": _tree_to_torch(kv_np["k"], device, dtype),
            "v": _tree_to_torch(kv_np["v"], device, dtype)}


def init_paged_cache(config: LlamaConfig, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device=None):
    """Paged KV pool [L, num_blocks, KV, block_size, Dh]; the last block is the
    trash target for padded-token writes."""
    return init_paged_kv_pool(config.num_layers, config.num_kv_heads,
                              config.hidden_size // config.num_heads, num_blocks, block_size,
                              dtype=dtype, device=device)


def forward_paged(config: LlamaConfig, params, tokens, n_tokens, start_pos, block_tables,
                  kv_cache, *, block_size: int, window: Optional[int] = None):
    """Ragged chunked forward over the paged KV pool.

    tokens [N, T] (right-padded chunks), n_tokens [N] valid counts, start_pos
    [N] absolute start of this chunk, block_tables [N, MAXB] (padded entries
    point at the trash block), all int32.  ``window`` enables Mistral-style
    sliding-window attention.  Returns (logits [N, T, V], kv_cache).

    The KV pool is updated IN PLACE (this chunk's keys and values are written
    into their blocks): the JAX package donates the pool to its jitted step
    and gets the updated pool back; here the same buffers are simply written,
    so the returned cache is the caller's own.
    """
    b, tchunk = tokens.shape
    Dh = config.hidden_size // config.num_heads
    H, KV = config.num_heads, config.num_kv_heads
    cos, sin = device_rotary_tables(Dh, config.max_seq_len, config.rope_theta, str(tokens.device))
    num_blocks = kv_cache["k"].shape[1]
    safe_pos, valid, lengths, blk, off = paged_chunk_indices(
        tokens, n_tokens, start_pos, block_tables, num_blocks, block_size)
    # rotary angles depend on the position only: gather them once for all layers
    c = cos[safe_pos.long()][:, :, None, :]
    s = sin[safe_pos.long()][:, :, None, :]
    write_idx = (blk.long()[:, :, None], torch.arange(KV, device=tokens.device)[None, None, :],
                 off.long()[:, :, None])
    scale = 1.0 / math.sqrt(Dh)
    layers = params["layers"]
    x = params["embed"][tokens.long()].to(kv_cache["k"].dtype)
    for i in range(config.num_layers):
        attn = {k: w[i] for k, w in layers["attn"].items()}
        attn_in = rms_norm(x, layers["attn_norm"][i], config.rms_eps)
        q = (attn_in @ attn["wq"].to(x.dtype)).reshape(b, tchunk, H, Dh)
        k = (attn_in @ attn["wk"].to(x.dtype)).reshape(b, tchunk, KV, Dh)
        v = (attn_in @ attn["wv"].to(x.dtype)).reshape(b, tchunk, KV, Dh)
        q = rotate_half(q, c, s)
        k = rotate_half(k, c, s)
        kpool, vpool = kv_cache["k"][i], kv_cache["v"][i]
        # pool [NB, KV, bs, Dh]: pool[blk, h, off] = k[n, t, h]
        kpool.index_put_(write_idx, k)
        vpool.index_put_(write_idx, v)
        out = paged_attention(q.contiguous(), kpool, vpool, block_tables, lengths, start_pos,
                              n_tokens, block_size=block_size, softmax_scale=scale,
                              window=window)
        x = x + out.reshape(b, tchunk, H * Dh) @ attn["wo"].to(x.dtype)
        mlp = {k: w[i] for k, w in layers["mlp"].items()}
        mlp_in = rms_norm(x, layers["mlp_norm"][i], config.rms_eps)
        x = x + swiglu_mlp(mlp, mlp_in)
    x = rms_norm(x, params["final_norm"], config.rms_eps)
    head = params["embed"].T if config.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype), kv_cache

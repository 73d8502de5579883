"""Falcon causal LM (tiiuae/falcon family).

Counterpart of ``deepspeed_tpu/models/falcon.py``: a parallel attention +
MLP block off one shared LayerNorm (x + attn(ln x) + mlp(ln x)), multi-query
attention (Falcon-7B: 71 q heads over 1 kv head at head dim 64; grouped on
40B), rotary embeddings on the whole head, a 4x MLP with the exact erf GELU,
no projection biases and a tied unembedding.  Layer leaves are flat and
stacked ``[L, ...]``.
"""

import dataclasses
import functools
import math
from typing import Callable

import torch
import torch.nn.functional as F

from ..ops.attention.paged import paged_attention
from ..runtime.activation_checkpointing import checkpoint
from ..runtime.tree import tree_map
from .transformer import (apply_rotary, causal_lm_batch, count_params, cross_entropy_loss,
                          device_rotary_tables, hf_stack, hf_tensor, init_paged_kv_pool,
                          layer_norm, paged_chunk_indices, paged_cost, paged_write_index,
                          resolve_attention, tree_to_torch)


@dataclasses.dataclass(frozen=True)
class FalconConfig:
    vocab_size: int = 65024
    hidden_size: int = 4544
    num_layers: int = 32
    num_heads: int = 71
    num_kv_heads: int = 1          # MQA on falcon-7b
    max_seq_len: int = 2048
    ln_eps: float = 1e-5
    rope_theta: float = 10000.0
    remat: bool = True

    @staticmethod
    def falcon_7b():
        return FalconConfig()

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, kv_heads=1, seq=64):
        return FalconConfig(vocab_size=vocab, hidden_size=hidden, num_layers=layers,
                            num_heads=heads, num_kv_heads=kv_heads, max_seq_len=seq)


def init_params(config: FalconConfig, generator, dtype=torch.float32, device=None):
    D, L, H, KV = config.hidden_size, config.num_layers, config.num_heads, config.num_kv_heads
    Dh = D // H
    s = D**-0.5

    def randn(*shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device).mul_(scale)

    return {
        "embed": randn(config.vocab_size, D, scale=0.02),
        "layers": {
            "ln_w": torch.ones((L, D), dtype=dtype, device=device),
            "ln_b": torch.zeros((L, D), dtype=dtype, device=device),
            "wq": randn(L, D, H * Dh, scale=s), "wk": randn(L, D, KV * Dh, scale=s),
            "wv": randn(L, D, KV * Dh, scale=s), "wo": randn(L, H * Dh, D, scale=s),
            "fc1": randn(L, D, 4 * D, scale=s), "fc2": randn(L, 4 * D, D, scale=s),
        },
        "final_ln_w": torch.ones((D, ), dtype=dtype, device=device),
        "final_ln_b": torch.zeros((D, ), dtype=dtype, device=device),
    }


def num_params(config: FalconConfig) -> int:
    return count_params(lambda: init_params(config, None))


def params_from_jax(config: FalconConfig, params_np, device, dtype=torch.float32):
    """The JAX params pytree (numpy leaves) -> this package's, same layout."""
    missing = {"embed", "layers", "final_ln_w", "final_ln_b"} - set(params_np)
    if missing:
        raise KeyError(f"params_from_jax: the JAX params lack {sorted(missing)}")
    return tree_to_torch(params_np, device, dtype)


def _qkv(config: FalconConfig, lp, h, cos, sin, positions=None):
    """q [B, S, H, Dh] and k, v [B, S, KV, Dh] of ``h``, q and k rotated."""
    b, s, D = h.shape
    H, KV = config.num_heads, config.num_kv_heads
    Dh = D // H
    q = (h @ lp["wq"].to(h.dtype)).reshape(b, s, H, Dh)
    k = (h @ lp["wk"].to(h.dtype)).reshape(b, s, KV, Dh)
    v = (h @ lp["wv"].to(h.dtype)).reshape(b, s, KV, Dh)
    return apply_rotary(q, cos, sin, positions), apply_rotary(k, cos, sin, positions), v


def _mlp(lp, h):
    # HF Falcon's 'gelu' is the exact erf form, not tanh (Phi's gelu_new is tanh)
    return F.gelu(h @ lp["fc1"].to(h.dtype)) @ lp["fc2"].to(h.dtype)


# ------------------------------------------------------------------ training
def _block(config: FalconConfig, cos, sin, attention_fn, x, lp):
    b, s, _ = x.shape
    h = layer_norm(x, lp["ln_w"], lp["ln_b"], config.ln_eps)
    q, k, v = _qkv(config, lp, h, cos, sin)
    attn = attention_fn(q, k, v, causal=True)
    attn_out = attn.reshape(b, s, -1) @ lp["wo"].to(x.dtype)
    return x + attn_out + _mlp(lp, h)  # parallel residual


def forward(config: FalconConfig, params, input_ids, attention_fn=None):
    """input_ids [B, S] -> logits [B, S, V]."""
    device = params["embed"].device
    attention_fn = resolve_attention(attention_fn, device)
    cos, sin = device_rotary_tables(config.hidden_size // config.num_heads, config.max_seq_len,
                                    config.rope_theta, str(device))
    x = params["embed"][input_ids.long()]
    block = functools.partial(_block, config, cos, sin, attention_fn)
    if config.remat:
        block = checkpoint(block)
    per_layer = tree_map(lambda w: w.unbind(0), params["layers"])
    for i in range(config.num_layers):
        x = block(x, tree_map(lambda ws: ws[i], per_layer))
    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"], config.ln_eps)
    return x @ params["embed"].T.to(x.dtype)  # tied unembedding


def make_loss_fn(config: FalconConfig, attention_fn=None) -> Callable:
    """loss_fn(params, batch, rng) for the engine; ``rng`` is unused."""

    def loss_fn(params, batch, rng=None):
        logits = forward(config, params, batch["input_ids"], attention_fn=attention_fn)
        return cross_entropy_loss(logits, batch["labels"])

    return loss_fn


# --------------------------------------------------------- paged (ragged) serve
def init_paged_cache(config: FalconConfig, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device=None):
    """The pool holds ``num_kv_heads`` kv heads: 1 for Falcon-7B."""
    return init_paged_kv_pool(config.num_layers, config.num_kv_heads,
                              config.hidden_size // config.num_heads, num_blocks, block_size,
                              dtype=dtype, device=device)


def forward_paged(config: FalconConfig, params, tokens, n_tokens, start_pos, block_tables,
                  kv_cache, *, block_size: int):
    """Ragged chunked Falcon forward: the multi-query pool (one kv head on
    7B) feeds the paged kernel, which maps all of a kv head's q heads onto
    it (a group of 71).  The arguments, the in-place pool update and graph
    safety are ``llama.forward_paged``'s."""
    b, tchunk = tokens.shape
    H, KV = config.num_heads, config.num_kv_heads
    Dh = config.hidden_size // H
    scale = 1.0 / math.sqrt(Dh)
    cos, sin = device_rotary_tables(Dh, config.max_seq_len, config.rope_theta, str(tokens.device))
    safe_pos, valid, lengths, blk, off = paged_chunk_indices(
        tokens, n_tokens, start_pos, block_tables, kv_cache["k"].shape[1], block_size)
    write_idx = paged_write_index(blk, off, KV)
    layers = params["layers"]
    x = params["embed"][tokens.long()].to(kv_cache["k"].dtype)
    for i in range(config.num_layers):
        lp = {k: w[i] for k, w in layers.items()}
        h = layer_norm(x, lp["ln_w"], lp["ln_b"], config.ln_eps)
        q, k, v = _qkv(config, lp, h, cos, sin, safe_pos)
        kpool, vpool = kv_cache["k"][i], kv_cache["v"][i]
        kpool.index_put_(write_idx, k)
        vpool.index_put_(write_idx, v)
        out = paged_attention(q.contiguous(), kpool, vpool, block_tables, lengths, start_pos,
                              n_tokens, block_size=block_size, softmax_scale=scale)
        attn_out = out.reshape(b, tchunk, H * Dh) @ lp["wo"].to(x.dtype)
        x = x + (attn_out + _mlp(lp, h))
    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"], config.ln_eps)
    return x @ params["embed"].T.to(x.dtype), kv_cache


def paged_bucket_cost(config: FalconConfig, n: int, t: int, b: int, block_size: int, dtype):
    """(FLOPs, bytes) of one :func:`forward_paged` over an ``(n, t, b)``
    bucket (``transformer.paged_cost``)."""
    D, L, V = config.hidden_size, config.num_layers, config.vocab_size
    H, KV = config.num_heads, config.num_kv_heads
    Dh = D // H
    return paged_cost(n=n, t=t, b=b, block_size=block_size, dtype=dtype, layers=L, heads=H,
                      kv_heads=KV, head_dim=Dh,
                      layer_weights=D * (H + 2 * KV) * Dh + H * Dh * D + 8 * D * D,
                      hidden=D, vocab=V, n_params=num_params(config))


# ----------------------------------------------------------------- HF import
def config_from_hf(hf_config) -> FalconConfig:
    if getattr(hf_config, "new_decoder_architecture", False):
        raise NotImplementedError(
            "new-decoder-architecture Falcon (40B/180B: ln_attn/ln_mlp split "
            "norms) is not supported by this importer")
    if getattr(hf_config, "alibi", False):
        raise NotImplementedError("alibi Falcon variants (falcon-rw) are not "
                                  "supported — this implementation is rotary")
    if getattr(hf_config, "bias", False):
        raise NotImplementedError("bias=True Falcon variants are not supported")
    if not getattr(hf_config, "parallel_attn", True):
        raise NotImplementedError("sequential-attention Falcon variants "
                                  "(parallel_attn=False) are not supported")
    # old decoder architecture: multi-query -> 1 kv head, else full MHA
    kv = 1 if getattr(hf_config, "multi_query", True) else hf_config.num_attention_heads
    return FalconConfig(vocab_size=hf_config.vocab_size, hidden_size=hf_config.hidden_size,
                        num_layers=hf_config.num_hidden_layers,
                        num_heads=hf_config.num_attention_heads, num_kv_heads=kv,
                        max_seq_len=getattr(hf_config, "max_position_embeddings", 2048),
                        ln_eps=getattr(hf_config, "layer_norm_epsilon", 1e-5),
                        rope_theta=getattr(hf_config, "rope_theta", 10000.0))


def from_hf_state_dict(config: FalconConfig, state_dict, dtype=torch.float32):
    """A FalconForCausalLM state dict -> this package's params on the CPU.
    HF stores one fused ``query_key_value`` [(H + 2 KV) Dh, D]: multi-query
    as [q x H, k, v], grouped or full MHA interleaved per group as [q x
    (H / KV), k, v] a kv head; it is split into wq / wk / wv, and torch
    Linear [out, in] is transposed to [in, out]."""
    t = lambda name: hf_tensor(state_dict, name)  # noqa: E731
    H, KV = config.num_heads, config.num_kv_heads
    Dh = config.hidden_size // H
    L = config.num_layers
    pre = "transformer.h.{}"
    wq, wk, wv = [], [], []
    for i in range(L):
        qkv = t(f"transformer.h.{i}.self_attention.query_key_value.weight")  # [(H+2KV)Dh, D]
        if KV == 1:  # multi-query: [q x H, k, v]
            q, k, v = qkv[:H * Dh], qkv[H * Dh:(H + 1) * Dh], qkv[(H + 1) * Dh:]
        else:  # grouped: interleaved per group [q x (H / KV), k, v]
            grp = H // KV
            blocks = qkv.reshape(KV, (grp + 2) * Dh, -1)
            q = blocks[:, :grp * Dh].reshape(H * Dh, -1)
            k = blocks[:, grp * Dh:(grp + 1) * Dh].reshape(KV * Dh, -1)
            v = blocks[:, (grp + 1) * Dh:].reshape(KV * Dh, -1)
        wq.append(q.T)
        wk.append(k.T)
        wv.append(v.T)
    stack = lambda fmt, transpose=True: hf_stack(state_dict, fmt, L, dtype,  # noqa: E731
                                                 transpose)
    return {
        "embed": t("transformer.word_embeddings.weight").to(dtype),
        "layers": {
            "ln_w": stack(pre + ".input_layernorm.weight", False),
            "ln_b": stack(pre + ".input_layernorm.bias", False),
            "wq": torch.stack(wq).to(dtype),
            "wk": torch.stack(wk).to(dtype),
            "wv": torch.stack(wv).to(dtype),
            "wo": stack(pre + ".self_attention.dense.weight"),
            "fc1": stack(pre + ".mlp.dense_h_to_4h.weight"),
            "fc2": stack(pre + ".mlp.dense_4h_to_h.weight"),
        },
        "final_ln_w": t("transformer.ln_f.weight").to(dtype),
        "final_ln_b": t("transformer.ln_f.bias").to(dtype),
    }

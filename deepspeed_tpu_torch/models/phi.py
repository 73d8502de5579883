"""Phi causal LM (microsoft/phi-2 family).

Counterpart of ``deepspeed_tpu/models/phi.py``: a parallel attention + MLP
block off one shared LayerNorm, as Falcon's, but with biases everywhere;
partial rotary (Llama's rotate-half on the leading ``rotary_dim`` of each
head: 32 of Phi-2's 80); a biased fc1/fc2 MLP with the tanh GELU; an untied
head with a bias.  Layer leaves are flat and stacked ``[L, ...]``.
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
class PhiConfig:
    vocab_size: int = 51200
    hidden_size: int = 2560
    ffn_dim: int = 10240
    num_layers: int = 32
    num_heads: int = 32
    max_seq_len: int = 2048
    partial_rotary_factor: float = 0.4
    ln_eps: float = 1e-5
    rope_theta: float = 10000.0
    remat: bool = True

    @property
    def rotary_dim(self) -> int:
        dh = self.hidden_size // self.num_heads
        # HF phi rounds the rotary slice to an even size
        return int(dh * self.partial_rotary_factor) // 2 * 2

    @staticmethod
    def phi_2():
        return PhiConfig()

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, seq=64):
        return PhiConfig(vocab_size=vocab, hidden_size=hidden, ffn_dim=hidden * 4,
                         num_layers=layers, num_heads=heads, max_seq_len=seq,
                         partial_rotary_factor=0.5)


def partial_rotary(x, cos, sin, rotary_dim: int, positions=None):
    """Rotate only the leading ``rotary_dim`` of the head dim; the rest
    passes (``transformer.apply_rotary`` on the slice)."""
    rot = apply_rotary(x[..., :rotary_dim], cos, sin, positions)
    return torch.cat([rot, x[..., rotary_dim:]], dim=-1)


def init_params(config: PhiConfig, generator, dtype=torch.float32, device=None):
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
            "wq": randn(L, D, D, scale=s), "bq": zeros(L, D),
            "wk": randn(L, D, D, scale=s), "bk": zeros(L, D),
            "wv": randn(L, D, D, scale=s), "bv": zeros(L, D),
            "wo": randn(L, D, D, scale=s), "bo": zeros(L, D),
            "fc1": randn(L, D, F_, scale=s), "b_fc1": zeros(L, F_),
            "fc2": randn(L, F_, D, scale=s), "b_fc2": zeros(L, D),
        },
        "final_ln_w": torch.ones((D, ), dtype=dtype, device=device), "final_ln_b": zeros(D),
        "lm_head": randn(D, V, scale=s),
        "lm_head_b": zeros(V),
    }


def num_params(config: PhiConfig) -> int:
    return count_params(lambda: init_params(config, None))


def params_from_jax(config: PhiConfig, params_np, device, dtype=torch.float32):
    """The JAX params pytree (numpy leaves) -> this package's, same layout."""
    missing = {"embed", "layers", "final_ln_w", "final_ln_b", "lm_head",
               "lm_head_b"} - set(params_np)
    if missing:
        raise KeyError(f"params_from_jax: the JAX params lack {sorted(missing)}")
    return tree_to_torch(params_np, device, dtype)


def _qkv(config: PhiConfig, lp, h, cos, sin, positions=None):
    """The biased q/k/v projections of ``h`` [B, S, D], partially rotated."""
    b, s, D = h.shape
    H = config.num_heads
    q = (h @ lp["wq"].to(h.dtype) + lp["bq"].to(h.dtype)).reshape(b, s, H, D // H)
    k = (h @ lp["wk"].to(h.dtype) + lp["bk"].to(h.dtype)).reshape(b, s, H, D // H)
    v = (h @ lp["wv"].to(h.dtype) + lp["bv"].to(h.dtype)).reshape(b, s, H, D // H)
    q = partial_rotary(q, cos, sin, config.rotary_dim, positions)
    k = partial_rotary(k, cos, sin, config.rotary_dim, positions)
    return q, k, v


def _mlp(lp, h):
    """fc2(gelu_tanh(fc1 h)), without fc2's bias."""
    x = F.gelu(h @ lp["fc1"].to(h.dtype) + lp["b_fc1"].to(h.dtype), approximate="tanh")
    return x @ lp["fc2"].to(h.dtype)


# ------------------------------------------------------------------ training
def _block(config: PhiConfig, cos, sin, attention_fn, x, lp):
    b, s, D = x.shape
    h = layer_norm(x, lp["ln_w"], lp["ln_b"], config.ln_eps)
    q, k, v = _qkv(config, lp, h, cos, sin)
    attn = attention_fn(q, k, v, causal=True)
    attn_out = attn.reshape(b, s, D) @ lp["wo"].to(x.dtype) + lp["bo"].to(x.dtype)
    mlp_out = _mlp(lp, h) + lp["b_fc2"].to(x.dtype)
    return x + attn_out + mlp_out  # parallel residual


def forward(config: PhiConfig, params, input_ids, attention_fn=None):
    """input_ids [B, S] -> logits [B, S, V]."""
    device = params["embed"].device
    attention_fn = resolve_attention(attention_fn, device)
    cos, sin = device_rotary_tables(config.rotary_dim, config.max_seq_len, config.rope_theta,
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


def make_loss_fn(config: PhiConfig, attention_fn=None) -> Callable:
    """loss_fn(params, batch, rng) for the engine; ``rng`` is unused."""

    def loss_fn(params, batch, rng=None):
        logits = forward(config, params, batch["input_ids"], attention_fn=attention_fn)
        return cross_entropy_loss(logits, batch["labels"])

    return loss_fn


# --------------------------------------------------------- paged (ragged) serve
def init_paged_cache(config: PhiConfig, num_blocks: int, block_size: int, dtype=torch.bfloat16,
                     device=None):
    return init_paged_kv_pool(config.num_layers, config.num_heads,
                              config.hidden_size // config.num_heads, num_blocks, block_size,
                              dtype=dtype, device=device)


def forward_paged(config: PhiConfig, params, tokens, n_tokens, start_pos, block_tables, kv_cache,
                  *, block_size: int):
    """Ragged chunked Phi forward: the partial rotary feeds the paged kernel
    at head dim 80; ``bo`` and ``b_fc2`` are added after the parallel sum,
    as the JAX forward adds them.  The arguments, the in-place pool update
    and graph safety are ``llama.forward_paged``'s."""
    b, tchunk = tokens.shape
    D, H = config.hidden_size, config.num_heads
    scale = 1.0 / math.sqrt(D // H)
    cos, sin = device_rotary_tables(config.rotary_dim, config.max_seq_len, config.rope_theta,
                                    str(tokens.device))
    safe_pos, valid, lengths, blk, off = paged_chunk_indices(
        tokens, n_tokens, start_pos, block_tables, kv_cache["k"].shape[1], block_size)
    write_idx = paged_write_index(blk, off, H)
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
        attn_out = out.reshape(b, tchunk, D) @ lp["wo"].to(x.dtype)
        x = x + (attn_out + _mlp(lp, h)) + lp["bo"].to(x.dtype) + lp["b_fc2"].to(x.dtype)
    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"], config.ln_eps)
    logits = x @ params["lm_head"].to(x.dtype) + params["lm_head_b"].to(x.dtype)
    return logits, kv_cache


def paged_bucket_cost(config: PhiConfig, n: int, t: int, b: int, block_size: int, dtype):
    """(FLOPs, bytes) of one :func:`forward_paged` over an ``(n, t, b)``
    bucket (``transformer.paged_cost``)."""
    D, F_, L, V = config.hidden_size, config.ffn_dim, config.num_layers, config.vocab_size
    H = config.num_heads
    return paged_cost(n=n, t=t, b=b, block_size=block_size, dtype=dtype, layers=L, heads=H,
                      kv_heads=H, head_dim=D // H, layer_weights=4 * D * D + 2 * D * F_,
                      hidden=D, vocab=V, n_params=num_params(config))


# ----------------------------------------------------------------- HF import
def config_from_hf(hf_config) -> PhiConfig:
    if getattr(hf_config, "qk_layernorm", False):
        raise NotImplementedError("qk_layernorm Phi variants are not supported")
    kv = getattr(hf_config, "num_key_value_heads", None)
    if kv is not None and kv != hf_config.num_attention_heads:
        raise NotImplementedError("GQA Phi variants (num_key_value_heads < "
                                  "num_attention_heads) are not supported")
    return PhiConfig(vocab_size=hf_config.vocab_size, hidden_size=hf_config.hidden_size,
                     ffn_dim=hf_config.intermediate_size,
                     num_layers=hf_config.num_hidden_layers,
                     num_heads=hf_config.num_attention_heads,
                     max_seq_len=hf_config.max_position_embeddings,
                     partial_rotary_factor=getattr(hf_config, "partial_rotary_factor", 0.4),
                     ln_eps=getattr(hf_config, "layer_norm_eps", 1e-5),
                     rope_theta=getattr(hf_config, "rope_theta", 10000.0))


def from_hf_state_dict(config: PhiConfig, state_dict, dtype=torch.float32):
    """A PhiForCausalLM state dict (biases everywhere, ``self_attn.dense``
    as the output projection, ``final_layernorm``, an untied biased head;
    torch Linear [out, in] -> [in, out]) -> this package's params on the
    CPU."""
    t = lambda name: hf_tensor(state_dict, name)  # noqa: E731
    pre = "model.layers.{}"
    stack = lambda fmt, transpose=True: hf_stack(state_dict, fmt, config.num_layers,  # noqa: E731
                                                 dtype, transpose)
    return {
        "embed": t("model.embed_tokens.weight").to(dtype),
        "layers": {
            "ln_w": stack(pre + ".input_layernorm.weight", False),
            "ln_b": stack(pre + ".input_layernorm.bias", False),
            "wq": stack(pre + ".self_attn.q_proj.weight"),
            "bq": stack(pre + ".self_attn.q_proj.bias", False),
            "wk": stack(pre + ".self_attn.k_proj.weight"),
            "bk": stack(pre + ".self_attn.k_proj.bias", False),
            "wv": stack(pre + ".self_attn.v_proj.weight"),
            "bv": stack(pre + ".self_attn.v_proj.bias", False),
            "wo": stack(pre + ".self_attn.dense.weight"),
            "bo": stack(pre + ".self_attn.dense.bias", False),
            "fc1": stack(pre + ".mlp.fc1.weight"),
            "b_fc1": stack(pre + ".mlp.fc1.bias", False),
            "fc2": stack(pre + ".mlp.fc2.weight"),
            "b_fc2": stack(pre + ".mlp.fc2.bias", False),
        },
        "final_ln_w": t("model.final_layernorm.weight").to(dtype),
        "final_ln_b": t("model.final_layernorm.bias").to(dtype),
        "lm_head": t("lm_head.weight").T.contiguous().to(dtype),
        "lm_head_b": t("lm_head.bias").to(dtype),
    }

"""BLOOM causal LM (bigscience/bloom family).

Counterpart of ``deepspeed_tpu/models/bloom.py``: a LayerNorm after the word
embeddings, ALiBi positional biases (no rotary, no learned positions), a
fused QKV interleaved per head (HF's ``(q, k, v)`` per head) with biases,
sequential residuals, a biased tanh-GELU 4x MLP and a tied unembedding.
Layer leaves are flat and stacked ``[L, ...]``, weights ``[in, out]``.

ALiBi: head h adds ``slope_h * key_index`` to its scores.  The key-only form
is softmax-equivalent to the relative-distance form (each query row differs
by a constant), as HF builds it (``build_alibi_tensor``).  The dense
``forward`` and the v1 ``forward_with_cache`` run the biased attention in
plain torch (``_biased_sdpa``, fp32 scores, as the JAX package leaves it to
XLA); ``forward_paged`` (v2 ragged serving through ``InferenceEngineV2(bloom,
...)``; ``build_engine`` has no BLOOM key, as in the JAX factory) hands the
slopes to the paged kernel's ``alibi_slopes`` operand.  Not ported: the
tensor-parallel rules and ``forward_paged``'s ``tp_axis`` (ROADMAP item 11).
"""

import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention.paged import paged_attention
from ..runtime.activation_checkpointing import checkpoint
from ..runtime.tree import tree_map
from .transformer import (causal_lm_batch, count_params, cross_entropy_loss, hf_stack, hf_tensor,
                          init_paged_kv_pool, layer_norm, materialize, paged_chunk_indices,
                          paged_cost, paged_write_index, tree_to_torch)


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    vocab_size: int = 250880
    hidden_size: int = 4096
    num_layers: int = 30
    num_heads: int = 32
    max_seq_len: int = 2048
    ln_eps: float = 1e-5
    remat: bool = True

    @staticmethod
    def bloom_7b1():
        return BloomConfig()

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, seq=64):
        return BloomConfig(vocab_size=vocab, hidden_size=hidden, num_layers=layers,
                           num_heads=heads, max_seq_len=seq)


def alibi_slopes(num_heads: int) -> np.ndarray:
    """The ALiBi slope schedule (HF ``build_alibi_tensor``): powers of
    2^(-8/n) for the nearest power-of-two head count n, and the odd powers
    of the schedule for 2n for the heads beyond it."""

    def pow2_slopes(n):
        start = 2.0**(-(2.0**-(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        return np.asarray(pow2_slopes(num_heads), np.float32)
    closest = 2**math.floor(math.log2(num_heads))
    extra = pow2_slopes(2 * closest)[0::2][:num_heads - closest]
    return np.asarray(pow2_slopes(closest) + extra, np.float32)


@functools.lru_cache(maxsize=8)
def device_alibi_slopes(num_heads: int, device: str) -> torch.Tensor:
    """:func:`alibi_slopes` as an fp32 tensor on ``device``, uploaded once a
    process and head count: ``forward_paged`` runs inside the v2 engine's
    CUDA-graph captures, where a host-to-device copy must not happen."""
    return torch.from_numpy(alibi_slopes(num_heads)).to(device)


def _biased_sdpa(q, k, v, slopes, kpos, causal_mask):
    """Attention with each head's ALiBi key bias, scores in fp32.  q/k/v
    [B, S(q/k), H, D]; ``kpos`` [Sk] absolute key positions;
    ``causal_mask`` [Sq, Sk] bool."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = scores + slopes[None, :, None, None] * kpos[None, None, None, :].float()
    scores = torch.where(causal_mask[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def init_params(config: BloomConfig, generator, dtype=torch.float32, device=None):
    """Random params drawn from ``generator`` (on ``device``); per-layer
    leaves stacked on dim 0.  ``w_qkv`` is [D, 3D] with its columns grouped
    (q, k, v) per head, HF's layout."""
    D, L, V = config.hidden_size, config.num_layers, config.vocab_size
    s = D**-0.5

    def randn(*shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device).mul_(scale)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "embed": randn(V, D, scale=0.02),
        "embed_ln_w": ones(D), "embed_ln_b": zeros(D),
        "layers": {
            "ln1_w": ones(L, D), "ln1_b": zeros(L, D),
            "ln2_w": ones(L, D), "ln2_b": zeros(L, D),
            "w_qkv": randn(L, D, 3 * D, scale=s), "b_qkv": zeros(L, 3 * D),
            "wo": randn(L, D, D, scale=s), "bo": zeros(L, D),
            "fc1": randn(L, D, 4 * D, scale=s), "b_fc1": zeros(L, 4 * D),
            "fc2": randn(L, 4 * D, D, scale=s), "b_fc2": zeros(L, D),
        },
        "final_ln_w": ones(D), "final_ln_b": zeros(D),
    }


def num_params(config: BloomConfig) -> int:
    return count_params(lambda: init_params(config, None))


def params_from_jax(config: BloomConfig, params_np, device, dtype=torch.float32):
    """The JAX params pytree (numpy leaves) -> this package's, same layout."""
    missing = {"embed", "embed_ln_w", "embed_ln_b", "layers", "final_ln_w",
               "final_ln_b"} - set(params_np)
    if missing:
        raise KeyError(f"params_from_jax: the JAX params lack {sorted(missing)}")
    return tree_to_torch(params_np, device, dtype)


def _split_qkv(config: BloomConfig, fused, b, s):
    """[B, S, 3D] interleaved per head -> q, k, v [B, S, H, Dh] each."""
    H = config.num_heads
    fused = fused.reshape(b, s, H, 3, config.hidden_size // H)
    return fused[..., 0, :], fused[..., 1, :], fused[..., 2, :]


def _mlp(lp, h):
    h = F.gelu(h @ lp["fc1"].to(h.dtype) + lp["b_fc1"].to(h.dtype), approximate="tanh")
    return h @ lp["fc2"].to(h.dtype) + lp["b_fc2"].to(h.dtype)


def _attend(config: BloomConfig, lp, x, attend):
    """One block: ``attend(q, k, v)`` -> [B, S, H, Dh] is the attention."""
    b, s, D = x.shape
    h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], config.ln_eps)
    qkv = h @ lp["w_qkv"].to(x.dtype) + lp["b_qkv"].to(x.dtype)
    attn = attend(*_split_qkv(config, qkv, b, s))
    x = x + attn.reshape(b, s, D) @ lp["wo"].to(x.dtype) + lp["bo"].to(x.dtype)
    return x + _mlp(lp, layer_norm(x, lp["ln2_w"], lp["ln2_b"], config.ln_eps))


def _block(config: BloomConfig, slopes, kpos, causal_mask, x, lp):
    return _attend(config, lp, x,
                   lambda q, k, v: _biased_sdpa(q, k, v, slopes, kpos, causal_mask))


def _embed(config: BloomConfig, params, ids, dtype=None):
    x = params["embed"][ids]
    x = x if dtype is None else x.to(dtype)
    return layer_norm(x, params["embed_ln_w"], params["embed_ln_b"], config.ln_eps)


def _head(config: BloomConfig, params, x):
    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"], config.ln_eps)
    return x @ materialize(params["embed"]).T.to(x.dtype)  # tied unembedding


# ------------------------------------------------------------------ training
def forward(config: BloomConfig, params, input_ids, attention_fn=None):
    """input_ids [B, S] -> logits [B, S, V].  ``attention_fn`` is ignored,
    as in the JAX package: ALiBi needs the biased attention."""
    del attention_fn
    device = params["embed"].device
    s = input_ids.shape[1]
    slopes = device_alibi_slopes(config.num_heads, str(device))
    kpos = torch.arange(s, device=device)
    block = functools.partial(_block, config, slopes, kpos, kpos[None, :] <= kpos[:, None])
    if config.remat:
        block = checkpoint(block)
    x = _embed(config, params, input_ids.long())
    per_layer = tree_map(lambda w: w.unbind(0), params["layers"])
    for i in range(config.num_layers):
        x = block(x, tree_map(lambda ws: ws[i], per_layer))
    return _head(config, params, x)


def make_loss_fn(config: BloomConfig, attention_fn=None) -> Callable:
    """loss_fn(params, batch, rng) for the engine; ``rng`` is unused."""

    def loss_fn(params, batch, rng=None):
        logits = forward(config, params, batch["input_ids"])
        return cross_entropy_loss(logits, batch["labels"])

    return loss_fn


# ------------------------------------------------------------ v1 inference
def init_cache(config: BloomConfig, batch: int, max_seq: Optional[int] = None,
               dtype=torch.bfloat16, device=None):
    """Dense KV cache for incremental decoding (``llama.init_cache``'s
    layout): [L, B, S_max, H, Dh] k and v and ``len``, a host int."""
    S = max_seq or config.max_seq_len
    shape = (config.num_layers, batch, S, config.num_heads,
             config.hidden_size // config.num_heads)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "len": 0}


def forward_with_cache(config: BloomConfig, params, input_ids, cache, attention_fn=None):
    """Incremental forward with ALiBi over absolute key positions: logits
    [B, S, V] and the cache, whose k/v this call writes IN PLACE at ``len``
    (as ``llama.forward_with_cache``; the JAX function returns new
    buffers).  Stacked leaves are read one layer at a time."""
    del attention_fn
    device, dtype = cache["k"].device, cache["k"].dtype
    ids = input_ids.long()
    b, s = ids.shape
    start = cache["len"]
    slopes = device_alibi_slopes(config.num_heads, str(device))
    kpos = torch.arange(cache["k"].shape[2], device=device)
    qpos = start + torch.arange(s, device=device)
    mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < start + s)
    x = _embed(config, params, ids, dtype)
    for i in range(config.num_layers):
        lp = tree_map(lambda w: w[i], params["layers"])
        kc, vc = cache["k"][i], cache["v"][i]

        def attend(q, k, v):
            kc[:, start:start + s] = k
            vc[:, start:start + s] = v
            return _biased_sdpa(q, kc, vc, slopes, kpos, mask)

        x = _attend(config, lp, x, attend)
    return _head(config, params, x), {"k": cache["k"], "v": cache["v"], "len": start + s}


# --------------------------------------------------------- paged (ragged) serve
def init_paged_cache(config: BloomConfig, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device=None):
    return init_paged_kv_pool(config.num_layers, config.num_heads,
                              config.hidden_size // config.num_heads, num_blocks, block_size,
                              dtype=dtype, device=device)


def forward_paged(config: BloomConfig, params, tokens, n_tokens, start_pos, block_tables,
                  kv_cache, *, block_size: int):
    """Ragged chunked BLOOM forward: ALiBi rides the paged kernel's
    ``alibi_slopes`` operand (the key-only form over the absolute key
    index).  The arguments, the in-place pool update and graph safety are
    ``llama.forward_paged``'s; the slopes come from
    :func:`device_alibi_slopes`, uploaded at the first (warm-up) call."""
    b, tchunk = tokens.shape
    H = config.num_heads
    Dh = config.hidden_size // H
    slopes = device_alibi_slopes(H, str(tokens.device))
    _, _, lengths, blk, off = paged_chunk_indices(
        tokens, n_tokens, start_pos, block_tables, kv_cache["k"].shape[1], block_size)
    write_idx = paged_write_index(blk, off, H)
    scale = 1.0 / math.sqrt(Dh)
    x = _embed(config, params, tokens.long(), kv_cache["k"].dtype)
    for i in range(config.num_layers):
        lp = {k: w[i] for k, w in params["layers"].items()}
        kpool, vpool = kv_cache["k"][i], kv_cache["v"][i]

        def attend(q, k, v):
            kpool.index_put_(write_idx, k)
            vpool.index_put_(write_idx, v)
            return paged_attention(q.contiguous(), kpool, vpool, block_tables, lengths,
                                   start_pos, n_tokens, block_size=block_size,
                                   softmax_scale=scale, alibi_slopes=slopes)

        x = _attend(config, lp, x, attend)
    return _head(config, params, x), kv_cache


def paged_bucket_cost(config: BloomConfig, n: int, t: int, b: int, block_size: int,
                      dtype) -> Tuple[float, float]:
    """(FLOPs, bytes) of one :func:`forward_paged` over an ``(n, t, b)``
    bucket (``transformer.paged_cost``): q/k/v, wo, fc1 and fc2 make 12 D^2
    weights a layer; the tied head is ``hidden x vocab``."""
    D, L, V, H = config.hidden_size, config.num_layers, config.vocab_size, config.num_heads
    return paged_cost(n=n, t=t, b=b, block_size=block_size, dtype=dtype, layers=L, heads=H,
                      kv_heads=H, head_dim=D // H, layer_weights=12 * D * D, hidden=D,
                      vocab=V, n_params=num_params(config))


# ----------------------------------------------------------------- HF import
def config_from_hf(hf_config) -> BloomConfig:
    return BloomConfig(vocab_size=hf_config.vocab_size, hidden_size=hf_config.hidden_size,
                       num_layers=hf_config.n_layer, num_heads=hf_config.n_head,
                       ln_eps=getattr(hf_config, "layer_norm_epsilon", 1e-5))


def from_hf_state_dict(config: BloomConfig, state_dict, dtype=torch.float32):
    """A BloomForCausalLM state dict -> this package's params on the CPU.
    The fused ``query_key_value`` keeps HF's per-head (q, k, v) interleaving,
    which :func:`_split_qkv` reads; torch Linear [out, in] is transposed to
    [in, out]."""
    t = lambda name: hf_tensor(state_dict, name).to(dtype)  # noqa: E731
    pre = "transformer.h.{}"
    stack = lambda fmt, transpose=True: hf_stack(state_dict, fmt, config.num_layers,  # noqa: E731
                                                 dtype, transpose)
    return {
        "embed": t("transformer.word_embeddings.weight"),
        "embed_ln_w": t("transformer.word_embeddings_layernorm.weight"),
        "embed_ln_b": t("transformer.word_embeddings_layernorm.bias"),
        "layers": {
            "ln1_w": stack(pre + ".input_layernorm.weight", False),
            "ln1_b": stack(pre + ".input_layernorm.bias", False),
            "ln2_w": stack(pre + ".post_attention_layernorm.weight", False),
            "ln2_b": stack(pre + ".post_attention_layernorm.bias", False),
            "w_qkv": stack(pre + ".self_attention.query_key_value.weight"),
            "b_qkv": stack(pre + ".self_attention.query_key_value.bias", False),
            "wo": stack(pre + ".self_attention.dense.weight"),
            "bo": stack(pre + ".self_attention.dense.bias", False),
            "fc1": stack(pre + ".mlp.dense_h_to_4h.weight"),
            "b_fc1": stack(pre + ".mlp.dense_h_to_4h.bias", False),
            "fc2": stack(pre + ".mlp.dense_4h_to_h.weight"),
            "b_fc2": stack(pre + ".mlp.dense_4h_to_h.bias", False),
        },
        "final_ln_w": t("transformer.ln_f.weight"),
        "final_ln_b": t("transformer.ln_f.bias"),
    }

"""Llama-family causal LM: the dense training forward, the cached forward of
the v1 inference engine and the paged (ragged) serving forward.

Counterpart of ``deepspeed_tpu/models/llama.py`` for the training, v1 and v2
serving paths.  Params are the JAX package's pytree as nested dicts of
tensors: per-layer leaves stacked on dim 0, weight matrices ``[in, out]``, so
:func:`params_from_jax` carries JAX weights across without reshuffling.  The
layer stack is a Python loop over those stacked leaves.  The cached forward
also takes packed (weight-only quantized) leaves: it asks each for the one
layer it needs, ``leaf[i]``, so only that layer is ever dense.
"""

import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.attention.paged import paged_attention
from ..runtime.activation_checkpointing import checkpoint
from ..runtime.tree import tree_map
from .transformer import (attention_block, cross_entropy_loss, device_rotary_tables,
                          hf_stack, hf_tensor, init_linear, init_paged_kv_pool, materialize,
                          paged_chunk_indices, paged_cost, paged_write_index, project,
                          resolve_attention, rms_norm, rotate_half, swiglu_mlp, tree_to_torch)


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
    # recompute each layer in the backward (torch.utils.checkpoint); the JAX
    # package's named remat policies are not ported yet
    remat: bool = True

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


def paged_bucket_cost(config: LlamaConfig, n: int, t: int, b: int, block_size: int,
                      dtype) -> Tuple[float, float]:
    """(FLOPs, bytes) of one :func:`forward_paged` over an ``(n, t, b)``
    bucket: ``n`` sequences of ``t`` padded tokens over block tables of
    ``b`` blocks, weights and KV pool in ``dtype``.  The serving roofline's
    cost source, noted once per bucket at its build
    (:func:`transformer.paged_cost` says what is counted)."""
    D, F, L, V = config.hidden_size, config.intermediate_size, config.num_layers, config.vocab_size
    H, KV = config.num_heads, config.num_kv_heads
    Dh = D // H
    return paged_cost(n=n, t=t, b=b, block_size=block_size, dtype=dtype, layers=L, heads=H,
                      kv_heads=KV, head_dim=Dh,
                      layer_weights=D * H * Dh + 2 * D * KV * Dh + H * Dh * D + 3 * D * F,
                      hidden=D, vocab=V, n_params=num_params(config))


def flops_per_token(config: LlamaConfig, seq_len: int) -> float:
    """Approximate training FLOPs per token (6N + attention terms) for MFU."""
    attn = 12 * config.num_layers * config.hidden_size * seq_len  # qk + av, fwd + bwd
    return 6.0 * num_params(config) + attn


# ------------------------------------------------------------------ training
def _layer(config: LlamaConfig, cos, sin, attention_fn, x, layer_params):
    attn_in = rms_norm(x, layer_params["attn_norm"], config.rms_eps)
    attn_out, _ = attention_block(layer_params["attn"], attn_in, n_heads=config.num_heads,
                                  n_kv_heads=config.num_kv_heads, cos=cos, sin=sin, causal=True,
                                  attention_fn=attention_fn)
    x = x + attn_out
    mlp_in = rms_norm(x, layer_params["mlp_norm"], config.rms_eps)
    return x + swiglu_mlp(layer_params["mlp"], mlp_in)


def forward(config: LlamaConfig, params, input_ids, attention_fn=None):
    """input_ids [B, S] -> logits [B, S, V], in the dtype of the params (the
    engine hands in its compute-dtype copy).  With ``config.remat`` each layer
    is recomputed in the backward instead of keeping its activations.

    The attention function is resolved once, here, and bound into the layer:
    the recompute runs in the backward, after the engine's configured
    attention scope (``transformer.scoped_default_attention``) has closed, and
    must run the same attention as the forward."""
    device = params["embed"].device
    attention_fn = resolve_attention(attention_fn, device)
    cos, sin = device_rotary_tables(config.hidden_size // config.num_heads, config.max_seq_len,
                                    config.rope_theta, str(device))
    x = params["embed"][input_ids.long()]
    layer = functools.partial(_layer, config, cos, sin, attention_fn)
    if config.remat:
        layer = checkpoint(layer)
    # one unbind per stacked leaf: its backward stacks the L layer grads once,
    # where indexing leaf[i] per layer would build and sum L full-size grads
    per_layer = tree_map(lambda w: w.unbind(0), params["layers"])
    for i in range(config.num_layers):
        x = layer(x, tree_map(lambda ws: ws[i], per_layer))
    x = rms_norm(x, params["final_norm"], config.rms_eps)
    head = params["embed"].T if config.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def make_loss_fn(config: LlamaConfig, attention_fn=None) -> Callable:
    """loss_fn(params, batch, rng) for the engine; batch: {input_ids, labels}
    (-100 = ignore).  ``rng`` is unused: the dense forward draws nothing."""

    def loss_fn(params, batch, rng):
        logits = forward(config, params, batch["input_ids"], attention_fn=attention_fn)
        return cross_entropy_loss(logits, batch["labels"])

    return loss_fn


def causal_lm_batch(input_ids: np.ndarray):
    """{input_ids, labels} with next-token labels from raw token rows: both
    keep length S, and the last label is -100 (``transformer.causal_lm_batch``
    instead drops a token)."""
    labels = np.full_like(input_ids, -100)
    labels[:, :-1] = input_ids[:, 1:]
    return {"input_ids": input_ids, "labels": labels}


def params_from_jax(config: LlamaConfig, params_np, device, dtype=torch.float32):
    """The JAX params pytree (leaves as numpy arrays, or anything
    ``np.array`` takes) -> this package's params, same layout."""
    missing = {"embed", "layers", "final_norm"} - set(params_np)
    if not config.tie_embeddings:
        missing |= {"lm_head"} - set(params_np)
    if missing:
        raise KeyError(f"params_from_jax: the JAX params lack {sorted(missing)}")
    return tree_to_torch(params_np, device, dtype)


def kv_from_jax(kv_np, device, dtype=torch.float32):
    """A JAX paged KV pool {"k", "v"} [L, NB, KV, bs, Dh] -> tensors."""
    return {"k": tree_to_torch(kv_np["k"], device, dtype),
            "v": tree_to_torch(kv_np["v"], device, dtype)}


# ------------------------------------------------------------------ inference
def init_cache(config: LlamaConfig, batch: int, max_seq: Optional[int] = None,
               dtype=torch.bfloat16, device=None):
    """Dense KV cache for incremental decoding: stacked per-layer [L, B, S_max,
    KV, Dh] k and v buffers and ``len``, the number of positions written (a
    host int, so a decode step needs no device sync)."""
    S = max_seq or config.max_seq_len
    shape = (config.num_layers, batch, S, config.num_kv_heads,
             config.hidden_size // config.num_heads)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "len": 0}


def _cached_layer(config: LlamaConfig, cos, sin, attention_fn, positions, x, layers, i, cache,
                  start):
    """Layer ``i`` of :func:`forward_with_cache`.  Its weights are taken here
    (a packed leaf dequantizes layer i alone) and freed on return."""
    lp = tree_map(lambda w: w[i], layers)
    attn_in = rms_norm(x, lp["attn_norm"], config.rms_eps)
    attn_out, _ = attention_block(lp["attn"], attn_in, n_heads=config.num_heads,
                                  n_kv_heads=config.num_kv_heads, cos=cos, sin=sin, causal=True,
                                  attention_fn=attention_fn, positions=positions,
                                  kv_cache=(cache["k"][i], cache["v"][i], start))
    x = x + attn_out
    mlp_in = rms_norm(x, lp["mlp_norm"], config.rms_eps)
    return x + swiglu_mlp(lp["mlp"], mlp_in)


def forward_with_cache(config: LlamaConfig, params, input_ids, cache, attention_fn=None):
    """Incremental forward that consumes and extends the KV cache.

    input_ids [B, S] on the cache's device (the prompt at prefill, one token a
    row at decode); returns (logits [B, S, V], cache).  This call's keys and
    values are written into ``cache["k"]``/``cache["v"]`` IN PLACE (the JAX
    function returns new buffers), and the returned dict holds the same
    buffers with ``len`` advanced by S.  Leaves may be packed
    (``inference.quantization.WOQLeaf``): stacked ones are read one layer at a
    time, the embedding by the rows ``input_ids`` names."""
    device, dtype = cache["k"].device, cache["k"].dtype
    cos, sin = device_rotary_tables(config.hidden_size // config.num_heads, config.max_seq_len,
                                    config.rope_theta, str(device))
    ids = input_ids.long()
    b, s = ids.shape
    start = cache["len"]
    positions = (start + torch.arange(s, device=device))[None, :].expand(b, s)
    attention_fn = resolve_attention(attention_fn, device)
    x = params["embed"][ids].to(dtype)
    for i in range(config.num_layers):
        x = _cached_layer(config, cos, sin, attention_fn, positions, x, params["layers"], i,
                          cache, start)
    x = rms_norm(x, params["final_norm"], config.rms_eps)
    head = materialize(params["embed"]).T if config.tie_embeddings else materialize(
        params["lm_head"])
    return x @ head.to(x.dtype), {"k": cache["k"], "v": cache["v"], "len": start + s}


def from_hf_state_dict(config: LlamaConfig, state_dict, dtype=torch.float32):
    """A HuggingFace LlamaForCausalLM state dict (a plain dict of tensors or
    arrays) -> this package's params on the CPU.  torch Linear stores [out,
    in]; ours is [in, out], so weights are transposed here."""
    t = lambda name: hf_tensor(state_dict, name)
    stack = lambda fmt, transpose=True: hf_stack(state_dict, fmt, config.num_layers, dtype,
                                                 transpose)
    params = {
        "embed": t("model.embed_tokens.weight").to(dtype),
        "layers": {
            "attn": {
                "wq": stack("model.layers.{}.self_attn.q_proj.weight"),
                "wk": stack("model.layers.{}.self_attn.k_proj.weight"),
                "wv": stack("model.layers.{}.self_attn.v_proj.weight"),
                "wo": stack("model.layers.{}.self_attn.o_proj.weight"),
            },
            "mlp": {
                "w_gate": stack("model.layers.{}.mlp.gate_proj.weight"),
                "w_up": stack("model.layers.{}.mlp.up_proj.weight"),
                "w_down": stack("model.layers.{}.mlp.down_proj.weight"),
            },
            "attn_norm": stack("model.layers.{}.input_layernorm.weight", transpose=False),
            "mlp_norm": stack("model.layers.{}.post_attention_layernorm.weight",
                              transpose=False),
        },
        "final_norm": t("model.norm.weight").to(dtype),
    }
    if not config.tie_embeddings:
        key = "lm_head.weight" if "lm_head.weight" in state_dict else "model.embed_tokens.weight"
        params["lm_head"] = t(key).T.contiguous().to(dtype)
    return params


def config_from_hf(hf_config) -> LlamaConfig:
    """A LlamaConfig from any object with the attribute names of a
    transformers LlamaConfig/MistralConfig (transformers is not imported)."""
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads", hf_config.num_attention_heads),
        max_seq_len=getattr(hf_config, "max_position_embeddings", 4096),
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        rms_eps=getattr(hf_config, "rms_norm_eps", 1e-5),
        tie_embeddings=getattr(hf_config, "tie_word_embeddings", False),
    )


def cache_from_jax(cache_np, device, dtype=torch.float32):
    """A JAX v1 KV cache {"k", "v" [L, B, S, KV, Dh], "len"} -> this package's."""
    return {"k": tree_to_torch(cache_np["k"], device, dtype),
            "v": tree_to_torch(cache_np["v"], device, dtype),
            "len": int(np.asarray(cache_np["len"]))}


# ------------------------------------------------------------- paged serve
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

    The forward is CUDA-graph safe (the v2 engine captures it per bucket): it
    reads no device value on the host and sizes every allocation from shapes
    alone.  Two things are built at first use and must exist before a
    capture, which the capture's warm-up run takes care of: the rotary
    tables on the device (:func:`device_rotary_tables`) and the paged
    kernel library.
    """
    head = params["embed"].T if config.tie_embeddings else params["lm_head"]
    return rotary_paged_forward(
        config, params, head, tokens, n_tokens, start_pos, block_tables, kv_cache,
        block_size=block_size, window=window,
        ffn=lambda layers, i, x: swiglu_mlp({k: w[i] for k, w in layers["mlp"].items()}, x))


def rotary_paged_forward(config, params, head, tokens, n_tokens, start_pos, block_tables,
                         kv_cache, *, block_size: int, window: Optional[int], ffn):
    """The paged forward of the Llama-shaped families (Llama, Mistral,
    Qwen2, Mixtral): RMSNorm, rotary, grouped-query attention through the
    paged kernel and ``ffn(layers, i, x)`` for layer i's feed-forward, then
    the final norm and ``head`` [D, V].  ``config`` needs ``hidden_size``,
    ``num_heads``, ``num_kv_heads``, ``num_layers``, ``max_seq_len``,
    ``rope_theta`` and ``rms_eps``; the q/k/v projections add their biases
    where the params hold them (Qwen2)."""
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
    write_idx = paged_write_index(blk, off, KV)
    scale = 1.0 / math.sqrt(Dh)
    layers = params["layers"]
    x = params["embed"][tokens.long()].to(kv_cache["k"].dtype)
    for i in range(config.num_layers):
        attn = {k: w[i] for k, w in layers["attn"].items()}
        attn_in = rms_norm(x, layers["attn_norm"][i], config.rms_eps)
        q = project(attn_in, attn, "q").reshape(b, tchunk, H, Dh)
        k = project(attn_in, attn, "k").reshape(b, tchunk, KV, Dh)
        v = project(attn_in, attn, "v").reshape(b, tchunk, KV, Dh)
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
        mlp_in = rms_norm(x, layers["mlp_norm"][i], config.rms_eps)
        x = x + ffn(layers, i, mlp_in)
    x = rms_norm(x, params["final_norm"], config.rms_eps)
    return x @ head.to(x.dtype), kv_cache

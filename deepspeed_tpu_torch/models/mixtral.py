"""Mixtral-style MoE causal LM: the Llama backbone with the FFN replaced by
a top-k gated expert layer.

Counterpart of ``deepspeed_tpu/models/mixtral.py``.  The dense forward
routes through ``moe.moe_layer`` (capacity dropping, the aux loss summed over
the layers and added to the LM loss by the loss function); the paged forward
runs :func:`dense_moe_ffn`, which drops no token: every expert computes every
row and the renormalized top-k gate weights combine them.  Expert weights
are stacked ``[L, E, in, out]``.
"""

import dataclasses
import functools
import math
from typing import Callable

import torch
import torch.nn.functional as F

from ..moe.experts import swiglu_experts
from ..moe.sharded_moe import TopKGate, moe_layer
from ..runtime.activation_checkpointing import checkpoint
from ..runtime.tree import tree_map
from . import llama
from .transformer import (attention_block, count_params, cross_entropy_loss, device_rotary_tables,
                          hf_stack, hf_tensor, init_linear, init_paged_kv_pool, paged_cost,
                          resolve_attention, rms_norm, tree_to_torch)


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.02
    max_seq_len: int = 4096
    rope_theta: float = 1e6
    rms_eps: float = 1e-5
    remat: bool = True

    @staticmethod
    def mixtral_8x7b():
        return MixtralConfig()

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, kv_heads=2, experts=4, seq=64):
        return MixtralConfig(vocab_size=vocab, hidden_size=hidden, intermediate_size=hidden * 2,
                             num_layers=layers, num_heads=heads, num_kv_heads=kv_heads,
                             num_experts=experts, max_seq_len=seq)


def init_params(config: MixtralConfig, generator, dtype=torch.float32, device=None):
    """Random params drawn from ``generator``; per-layer leaves stacked on
    dim 0, experts ``[L, E, in, out]``."""
    L, D, E, F_ = config.num_layers, config.hidden_size, config.num_experts, config.intermediate_size
    H, KV = config.num_heads, config.num_kv_heads
    head_dim = D // H

    def stack(in_dim, out_dim):
        return init_linear(generator, in_dim, out_dim, dtype=dtype, device=device, layers=L)

    def experts(in_dim, out_dim):  # [L, E, in, out], drawn in place (no per-layer copies)
        w = torch.randn((L, E, in_dim, out_dim), generator=generator, dtype=dtype, device=device)
        return w.mul_(1.0 / math.sqrt(in_dim))

    wg = torch.randn((L, D, E), generator=generator, dtype=dtype, device=device).mul_(0.02)
    return {
        "embed": torch.randn((config.vocab_size, D), generator=generator, dtype=dtype,
                             device=device).mul_(0.02),
        "layers": {
            "attn": {"wq": stack(D, H * head_dim), "wk": stack(D, KV * head_dim),
                     "wv": stack(D, KV * head_dim), "wo": stack(H * head_dim, D)},
            "moe": {
                "gate": {"wg": wg},
                "experts": {"w_gate": experts(D, F_), "w_up": experts(D, F_),
                            "w_down": experts(F_, D)},
            },
            "attn_norm": torch.ones((L, D), dtype=dtype, device=device),
            "mlp_norm": torch.ones((L, D), dtype=dtype, device=device),
        },
        "final_norm": torch.ones((D, ), dtype=dtype, device=device),
        "lm_head": init_linear(generator, D, config.vocab_size, dtype=dtype, device=device),
    }


def num_params(config: MixtralConfig) -> int:
    return count_params(lambda: init_params(config, None))


def params_from_jax(config: MixtralConfig, params_np, device, dtype=torch.float32):
    """The JAX params pytree (numpy leaves) -> this package's, same layout."""
    missing = {"embed", "layers", "final_norm", "lm_head"} - set(params_np)
    if missing:
        raise KeyError(f"params_from_jax: the JAX params lack {sorted(missing)}")
    return tree_to_torch(params_np, device, dtype)


# ------------------------------------------------------------------ training
def _gate(config: MixtralConfig) -> TopKGate:
    return TopKGate(config.hidden_size, config.num_experts, k=config.top_k,
                    capacity_factor=config.capacity_factor,
                    eval_capacity_factor=config.capacity_factor)


def _layer(config: MixtralConfig, cos, sin, attention_fn, train, x, aux, layer_params):
    attn_in = rms_norm(x, layer_params["attn_norm"], config.rms_eps)
    attn_out, _ = attention_block(layer_params["attn"], attn_in, n_heads=config.num_heads,
                                  n_kv_heads=config.num_kv_heads, cos=cos, sin=sin, causal=True,
                                  attention_fn=attention_fn)
    x = x + attn_out
    moe_in = rms_norm(x, layer_params["mlp_norm"], config.rms_eps)
    moe_out, l_aux = moe_layer(_gate(config), layer_params["moe"], moe_in,
                               expert_fn=swiglu_experts, train=train)
    return x + moe_out, aux + l_aux


def forward(config: MixtralConfig, params, input_ids, attention_fn=None, train=True):
    """input_ids [B, S] -> (logits [B, S, V], the aux loss summed over the
    layers, fp32).  ``train`` picks the gate's capacity factor (both are
    ``config.capacity_factor``) and its noisy policy (none here)."""
    device = params["embed"].device
    attention_fn = resolve_attention(attention_fn, device)
    cos, sin = device_rotary_tables(config.hidden_size // config.num_heads, config.max_seq_len,
                                    config.rope_theta, str(device))
    x = params["embed"][input_ids.long()]
    aux = torch.zeros((), dtype=torch.float32, device=device)
    layer = functools.partial(_layer, config, cos, sin, attention_fn, train)
    if config.remat:
        layer = checkpoint(layer)
    per_layer = tree_map(lambda w: w.unbind(0), params["layers"])
    for i in range(config.num_layers):
        x, aux = layer(x, aux, tree_map(lambda ws: ws[i], per_layer))
    x = rms_norm(x, params["final_norm"], config.rms_eps)
    return x @ params["lm_head"].to(x.dtype), aux


def make_loss_fn(config: MixtralConfig, attention_fn=None) -> Callable:
    """loss_fn(params, batch, rng) -> (LM loss + aux_loss_coef x aux,
    {"aux_loss": aux}), the JAX function's (loss, aux) pair."""

    def loss_fn(params, batch, rng):
        logits, aux = forward(config, params, batch["input_ids"], attention_fn=attention_fn)
        lm = cross_entropy_loss(logits, batch["labels"])
        return lm + config.aux_loss_coef * aux, {"aux_loss": aux}

    return loss_fn


causal_lm_batch = llama.causal_lm_batch


# --------------------------------------------------------- paged (ragged) serve
def dense_moe_ffn(moe_params, x, top_k: int):
    """Serving-time MoE FFN over rows x [T, D]: top-k routing with no
    capacity dropping, so every row reaches its k experts.  Every expert
    computes every row ([E, T, F] in between) and the renormalized top-k
    gate weights combine them.  The top k are taken by a stable descending
    sort, so equal gate values pick the lower expert as ``jax.lax.top_k``
    does (``torch.topk`` does not promise an order among ties)."""
    ex = moe_params["experts"]
    gate_logits = x @ moe_params["gate"]["wg"].to(x.dtype)  # [T, E]
    probs = torch.softmax(gate_logits.float(), dim=-1)
    top_p, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_idx = top_p[:, :top_k], top_idx[:, :top_k]
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    combine = torch.zeros_like(probs).scatter(1, top_idx, top_p)  # [T, E]
    h = (F.silu(torch.matmul(x, ex["w_gate"].to(x.dtype)))
         * torch.matmul(x, ex["w_up"].to(x.dtype)))  # [E, T, F]
    all_out = torch.matmul(h, ex["w_down"].to(x.dtype))  # [E, T, D]
    return torch.einsum("te,etd->td", combine.to(x.dtype), all_out)


def init_paged_cache(config: MixtralConfig, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device=None):
    return init_paged_kv_pool(config.num_layers, config.num_kv_heads,
                              config.hidden_size // config.num_heads, num_blocks, block_size,
                              dtype=dtype, device=device)


def forward_paged(config: MixtralConfig, params, tokens, n_tokens, start_pos, block_tables,
                  kv_cache, *, block_size: int):
    """Ragged chunked forward: Llama's paged attention and
    :func:`dense_moe_ffn` a layer (see ``llama.forward_paged`` for the
    arguments, the in-place pool update and graph safety)."""
    D = config.hidden_size

    def ffn(layers, i, x):
        moe = tree_map(lambda w: w[i], layers["moe"])
        rows = x.reshape(-1, D)
        return dense_moe_ffn(moe, rows, config.top_k).reshape(x.shape)

    return llama.rotary_paged_forward(config, params, params["lm_head"], tokens, n_tokens,
                                      start_pos, block_tables, kv_cache, block_size=block_size,
                                      window=None, ffn=ffn)


def paged_bucket_cost(config: MixtralConfig, n: int, t: int, b: int, block_size: int, dtype):
    """(FLOPs, bytes) of one :func:`forward_paged` over an ``(n, t, b)``
    bucket (``transformer.paged_cost``): per layer the attention products,
    the router, all E experts on every row (as :func:`dense_moe_ffn`
    computes them) and the E-way combine."""
    D, F, L, V = config.hidden_size, config.intermediate_size, config.num_layers, config.vocab_size
    H, KV, E = config.num_heads, config.num_kv_heads, config.num_experts
    Dh = D // H
    layer = D * H * Dh + 2 * D * KV * Dh + H * Dh * D + D * E + 3 * D * F * E + E * D
    return paged_cost(n=n, t=t, b=b, block_size=block_size, dtype=dtype, layers=L, heads=H,
                      kv_heads=KV, head_dim=Dh, layer_weights=layer, hidden=D, vocab=V,
                      n_params=num_params(config))


# ----------------------------------------------------------------- HF import
def config_from_hf(hf_config) -> MixtralConfig:
    """A MixtralConfig from a transformers MixtralConfig (not imported)."""
    return MixtralConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads", hf_config.num_attention_heads),
        num_experts=getattr(hf_config, "num_local_experts", 8),
        top_k=getattr(hf_config, "num_experts_per_tok", 2),
        max_seq_len=getattr(hf_config, "max_position_embeddings", 4096),
        rope_theta=getattr(hf_config, "rope_theta", 1e6),
        rms_eps=getattr(hf_config, "rms_norm_eps", 1e-5),
    )


def from_hf_state_dict(config: MixtralConfig, state_dict, dtype=torch.float32):
    """A HF MixtralForCausalLM state dict (block_sparse_moe naming: w1 =
    gate, w3 = up, w2 = down) -> this package's params on the CPU."""
    t = lambda name: hf_tensor(state_dict, name)  # noqa: E731
    L, E = config.num_layers, config.num_experts
    stack = lambda fmt, tr=True: hf_stack(state_dict, fmt, L, dtype, tr)  # noqa: E731

    def stack_expert(which):
        return torch.stack([
            torch.stack([t(f"model.layers.{i}.block_sparse_moe.experts.{e}.{which}.weight").T
                         for e in range(E)]) for i in range(L)]).to(dtype)

    return {
        "embed": t("model.embed_tokens.weight").to(dtype),
        "layers": {
            "attn": {
                "wq": stack("model.layers.{}.self_attn.q_proj.weight"),
                "wk": stack("model.layers.{}.self_attn.k_proj.weight"),
                "wv": stack("model.layers.{}.self_attn.v_proj.weight"),
                "wo": stack("model.layers.{}.self_attn.o_proj.weight"),
            },
            "moe": {
                "gate": {"wg": stack("model.layers.{}.block_sparse_moe.gate.weight")},
                "experts": {"w_gate": stack_expert("w1"), "w_up": stack_expert("w3"),
                            "w_down": stack_expert("w2")},
            },
            "attn_norm": stack("model.layers.{}.input_layernorm.weight", tr=False),
            "mlp_norm": stack("model.layers.{}.post_attention_layernorm.weight", tr=False),
        },
        "final_norm": t("model.norm.weight").to(dtype),
        "lm_head": t("lm_head.weight").T.contiguous().to(dtype),
    }

"""Qwen2 causal LM: the Llama architecture with biases on the q/k/v
projections (the output projection and the MLP stay bias-free).

Counterpart of ``deepspeed_tpu/models/qwen.py``.  The biases are stacked
per-layer leaves ``layers.attn.bq`` / ``bk`` / ``bv`` [L, out]; the port's
shared blocks (``transformer.attention_block``, ``llama.forward_paged``)
add a projection's bias wherever the params hold one, so the dense, cached
and paged forwards are Llama's own.
"""

import dataclasses

import torch

from . import llama
from .llama import LlamaConfig
from .transformer import count_params, hf_stack


@dataclasses.dataclass(frozen=True)
class QwenConfig(LlamaConfig):

    @staticmethod
    def qwen2_7b():
        return QwenConfig(vocab_size=152064, hidden_size=3584, intermediate_size=18944,
                          num_layers=28, num_heads=28, num_kv_heads=4,
                          max_seq_len=32768, rope_theta=1000000.0)

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, kv_heads=2, seq=64):
        return QwenConfig(vocab_size=vocab, hidden_size=hidden, intermediate_size=hidden * 2,
                          num_layers=layers, num_heads=heads, num_kv_heads=kv_heads,
                          max_seq_len=seq)


def init_params(config: QwenConfig, generator, dtype=torch.float32, device=None):
    """Llama params + per-layer q/k/v biases (zeros)."""
    params = llama.init_params(config, generator, dtype=dtype, device=device)
    L, H, KV = config.num_layers, config.num_heads, config.num_kv_heads
    Dh = config.hidden_size // H
    attn = params["layers"]["attn"]
    attn["bq"] = torch.zeros((L, H * Dh), dtype=dtype, device=device)
    attn["bk"] = torch.zeros((L, KV * Dh), dtype=dtype, device=device)
    attn["bv"] = torch.zeros((L, KV * Dh), dtype=dtype, device=device)
    return params


def num_params(config: QwenConfig) -> int:
    return count_params(lambda: init_params(config, None))


forward = llama.forward
make_loss_fn = llama.make_loss_fn
causal_lm_batch = llama.causal_lm_batch
init_paged_cache = llama.init_paged_cache
forward_paged = llama.forward_paged
kv_from_jax = llama.kv_from_jax


def params_from_jax(config: QwenConfig, params_np, device, dtype=torch.float32):
    """The JAX params pytree (numpy leaves) -> this package's, same layout."""
    missing = {"bq", "bk", "bv"} - set(params_np.get("layers", {}).get("attn", {}))
    if missing:
        raise KeyError(f"params_from_jax: the JAX params lack layers.attn.{sorted(missing)}")
    return llama.params_from_jax(config, params_np, device, dtype)


def paged_bucket_cost(config: QwenConfig, n: int, t: int, b: int, block_size: int, dtype):
    """Llama's (the bias adds are no products), with the biases' bytes."""
    flops, nbytes = llama.paged_bucket_cost(config, n, t, b, block_size, dtype)
    item = torch.empty((), dtype=dtype).element_size()
    Dh = config.hidden_size // config.num_heads
    biases = config.num_layers * (config.num_heads + 2 * config.num_kv_heads) * Dh
    return flops, nbytes + biases * item


# ----------------------------------------------------------------- HF import
def config_from_hf(hf_config) -> QwenConfig:
    base = llama.config_from_hf(hf_config)
    return QwenConfig(**dataclasses.asdict(base))


def from_hf_state_dict(config: QwenConfig, state_dict, dtype=torch.float32):
    """Qwen2ForCausalLM = the Llama layout + q/k/v biases."""
    params = llama.from_hf_state_dict(config, state_dict, dtype)
    stack_bias = lambda fmt: hf_stack(state_dict, fmt, config.num_layers, dtype,  # noqa: E731
                                      transpose=False)
    attn = params["layers"]["attn"]
    attn["bq"] = stack_bias("model.layers.{}.self_attn.q_proj.bias")
    attn["bk"] = stack_bias("model.layers.{}.self_attn.k_proj.bias")
    attn["bv"] = stack_bias("model.layers.{}.self_attn.v_proj.bias")
    return params

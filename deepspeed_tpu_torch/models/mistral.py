"""Mistral causal LM: the Llama architecture with sliding-window attention.

Counterpart of ``deepspeed_tpu/models/mistral.py`` for the v2 serving path:
everything delegates to :mod:`.llama`, and ``forward_paged`` hands
``sliding_window`` to the paged-attention kernel.
"""

import dataclasses
from typing import Optional

from . import llama
from .llama import LlamaConfig


@dataclasses.dataclass(frozen=True)
class MistralConfig(LlamaConfig):
    sliding_window: Optional[int] = 4096

    @staticmethod
    def mistral_7b():
        return MistralConfig(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                             num_layers=32, num_heads=32, num_kv_heads=8,
                             max_seq_len=32768, rope_theta=10000.0, sliding_window=4096)

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, kv_heads=2, seq=64, window=16):
        return MistralConfig(vocab_size=vocab, hidden_size=hidden, intermediate_size=hidden * 2,
                             num_layers=layers, num_heads=heads, num_kv_heads=kv_heads,
                             max_seq_len=seq, sliding_window=window)


init_params = llama.init_params
num_params = llama.num_params
params_from_jax = llama.params_from_jax
kv_from_jax = llama.kv_from_jax
from_hf_state_dict = llama.from_hf_state_dict
init_paged_cache = llama.init_paged_cache
paged_bucket_cost = llama.paged_bucket_cost


def config_from_hf(hf_config) -> MistralConfig:
    """A MistralConfig from a transformers MistralConfig (not imported)."""
    base = llama.config_from_hf(hf_config)
    return MistralConfig(**dataclasses.asdict(base),
                         sliding_window=getattr(hf_config, "sliding_window", None))


def forward_paged(config: MistralConfig, params, tokens, n_tokens, start_pos, block_tables,
                  kv_cache, *, block_size: int):
    """v2 ragged forward with the sliding window applied inside the kernel."""
    return llama.forward_paged(config, params, tokens, n_tokens, start_pos, block_tables,
                               kv_cache, block_size=block_size, window=config.sliding_window)

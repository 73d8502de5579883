"""Mistral causal LM: the Llama architecture with sliding-window attention.

Counterpart of ``deepspeed_tpu/models/mistral.py``: everything delegates to
:mod:`.llama`.  Training masks the window inside plain ``sdpa``
(:func:`windowed_attention`, on every device, as the JAX package leaves the
masked attention to XLA); ``forward_paged`` hands ``sliding_window`` to the
paged-attention kernel.  Not ported: the tensor-parallel rules (ROADMAP item
11).
"""

import dataclasses
from typing import Callable, Optional

import torch

from . import llama
from .llama import LlamaConfig
from .transformer import sdpa


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


def windowed_attention(window: Optional[int]):
    """The training path's attention function: causal within the last
    ``window`` keys of each query (queries at the end of the keys), and
    within ``mask`` where the caller gives one; None without a window."""
    if window is None:
        return None

    def attn(q, k, v, causal=True, mask=None, softmax_scale=None):
        sq, sk = q.shape[1], k.shape[1]
        qp = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kp = torch.arange(sk, device=q.device)[None, :]
        wmask = ((kp <= qp) & (kp > qp - window))[None, None]
        if mask is not None:
            wmask = mask & wmask
        return sdpa(q, k, v, causal=False, mask=wmask, softmax_scale=softmax_scale)

    return attn


init_params = llama.init_params
num_params = llama.num_params
flops_per_token = llama.flops_per_token
abstract_params = llama.abstract_params
hf_streaming_loader = llama.hf_streaming_loader
params_from_jax = llama.params_from_jax
kv_from_jax = llama.kv_from_jax
from_hf_state_dict = llama.from_hf_state_dict
init_cache = llama.init_cache
init_paged_cache = llama.init_paged_cache
causal_lm_batch = llama.causal_lm_batch
paged_bucket_cost = llama.paged_bucket_cost


def forward(config: MistralConfig, params, input_ids, attention_fn=None):
    """``llama.forward`` with :func:`windowed_attention` unless the caller
    gives an attention function."""
    fn = attention_fn or windowed_attention(config.sliding_window)
    return llama.forward(config, params, input_ids, attention_fn=fn)


def make_loss_fn(config: MistralConfig, attention_fn=None) -> Callable:
    fn = attention_fn or windowed_attention(config.sliding_window)
    return llama.make_loss_fn(config, attention_fn=fn)


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

"""Random layerwise token dropping (random-LTD).

Counterpart of ``deepspeed_tpu/runtime/data_pipeline/random_ltd.py``: middle
layers process a random subset of the tokens; the dropped tokens bypass the
layer and are scattered back, which cuts attention cost quadratically while
the kept-token budget ramps up on a schedule.  The reference's CUDA
token_sort / gather kernels are ``torch.randperm`` + sort, ``index_select``
and ``index_copy``.  The indices come from an explicit ``torch.Generator``
(Philox on CUDA), so they never equal the JAX package's Threefry draws bit
for bit; the scheduler is the JAX one, copied.
"""

from typing import Dict

import torch


class RandomLTDScheduler:
    """Token-budget ramp: a linear increase of the kept tokens from
    min_value to max_value over ``require_steps``, in steps of
    ``seq_per_step``."""

    def __init__(self, config: Dict):
        ltd = config.get("random_ltd", config)
        self.min_tokens = int(ltd.get("random_ltd_schedule", {}).get("min_value", ltd.get("min_value", 128)))
        self.max_tokens = int(ltd.get("random_ltd_schedule", {}).get("max_value", ltd.get("max_value", 512)))
        sched = ltd.get("random_ltd_schedule", ltd)
        self.step_size = int(sched.get("schedule_config", sched).get("seq_per_step", 16))
        self.total_steps = int(sched.get("schedule_config", sched).get("require_steps", 1000))
        self.current_tokens = self.min_tokens

    def update_seq(self, global_step: int) -> int:
        frac = min(1.0, global_step / max(self.total_steps, 1))
        tokens = self.min_tokens + frac * (self.max_tokens - self.min_tokens)
        tokens = int(tokens // self.step_size * self.step_size)
        self.current_tokens = max(self.min_tokens, min(self.max_tokens, tokens))
        return self.current_tokens

    def state_dict(self):
        return {"current_tokens": self.current_tokens}

    def load_state_dict(self, sd):
        self.current_tokens = sd.get("current_tokens", self.min_tokens)


def sample_token_indices(generator: torch.Generator, seq_len: int, keep: int) -> torch.Tensor:
    """A sorted random subset of ``keep`` of the ``seq_len`` token positions,
    int64 on the generator's device."""
    keep = min(keep, seq_len)
    perm = torch.randperm(seq_len, generator=generator, device=generator.device)
    return torch.sort(perm[:keep]).values


def gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] -> the kept tokens [B, K, D]."""
    return x.index_select(1, idx)


def scatter_tokens(full: torch.Tensor, kept: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``full`` with the processed kept tokens written back (out of place)."""
    return full.index_copy(1, idx, kept.to(full.dtype))


def random_ltd_layer(layer_fn, x: torch.Tensor, generator: torch.Generator,
                     keep: int) -> torch.Tensor:
    """``layer_fn`` applied to a random token subset; the dropped tokens skip
    the layer (residual identity)."""
    idx = sample_token_indices(generator, x.shape[1], keep).to(x.device)
    return scatter_tokens(x, layer_fn(gather_tokens(x, idx)), idx)

"""Activation checkpointing (rematerialisation).

Counterpart of ``deepspeed_tpu/runtime/activation_checkpointing.py`` for
what the dense Llama forward uses: each wrapped layer keeps only its inputs
and recomputes its activations in the backward, which is
``jax.checkpoint`` with the ``nothing_saveable`` policy.  The named policies
and host offload are not ported yet.
"""

import functools

import torch.utils.checkpoint


def checkpoint(fn):
    """``fn`` recomputed in the backward (non-reentrant, so nested params dicts
    and autograd Functions inside ``fn`` work); the math is unchanged."""

    @functools.wraps(fn)
    def wrapped(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)

    return wrapped

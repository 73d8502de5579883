"""Token selection shared by the serving engines.

Counterpart of ``deepspeed_tpu/inference/engine.py::_filter_logits`` and
``_sample``.  JAX's threefry keys become an explicit ``torch.Generator``; the
two never draw the same bits, so sampled outputs agree with the JAX package
in distribution, not token for token.
"""

import torch


def _filter_logits(logits, *, temperature, top_k, top_p):
    """Temperature scaling + top-k / top-p masking in fp32: the one filtered
    target distribution the sampler draws from.  ``temperature == 0`` must be
    handled by the caller (greedy argmax, no filtering)."""
    logits = logits.float() / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, -1e30, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, -1e30, logits)
    return logits


def _sample(logits, generator: torch.Generator, *, temperature, top_k, top_p):
    """Temperature / top-k / top-p sampling of one token per row; greedy at
    T=0.  Returns int32 token ids [N]."""
    if temperature == 0.0:
        return torch.argmax(logits.float(), dim=-1).to(torch.int32)
    logits = _filter_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)

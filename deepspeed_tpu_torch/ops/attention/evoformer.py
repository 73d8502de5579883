"""Evoformer attention (DeepSpeed4Science's ``DS4Sci_EvoformerAttention``).

Counterpart of ``deepspeed_tpu/ops/attention/evoformer.py``, which computes
attention with pair bias in plain ``jnp`` ops (no Pallas kernel): here in
plain torch ops.  ``remat`` recomputes the logits in the backward
(``torch.utils.checkpoint``) instead of storing them, the memory contract of
the reference's fused kernel.

Q/K/V are ``[*, S, H, D]`` with any leading batch dims (MSA rows, residue
pairs); biases broadcast to ``[*, H, S_q, S_k]``: canonically a mask bias
``[*, 1, 1, S_k]`` and a pair bias ``[*, H, S_q, S_k]``.  The logits and the
softmax are fp32; the probabilities are cast to the inputs' dtype before
the value product.
"""

import math
from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint


def _evoformer_core(q, k, v, *biases):
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("...qhd,...khd->...hqk", q, k).float() * scale
    for b in biases:
        logits = logits + b.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("...hqk,...khd->...qhd", probs, v)


def evoformer_attention(q, k, v, biases: Optional[Sequence] = None, remat: bool = True):
    """Attention with additive biases (at most ``[mask_bias, pair_bias]``)."""
    biases = tuple(biases or ())
    if len(biases) > 2:
        raise ValueError("evoformer attention takes at most [mask_bias, pair_bias]")
    if remat:
        return checkpoint(_evoformer_core, q, k, v, *biases, use_reentrant=False)
    return _evoformer_core(q, k, v, *biases)


def msa_row_attention_with_pair_bias(msa, pair_bias, params, num_heads: int):
    """One MSA-row gated self-attention block: projections,
    :func:`evoformer_attention` with the pair bias, sigmoid gating.

    msa ``[rows, S, C]``; pair_bias ``[H, S, S]``; params ``{wq, wk, wv, wg,
    wo}``, each ``[C, H*Dh]`` or ``[H*Dh, C]``."""
    rows, s, c = msa.shape
    dh = params["wq"].shape[1] // num_heads

    def proj(w):
        return (msa @ w.to(msa.dtype)).reshape(rows, s, num_heads, dh)

    q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
    out = evoformer_attention(q, k, v, biases=[pair_bias[None]])
    gate = torch.sigmoid(msa @ params["wg"].to(msa.dtype))
    out = out.reshape(rows, s, num_heads * dh) * gate
    return out @ params["wo"].to(msa.dtype)

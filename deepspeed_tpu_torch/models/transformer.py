"""Shared transformer building blocks, as plain functions on tensors.

Counterpart of ``deepspeed_tpu/models/transformer.py`` for what the paged
serving path, the dense training forward and the v1 cached forward use.  Layouts follow the JAX
package: activations
``[B, S, H, D]``, weight matrices ``[in, out]``, stacked ``[L, ...]`` layer
leaves, KV pool ``[L, NB, KV, bs, Dh]``.  Casting order is kept so fp32 runs
match the JAX functions: ``rms_norm`` works in fp32 inside, and rotary cos/sin
are cast to the activation dtype before the rotate-half multiply.
"""

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


# ----------------------------------------------------------------- norms
def rms_norm(x, weight, eps=1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def layer_norm(x, weight, bias, eps=1e-5):
    """LayerNorm in fp32 inside (population variance, as ``jnp.var``)."""
    dtype = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mean) * (x - mean), dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dtype)


# ----------------------------------------------------------------- rotary
def rotary_tables(head_dim: int, max_seq: int, theta: float = 10000.0):
    """numpy cos/sin tables [max_seq, head_dim / 2], bit-identical to the JAX
    package's (the same float32 numpy arithmetic)."""
    inv_freq = 1.0 / (theta**(np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    t = np.arange(max_seq, dtype=np.float32)
    freqs = np.outer(t, inv_freq)
    return np.cos(freqs), np.sin(freqs)


@functools.lru_cache(maxsize=8)
def device_rotary_tables(head_dim: int, max_seq: int, theta: float, device: str):
    """:func:`rotary_tables` as fp32 tensors on ``device``, uploaded once per
    process and configuration instead of at every forward."""
    cos, sin = rotary_tables(head_dim, max_seq, theta)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def apply_rotary(x, cos, sin, positions=None):
    """x: [B, S, H, D]; cos/sin: [maxS, D/2] (numpy or tensor); positions
    [B, S] absolute positions (default 0..S-1)."""
    cos = torch.as_tensor(cos, device=x.device)
    sin = torch.as_tensor(sin, device=x.device)
    if positions is None:
        c = cos[:x.shape[1]][None, :, None, :]
        s = sin[:x.shape[1]][None, :, None, :]
    else:
        c = cos[positions.long()][:, :, None, :]
        s = sin[positions.long()][:, :, None, :]
    return rotate_half(x, c, s)


def rotate_half(x, c, s):
    """The rotate-half product with gathered cos/sin ``c``/``s`` broadcastable
    to [B, S, 1, D/2]; both are cast to x's dtype before the multiply."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = c.to(x.dtype)
    s = s.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ----------------------------------------------------------------- attention
def sdpa(q, k, v, causal=True, mask=None, softmax_scale=None, bias=None):
    """Scaled dot-product attention. q,k,v: [B, S, H, D] (k/v may have fewer
    heads — GQA — repeated per group).  fp32 softmax.  ``bias``: additive
    logit bias broadcastable to [B, H, Sq, Sk] (ALiBi)."""
    b, sq, hq, d = q.shape
    hk = k.shape[2]
    if hk != hq:
        k = torch.repeat_interleave(k, hq // hk, dim=2)
        v = torch.repeat_interleave(v, hq // hk, dim=2)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if bias is not None:
        logits = logits + bias.float()
    sk = k.shape[1]
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where((kpos <= qpos)[None, None], logits, -1e30)
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def default_attention(device):
    """The attention function for tensors on ``device``: the flash kernels
    (``ops/attention/flash.py``) on CUDA, plain ``sdpa`` on the CPU, as the
    JAX package takes its Pallas kernel on the TPU and XLA elsewhere."""
    if torch.device(device).type == "cuda":
        from ..ops.attention.flash import flash_attention
        return flash_attention
    return sdpa


# Config-installed attention: the engine wraps its loss function so that the
# function built from the config's ``sparse_attention`` section is the
# default while that loss function runs (models/transformer.py:128-164 of the
# JAX package); "engaged" records that a forward took it.
_CONFIGURED_ATTENTION = {"fn": None, "engaged": False}


def set_default_attention(fn):
    """Install (or clear, fn=None) the process-wide configured attention."""
    _CONFIGURED_ATTENTION["fn"] = fn
    _CONFIGURED_ATTENTION["engaged"] = False


def scoped_default_attention(loss_fn, attention_fn):
    """``loss_fn`` wrapped so that ``attention_fn`` (possibly None) is the
    configured attention exactly while its body runs: each engine keeps its
    own choice, and one that configured none never inherits another's.  A
    forward must take the function while the scope holds (``llama.forward``
    resolves it once, at its top): the recompute of a checkpointed layer runs
    in the backward, after the scope has closed."""

    def scoped(*args, **kwargs):
        prev = _CONFIGURED_ATTENTION["fn"]
        _CONFIGURED_ATTENTION["fn"] = attention_fn
        try:
            return loss_fn(*args, **kwargs)
        finally:
            _CONFIGURED_ATTENTION["fn"] = prev

    return scoped


def configured_attention_engaged() -> bool:
    return _CONFIGURED_ATTENTION["engaged"]


def resolve_attention(attention_fn, device):
    """The attention a forward on ``device`` runs: ``attention_fn`` when
    given, else the configured function in scope, else
    :func:`default_attention`."""
    if attention_fn is not None:
        return attention_fn
    if _CONFIGURED_ATTENTION["fn"] is not None:
        _CONFIGURED_ATTENTION["engaged"] = True
        return _CONFIGURED_ATTENTION["fn"]
    return default_attention(device)


def project(x, params, name):
    """``x @ params["w<name>"]``, plus ``params["b<name>"]`` where the
    params hold that bias (Qwen2's q/k/v), in x's dtype."""
    y = x @ params["w" + name].to(x.dtype)
    bias = params.get("b" + name)
    return y if bias is None else y + bias.to(x.dtype)


def attention_block(params, x, *, n_heads, n_kv_heads, cos, sin, causal=True,
                    attention_fn=None, positions=None, kv_cache=None):
    """Multi-head attention with rotary + GQA.

    params: {wq, wk, wv, wo}, [model, heads*dim] / [heads*dim, model], and
    optionally the q/k/v biases {bq, bk, bv} [heads*dim] (Qwen2).
    kv_cache: optional (k_cache [B, S_max, KV, Dh], v_cache, cache_len) of one
    layer for incremental decoding: this call's keys and values are written
    into the caches IN PLACE at ``cache_len`` (JAX's functional
    ``dynamic_update_slice``), and the queries attend to every cached
    position below ``cache_len + s`` that is not after their own.  Returns
    (out, (k_cache, v_cache, cache_len + s)), or (out, None) without a cache.
    """
    b, s, _ = x.shape
    head_dim = params["wq"].shape[1] // n_heads
    q = project(x, params, "q").reshape(b, s, n_heads, head_dim)
    k = project(x, params, "k").reshape(b, s, n_kv_heads, head_dim)
    v = project(x, params, "v").reshape(b, s, n_kv_heads, head_dim)
    q = apply_rotary(q, cos, sin, positions)
    k = apply_rotary(k, cos, sin, positions)
    attn_fn = resolve_attention(attention_fn, x.device)
    new_cache = None
    if kv_cache is not None:
        k_cache, v_cache, cache_len = kv_cache
        k_cache[:, cache_len:cache_len + s] = k
        v_cache[:, cache_len:cache_len + s] = v
        kpos = torch.arange(k_cache.shape[1], device=x.device)[None, None, None, :]
        qpos = torch.arange(s, device=x.device)[None, None, :, None] + cache_len
        # positions past the written ones, and causal over absolute positions
        mask = (kpos < cache_len + s) & (kpos <= qpos)
        out = attn_fn(q, k_cache, v_cache, causal=False, mask=mask)
        new_cache = (k_cache, v_cache, cache_len + s)
    else:
        out = attn_fn(q, k, v, causal=causal)
    return out.reshape(b, s, n_heads * head_dim) @ params["wo"].to(x.dtype), new_cache


def materialize(w):
    """``w`` as a dense tensor: a tensor as it is, a packed weight (any object
    with ``dequantize()``, e.g. ``inference.quantization.WOQLeaf``) unpacked."""
    return w if isinstance(w, torch.Tensor) else w.dequantize()


# ----------------------------------------------------------------- mlp
def swiglu_mlp(params, x):
    """Llama-style gated MLP: down(silu(gate(x)) * up(x))."""
    gate = F.silu(x @ params["w_gate"].to(x.dtype))
    up = x @ params["w_up"].to(x.dtype)
    return (gate * up) @ params["w_down"].to(x.dtype)


# ------------------------------------------------------------------ losses
def cross_entropy_loss(logits, labels, ignore_index=-100, z_loss=0.0):
    """Token cross entropy in fp32 with masking; logits [B, S, V], labels
    [B, S] int."""
    logits = logits.float()
    labels = labels.long()
    mask = labels != ignore_index
    safe_labels = torch.where(mask, labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe_labels[..., None])[..., 0]
    nll = (logz - gold) * mask
    loss = nll.sum() / torch.clamp(mask.sum(), min=1)
    if z_loss > 0.0:
        loss = loss + z_loss * torch.mean((logz * mask)**2)
    return loss


def causal_lm_batch(ids):
    """Shift token ids into (input_ids, labels) next-token pairs: both keep
    S - 1 tokens."""
    ids = np.asarray(ids)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


# ------------------------------------------------------------- params / pools
def count_params(init_fn) -> int:
    """Parameter count of the tree ``init_fn()`` builds, drawn on the meta
    device (no storage; the analogue of ``jax.eval_shape``).  ``init_fn``
    must leave the device to the default (``device=None``) and draw from no
    generator."""
    from ..runtime.tree import tree_leaves
    with torch.device("meta"):
        return sum(leaf.numel() for leaf in tree_leaves(init_fn()))


def tree_to_torch(tree, device, dtype):
    """A pytree of numpy arrays (or anything ``np.array`` takes, such as JAX
    arrays) -> the same nesting of tensors on ``device`` in ``dtype``."""
    from ..runtime.tree import tree_map
    return tree_map(lambda x: torch.from_numpy(np.array(x)).to(device=device, dtype=dtype), tree)


def init_linear(generator, in_dim, out_dim, scale=None, dtype=torch.float32, device=None,
                layers: Optional[int] = None):
    """Normal(0, scale^2) weight [in, out] (or [layers, in, out] stacked),
    scale defaulting to 1/sqrt(in), drawn from ``generator``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    shape = (in_dim, out_dim) if layers is None else (layers, in_dim, out_dim)
    w = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return w.mul_(scale)


def init_paged_kv_pool(num_layers: int, num_kv_heads: int, head_dim: int, num_blocks: int,
                       block_size: int, dtype=torch.bfloat16, device=None):
    """Paged KV pool [L, NB, KV, bs, Dh]; the last block is the trash target
    for padded-token writes."""
    shape = (num_layers, num_blocks, num_kv_heads, block_size, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ------------------------------------------------------ HF state-dict helpers
def hf_tensor(state_dict, name):
    """One HF state-dict entry (torch tensor or array) as an fp32 CPU tensor."""
    return torch.as_tensor(state_dict[name]).detach().to(device="cpu", dtype=torch.float32)


def hf_stack(state_dict, fmt, num_layers, dtype, transpose=True):
    """Stack one per-layer HF tensor into an [L, ...] leaf of ``dtype``,
    transposing torch Linear [out, in] into our [in, out] unless
    ``transpose=False``."""
    ws = [hf_tensor(state_dict, fmt.format(i)) for i in range(num_layers)]
    return torch.stack([w.T if transpose else w for w in ws]).to(dtype)


# -------------------------------------------------------- paged-serving shared
def paged_cost(*, n: int, t: int, b: int, block_size: int, dtype, layers: int, heads: int,
               kv_heads: int, head_dim: int, layer_weights: int, hidden: int, vocab: int,
               n_params: int):
    """(FLOPs, bytes) of one ``forward_paged`` over an ``(n, t, b)`` bucket,
    the families' ``paged_bucket_cost``: ``layer_weights`` are the weight
    elements one layer multiplies every row by (matrix products only; bias
    adds and norms are not counted).

    FLOPs: ``2 n t`` times every layer's weight elements and the head's
    ``hidden x vocab`` (every row the forward projects), and the attention
    products ``4 n t (b block_size) heads head_dim`` a layer (scores and
    values over every table position).  Bytes: every
    parameter once, the KV read of ``n b block_size`` positions and the KV
    write of ``n t`` positions over all layers, the int32 token rows and the
    logit rows: the least bytes the bucket must move."""
    item = torch.empty((), dtype=dtype).element_size()
    rows = n * t
    flops = (2.0 * rows * layers * layer_weights
             + 4.0 * rows * b * block_size * heads * head_dim * layers
             + 2.0 * rows * hidden * vocab)
    kv_position = 2 * layers * kv_heads * head_dim * item  # k and v of one position
    nbytes = (n_params * item + n * b * block_size * kv_position + rows * kv_position
              + rows * 4 + rows * vocab * item)
    return flops, float(nbytes)


def paged_write_index(blk, off, kv_heads: int):
    """The advanced index that writes a chunk's [N, T, KV, Dh] keys or
    values into one layer's pool [NB, KV, bs, Dh]: pool[blk, h, off] =
    k[n, t, h]."""
    return (blk.long()[:, :, None], torch.arange(kv_heads, device=blk.device)[None, None, :],
            off.long()[:, :, None])


def paged_chunk_indices(tokens, n_tokens, start_pos, block_tables, num_blocks: int,
                        block_size: int):
    """Maps the ragged chunk's absolute positions onto paged-KV pool
    coordinates.  Returns (safe_pos [N,T], valid [N,T], lengths [N], blk [N,T],
    off [N,T]): ``blk``/``off`` address pool[blk, :, off] for each token's KV
    write, with padded tokens routed to the trash block (``num_blocks - 1``)."""
    tchunk = tokens.shape[1]
    trash = num_blocks - 1
    ar = torch.arange(tchunk, device=tokens.device, dtype=start_pos.dtype)
    positions = start_pos[:, None] + ar[None, :]
    valid = ar[None, :] < n_tokens[:, None]
    safe_pos = torch.where(valid, positions, 0)
    lengths = start_pos + n_tokens
    blk = torch.gather(block_tables, 1, (safe_pos // block_size).long())
    blk = torch.where(valid, blk, trash)
    off = torch.where(valid, safe_pos % block_size, 0)
    return safe_pos, valid, lengths, blk, off

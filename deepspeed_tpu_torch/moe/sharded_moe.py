"""Mixture-of-Experts gating and dispatch at world size 1.

Counterpart of ``deepspeed_tpu/moe/sharded_moe.py`` (``top1gating``,
``top2gating``, ``TopKGate``, ``moe_layer``): the GShard einsum dispatch and
combine over a capacity dimension, with the JAX package's capacity dropping
and aux loss.  Expert parallelism (the JAX package's sharding constraint on
the expert dim) is not ported: ``moe_layer`` with ``ep_size > 1`` raises.

One-hot rows are built by comparison, so an index at or past the capacity
gives a zero row, as ``jax.nn.one_hot`` does (``F.one_hot`` would raise).
``torch.argmax`` and ``jnp.argmax`` both take the first maximum.
"""

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

EP_UNPORTED = ("expert parallelism (ep_size > 1) is not ported yet: it comes with multi-GPU "
               "parallelism over torch.distributed (ROADMAP Queue 1, item 11)")


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float, min_capacity: int,
              k: int = 1) -> int:
    cap = int(math.ceil(num_tokens * capacity_factor * k / num_experts))
    return max(cap, min_capacity)


def _one_hot(idx, n: int):
    """float32 one-hot rows of ``idx`` over ``n`` classes; out-of-range -> zeros."""
    return (idx.long()[..., None] == torch.arange(n, device=idx.device)).float()


class GateOutput(NamedTuple):
    l_aux: torch.Tensor
    combine_weights: torch.Tensor  # [S, E, C]
    dispatch_mask: torch.Tensor  # [S, E, C] bool
    exp_counts: torch.Tensor  # [E]


def top1gating(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
               noisy_gate_policy: Optional[str] = None, rng=None, used_capacity=None,
               drop_tokens: bool = True) -> GateOutput:
    """Switch-style top-1 gating: aux loss = E * sum_e(mean_prob_e *
    frac_tokens_e); tokens past an expert's capacity are dropped (their
    combine row is zero).  ``noisy_gate_policy="RSample"`` with ``rng`` (a
    ``torch.Generator``) picks the expert from Gumbel-perturbed logits."""
    s, e = logits.shape
    capacity = _capacity(s, e, capacity_factor, min_capacity, k=1)
    gates = torch.softmax(logits.float(), dim=-1)
    if noisy_gate_policy == "RSample" and rng is not None:
        u = torch.rand(logits.shape, generator=rng, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        idx = torch.argmax(logits + gumbel, dim=-1)
    else:
        idx = torch.argmax(gates, dim=-1)
    mask1 = _one_hot(idx, e)  # [S, E]

    me = torch.mean(gates, dim=0)
    ce = torch.mean(mask1, dim=0)
    l_aux = torch.sum(me * ce) * e

    # position of each token within its expert's queue
    locations = torch.cumsum(mask1, dim=0) - mask1  # [S, E]
    pos_in_expert = torch.sum(locations * mask1, dim=-1)  # [S]
    if drop_tokens:
        mask1 = mask1 * (pos_in_expert < capacity)[:, None]

    gate_val = torch.sum(gates * mask1, dim=-1)  # [S]
    cap_onehot = _one_hot(pos_in_expert, capacity)  # [S, C]
    combine = gate_val[:, None, None] * mask1[:, :, None] * cap_onehot[:, None, :]
    return GateOutput(l_aux, combine, combine > 0, torch.sum(mask1, dim=0).int())


def top2gating(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
               drop_tokens: bool = True, rng=None) -> GateOutput:
    """GShard top-2 gating: the second expert is chosen with the first
    masked out; the two gate values are renormalized to sum to 1."""
    s, e = logits.shape
    capacity = _capacity(s, e, capacity_factor, min_capacity, k=2)
    gates = torch.softmax(logits.float(), dim=-1)

    mask1 = _one_hot(torch.argmax(gates, dim=-1), e)
    mask2 = _one_hot(torch.argmax(gates * (1.0 - mask1), dim=-1), e)

    me = torch.mean(gates, dim=0)
    ce = torch.mean(mask1, dim=0)
    l_aux = torch.sum(me * ce) * e

    loc1 = torch.cumsum(mask1, dim=0) - mask1
    loc2 = torch.cumsum(mask2, dim=0) - mask2 + torch.sum(mask1, dim=0, keepdim=True)
    pos1 = torch.sum(loc1 * mask1, dim=-1)
    pos2 = torch.sum(loc2 * mask2, dim=-1)
    if drop_tokens:
        mask1 = mask1 * (pos1 < capacity)[:, None]
        mask2 = mask2 * (pos2 < capacity)[:, None]

    g1 = torch.sum(gates * mask1, dim=-1)
    g2 = torch.sum(gates * mask2, dim=-1)
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom

    cap1 = _one_hot(pos1, capacity)
    cap2 = _one_hot(pos2, capacity)
    combine = (g1[:, None, None] * mask1[:, :, None] * cap1[:, None, :]
               + g2[:, None, None] * mask2[:, :, None] * cap2[:, None, :])
    counts = torch.sum(mask1 + mask2, dim=0).int()
    return GateOutput(l_aux, combine, combine > 0, counts)


class TopKGate:
    """The gate: params = {'wg': [M, E]}; k = 1 or 2."""

    def __init__(self, model_dim: int, num_experts: int, k: int = 1, capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 noisy_gate_policy: Optional[str] = None, drop_tokens: bool = True):
        if k not in (1, 2):
            raise ValueError("TopKGate supports k=1 or k=2")
        self.model_dim = model_dim
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens = drop_tokens

    def init(self, generator, dtype=torch.float32, device=None):
        wg = torch.randn((self.model_dim, self.num_experts), generator=generator, dtype=dtype,
                         device=device)
        return {"wg": wg.mul_(0.02)}

    def __call__(self, params, x, train: bool = True, rng=None) -> GateOutput:
        logits = x.float() @ params["wg"].float()
        cf = self.capacity_factor if train else self.eval_capacity_factor
        if self.k == 1:
            return top1gating(logits, cf, self.min_capacity,
                              self.noisy_gate_policy if train else None, rng,
                              drop_tokens=self.drop_tokens)
        return top2gating(logits, cf, self.min_capacity, drop_tokens=self.drop_tokens, rng=rng)


def moe_layer(gate: TopKGate, params, x, *, expert_fn: Callable, train: bool = True, rng=None,
              ep_size: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch -> grouped experts -> combine.

    x [..., M] (leading dims flattened to the token dim); params {'gate':
    gate params, 'experts': stacked expert params (leading dim E)};
    ``expert_fn(expert_params, tokens [E, C, M]) -> [E, C, M]``.  Returns
    (out, l_aux)."""
    if ep_size > 1:
        raise NotImplementedError(EP_UNPORTED)
    orig_shape = x.shape
    tokens = x.reshape(-1, orig_shape[-1])
    gout = gate(params["gate"], tokens, train=train, rng=rng)
    # dispatch: [S, E, C] x [S, M] -> [E, C, M]
    dispatched = torch.einsum("sec,sm->ecm", gout.dispatch_mask.to(x.dtype), tokens)
    expert_out = expert_fn(params["experts"], dispatched)
    out = torch.einsum("sec,ecm->sm", gout.combine_weights.to(x.dtype), expert_out)
    return out.reshape(orig_shape), gout.l_aux

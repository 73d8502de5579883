"""MoE facade: a TopKGate and stacked experts in one layer with an
init/apply pair, at world size 1.

Counterpart of ``deepspeed_tpu/moe/layer.py::MoE``, with its PR-MoE residual
combine.  ``ep_size`` must divide ``num_experts``; ``ep_size > 1`` raises
(expert parallelism is not ported).
"""

from typing import Optional

import torch

from . import experts as experts_lib
from .sharded_moe import EP_UNPORTED, TopKGate, moe_layer


class MoE:

    def __init__(self,
                 hidden_size: int,
                 expert_intermediate_size: Optional[int] = None,
                 num_experts: int = 1,
                 ep_size: int = 1,
                 k: int = 1,
                 capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0,
                 min_capacity: int = 4,
                 use_residual: bool = False,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True,
                 expert_kind: str = "swiglu"):
        if num_experts % ep_size != 0:
            raise ValueError(f"num_experts({num_experts}) must be divisible by ep_size({ep_size})")
        if ep_size > 1:
            raise NotImplementedError(EP_UNPORTED)
        self.hidden_size = hidden_size
        self.ffn_dim = expert_intermediate_size or 4 * hidden_size
        self.num_experts = num_experts
        self.ep_size = ep_size
        self.use_residual = use_residual
        self.expert_kind = expert_kind
        self.gate = TopKGate(hidden_size, num_experts, k, capacity_factor, eval_capacity_factor,
                             min_capacity, noisy_gate_policy, drop_tokens)
        if expert_kind == "swiglu":
            self._init_experts = experts_lib.init_swiglu_experts
            self._expert_fn = experts_lib.swiglu_experts
        else:
            self._init_experts = experts_lib.init_gelu_experts
            self._expert_fn = experts_lib.gelu_experts

    def init(self, generator, dtype=torch.float32, device=None):
        params = {
            "gate": self.gate.init(generator, dtype=dtype, device=device),
            "experts": self._init_experts(generator, self.num_experts, self.hidden_size,
                                          self.ffn_dim, dtype=dtype, device=device),
        }
        if self.use_residual:
            # PR-MoE: a dense expert-shaped MLP on every token and a learned
            # 2-way mixing head
            params["residual_mlp"] = self._init_experts(generator, 1, self.hidden_size,
                                                        self.ffn_dim, dtype=dtype, device=device)
            w = torch.randn((self.hidden_size, 2), generator=generator, dtype=dtype, device=device)
            params["coefficient"] = {"w": w.mul_(0.02),
                                     "b": torch.zeros((2, ), dtype=dtype, device=device)}
        return params

    def __call__(self, params, x, train: bool = True, rng=None):
        """x [..., hidden] -> (out, l_aux)."""
        out, l_aux = moe_layer(self.gate, params, x, expert_fn=self._expert_fn, train=train,
                               rng=rng, ep_size=self.ep_size)
        if self.use_residual:
            # residual combine: softmax'd per-token coefficients weight the
            # expert output against the dense MLP's
            flat = x.reshape(-1, self.hidden_size)
            mlp_out = self._expert_fn(params["residual_mlp"], flat[None])[0].reshape(x.shape)
            coef = torch.softmax(
                (x @ params["coefficient"]["w"].to(x.dtype)
                 + params["coefficient"]["b"].to(x.dtype)).float(), dim=-1).to(x.dtype)
            out = out * coef[..., 0:1] + mlp_out * coef[..., 1:]
        return out, l_aux

"""Grouped expert FFNs, stacked on a leading expert dim E.

Counterpart of ``deepspeed_tpu/moe/experts.py``: expert weights are stacked
``[E, in, out]`` and applied as batched products over E (one ``matmul``
each) instead of a loop over per-expert modules.
"""

import math

import torch
import torch.nn.functional as F


def _stack(generator, num_experts, in_dim, out_dim, dtype, device):
    """Fan-in normal weights [E, in, out] (``transformer.init_linear``'s scale)."""
    w = torch.randn((num_experts, in_dim, out_dim), generator=generator, dtype=dtype,
                    device=device)
    return w.mul_(1.0 / math.sqrt(in_dim))


def init_swiglu_experts(generator, num_experts: int, model_dim: int, hidden_dim: int,
                        dtype=torch.float32, device=None):
    return {
        "w_gate": _stack(generator, num_experts, model_dim, hidden_dim, dtype, device),
        "w_up": _stack(generator, num_experts, model_dim, hidden_dim, dtype, device),
        "w_down": _stack(generator, num_experts, hidden_dim, model_dim, dtype, device),
    }


def swiglu_experts(params, tokens):
    """tokens [E, C, M] -> [E, C, M], batched over the experts."""
    gate = F.silu(torch.matmul(tokens, params["w_gate"].to(tokens.dtype)))
    up = torch.matmul(tokens, params["w_up"].to(tokens.dtype))
    return torch.matmul(gate * up, params["w_down"].to(tokens.dtype))


def init_gelu_experts(generator, num_experts: int, model_dim: int, hidden_dim: int,
                      dtype=torch.float32, device=None):
    return {
        "w_fc1": _stack(generator, num_experts, model_dim, hidden_dim, dtype, device),
        "b_fc1": torch.zeros((num_experts, hidden_dim), dtype=dtype, device=device),
        "w_fc2": _stack(generator, num_experts, hidden_dim, model_dim, dtype, device),
        "b_fc2": torch.zeros((num_experts, model_dim), dtype=dtype, device=device),
    }


def gelu_experts(params, tokens):
    """tokens [E, C, M] -> [E, C, M]: fc1, tanh GELU, fc2, each with its bias."""
    h = (torch.matmul(tokens, params["w_fc1"].to(tokens.dtype))
         + params["b_fc1"][:, None, :].to(tokens.dtype))
    h = F.gelu(h, approximate="tanh")
    return (torch.matmul(h, params["w_fc2"].to(tokens.dtype))
            + params["b_fc2"][:, None, :].to(tokens.dtype))

"""Progressive layer drop (PLD).

Counterpart of ``deepspeed_tpu/runtime/progressive_layer_drop.py``:
theta(t) = (1 - theta_bar) * exp(-gamma * t) + theta_bar is the global keep
probability; layer i of L keeps with probability 1 - ((i + 1) / L) * (1 -
theta), so deeper layers drop more.  ``pld_scan_layer`` wraps a layer body
with the stochastic skip, its Bernoulli drawn from an explicit
``torch.Generator``.
"""

import math
from typing import Callable

import torch


class ProgressiveLayerDrop:

    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0

    def get_theta(self) -> float:
        return self.current_theta

    def update_state(self, global_step: int) -> float:
        def _prob(x, gamma, p):
            return (1.0 - p) * math.exp(-gamma * x) + p

        self.current_theta = _prob(global_step, self.gamma, self.theta)
        return self.current_theta

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}


def layer_keep_prob(theta: float, layer_idx, num_layers: int):
    """Per-layer keep probability: deeper layers drop more."""
    frac = (layer_idx + 1) / num_layers
    return 1.0 - frac * (1.0 - theta)


def pld_scan_layer(layer_fn: Callable, num_layers: int):
    """Wrap a layer body ``layer_fn(x, params) -> (y, aux)`` with the
    stochastic skip: the wrapper takes ``(x, (idx, generator, theta,
    params))``, keeps the layer with :func:`layer_keep_prob` (one draw from
    ``generator``) and rescales the kept residual delta by the inverse
    probability; a dropped layer passes ``x`` through."""

    def wrapped(x, inp):
        idx, generator, theta, layer_params = inp
        keep_p = layer_keep_prob(theta, idx, num_layers)
        keep = torch.rand((), generator=generator, device=generator.device) < keep_p
        y, aux = layer_fn(x, layer_params)
        out = torch.where(keep.to(x.device), x + (y - x) / max(keep_p, 1e-3), x)
        return out.to(x.dtype), aux

    return wrapped

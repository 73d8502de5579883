"""Hessian eigenvalue estimation (an aid to MoQ's precision schedule).

Counterpart of ``deepspeed_tpu/runtime/eigenvalue.py``: power iteration for
the dominant eigenvalue of the loss Hessian.  The Hessian-vector product is
a double backward (``torch.autograd.grad(..., create_graph=True)``, then the
grad of <grad, v>), so the loss must be plain torch math: the flash and
block-sparse autograd Functions refuse a second derivative, as JAX's
``jvp`` of a ``custom_vjp`` Pallas call does.
"""

from typing import Any, Callable, Dict

import torch

from .tree import tree_leaves


class Eigenvalue:

    def __init__(self, verbose: bool = False, max_iter: int = 100, tol: float = 1e-2,
                 stability: float = 1e-6):
        self.max_iter = max_iter
        self.tol = tol
        self.stability = stability
        self.verbose = verbose

    def compute_eigenvalue(self, loss_fn: Callable, params: Any, batch: Any,
                           rng=None, seed: int = 0) -> Dict[str, float]:
        """Dominant Hessian eigenvalue of ``loss_fn(params, batch, rng)`` over
        all the params, in fp32."""
        leaves = [p.detach().float().requires_grad_(True) for p in tree_leaves(params)]

        def rebuild(tree, it):
            if isinstance(tree, dict):
                return {k: rebuild(v, it) for k, v in tree.items()}
            return next(it)

        def hvp(v):
            out = loss_fn(rebuild(params, iter(leaves)), batch, rng)
            loss = (out[0] if isinstance(out, tuple) else out).float()
            grads = torch.autograd.grad(loss, leaves, create_graph=True)
            dot = sum((g * u).sum() for g, u in zip(grads, v))
            return [h.detach() for h in torch.autograd.grad(dot, leaves)]

        gen = torch.Generator(device=leaves[0].device).manual_seed(seed)
        v = _normalize([torch.randn(p.shape, generator=gen, device=p.device) for p in leaves])
        eig = 0.0
        for i in range(self.max_iter):
            hv = hvp(v)
            new_eig = float(_dot(v, hv))
            v = _normalize(hv)
            if abs(new_eig) < self.stability:
                eig = new_eig
                break
            if i > 0 and abs(new_eig - eig) / (abs(new_eig) + self.stability) < self.tol:
                eig = new_eig
                break
            eig = new_eig
        return {"eigenvalue": eig}


def _dot(a, b) -> torch.Tensor:
    return sum((x * y).sum() for x, y in zip(a, b))


def _normalize(v):
    norm = torch.sqrt(torch.clamp(_dot(v, v), min=1e-12))
    return [x / norm for x in v]

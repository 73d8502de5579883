"""Tensor fragment API: full access to one parameter's master weights,
optimizer state and gradient (``deepspeed_tpu/utils/tensor_fragment.py``,
the reference's ``deepspeed/utils/tensor_fragment.py``).

The port trains on one device, so "full" needs no gather: a get returns a
host numpy copy of the leaf, a set copies into it in place.  Paths are
dotted checkpoint keys (``"layers.attn.wq"``).  On an offloaded engine the
master params and moments are the host's, and a set refreshes the device's
compute copy.
"""

from typing import Optional

import numpy as np
import torch


def _resolve(tree, dotted: str):
    node = tree
    for part in dotted.split("."):
        if isinstance(node, tuple) and hasattr(node, "_fields") and part in node._fields:
            node = getattr(node, part)  # NamedTuple states (optimizer moments)
        elif isinstance(node, (list, tuple)):
            node = node[int(part)]
        elif isinstance(node, dict):
            if part not in node:
                raise KeyError(f"path component '{part}' not in {sorted(node)}")
            node = node[part]
        else:
            node = getattr(node, part)
    return node


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def safe_get_full_fp32_param(engine, param_path: str) -> Optional[np.ndarray]:
    """One fp32 master parameter, as a host array."""
    return _host(_resolve(engine._master_params(), param_path))


def safe_set_full_fp32_param(engine, param_path: str, value) -> None:
    """Overwrite one fp32 master parameter in place."""
    value = np.asarray(value, np.float32)
    if engine._offload_state is not None:
        flat = engine._offload_state.params
        if param_path not in flat:
            raise KeyError(f"{param_path} not in offloaded params: {sorted(flat)[:8]}...")
        flat[param_path].copy_(torch.from_numpy(np.ascontiguousarray(value).ravel()))
        engine._push_compute_params()
        return
    leaf = _resolve(engine.state.params, param_path)
    if tuple(leaf.shape) != value.shape:
        raise ValueError(f"shape mismatch for {param_path}: {value.shape} vs {tuple(leaf.shape)}")
    with torch.no_grad():
        leaf.copy_(torch.from_numpy(np.ascontiguousarray(value)))


def safe_get_full_optimizer_state(engine, param_path: str, state_name: str) -> Optional[np.ndarray]:
    """One optimizer moment (``"exp_avg"``/``"exp_avg_sq"`` or another field of
    the optimizer's state) in the param's shape.  The quantized
    ``fused_adam8bit`` moments come back dequantized (v squared back from its
    sqrt domain)."""
    if engine._offload_state is not None:
        sd = engine._offload_state.state_dict()
        key = {"exp_avg": "m", "exp_avg_sq": "v"}[state_name]
        return _host(sd[key][param_path])
    opt_state = engine.state.opt_state
    if type(opt_state).__name__ == "Adam8bitState" and state_name in ("exp_avg", "exp_avg_sq"):
        from ..ops.adam.adam8bit import dequantize_moments
        param = _resolve(engine.state.params, param_path)
        leaves = [_resolve(getattr(opt_state, f), param_path)
                  for f in ("exp_avg", "exp_avg_sq", "scale_m", "scale_v")]
        m, v = dequantize_moments(*leaves, param.numel())
        out = m if state_name == "exp_avg" else v
        return _host(out.reshape(param.shape))
    return _host(_resolve(_resolve(opt_state, state_name), param_path))


def safe_get_full_grad(engine, param_path: str) -> Optional[np.ndarray]:
    """The last step's gradient of one parameter, where the engine keeps one
    (``_last_grads``); None otherwise, as in JAX: grads are transient inside
    the step."""
    grads = getattr(engine, "_last_grads", None)
    if grads is None:
        return None
    return _host(_resolve(grads, param_path))

"""Hybrid engine: RLHF's train and generate over the same weights.

Counterpart of ``deepspeed_tpu/runtime/hybrid_engine.py``.  The engine
trains as :class:`~.engine.Engine` does and generates rollouts from its
current weights through one v1 :class:`~..inference.engine.InferenceEngine`,
built at the first ``generate`` or ``eval_forward`` on the engine's device
and kept for the engine's life.  A flip (after a step, or a LoRA change)
writes the current weights into that engine's own buffers with ``copy_``,
cast on the device, one leaf at a time, so it never holds a second copy of
the weights (JAX builds new arrays and keeps its compiled programs).  The
weights come from the fp32 masters, or under ``offload_optimizer`` from the
compute copy the engine keeps on the device; the ``offload_param: nvme``
path holds no weights on the device and raises.

LoRA adapters mirror the param tree on the adapted subset, each adapted
leaf ``{"a": [..., in, r], "b": [..., r, out], "alpha": s}`` (an adapter
without the leading layer dim is shared by every stacked layer).  Generation
serves ``W + (alpha/r) a @ b`` in the compute dtype; the train step always
sees the base weights.
"""

import logging
from typing import Dict, Optional

import numpy as np
import torch

from ..inference.config import DTYPES
from ..inference.engine import InferenceEngine
from .checkpointing import flatten_with_paths
from .engine import Engine

logger = logging.getLogger(__name__)

_NVME_REFUSAL = ("hybrid engine generation/LoRA is not available on the offload_param:nvme "
                 "streaming path (no resident params)")


def _shape(x):
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _is_adapter(x) -> bool:
    return isinstance(x, dict) and "a" in x and "b" in x


def _adapters(lora, path=()):
    """``(path, adapter)`` of every adapter of a LoRA tree."""
    if _is_adapter(lora):
        yield path, lora
    elif isinstance(lora, dict):
        for k, v in lora.items():
            yield from _adapters(v, path + (k, ))


class DeepSpeedHybridEngine(Engine):
    """Training engine with in-loop generation over the same weights.

    Keywords beyond :class:`~.engine.Engine`'s: ``model_module`` (a
    ``models.llama``-style module: ``init_cache``, ``forward_with_cache``)
    and ``model_config``; ``inference_config`` (the v1 engine's config; its
    dtype defaults to bf16 under bf16 training, else fp32, as in JAX);
    ``lora_params``.  ``loss_fn`` still drives training."""

    def __init__(self, *args, model_module=None, model_config=None,
                 inference_config: Optional[Dict] = None, lora_params=None, **kwargs):
        super().__init__(*args, **kwargs)
        if model_module is None:
            raise ValueError("DeepSpeedHybridEngine needs model_module (and model_config)")
        self.model_module = model_module
        self.model_config = model_config
        self._inf_cfg = dict(inference_config or {})
        self._inf_cfg.setdefault("dtype", "bfloat16" if self.compute_dtype == torch.bfloat16
                                 else "float32")
        if (self._inf_cfg.get("quant") or {}).get("enabled"):
            raise NotImplementedError("DeepSpeedHybridEngine serves its training weights dense: "
                                      "an inference_config with quant enabled is not ported")
        self._inf_engine: Optional[InferenceEngine] = None
        self._inf_bufs: Dict[tuple, torch.Tensor] = {}
        self._params_version = -1
        self._lora = None
        self._lora_fused = False
        if lora_params is not None:
            self.set_lora(lora_params)
        logger.info("HybridEngine: training + rollout generation enabled")

    # --------------------------------------------------------------- LoRA
    def _base_params(self):
        """The weights generation starts from: the fp32 masters, or the
        device's compute copy under ``offload_optimizer``."""
        if self._nvme_trainer is not None:
            raise ValueError(_NVME_REFUSAL)
        return self._compute if self._offload_state is not None else self.state.params

    def set_lora(self, lora_params) -> None:
        """Attach (or with None detach) LoRA adapters; they are validated
        against the base tree, and the next generation serves them fused."""
        if lora_params is not None:
            self._validate_lora(self._base_params(), lora_params)
        self._lora = lora_params
        self._lora_fused = lora_params is not None
        self._params_version = -1

    @classmethod
    def _validate_lora(cls, params, lora, path=""):
        """Reject adapters whose paths are not in the base tree (a typo'd key
        would fuse as a silent no-op) or whose shapes do not fit."""
        if lora is None:
            return
        if _is_adapter(lora):
            if not hasattr(params, "shape"):
                raise ValueError(f"LoRA adapter at {path or '<root>'} targets a non-leaf")
            a, b, w = _shape(lora["a"]), _shape(lora["b"]), tuple(params.shape)
            ok = len(a) >= 2 and len(b) >= 2 and len(w) >= 2 \
                and a[-1] == b[-2] and a[-2] == w[-2] and b[-1] == w[-1]
            if ok:
                try:  # batch dims may broadcast (shared adapter over stacked layers)
                    ok = np.broadcast_shapes(a[:-2], b[:-2], w[:-2]) == w[:-2]
                except ValueError:
                    ok = False
            if not ok:
                raise ValueError(f"LoRA shapes at {path}: a{a} @ b{b} does not match W{w}")
            return
        if not isinstance(lora, dict) or not isinstance(params, dict):
            raise ValueError(f"LoRA adapter at {path or '<root>'}: expected a dict mirroring "
                             f"the param tree (leaves = {{'a','b','alpha'}})")
        unknown = set(lora) - set(params)
        if unknown:
            raise ValueError(f"LoRA adapter keys {sorted(unknown)} at {path or '<root>'} "
                             f"not in base params (have: {sorted(params)})")
        for k, v in lora.items():
            cls._validate_lora(params[k], v, f"{path}.{k}" if path else k)

    def fuse_lora_weight(self) -> None:
        """Serve the adapters fused (the reference's explicit fuse)."""
        self._ensure_lora_toggle(True)

    def unfuse_lora_weight(self) -> None:
        """Serve the base weights again."""
        self._ensure_lora_toggle(False)

    def _ensure_lora_toggle(self, fused: bool):
        if self._lora is None:
            raise ValueError("no LoRA adapters attached — call set_lora first")
        if self._lora_fused != fused:
            self._lora_fused = fused
            self._params_version = -1

    @staticmethod
    def _lora_delta(w: torch.Tensor, adapter) -> torch.Tensor:
        """``(alpha/r) a @ b`` in ``w``'s dtype and on its device."""
        def leaf(x):
            if isinstance(x, torch.Tensor):
                return x.to(device=w.device, dtype=w.dtype)
            return torch.as_tensor(np.asarray(x), device=w.device).to(w.dtype)

        a, b = leaf(adapter["a"]), leaf(adapter["b"])
        r = a.shape[-1]
        scale = torch.tensor(float(adapter.get("alpha", r)) / r, dtype=w.dtype, device=w.device)
        return torch.einsum("...ir,...ro->...io", a, b) * scale

    @classmethod
    def _fuse_lora_tree(cls, params, lora):
        """``params`` with ``W + (alpha/r) a @ b`` on the adapted subset, as new
        tensors: the base tree is never changed."""
        def fuse(p, l):
            if l is None:
                return p
            if _is_adapter(l):
                return p + cls._lora_delta(p, l)
            if isinstance(l, dict):
                return {k: fuse(p[k], l.get(k)) for k in p} if isinstance(p, dict) else p
            return p
        return fuse(params, lora)

    # ------------------------------------------------------------- the flip
    def _write_leaf(self, path: tuple, buf: torch.Tensor, src: torch.Tensor, adapter) -> None:
        """Write one serving leaf in place: ``src`` cast to the compute dtype,
        plus the adapter's product when fused, then to the buffer's dtype."""
        cd = self.compute_dtype
        if buf.dtype == cd:
            buf.copy_(src)
            if adapter is not None:
                buf.add_(self._lora_delta(buf, adapter))
            return
        w = src.to(cd)
        if adapter is not None:
            w = w + self._lora_delta(w, adapter)
        buf.copy_(w)

    @torch.no_grad()
    def _write_inference_params(self) -> None:
        src = dict(flatten_with_paths(self._base_params()))
        adapters = dict(_adapters(self._lora)) if self._lora_fused else {}
        for path, buf in self._inf_bufs.items():
            self._write_leaf(path, buf, src[path], adapters.get(path))

    def _refresh_inference(self):
        """Build the inference engine once, or write the current weights into
        its buffers when the step count or the LoRA state changed."""
        if self._inf_engine is None:
            dtype = DTYPES[self._inf_cfg["dtype"]]
            bufs = {}

            def alloc(tree, path=()):
                if isinstance(tree, dict):
                    return {k: alloc(v, path + (k, )) for k, v in tree.items()}
                bufs[path] = torch.empty(tuple(tree.shape), dtype=dtype, device=self.device)
                return bufs[path]

            tree = alloc(self._base_params())
            # the engine keeps these buffers: their dtype and device are its own
            self._inf_engine = InferenceEngine(self.model_module, self.model_config, tree,
                                               config=self._inf_cfg, device=self.device)
            self._inf_bufs = bufs
            self._write_inference_params()
        elif self._params_version != self.global_steps:
            self._write_inference_params()
        self._params_version = self.global_steps

    def load_checkpoint(self, *args, **kwargs):
        out = super().load_checkpoint(*args, **kwargs)
        self._params_version = -1  # the weights changed under the same step count
        return out

    # ------------------------------------------------------------ public API
    def generate(self, input_ids, **kwargs) -> np.ndarray:
        """Rollout generation from the current training weights (the v1
        engine's ``generate`` and its keywords)."""
        self._refresh_inference()
        return self._inf_engine.generate(input_ids, **kwargs)

    def eval_forward(self, input_ids):
        """Logits of the current weights, for scoring rollouts."""
        self._refresh_inference()
        return self._inf_engine.forward(input_ids)

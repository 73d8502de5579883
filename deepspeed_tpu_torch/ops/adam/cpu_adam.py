"""Host-resident AdamW (``deepspeed_tpu/ops/adam/cpu_adam.py``, the reference's
DeepSpeedCPUAdam).

Steps fp32 master params and moments in host RAM through the OpenMP C++
library ``csrc/cpu_adam.cpp`` (a copy of the JAX package's), built with g++
at first use and called through ``ctypes`` on the tensors' ``data_ptr()``.
The optimizer-offload path (``runtime/swap_tensor``) uses it.  Where the JAX
class falls back to numpy when the build fails, this one raises
(:class:`~deepspeed_tpu_torch.ops._build.KernelBuildError`): no path of the
port steps on the plain version.  ``cpu_adamw_plain`` is that plain version
in torch ops, for the tests.

The library's OpenMP runtime is not torch's, so the two would both start one
thread a core; ``threads`` sets the library's own count explicitly (default:
the cores this process may run on).
"""

import ctypes
import os
from typing import Optional

import numpy as np
import torch

from .. import _build

LIBRARY = "cpu_adam"


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIBRARY)
    if not getattr(lib, "_bound", False):
        f32p = ctypes.c_void_p
        lib.dstpu_adamw_step.argtypes = [f32p, f32p, f32p, f32p, ctypes.c_size_t,
                                         ctypes.c_float, ctypes.c_float, ctypes.c_float,
                                         ctypes.c_float, ctypes.c_float, ctypes.c_int]
        lib.dstpu_adamw_step.restype = None
        # libgomp's setter, resolved through the library's own dependencies
        lib.omp_set_num_threads.argtypes = [ctypes.c_int]
        lib.omp_set_num_threads.restype = None
        lib._bound = True
    return lib


def default_threads() -> int:
    """The cores this process may run on."""
    return len(os.sched_getaffinity(0))


def _flat_f32(name: str, t: torch.Tensor) -> torch.Tensor:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"cpu_adam: {name} must be a torch tensor, got {type(t).__name__}")
    if t.device.type != "cpu" or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"cpu_adam: {name} must be a contiguous float32 CPU tensor, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    return t


class DeepSpeedCPUAdam:
    """AdamW with decoupled weight decay and bias correction over flat fp32
    CPU tensors, updated in place.  ``launches`` counts the library calls."""

    launches = 0

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 threads: Optional[int] = None):
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.step_count = 0
        self.threads = int(threads or default_threads())
        self._lib = _lib()  # builds now: a missing compiler raises here, not mid-step

    def step(self, p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
             lr: Optional[float] = None, step: Optional[int] = None) -> None:
        """One in-place AdamW step over ``p``, ``m``, ``v`` with grad ``g`` (all
        contiguous fp32 CPU tensors of one size); ``step`` is 1-based (default:
        this optimizer's own count, advanced)."""
        lr = self.lr if lr is None else float(lr)
        if step is None:
            self.step_count += 1
            step = self.step_count
        tensors = [_flat_f32(name, t) for name, t in (("p", p), ("m", m), ("v", v), ("g", g))]
        n = p.numel()
        if any(t.numel() != n for t in tensors):
            raise ValueError(f"cpu_adam: sizes differ: {[t.numel() for t in tensors]}")
        self._lib.omp_set_num_threads(self.threads)
        self._lib.dstpu_adamw_step(*(t.data_ptr() for t in tensors), n, lr, self.beta1,
                                   self.beta2, self.eps, self.weight_decay, int(step))
        DeepSpeedCPUAdam.launches += 1


def cpu_adamw_plain(p, m, v, g, *, lr, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0,
                    step=1):
    """The library's math in torch ops, in place on fp32 tensors: the plain
    version the tests hold the library to."""
    f32 = np.float32
    bc1 = bc2 = 1.0
    if step > 0:
        bc1 = float(f32(1.0) - np.power(f32(beta1), f32(step)))
        bc2 = float(f32(1.0) - np.power(f32(beta2), f32(step)))
    m.mul_(beta1).add_(g, alpha=float(f32(1.0) - f32(beta1)))
    v.mul_(beta2).add_(g * g, alpha=float(f32(1.0) - f32(beta2)))
    denom = torch.sqrt(v / bc2) + eps
    p.sub_(lr * ((m / bc1) / denom + weight_decay * p))

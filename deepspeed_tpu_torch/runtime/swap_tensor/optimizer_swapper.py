"""Optimizer-state offload: host RAM (``cpu``) or disk (``nvme``) through the
aio library (``deepspeed_tpu/runtime/swap_tensor/optimizer_swapper.py``).

fp32 master params and Adam moments live off the GPU; the GPU holds only the
compute-dtype copy.  A step runs, leaf by leaf:

  grads on the host -> (nvme: swap the moments in) -> C++ CPU-Adam
  -> (nvme: async swap-out of the moments) -> updated master

Host buffers are flat torch tensors with one view a leaf.  With
``pin_memory`` the master params sit in ONE pinned buffer (page-locked, so
that the push to the GPU and the grads' copy back run asynchronously): the
caching host allocator rounds every pinned block up to a power of two, so one
flat block wastes less than a block a leaf and pins once.  ``pin_seconds``
and ``pinned_bytes`` say what pinning cost.
"""

import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ...ops.adam.cpu_adam import DeepSpeedCPUAdam
from ...ops.aio import build_aio_handle


def host_buffer(numel: int, pin_memory: bool) -> torch.Tensor:
    """A flat fp32 host buffer, page-locked with ``pin_memory``."""
    return torch.empty(numel, dtype=torch.float32, pin_memory=pin_memory)


def flat_views(buf: torch.Tensor, sizes: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """Consecutive views of ``buf``, one a key, of the given sizes."""
    out, off = {}, 0
    for key, n in sizes.items():
        out[key] = buf[off:off + n]
        off += n
    return out


def _as_flat_f32(x) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.detach().reshape(-1).to("cpu", torch.float32)


class OffloadedAdamState:
    """Flat host-side AdamW state for one tree of params, keyed by leaf key."""

    def __init__(self, flat_params: Dict[str, object], device: str = "cpu",
                 nvme_path: Optional[str] = None, aio_threads: int = 4, lr: float = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
                 pin_memory: bool = False):
        if device not in ("cpu", "nvme"):
            raise ValueError(f"optimizer offload device must be 'cpu' or 'nvme', got {device!r}")
        self.device = device
        self.opt = DeepSpeedCPUAdam(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
        sizes = {k: int(np.prod(np.shape(v))) for k, v in flat_params.items()}
        total = sum(sizes.values())
        t0 = time.perf_counter()
        self._flat = host_buffer(total, pin_memory)
        self.pin_seconds = time.perf_counter() - t0 if pin_memory else 0.0
        self.pinned_bytes = total * 4 if pin_memory else 0
        self.params: Dict[str, torch.Tensor] = flat_views(self._flat, sizes)
        for k, v in flat_params.items():  # straight into the buffer: no pageable copy between
            src = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            self.params[k].copy_(src.detach().reshape(-1))
        self.step_count = 0
        self._aio = None
        if device == "cpu":
            self._m = flat_views(torch.zeros(total, dtype=torch.float32), sizes)
            self._v = flat_views(torch.zeros(total, dtype=torch.float32), sizes)
        else:
            if not nvme_path:
                raise ValueError("nvme offload needs offload_optimizer.nvme_path")
            self.nvme_dir = os.path.join(nvme_path, "dstpu_opt_swap")
            os.makedirs(self.nvme_dir, exist_ok=True)
            # O_DIRECT, as the reference's libaio queues; a filesystem that
            # refuses it gets buffered I/O inside the library, per file
            self._aio = build_aio_handle(aio_threads, use_odirect=True)
            for k, p in self.params.items():
                zeros = torch.zeros_like(p)
                self._aio.pwrite(self._file(k, "m"), zeros)
                self._aio.pwrite(self._file(k, "v"), zeros)
            self._aio.wait_all()

    def _file(self, key: str, kind: str) -> str:
        return os.path.join(self.nvme_dir, f"{key.replace('/', '_')}.{kind}.bin")

    def step(self, grads: Dict[str, torch.Tensor], lr: Optional[float] = None,
             ready: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        """One AdamW step over every key of ``grads`` (flat fp32 CPU tensors);
        ``ready(key)``, where given, is called before a leaf's grad is read
        (it waits for that grad's copy to the host).  Returns the params."""
        self.step_count += 1
        if self.device == "cpu":
            for k, g in grads.items():
                if ready is not None:
                    ready(k)
                self.opt.step(self.params[k], self._m[k], self._v[k], g, lr=lr,
                              step=self.step_count)
            return self.params
        # nvme: per leaf, swap in -> step -> async swap-out (overlaps the next
        # leaf's swap-in)
        pending: List[int] = []
        for k, g in grads.items():
            m = torch.empty_like(self.params[k])
            v = torch.empty_like(self.params[k])
            rid_m = self._aio.pread(self._file(k, "m"), m)
            rid_v = self._aio.pread(self._file(k, "v"), v)
            self._aio.wait(rid_m)
            self._aio.wait(rid_v)
            if ready is not None:
                ready(k)
            self.opt.step(self.params[k], m, v, g, lr=lr, step=self.step_count)
            pending.append(self._aio.pwrite(self._file(k, "m"), m))
            pending.append(self._aio.pwrite(self._file(k, "v"), v))
        for rid in pending:
            self._aio.wait(rid)
        return self.params

    def state_dict(self) -> Dict[str, object]:
        """``{"m": {key: tensor}, "v": {...}, "step": int}``; the nvme moments
        are read back into fresh tensors."""
        if self.device == "cpu":
            return {"m": self._m, "v": self._v, "step": self.step_count}
        out_m, out_v = {}, {}
        for k, p in self.params.items():
            m, v = torch.empty_like(p), torch.empty_like(p)
            self._aio.wait(self._aio.pread(self._file(k, "m"), m))
            self._aio.wait(self._aio.pread(self._file(k, "v"), v))
            out_m[k], out_v[k] = m, v
        return {"m": out_m, "v": out_v, "step": self.step_count}

    def load_state_dict(self, sd) -> None:
        self.step_count = int(sd.get("step", 0))
        if self.device == "cpu":
            for k in self._m:
                self._m[k].copy_(_as_flat_f32(sd["m"][k]))
                self._v[k].copy_(_as_flat_f32(sd["v"][k]))
            return
        for k in self.params:
            self._aio.pwrite(self._file(k, "m"), _as_flat_f32(sd["m"][k]).contiguous())
            self._aio.pwrite(self._file(k, "v"), _as_flat_f32(sd["v"][k]).contiguous())
        self._aio.wait_all()

    def close(self) -> None:
        if self._aio is not None:
            self._aio.close()
            self._aio = None

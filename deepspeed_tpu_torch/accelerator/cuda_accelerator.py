"""The CUDA accelerator: the counterpart of the JAX package's
``accelerator/tpu_accelerator.py``, with every public method of
``TpuAccelerator`` under the same name.

Where XLA had stand-ins, this one has CUDA's own semantics: ``Stream`` and
``Event`` are ``torch.cuda.Stream`` and ``torch.cuda.Event``
(``elapsed_time`` in ms); ``create_graph``, ``capture_to_graph`` and
``replay_graph`` capture a ``torch.cuda.CUDAGraph`` after a warm-up on a
side stream; ``pin_memory`` gives page-locked host tensors; memory
statistics come from ``torch.cuda``; ``range_push``/``range_pop`` are NVTX
ranges; op builders resolve to ``ops/_build.py``'s libraries.

``CudaAccelerator(device="cpu")`` is for tests on a machine without a GPU:
there ``synchronize`` does nothing, ``Stream`` and ``Event`` are the JAX
package's host stand-ins (an ordering no-op, a wall-clock stamp) and
``create_graph`` raises.  ``get_accelerator()`` returns the process's CUDA
accelerator and raises where there is no GPU: it never hands back a CPU one.
"""

import importlib.util
import time
from typing import Optional

import numpy as np
import torch

from .abstract_accelerator import Accelerator


class _HostStream:
    """A CPU device's stream: ops finish when they return, so ordering is a
    no-op."""

    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def synchronize(self):
        pass

    def wait_stream(self, stream):
        pass


class _HostEvent:
    """A CPU device's event: a wall-clock stamp; ``elapsed_time`` in ms."""

    def __init__(self, enable_timing: bool = True, **kwargs):
        self._t = None

    def record(self, stream=None):
        self._t = time.perf_counter()

    def synchronize(self):
        pass

    def query(self) -> bool:
        return True

    def elapsed_time(self, end_event) -> float:
        if self._t is None or end_event._t is None:
            raise RuntimeError("elapsed_time needs both events recorded")
        return (end_event._t - self._t) * 1e3


class CudaAccelerator(Accelerator):

    def __init__(self, device="cuda"):
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._ranges = []

    def _index(self, device_index=None) -> int:
        if device_index is not None:
            return int(device_index)
        return self._device.index if self._device.index is not None else 0

    # -- identity -------------------------------------------------------------
    def device_name(self, device_index=None) -> str:
        if device_index is None:
            return self._device.type
        return f"{self._device.type}:{device_index}"

    def device(self, device_index=None):
        return torch.device(self._device.type, self._index(device_index))

    def current_device(self):
        if self._cuda:
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu", 0)

    def current_device_name(self) -> str:
        return self.device_name(self.current_device().index)

    def device_count(self) -> int:
        return torch.cuda.device_count() if self._cuda else 1

    def global_device_count(self) -> int:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return self.device_count()

    def is_available(self) -> bool:
        return torch.cuda.is_available() if self._cuda else True

    # -- synchronization ------------------------------------------------------
    def synchronize(self, device_index=None):
        if self._cuda:
            torch.cuda.synchronize(self._index(device_index))

    # -- dtype support --------------------------------------------------------
    def is_bf16_supported(self) -> bool:
        return torch.cuda.is_bf16_supported() if self._cuda else True

    def is_fp16_supported(self) -> bool:
        return True

    def is_triton_supported(self) -> bool:
        return self._cuda and importlib.util.find_spec("triton") is not None

    def supported_dtypes(self):
        return [torch.float32, torch.bfloat16, torch.float16, torch.int8, torch.int32]

    # -- memory ---------------------------------------------------------------
    def memory_allocated(self, device_index=None) -> int:
        return torch.cuda.memory_allocated(self._index(device_index)) if self._cuda else 0

    def max_memory_allocated(self, device_index=None) -> int:
        return torch.cuda.max_memory_allocated(self._index(device_index)) if self._cuda else 0

    def reset_peak_memory_stats(self, device_index=None):
        if self._cuda:
            torch.cuda.reset_peak_memory_stats(self._index(device_index))

    def total_memory(self, device_index=None) -> int:
        if not self._cuda:
            return 0
        return int(torch.cuda.get_device_properties(self._index(device_index)).total_memory)

    def available_memory(self, device_index=None) -> int:
        """Free device memory as CUDA reports it (``cudaMemGetInfo``)."""
        if not self._cuda:
            return 0
        return int(torch.cuda.mem_get_info(self._index(device_index))[0])

    def empty_cache(self):
        if self._cuda:
            torch.cuda.empty_cache()

    # -- streams / events -----------------------------------------------------
    @property
    def Stream(self):
        return torch.cuda.Stream if self._cuda else _HostStream

    @property
    def Event(self):
        return torch.cuda.Event if self._cuda else _HostEvent

    def stream(self, stream=None):
        if self._cuda:
            return torch.cuda.stream(stream)
        return stream if stream is not None else _HostStream()

    def current_stream(self, device_index=None):
        return torch.cuda.current_stream(self._index(device_index)) if self._cuda else _HostStream()

    def default_stream(self, device_index=None):
        return torch.cuda.default_stream(self._index(device_index)) if self._cuda else _HostStream()

    # -- graph capture --------------------------------------------------------
    def create_graph(self):
        """A holder for one ``torch.cuda.CUDAGraph``."""
        if not self._cuda:
            raise RuntimeError("create_graph: CUDA graphs need a CUDA device; this accelerator "
                               f"is on {self._device}")
        return {"graph": torch.cuda.CUDAGraph(), "args": None, "out": None}

    def capture_to_graph(self, graph, fn, *args, **kwargs):
        """Warm ``fn(*args, **kwargs)`` up once on a side stream, then capture
        it into ``graph``; returns the graph's static output (the eager
        warm-up's result is discarded).  ``args`` become the static inputs
        that ``replay_graph`` refills."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*args, **kwargs)
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph["graph"]):
            graph["out"] = fn(*args, **kwargs)
        graph["args"] = args
        return graph["out"]

    def replay_graph(self, graph, *args, **kwargs):
        """Copy ``args`` (where given) into the captured inputs, replay, and
        return the static output."""
        for static, new in zip(graph["args"] or (), args):
            if isinstance(static, torch.Tensor) and new is not static:
                static.copy_(new)
        graph["graph"].replay()
        return graph["out"]

    # -- pinned memory --------------------------------------------------------
    def pin_memory(self, array):
        """A page-locked host copy of ``array`` (a tensor or numpy array); on a
        CPU device, a contiguous host array, as JAX's stand-in gives."""
        if not self._cuda:
            if isinstance(array, torch.Tensor):
                return array.contiguous()
            return np.ascontiguousarray(array)
        tensor = array if isinstance(array, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(array))
        return tensor.pin_memory()

    def is_pinned(self, array) -> bool:
        if not self._cuda:
            if isinstance(array, torch.Tensor):
                return array.device.type == "cpu" and array.is_contiguous()
            return isinstance(array, np.ndarray) and array.flags["C_CONTIGUOUS"]
        return isinstance(array, torch.Tensor) and array.is_pinned()

    # -- profiler ranges ------------------------------------------------------
    def range_push(self, name: str):
        if self._cuda:
            torch.cuda.nvtx.range_push(name)
            return
        ctx = torch.autograd.profiler.record_function(name)
        ctx.__enter__()
        self._ranges.append(ctx)

    def range_pop(self):
        if self._cuda:
            torch.cuda.nvtx.range_pop()
        elif self._ranges:
            self._ranges.pop().__exit__(None, None, None)

    # -- device properties ----------------------------------------------------
    def get_device_properties(self, device_index=None) -> dict:
        if not self._cuda:
            return {"name": "cpu", "platform": "cpu", "total_memory": 0, "num_cores": 1}
        props = torch.cuda.get_device_properties(self._index(device_index))
        return {"name": props.name, "platform": "cuda", "total_memory": int(props.total_memory),
                "num_cores": props.multi_processor_count}

    # -- communication --------------------------------------------------------
    def communication_backend_name(self) -> str:
        return "nccl" if self._cuda else "gloo"

    # -- op builders ----------------------------------------------------------
    def op_builder_dir(self) -> str:
        return "deepspeed_tpu_torch.ops._build"

    def get_op_builder(self, class_name: str):
        """The builder class of one ``csrc/`` library, by its JAX-style class
        name (``CPUAdamBuilder``, ``FlashAttentionBuilder``) or its stem."""
        from ..ops._build import builder_class
        return builder_class(class_name)

    def create_op_builder(self, class_name: str):
        return self.get_op_builder(class_name)()

    # -- rng ------------------------------------------------------------------
    def random_seed(self, seed: int):
        """Seed the device's default generator; returns a generator on the
        device seeded with ``seed`` (the port threads explicit generators)."""
        if self._cuda:
            torch.cuda.manual_seed(seed)
        else:
            torch.manual_seed(seed)
        return torch.Generator(device=self._device).manual_seed(seed)

    def get_rng_state(self, generator=None):
        if generator is not None:
            return generator.get_state()
        return torch.cuda.get_rng_state(self._index()) if self._cuda else torch.get_rng_state()

    def set_rng_state(self, state, generator=None):
        if generator is not None:
            generator.set_state(state)
        elif self._cuda:
            torch.cuda.set_rng_state(state, self._index())
        else:
            torch.set_rng_state(state)
        return state

    def on_accelerator(self, array) -> bool:
        return isinstance(array, torch.Tensor) and array.device.type == self._device.type


_ACCELERATOR: Optional[CudaAccelerator] = None


def get_accelerator() -> CudaAccelerator:
    """The process's CUDA accelerator; raises where no GPU is present."""
    global _ACCELERATOR
    if _ACCELERATOR is None:
        if not torch.cuda.is_available():
            raise RuntimeError("get_accelerator: no CUDA device is available; build "
                               "CudaAccelerator(device='cpu') explicitly to run on the CPU")
        _ACCELERATOR = CudaAccelerator("cuda")
    return _ACCELERATOR

"""Accelerator abstraction (JAX ``deepspeed_tpu/accelerator/
abstract_accelerator.py``): the methods the runtime and the tools read, with
the same names and the same abstract set.
"""

import abc


class Accelerator(abc.ABC):
    """Minimal device abstraction consumed by the engine/runtime."""

    @abc.abstractmethod
    def device_name(self, device_index=None) -> str:
        ...

    @abc.abstractmethod
    def device_count(self) -> int:
        ...

    @abc.abstractmethod
    def current_device(self):
        ...

    @abc.abstractmethod
    def synchronize(self):
        ...

    @abc.abstractmethod
    def is_available(self) -> bool:
        ...

    @abc.abstractmethod
    def is_bf16_supported(self) -> bool:
        ...

    @abc.abstractmethod
    def is_fp16_supported(self) -> bool:
        ...

    @abc.abstractmethod
    def supported_dtypes(self):
        ...

    @abc.abstractmethod
    def memory_allocated(self, device_index=None) -> int:
        ...

    @abc.abstractmethod
    def total_memory(self, device_index=None) -> int:
        ...

    @abc.abstractmethod
    def available_memory(self, device_index=None) -> int:
        ...

    @abc.abstractmethod
    def communication_backend_name(self) -> str:
        ...

    @abc.abstractmethod
    def random_seed(self, seed: int):
        ...

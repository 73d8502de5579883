"""Hand-written Hopper kernels and their dispatch rule.

The counterpart of ``deepspeed_tpu/ops/_pallas.py::use_pallas``: one predicate
decides between a kernel and its plain PyTorch version, and it decides by
where the tensors lie.  CUDA tensors go to the kernel (or raise); CPU tensors
go to the plain version.  There is no fallback from a failed kernel to the
plain version.
"""

import torch


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device, False when every tensor is
    on the CPU; raises for mixed or other devices."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all lie on CUDA or all on the CPU, got devices "
                     f"{sorted(str(t.device) for t in tensors)}")

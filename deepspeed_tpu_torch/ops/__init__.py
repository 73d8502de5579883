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


def count_kernel(plain, args, outputs, nbytes=None):
    """Add one kernel launch to the counts that are open around it.

    While a ``torch.utils.flop_counter.FlopCounterMode`` is on the dispatch
    stack, ``plain`` (the kernel's plain version) runs once on meta tensors
    of ``args``' shapes, so the count holds exactly the products the plain
    version adds on the CPU.  A mode with an ``add_kernel_bytes`` method (the
    profiler's byte count, ``profiling/flops_profiler.py``) gets the
    kernel's own traffic: ``nbytes``, or each tensor of ``args`` read once
    and each of ``outputs`` written once.  With no mode open this is one
    look at the stack."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    modes = _get_current_dispatch_mode_stack()
    if not modes:
        return
    from torch.utils.flop_counter import FlopCounterMode
    # the counter itself, or (newer torch) the dispatch mode it pushes
    if any(isinstance(m, FlopCounterMode) or isinstance(getattr(m, "counter", None),
                                                        FlopCounterMode) for m in modes):
        meta = [torch.empty_like(a, device="meta") if isinstance(a, torch.Tensor) else a
                for a in args]
        with torch.no_grad():
            plain(*meta)
    if nbytes is None:
        nbytes = sum(t.numel() * t.element_size() for t in (*args, *outputs)
                     if isinstance(t, torch.Tensor))
    for m in modes:
        if hasattr(m, "add_kernel_bytes"):
            m.add_kernel_bytes(nbytes)

"""Device-memory introspection.

Counterpart of ``deepspeed_tpu/utils/memory.py`` (the reference's
``see_memory_usage``, deepspeed/runtime/utils.py:835).  The three keys of a
telemetry record's ``hbm`` field keep the JAX package's names and are read
from the CUDA caching allocator: ``bytes_in_use`` and ``peak_bytes_in_use``
from ``torch.cuda.memory_stats()`` (``allocated_bytes.all.current`` and
``.peak``), ``bytes_limit`` from ``torch.cuda.mem_get_info()``'s total.  On
the CPU every value is None, as on the JAX CPU backend, so callers never
branch.
"""

import logging
from typing import Any, Dict, Optional

import torch

logger = logging.getLogger(__name__)

# keys surfaced in telemetry records and see_memory_usage lines
HBM_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


def device_memory_stats(device_index: int = 0) -> Dict[str, Optional[int]]:
    """Device memory counters for one local CUDA device, every key present
    and None where there is no CUDA device."""
    if not torch.cuda.is_available():
        return dict.fromkeys(HBM_KEYS)
    raw = torch.cuda.memory_stats(device_index)
    return {"bytes_in_use": int(raw.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(raw.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.mem_get_info(device_index)[1])}


def _gb(n: Optional[int]) -> str:
    return "n/a" if n is None else f"{n / 2**30:.2f}GB"


def see_memory_usage(message: str, force: bool = True, device_index: int = 0) -> Dict[str, Any]:
    """Log a one-line memory snapshot tagged ``message`` and return it as a
    dict ``{bytes_in_use, peak_bytes_in_use, bytes_limit, reserved_bytes}``;
    ``reserved_bytes`` (the caching allocator's segments, the reference's
    "CA") stands where the JAX package reports its live-array census."""
    snap: Dict[str, Any] = dict(device_memory_stats(device_index))
    snap["reserved_bytes"] = (int(torch.cuda.memory_reserved(device_index))
                              if torch.cuda.is_available() else None)
    if force:
        logger.info(f"{message} | device memory in_use={_gb(snap['bytes_in_use'])} "
                    f"peak={_gb(snap['peak_bytes_in_use'])} limit={_gb(snap['bytes_limit'])} "
                    f"reserved={_gb(snap['reserved_bytes'])}")
    return snap

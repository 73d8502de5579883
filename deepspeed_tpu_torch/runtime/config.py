"""Config sections shared by training and serving.

Counterpart of ``deepspeed_tpu/runtime/config.py``; the port so far carries
the ``serving_resilience`` section only.
"""

from typing import Optional

from .config_utils import ConfigModel, Field


class ServingResilienceConfig(ConfigModel):
    """Serving-side overload policy for the v2 ragged engine
    (inference/v2/admission.py).

    Admission: requests enter a bounded, priority-aware queue and are load-shed
    with a structured retryable/fatal reason BEFORE any KV allocation when
    ``max_queue_depth`` or ``shed_kv_utilization`` is crossed
    (``shed_kv_utilization=1.0`` disables pressure shedding: requests queue
    until the pool frees instead).  ``default_ttl_s`` gives every request a
    deadline (per-call ``generate(ttl_s=...)`` overrides); expired requests are
    evicted between steps — never mid-forward — with their blocks reclaimed.

    Scheduling: ``preemption`` lets a starved decode step reclaim KV blocks
    from the newest prefilling sequence (rolled back to a block boundary and
    requeued, at most ``max_preemptions`` times; once every candidate victim
    is exhausted the newest is evicted with status
    ``preempt_requeued_exhausted``).  ``stall_watchdog_steps`` bounds
    live-but-unschedulable loops: after that many steps without progress the
    engine raises ``ServingStalledError`` carrying a full state snapshot
    (strict mode) or fails the stuck requests and keeps serving the rest.
    """
    max_queue_depth: int = Field(0, ge=0)  # 0 => unbounded admission queue
    shed_kv_utilization: float = Field(1.0, gt=0.0, le=1.0)
    default_ttl_s: Optional[float] = Field(None, gt=0.0)
    max_live_seqs: int = Field(0, ge=0)  # 0 => bounded only by the scheduler
    preemption: bool = True
    max_preemptions: int = Field(2, ge=0)
    stall_watchdog_steps: int = Field(100, ge=1)

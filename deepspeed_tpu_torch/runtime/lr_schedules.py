"""Learning-rate schedules.

Counterpart of ``deepspeed_tpu/runtime/lr_schedules.py`` (the reference's
LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR, WarmupCosineLR): each
schedule is a pure ``step -> lr`` function, wrapped by :class:`LRScheduler` for
the reference's ``get_lr()/step()`` surface.  The JAX schedules compute in
float32 (``jnp.asarray(step, float32)``, Python constants taken as float32);
these do the same with numpy float32 scalars, so the lr the optimizer sees is
the same float32 number.
"""

import math
from typing import Any, Callable, Dict, Optional

import numpy as np

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"

VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR, WARMUP_COSINE_LR]

f32 = np.float32


def _clip01(x):
    return np.clip(x, f32(0.0), f32(1.0))


def lr_range_test(lr_range_test_min_lr: float = 1e-3, lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False) -> Callable:
    """lr = min_lr * (1 + rate * interval)."""

    def schedule(step):
        step = f32(step)
        interval = step / f32(lr_range_test_step_size)
        if lr_range_test_staircase:
            interval = np.floor(interval)
        return f32(lr_range_test_min_lr) * (f32(1.0) + interval * f32(lr_range_test_step_rate))

    return schedule


def one_cycle(cycle_min_lr: float, cycle_max_lr: float, decay_lr_rate: float = 0.0,
              cycle_first_step_size: int = 2000, cycle_second_step_size: Optional[int] = None,
              cycle_first_stair_count: int = 0, cycle_second_stair_count: Optional[int] = None,
              decay_step_size: int = 0, **_ignored) -> Callable:
    """Ramp min -> max over the first phase, max -> min over the second, then
    decay by ``decay_lr_rate`` per ``decay_step_size``."""
    second = cycle_second_step_size if cycle_second_step_size is not None \
        else cycle_first_step_size
    total_cycle = cycle_first_step_size + second
    lo, span = f32(cycle_min_lr), f32(cycle_max_lr - cycle_min_lr)

    def schedule(step):
        step = f32(step)
        if step < total_cycle:
            if step < cycle_first_step_size:
                return lo + span * _clip01(step / f32(cycle_first_step_size))
            frac = _clip01((step - f32(cycle_first_step_size)) / f32(max(second, 1)))
            return f32(cycle_max_lr) - span * frac
        if decay_lr_rate > 0.0 and decay_step_size > 0:
            post = np.maximum(step - f32(total_cycle), f32(0.0))
            decay = f32(1.0) / (f32(1.0) + f32(decay_lr_rate)
                                * np.floor(post / f32(decay_step_size)))
            return lo * decay
        return lo

    return schedule


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log",
              **_ignored) -> Callable:
    """Log (default) or linear warmup to the max, then hold."""

    def schedule(step):
        step = f32(step)
        if step >= warmup_num_steps:
            return f32(warmup_max_lr)
        frac = _clip01((step + f32(1.0)) / f32(warmup_num_steps))
        gamma = np.log(frac * f32(math.e - 1.0) + f32(1.0)) if warmup_type == "log" else frac
        return f32(warmup_min_lr) + f32(warmup_max_lr - warmup_min_lr) * gamma

    return schedule


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_ignored) -> Callable:
    """Warmup, then linear decay to 0 at ``total_num_steps``."""
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def schedule(step):
        step = f32(step)
        if step < warmup_num_steps:
            return base(step)
        frac = _clip01((f32(total_num_steps) - step)
                       / np.maximum(f32(total_num_steps - warmup_num_steps), f32(1.0)))
        return f32(warmup_max_lr) * frac

    return schedule


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.01,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0001,
                     lr: float = 1.0, **_ignored) -> Callable:
    """Linear warmup from ``warmup_min_ratio`` to 1, then cosine decay to
    ``cos_min_ratio`` (ratios of the base lr)."""

    def schedule(step):
        step = f32(step)
        if step < warmup_num_steps:
            ratio = f32(warmup_min_ratio) + f32(1.0 - warmup_min_ratio) * _clip01(
                step / f32(max(warmup_num_steps, 1)))
        else:
            progress = _clip01((step - f32(warmup_num_steps))
                               / np.maximum(f32(total_num_steps - warmup_num_steps), f32(1.0)))
            ratio = f32(cos_min_ratio) + f32(1.0 - cos_min_ratio) * f32(0.5) * (
                f32(1.0) + np.cos(f32(np.pi) * progress))
        return f32(lr) * ratio

    return schedule


_SCHEDULE_BUILDERS = {
    LR_RANGE_TEST: lr_range_test,
    ONE_CYCLE: one_cycle,
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
    WARMUP_COSINE_LR: warmup_cosine_lr,
}


class LRScheduler:
    """Imperative wrapper with the torch-style surface the reference exposes
    (``step()``, ``get_lr()``, ``state_dict()``/``load_state_dict()``)."""

    def __init__(self, schedule_fn: Callable, last_step: int = 0):
        self.schedule_fn = schedule_fn
        self.last_step = last_step

    def step(self, increment: int = 1):
        self.last_step += increment

    def get_lr(self):
        return [float(self.schedule_fn(self.last_step))]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"last_step": self.last_step}

    def load_state_dict(self, sd):
        self.last_step = sd["last_step"]


def build_lr_schedule(sched_type: Optional[str], params: Dict[str, Any],
                      base_lr: float = 1e-3) -> Callable:
    """A pure step -> float32 lr function from a scheduler config section; a
    constant ``base_lr`` when no scheduler is configured."""
    if sched_type is None:
        return lambda step: f32(base_lr)
    if sched_type not in _SCHEDULE_BUILDERS:
        raise ValueError(f"unknown scheduler type {sched_type!r}; valid: {VALID_LR_SCHEDULES}")
    if sched_type == WARMUP_COSINE_LR:
        params = dict(params)
        params.setdefault("lr", base_lr)
    return _SCHEDULE_BUILDERS[sched_type](**params)

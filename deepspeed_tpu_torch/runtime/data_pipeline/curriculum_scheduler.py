"""Curriculum learning scheduler (a copy of
``deepspeed_tpu/runtime/data_pipeline/curriculum_scheduler.py``: host Python
only, so the port keeps its own copy).

Analog of the reference CurriculumScheduler
(runtime/data_pipeline/data_sampling/curriculum_scheduler.py:11): maps the
global step to a difficulty value (e.g. sequence length) under
fixed_linear / fixed_root / fixed_discrete / custom schedules, with the same
config keys (schedule_type, min/max difficulty, total_curriculum_step,
difficulty_step rounding, root_degree).
"""

import math
from typing import Callable, Dict, Optional


FIXED_LINEAR = "fixed_linear"
FIXED_ROOT = "fixed_root"
FIXED_DISCRETE = "fixed_discrete"
CUSTOM = "custom"


class CurriculumScheduler:

    def __init__(self, config: Dict):
        self.state: Dict = {}
        assert "curriculum_type" in config or "schedule_type" in config, \
            "curriculum config needs schedule_type"
        self.schedule_type = config.get("schedule_type", config.get("curriculum_type"))
        self.min_difficulty = config.get("min_difficulty", 1)
        self.max_difficulty = config.get("max_difficulty", 1)
        cfg = config.get("schedule_config", config)
        self.total_step = cfg.get("total_curriculum_step", 1)
        self.difficulty_step = cfg.get("difficulty_step", 1)
        self.root_degree = cfg.get("root_degree", 2)
        self.difficulties = cfg.get("difficulty", [])
        self.max_steps = cfg.get("max_step", [])
        self._custom: Optional[Callable[[int], int]] = None
        self.current_difficulty = self.min_difficulty

    def set_custom_get_difficulty(self, fn: Callable[[int], int]):
        self._custom = fn

    def get_difficulty(self, global_step: int) -> int:
        if self.schedule_type == CUSTOM:
            assert self._custom is not None, "set_custom_get_difficulty first"
            return self._custom(global_step)
        if self.schedule_type == FIXED_DISCRETE:
            for difficulty, until in zip(self.difficulties, self.max_steps):
                if global_step <= until:
                    return difficulty
            return self.difficulties[-1]
        if self.schedule_type == FIXED_LINEAR:
            frac = min(1.0, global_step / max(self.total_step, 1))
        elif self.schedule_type == FIXED_ROOT:
            frac = min(1.0, (global_step / max(self.total_step, 1))**(1.0 / self.root_degree))
        else:
            raise ValueError(f"unknown curriculum schedule '{self.schedule_type}'")
        diff = self.min_difficulty + frac * (self.max_difficulty - self.min_difficulty)
        diff = int(diff // self.difficulty_step * self.difficulty_step)
        return max(self.min_difficulty, min(self.max_difficulty, diff))

    def update_difficulty(self, global_step: int) -> int:
        self.current_difficulty = self.get_difficulty(global_step)
        return self.current_difficulty

    def state_dict(self) -> Dict:
        return {"current_difficulty": self.current_difficulty}

    def load_state_dict(self, sd: Dict):
        self.current_difficulty = sd.get("current_difficulty", self.min_difficulty)

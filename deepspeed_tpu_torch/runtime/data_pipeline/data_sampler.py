"""Curriculum-aware distributed data sampler (a copy of
``deepspeed_tpu/runtime/data_pipeline/data_sampler.py``; numpy only, the same
index order for the same seed).

Analog of DeepSpeedDataSampler (runtime/data_pipeline/data_sampling/
data_sampler.py:36): deterministic shuffled index stream, partitioned per dp
rank, with curriculum truncation (sequence-length difficulty) and exact resume
from a consumed-samples counter.
"""

from typing import Dict, Iterator, List, Optional

import numpy as np

from .curriculum_scheduler import CurriculumScheduler


class DeepSpeedDataSampler:

    def __init__(self, total_samples: int, micro_batch_size: int, data_parallel_rank: int = 0,
                 data_parallel_size: int = 1, gradient_accumulation_steps: int = 1,
                 curriculum: Optional[Dict] = None, seed: int = 0, drop_last: bool = True):
        self.total_samples = total_samples
        self.micro_batch_size = micro_batch_size
        self.dp_rank = data_parallel_rank
        self.dp_size = data_parallel_size
        self.gas = gradient_accumulation_steps
        self.seed = seed
        self.drop_last = drop_last
        self.consumed_samples = 0
        self.global_batch_size = micro_batch_size * data_parallel_size * gradient_accumulation_steps
        self.curriculum = CurriculumScheduler(curriculum) if curriculum else None

    @property
    def global_step(self) -> int:
        return self.consumed_samples // self.global_batch_size

    def get_seqlen(self) -> Optional[int]:
        """Current curriculum difficulty (sequence length) for batch truncation."""
        if self.curriculum is None:
            return None
        return self.curriculum.update_difficulty(self.global_step + 1)

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        return rng.permutation(self.total_samples)

    def __iter__(self) -> Iterator[List[int]]:
        while True:
            epoch = self.consumed_samples // self.total_samples
            offset = self.consumed_samples % self.total_samples
            perm = self._epoch_perm(epoch)
            remaining = self.total_samples - offset
            if remaining < self.global_batch_size and self.drop_last:
                self.consumed_samples += remaining  # skip tail, next epoch
                continue
            batch = perm[offset:offset + self.global_batch_size]
            self.consumed_samples += len(batch)
            # rank slice: contiguous per-rank chunk of each micro batch
            my = []
            for g in range(self.gas):
                micro = batch[g * self.micro_batch_size * self.dp_size:(g + 1) * self.micro_batch_size * self.dp_size]
                my.extend(micro[self.dp_rank * self.micro_batch_size:(self.dp_rank + 1) * self.micro_batch_size])
            yield [int(i) for i in my]

    def state_dict(self) -> Dict:
        return {
            "consumed_samples": self.consumed_samples,
            "seed": self.seed,
            "curriculum": self.curriculum.state_dict() if self.curriculum else None,
        }

    def load_state_dict(self, sd: Dict):
        self.consumed_samples = sd["consumed_samples"]
        self.seed = sd.get("seed", self.seed)
        if self.curriculum and sd.get("curriculum"):
            self.curriculum.load_state_dict(sd["curriculum"])

"""The ``autotuning`` section (JAX ``deepspeed_tpu/autotuning/config.py``):
the same fields, defaults and checks.  The training config keeps the
section as a dict, which the autotuner parses."""

from typing import List, Optional

from ..runtime.config_utils import ConfigModel, Field


class AutotuningConfig(ConfigModel):
    """``autotuning`` section of the training config."""
    allow_extra = True

    enabled: bool = False
    fast: bool = True  # micro-batch sweep only; False adds remat/ZeRO++ knobs
    metric: str = Field("throughput", choices=("latency", "throughput", "flops"))
    start_profile_step: int = Field(3, ge=0)   # warmup steps (compile + cache)
    end_profile_step: int = Field(5, ge=1)     # measured window = end - start
    tuner_type: str = Field("model_based", choices=("gridsearch", "random", "model_based"))
    tuner_early_stopping: int = Field(5, ge=1)  # stop after N non-improving trials
    tuner_num_trials: int = Field(50, ge=1)
    max_train_batch_size: Optional[int] = None  # global cap: mbs * gas * dp
    min_train_batch_size: int = Field(1, ge=1)  # global floor on the sweep
    micro_batch_sizes: Optional[List[int]] = None  # user override of the mbs sweep
    zero_stages: Optional[List[int]] = None        # None -> try all feasible
    exps_dir: str = "autotuning_exps"      # experiment records (jsonl)
    results_dir: str = "autotuning_results"  # winning config
    overwrite: bool = False                # clear previous records first
    # device memory override in bytes; None -> accelerator total_memory()
    device_memory: Optional[int] = None

    def model_validate(self):
        if self.end_profile_step <= self.start_profile_step:
            raise ValueError("autotuning: end_profile_step must exceed start_profile_step")

"""The autotuner (JAX ``deepspeed_tpu/autotuning/autotuner.py``): prune the
ZeRO stages whose model state cannot fit, sweep each stage's micro-batch
sizes (and, outside ``fast`` mode, its knobs), measure each candidate with
a short run, and write the best config.

Same search as JAX's: the same memory arithmetic, candidates, experiments,
tuners and files.  Differences, each for the port's engine:

* ``model_state_memory`` counts the port's layout: bf16 compute params (2
  B a param, made for each step), fp32 grads (4 B: the engine accumulates
  the micro-batches' grads in fp32) and fp32 master, m and v (12 B); JAX's
  engine keeps its grads in bf16 (2 B);
* each experiment trains a fresh copy of the parameters (the engine updates
  its tensors in place, JAX's params are immutable), and each engine is
  freed (collected, the CUDA cache emptied) before the next, so a leftover
  engine cannot make a later micro-batch run out of memory;
* the runner prunes a point on ``torch.cuda.OutOfMemoryError`` and on the
  ``ValueError`` that ``load_config`` raises for an invalid combination;
  anything else (a kernel that fails to build or launch) propagates, where
  JAX's runner prunes on any exception.
"""

import itertools
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ..utils.logging import logger
from .config import AutotuningConfig
from .tuner import BaseTuner, GridSearchTuner, ModelBasedTuner, RandomTuner

BYTES_PER_PARAM_BF16 = 2
BYTES_PER_PARAM_GRAD = 4          # fp32: the engine accumulates the grads in fp32
BYTES_PER_PARAM_OPT = 12          # fp32 master + m + v


@dataclass
class ModelInfo:
    """What the tuner needs to know about the model."""
    num_params: int
    activation_mem_per_mbs: int  # bytes of activations at micro-batch 1


def model_state_memory(num_params: int, stage: int, dp_size: int) -> int:
    """Per-GPU model-state bytes under a given ZeRO stage."""
    p, g, o = (num_params * BYTES_PER_PARAM_BF16, num_params * BYTES_PER_PARAM_GRAD,
               num_params * BYTES_PER_PARAM_OPT)
    d = max(1, dp_size)
    if stage == 0:
        return p + g + o
    if stage == 1:
        return p + g + o // d
    if stage == 2:
        return p + (g + o) // d
    return (p + g + o) // d


# Per-stage extra knobs, JAX's: the remat policy (LlamaConfig.remat_policy
# takes the same names) and, at stage 3, ZeRO++'s quantized weights.
REMAT_POLICIES = ["dots_with_no_batch_dims_saveable", "nothing_saveable"]


def stage_tuning_space(stage: int, fast: bool = True) -> Dict[str, List[Any]]:
    """Fast mode sweeps the micro-batch only; full mode adds the remat
    policy and the stage-3 ZeRO++ lever."""
    if fast:
        return {}
    space: Dict[str, List[Any]] = {"activation_checkpointing.policy": REMAT_POLICIES}
    if stage == 3:
        space["zero_optimization.zero_quantized_weights"] = [False, True]
    return space


def _set_path(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    node = cfg
    keys = dotted.split(".")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


class Autotuner:
    """Searches (stage, micro-batch, knobs) and emits the best config.

    ``runner(exp_config) -> metrics`` executes one short experiment and
    returns ``{"throughput": samples/s, "latency": s, "flops": flops/s}`` or
    None on failure/OOM.  Tests stub it; production uses
    ``make_engine_runner`` below.
    """

    def __init__(self, model_info: ModelInfo, runner: Callable[[Dict[str, Any]], Optional[Dict[str, float]]],
                 user_config: Optional[Dict[str, Any]] = None, dp_size: int = 1,
                 device_memory: Optional[int] = None,
                 config: Optional[AutotuningConfig] = None):
        self.model_info = model_info
        self.runner = runner
        self.user_config = dict(user_config or {})
        self.dp_size = dp_size
        self.config = config or AutotuningConfig(
            **(self.user_config.get("autotuning") or {}))
        self.device_memory = (device_memory if device_memory is not None
                              else self.config.device_memory)
        if self.device_memory is None:
            from ..accelerator import get_accelerator
            self.device_memory = get_accelerator().total_memory()  # raises without a GPU
        self.records: List[Dict[str, Any]] = []
        self.best_exp: Optional[Dict[str, Any]] = None
        self.best_metric: float = -float("inf")

    # ----------------------------------------------------------- search space
    def feasible_stages(self) -> List[int]:
        stages = self.config.zero_stages or [0, 1, 2, 3]
        act = self.model_info.activation_mem_per_mbs
        out = []
        for s in stages:
            need = model_state_memory(self.model_info.num_params, s, self.dp_size) + act
            if need <= self.device_memory:
                out.append(s)
            else:
                logger.info(f"autotuning: ZeRO-{s} infeasible "
                            f"(needs {need >> 20} MiB > {self.device_memory >> 20} MiB)")
        return out

    def max_micro_batch(self, stage: int) -> int:
        free = self.device_memory - model_state_memory(
            self.model_info.num_params, stage, self.dp_size)
        return max(0, free // max(1, self.model_info.activation_mem_per_mbs))

    def _user_gas(self) -> int:
        return int(self.user_config.get("gradient_accumulation_steps") or 1)

    def micro_batch_candidates(self, stage: int) -> List[int]:
        """Memory cap ∩ the user's global batch window: train_batch = mbs * gas
        * dp must land in [min_train_batch_size, max_train_batch_size]."""
        cap = self.max_micro_batch(stage)
        scale = self._user_gas() * max(1, self.dp_size)
        if self.config.max_train_batch_size:
            cap = min(cap, self.config.max_train_batch_size // scale)
        floor = -(-self.config.min_train_batch_size // scale)  # ceil div
        if self.config.micro_batch_sizes:
            return [m for m in self.config.micro_batch_sizes if floor <= m <= cap]
        out, m = [], 1
        while m <= cap:
            if m >= floor:
                out.append(m)
            m *= 2
        return out

    def experiments_for_stage(self, stage: int) -> List[Dict[str, Any]]:
        mbs_list = self.micro_batch_candidates(stage)
        if not mbs_list:
            return []
        space = stage_tuning_space(stage, fast=self.config.fast)
        keys = sorted(space)
        exps = []
        for mbs in mbs_list:
            for combo in itertools.product(*(space[k] for k in keys)):
                exp = json.loads(json.dumps(self.user_config))  # deep copy
                exp.pop("autotuning", None)
                _set_path(exp, "zero_optimization.stage", stage)
                exp["train_micro_batch_size_per_gpu"] = mbs
                # retune the batch triple: keep user gas, drop fixed total
                exp.pop("train_batch_size", None)
                for k, v in zip(keys, combo):
                    _set_path(exp, k, v)
                exps.append(exp)
        return exps

    # ------------------------------------------------------------------ tuning
    def _metric_of(self, metrics: Optional[Dict[str, float]]) -> Optional[float]:
        if metrics is None:
            return None
        name = self.config.metric
        val = metrics.get(name)
        if val is None:
            return None
        return -val if name == "latency" else val

    def _make_tuner(self, exps, run_fn) -> BaseTuner:
        cls = {"gridsearch": GridSearchTuner, "random": RandomTuner,
               "model_based": ModelBasedTuner}[self.config.tuner_type]
        return cls(exps, run_fn, early_stopping=self.config.tuner_early_stopping)

    def tune(self) -> Optional[Dict[str, Any]]:
        """Returns the best experiment config (or None if nothing ran)."""
        t0 = time.time()
        for stage in self.feasible_stages():
            exps = self.experiments_for_stage(stage)
            if not exps:
                continue
            logger.info(f"autotuning: ZeRO-{stage} space has {len(exps)} experiments")

            def run_fn(exp):
                metrics = self.runner(exp)
                rec = {"config": exp, "metrics": metrics, "stage": stage}
                self.records.append(rec)
                return self._metric_of(metrics)

            tuner = self._make_tuner(exps, run_fn)
            best_exp, best_metric = tuner.tune(num_trials=self.config.tuner_num_trials)
            if best_exp is not None and best_metric > self.best_metric:
                self.best_metric = best_metric
                self.best_exp = best_exp
        best_display = None
        if self.best_exp is not None:
            # latency is negated internally for max-comparison; report raw
            best_display = -self.best_metric if self.config.metric == "latency" else self.best_metric
        logger.info(f"autotuning: {len(self.records)} experiments in "
                    f"{time.time() - t0:.1f}s; best {self.config.metric} = {best_display}")
        return self.best_exp

    # ----------------------------------------------------------------- output
    def write_results(self) -> Optional[str]:
        """Write experiment records to exps_dir and the winning config to
        results_dir (``dstpu_config_optimal.json``); ``overwrite`` clears
        previous runs' records first."""
        import shutil
        for d in (self.config.exps_dir, self.config.results_dir):
            if self.config.overwrite and os.path.isdir(d):
                shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d, exist_ok=True)
        with open(os.path.join(self.config.exps_dir, "experiments.jsonl"), "w") as fh:
            for rec in self.records:
                fh.write(json.dumps(rec) + "\n")
        if self.best_exp is None:
            return None
        path = os.path.join(self.config.results_dir, "dstpu_config_optimal.json")
        with open(path, "w") as fh:
            json.dump(self.best_exp, fh, indent=2)
        return path


def _fresh_copy(params):
    from ..runtime.tree import tree_map
    return tree_map(lambda p: p.detach().clone(), params)


def _free_device_memory():
    import gc

    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def make_engine_runner(loss_fn, params, example_batch_fn=None, warmup_steps: int = 2,
                       measure_steps: int = 3,
                       autotuning_config: Optional[AutotuningConfig] = None, device="cuda"):
    """The default measured runner: an engine for each candidate config on a
    fresh copy of ``params``, a few steps, steady-state throughput
    (samples/s), latency (s a step) and FLOPs/s.

    ``example_batch_fn(train_batch_size) -> batch`` supplies data.  With an
    ``autotuning_config``, its start/end_profile_step set the warm-up and
    the measured window.  The FLOPs are ``FlopsProfiler.profile_train_step``'s
    count of one step (the hand kernels' plain FLOPs included).  The peak
    memory statistics are reset as each experiment starts; each engine is
    freed when its experiment ends, whatever the outcome.
    """
    if autotuning_config is not None:
        warmup_steps = autotuning_config.start_profile_step
        measure_steps = autotuning_config.end_profile_step - autotuning_config.start_profile_step

    def runner(exp_config):
        import torch

        from ..profiling.flops_profiler import FlopsProfiler
        from ..runtime.config import load_config
        from ..runtime.engine import initialize
        try:
            cfg = load_config(exp_config)
        except ValueError as e:  # an invalid combination -> prune this point
            logger.warning(f"autotuning experiment failed: {type(e).__name__}: {e}")
            return None
        on_card = torch.device(device).type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        engine = None
        try:
            engine = initialize(loss_fn=loss_fn, model_parameters=_fresh_copy(params),
                                config=cfg, device=device)[0]
            batch = example_batch_fn(engine.train_batch_size)
            for _ in range(max(1, warmup_steps)):
                metrics = engine.train_batch(batch)
            float(metrics.loss)  # waits for the warm-up before the clock starts
            t0 = time.perf_counter()
            for _ in range(max(1, measure_steps)):
                metrics = engine.train_batch(batch)
            float(metrics.loss)  # the last step's loss: every queued step has run
            dt = (time.perf_counter() - t0) / max(1, measure_steps)
            step_flops = FlopsProfiler(engine).profile_train_step(batch).flops
            samples = engine.train_batch_size
            return {"throughput": samples / dt, "latency": dt, "flops": step_flops / dt}
        except torch.cuda.OutOfMemoryError as e:  # this micro-batch does not fit: prune it
            logger.warning(f"autotuning experiment failed: {type(e).__name__}: "
                           f"{str(e).splitlines()[0]}")
            return None
        finally:
            engine = batch = metrics = None
            _free_device_memory()

    return runner

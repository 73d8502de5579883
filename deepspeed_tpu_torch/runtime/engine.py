"""The training engine, single GPU.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` for one device: an fp32
master copy of the params, a compute-dtype copy made at every step,
micro-batch gradient accumulation in fp32, global-norm clipping, the lr
schedule and the optimizer step.  The step follows ``engine.py:586-655``:

1. grads of each micro-batch, summed in fp32, then divided by gas * scale;
2. the global grad norm;
3. clipping to ``gradient_clipping``;
4. ``lr = schedule(step)`` with the step count before this step;
5. the fused optimizer step (``optimizer.step_fn``, the fused AdamW kernel on
   CUDA) when the optimizer has one, else the delta form ``update``.

On one device the JAX engine takes the fused step too (``engine.py:544``),
and ZeRO partitions nothing, so every ZeRO stage runs this same step.  The
engine runs on ``device="cuda"`` unless the caller passes ``device="cpu"``
(then every kernel's plain version runs); it raises when asked for CUDA
without a GPU.  ``initialize`` makes the config's ``sparse_attention``
section the loss function's default attention.

Observability, as in the JAX engine: the monitor writers (``MonitorMaster``)
and a ``TelemetryCollector`` (``telemetry`` section: per-step records with
loss, step time, tokens/s, ``mfu`` and device memory, and a
``torch.profiler`` step window); ``wall_clock_breakdown`` or telemetry add
ONE ``float(loss)`` sync a step.  The step's FLOPs for ``mfu`` are counted
once, on the first step under ``torch.utils.flop_counter.FlopCounterMode``:
every aten product, the remat recompute included, and nothing inside the
hand kernels (called through ``ctypes``, as XLA's cost analysis does not see
inside a Pallas call).  ``ops_server`` publishes ``/metrics``, ``/healthz``
and ``/statez`` refreshed at the step boundary.  Not ported yet: fp16 loss
scaling, offload, checkpoints and the watchdog (ROADMAP Queue 1).
"""

import contextlib
import json
import logging
import os
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..models import transformer
from ..monitor.metrics import populate_from_telemetry
from ..monitor.monitor import MonitorMaster
from ..monitor.ops_server import OpsPublisher
from ..monitor.telemetry import TelemetryCollector
from ..utils.memory import see_memory_usage
from . import lr_schedules, optimizers
from .config import OpsServerConfig, TrainingConfig, load_config
from .grad_accum import accumulate_micro_grads
from .heartbeat import OPS_DIR_ENV
from .tree import tree_leaves, tree_map

logger = logging.getLogger(__name__)


class TrainState(NamedTuple):
    """Everything a step reads and writes."""
    step: int  # optimizer steps taken
    params: Any  # fp32 master params, on the engine's device
    opt_state: Any


class StepMetrics(NamedTuple):
    loss: torch.Tensor  # mean micro-batch loss, fp32 0-d, on the device
    grad_norm: torch.Tensor  # before clipping
    lr: float
    skipped: bool  # always False: there is no fp16 overflow skip without loss scaling
    loss_scale: float


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; CUDA without a GPU raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch sees no CUDA device; pass device='cpu' to "
                           "run the plain versions of the kernels on the CPU")
    return device


class Engine:
    """Wraps ``loss_fn(params, batch, rng) -> loss`` and a params tree with the
    training mechanics.  ``loss_fn`` receives the params in the compute dtype."""

    def __init__(self, loss_fn: Callable, params: Any, config: TrainingConfig,
                 device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.loss_fn = loss_fn
        (self.train_batch_size, self.micro_batch_size,
         self.gradient_accumulation_steps) = config.resolve_batch_sizes(1)
        self.zero_stage = config.zero_optimization.stage

        opt_cfg = config.optimizer
        opt_params = dict(opt_cfg.params) if opt_cfg else {}
        self.base_lr = float(opt_params.pop("lr", 1e-3))
        self.optimizer = optimizers.get_optimizer(opt_cfg.type if opt_cfg else "adamw",
                                                  **opt_params)
        sched_cfg = config.scheduler
        self.lr_schedule = lr_schedules.build_lr_schedule(
            sched_cfg.type if sched_cfg else None, dict(sched_cfg.params) if sched_cfg else {},
            base_lr=self.base_lr)
        self.lr_scheduler = lr_schedules.LRScheduler(self.lr_schedule)
        self.compute_dtype = config.precision_dtype
        self.global_steps = 0
        self.global_samples = 0
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self._last_grad_norm: Optional[torch.Tensor] = None
        # monitor writers and the per-step telemetry collector (the engine
        # trains on one device)
        self.monitor = MonitorMaster(config)
        self.telemetry = TelemetryCollector(config.telemetry, monitor=self.monitor,
                                            batch_size=self.train_batch_size, n_chips=1)
        self._last_telemetry_record: Optional[Dict[str, Any]] = None
        self._breakdown_acc = [0.0, 0.0, 0]
        # pull-based ops plane: rank 0 serves /metrics + /healthz + /statez
        # over the telemetry caches; every rank publishes per-rank files when
        # DSTPU_OPS_DIR (or ops_server.textfile_dir) is set.  The cache
        # refreshes at the step boundary, from host values only.
        self._ops = None
        self._ops_rank = int(os.environ.get("RANK", "0") or 0)
        ops_cfg = config.ops_server
        ops_dir = os.environ.get(OPS_DIR_ENV) or ops_cfg.textfile_dir
        if ops_cfg.enabled or ops_dir:
            if ops_cfg.enabled and not self.telemetry._is_rank0:
                # one endpoint per job: ranks > 0 publish exchange files only
                ops_cfg = OpsServerConfig(enabled=False, host=ops_cfg.host,
                                          refresh_interval_s=ops_cfg.refresh_interval_s,
                                          textfile_dir=ops_cfg.textfile_dir,
                                          namespace=ops_cfg.namespace)
            self._ops = OpsPublisher(ops_cfg, ops_dir=ops_dir, rank=self._ops_rank,
                                     owner="training engine")
        self.ops = self._ops.server if self._ops is not None else None

        master = tree_map(lambda p: _as_tensor(p).detach().to(
            device=self.device, dtype=torch.float32).clone(), params)
        self.state = TrainState(step=0, params=master, opt_state=self.optimizer.init(master))
        n_params = sum(p.numel() for p in tree_leaves(master))
        logger.info(f"Engine: device={self.device} zero_stage={self.zero_stage} "
                    f"batch={self.train_batch_size} (micro={self.micro_batch_size} x gas="
                    f"{self.gradient_accumulation_steps}) dtype={self.compute_dtype} "
                    f"optimizer={self.optimizer.name} params={n_params / 1e6:.2f}M")

    # ------------------------------------------------------------- batches
    def _gas_layout(self, batch):
        """Leaves [train_batch_size, ...] or [gas, micro, ...] -> tensors
        [gas, micro, ...] on the device."""
        gas = self.gradient_accumulation_steps

        def fix(x):
            x = _as_tensor(x)
            if x.shape[0] == self.train_batch_size:
                x = x.reshape(gas, self.train_batch_size // gas, *x.shape[1:])
            elif not (x.dim() >= 2 and x.shape[0] == gas):
                raise ValueError(f"batch leading dim {x.shape[0]} matches neither "
                                 f"train_batch_size={self.train_batch_size} nor gas={gas}")
            return x.to(self.device)

        return tree_map(fix, batch)

    def _compute_params(self):
        """The compute-dtype copy of the master params, as autograd leaves."""
        return tree_map(lambda p: p.detach().to(self.compute_dtype).requires_grad_(True),
                        self.state.params)

    # ---------------------------------------------------------------- step
    def accumulate_gradients(self, batch):
        """(fp32 grads averaged over the micro-batches, mean loss) for
        ``batch`` at the current params, without stepping: step 1 of the
        train step."""
        return self._accumulate(self._gas_layout(batch))

    def _accumulate(self, batch):
        gas = self.gradient_accumulation_steps
        scale = 1.0  # no loss scaling in bf16/fp32
        grads, loss_sum = accumulate_micro_grads(self.loss_fn, self._compute_params(), batch,
                                                 [self.generator] * gas, scale)
        for g in tree_leaves(grads):
            g.div_(gas * scale)
        return grads, loss_sum / gas

    def train_batch(self, batch) -> StepMetrics:
        """One optimizer step on a global batch: leaves [train_batch_size, ...]
        or [gas, micro, ...]."""
        telemetry = self.telemetry.enabled
        if telemetry:
            self.telemetry.profile_step_boundary(self.global_steps)
        breakdown = self.config.wall_clock_breakdown
        timed = breakdown or telemetry
        t0 = time.perf_counter() if timed else 0.0
        with self.telemetry.annotation("batch_prep"):
            batch = self._gas_layout(batch)
        t1 = time.perf_counter() if timed else 0.0
        flop_counter = None
        if self.telemetry.wants_flops():
            # the step's FLOPs, counted once on the first step and this batch
            from torch.utils.flop_counter import FlopCounterMode
            flop_counter = FlopCounterMode(display=False)
        with self.telemetry.step_annotation(self.global_steps), \
                flop_counter if flop_counter is not None else contextlib.nullcontext():
            metrics = self._step(batch)
        if flop_counter is not None:
            self.telemetry.set_flops_per_step(flop_counter.get_total_flops())
        loss_val = None
        t2 = 0.0
        if timed:
            loss_val = float(metrics.loss)  # the step's ONE sync, opt-in
            t2 = time.perf_counter()
        if breakdown:
            acc = self._breakdown_acc
            acc[0] += t1 - t0
            acc[1] += t2 - t1
            acc[2] += 1
            if self.global_steps % self.config.steps_per_print == 0:
                bd, bs, n = acc
                logger.info(f"wall clock breakdown (avg over {n} steps): batch_prep="
                            f"{bd / n * 1e3:.2f}ms train_step={bs / n * 1e3:.2f}ms")
                self._breakdown_acc = [0.0, 0.0, 0]
        if telemetry:
            self._last_telemetry_record = self.telemetry.record_train_step(
                step=self.global_steps, samples=self.global_samples, loss=loss_val,
                grad_norm=float(metrics.grad_norm), lr=metrics.lr,
                step_time_s=max(t2 - t1, 0.0) or None, tokens=self._batch_tokens(batch))
        if (self.config.telemetry.memory_breakdown
                and self.global_steps % self.config.steps_per_print == 0):
            see_memory_usage(f"after train step {self.global_steps}")
        # ops-plane cache refresh after the record, so a scrape sees THIS step
        self._refresh_ops()
        if self.global_steps % self.config.steps_per_print == 0:
            self._report(metrics, loss_val)
        return metrics

    def _step(self, batch) -> StepMetrics:
        """Grads, norm, clipping, lr and the optimizer step on a gas-layout
        batch; advances the step counters."""
        grads, loss = self._accumulate(batch)
        norm = optimizers.global_grad_norm(grads)
        clip = self.config.gradient_clipping
        if clip > 0:
            grads, norm = optimizers.clip_by_global_norm(grads, clip, precomputed_norm=norm)
        state = self.state
        lr = float(self.lr_schedule(state.step))
        if self.optimizer.step_fn is not None:
            params, opt_state = self.optimizer.step_fn(grads, state.opt_state, state.params, lr)
        else:
            updates, opt_state = self.optimizer.update(grads, state.opt_state, state.params, lr)
            params = tree_map(lambda p, u: p.add_(u), state.params, updates)
        self.state = TrainState(step=state.step + 1, params=params, opt_state=opt_state)
        self.global_steps += 1
        self.global_samples += self.train_batch_size
        self.lr_scheduler.last_step = self.global_steps
        self._last_grad_norm = norm
        return StepMetrics(loss=loss, grad_norm=norm, lr=lr, skipped=False, loss_scale=1.0)

    def _report(self, metrics: StepMetrics, loss: Optional[float]) -> None:
        """The steps_per_print line and the monitor writers' events."""
        loss = float(metrics.loss) if loss is None else loss
        norm = float(metrics.grad_norm)
        logger.info(f"step={self.global_steps} loss={loss:.4f} lr={metrics.lr:.3e} "
                    f"grad_norm={norm:.3f}")
        if not self.monitor.enabled:
            return
        samples = self.global_samples
        events = [("Train/Samples/train_loss", loss, samples),
                  ("Train/Samples/lr", float(metrics.lr), samples),
                  ("Train/Samples/grad_norm", norm, samples)]
        rec = self._last_telemetry_record
        if rec is not None:
            for key in ("step_time_ms", "samples_per_sec", "tokens_per_sec", "tflops_per_sec",
                        "mfu"):
                if rec.get(key) is not None:
                    events.append((f"Train/Samples/{key}", float(rec[key]), samples))
            for key, value in (rec.get("hbm") or {}).items():
                if value is not None:
                    events.append((f"Train/HBM/{key}", float(value), samples))
        self.monitor.write_events(events)

    def _batch_tokens(self, batch) -> Optional[int]:
        """Global tokens this step: train_batch_size x the sequence length of
        the first integer leaf with a sequence dim (gas layout [gas, micro,
        seq, ...]); None for sequence-free batches."""
        for leaf in tree_leaves(batch):
            if leaf.dim() > 2 and not leaf.is_floating_point():
                return self.train_batch_size * int(leaf.shape[2])
        return None

    # ------------------------------------------------------------ ops plane
    def ops_health(self) -> Dict[str, Any]:
        """The training engine's /healthz payload: host-owned progress plus
        the newest telemetry record's headline numbers (all cached)."""
        record = self._last_telemetry_record or {}
        return {"global_steps": self.global_steps, "global_samples": self.global_samples,
                "rank": self._ops_rank,
                **{k: record.get(k) for k in ("loss", "step_time_ms", "samples_per_sec",
                                              "tokens_per_sec", "mfu")}}

    def _refresh_ops(self, force: bool = False) -> None:
        """Refresh the cached ops snapshots at the step boundary (throttled to
        ``ops_server.refresh_interval_s``); a no-op with the plane off."""
        if self._ops is None:
            return
        self._ops.refresh(self._populate_ops_registry, now=time.monotonic(), force=force,
                          healthz=lambda: json.dumps(self.ops_health()),
                          statez=lambda: json.dumps(self._ops.registry.snapshot()))

    def _populate_ops_registry(self, reg) -> None:
        ns = reg.namespace
        # telemetry first, then the engine's own families (the engine's live
        # position wins the global-step/samples gauges)
        populate_from_telemetry(reg, self.telemetry)
        reg.set_counter(f"{ns}_train_steps_total", self.global_steps,
                        help_text="optimizer steps run by this process")
        reg.set_counter(f"{ns}_train_samples_total", self.global_samples,
                        help_text="samples consumed by this process")
        reg.set_gauge(f"{ns}_train_global_step", self.global_steps,
                      help_text="absolute training step (checkpoint position)")
        reg.set_gauge(f"{ns}_train_global_samples", self.global_samples,
                      help_text="absolute samples consumed (checkpoint position)")

    def close_ops(self) -> None:
        """Shut the ops HTTP listener down."""
        if self._ops is not None:
            self._ops.close()

    @torch.no_grad()
    def eval_batch(self, batch, rng=None):
        """The loss of ``batch`` (leaves [B, ...]) at the current params, in the
        compute dtype; no step."""
        batch = tree_map(lambda x: _as_tensor(x).to(self.device), batch)
        params = tree_map(lambda p: p.to(self.compute_dtype), self.state.params)
        out = self.loss_fn(params, batch, rng if rng is not None else self.generator)
        return out[0] if isinstance(out, tuple) else out

    # ------------------------------------------------------------- queries
    @property
    def lr(self) -> float:
        return float(self.lr_schedule(self.global_steps))

    def get_global_grad_norm(self) -> Optional[float]:
        """The last step's grad norm before clipping (None before the first)."""
        return None if self._last_grad_norm is None else float(self._last_grad_norm)


def _as_tensor(x) -> torch.Tensor:
    """A batch leaf (tensor, numpy array or nested list) as a tensor."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def initialize(args=None, model=None, loss_fn: Optional[Callable] = None,
               model_parameters: Any = None, training_data=None, config=None,
               device="cuda", **kwargs):
    """See ``deepspeed_tpu_torch.initialize``."""
    if training_data is not None:
        raise NotImplementedError("initialize(training_data=...): the dataloader is not ported "
                                  "to PyTorch yet (ROADMAP Queue 1); pass batches to "
                                  "engine.train_batch")
    if kwargs:
        raise NotImplementedError(f"initialize() arguments {sorted(kwargs)} are not ported to "
                                  f"PyTorch yet")
    cfg = load_config(config)
    if args is not None and getattr(args, "deepspeed_config", None) and config is None:
        cfg = load_config(args.deepspeed_config)
    fn = loss_fn
    if fn is None and model is not None:
        fn = getattr(model, "loss_fn", model if callable(model) else None)
    if fn is None:
        raise ValueError("initialize() needs loss_fn (or a callable/loss_fn-bearing model)")
    if model_parameters is None:
        model_parameters = getattr(model, "params", None)
    if model_parameters is None:
        raise ValueError("initialize() needs model_parameters (the params tree)")
    # The config's sparse_attention section makes the block-sparse kernels
    # this engine's default attention (deepspeed_tpu/__init__.py:73-89): the
    # loss function is wrapped so that the function is in scope while it
    # runs, and None (the backend default) is in scope for an engine without
    # the section.
    sparse_fn = None
    if cfg.sparse_attention is not None:
        from ..ops.sparse_attention.attention import make_config_attention_fn
        sparse_fn = make_config_attention_fn(cfg.sparse_attention)
        logger.info(f"sparse_attention: block-sparse kernels (mode={cfg.sparse_attention.mode}, "
                    f"block={cfg.sparse_attention.block}) are this engine's default attention for "
                    f"models routed through models.transformer.attention_block")
    fn = transformer.scoped_default_attention(fn, sparse_fn)
    engine = Engine(fn, model_parameters, cfg, device=device)
    return engine, engine.optimizer, None, engine.lr_scheduler

"""The training engine, single GPU.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` for one device: an fp32
master copy of the params, a compute-dtype copy made at every step,
micro-batch gradient accumulation in fp32, global-norm clipping, the lr
schedule and the optimizer step.  The step follows ``engine.py:586-655``:

1. grads of each micro-batch of ``loss * scale`` (the fp16 loss scale, 1
   in bf16 and fp32), summed in fp32, then divided by gas * scale;
2. the global grad norm;
3. clipping to ``gradient_clipping``;
4. ``lr = schedule(step)`` with the step count before this step;
5. the fused optimizer step (``optimizer.step_fn``, the fused AdamW kernel on
   CUDA) when the optimizer has one, else the delta form ``update``.

fp16: an overflow (an inf or NaN grad, or a non-finite norm) skips step 5
entirely, the step count (and so the lr schedule) stays put, and the loss
scale follows ``optimizers.update_loss_scale``; the host counters
(``global_steps``, ``global_samples``, the scheduler's ``last_step``)
advance on every call, skipped or not.  JAX takes the update and then
selects the old state with ``where``; the port's fused kernels update
params and moments in place, so it reads the overflow flag on the host and
does not call the optimizer: ONE host sync a step, in fp16 only (the
reference DeepSpeed fp16 optimizer reads it the same way).  bf16 and fp32
steps make no sync.

Checkpoints (``runtime/checkpointing.py``) hold the JAX package's files:
``save_checkpoint`` writes the train state's leaves under JAX's keys
(``step``, ``params.*``, ``opt_state.*``, ``loss_scale.*``) plus the
engine's ``torch.Generator`` state as a ``uint8`` leaf ``torch_rng``, which
the JAX loader ignores (the JAX ``rng`` leaf is read by nobody here).
``load_checkpoint`` takes a checkpoint of either package, matching leaves
by key.  ``forward``/``backward``/``step`` are the JAX three-call shim
(``engine.py:957-972``): ``step`` stacks the queued micro-batches and runs
``train_batch``.

Liveness and divergence (JAX ``engine.py:47, :821, :1021-1058,
:1153-1289``): the ``fault_tolerance`` heartbeat (``runtime/heartbeat.py``)
is stamped after every step and around checkpoint IO (phases
``checkpoint_save``, ``checkpoint_load``, ``resumed``); the watchdog
(``max_consecutive_skips``) raises :class:`NonFiniteLossError` after that
many consecutive bad steps: fp16 counts skipped steps from the overflow flag
it already reads; bf16 and fp32 count non-finite losses or grad norms, and
read them without a sync of their own: on CUDA a step's two values are
copied to pinned memory behind an event, and read once the next step has
been queued (a streak ends one step later than JAX's, never with the
device drained), on the CPU at once.

On one device the JAX engine takes the fused step too (``engine.py:544``),
and ZeRO partitions nothing, so every ZeRO stage runs this same step.  The
engine runs on ``device="cuda"`` unless the caller passes ``device="cpu"``
(then every kernel's plain version runs); it raises when asked for CUDA
without a GPU.  ``initialize`` makes the config's ``sparse_attention``
section the loss function's default attention, scopes the
``data_efficiency.data_routing`` random-LTD state around it (the engine
ramps its kept-token count after each step, and ``eval_batch`` pins it
off), and with ``training_data`` builds the dataloader
(``runtime/dataloader.py``; a curriculum loader under the
``data_efficiency`` or legacy ``curriculum_learning`` schedule).

Observability, as in the JAX engine: the monitor writers (``MonitorMaster``)
and a ``TelemetryCollector`` (``telemetry`` section: per-step records with
loss, step time, tokens/s, ``mfu`` and device memory, and a
``torch.profiler`` step window); ``wall_clock_breakdown`` or telemetry add
ONE ``float(loss)`` sync a step.  The step's FLOPs for ``mfu`` are counted
once, on the first step, by ``profiling.flops_profiler.count_ops``: every
aten product, the remat recompute included, and for each hand kernel the
products of its plain version (so a step counts the same FLOPs on the CPU
and the card).  ``ops_server`` publishes ``/metrics``, ``/healthz``
and ``/statez`` refreshed at the step boundary.

ZeRO-Offload and ZeRO-Infinity (JAX ``engine.py:235-478``, ``:805-820``):
``zero_optimization.offload_optimizer: {device: cpu | nvme}`` keeps the
fp32 master params and Adam moments on the host (the moments on disk with
``nvme``) in an ``OffloadedAdamState``; the device holds only the
compute-dtype copy, refreshed in place after each host step.  A step
accumulates the grads on the device, takes the global norm and clips there,
copies the fp32 grads to host (one pinned staging buffer with
``pin_memory``; CPU-Adam starts on a leaf once its copy has landed), steps
the host C++ CPU-Adam at the host lr, and pushes the params back.
``offload_param: {device: nvme}`` hands training to a ``SwappedLayerTrainer``
(the layers' params on disk, streamed one layer at a time) built from
``initialize``'s ``layer_fn``/``head_fn``/``stem_fn``; ``offload_param:
{device: cpu}`` alone changes nothing, as in JAX.  Checkpoints of an
offloaded engine hold the resident layout, and ``load_universal_checkpoint:
true`` resumes either kind of engine from ``checkpoint/universal.py``'s
atoms.
"""

import contextlib
import json
import logging
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..models import transformer
from ..monitor.metrics import populate_from_telemetry
from ..monitor.monitor import MonitorMaster
from ..monitor.ops_server import OpsPublisher
from ..monitor.telemetry import TelemetryCollector
from ..utils import safetensors_io
from ..utils.memory import see_memory_usage
from . import lr_schedules, optimizers
from .checkpointing import (CheckpointError, _restore_leaf, find_latest_valid_tag,
                            flatten_with_keys, get_latest_tag, load_checkpoint_dir,
                            map_with_keys, read_metadata, save_checkpoint_with_retries,
                            sweep_retention, validate_checkpoint_tag)
from .config import OpsServerConfig, TrainingConfig, load_config
from .grad_accum import accumulate_micro_grads
from .heartbeat import OPS_DIR_ENV, RESUME_DIR_ENV, RESUME_TAG_ENV, build_heartbeat
from .optimizers import LossScaleState, has_overflow, init_loss_scale, update_loss_scale
from .tree import tree_leaves, tree_map

logger = logging.getLogger(__name__)


class NonFiniteLossError(RuntimeError):
    """The train-loop watchdog tripped: ``max_consecutive_skips`` successive
    steps produced a non-finite loss or grad norm (bf16/fp32) or were
    overflow-skipped (fp16)."""


class TrainState(NamedTuple):
    """Everything a step reads and writes."""
    step: int  # optimizer steps taken (a skipped fp16 step takes none)
    params: Any  # fp32 master params, on the engine's device
    opt_state: Any
    loss_scale: Optional[LossScaleState] = None  # fp16 only


class _SavedState(NamedTuple):
    """What a checkpoint holds: the train state's leaves under JAX's keys,
    then the engine's generator state (JAX's template has ``rng`` there)."""
    step: int
    params: Any
    opt_state: Any
    loss_scale: Optional[LossScaleState]
    torch_rng: Optional[np.ndarray]


class StepMetrics(NamedTuple):
    loss: torch.Tensor  # mean micro-batch loss, fp32 0-d, on the device
    grad_norm: torch.Tensor  # before clipping
    lr: float
    skipped: bool  # fp16: the overflow skipped the update; always False in bf16/fp32
    loss_scale: float  # the scale this step's loss was multiplied by


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
                 device="cuda", ltd_state: Optional[dict] = None,
                 layer_fn: Optional[Callable] = None, head_fn: Optional[Callable] = None,
                 stem_fn: Optional[Callable] = None):
        self.device = resolve_device(device)
        self.config = config
        self.loss_fn = loss_fn
        # the random-LTD state initialize() scoped around loss_fn (or None)
        self._ltd_state = ltd_state
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
        self.fp16_enabled = config.fp16.enabled
        self.global_steps = 0
        self.global_samples = 0
        # per-process counter bases of the ops plane: load_checkpoint moves
        # them to the restored position, so exported counters count this
        # process's work only
        self._ops_steps_base = 0
        self._ops_samples_base = 0
        self._micro_batches: list = []
        self._ckpt_engine = None  # built at the first save from the config
        # the SIGTERM best-effort final save, armed by the first
        # save_checkpoint() when checkpoint.save_on_preemption is set
        self._preempt_save_dir: Optional[str] = None
        self._preempt_prev_handler = None
        self._preempt_registered = False
        self._in_preempt_save = False
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self._last_grad_norm: Optional[torch.Tensor] = None
        # the watchdog's streak, and on CUDA the step whose verdict is still
        # on its way to the host
        self._consecutive_bad_steps = 0
        self._watchdog_pending = None
        # per-rank liveness stamps (the fault_tolerance section or the
        # agent-exported DSTPU_HEARTBEAT_DIR; a no-op writer otherwise)
        self.heartbeat = build_heartbeat(config.fault_tolerance)
        act = config.activation_checkpointing
        if act.cpu_checkpointing or act.policy != "nothing_saveable":
            logger.info(f"activation_checkpointing requests policy="
                        f"{'cpu_checkpointing' if act.cpu_checkpointing else act.policy}: remat "
                        f"belongs to the model (LlamaConfig.remat_policy="
                        f"{'offload_inputs' if act.cpu_checkpointing else repr(act.policy)}); the "
                        f"engine cannot rewrite it inside a loss function")
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

        zero = config.zero_optimization
        off = zero.offload_optimizer
        self.offload_device = off.device if (off is not None and off.device != "none") else None
        self._offload_state = None
        self._nvme_trainer = None
        off_p = zero.offload_param
        if off_p is not None and off_p.device == "nvme":
            # ZeRO-Infinity: the caller supplies the layer structure that an
            # opaque loss function hides (JAX engine.py:235-259)
            if layer_fn is None or head_fn is None:
                raise ValueError(
                    "offload_param: nvme streams one layer at a time, which needs the layer "
                    "structure the opaque loss_fn hides - pass layer_fn(params_l, x) -> x and "
                    "head_fn(head_params, x, labels) -> loss to initialize(), with "
                    "model_parameters = {'layers': stacked [L, ...] tree, ...head leaves}")
            if not (isinstance(params, dict) and "layers" in params):
                raise ValueError("offload_param: nvme expects model_parameters to be a dict "
                                 "with a stacked 'layers' subtree ([L, ...] leaves)")
            if self.gradient_accumulation_steps != 1:
                raise ValueError(
                    f"offload_param: nvme streams layers on ONE process/device "
                    f"(gas={self.gradient_accumulation_steps}, dp=1 requested) - set "
                    f"gradient_accumulation_steps=1")
            self._init_nvme_trainer(params, off_p, layer_fn, head_fn, stem_fn)
            self.state = None
            return
        if self.offload_device is not None:
            self._init_offload(params, off)
            self.state = None
        else:
            master = tree_map(lambda p: _as_tensor(p).detach().to(
                device=self.device, dtype=torch.float32).clone(), params)
            self.state = TrainState(step=0, params=master, opt_state=self.optimizer.init(master),
                                    loss_scale=(init_loss_scale(config.fp16) if self.fp16_enabled
                                                else None))
        n_params = sum(int(np.prod(tuple(p.shape))) for p in tree_leaves(params))
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
        """The compute-dtype copy of the master params, as autograd leaves
        (under ``offload_optimizer``, the device's persistent copy)."""
        if self._offload_state is not None:
            return self._compute
        return tree_map(lambda p: p.detach().to(self.compute_dtype).requires_grad_(True),
                        self.state.params)

    # ------------------------------------------------------------- offload
    def _offload_adam_params(self, what: str, allowed) -> Dict[str, Any]:
        """The optimizer section's params for a host CPU-Adam; any optimizer
        but ``allowed`` raises ``ValueError``, as in JAX."""
        opt_cfg = self.config.optimizer
        opt_type = (opt_cfg.type if opt_cfg else "adamw").lower()
        if opt_type not in allowed:
            raise ValueError(f"{what} steps with the host CPU-Adam (csrc/cpu_adam.cpp); optimizer "
                             f"'{opt_type}' is not supported (adam/adamw)")
        opt_params = dict(opt_cfg.params) if opt_cfg else {}
        return dict(betas=tuple(opt_params.get("betas", (0.9, 0.999))),
                    eps=float(opt_params.get("eps", 1e-8)),
                    weight_decay=float(opt_params.get("weight_decay", 0.0)))

    def _init_nvme_trainer(self, params, off_p, layer_fn, head_fn, stem_fn):
        """ZeRO-Infinity (JAX ``engine.py:362-405``): the layers' fp32 masters go
        to disk under ``nvme_path``, the moments too unless
        ``offload_optimizer`` is ``cpu`` (then in RAM); the head and, with a
        ``stem_fn``, the ``stem`` group stay on the device."""
        import tempfile

        from .swap_tensor.partitioned_param_swapper import (AsyncPartitionedParameterSwapper,
                                                            SwappedLayerTrainer)
        adam = self._offload_adam_params("offload_param: nvme",
                                         ("adam", "adamw", "fusedadam", "fused_adam"))
        path = off_p.nvme_path or tempfile.mkdtemp(prefix="dstpu_nvme_")
        swapper = AsyncPartitionedParameterSwapper(path, buffer_count=off_p.buffer_count)
        stacked = params["layers"]
        num_layers = int(tree_leaves(stacked)[0].shape[0])
        off_o = self.config.zero_optimization.offload_optimizer
        opt_device = "cpu" if (off_o is not None and off_o.device == "cpu") else "nvme"
        trainer = SwappedLayerTrainer(
            layer_fn, num_layers, head_fn, swapper, lr=self.base_lr, **adam,
            compute_dtype=self.compute_dtype, stem_fn=stem_fn, optimizer_device=opt_device,
            offload_activations=self.config.activation_checkpointing.cpu_checkpointing,
            device=self.device)
        # "stem" is reserved only when a stem_fn claims it
        head_keys = ("layers", "stem") if stem_fn is not None else ("layers", )
        trainer.init_from_stacked(stacked, {k: v for k, v in params.items() if k not in head_keys},
                                  stem_params=params.get("stem") if stem_fn is not None else None)
        self._nvme_trainer = trainer
        logger.info(f"Engine: ZeRO-Infinity NVMe param streaming - {num_layers} layers, "
                    f"buffer_count={off_p.buffer_count}, moments={opt_device}, path={path}")

    def _init_offload(self, params, off):
        """ZeRO-Offload (JAX ``engine.py:407-441``): fp32 master params and Adam
        moments on the host (``cpu``) or the moments on disk (``nvme``); the
        device holds the compute-dtype copy only."""
        from .swap_tensor.optimizer_swapper import OffloadedAdamState, flat_views, host_buffer
        if self.fp16_enabled:
            raise ValueError("optimizer offload requires bf16/fp32 (fp16 dynamic loss "
                             "scaling is not supported on the host-offload path)")
        adam = self._offload_adam_params("optimizer offload", ("adam", "adamw"))
        flat = dict(flatten_with_keys(params))
        self._offload_shapes = {k: tuple(leaf.shape) for k, leaf in flat.items()}
        self._offload_template = map_with_keys(lambda key, _: key, params)
        pin = off.pin_memory and self.device.type == "cuda"
        self._offload_state = OffloadedAdamState(
            flat, device=self.offload_device, nvme_path=off.nvme_path, lr=self.base_lr,
            pin_memory=pin, **adam)
        sizes = {k: int(np.prod(shape)) for k, shape in self._offload_shapes.items()}
        self._grad_staging = flat_views(host_buffer(sum(sizes.values()), pin), sizes)
        # the compute copy: persistent autograd leaves, refreshed in place
        self._compute = tree_map(
            lambda key: torch.empty(self._offload_shapes[key], dtype=self.compute_dtype,
                                    device=self.device).requires_grad_(True),
            self._offload_template)
        self._compute_by_key = dict(flatten_with_keys(self._compute))
        self._push_compute_params()
        # seconds of the last offloaded step by part (device compute, grads to
        # host, CPU-Adam, push), host clock: the step waits for the device
        # before the grads' copy and after the push
        self.offload_times: Dict[str, float] = {}

    @torch.no_grad()
    def _push_compute_params(self):
        """Refresh the device's compute copy from the host masters with
        ``copy_`` (cast on the device; the leaves and their holders stay
        valid).  The copies are queued behind the step that read the old
        values, so they never overwrite params the device still reads."""
        params = self._offload_state.params
        for key, leaf in self._compute_by_key.items():
            leaf.copy_(params[key].view(leaf.shape), non_blocking=True)

    def _offload_step(self, batch) -> StepMetrics:
        """The offloaded step (JAX ``_offload_train_batch``, ``engine.py:452-478``)."""
        clock = time.perf_counter
        t0 = clock()
        gas = self.gradient_accumulation_steps
        grads, loss_sum = accumulate_micro_grads(self.loss_fn, self._compute, batch,
                                                 [self.generator] * gas, 1.0)
        loss = loss_sum / gas
        divisor = float(np.float32(gas))
        for g in tree_leaves(grads):
            g.div_(divisor)
        norm = optimizers.global_grad_norm(grads)
        clip = self.config.gradient_clipping
        if clip > 0:
            grads, norm = optimizers.clip_by_global_norm(grads, clip, precomputed_norm=norm)
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t1 = clock()
        events = {}
        staging = self._grad_staging
        for key, g in flatten_with_keys(grads):
            staging[key].copy_(g.reshape(-1), non_blocking=True)
            if cuda:
                events[key] = torch.cuda.Event()
                events[key].record()
        waited = [0.0]

        def ready(key):  # CPU-Adam reads a leaf's grads once their copy has landed
            if cuda:
                w0 = clock()
                events[key].synchronize()
                waited[0] += clock() - w0

        lr = float(self.lr_schedule(self.global_steps))
        t2 = clock()
        self._offload_state.step({k: staging[k] for k in self._compute_by_key}, lr=lr,
                                 ready=ready)
        del grads
        t3 = clock()
        self._push_compute_params()
        if cuda:
            torch.cuda.synchronize(self.device)
        t4 = clock()
        self.offload_times = {"compute": t1 - t0, "grads_d2h": t2 - t1 + waited[0],
                              "cpu_adam": t3 - t2 - waited[0], "push_h2d": t4 - t3}
        self.global_steps += 1
        self.global_samples += self.train_batch_size
        self.lr_scheduler.last_step = self.global_steps
        self._last_grad_norm = norm
        return StepMetrics(loss=loss, grad_norm=norm, lr=lr, skipped=False, loss_scale=1.0)

    def _offload_host_state(self) -> Dict[str, Any]:
        """The host state as a tree with the resident state's keys (JAX
        ``engine.py:1218-1230``), plus the engine's ``torch_rng``; the params
        are views of the host masters."""
        sd = self._offload_state.state_dict()
        tree = lambda flat: tree_map(lambda key: flat[key].view(self._offload_shapes[key]),
                                     self._offload_template)
        return {"step": sd["step"], "params": tree(self._offload_state.params),
                "opt_state": {"step": sd["step"], "exp_avg": tree(sd["m"]),
                              "exp_avg_sq": tree(sd["v"])},
                "torch_rng": self.generator.get_state().numpy()}

    def _nvme_guard(self, what: str):
        if self._nvme_trainer is not None:
            raise NotImplementedError(
                f"{what} is not available on the offload_param:nvme streaming path - state "
                f"lives in the swapper's NVMe files (persistent across runs at nvme_path); "
                f"use the trainer's forward() for inference, and point a new engine at the "
                f"same nvme_path to resume")

    def _nvme_train_batch(self, batch) -> StepMetrics:
        """The ZeRO-Infinity step (JAX ``engine.py:805-820``): the trainer
        streams the layers; the batch goes through whole."""
        self.telemetry.profile_step_boundary(self.global_steps)
        lr = float(self.lr_schedule(self.global_steps))
        t0 = time.perf_counter()
        with self.telemetry.step_annotation(self.global_steps):
            loss = self._nvme_trainer.train_step(batch, lr=lr)
        step_time = time.perf_counter() - t0
        metrics = StepMetrics(loss=torch.tensor(loss, dtype=torch.float32),
                              grad_norm=torch.tensor(0.0), lr=lr, skipped=False, loss_scale=1.0)
        self.global_steps += 1
        self.global_samples += self.train_batch_size
        self.lr_scheduler.last_step = self.global_steps
        self.heartbeat.stamp(self.global_steps)
        if self.telemetry.enabled:
            self.telemetry.set_flops_per_step(None)  # the streamed loop is no one program
            x = _as_tensor(batch["x"])
            self._last_telemetry_record = self.telemetry.record_train_step(
                step=self.global_steps, samples=self.global_samples, loss=loss, grad_norm=0.0,
                lr=lr, step_time_s=step_time,
                tokens=(self.train_batch_size * int(x.shape[1])
                        if x.dim() > 1 and not x.is_floating_point() else None))
        self._refresh_ops()
        self._watchdog_check(metrics, loss)
        if self.global_steps % self.config.steps_per_print == 0:
            self._report(metrics, loss)
        return metrics

    # ---------------------------------------------------------------- step
    def _loss_scale(self) -> float:
        ls = self.state.loss_scale
        return 1.0 if ls is None else ls.cur_scale

    def accumulate_gradients(self, batch):
        """(fp32 grads averaged over the micro-batches and unscaled, mean
        loss) for ``batch`` at the current params, without stepping: step 1
        of the train step."""
        return self._accumulate(self._gas_layout(batch), self._loss_scale())

    def _accumulate(self, batch, scale: float):
        gas = self.gradient_accumulation_steps
        grads, loss_sum = accumulate_micro_grads(self.loss_fn, self._compute_params(), batch,
                                                 [self.generator] * gas, scale)
        divisor = float(np.float32(gas) * np.float32(scale))  # float32, as JAX's gas * scale
        for g in tree_leaves(grads):
            g.div_(divisor)
        return grads, loss_sum / gas

    def train_batch(self, batch) -> StepMetrics:
        """One optimizer step on a global batch: leaves [train_batch_size, ...]
        or [gas, micro, ...] (under ``offload_param: nvme``, ``{"x", "y"}``
        taken whole)."""
        if self._nvme_trainer is not None:
            return self._nvme_train_batch(batch)
        if self._ltd_state is not None:
            self._ramp_ltd()
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
        if self.telemetry.wants_flops() and self._offload_state is not None:
            self.telemetry.set_flops_per_step(None)  # the step is no one device program
        elif self.telemetry.wants_flops():
            # the step's FLOPs, counted once on the first step and this batch,
            # with the FLOPs profiler's count (the hand kernels included)
            from ..profiling.flops_profiler import count_ops
            flop_counter = count_ops()
        with self.telemetry.step_annotation(self.global_steps), \
                flop_counter if flop_counter is not None else contextlib.nullcontext():
            metrics = (self._step(batch) if self._offload_state is None
                       else self._offload_step(batch))
        if flop_counter is not None:
            self.telemetry.set_flops_per_step(flop_counter.flops)
        # liveness stamp: the host step count and the wall clock, throttled
        # inside the writer; no device value
        self.heartbeat.stamp(self.global_steps)
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
        self._watchdog_check(metrics, loss_val)
        if self.global_steps % self.config.steps_per_print == 0:
            self._report(metrics, loss_val)
        return metrics

    def _ramp_ltd(self):
        """Before a step: warn once if the first step never dropped a token
        (the loss function does not read ``configured_ltd()``), then set the
        kept-token count to the schedule's value for this step."""
        st = self._ltd_state
        if self.global_steps == 1 and not st.get("engaged"):
            logger.warning("data_routing.random_ltd is configured but the first step never "
                           "engaged token dropping: this loss_fn does not read "
                           "configured_ltd() (llama-family forwards with an rng do); training "
                           "proceeds WITHOUT random-LTD")
        st["keep"] = st["scheduler"].update_seq(self.global_steps)

    # ------------------------------------------------------------ watchdog
    def _watchdog_check(self, metrics: StepMetrics, loss_val: Optional[float] = None):
        """The NaN/Inf sentinel (``max_consecutive_skips``): fp16 counts
        consecutive skipped steps (the flag is on the host already); bf16
        and fp32 count consecutive steps with a non-finite loss or grad
        norm.  One good step resets the streak; reaching the limit raises
        :class:`NonFiniteLossError`.  On CUDA the values travel to pinned
        memory behind an event and are read a step later (see the module
        docstring); with ``loss_val`` already on the host (telemetry or the
        breakdown synced for it) or on the CPU they are read at once."""
        limit = self.config.max_consecutive_skips
        if limit <= 0:
            return
        lr = metrics.lr
        if self.fp16_enabled:
            self._watchdog_count(metrics.skipped, None, None, lr, self.global_steps)
            return
        if self.device.type != "cuda" or loss_val is not None:
            loss = float(metrics.loss) if loss_val is None else loss_val
            self._watchdog_count(None, loss, float(metrics.grad_norm), lr, self.global_steps)
            return
        host = torch.empty(2, dtype=torch.float32, pin_memory=True)
        host.copy_(torch.stack([metrics.loss.float(), metrics.grad_norm.float()]),
                   non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        pending, self._watchdog_pending = (self._watchdog_pending,
                                           (host, event, lr, self.global_steps))
        if pending is not None:
            host, event, lr, step = pending
            event.synchronize()  # the step before this one: this one stays queued
            self._watchdog_count(None, float(host[0]), float(host[1]), lr, step)

    def _watchdog_count(self, skipped, loss, grad_norm, lr, step):
        limit = self.config.max_consecutive_skips
        bad = skipped if self.fp16_enabled else not (np.isfinite(loss) and np.isfinite(grad_norm))
        if not bad:
            self._consecutive_bad_steps = 0
            return
        self._consecutive_bad_steps += 1
        self.telemetry.record_resilience(
            "watchdog_nonfinite", step=step, samples=self.global_samples,
            consecutive=self._consecutive_bad_steps, limit=limit, loss=loss, grad_norm=grad_norm)
        if self._consecutive_bad_steps >= limit:
            kind = "fp16 overflow-skipped" if self.fp16_enabled else "non-finite loss/grad-norm"
            raise NonFiniteLossError(
                f"train-loop watchdog: {self._consecutive_bad_steps} consecutive {kind} steps "
                f"(max_consecutive_skips={limit}) at global step {step} - last loss={loss}, "
                f"grad_norm={grad_norm}, lr={float(lr):.3e}. The run has diverged: check the "
                f"data pipeline for corrupt batches, lower the lr, or resume from the last "
                f"checkpoint with load_checkpoint(fallback_to_valid=True)")

    def _step(self, batch) -> StepMetrics:
        """Grads, norm, clipping, lr and the optimizer step on a gas-layout
        batch; advances the step counters.  In fp16 an overflow skips the
        optimizer (see the module docstring)."""
        state = self.state
        scale = self._loss_scale()
        grads, loss = self._accumulate(batch, scale)
        norm = optimizers.global_grad_norm(grads)
        clip = self.config.gradient_clipping
        if clip > 0:
            grads, norm = optimizers.clip_by_global_norm(grads, clip, precomputed_norm=norm)
        lr = float(self.lr_schedule(state.step))
        overflow = False
        if state.loss_scale is not None:
            # the fp16 step's one host sync: the fused kernels update in
            # place, so the skip is decided before the optimizer runs
            overflow = bool(has_overflow(grads) | ~torch.isfinite(norm))
        if overflow:
            params, opt_state = state.params, state.opt_state
        elif self.optimizer.step_fn is not None:
            params, opt_state = self.optimizer.step_fn(grads, state.opt_state, state.params, lr)
        else:
            updates, opt_state = self.optimizer.update(grads, state.opt_state, state.params, lr)
            params = tree_map(lambda p, u: p.add_(u), state.params, updates)
        loss_scale = (None if state.loss_scale is None else
                      update_loss_scale(state.loss_scale, overflow, self.config.fp16))
        self.state = TrainState(step=state.step + (0 if overflow else 1), params=params,
                                opt_state=opt_state, loss_scale=loss_scale)
        self.global_steps += 1
        self.global_samples += self.train_batch_size
        self.lr_scheduler.last_step = self.global_steps
        self._last_grad_norm = norm
        return StepMetrics(loss=loss, grad_norm=norm, lr=lr, skipped=overflow, loss_scale=scale)

    # ------------------------------------------------- the three-call shim
    def forward(self, micro_batch):
        """Queue one micro-batch (leaves [micro, ...]); returns None, as in
        JAX: the loss comes from ``step()``."""
        self._micro_batches.append(micro_batch)
        return None

    def backward(self, loss=None):
        return None

    def step(self) -> StepMetrics:
        """``train_batch`` over the ``gradient_accumulation_steps``
        micro-batches queued by ``forward``, stacked on a new leading dim."""
        gas = self.gradient_accumulation_steps
        if len(self._micro_batches) != gas:
            raise RuntimeError(f"engine.step() called after {len(self._micro_batches)} forward() "
                               f"calls; gradient_accumulation_steps={gas} micro-batches are "
                               f"required")
        stacked = tree_map(lambda *xs: torch.stack([_as_tensor(x) for x in xs]),
                           *self._micro_batches)
        self._micro_batches = []
        return self.train_batch(stacked)

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
                "consecutive_bad_steps": self._consecutive_bad_steps,
                "heartbeat": bool(getattr(self.heartbeat, "enabled", False)),
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
        # counters count THIS process's work (since the last checkpoint
        # load); the absolute position rides as a gauge
        reg.set_counter(f"{ns}_train_steps_total", self.global_steps - self._ops_steps_base,
                        help_text="optimizer steps run by this process")
        reg.set_counter(f"{ns}_train_samples_total",
                        self.global_samples - self._ops_samples_base,
                        help_text="samples consumed by this process")
        reg.set_gauge(f"{ns}_train_global_step", self.global_steps,
                      help_text="absolute training step (checkpoint position)")
        reg.set_gauge(f"{ns}_train_global_samples", self.global_samples,
                      help_text="absolute samples consumed (checkpoint position)")
        reg.set_gauge(f"{ns}_train_consecutive_bad_steps", self._consecutive_bad_steps,
                      help_text="current NaN/overflow watchdog streak")

    def close_ops(self) -> None:
        """Shut the ops HTTP listener down."""
        if self._ops is not None:
            self._ops.close()

    @torch.no_grad()
    def eval_batch(self, batch, rng=None):
        """The loss of ``batch`` (leaves [B, ...]) at the current params, in the
        compute dtype; no step.  Random-LTD is pinned off: eval measures the
        whole model."""
        self._nvme_guard("eval_batch")
        batch = tree_map(lambda x: _as_tensor(x).to(self.device), batch)
        if self._offload_state is not None:
            params = tree_map(lambda p: p.detach(), self._compute)
        else:
            params = tree_map(lambda p: p.to(self.compute_dtype), self.state.params)
        loss_fn = self.loss_fn
        if self._ltd_state is not None:
            loss_fn = transformer.scoped_random_ltd(loss_fn, None)
        out = loss_fn(params, batch, rng if rng is not None else self.generator)
        return out[0] if isinstance(out, tuple) else out

    # ------------------------------------------------------------- queries
    @property
    def lr(self) -> float:
        return float(self.lr_schedule(self.global_steps))

    def get_global_grad_norm(self) -> Optional[float]:
        """The last step's grad norm before clipping (None before the first)."""
        return None if self._last_grad_norm is None else float(self._last_grad_norm)

    def get_fp32_params(self):
        """The fp32 master params as a tree of numpy arrays (copies)."""
        self._nvme_guard("get_fp32_params")
        return tree_map(lambda p: p.detach().to("cpu", copy=True).numpy(), self._master_params())

    def _master_params(self):
        """The fp32 master params: on the device, or the host's under offload."""
        if self._offload_state is not None:
            return self._offload_host_state()["params"]
        return self.state.params

    def save_16bit_model(self, save_dir: str, filename: str = "model.safetensors") -> str:
        """The params cast to the compute dtype, in one safetensors file
        keyed by their leaf keys (``layers.attn.wq``), as the JAX engine
        writes it; bf16 leaves are ``"BF16"``.  Returns the file's path."""
        self._nvme_guard("save_16bit_model")
        os.makedirs(save_dir, exist_ok=True)
        out = {key: p.detach().to(self.compute_dtype)
               for key, p in flatten_with_keys(self._master_params())}
        path = os.path.join(save_dir, filename)
        safetensors_io.save_file(out, path)
        logger.info(f"saved 16-bit model weights ({len(out)} leaves) -> {path}")
        return path

    # --------------------------------------------------------- checkpointing
    def _validate_tag(self, tag: str):
        """Cross-process tag consistency (JAX ``engine.py:1103-1120``): every
        process must save under the same tag.  The port trains in one
        process, where there is nothing to compare, whatever
        ``checkpoint_tag_validation`` says."""

    @property
    def checkpoint_engine(self):
        """The config's persistence plug-in (``checkpoint.checkpoint_engine``,
        or the async writer when the ``nebula`` section is on), built at the
        first use so that an engine that never saves starts no writer
        thread."""
        if self._ckpt_engine is None:
            from .checkpoint_engine import build_checkpoint_engine
            kind = self.config.checkpoint_engine_kind()
            self._ckpt_engine = build_checkpoint_engine(
                kind, max_queue=self.config.checkpoint.async_max_queue)
        return self._ckpt_engine

    def _saved_state(self):
        if self._offload_state is not None:
            return self._offload_host_state()
        return _SavedState(*self.state, torch_rng=self.generator.get_state().numpy())

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None) -> str:
        """Save the train state under ``save_dir/<tag>`` (default
        ``global_step<N>``) through the configured checkpoint engine, with
        the configured retries; ``client_state`` gains ``global_steps``,
        ``global_samples`` and the scheduler's state.  Afterwards
        ``keep_last_n`` retention runs and, with
        ``checkpoint.save_on_preemption``, the SIGTERM handler is armed.
        Returns the tag."""
        self._nvme_guard("save_checkpoint")
        tag = tag or f"global_step{self.global_steps}"
        self._validate_tag(tag)
        client_state = dict(client_state or {})
        client_state.update({"global_steps": self.global_steps,
                             "global_samples": self.global_samples,
                             "lr_scheduler": self.lr_scheduler.state_dict()})
        ck = self.config.checkpoint
        t0 = time.perf_counter()
        # phase-stamped, so that a hang dump tells checkpoint IO (slow by
        # nature) from a wedged step
        self.heartbeat.stamp(self.global_steps, phase="checkpoint_save", force=True)
        with self.telemetry.annotation("checkpoint_save"):
            save_checkpoint_with_retries(
                save_dir, tag, self._saved_state(), client_state,
                engine=self.checkpoint_engine, retries=ck.save_retries,
                backoff_secs=ck.retry_backoff_secs,
                on_retry=lambda attempt, exc: self.telemetry.record_resilience(
                    "save_retry", step=self.global_steps, samples=self.global_samples, tag=tag,
                    attempt=attempt, error=repr(exc)))
        self.telemetry.record_events([("Train/Checkpoint/save_time_ms",
                                       (time.perf_counter() - t0) * 1e3, self.global_samples)])
        if ck.keep_last_n:
            sweep_retention(save_dir, ck.keep_last_n, verify_integrity=ck.verify_integrity)
        self._register_preemption_handler(save_dir)
        self.heartbeat.stamp(self.global_steps, force=True)
        return tag

    def _register_preemption_handler(self, save_dir: str):
        """Arm the best-effort final save (``checkpoint.save_on_preemption``):
        on SIGTERM save one last checkpoint tagged ``preempt_step<N>`` with
        ``client_state["preempted"]`` set, then chain to the handler that was
        installed before (so the default die-on-TERM still happens)."""
        self._preempt_save_dir = save_dir
        if self._preempt_registered or not self.config.checkpoint.save_on_preemption:
            return
        if threading.current_thread() is not threading.main_thread():
            return  # signal.signal works from the main thread only
        try:
            self._preempt_prev_handler = signal.signal(signal.SIGTERM, self._on_preemption)
            self._preempt_registered = True
            logger.info("checkpoint: save_on_preemption armed (SIGTERM -> final save)")
        except (ValueError, OSError) as exc:
            logger.warning(f"save_on_preemption: could not install SIGTERM handler ({exc})")

    def _on_preemption(self, signum=None, frame=None):
        # CPython runs signal handlers on the main thread between bytecodes,
        # so this never runs concurrently with a step
        if not self._in_preempt_save and self._preempt_save_dir is not None:
            self._in_preempt_save = True
            try:
                tag = f"preempt_step{self.global_steps}"
                logger.warning(f"SIGTERM: best-effort preemption save -> "
                               f"{self._preempt_save_dir}/{tag}")
                self.save_checkpoint(self._preempt_save_dir, tag=tag,
                                     client_state={"preempted": True})
                self.telemetry.record_resilience("preemption_save", step=self.global_steps,
                                                 samples=self.global_samples, tag=tag)
            except BaseException as exc:  # best-effort: never mask the signal
                logger.error(f"preemption save failed: {exc!r}")
            finally:
                self._in_preempt_save = False
        prev = self._preempt_prev_handler
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL and signum is not None:
            # restore the default disposition and re-deliver, so that the
            # process still dies the way its supervisor expects
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True, fallback_to_valid: bool = False):
        """Resume from ``load_dir``: a checkpoint of this package or of the
        JAX package.  With ``fallback_to_valid`` a missing, incomplete or
        corrupt tag (manifest sizes, and CRC32s with
        ``checkpoint.verify_integrity``) walks back to the newest earlier tag
        that validates; without it, it raises :class:`CheckpointError`.
        With ``tag`` None, a resume tag pinned in ``DSTPU_RESUME_TAG`` (and
        scoped by ``DSTPU_RESUME_DIR``) wins over ``latest``.  Restores
        ``global_steps``, ``global_samples`` and the scheduler;
        ``load_optimizer_states=False`` keeps this engine's optimizer and
        loss-scale state.  Leaves land on the engine's device.  Returns
        ``(tag, client_state)``.  With ``load_universal_checkpoint`` the
        directory is a universal one (or holds one under ``<tag>/``)."""
        self._nvme_guard("load_checkpoint")
        t0 = time.perf_counter()
        self.heartbeat.stamp(self.global_steps, phase="checkpoint_load", force=True)
        with self.telemetry.annotation("checkpoint_load"):
            if self.config.load_universal_checkpoint:
                tag, client_state = self._load_universal_checkpoint(load_dir, tag,
                                                                    load_optimizer_states)
            else:
                tag = self._resolve_load_tag(load_dir, tag, fallback_to_valid)
                if self._offload_state is not None:
                    client_state = self._load_checkpoint_offload(load_dir, tag,
                                                                 load_optimizer_states)
                else:
                    client_state = self._load_checkpoint_resident(load_dir, tag,
                                                                  load_optimizer_states)
            self._restore_counters(client_state)
        self.telemetry.record_events([("Train/Checkpoint/load_time_ms",
                                       (time.perf_counter() - t0) * 1e3, self.global_samples)])
        # clears the checkpoint_load phase and declares the restart, which the
        # agent gives its startup grace
        self.heartbeat.stamp(self.global_steps, phase="resumed", force=True)
        return tag, client_state

    def _restore_counters(self, client_state: Dict[str, Any]) -> None:
        self.global_steps = client_state.get("global_steps", 0)
        self.global_samples = client_state.get("global_samples", 0)
        self._ops_steps_base = self.global_steps
        self._ops_samples_base = self.global_samples
        if "lr_scheduler" in client_state:
            self.lr_scheduler.load_state_dict(client_state["lr_scheduler"])

    def _load_checkpoint_resident(self, load_dir, tag, load_optimizer_states):
        template = self._saved_state()
        template = template._replace(
            torch_rng=self._generator_template(load_dir, tag, template.torch_rng))
        saved, client_state = load_checkpoint_dir(
            load_dir, tag, template, self.device, load_optimizer_states=load_optimizer_states,
            validate=False)  # _resolve_load_tag validated it
        self.state = TrainState(step=saved.step, params=saved.params,
                                opt_state=saved.opt_state, loss_scale=saved.loss_scale)
        if saved.torch_rng is not None:
            self.generator.set_state(torch.from_numpy(np.array(saved.torch_rng)))
        return client_state

    def _load_checkpoint_offload(self, load_dir, tag, load_optimizer_states):
        """A checkpoint into the host state (JAX ``engine.py:1360-1385``): params,
        moments and step by key, whichever engine wrote it."""
        ckpt_dir = os.path.join(load_dir, tag)
        meta = read_metadata(ckpt_dir)
        host = self._offload_state
        sd = {"m": {}, "v": {}, "step": 0}
        for entry in meta["manifest"]:
            key = entry["key"]
            path = os.path.join(ckpt_dir, key + ".npy")
            if key.startswith("params."):
                host.params[key[len("params."):]].copy_(
                    torch.from_numpy(np.load(path).astype(np.float32).ravel()))
            elif key.startswith("opt_state.exp_avg_sq.") and load_optimizer_states:
                sd["v"][key[len("opt_state.exp_avg_sq."):]] = np.load(path)
            elif key.startswith("opt_state.exp_avg.") and load_optimizer_states:
                sd["m"][key[len("opt_state.exp_avg."):]] = np.load(path)
            elif key in ("step", "opt_state.step"):
                sd["step"] = int(np.load(path))
            elif key == "torch_rng":
                self._load_generator(np.load(path), tag)
        if load_optimizer_states and sd["m"]:
            host.load_state_dict(sd)
        self._push_compute_params()
        return meta.get("client_state", {})

    def _load_generator(self, state: np.ndarray, tag: str) -> None:
        current = self.generator.get_state()
        if tuple(state.shape) != tuple(current.shape):
            logger.warning(f"checkpoint {tag}: torch_rng of shape {tuple(state.shape)} comes from "
                           f"a generator of another device type; keeping the engine's seeded "
                           f"generator")
            return
        self.generator.set_state(torch.from_numpy(np.array(state)))

    def _load_universal_checkpoint(self, load_dir, tag, load_optimizer_states=True):
        """Resume from the universal atom format (JAX ``engine.py:1387-1500``),
        resident or offloaded.  ``load_dir`` holds ``universal_metadata.json``
        or has a ``<tag>/`` that does.  Param leaves come from their ``fp32``
        atoms; optimizer leaves match atoms by the same suffix discovery the
        converter used, so a different optimizer resumes too (unmatched
        moments warn and keep their values); atoms stripped of vocab padding
        are zero-padded back on dim 0."""
        from ..checkpoint.universal import PARAM_ATOM, load_universal
        udir = load_dir
        if not os.path.exists(os.path.join(udir, "universal_metadata.json")):
            tag = tag or get_latest_tag(load_dir)
            if tag is not None and os.path.exists(os.path.join(load_dir, tag,
                                                               "universal_metadata.json")):
                udir = os.path.join(load_dir, tag)
            else:
                raise FileNotFoundError(
                    f"load_universal_checkpoint: no universal_metadata.json under {load_dir}"
                    + (f" or {load_dir}/{tag}" if tag else "")
                    + " - convert a checkpoint first (python -m "
                      "deepspeed_tpu_torch.checkpoint.universal)")
        data = load_universal(udir)
        atoms, passthrough = data["params"], data["passthrough"]
        stripped_to = data.get("strip_vocab_padding")
        by_len = sorted(atoms, key=len, reverse=True)

        def lookup(key: str):
            if key.startswith("params."):
                p = key[len("params."):]
                return atoms[p][PARAM_ATOM] if p in atoms else None
            if key.startswith("opt_state."):
                if not load_optimizer_states:
                    return None
                rest = key[len("opt_state."):]
                for p in by_len:
                    if rest.endswith("." + p):
                        got = atoms[p].get(rest[:-(len(p) + 1)])
                        if got is not None:
                            return got
                return passthrough.get(key)
            return passthrough.get(key)

        def fit(arr: np.ndarray, want, key: str) -> np.ndarray:
            want = tuple(want)
            if tuple(arr.shape) != want:
                # re-pad only atoms the converter recorded as vocab-stripped: a
                # bare dim-0 mismatch (another layer count) stays an error
                if (stripped_to is not None and arr.ndim == len(want) and arr.ndim >= 1
                        and arr.shape[0] == stripped_to and arr.shape[0] < want[0]
                        and tuple(arr.shape[1:]) == want[1:]):
                    pad = np.zeros((want[0] - arr.shape[0], ) + tuple(arr.shape[1:]), arr.dtype)
                    logger.info(f"universal load: re-padded {key} dim0 {arr.shape[0]} -> "
                                f"{want[0]} (vocab padding)")
                    arr = np.concatenate([arr, pad], axis=0)
                else:
                    raise ValueError(f"universal atom {key} shape {arr.shape} != model {want}")
            return arr

        if self._offload_state is not None:
            host = self._offload_state
            cur = host.state_dict() if load_optimizer_states else None
            any_moment = False
            sd = {"m": {}, "v": {}, "step": int(passthrough.get("opt_state.step", 0))}
            for key, shape in self._offload_shapes.items():
                a = atoms.get(key)
                if a is None:
                    logger.warning(f"universal load: no atom for param {key}; keeping current")
                    a = {}
                else:
                    host.params[key].copy_(torch.from_numpy(
                        fit(a[PARAM_ATOM], shape, key).astype(np.float32).ravel()))
                if load_optimizer_states:
                    for atom_name, slot in (("exp_avg", "m"), ("exp_avg_sq", "v")):
                        if atom_name in a:
                            sd[slot][key] = fit(a[atom_name], shape, key).ravel()
                            any_moment = True
                        else:
                            sd[slot][key] = cur[slot][key]
                    extra = sorted(set(a) - {PARAM_ATOM, "exp_avg", "exp_avg_sq"})
                    if a and (extra or "exp_avg" not in a):
                        logger.warning(f"universal load (offload): param {key} has atoms "
                                       f"{sorted(a)} but the host-offload Adam consumes "
                                       f"exp_avg/exp_avg_sq only - unmatched moments keep "
                                       f"their current values")
            if load_optimizer_states and any_moment:
                host.load_state_dict(sd)
            if "torch_rng" in passthrough:
                self._load_generator(passthrough["torch_rng"], "universal")
            self._push_compute_params()
        else:
            def leaf(key, cur):
                arr = lookup(key)
                if arr is None:
                    skip = (not load_optimizer_states) and key.split(".")[0] in ("opt_state",
                                                                                 "loss_scale")
                    if not skip:
                        logger.warning(f"universal load: no atom/passthrough for {key}; "
                                       f"keeping current value")
                    return cur
                if key == "torch_rng":
                    self._load_generator(arr, "universal")
                    return cur
                want = tuple(cur.shape) if isinstance(cur, (torch.Tensor, np.ndarray)) else ()
                return _restore_leaf(fit(np.asarray(arr), want, key), cur, key, self.device)

            saved = map_with_keys(leaf, self._saved_state())
            self.state = TrainState(step=saved.step, params=saved.params,
                                    opt_state=saved.opt_state, loss_scale=saved.loss_scale)
        logger.info(f"loaded universal checkpoint from {udir} ({len(atoms)} parameter atoms)")
        return tag, data.get("client_state", {})

    @staticmethod
    def _generator_template(load_dir: str, tag: str, current: np.ndarray):
        """The ``torch_rng`` leaf to load: ``current`` (the generator's own
        state) unless the checkpoint's was written by a generator of another
        kind (a CPU generator's state does not fit a CUDA one), which is
        left out with a warning, keeping this engine's seeded generator."""
        entry = next((m for m in read_metadata(os.path.join(load_dir, tag))["manifest"]
                      if m.get("key") == "torch_rng"), None)
        if entry is not None and tuple(entry["shape"]) != current.shape:
            logger.warning(f"checkpoint {tag}: torch_rng of shape {tuple(entry['shape'])} comes "
                           f"from a generator of another device type than this engine's "
                           f"{current.shape}; keeping the engine's seeded generator")
            return None
        return current

    def _resolve_load_tag(self, load_dir: str, tag: Optional[str],
                          fallback_to_valid: bool) -> str:
        """The tag to load: the requested one (or the pinned
        ``DSTPU_RESUME_TAG``, or ``latest``) when it validates; otherwise,
        only with ``fallback_to_valid``, the newest earlier tag that does.
        A pinned tag that fails validation raises: falling back would resume
        from another tag than the pin names."""
        pinned = None
        if tag is None:
            pinned = os.environ.get(RESUME_TAG_ENV) or None
            # the pin applies to the supervised checkpoint dir only: a
            # warm-start load from an unrelated directory keeps its 'latest'
            if pinned is not None and os.path.isdir(os.path.join(load_dir, pinned)):
                resume_dir = os.environ.get(RESUME_DIR_ENV) or None
                if resume_dir is not None:
                    try:
                        inside = os.path.commonpath(
                            [os.path.realpath(load_dir), os.path.realpath(resume_dir)]
                        ) == os.path.realpath(resume_dir)
                    except ValueError:  # different drives / mixed abs-rel
                        inside = False
                    if not inside:
                        pinned = None
            else:
                pinned = None
            tag = pinned
        verify = self.config.checkpoint.verify_integrity
        requested, failure = tag, None
        try:
            requested = tag or get_latest_tag(load_dir)
            if requested is None:
                raise CheckpointError(
                    f"checkpoint dir {load_dir!r} has no 'latest' file and no tag was "
                    f"given — nothing to resume from")
            validate_checkpoint_tag(load_dir, requested, verify_integrity=verify)
            return requested
        except CheckpointError as exc:
            if pinned is not None:
                raise CheckpointError(
                    f"agent-pinned resume tag {pinned!r} failed validation on this "
                    f"rank ({exc}); refusing to fall back to a per-rank tag — all "
                    f"ranks must resume from the same checkpoint") from exc
            if not fallback_to_valid:
                raise
            failure = exc
        exclude = (requested, ) if requested else ()
        found = find_latest_valid_tag(load_dir, verify_integrity=verify, exclude=exclude)
        if found is None:
            raise CheckpointError(
                f"checkpoint dir {load_dir!r}: no valid checkpoint to fall back to "
                f"(requested tag {requested!r} failed: {failure})")
        logger.warning(f"checkpoint tag {requested!r} is unusable ({failure}); "
                       f"falling back to newest valid tag {found!r}")
        self.telemetry.record_resilience(
            "fallback_load", step=self.global_steps, samples=self.global_samples,
            requested=str(requested), fallback=found, reason=str(failure))
        return found


def _as_tensor(x) -> torch.Tensor:
    """A batch leaf (tensor, numpy array or nested list) as a tensor."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def initialize(args=None, model=None, loss_fn: Optional[Callable] = None,
               model_parameters: Any = None, training_data=None, config=None,
               device="cuda", collate_fn=None, **kwargs):
    """See ``deepspeed_tpu_torch.initialize``."""
    # ZeRO-Infinity's layer structure (deepspeed_tpu/__init__.py:113-116)
    stream_fns = {name: kwargs.pop(name, None) for name in ("layer_fn", "head_fn", "stem_fn")}
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
    # random-LTD (deepspeed_tpu/__init__.py:98-104): the state is scoped
    # around the loss function the same way; forwards that drop tokens read
    # it, and the engine ramps state["keep"] between steps
    ltd_state = None
    if cfg.data_efficiency.enabled and cfg.data_efficiency.data_routing.enabled:
        from .data_pipeline.random_ltd import RandomLTDScheduler
        scheduler = RandomLTDScheduler(cfg.data_efficiency.data_routing.random_ltd)
        ltd_state = {"keep": scheduler.current_tokens, "scheduler": scheduler}
        fn = transformer.scoped_random_ltd(fn, ltd_state)
        logger.info(f"data_routing: random-LTD scoped as this engine's token-drop state (keep "
                    f"ramps {scheduler.min_tokens}->{scheduler.max_tokens} over "
                    f"{scheduler.total_steps} steps); the engine warns after step 1 if the loss "
                    f"function never engaged it")
    engine = Engine(fn, model_parameters, cfg, device=device, ltd_state=ltd_state, **stream_fns)
    dataloader = None
    if training_data is not None:
        from .dataloader import CurriculumDataLoader, DeepSpeedDataLoader
        curriculum = cfg.effective_curriculum()
        if curriculum is not None:
            dataloader = CurriculumDataLoader(
                training_data, batch_size=engine.train_batch_size,
                gradient_accumulation_steps=engine.gradient_accumulation_steps,
                curriculum=curriculum,
                seed=cfg.data_efficiency.seed if cfg.data_efficiency.enabled else cfg.seed,
                collate_fn=collate_fn)
            logger.info(f"data_efficiency: curriculum data sampler active (schedule="
                        f"{curriculum.get('schedule_type', curriculum.get('curriculum_type'))}, "
                        f"min={curriculum.get('min_difficulty')}, "
                        f"max={curriculum.get('max_difficulty')})")
        else:
            dataloader = DeepSpeedDataLoader(training_data, batch_size=engine.train_batch_size,
                                             seed=cfg.seed, collate_fn=collate_fn)
    return engine, engine.optimizer, dataloader, engine.lr_scheduler

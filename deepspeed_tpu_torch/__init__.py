"""PyTorch/CUDA port of ``deepspeed_tpu``.

Kept beside the JAX package, with its module paths and names, and
independent of it: nothing here imports ``jax`` or ``deepspeed_tpu``.  Plain
tensor code is PyTorch; every Pallas kernel of the JAX package becomes a
kernel written by hand for Hopper (``csrc/``), built at first use.  Entry
points run on ``device="cuda"`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from . import comm
from .comm import init_distributed
from .parallel.mesh import MeshTopology
from .runtime.checkpointing import CheckpointError
from .runtime.config import TrainingConfig, load_config
from .runtime.dataloader import DeepSpeedDataLoader, RepeatingLoader


def initialize(args=None, model=None, loss_fn=None, model_parameters=None, training_data=None,
               config=None, device="cuda", collate_fn=None, dist_init_required=None, **kwargs):
    """Build a training engine (``deepspeed_tpu.initialize``): one GPU, or
    data-parallel ranks of a process group.

    The model is a loss function ``loss_fn(params, batch, rng) -> loss`` over
    a params tree of tensors (nested dicts), e.g.
    ``models.llama.make_loss_fn(config)`` with ``models.llama.init_params``.
    Returns ``(engine, optimizer, dataloader, lr_scheduler)``: with
    ``training_data`` (an indexable dataset, e.g. an ``MMapIndexedDataset``
    or anything with ``__len__``/``__getitem__``) the dataloader yields
    global batches of numpy arrays (a ``DeepSpeedDataLoader``, or a
    ``CurriculumDataLoader`` under a curriculum schedule, batched by
    ``collate_fn`` when given), else it is None.  The engine trains with
    ``train_batch`` or ``forward``/``backward``/``step``, and saves and
    resumes with ``save_checkpoint``/``load_checkpoint`` (files the JAX
    package reads and writes too).  The engine runs on ``device`` ("cuda"
    unless the caller passes "cpu") and raises when asked for CUDA without a
    GPU.  Under ``zero_optimization.offload_param: {device: nvme}`` the
    layers stream from disk: pass ``layer_fn(params_l, x) -> x``,
    ``head_fn(head_params, x, labels) -> loss`` and optionally
    ``stem_fn(stem_params, tokens) -> x``, with ``model_parameters`` a dict
    holding the stacked ``layers`` (and ``stem``) beside the head's leaves.

    Before the engine, the config's ``fault_tolerance`` retry defaults and
    collective timeout are applied and ``init_distributed`` runs (unless
    ``dist_init_required`` is False): it starts the process group from the
    launcher's env (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``; ``gloo`` for a
    CPU engine, ``nccl`` for a CUDA one) and is a no-op in a single process
    or when a group is already up.  Above one rank the engine trains
    data-parallel over the ``mesh`` section's ``data`` axis: each rank passes
    the same global batch and keeps its own rows; the dataloader yields the
    global batch.
    """
    from .runtime.engine import initialize as _initialize
    return _initialize(args=args, model=model, loss_fn=loss_fn,
                       model_parameters=model_parameters, training_data=training_data,
                       config=config, device=device, collate_fn=collate_fn,
                       dist_init_required=dist_init_required, **kwargs)


def init_inference(model_module=None, model_config=None, params=None, config=None,
                   hf_model=None, **kwargs):
    """Build the v1 inference engine (``deepspeed_tpu.init_inference``): pass
    (model_module, model_config, params), e.g. ``models.llama`` with its
    config and params, or a HF Llama/Mistral model as ``hf_model``.  The
    engine runs on ``device`` ("cuda" unless the caller passes
    ``device="cpu"``) and raises when asked for CUDA without a GPU; with
    ``{"quant": {"enabled": True, "bits": 8}}`` its weights live packed."""
    from .inference.engine import init_inference as _init_inference
    return _init_inference(model_module=model_module, model_config=model_config, params=params,
                           config=config, hf_model=hf_model, **kwargs)


def add_config_arguments(parser):
    """Add the ``--deepspeed`` and ``--deepspeed_config`` arguments to an
    ``argparse`` parser (``deepspeed_tpu.add_config_arguments``)."""
    group = parser.add_argument_group("DeepSpeed-TPU", "DeepSpeed-TPU configurations")
    group.add_argument("--deepspeed", default=False, action="store_true")
    group.add_argument("--deepspeed_config", default=None, type=str)
    return parser

"""PyTorch/CUDA port of ``deepspeed_tpu``.

Kept beside the JAX package, with its module paths and names, and
independent of it: nothing here imports ``jax`` or ``deepspeed_tpu``.  Plain
tensor code is PyTorch; every Pallas kernel of the JAX package becomes a
kernel written by hand for Hopper (``csrc/``), built at first use.  Entry
points run on ``device="cuda"`` unless the caller asks for the CPU.
"""


def initialize(args=None, model=None, loss_fn=None, model_parameters=None, training_data=None,
               config=None, device="cuda", **kwargs):
    """Build a single-GPU training engine (``deepspeed_tpu.initialize``).

    The model is a loss function ``loss_fn(params, batch, rng) -> loss`` over
    a params tree of tensors (nested dicts), e.g.
    ``models.llama.make_loss_fn(config)`` with ``models.llama.init_params``.
    Returns ``(engine, optimizer, None, lr_scheduler)``: the dataloader is not
    ported, and ``training_data`` raises ``NotImplementedError``.  The engine
    runs on ``device`` ("cuda" unless the caller passes "cpu") and raises when
    asked for CUDA without a GPU.
    """
    from .runtime.engine import initialize as _initialize
    return _initialize(args=args, model=model, loss_fn=loss_fn,
                       model_parameters=model_parameters, training_data=training_data,
                       config=config, device=device, **kwargs)


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

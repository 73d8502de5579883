"""v2 engine factory: assemble a ragged serving engine for a known family,
from ready params or from a HuggingFace model.

Counterpart of ``deepspeed_tpu/inference/v2/engine_factory.py``.  The port
serves ``llama``, ``mistral`` (sliding window), ``mixtral`` (MoE), ``opt``,
``qwen2`` and ``gptj``; ``falcon`` and ``phi`` wait for the paged kernel to
take their heads (a GQA group of 71, head dim 80).  BLOOM serves through the
v1 engine (ALiBi needs the biased dense attention).
"""

from typing import Any, Dict, Optional

from ...models import gptj, llama, mistral, mixtral, opt, qwen
from .engine_v2 import InferenceEngineV2

# model_type -> model module (each defines ``config_from_hf``)
REGISTRY = {
    "llama": llama,
    "mistral": mistral,
    "mixtral": mixtral,
    "opt": opt,
    "qwen2": qwen,
    "gptj": gptj,
}


def _lookup(model_type: str):
    if model_type not in REGISTRY:
        raise ValueError(f"v2 serving supports {sorted(REGISTRY)}; got {model_type!r}")
    return REGISTRY[model_type]


def build_engine(model_type: str, model_config, params, config: Optional[Dict] = None,
                 **engine_kwargs) -> InferenceEngineV2:
    """Assemble a v2 engine for a known model family with ready params.
    ``engine_kwargs`` go to :class:`InferenceEngineV2` (``device`` defaults to
    ``"cuda"``)."""
    return InferenceEngineV2(_lookup(model_type), model_config, params, config=config, **engine_kwargs)


def build_hf_engine(hf_model_or_path: Any, config: Optional[Dict] = None,
                    **engine_kwargs) -> InferenceEngineV2:
    """A v2 engine from a ``transformers`` causal-LM instance, or from a
    local directory that ``transformers`` loads (imported only then; it is
    never asked to download).  The family comes from ``config.model_type``
    and the weights from the model's state dict."""
    if isinstance(hf_model_or_path, str):
        try:
            import transformers
        except ImportError as err:
            raise ImportError("build_hf_engine: loading a checkpoint directory needs the "
                              "transformers package; pass a model instance instead") from err
        hf_model = transformers.AutoModelForCausalLM.from_pretrained(hf_model_or_path,
                                                                     local_files_only=True)
    else:
        hf_model = hf_model_or_path
    module = _lookup(hf_model.config.model_type)
    model_config = module.config_from_hf(hf_model.config)
    params = module.from_hf_state_dict(model_config, hf_model.state_dict())
    return InferenceEngineV2(module, model_config, params, config=config, **engine_kwargs)

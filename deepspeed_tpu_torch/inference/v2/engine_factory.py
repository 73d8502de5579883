"""v2 engine factory: assemble a ragged serving engine for a known family.

Counterpart of ``deepspeed_tpu/inference/v2/engine_factory.py::build_engine``;
the port serves ``"llama"`` and ``"mistral"`` so far.
"""

from typing import Dict, Optional

from ...models import llama, mistral
from .engine_v2 import InferenceEngineV2

REGISTRY = {"llama": llama, "mistral": mistral}


def build_engine(model_type: str, model_config, params, config: Optional[Dict] = None,
                 **engine_kwargs) -> InferenceEngineV2:
    """Assemble a v2 engine for a known model family with ready params.
    ``engine_kwargs`` go to :class:`InferenceEngineV2` (``device`` defaults to
    ``"cuda"``)."""
    if model_type not in REGISTRY:
        raise ValueError(f"v2 serving supports {sorted(REGISTRY)}; got {model_type!r}")
    return InferenceEngineV2(REGISTRY[model_type], model_config, params, config=config,
                             **engine_kwargs)

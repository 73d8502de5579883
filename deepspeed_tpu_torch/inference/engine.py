"""The v1 inference engine (prefill, then decode over a dense KV cache) and
the token selection shared with the v2 engine.

Counterpart of ``deepspeed_tpu/inference/engine.py`` on one GPU.  The JAX
engine jits two programs, prefill and decode, over ``forward_with_cache``;
here both are the same eager call, the KV cache is written in place and its
length stays a host int.  With ``quant.enabled`` the weights live packed on
the device (``inference/quantization.py``: int8 through the hand-written
quantize kernel, or int4) and the forward dequantizes one layer at a time.
JAX's threefry keys become an explicit ``torch.Generator``; the two never
draw the same bits, so sampled outputs agree with the JAX package in
distribution, not token for token.  Not ported: tensor parallelism
(``topology``, ``tp_rules``, ``tp_size > 1``: ROADMAP Queue 1 item 11).
"""

import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..runtime.engine import resolve_device
from ..runtime.tree import tree_map
from .config import DTYPES, InferenceConfig, load_inference_config
from .quantization import is_woq_leaf, quantize_tree

logger = logging.getLogger(__name__)


class InferenceEngine:
    """Serve a model-family module (``models.llama``-style: ``init_cache`` and
    ``forward_with_cache``) with incremental decoding on ``device`` ("cuda"
    unless the caller passes "cpu"; CUDA without a GPU raises)."""

    def __init__(self, model_module, model_config, params, config: Optional[Dict] = None,
                 device="cuda", topology=None, tp_rules: Optional[Callable] = None,
                 attention_fn: Optional[Callable] = None):
        if topology is not None or tp_rules is not None:
            raise NotImplementedError("InferenceEngine(topology=..., tp_rules=...): the PyTorch "
                                      "port serves on one GPU; TP serving is ROADMAP Queue 1 "
                                      "item 11")
        self.config: InferenceConfig = load_inference_config(config)
        self.device = resolve_device(device)
        self.model = model_module
        self.model_config = model_config
        self.dtype = DTYPES[self.config.dtype]
        self.attention_fn = attention_fn
        quant = self.config.quant
        if quant.enabled:
            # packed leaf by leaf on the device; the engine keeps no reference
            # to the caller's dense weights
            params = quantize_tree(params, bits=quant.bits, group_size=quant.group_size,
                                   device=self.device, dtype=self.dtype)
        # leaves that are not packed serve in the configured dtype, or fp32
        # norms would promote the whole forward (engine.py:70-72)
        self.params = tree_map(
            lambda x: x if is_woq_leaf(x) else x.to(device=self.device, dtype=self.dtype), params)
        logger.info(f"InferenceEngine: device={self.device} dtype={self.config.dtype} "
                    f"quant={'int%d' % quant.bits if quant.enabled else 'off'}")

    def _prefill(self, ids, max_seq):
        cache = self.model.init_cache(self.model_config, ids.shape[0], max_seq, dtype=self.dtype,
                                      device=self.device)
        return self.model.forward_with_cache(self.model_config, self.params, ids, cache,
                                             attention_fn=self.attention_fn)

    @torch.no_grad()
    def forward(self, input_ids):
        """One full forward of ``input_ids`` [B, S]: logits [B, S, V]."""
        ids = torch.as_tensor(np.asarray(input_ids), device=self.device)
        return self._prefill(ids, ids.shape[1])[0]

    __call__ = forward

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, eos_token_id: Optional[int] = None,
                 seed: Optional[int] = None):
        """Autoregressive generation from prompts ``input_ids`` [B, S]; returns
        np.ndarray [B, S + new].  Tokens stay on the device until the end, so
        a decode step fetches nothing unless ``eos_token_id`` is given."""
        prompt = np.asarray(input_ids)
        b, s = prompt.shape
        new = max_new_tokens if max_new_tokens is not None else self.config.max_out_tokens
        if new <= 0:
            return prompt
        cfg = self.config
        temperature = cfg.temperature if temperature is None else temperature
        top_k = cfg.top_k if top_k is None else top_k
        top_p = cfg.top_p if top_p is None else top_p
        model_max = getattr(self.model_config, "max_seq_len", None)
        max_seq = cfg.max_seq_len or (s + new)
        if model_max is not None:
            max_seq = min(max_seq, model_max)
        if s + new > max_seq:
            raise ValueError(f"prompt ({s}) + max_new_tokens ({new}) exceeds max_seq_len {max_seq} "
                             f"(model rotary table covers {model_max} positions)")
        generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed if seed is None else seed)
        pick = lambda logits: _sample(logits[:, -1], generator, temperature=temperature,
                                      top_k=top_k, top_p=top_p)
        logits, cache = self._prefill(torch.as_tensor(prompt, device=self.device), max_seq)
        tok = pick(logits)
        out = [tok]
        for _ in range(new - 1):
            logits, cache = self.model.forward_with_cache(self.model_config, self.params,
                                                          tok[:, None], cache,
                                                          attention_fn=self.attention_fn)
            tok = pick(logits)
            out.append(tok)
            if eos_token_id is not None and bool((tok == eos_token_id).all()):
                break
        gen = torch.stack(out, dim=1).cpu().numpy().astype(prompt.dtype)
        return np.concatenate([prompt, gen], axis=1)


def _filter_logits(logits, *, temperature, top_k, top_p):
    """Temperature scaling + top-k / top-p masking in fp32: the one filtered
    target distribution the sampler draws from.  ``temperature == 0`` must be
    handled by the caller (greedy argmax, no filtering)."""
    logits = logits.float() / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, -1e30, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, -1e30, logits)
    return logits


def _sample(logits, generator: torch.Generator, *, temperature, top_k, top_p):
    """Temperature / top-k / top-p sampling of one token per row; greedy at
    T=0.  Returns int32 token ids [N]."""
    if temperature == 0.0:
        return torch.argmax(logits.float(), dim=-1).to(torch.int32)
    logits = _filter_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def init_inference(model_module=None, model_config=None, params=None, config=None,
                   hf_model=None, **kwargs) -> InferenceEngine:
    """``deepspeed.init_inference`` analog: pass (model_module, model_config,
    params), or a HF LlamaForCausalLM/MistralForCausalLM as ``hf_model``,
    converted with ``models.llama.from_hf_state_dict``.  Keyword arguments go
    to :class:`InferenceEngine` (``device`` among them)."""
    if hf_model is not None:
        from ..models import llama
        model_module = llama
        model_config = llama.config_from_hf(hf_model.config)
        params = llama.from_hf_state_dict(model_config, hf_model.state_dict())
    if model_module is None or params is None:
        raise ValueError("init_inference needs (model_module, model_config, params) or hf_model")
    return InferenceEngine(model_module, model_config, params, config=config, **kwargs)

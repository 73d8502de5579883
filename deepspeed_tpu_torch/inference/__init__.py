"""Serving: the v1 engine (``init_inference``) and the v2 ragged engine (``v2``)."""

from .engine import InferenceEngine, init_inference

__all__ = ["InferenceEngine", "init_inference"]

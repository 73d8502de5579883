"""Profiling tools (JAX ``deepspeed_tpu/profiling/``)."""
from .flops_profiler import FlopsProfiler, ProfileResult, get_model_profile, profile_fn

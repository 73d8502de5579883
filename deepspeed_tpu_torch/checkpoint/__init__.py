"""Checkpoint conversion tools (``deepspeed_tpu/checkpoint``)."""
from .universal import ds_to_universal, load_universal, zero_to_fp32

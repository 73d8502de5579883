"""Fused optimizer kernels: AdamW and Lion over flat buffers, AdamW-8bit."""

from .fused_adam import fused_adamw_flat, fused_lion_flat

__all__ = ["fused_adamw_flat", "fused_lion_flat"]

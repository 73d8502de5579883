"""Compression library (JAX ``deepspeed_tpu/compression/``)."""
from .basic_layer import (QuantAct, channel_prune_mask, head_prune_mask, layer_reduction,
                          shrink_rows)
from .compress import (CompressionScheduler, fake_quantize, init_compression, redundancy_clean,
                       row_prune_mask, sparse_prune_mask)

"""Block-sparse attention (counterpart of ``deepspeed_tpu/ops/sparse_attention``).

The layout generators (``sparsity_config.py``) and one set of hand-written
CUDA kernels (``attention.py`` over ``csrc/sparse_attention.cu``): forward,
dK/dV and dQ, each walking only the live blocks of the layout.
"""

from .sparsity_config import (SparsityConfig, DenseSparsityConfig, FixedSparsityConfig,
                              VariableSparsityConfig, BigBirdSparsityConfig,
                              BSLongformerSparsityConfig, LocalSlidingWindowSparsityConfig)
from .attention import sparse_attention, make_sparse_attention_fn, pad_to_block_size

"""Host-side utilities of the port: durable IO and the CRC-framed log
(``wal.py``), tolerant environment parsing (``env.py``) and the tensor
fragment API (``tensor_fragment.py``)."""
from .tensor_fragment import (safe_get_full_fp32_param, safe_get_full_grad,
                              safe_get_full_optimizer_state, safe_set_full_fp32_param)

from .abstract_accelerator import Accelerator
from .cuda_accelerator import CudaAccelerator, get_accelerator

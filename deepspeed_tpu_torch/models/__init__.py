from . import falcon, gptj, llama, mistral, mixtral, opt, phi, qwen, transformer
from .falcon import FalconConfig
from .gptj import GPTJConfig
from .llama import LlamaConfig
from .mistral import MistralConfig
from .mixtral import MixtralConfig
from .opt import OPTConfig
from .phi import PhiConfig
from .qwen import QwenConfig

from . import gptj, llama, mistral, mixtral, opt, qwen, transformer
from .gptj import GPTJConfig
from .llama import LlamaConfig
from .mistral import MistralConfig
from .mixtral import MixtralConfig
from .opt import OPTConfig
from .qwen import QwenConfig

from . import bert, bloom, falcon, gpt2, gptj, llama, mistral, mixtral, opt, phi, qwen, transformer
from .bert import BertConfig
from .bloom import BloomConfig
from .falcon import FalconConfig
from .gpt2 import GPT2Config
from .gptj import GPTJConfig
from .llama import LlamaConfig
from .mistral import MistralConfig
from .mixtral import MixtralConfig
from .opt import OPTConfig
from .phi import PhiConfig
from .qwen import QwenConfig

from .config import TrainingConfig, ZeroConfig, load_config

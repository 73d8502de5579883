"""Elastic training's batch solver (JAX ``deepspeed_tpu/elasticity/``; the
elastic agent waits for the launcher)."""
from .elasticity import (ElasticityConfig, compute_elastic_config, get_best_candidates,
                         get_valid_gpus)

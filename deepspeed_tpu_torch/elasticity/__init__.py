"""Elastic training (JAX ``deepspeed_tpu/elasticity/``): the batch solver
and the elastic agent; the command is ``python -m
deepspeed_tpu_torch.elasticity``."""
from .elastic_agent import DSElasticAgent, WorkerGroup, select_consensus_tag
from .elasticity import (ElasticityConfig, compute_elastic_config, get_best_candidates,
                         get_valid_gpus)

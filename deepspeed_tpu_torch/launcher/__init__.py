"""Cluster launcher (JAX ``deepspeed_tpu/launcher/``): ``runner`` is the
CLI over a hostfile, ``launch`` the per-node entry that starts one process
per local GPU."""
from .runner import (MultiNodeRunner, PDSHRunner, SSHRunner, encode_world_info, decode_world_info,
                     fetch_hostfile, parse_inclusion_exclusion)

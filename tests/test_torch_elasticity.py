"""The port's elastic batch solver against the JAX package's, on JAX's own
cases (``tests/unit/test_elasticity.py``): the same valid GPU counts, best
batch, micro-batch and errors."""

import pytest

from deepspeed_tpu import elasticity as jel
from deepspeed_tpu_torch import elasticity as el
from deepspeed_tpu_torch.runtime.config import load_config

BASE = {"elasticity": {"enabled": True, "max_train_batch_size": 10000,
                       "micro_batch_sizes": [8, 12, 16, 17], "min_gpus": 32,
                       "max_gpus": 1500}}


@pytest.mark.parametrize("args", [(24, [2, 3], 1, 100), (24, [2, 2, 3, 3, 2], 1, 100),
                                  (24, [2, 3], 10, 4), (7, [2, 4], 1, 100)])
def test_valid_gpus_match_jax(args):
    assert el.get_valid_gpus(*args) == jel.get_valid_gpus(*args)


@pytest.mark.parametrize("args", [(10000, [8, 12, 16, 17], 32, 1500), (100, [2, 4], 50, 10),
                                  (512, [4, 6], 1, 64, False)])
def test_best_candidates_match_jax(args):
    assert el.get_best_candidates(*args) == jel.get_best_candidates(*args)


def test_compute_elastic_config_matches_jax():
    batch, valid = el.compute_elastic_config(BASE)
    assert (batch, valid) == jel.compute_elastic_config(BASE)
    w = valid[len(valid) // 2]
    assert el.compute_elastic_config(BASE, world_size=w, return_microbatch=True) == \
        jel.compute_elastic_config(BASE, world_size=w, return_microbatch=True)
    # the training config's elasticity section is the solver's input
    conf = load_config({"train_micro_batch_size_per_gpu": 1, **BASE})
    assert el.compute_elastic_config({"elasticity": conf.elasticity}) == (batch, valid)


@pytest.mark.parametrize("conf,world", [(BASE, 31), ({"elasticity": {"enabled": False}}, 0),
                                        ({}, 0)])
def test_refusals_match_jax(conf, world):
    with pytest.raises(ValueError) as want:
        jel.compute_elastic_config(conf, world_size=world)
    with pytest.raises(ValueError) as got:
        el.compute_elastic_config(conf, world_size=world)
    assert str(got.value) == str(want.value)

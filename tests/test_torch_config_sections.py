"""Every field of the JAX package's ``TrainingConfig`` loads in the port's:
each field, with a value JAX accepts, loads the same value in both, and the
fields that need more than one GPU raise ``NotImplementedError`` naming
ROADMAP item 11 where JAX acts on them.  A bad value raises the same
``ValueError`` in both."""

import pytest

from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu_torch.runtime import config

BASE = {"train_micro_batch_size_per_gpu": 1}
JAX_FIELDS = sorted(jconfig.TrainingConfig._fields)

# a value away from the default for the fields this slice added
SAMPLES = {
    "mesh": {"data": 1, "tensor": 1, "axis_order": ["data", "pipe", "fsdp", "expert", "sequence",
                                                     "tensor"]},
    "serving_resilience": {"max_queue_depth": 8, "shed_kv_utilization": 0.9},
    "serving_fastpath": {"pipeline_depth": 0, "fusion_min_steps": 4},
    "serving_spec_decode": {"enabled": True, "k": 6},
    "serving_tracing": {"enabled": True},
    "serving_fault_tolerance": {"fsync_every": 0},
    "serving_kv_observability": {"invariant_check": False},
    "serving_prefix_cache": {"enabled": False},
    "serving_perf": {"enabled": True, "hbm_gbps_spec": 2000.0},  # defaults differ by chip
    "serving_fleet": {"enabled": False},
    "serving_qos": {"enabled": True},
    "elasticity": {"enabled": True, "max_train_batch_size": 64, "micro_batch_sizes": [2, 4]},
    "comms_logger": {"verbose": True, "prof_ops": ["all_reduce"]},
    "prescale_gradients": True,
    "gradient_predivide_factor": 2.0,
    "sparse_gradients": True,
    "communication_data_type": "fp32",
    "gradient_compression": {"enabled": True, "freeze_step": 10},
    "flops_profiler": {"enabled": True, "profile_step": 3, "top_modules": 5},
    "dump_state": True,
    "autotuning": {"enabled": False, "fast": True},
}
# what JAX acts on with more than one device: the port raises naming item 11
MULTI_GPU = {"mesh": [{"data": 2}, {"data": -1, "tensor": 2}],
             "comms_logger": [{"enabled": True}]}


def _value(field):
    if field in SAMPLES:
        return SAMPLES[field]
    default = getattr(jconfig.TrainingConfig(**BASE), field)
    return default.to_dict() if hasattr(default, "to_dict") else default


def _plain(v):
    return v.to_dict() if hasattr(v, "to_dict") else v


def test_the_port_has_every_jax_field():
    assert set(JAX_FIELDS) <= set(config.TrainingConfig._fields)
    assert config.UNPORTED_TRAINING_SECTIONS == ()


@pytest.mark.parametrize("field", JAX_FIELDS)
def test_every_jax_training_field_loads(field):
    value = _value(field)
    want = jconfig.load_config({**BASE, field: value})
    got = config.load_config({**BASE, field: value})
    if field in SAMPLES:
        assert _plain(getattr(got, field)) == _plain(getattr(want, field))
    for wide in MULTI_GPU.get(field, ()):
        jconfig.load_config({**BASE, field: wide})  # JAX acts on it
        with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
            config.load_config({**BASE, field: wide})


@pytest.mark.parametrize("bad", [{"gradient_predivide_factor": 0.0},
                                 {"flops_profiler": {"top_modules": 0}},
                                 {"flops_profiler": {"profile_step": -1}},
                                 {"gradient_compression": {"freeze_step": -1}},
                                 {"mesh": {"data": 0}},
                                 {"mesh": {"data": -1, "fsdp": -1}},
                                 {"mesh": {"axis_order": ["data", "data"]}},
                                 {"mesh": {"axis_order": ["rows"]}},
                                 {"serving_fastpath": {"pipeline_depth": 2}},
                                 {"serving_spec_decode": {"drafter": "oracle"}}],
                         ids=lambda b: next(iter(b)))
def test_bad_values_raise_as_in_jax(bad):
    with pytest.raises(ValueError) as want:
        jconfig.load_config({**BASE, **bad})
    with pytest.raises(ValueError) as got:
        config.load_config({**BASE, **bad})
    assert str(got.value) == str(want.value)


def test_jax_zero_aliases_are_dropped():
    extra = {"zero_allow_untested_optimizer": True, "zero_force_ds_cpu_optimizer": False}
    assert config.load_config({**BASE, **extra}).train_micro_batch_size_per_gpu == 1


def _section(tp):
    import typing
    return next((a for a in (typing.get_args(tp) or (tp, ))
                 if isinstance(a, type) and hasattr(a, "_fields")), None)


def test_every_jax_section_field_exists_in_the_port():
    missing = []

    def walk(jax_model, port_model, path):
        for name, (tp, _) in jax_model._fields.items():
            if name not in port_model._fields:
                missing.append(path + name)
                continue
            jsec, psec = _section(tp), _section(port_model._fields[name][0])
            if jsec is not None and psec is not None:
                walk(jsec, psec, f"{path}{name}.")

    walk(jconfig.TrainingConfig, config.TrainingConfig, "")
    assert missing == []


def test_zero_section_takes_jax_spellings():
    section = {"stage": 3, "stage3_prefetch_bucket_size": 123, "reduce_bucket_size": 7,
               "mics_shard_size_": 4, "zero_quantized_weights": True}
    want = jconfig.load_config({**BASE, "zero_optimization": section}).zero_optimization
    got = config.load_config({**BASE, "zero_optimization": section}).zero_optimization
    for name in ("stage", "prefetch_bucket_size", "reduce_bucket_size", "mics_shard_size",
                 "zero_quantized_weights", "overlap_comm"):
        assert getattr(got, name) == getattr(want, name), name

"""The port's accelerator, timers, logging, comms logging and environment
report against the JAX package's on the CPU, and the repaired
``steps_per_print`` line and events of the training engine.

``CudaAccelerator(device="cpu")`` answers as ``TpuAccelerator`` does on the
CPU where both define a method; ``get_accelerator()`` raises here, where
there is no GPU.  ``calc_bw_log`` and ``CommsLogger`` are the same host
arithmetic.  The engine's line carries JAX's fields in JAX's order, in fp32
and in fp16 (``loss_scale=``), with ``samples/sec=`` from the throughput
timer, and writes the ``Train/Samples/samples_per_sec`` event when
telemetry is off."""

import logging
import time

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.accelerator import TpuAccelerator
from deepspeed_tpu.utils import comms_logging as jcomms
from deepspeed_tpu_torch.accelerator import Accelerator, CudaAccelerator, get_accelerator
from deepspeed_tpu_torch.utils import comms_logging as pcomms
from deepspeed_tpu_torch.utils import logging as plogging
from deepspeed_tpu_torch.utils.timer import NoopTimer, SynchronizedWallClockTimer, ThroughputTimer


@pytest.fixture
def accs():
    return CudaAccelerator(device="cpu"), TpuAccelerator()


def test_cpu_accelerator_answers_as_the_tpu_accelerator_on_the_cpu(accs):
    ours, theirs = accs
    assert isinstance(ours, Accelerator)
    import deepspeed_tpu.accelerator.abstract_accelerator as jabs
    assert Accelerator.__abstractmethods__ == jabs.Accelerator.__abstractmethods__
    public = {n for n in dir(TpuAccelerator) if not n.startswith("_")}
    assert public <= {n for n in dir(CudaAccelerator) if not n.startswith("_")}
    for name, args in (("device_name", ()), ("device_name", (0,)), ("device_name", (3,)),
                       ("is_available", ()), ("is_bf16_supported", ()),
                       ("is_fp16_supported", ()), ("is_triton_supported", ()),
                       ("memory_allocated", ()), ("max_memory_allocated", ()),
                       ("total_memory", ()), ("available_memory", ()),
                       ("get_device_properties", ())):
        assert getattr(ours, name)(*args) == getattr(theirs, name)(*args), name
    assert ours.device_count() == 1 and ours.current_device_name() == "cpu:0"
    assert [str(d).split(".")[-1] for d in ours.supported_dtypes()] == \
        [str(np.dtype(d)) for d in theirs.supported_dtypes()]
    strided = np.ones((3, 4), np.float32)[:, ::2]
    for acc in accs:
        pinned = acc.pin_memory(strided)
        assert acc.is_pinned(pinned) and not acc.is_pinned(strided)
        np.testing.assert_array_equal(pinned, strided)
    assert ours.on_accelerator(torch.ones(2)) and not ours.on_accelerator(np.ones(2))
    assert ours.communication_backend_name() == "gloo"  # CUDA's is nccl (tested on the card)


def test_cpu_streams_and_events_are_the_host_stand_ins(accs):
    for acc in accs:
        with acc.stream(acc.Stream()) as s:
            s.synchronize()
        acc.current_stream().synchronize()
        acc.synchronize()
        start, end = acc.Event(enable_timing=True), acc.Event(enable_timing=True)
        with pytest.raises(RuntimeError, match="both events"):
            start.elapsed_time(end)
        start.record()
        time.sleep(0.02)
        end.record()
        end.synchronize()
        assert 15.0 <= start.elapsed_time(end) < 2000.0  # milliseconds


def test_cpu_accelerator_refuses_graphs_and_get_accelerator_refuses_the_cpu(accs):
    ours, _ = accs
    with pytest.raises(RuntimeError, match="CUDA graphs need a CUDA device"):
        ours.create_graph()
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_accelerator()


def test_op_builders_resolve_to_the_build_libraries():
    from deepspeed_tpu_torch.ops import _build
    acc = CudaAccelerator(device="cpu")
    assert acc.op_builder_dir() == "deepspeed_tpu_torch.ops._build"
    for class_name, stem in (("CPUAdamBuilder", "cpu_adam"), ("AsyncIOBuilder", "aio"),
                             ("FlashAttentionBuilder", "flash_attention"),
                             ("fused_adam", "fused_adam")):
        builder = acc.create_op_builder(class_name)
        assert builder.name == stem and builder.lib_path() == str(_build.library_path(stem))
    assert sorted(b.name for b in _build.BUILDERS.values()) == sorted(_build.library_names())
    with pytest.raises(ValueError, match="no op builder"):
        acc.get_op_builder("NoSuchBuilder")


def test_rng_seed_and_state_round_trip():
    acc = CudaAccelerator(device="cpu")
    gen = acc.random_seed(7)
    state = acc.get_rng_state(gen)
    a = torch.rand(3, generator=gen)
    acc.set_rng_state(state, gen)
    assert torch.equal(a, torch.rand(3, generator=gen))


# ---------------------------------------------------------- comms logging
OPS = ("all_gather", "reduce_scatter", "all_to_all", "all_reduce", "broadcast", "send", "recv")


@pytest.mark.parametrize("n", [1, 2, 4, 8, 64])
def test_calc_bw_log_equals_jax_s(n):
    for op in OPS:
        for size, dur in ((1 << 20, 1e-3), (12345, 3e-6), (1 << 30, 0.25), (0, 0.0)):
            assert pcomms.calc_bw_log(op, size, dur, n) == jcomms.calc_bw_log(op, size, dur, n)


def test_comms_logger_records_summary_and_events_equal_jax_s():
    class Cfg:
        enabled, verbose, prof_all, prof_ops, debug = True, True, False, ["all_reduce"], False

    loggers = (pcomms.CommsLogger(), jcomms.CommsLogger())
    for lg in loggers:
        lg.configure(Cfg())
        assert lg.should_profile("all_reduce") and not lg.should_profile("broadcast")
        for i, (op, size) in enumerate([("all_reduce", 1 << 20), ("all_gather", 4096),
                                        ("all_reduce", 1 << 20), ("all_reduce", 512)]):
            lg.append(op, f"{op}_rec", 1e-3 * (i + 1), size, 8)
        lg.record_traced("psum", 2048)
        lg.record_traced("psum", 2048)
    p, j = loggers
    assert {k: dict(v) for k, v in p.comms_dict.items()} == \
        {k: dict(v) for k, v in j.comms_dict.items()}
    assert p.as_events(5) == j.as_events(5)
    assert p.log_summary() == j.log_summary()
    assert isinstance(pcomms.get_comms_logger(), pcomms.CommsLogger)
    assert pcomms.get_comms_logger() is pcomms.get_comms_logger()


# ---------------------------------------------------------------- logging
class _Records(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def records():
    handler = _Records()
    plogging.logger.addHandler(handler)
    yield handler.messages
    plogging.logger.removeHandler(handler)
    plogging.set_rank_provider(plogging._env_rank)


def test_log_dist_filters_by_rank(records, monkeypatch):
    monkeypatch.setenv("RANK", "3")
    plogging.log_dist("everyone")
    plogging.log_dist("rank 0 only", ranks=[0])
    plogging.log_dist("rank 3", ranks=[1, 3])
    plogging.log_dist("all again", ranks=[-1])
    plogging.print_rank_0("not here")
    plogging.set_rank_provider(lambda: 0)
    plogging.print_rank_0("rank 0 now")
    plogging.set_rank_provider(lambda: 1 / 0)  # a failing provider reads rank 0
    plogging.log_dist("fallback", ranks=[0])
    assert records == ["[Rank 3] everyone", "[Rank 3] rank 3", "[Rank 3] all again",
                       "rank 0 now", "[Rank 0] fallback"]


def test_package_logger_reaches_module_loggers_and_warns_once(records):
    logging.getLogger("deepspeed_tpu_torch.runtime.engine").info("from a module")
    plogging.warning_once("only once")
    plogging.warning_once("only once")
    assert records == ["from a module", "only once"]
    assert plogging.logger.name == "deepspeed_tpu_torch" and plogging.logger.handlers


# ----------------------------------------------------------------- timers
def test_timers_read_wall_clock_and_throughput(records):
    timers = SynchronizedWallClockTimer(device="cpu")
    timers("step").start(sync=True)
    time.sleep(0.02)
    timers("step").stop(sync=True)
    timers("step").stop()  # a stop without a start is ignored
    assert timers("step").count == 1 and timers("step").mean() >= 15.0
    timers.log(["step", "absent"], normalizer=2.0)
    assert records[-1].startswith("[Rank 0] time (ms) | step: ") and "absent" not in records[-1]
    assert timers("step").elapsed() == 0.0  # reset by log
    noop = NoopTimer()
    noop("x").start()
    noop("x").stop()
    assert noop("x").elapsed() == 0.0
    tp = ThroughputTimer(batch_size=8, start_step=2, device="cpu")
    assert tp.stop() is None
    for _ in range(4):
        tp.start()
        time.sleep(0.01)
        assert tp.stop() > 0
    assert tp.step_count == 4 and 0 < tp.avg_samples_per_sec() <= 2 * 8 / 0.02
    assert ThroughputTimer(batch_size=8).avg_samples_per_sec() == 0.0


def test_env_report_prints_a_row_for_each_library(capsys):
    from deepspeed_tpu_torch import env_report
    from deepspeed_tpu_torch.ops import _build
    assert env_report.main() == 0
    out = capsys.readouterr().out
    rows = [line.split()[0] for line in out.splitlines()
            if line.split() and line.split()[0] in _build.library_names()]
    assert rows == _build.library_names() and len(rows) == 8
    assert "Pallas" not in out and "pallas" not in out
    for needle in ("torch ....", "torch.version.cuda", "nvcc ....", "numpy", "scipy", "einops",
                   "devices ...."):
        assert needle in out, needle
    if not torch.cuda.is_available():
        assert "unavailable (get_accelerator: no CUDA device" in out


def test_add_config_arguments_matches_jax():
    import argparse

    import deepspeed_tpu
    import deepspeed_tpu_torch
    argv = ["--deepspeed", "--deepspeed_config", "ds.json"]
    ours = deepspeed_tpu_torch.add_config_arguments(argparse.ArgumentParser()).parse_args(argv)
    theirs = deepspeed_tpu.add_config_arguments(argparse.ArgumentParser()).parse_args(argv)
    assert vars(ours) == vars(theirs) == {"deepspeed": True, "deepspeed_config": "ds.json"}


# ------------------------------------------------ the steps_per_print line
def _fields(message):
    body = message.split("] ", 1)[1] if message.startswith("[Rank") else message
    return [token.split("=")[0] for token in body.split() if "=" in token]


def _train_lines(package, conf, steps=3):
    """(the step lines' messages, the events written) of ``steps`` steps of
    a tiny Llama with ``steps_per_print: 1`` in ``package``."""
    from deepspeed_tpu_torch.models import llama as pllama
    cfg = pllama.LlamaConfig.tiny(vocab=64, hidden=32, layers=1, heads=2, kv_heads=2, seq=16)
    batch = pllama.causal_lm_batch(np.random.default_rng(0).integers(0, 64, (2, 16)))
    handler = _Records()
    if package == "port":
        import deepspeed_tpu_torch
        name = "deepspeed_tpu_torch"
        engine = deepspeed_tpu_torch.initialize(
            loss_fn=pllama.make_loss_fn(cfg), config=conf, device="cpu",
            model_parameters=pllama.init_params(cfg, torch.Generator().manual_seed(0)))[0]
    else:
        import deepspeed_tpu
        from deepspeed_tpu.models import llama as jllama
        from deepspeed_tpu.parallel import MeshTopology, reset_topology
        name = "deepspeed_tpu"
        jcfg = jllama.LlamaConfig(**{f.name: getattr(cfg, f.name)
                                     for f in __import__("dataclasses").fields(jllama.LlamaConfig)
                                     if hasattr(cfg, f.name)})
        engine = deepspeed_tpu.initialize(
            loss_fn=jllama.make_loss_fn(jcfg), config=conf,
            model_parameters=jllama.init_params(jcfg, jax.random.PRNGKey(0)),
            topology=MeshTopology.from_axis_dict({"data": 1}, devices=jax.devices()[:1]))[0]
    events = []
    engine.monitor.write_events = events.extend
    logging.getLogger(name).addHandler(handler)
    try:
        for _ in range(steps):
            engine.train_batch(batch)
    finally:
        logging.getLogger(name).removeHandler(handler)
        if package == "jax":
            reset_topology()
    return [m for m in handler.messages if "step=" in m and "loss=" in m], events


@pytest.mark.parametrize("precision", ["fp32", "fp16"])
def test_steps_per_print_line_and_events_carry_jax_s_fields(precision, tmp_path):
    conf = {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 1,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "csv_monitor": {"enabled": True, "output_path": str(tmp_path), "job_name": "f6"}}
    if precision == "fp16":
        conf["fp16"] = {"enabled": True, "initial_scale_power": 8}
    else:
        conf["bf16"] = {"enabled": False}
    port_lines, port_events = _train_lines("port", conf)
    jax_lines, jax_events = _train_lines("jax", conf)
    assert len(port_lines) == len(jax_lines) == 3
    for ours, theirs in zip(port_lines, jax_lines):
        assert ours.startswith("[Rank 0] step=")
        assert _fields(ours) == _fields(theirs)
    want = ["step", "loss", "lr", "grad_norm"] + (["loss_scale"] if precision == "fp16" else []) \
        + ["samples/sec"]
    assert _fields(port_lines[-1]) == want
    tags = lambda events: [tag for tag, _, _ in events]
    assert tags(port_events) == tags(jax_events)
    assert tags(port_events).count("Train/Samples/samples_per_sec") == 3
    assert ("Train/Samples/loss_scale" in tags(port_events)) == (precision == "fp16")

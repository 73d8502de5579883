"""The port's autotuner (``deepspeed_tpu_torch.autotuning``) held against
the JAX package's on the same inputs: the memory arithmetic, the search
space (feasible stages, micro-batch candidates, experiments), the three
tuners' order of trials and winners, ``Autotuner.tune``'s records and
``write_results``' files; and the port's measured runner on a tiny Llama
on the CPU, which prunes an out-of-memory point and an invalid config and
lets any other error through.

The port's engine accumulates its grads in fp32, so its model state is 18
bytes a parameter where JAX's is 16; the search-space comparisons give the
JAX module the port's constant, and one test reads the constant off the
port engine's tensors."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from deepspeed_tpu.autotuning import autotuner as jat
from deepspeed_tpu.autotuning import (Autotuner as JAutotuner, AutotuningConfig as JConfig,
                                      GridSearchTuner as JGrid, ModelBasedTuner as JModel,
                                      ModelInfo as JInfo, RandomTuner as JRandom)
from deepspeed_tpu_torch.autotuning import autotuner as pat
from deepspeed_tpu_torch.autotuning import (Autotuner, AutotuningConfig, GridSearchTuner,
                                            ModelBasedTuner, ModelInfo, RandomTuner)
from deepspeed_tpu_torch.models import llama

GiB = 1 << 30


@pytest.fixture
def jax_layout(monkeypatch):
    """The JAX autotuner with the port's bytes a parameter."""
    for name in ("BYTES_PER_PARAM_BF16", "BYTES_PER_PARAM_GRAD", "BYTES_PER_PARAM_OPT"):
        monkeypatch.setattr(jat, name, getattr(pat, name))


@pytest.mark.parametrize("dp", [1, 2, 8])
def test_model_state_memory_is_jax_s_arithmetic_on_the_port_s_layout(jax_layout, dp):
    for p in (1_000_000, 6_738_415_616):
        assert [pat.model_state_memory(p, s, dp) for s in range(4)] == \
            [jat.model_state_memory(p, s, dp) for s in range(4)]
    mems = [pat.model_state_memory(1_000_000, s, 8) for s in range(4)]
    assert mems == sorted(mems, reverse=True)
    assert pat.model_state_memory(1_000_000, 0, dp) == 18_000_000


def test_bytes_per_param_follow_the_port_engine():
    """bf16 compute params, fp32 grads (the accumulator), fp32 master, m and
    v: what the port's engine holds for a tiny Llama in bf16 with AdamW."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.tree import tree_leaves
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab=64, hidden=32, layers=1, heads=2,
                                                     kv_heads=2, seq=16), remat=False)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    engine = deepspeed_tpu_torch.initialize(
        loss_fn=llama.make_loss_fn(cfg), model_parameters=params, device="cpu",
        config={"train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": True},
                "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}})[0]
    batch = llama.causal_lm_batch(np.random.default_rng(0).integers(0, 64, (2, 16)))
    engine.train_batch(batch)
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    n = sum(t.numel() for t in tree_leaves(engine.state.params))
    grads, _ = engine.accumulate_gradients(batch)
    state = engine.state.opt_state
    assert nbytes(engine.state.params) + nbytes({"m": state.exp_avg, "v": state.exp_avg_sq}) \
        == pat.BYTES_PER_PARAM_OPT * n
    assert nbytes(grads) == pat.BYTES_PER_PARAM_GRAD * n
    assert nbytes(engine._compute_params()) == pat.BYTES_PER_PARAM_BF16 * n


def _synthetic_runner(exp):
    """Deterministic landscape (JAX's test's): stage 2, micro 8, the cheap
    remat policy best."""
    stage = exp["zero_optimization"]["stage"]
    mbs = exp["train_micro_batch_size_per_gpu"]
    policy = exp.get("activation_checkpointing", {}).get("policy")
    thr = mbs * 10 - abs(mbs - 8) * 5
    thr += {0: 0, 1: 5, 2: 10, 3: 2}[stage]
    thr += 3 if policy == "dots_with_no_batch_dims_saveable" else 0
    return {"throughput": float(thr), "latency": 1.0 / max(thr, 1), "flops": 0.0}


# (num_params, activation bytes a micro-batch, dp, device memory, autotuning
# section, user config): JAX's test cases, the gas cap and the user's sizes
SPACES = [
    (1_000_000_000, 1 * GiB, 8, 4 * GiB, {}, {}),
    (1_000_000_000, 1 * GiB, 8, 32 * GiB, {}, {}),
    (1_000_000, 1 * GiB, 1, 10 * GiB, {}, {}),
    (1_000_000, 1 * GiB, 1, 10 * GiB, {"micro_batch_sizes": [2, 6, 64]}, {}),
    (10_000_000, 512 << 20, 4, 8 * GiB, {"fast": False}, {"optimizer": {"type": "adamw"}}),
    (1_000_000, 1 << 20, 2, 64 * GiB, {"max_train_batch_size": 32},
     {"gradient_accumulation_steps": 4}),
    (1_000_000, 1 << 20, 2, 64 * GiB, {"max_train_batch_size": 32, "min_train_batch_size": 16,
                                       "micro_batch_sizes": [1, 2, 4, 8]},
     {"gradient_accumulation_steps": 4}),
    (1_000_000, 1 << 20, 4, 64 * GiB, {"max_train_batch_size": 8, "micro_batch_sizes": [1, 2]},
     {"gradient_accumulation_steps": 4}),
    (6_738_415_616, 3 * GiB, 1, 80 * GiB, {"zero_stages": [0, 3], "fast": False},
     {"train_batch_size": 64, "autotuning": {"enabled": True}}),
]


@pytest.mark.parametrize("case", range(len(SPACES)))
def test_search_space_matches_jax(jax_layout, case):
    n, act, dp, mem, section, user = SPACES[case]
    port = Autotuner(ModelInfo(n, act), _synthetic_runner, user_config=user, dp_size=dp,
                     device_memory=mem, config=AutotuningConfig(**section))
    ref = JAutotuner(JInfo(n, act), _synthetic_runner, user_config=user, dp_size=dp,
                     device_memory=mem, config=JConfig(**section))
    assert port.feasible_stages() == ref.feasible_stages()
    for stage in range(4):
        assert port.max_micro_batch(stage) == ref.max_micro_batch(stage)
        assert port.micro_batch_candidates(stage) == ref.micro_batch_candidates(stage)
        assert port.experiments_for_stage(stage) == ref.experiments_for_stage(stage)
        assert pat.stage_tuning_space(stage, section.get("fast", True)) == \
            jat.stage_tuning_space(stage, section.get("fast", True))


def _metric(e):
    """A deterministic metric with a failed (None) point, a plateau and a
    peak off the grid's start."""
    x = e["x"]
    if x % 7 == 3:
        return None
    return float(-(x - 25) ** 2 + (x % 3))


TUNERS = [("grid", GridSearchTuner, JGrid, {}), ("random", RandomTuner, JRandom, {}),
          ("model_based", ModelBasedTuner, JModel, {"num_random": 4})]


@pytest.mark.parametrize("early,trials", [(3, None), (8, 25), (50, None)])
@pytest.mark.parametrize("name,port_cls,jax_cls,kw", TUNERS, ids=[t[0] for t in TUNERS])
def test_tuners_take_jax_s_trials_in_jax_s_order(name, port_cls, jax_cls, kw, early, trials):
    space = [{"x": i, "mode": ("a", "b")[i % 2]} for i in range(50)]
    seen = {"port": [], "jax": []}

    def run_of(side):
        def run(e):
            seen[side].append(e["x"])
            return _metric(e)
        return run

    port = port_cls(space, run_of("port"), early_stopping=early, **kw)
    ref = jax_cls(space, run_of("jax"), early_stopping=early, **kw)
    assert port.tune(num_trials=trials) == ref.tune(num_trials=trials)
    assert seen["port"] == seen["jax"] and len(seen["port"]) > 0
    assert port.records == ref.records


@pytest.mark.parametrize("section", [
    {"tuner_type": "gridsearch", "tuner_early_stopping": 50, "fast": False},
    {"tuner_type": "random", "zero_stages": [1, 2]},
    {"tuner_type": "model_based", "fast": False, "tuner_num_trials": 9},
    {"metric": "latency", "tuner_type": "gridsearch", "zero_stages": [3],
     "micro_batch_sizes": [4, 8]},
], ids=["grid_full", "random_stages", "model_based_full", "latency"])
def test_tune_records_and_written_files_equal_jax_s(jax_layout, tmp_path, section):
    sides = {}
    for side, (cls, cfg_cls, info) in {"port": (Autotuner, AutotuningConfig, ModelInfo),
                                      "jax": (JAutotuner, JConfig, JInfo)}.items():
        cfg = cfg_cls(**section, exps_dir=str(tmp_path / side / "exps"),
                      results_dir=str(tmp_path / side / "results"))
        at = cls(info(10_000_000, 512 << 20), _synthetic_runner,
                 user_config={"optimizer": {"type": "adamw"}}, dp_size=4,
                 device_memory=8 * GiB, config=cfg)
        sides[side] = (at, at.tune(), at.write_results())
    (port, pbest, ppath), (ref, jbest, jpath) = sides["port"], sides["jax"]
    assert pbest == jbest and pbest is not None
    assert port.records == ref.records and port.best_metric == ref.best_metric
    for name in ("exps/experiments.jsonl", "results/dstpu_config_optimal.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    if section.get("metric") == "latency":
        assert pbest["train_micro_batch_size_per_gpu"] == 8  # latency negated to a maximum


def test_autotuning_config_matches_jax():
    assert AutotuningConfig().to_dict() == {k: getattr(JConfig(), k) for k in JConfig._fields}
    with pytest.raises(ValueError, match="end_profile_step"):
        AutotuningConfig(start_profile_step=3, end_profile_step=3)
    with pytest.raises(ValueError):
        AutotuningConfig(tuner_type="bayes")
    assert AutotuningConfig(some_future_knob=1)._extra == {"some_future_knob": 1}


# ----------------------------------------------------------- the runner
CFG = dataclasses.replace(llama.LlamaConfig.tiny(vocab=128, hidden=64, layers=2, heads=2,
                                                 kv_heads=2, seq=32), remat=False)
EXP = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 1,
       "zero_optimization": {"stage": 0}, "bf16": {"enabled": False},
       "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}


def _runner():
    params = llama.init_params(CFG, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch_fn = lambda n: llama.causal_lm_batch(rng.integers(0, CFG.vocab_size, (n, CFG.max_seq_len)))
    snapshot = {k: v.clone() for k, v in params.items() if isinstance(v, torch.Tensor)}
    runner = pat.make_engine_runner(llama.make_loss_fn(CFG), params, example_batch_fn=batch_fn,
                                    warmup_steps=1, measure_steps=2, device="cpu")
    return runner, params, snapshot


def test_engine_runner_measures_a_tiny_llama_on_the_cpu_with_fresh_params():
    from deepspeed_tpu_torch.profiling.flops_profiler import FlopsProfiler
    from deepspeed_tpu_torch.runtime.engine import initialize
    runner, params, snapshot = _runner()
    first = runner(dict(EXP))
    assert set(first) == {"throughput", "latency", "flops"}
    assert all(np.isfinite(v) and v > 0 for v in first.values())
    # the experiment trained a copy: the caller's params never moved
    assert all(torch.equal(params[k], v) for k, v in snapshot.items())
    engine = initialize(loss_fn=llama.make_loss_fn(CFG), model_parameters=params, device="cpu",
                        config=dict(EXP))[0]
    batch = llama.causal_lm_batch(np.random.default_rng(1).integers(0, 128, (2, 32)))
    step_flops = FlopsProfiler(engine).profile_train_step(batch).flops
    assert first["flops"] * first["latency"] == pytest.approx(step_flops, rel=1e-9)


def test_engine_runner_prunes_oom_and_invalid_configs_and_lets_other_errors_through(monkeypatch):
    from deepspeed_tpu_torch.runtime.engine import Engine
    runner, _, _ = _runner()
    assert runner(dict(EXP, no_such_section=1)) is None  # load_config's ValueError
    original = Engine.train_batch

    def oom(self, batch):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 64.00 GiB")

    monkeypatch.setattr(Engine, "train_batch", oom)
    assert runner(dict(EXP)) is None

    def kernel_fault(self, batch):
        raise RuntimeError("flash_fwd: kernel launch failed")

    monkeypatch.setattr(Engine, "train_batch", kernel_fault)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        runner(dict(EXP))
    monkeypatch.setattr(Engine, "train_batch", original)
    assert runner(dict(EXP)) is not None


def test_device_memory_needs_a_gpu_without_an_override():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: get_accelerator() answers")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Autotuner(ModelInfo(1000, 1000), _synthetic_runner)
    assert Autotuner(ModelInfo(1000, 1000), _synthetic_runner,
                     config=AutotuningConfig(device_memory=GiB)).device_memory == GiB


def test_cli_tunes_an_entry_on_the_cpu(tmp_path, monkeypatch):
    (tmp_path / "tiny_entry.py").write_text(
        "import numpy as np, torch\n"
        "from deepspeed_tpu_torch.autotuning import ModelInfo\n"
        "def make():\n"
        "    def loss_fn(params, batch, rng=None):\n"
        "        return ((batch['x'] @ params['w'] - batch['y']) ** 2).mean()\n"
        "    params = {'w': torch.ones(4, 2)}\n"
        "    batch_fn = lambda n: {'x': np.ones((n, 4), np.float32), 'y': np.zeros((n, 2), np.float32)}\n"
        "    return loss_fn, params, batch_fn, ModelInfo(8, 1 << 20)\n")
    conf = tmp_path / "ds.json"
    conf.write_text(json.dumps({
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}, "bf16": {"enabled": False},
        "autotuning": {"enabled": True, "zero_stages": [0], "micro_batch_sizes": [1, 2],
                       "tuner_type": "gridsearch", "start_profile_step": 1,
                       "end_profile_step": 2, "device_memory": GiB,
                       "exps_dir": str(tmp_path / "exps"),
                       "results_dir": str(tmp_path / "results")}}))
    monkeypatch.syspath_prepend(str(tmp_path))
    from deepspeed_tpu_torch.autotuning.__main__ import main
    assert main(["--config", str(conf), "--entry", "tiny_entry:make", "--device", "cpu"]) == 0
    best = json.loads((tmp_path / "results" / "dstpu_config_optimal.json").read_text())
    assert best["train_micro_batch_size_per_gpu"] in (1, 2)
    assert len((tmp_path / "exps" / "experiments.jsonl").read_text().splitlines()) == 2

"""The port's checkpoints on the CPU against the JAX package's, on files.

A checkpoint written by ``deepspeed_tpu`` loads into ``deepspeed_tpu_torch``
and the reverse, and the next step matches the other package's (tiny Llama,
fp32, ``fused_adam``, ``fused_adam8bit`` and ``lion``; the JAX side runs its
Pallas kernels in interpret mode on a one-device topology); the same state
gives byte-identical leaf files and manifest entries in both packages; a
resumed port run equals an unbroken one bit for bit; ``get_fp32_params`` and
``save_16bit_model`` equal JAX's.  Then the durability protocol of
``tests/unit/test_checkpoint_resilience.py`` on the port (a small MLP, the
JAX package's fault-injection harness at the checkpoint-engine seam), and
the three-call ``forward``/``backward``/``step`` shim."""

import json
import os
import signal
import time

import jax
import numpy as np
import pytest
import safetensors.torch
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.elasticity import select_consensus_tag
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.ops import _pallas
from deepspeed_tpu.parallel.mesh import MeshTopology, reset_topology
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.runtime import checkpointing as ckpt
from deepspeed_tpu_torch.runtime.checkpoint_engine import (AsyncCheckpointEngine,
                                                           NativeCheckpointEngine)
from deepspeed_tpu_torch.runtime.checkpointing import (CheckpointError, check_checkpoint_tag,
                                                       find_latest_valid_tag, flatten_with_keys,
                                                       get_latest_tag, is_valid_tag, list_tags,
                                                       sweep_retention)
from deepspeed_tpu_torch.runtime.heartbeat import RESUME_DIR_ENV, RESUME_TAG_ENV
from deepspeed_tpu_torch.utils.wal import file_crc32

from .test_torch_train import (ADAM8, LR, _assert_params_close, _config, _configs, _ids,
                               _no_remat_configs, _params)
from .unit.fault_injection import (FaultyCheckpointEngine, SimulatedCrash, corrupt_leaf,
                                   drop_metadata, truncate_leaf)

OPTIMIZERS = {"fused_adam": _config()["optimizer"], "fused_adam8bit": ADAM8,
              "lion": {"type": "lion", "params": {"lr": LR, "weight_decay": 0.01}}}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(_pallas, "INTERPRET", True)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tiny engines' ops are far smaller than a
    thread pool's wake-up, and the suite runs several workers on the box's
    cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def one_device():
    topo = MeshTopology.from_axis_dict({"data": 1}, devices=jax.devices()[:1])
    yield topo
    reset_topology()


def _port_engine(cfg, params, conf):
    return deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg), model_parameters=params,
                                          config=conf, device="cpu")[0]


def _leaf_files(ckpt_dir):
    meta = ckpt.read_metadata(str(ckpt_dir))
    return {e["key"]: e for e in meta["manifest"]}


# ------------------------------------------------------- interop with the JAX package
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_checkpoints_cross_between_the_packages(opt, one_device, tmp_path):
    """Both packages train 2 steps and save.  (a) A port engine from another
    seed loads JAX's files and its third step matches JAX's; (b) the JAX
    engine loads the port's files and its third step matches the port's;
    (c) the port re-saves JAX's state: every leaf file and manifest entry is
    byte-identical to JAX's (``torch_rng`` / ``rng`` aside)."""
    jcfg, cfg = _no_remat_configs()
    jparams, params = _params(jcfg, cfg, seed=11)
    conf = _config(optimizer=OPTIMIZERS[opt])
    jengine = deepspeed_tpu.initialize(loss_fn=jllama.make_loss_fn(jcfg), model_parameters=jparams,
                                       config=conf, topology=one_device)[0]
    engine = _port_engine(cfg, params, conf)
    batches = [llama.causal_lm_batch(_ids(80 + s, 4)) for s in range(3)]
    lrs = []
    for batch in batches[:2]:
        jengine.train_batch(batch)
        lrs.append(engine.train_batch(batch).lr)
    jtag = jengine.save_checkpoint(str(tmp_path / "jax"))
    assert engine.save_checkpoint(str(tmp_path / "port")) == jtag == "global_step2"

    other = _port_engine(cfg, _params(jcfg, cfg, seed=12)[1], conf)
    assert other.load_checkpoint(str(tmp_path / "jax"))[0] == jtag
    assert (other.global_steps, other.global_samples, other.state.step) == (2, 8, 2)
    assert other.lr_scheduler.last_step == 2
    # (c) the same state, the same files
    other.save_checkpoint(str(tmp_path / "again"), tag=jtag)
    jfiles, pfiles = _leaf_files(tmp_path / "jax" / jtag), _leaf_files(tmp_path / "again" / jtag)
    assert set(jfiles) - {"rng"} == set(pfiles) - {"torch_rng"}
    assert [k for k in jfiles if k != "rng"] == [k for k in pfiles if k != "torch_rng"]  # order
    for key in set(jfiles) - {"rng"}:
        assert jfiles[key] == pfiles[key], key
        assert ((tmp_path / "jax" / jtag / f"{key}.npy").read_bytes()
                == (tmp_path / "again" / jtag / f"{key}.npy").read_bytes()), key
    # (a) JAX -> port
    jm, m = jengine.train_batch(batches[2]), other.train_batch(batches[2])
    np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-5)
    _assert_params_close(other.state.params, jengine.state.params, lrs + [m.lr])
    # (b) port -> JAX
    assert jengine.load_checkpoint(str(tmp_path / "port"))[0] == jtag
    assert jengine.global_steps == 2 and int(jengine.state.step) == 2
    jm, m = jengine.train_batch(batches[2]), engine.train_batch(batches[2])
    np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-5)
    _assert_params_close(engine.state.params, jengine.state.params, lrs + [m.lr])


def _saved_leaves(engine):
    return {k: ckpt.to_host(v) for k, v in flatten_with_keys(engine._saved_state())}


@pytest.mark.parametrize("opt", ["fused_adam", "fused_adam8bit", "lion", "sgd", "adagrad", "lamb"])
def test_resume_equals_the_unbroken_run(opt, tmp_path):
    """4 unbroken steps equal 2 + save + a fresh engine from another seed +
    load + 2, bit for bit: losses, every state leaf, the generator."""
    _, cfg = _configs()
    optimizer = dict(OPTIMIZERS.get(opt) or {"type": opt, "params": {"lr": LR}})
    if opt == "sgd":
        optimizer["params"] = {"lr": LR, "momentum": 0.9, "nesterov": True}
    conf = _config(optimizer=optimizer)
    params = llama.init_params(cfg, torch.Generator().manual_seed(3))
    batches = [llama.causal_lm_batch(_ids(90 + s, 4)) for s in range(4)]
    unbroken = _port_engine(cfg, params, conf)
    ref = [float(unbroken.train_batch(b).loss) for b in batches]
    first = _port_engine(cfg, params, conf)
    losses = [float(first.train_batch(b).loss) for b in batches[:2]]
    first.save_checkpoint(str(tmp_path))
    del first
    resumed = _port_engine(cfg, llama.init_params(cfg, torch.Generator().manual_seed(4)),
                           dict(conf, seed=99))
    resumed.load_checkpoint(str(tmp_path))
    losses += [float(resumed.train_batch(b).loss) for b in batches[2:]]
    assert losses == ref
    got, want = _saved_leaves(resumed), _saved_leaves(unbroken)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert resumed.global_steps == 4 and resumed.lr_scheduler.last_step == 4


@pytest.mark.parametrize("bf16", [False, True])
def test_fp32_params_and_16bit_model_equal_jax(bf16, one_device, tmp_path):
    """``get_fp32_params`` and ``save_16bit_model`` of a port engine that
    loaded a JAX checkpoint equal the JAX engine's, read back with
    ``safetensors.torch.load_file`` (fp32 and bf16), byte for byte."""
    jcfg, cfg = _configs()
    jparams, params = _params(jcfg, cfg, seed=13)
    rng = np.random.default_rng(5)
    jparams = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32), jparams)
    conf = _config(bf16={"enabled": bf16})
    jengine = deepspeed_tpu.initialize(loss_fn=jllama.make_loss_fn(jcfg), model_parameters=jparams,
                                       config=conf, topology=one_device)[0]
    jengine.save_checkpoint(str(tmp_path / "ck"))
    engine = _port_engine(cfg, params, conf)
    engine.load_checkpoint(str(tmp_path / "ck"))
    ref, got = jengine.get_fp32_params(), engine.get_fp32_params()
    assert [k for k, _ in flatten_with_keys(got)] == [k for k, _ in flatten_with_keys(ref)]
    for (key, a), (_, b) in zip(flatten_with_keys(got), flatten_with_keys(ref)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=key)
    jpath = jengine.save_16bit_model(str(tmp_path / "jax16"))
    path = engine.save_16bit_model(str(tmp_path / "port16"))
    jt, t = safetensors.torch.load_file(jpath), safetensors.torch.load_file(path)
    assert sorted(t) == sorted(jt) and "layers.attn.wq" in t
    dtype = torch.bfloat16 if bf16 else torch.float32
    for key in jt:
        assert t[key].dtype == jt[key].dtype == dtype
        assert torch.equal(t[key], jt[key]), key
    assert open(path, "rb").read() == open(jpath, "rb").read()


# ------------------------------------------------------- the durability protocol
HIDDEN = 16


def _mlp_loss(params, batch, rng):
    h = batch["x"]
    for i in range(len(params)):
        p = params[f"layer_{i}"]
        h = h @ p["w"].to(h.dtype) + p["b"].to(h.dtype)
        if i < len(params) - 1:
            h = torch.relu(h)
    return torch.mean((h - batch["y"].to(h.dtype))**2).float()


def make_engine(extra_cfg=None, ckpt_cfg=None):
    gen = torch.Generator().manual_seed(0)
    params = {f"layer_{i}": {"w": torch.randn(HIDDEN, HIDDEN, generator=gen) / HIDDEN**0.5,
                             "b": torch.zeros(HIDDEN)} for i in range(2)}
    cfg = {"train_micro_batch_size_per_gpu": 2, "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
           "zero_optimization": {"stage": 1}, "bf16": {"enabled": False}, "steps_per_print": 100}
    if ckpt_cfg:
        cfg["checkpoint"] = ckpt_cfg
    cfg.update(extra_cfg or {})
    return deepspeed_tpu_torch.initialize(loss_fn=_mlp_loss, model_parameters=params, config=cfg,
                                          device="cpu")[0]


def train(engine, steps, seed=1):
    w_true = np.random.default_rng(42).normal(size=(HIDDEN, HIDDEN)).astype(np.float32) * 0.3
    losses = []
    for s in range(steps):
        x = np.random.default_rng(seed + s).normal(size=(engine.train_batch_size, HIDDEN))
        x = x.astype(np.float32)
        losses.append(float(engine.train_batch({"x": x, "y": x @ w_true}).loss))
    return losses


def _assert_same_params(a, b):
    for (key, x), (_, y) in zip(flatten_with_keys(a), flatten_with_keys(b)):
        np.testing.assert_array_equal(x, y, err_msg=key)


def test_save_layout_manifest_and_index(tmp_path):
    engine = make_engine()
    train(engine, 2)
    tag = engine.save_checkpoint(str(tmp_path))
    assert not [d for d in os.listdir(tmp_path) if d.startswith(ckpt.TMP_PREFIX)]
    assert get_latest_tag(str(tmp_path)) == tag == "global_step2"
    assert list_tags(str(tmp_path)) == [tag]
    meta = ckpt.read_metadata(str(tmp_path / tag))
    assert meta["format_version"] == ckpt.FORMAT_VERSION and meta["tag"] == tag
    assert [e["key"] for e in meta["manifest"]] == [
        "step", "params.layer_0.b", "params.layer_0.w", "params.layer_1.b", "params.layer_1.w",
        "opt_state.step", "opt_state.exp_avg.layer_0.b", "opt_state.exp_avg.layer_0.w",
        "opt_state.exp_avg.layer_1.b", "opt_state.exp_avg.layer_1.w",
        "opt_state.exp_avg_sq.layer_0.b", "opt_state.exp_avg_sq.layer_0.w",
        "opt_state.exp_avg_sq.layer_1.b", "opt_state.exp_avg_sq.layer_1.w", "torch_rng"]
    for entry in meta["manifest"]:
        path = tmp_path / tag / (entry["key"] + ".npy")
        assert entry["nbytes"] == os.path.getsize(path)
        assert entry["crc32"] == file_crc32(str(path))
        assert entry["dtype"] == str(np.load(path).dtype)
    assert np.load(tmp_path / tag / "step.npy").dtype == np.int32
    assert meta["client_state"] == {"global_steps": 2, "global_samples": 4,
                                    "lr_scheduler": {"last_step": 2}}
    assert check_checkpoint_tag(str(tmp_path), tag, verify_integrity=True) == []


def test_commit_runs_after_rename_and_before_latest(tmp_path):
    observed = {}

    class RecordingEngine(NativeCheckpointEngine):
        def commit(self, tag):
            final = tmp_path / tag
            observed["final_dir"] = final.is_dir()
            observed["metadata"] = (final / ckpt.METADATA_FILE).exists()
            latest = tmp_path / ckpt.LATEST_FILE
            observed["latest_already_flipped"] = (latest.exists()
                                                  and latest.read_text().strip() == tag)
            return True

    engine = make_engine()
    train(engine, 1)
    engine._ckpt_engine = RecordingEngine()
    tag = engine.save_checkpoint(str(tmp_path))
    assert observed == {"final_dir": True, "metadata": True, "latest_already_flipped": False}
    assert get_latest_tag(str(tmp_path)) == tag


@pytest.mark.parametrize("fault", [{"kill_after_bytes": 1500}, {"kill_after_leaves": 3}])
def test_kill_mid_save_preserves_latest_and_fallback_restores(fault, tmp_path):
    engine = make_engine()
    train(engine, 3)
    tag_a = engine.save_checkpoint(str(tmp_path))
    params_a = engine.get_fp32_params()
    train(engine, 2)
    engine._ckpt_engine = FaultyCheckpointEngine(**fault)
    with pytest.raises(SimulatedCrash):
        engine.save_checkpoint(str(tmp_path), tag="global_step_doomed")
    assert get_latest_tag(str(tmp_path)) == tag_a
    assert not (tmp_path / "global_step_doomed").exists()
    assert [d for d in os.listdir(tmp_path) if d.startswith(ckpt.TMP_PREFIX)]
    assert is_valid_tag(str(tmp_path), tag_a, verify_integrity=True)
    engine2 = make_engine()
    loaded_tag, _ = engine2.load_checkpoint(str(tmp_path), fallback_to_valid=True)
    assert loaded_tag == tag_a and engine2.global_steps == 3
    _assert_same_params(params_a, engine2.get_fp32_params())
    # the next healthy save sweeps the crashed staging dir
    train(engine2, 1)
    engine2.save_checkpoint(str(tmp_path))
    assert not [d for d in os.listdir(tmp_path) if d.startswith(ckpt.TMP_PREFIX)]


def test_resave_same_tag_parks_old_copy_until_published(tmp_path):
    engine = make_engine()
    train(engine, 1)
    engine.save_checkpoint(str(tmp_path), tag="t")

    class CommitBomb(NativeCheckpointEngine):
        def commit(self, tag):
            raise SimulatedCrash("die between rename and latest flip")

    train(engine, 1)
    engine._ckpt_engine = CommitBomb()
    with pytest.raises(SimulatedCrash):
        engine.save_checkpoint(str(tmp_path), tag="t")
    assert is_valid_tag(str(tmp_path), "t", verify_integrity=True)
    assert is_valid_tag(str(tmp_path), "t.prev", verify_integrity=True)
    engine._ckpt_engine = None
    engine.save_checkpoint(str(tmp_path), tag="t")
    assert not (tmp_path / "t.prev").exists()
    assert get_latest_tag(str(tmp_path)) == "t"


def test_sweep_skips_in_flight_staging_dir(tmp_path):
    live = tmp_path / (ckpt.TMP_PREFIX + "inflight")
    stale = tmp_path / (ckpt.TMP_PREFIX + "crashed")
    live.mkdir(), stale.mkdir()
    ckpt._ACTIVE_STAGING.add(str(live))
    try:
        swept = ckpt._sweep_stale_tmp(str(tmp_path))
    finally:
        ckpt._ACTIVE_STAGING.discard(str(live))
    assert swept == [ckpt.TMP_PREFIX + "crashed"]
    assert live.is_dir() and not stale.exists()


def _malformed(d):
    (d / ckpt.METADATA_FILE).write_text(json.dumps({"manifest": [{}], "client_state": {}}))


DAMAGE = {
    "malformed_manifest": (_malformed, "malformed", False),
    "truncated_leaf": (lambda d: truncate_leaf(str(d), "params.layer_0.w"), "size", False),
    "dropped_metadata": (lambda d: drop_metadata(str(d)), "no metadata.json", False),
    "bitflip": (lambda d: corrupt_leaf(str(d), "params.layer_0.w"), "crc32", True),
}


@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_damaged_newest_tag_raises_and_falls_back(damage, tmp_path):
    """The newest tag damaged after its save: validation names the damage,
    a plain load raises ``CheckpointError``, and ``fallback_to_valid`` loads
    the earlier tag bit for bit (a bitflip only ``verify_integrity`` sees)."""
    hurt, problem, needs_crc = DAMAGE[damage]
    engine = make_engine()
    train(engine, 2)
    engine.save_checkpoint(str(tmp_path), tag="step_a")
    params_a = engine.get_fp32_params()
    train(engine, 2)
    engine.save_checkpoint(str(tmp_path), tag="step_b")
    hurt(tmp_path / "step_b")
    if needs_crc:
        assert is_valid_tag(str(tmp_path), "step_b")
    problems = check_checkpoint_tag(str(tmp_path), "step_b", verify_integrity=True)
    assert any(problem in p for p in problems), problems
    assert find_latest_valid_tag(str(tmp_path), verify_integrity=True) == "step_a"
    engine2 = make_engine(ckpt_cfg={"verify_integrity": needs_crc})
    with pytest.raises(CheckpointError, match="step_b"):
        engine2.load_checkpoint(str(tmp_path))
    assert engine2.load_checkpoint(str(tmp_path), fallback_to_valid=True)[0] == "step_a"
    _assert_same_params(params_a, engine2.get_fp32_params())
    assert engine2.global_steps == 2


def test_no_valid_checkpoint_raises_clear_error(tmp_path):
    engine = make_engine()
    train(engine, 1)
    tag = engine.save_checkpoint(str(tmp_path))
    drop_metadata(str(tmp_path / tag))
    with pytest.raises(CheckpointError, match="no valid checkpoint"):
        make_engine().load_checkpoint(str(tmp_path), fallback_to_valid=True)


@pytest.mark.parametrize("case", ["empty_latest", "dangling_latest", "no_latest"])
def test_latest_file_faults_are_checkpoint_errors(case, tmp_path):
    engine = make_engine()
    if case == "no_latest":
        with pytest.raises(CheckpointError, match="no 'latest'"):
            engine.load_checkpoint(str(tmp_path))
        return
    if case == "dangling_latest":
        (tmp_path / ckpt.LATEST_FILE).write_text("ghost_tag")
        with pytest.raises(CheckpointError, match="ghost_tag"):
            engine.load_checkpoint(str(tmp_path))
        with pytest.raises(CheckpointError, match="fallback_to_valid"):
            engine.load_checkpoint(str(tmp_path), tag="also_missing")
        return
    train(engine, 1)
    tag = engine.save_checkpoint(str(tmp_path))
    (tmp_path / ckpt.LATEST_FILE).write_text("  \n")
    with pytest.raises(CheckpointError, match="empty"):
        get_latest_tag(str(tmp_path))
    engine2 = make_engine()
    with pytest.raises(CheckpointError, match="empty"):
        engine2.load_checkpoint(str(tmp_path))
    # the fallback walks the index past the torn latest
    assert engine2.load_checkpoint(str(tmp_path), fallback_to_valid=True)[0] == tag


def test_transient_oserrors_absorbed_by_retries(tmp_path):
    jsonl = tmp_path / "telemetry.jsonl"
    engine = make_engine(extra_cfg={"telemetry": {"jsonl_path": str(jsonl)}},
                         ckpt_cfg={"save_retries": 3, "retry_backoff_secs": 0.0})
    train(engine, 1)
    faulty = FaultyCheckpointEngine(transient_errors=2)
    engine._ckpt_engine = faulty
    tag = engine.save_checkpoint(str(tmp_path / "ck"))
    assert faulty.transients_raised == 2
    assert is_valid_tag(str(tmp_path / "ck"), tag, verify_integrity=True)
    engine2 = make_engine()
    engine2.load_checkpoint(str(tmp_path / "ck"))
    assert engine2.global_steps == engine.global_steps
    engine.telemetry.close()
    records = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [r["attempt"] for r in records if r.get("event") == "save_retry"] == [1, 2]


@pytest.mark.parametrize("engine_kind", ["native", "async"])
def test_a_full_disk_raises_and_publishes_nothing(engine_kind, tmp_path, monkeypatch):
    """``ENOSPC`` on every write: the retries run out and the ``OSError``
    propagates, from the async writer's thread too; nothing is published."""
    engine = make_engine(ckpt_cfg={"save_retries": 1, "retry_backoff_secs": 0.0,
                                   "checkpoint_engine": engine_kind})
    train(engine, 1)
    if engine_kind == "native":
        engine._ckpt_engine = FaultyCheckpointEngine(transient_errors=10)
        match = "injected transient"
    else:
        assert isinstance(engine.checkpoint_engine, AsyncCheckpointEngine)

        def full(path, arr):
            raise OSError(28, "No space left on device", path)

        monkeypatch.setattr(np, "save", full)
        match = "No space left"
    with pytest.raises(OSError, match=match):
        engine.save_checkpoint(str(tmp_path))
    assert get_latest_tag(str(tmp_path)) is None


def test_keep_last_n_gc(tmp_path):
    engine = make_engine(ckpt_cfg={"keep_last_n": 2})
    for i in range(4):
        train(engine, 1)
        engine.save_checkpoint(str(tmp_path), tag=f"step_{i}")
    assert list_tags(str(tmp_path)) == ["step_2", "step_3"]
    assert get_latest_tag(str(tmp_path)) == "step_3"
    assert not (tmp_path / "step_0").exists() and not (tmp_path / "step_1").exists()


def test_retention_never_deletes_only_valid_checkpoint(tmp_path):
    engine = make_engine()
    for i in range(3):
        train(engine, 1)
        engine.save_checkpoint(str(tmp_path), tag=f"step_{i}")
    drop_metadata(str(tmp_path / "step_1"))
    drop_metadata(str(tmp_path / "step_2"))
    deleted = sweep_retention(str(tmp_path), keep_last_n=1)
    assert "step_0" not in deleted and (tmp_path / "step_0").is_dir()
    assert find_latest_valid_tag(str(tmp_path)) == "step_0"


def test_client_state_numpy_and_torch_leaves_serialize(tmp_path):
    engine = make_engine()
    train(engine, 1)
    tag = engine.save_checkpoint(str(tmp_path), client_state={
        "mask": np.array([True, False]), "counts": np.arange(3, dtype=np.int64),
        "flag": np.bool_(True), "scale": np.float32(1.5), "dev": torch.ones(2),
        "bf16": torch.full((2, ), 0.5, dtype=torch.bfloat16), "n": torch.tensor(7)})
    with open(tmp_path / tag / ckpt.METADATA_FILE) as fh:
        client = json.load(fh)["client_state"]
    assert client["mask"] == [True, False] and client["counts"] == [0, 1, 2]
    assert client["flag"] is True and client["scale"] == 1.5
    assert client["dev"] == [1.0, 1.0] and client["bf16"] == [0.5, 0.5] and client["n"] == 7
    _, restored = make_engine().load_checkpoint(str(tmp_path))
    assert restored["flag"] is True and restored["global_steps"] == 1


def test_legacy_manifest_without_crc_still_validates(tmp_path):
    engine = make_engine()
    train(engine, 1)
    tag = engine.save_checkpoint(str(tmp_path))
    meta_path = tmp_path / tag / ckpt.METADATA_FILE
    meta = json.loads(meta_path.read_text())
    for entry in meta["manifest"]:
        entry.pop("nbytes"), entry.pop("crc32")
    meta_path.write_text(json.dumps(meta))
    assert is_valid_tag(str(tmp_path), tag, verify_integrity=True)
    make_engine().load_checkpoint(str(tmp_path))


def test_sigterm_triggers_best_effort_save(tmp_path):
    original = signal.getsignal(signal.SIGTERM)
    chained = []
    try:
        signal.signal(signal.SIGTERM, lambda *a: chained.append(a))
        engine = make_engine(ckpt_cfg={"save_on_preemption": True})
        train(engine, 2)
        engine.save_checkpoint(str(tmp_path))  # arms the handler
        train(engine, 1)
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)  # the signal lands at a bytecode boundary
        tag = get_latest_tag(str(tmp_path))
        assert tag == f"preempt_step{engine.global_steps}"
        assert is_valid_tag(str(tmp_path), tag, verify_integrity=True)
        _, client = make_engine().load_checkpoint(str(tmp_path))
        assert client["preempted"] is True
        assert chained, "previous SIGTERM handler was not chained"
    finally:
        signal.signal(signal.SIGTERM, original)


def test_async_engine_roundtrip_with_atomic_protocol(tmp_path):
    engine = make_engine(extra_cfg={"nebula": {"enabled": True}})
    assert isinstance(engine.checkpoint_engine, AsyncCheckpointEngine)
    train(engine, 2)
    tag = engine.save_checkpoint(str(tmp_path))
    assert is_valid_tag(str(tmp_path), tag, verify_integrity=True)
    engine2 = make_engine(ckpt_cfg={"checkpoint_engine": "async"})
    engine2.load_checkpoint(str(tmp_path))
    _assert_same_params(engine.get_fp32_params(), engine2.get_fp32_params())


def _two_tags(tmp_path, sub=""):
    engine = make_engine()
    train(engine, 1)
    tag1 = engine.save_checkpoint(str(tmp_path / sub))
    train(engine, 1)
    return engine, tag1, engine.save_checkpoint(str(tmp_path / sub))


def test_agent_resume_pin_matches_fallback_walk(tmp_path):
    """The JAX elastic agent's consensus walk over the port's per-rank dirs
    picks what the port's own fallback load picks."""
    engine = make_engine()
    dirs = [str(tmp_path / "ck" / f"rank{r}") for r in range(2)]
    for _ in range(3):
        train(engine, 1)
        for d in dirs:
            engine.save_checkpoint(d)
    truncate_leaf(os.path.join(dirs[1], list_tags(dirs[1])[-1]), "params.layer_0.w")
    tag = select_consensus_tag(dirs)
    assert tag == find_latest_valid_tag(dirs[1]) == "global_step2"
    assert make_engine().load_checkpoint(dirs[1], fallback_to_valid=True)[0] == tag


def test_engine_honors_agent_pinned_resume_tag(tmp_path, monkeypatch):
    _, tag1, tag2 = _two_tags(tmp_path)
    monkeypatch.setenv(RESUME_TAG_ENV, tag1)
    assert make_engine().load_checkpoint(str(tmp_path))[0] == tag1  # pin beats 'latest'
    assert make_engine().load_checkpoint(str(tmp_path), tag=tag2)[0] == tag2  # arg beats pin
    monkeypatch.delenv(RESUME_TAG_ENV)
    assert make_engine().load_checkpoint(str(tmp_path))[0] == tag2


def test_resume_pin_scoped_to_agent_checkpoint_dir(tmp_path, monkeypatch):
    engine = make_engine()
    train(engine, 1)
    train_tag = engine.save_checkpoint(str(tmp_path / "train"))
    train(engine, 1)
    base_tag = engine.save_checkpoint(str(tmp_path / "base"))
    monkeypatch.setenv(RESUME_TAG_ENV, train_tag)
    # the pinned tag is absent from base/: its own 'latest' loads
    assert make_engine().load_checkpoint(str(tmp_path / "base"))[0] == base_tag
    assert make_engine().load_checkpoint(str(tmp_path / "train"))[0] == train_tag
    # a same-named tag outside DSTPU_RESUME_DIR does not take the pin either
    _, clash, base_latest = _two_tags(tmp_path, "base2")
    assert clash == train_tag and base_latest != train_tag
    monkeypatch.setenv(RESUME_DIR_ENV, str(tmp_path / "train"))
    assert make_engine().load_checkpoint(str(tmp_path / "base2"))[0] == base_latest
    assert make_engine().load_checkpoint(str(tmp_path / "train"))[0] == train_tag


def test_pinned_tag_validation_failure_refuses_fallback(tmp_path, monkeypatch):
    _, tag1, tag2 = _two_tags(tmp_path)
    truncate_leaf(os.path.join(str(tmp_path), tag2), "params.layer_0.w")
    monkeypatch.setenv(RESUME_TAG_ENV, tag2)
    with pytest.raises(CheckpointError, match="pinned resume tag"):
        make_engine().load_checkpoint(str(tmp_path), fallback_to_valid=True)
    monkeypatch.delenv(RESUME_TAG_ENV)
    assert make_engine().load_checkpoint(str(tmp_path), fallback_to_valid=True)[0] == tag1


def test_load_without_optimizer_states_keeps_the_engines(tmp_path):
    engine = make_engine()
    train(engine, 2)
    engine.save_checkpoint(str(tmp_path))
    fresh = make_engine()
    before = [leaf for _, leaf in flatten_with_keys(fresh.state.opt_state)]
    fresh.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    after = [leaf for _, leaf in flatten_with_keys(fresh.state.opt_state)]
    assert all(a is b for a, b in zip(after, before)) and len(after) == len(before)
    assert fresh.state.opt_state.step == 0 and fresh.state.step == 2
    _assert_same_params(engine.get_fp32_params(), fresh.get_fp32_params())


# --------------------------------------------------------------- the three-call shim
def test_forward_backward_step_shim_equals_train_batch():
    """``forward`` twice, ``backward``, ``step`` equals ``train_batch`` on the
    stacked micro-batches bit for bit; a wrong count raises (JAX
    ``tests/unit/test_engine.py:90-101``)."""
    _, cfg = _configs()
    params = llama.init_params(cfg, torch.Generator().manual_seed(6))
    conf = _config()
    shim, ref = _port_engine(cfg, params, conf), _port_engine(cfg, params, conf)
    for s in range(2):
        batch = llama.causal_lm_batch(_ids(100 + s, 4))
        micro = [{k: v[2 * g:2 * g + 2] for k, v in batch.items()} for g in range(2)]
        for mb in micro:
            assert shim.forward(mb) is None and shim.backward() is None
        m, want = shim.step(), ref.train_batch(batch)
        assert float(m.loss) == float(want.loss)
    _assert_same_params(shim.get_fp32_params(), ref.get_fp32_params())
    assert shim.global_steps == 2
    with pytest.raises(RuntimeError, match="forward"):
        shim.step()  # no micro-batches queued
    shim.forward(micro[0])
    with pytest.raises(RuntimeError, match="gradient_accumulation_steps=2"):
        shim.step()

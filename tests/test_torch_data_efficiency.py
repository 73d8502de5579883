"""The port's data path and the rest of single-GPU training on the CPU
against the JAX package: ``MMIDIDX`` files both ways, ``DataAnalyzer``,
the curriculum scheduler, the sampler and both loaders (with resume),
random-LTD (its scheduler, ``random_ltd_scan`` and an engine built by
``initialize(training_data=, config=data_efficiency)``, both packages' token
samplers patched to one fixed index set: Threefry and Philox never share
bits), eval without LTD, the watchdog, PLD, the Hessian eigenvalue and the
heartbeat stamps around checkpoint IO.  fp32 throughout."""

import filecmp
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel.mesh import MeshTopology, reset_topology
from deepspeed_tpu.runtime import dataloader as jdl
from deepspeed_tpu.runtime import eigenvalue as jeig
from deepspeed_tpu.runtime import progressive_layer_drop as jpld
from deepspeed_tpu.runtime.data_pipeline import (curriculum_scheduler as jcs, data_analyzer as jda,
                                                 data_sampler as jds, indexed_dataset as jid,
                                                 random_ltd as jltd)
from deepspeed_tpu.runtime.engine import NonFiniteLossError as JNonFinite
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.runtime import dataloader as dl
from deepspeed_tpu_torch.runtime import eigenvalue as eig
from deepspeed_tpu_torch.runtime import progressive_layer_drop as pld
from deepspeed_tpu_torch.runtime.config import load_config
from deepspeed_tpu_torch.runtime.data_pipeline import (curriculum_scheduler as cs, data_analyzer as da,
                                                       data_sampler as ds, indexed_dataset as idd,
                                                       random_ltd as ltd)
from deepspeed_tpu_torch.runtime.engine import NonFiniteLossError
from deepspeed_tpu_torch.runtime.heartbeat import read_heartbeats
from deepspeed_tpu_torch.runtime.tree import tree_leaves

VOCAB, SEQ = 96, 32

CURRICULUM = {"schedule_type": "fixed_linear", "min_difficulty": 16, "max_difficulty": 32,
              "schedule_config": {"total_curriculum_step": 3, "difficulty_step": 8}}
RANDOM_LTD = {"random_ltd_schedule": {"min_value": 8, "max_value": 24,
                                      "schedule_config": {"seq_per_step": 8,
                                                          "require_steps": 3}}}


@pytest.fixture
def one_device():
    topo = MeshTopology.from_axis_dict({"data": 1}, devices=jax.devices()[:1])
    yield topo
    reset_topology()


def _fixed_indices(seq_len, keep):
    """One index set for a (length, keep): what both patched samplers return."""
    keep = min(keep, seq_len)
    return np.sort(np.random.default_rng(seq_len * 7919 + keep).permutation(seq_len)[:keep])


@pytest.fixture
def fixed_samplers(monkeypatch):
    """Both packages' token samplers replaced by :func:`_fixed_indices`
    (their scans import the sampler at call time)."""
    calls = {"jax": 0, "port": 0}

    def jax_sampler(rng, seq_len, keep):
        calls["jax"] += 1
        return jnp.asarray(_fixed_indices(seq_len, keep))

    def port_sampler(generator, seq_len, keep):
        calls["port"] += 1
        return torch.from_numpy(_fixed_indices(seq_len, keep))

    monkeypatch.setattr(jltd, "sample_token_indices", jax_sampler)
    monkeypatch.setattr(ltd, "sample_token_indices", port_sampler)
    return calls


def _llama(layers=4):
    shape = dict(vocab=VOCAB, hidden=64, layers=layers, heads=4, kv_heads=2, seq=SEQ)
    jcfg, cfg = jllama.LlamaConfig.tiny(**shape), llama.LlamaConfig.tiny(**shape)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7))
    return jcfg, cfg, jparams, llama.params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")


class _Rows:
    """An indexable dataset of {input_ids, labels} rows of SEQ tokens."""

    def __init__(self, n=32, seed=0):
        ids = np.random.default_rng(seed).integers(0, VOCAB, (n, SEQ)).astype(np.int32)
        self.batch = llama.causal_lm_batch(ids)

    def __len__(self):
        return len(self.batch["input_ids"])

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.batch.items()}


# ------------------------------------------------------------ files and data
def test_mmidx_files_interoperate_byte_for_byte(tmp_path):
    rng = np.random.default_rng(0)
    docs = [[rng.integers(0, 60000, rng.integers(1, 40)) for _ in range(rng.integers(1, 4))]
            for _ in range(12)]
    for dtype in (np.uint16, np.int32, np.int64):
        prefixes = {}
        for side, mod in (("jax", jid), ("port", idd)):
            prefixes[side] = str(tmp_path / f"{side}_{np.dtype(dtype).name}")
            builder = mod.MMapIndexedDatasetBuilder(prefixes[side], dtype=dtype)
            for doc in docs:
                for sentence in doc:
                    builder.add_item(sentence)
                builder.end_document()
            builder.finalize()
        for ext in (".idx", ".bin"):
            assert filecmp.cmp(prefixes["jax"] + ext, prefixes["port"] + ext, shallow=False)
        # each package reads the other's files
        for reader, writer in ((idd, "jax"), (jid, "port")):
            data = reader.MMapIndexedDataset(prefixes[writer])
            flat = [s for doc in docs for s in doc]
            assert len(data) == len(flat) and data.dtype == np.dtype(dtype)
            for i, sentence in enumerate(flat):
                np.testing.assert_array_equal(data[i], np.asarray(sentence, dtype))
            np.testing.assert_array_equal(data.get(0, 1, 1), flat[0][1:2])
            assert list(data.doc_idx) == list(np.cumsum([0] + [len(d) for d in docs]))
    assert idd.best_fitting_dtype(32000) is jid.best_fitting_dtype(32000) is np.uint16
    assert idd.dataset_exists(prefixes["jax"])


def test_data_analyzer_outputs_equal_jax(tmp_path):
    rows = [np.arange(n) % 50 for n in np.random.default_rng(1).integers(1, 30, 23)]
    names, types = ["seqlen", "total"], [da.SINGLE_VALUE, da.ACCUMULATE]
    fns = [len, lambda s: float(np.sum(s))]
    for side, mod in (("jax", jda), ("port", da)):
        for worker in range(3):
            mod.DataAnalyzer(rows, names, fns, types, str(tmp_path / side), num_workers=3,
                             worker_id=worker).run_map()
        mod.DataAnalyzer(rows, names, fns, types, str(tmp_path / side), num_workers=3).run_reduce()
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "port"))
    for name in os.listdir(tmp_path / "jax"):
        if not name.endswith(".npz"):
            assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name, shallow=False), name
    got = da.DataAnalyzer.load_metric_to_sample(str(tmp_path / "jax"), "seqlen")
    ref = jda.DataAnalyzer.load_metric_to_sample(str(tmp_path / "port"), "seqlen")
    assert got.keys() == ref.keys() and all(np.array_equal(got[k], ref[k]) for k in got)
    assert da.DataAnalyzer.get_metric_percentiles(str(tmp_path / "port"), "seqlen", [10, 90]) \
        == jda.DataAnalyzer.get_metric_percentiles(str(tmp_path / "jax"), "seqlen", [10, 90])
    with pytest.raises(ValueError, match="non-integral"):
        da.DataAnalyzer(rows, ["bad"], [lambda s: 0.5], [da.SINGLE_VALUE],
                        str(tmp_path / "bad")).run_map()


def test_curriculum_difficulties_match_jax():
    configs = [CURRICULUM,
               {"curriculum_type": "fixed_root", "min_difficulty": 8, "max_difficulty": 64,
                "schedule_config": {"total_curriculum_step": 10, "difficulty_step": 4,
                                    "root_degree": 3}},
               {"schedule_type": "fixed_discrete", "difficulty": [8, 16, 32],
                "max_step": [2, 5]}]
    for conf in configs:
        ours, theirs = cs.CurriculumScheduler(conf), jcs.CurriculumScheduler(conf)
        assert [ours.update_difficulty(s) for s in range(14)] == \
            [theirs.update_difficulty(s) for s in range(14)]
        assert ours.state_dict() == theirs.state_dict()
    custom = cs.CurriculumScheduler({"schedule_type": "custom"})
    custom.set_custom_get_difficulty(lambda step: 3 * step)
    assert custom.get_difficulty(4) == 12


def test_sampler_order_and_resume_match_jax():
    for kw in (dict(total_samples=37, micro_batch_size=2, gradient_accumulation_steps=2,
                    data_parallel_size=2, data_parallel_rank=1, seed=5, curriculum=CURRICULUM),
               dict(total_samples=10, micro_batch_size=3, seed=1, drop_last=True)):
        ours, theirs = ds.DeepSpeedDataSampler(**kw), jds.DeepSpeedDataSampler(**kw)
        oi, ti = iter(ours), iter(theirs)
        for _ in range(9):
            assert (ours.get_seqlen(), next(oi)) == (theirs.get_seqlen(), next(ti))
        state = ours.state_dict()
        assert state == theirs.state_dict()
        resumed = ds.DeepSpeedDataSampler(**kw)
        resumed.load_state_dict(json.loads(json.dumps(state)))
        assert next(iter(resumed)) == next(oi)


def test_loaders_match_jax_with_resume():
    data = _Rows(n=21, seed=2)
    for make in (lambda m: m.DeepSpeedDataLoader(data, batch_size=4, seed=3),
                 lambda m: m.CurriculumDataLoader(data, batch_size=4, gradient_accumulation_steps=2,
                                                  curriculum=CURRICULUM, seed=3)):
        ours, theirs = make(dl), make(jdl)
        assert len(ours) == len(theirs)
        got = [b for epoch in range(2) for b in ours]
        ref = [b for epoch in range(2) for b in theirs]
        assert len(got) == len(ref) == 2 * len(ours)
        for a, b in zip(got, ref):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]))
        # a fresh loader resumed from the state after batch 3 yields batch 4
        fresh = make(dl)
        it = iter(fresh)
        for _ in range(3):
            next(it)
        resumed = make(dl)
        resumed.load_state_dict(json.loads(json.dumps(fresh.state_dict())))
        nxt = next(iter(resumed))
        for k in nxt:
            np.testing.assert_array_equal(nxt[k], got[3][k])
    repeat = deepspeed_tpu_torch.RepeatingLoader([1, 2])
    assert [next(repeat) for _ in range(5)] == [1, 2, 1, 2, 1]


# ---------------------------------------------------------------- random-LTD
def test_random_ltd_scheduler_and_sampler():
    for conf in (RANDOM_LTD, {"random_ltd": {"min_value": 128, "max_value": 2048,
                                             "seq_per_step": 64, "require_steps": 50}}):
        ours, theirs = ltd.RandomLTDScheduler(conf), jltd.RandomLTDScheduler(conf)
        assert [ours.update_seq(s) for s in range(60)] == [theirs.update_seq(s) for s in range(60)]
        assert ours.state_dict() == theirs.state_dict()
    gen = torch.Generator().manual_seed(0)
    idx = ltd.sample_token_indices(gen, 40, 12)
    assert idx.tolist() == sorted(set(idx.tolist())) and len(idx) == 12 and idx.max() < 40
    x = torch.arange(2 * 6 * 3, dtype=torch.float32).reshape(2, 6, 3)
    keep = torch.tensor([1, 4])
    np.testing.assert_array_equal(ltd.gather_tokens(x, keep).numpy(),
                                  np.asarray(jltd.gather_tokens(jnp.asarray(x.numpy()),
                                                                jnp.asarray(keep.numpy()))))
    y = ltd.scatter_tokens(x, torch.zeros(2, 2, 3), keep)
    ref = jltd.scatter_tokens(jnp.asarray(x.numpy()), jnp.zeros((2, 2, 3)),
                              jnp.asarray(keep.numpy()))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref))
    out = ltd.random_ltd_layer(lambda t: t * 0, x, torch.Generator().manual_seed(1), 4)
    assert int((out.abs().sum(-1) == 0).sum()) == 2 * 4


def test_random_ltd_scan_matches_jax(fixed_samplers):
    jcfg, cfg, jparams, params = _llama()
    ids = np.random.default_rng(8).integers(0, VOCAB, (2, SEQ)).astype(np.int32)
    batch = llama.causal_lm_batch(ids)
    state, jstate = {"keep": 12}, {"keep": 12}
    jloss_fn = jtf.scoped_random_ltd(jllama.make_loss_fn(jcfg), jstate)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))))(jparams)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss_fn = tf.scoped_random_ltd(llama.make_loss_fn(cfg), state)
    loss = loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                   torch.Generator().manual_seed(0))
    grads = torch.autograd.grad(loss, leaves)
    assert state["engaged"] and jstate["engaged"]
    # JAX traces its middle-layer body once (one call); the port draws a set a
    # middle layer: the same fixed set for both of them
    assert fixed_samplers == {"jax": 1, "port": 2}
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for g, jg in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-4)
    plain = llama.make_loss_fn(cfg)(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                    torch.Generator().manual_seed(0))
    assert abs(plain.item() - loss.item()) > 1e-4  # token dropping changed the loss


def _ltd_config(**over):
    conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "bf16": {"enabled": False}, "steps_per_print": 100, "seed": 3,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "data_efficiency": {"enabled": True, "seed": 11,
                                "data_sampling": {"curriculum_learning": {
                                    "enabled": True,
                                    "curriculum_metrics": {"seqlen": CURRICULUM}}},
                                "data_routing": {"enabled": True, "random_ltd": RANDOM_LTD}}}
    conf.update(over)
    return conf


def test_engine_with_training_data_and_data_efficiency_matches_jax(fixed_samplers, one_device):
    jcfg, cfg, jparams, params = _llama()
    data = _Rows(n=12, seed=4)
    jengine, _, jloader, _ = deepspeed_tpu.initialize(
        loss_fn=jllama.make_loss_fn(jcfg), model_parameters=jparams, training_data=data,
        config=_ltd_config(), topology=one_device)
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        loss_fn=llama.make_loss_fn(cfg), model_parameters=params, training_data=data,
        config=_ltd_config(), device="cpu")
    assert isinstance(loader, dl.CurriculumDataLoader)
    losses, jlosses, keeps, seqs = [], [], [], []
    for batch, jbatch in zip(loader, jloader):
        assert batch["input_ids"].shape == np.asarray(jbatch["input_ids"]).shape
        seqs.append(batch["input_ids"].shape[1])
        losses.append(float(engine.train_batch(batch).loss))
        jlosses.append(float(jengine.train_batch(jbatch).loss))
        keeps.append(engine._ltd_state["keep"])
        assert keeps[-1] == jengine._ltd_state["keep"]
    # 3 steps: the curriculum 16 -> 24 -> 32, the kept tokens 8 -> 8 -> 16
    assert (seqs, keeps) == ([16, 24, 32], [8, 8, 16])
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    # eval pins LTD off on both sides: the whole model's loss, equal to a
    # plain forward at the trained params
    batch = {k: v[:4] for k, v in data.batch.items()}
    ev = float(engine.eval_batch(batch))
    jev = float(jengine.eval_batch({k: jnp.asarray(v) for k, v in batch.items()}))
    plain = llama.make_loss_fn(cfg)(
        {**engine.state.params}, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    np.testing.assert_allclose(ev, jev, rtol=1e-4)
    np.testing.assert_allclose(ev, float(plain), rtol=1e-6)


def test_ltd_not_engaged_warns(caplog):
    params = {"w": torch.ones(4, 4)}

    def loss_fn(p, batch, rng):  # reads no configured_ltd()
        return ((batch["x"] @ p["w"]) ** 2).mean()

    engine, *_ = deepspeed_tpu_torch.initialize(
        loss_fn=loss_fn, model_parameters=params, device="cpu",
        config={"train_batch_size": 2, "bf16": {"enabled": False},
                "data_efficiency": {"enabled": True, "data_routing": {
                    "enabled": True, "random_ltd": RANDOM_LTD}}})
    batch = {"x": np.ones((2, 4), np.float32)}
    # initialize() logs an INFO note that names the warning: only what the
    # steps log counts
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="deepspeed_tpu_torch.runtime.engine"):
        engine.train_batch(batch)
        assert "never engaged" not in caplog.text
        engine.train_batch(batch)
    assert "never engaged token dropping" in caplog.text


# ------------------------------------------------------------------ watchdog
def _mlp_engines(conf, one_device):
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(8, 8)) / 3).astype(np.float32)

    def jloss(p, batch, r):
        return jnp.mean((batch["x"].astype(p["w"].dtype) @ p["w"]) ** 2).astype(jnp.float32)

    def loss(p, batch, r):
        return ((batch["x"].to(p["w"].dtype) @ p["w"]) ** 2).mean().float()

    jengine, *_ = deepspeed_tpu.initialize(loss_fn=jloss, model_parameters={"w": jnp.asarray(w)},
                                           config=conf, topology=one_device)
    engine, *_ = deepspeed_tpu_torch.initialize(loss_fn=loss, model_parameters={"w": w},
                                                config=conf, device="cpu")
    return jengine, engine


@pytest.mark.parametrize("precision", ["bf16", "fp16"])
def test_watchdog_raises_where_jax_does(precision, one_device):
    conf = {"train_batch_size": 2, "max_consecutive_skips": 3, "steps_per_print": 100,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    conf.update({"fp16": {"enabled": True, "initial_scale_power": 4}, "bf16": {"enabled": False}}
                if precision == "fp16" else {"bf16": {"enabled": True}})
    good = {"x": np.ones((2, 8), np.float32)}
    # bf16: a NaN input makes the loss and grads NaN; fp16: an inf input
    # overflows every step, which the loss scale cannot absorb
    bad = {"x": np.full((2, 8), np.nan if precision == "bf16" else np.inf, np.float32)}
    raised = {}
    for side, engine in zip(("jax", "port"), _mlp_engines(conf, one_device)):
        engine.train_batch(good)
        steps = [bad, bad, good, bad, bad, bad, bad] if precision == "fp16" else [bad] * 4
        error = JNonFinite if side == "jax" else NonFiniteLossError
        with pytest.raises(error, match="3 consecutive") as info:
            for i, batch in enumerate(steps):
                raised[side] = i
                engine.train_batch(batch)
        assert engine._consecutive_bad_steps == 3
        assert ("fp16 overflow-skipped" in str(info.value)) == (precision == "fp16")
    assert raised["port"] == raised["jax"] == (5 if precision == "fp16" else 2)


# -------------------------------------------------------------------- PLD, eig
def test_progressive_layer_drop_matches_jax():
    ours, theirs = pld.ProgressiveLayerDrop(theta=0.5, gamma=0.01), \
        jpld.ProgressiveLayerDrop(theta=0.5, gamma=0.01)
    for step in (0, 1, 10, 100, 1000, 100000):
        assert ours.update_state(step) == theirs.update_state(step)
    assert ours.get_state() == theirs.get_state()
    for theta in (0.5, 0.9, 1.0):
        for i in range(10):
            assert pld.layer_keep_prob(theta, i, 10) == jpld.layer_keep_prob(theta, i, 10)
    layer = lambda x, p: (x * p, None)
    x = torch.ones(3)
    wrapped = pld.pld_scan_layer(layer, 4)
    gen = torch.Generator().manual_seed(0)
    keep_p = pld.layer_keep_prob(0.5, 3, 4)
    outs = {round(float(wrapped(x, (3, gen, 0.5, 3.0))[0][0]), 5) for _ in range(40)}
    assert outs == {1.0, round(1 + 2 / keep_p, 5)}  # dropped, or kept and rescaled
    assert float(wrapped(x, (3, gen, 1.0, 3.0))[0][0]) == 3.0  # theta 1 keeps every layer


def test_eigenvalue_matches_jax():
    a = np.diag([5.0, 2.0, 1.0]).astype(np.float32)

    def quad(p, batch, rng):
        return 0.5 * p["x"] @ torch.from_numpy(a) @ p["x"]

    out = eig.Eigenvalue(max_iter=50, tol=1e-4).compute_eigenvalue(quad, {"x": torch.ones(3)}, None)
    assert abs(out["eigenvalue"] - 5.0) < 0.05
    rng = np.random.default_rng(2)
    w1, w2 = rng.normal(size=(6, 8)).astype(np.float32), rng.normal(size=(8, 1)).astype(np.float32)
    x, y = rng.normal(size=(16, 6)).astype(np.float32), rng.normal(size=(16, 1)).astype(np.float32)

    def jmlp(p, batch, r):
        return jnp.mean((jnp.tanh(batch["x"] @ p["w1"]) @ p["w2"] - batch["y"]) ** 2)

    def mlp(p, batch, r):
        return ((torch.tanh(batch["x"] @ p["w1"]) @ p["w2"] - batch["y"]) ** 2).mean()

    kw = dict(max_iter=300, tol=1e-7)
    ref = jeig.Eigenvalue(**kw).compute_eigenvalue(
        jmlp, {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)},
        {"x": jnp.asarray(x), "y": jnp.asarray(y)})["eigenvalue"]
    got = eig.Eigenvalue(**kw).compute_eigenvalue(
        mlp, {"w1": torch.from_numpy(w1), "w2": torch.from_numpy(w2)},
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})["eigenvalue"]
    assert got == pytest.approx(ref, rel=1e-3)
    from deepspeed_tpu_torch.ops.attention.flash import flash_attention
    with pytest.raises(RuntimeError, match="differentiable once"):
        eig.Eigenvalue(max_iter=2).compute_eigenvalue(
            lambda p, b, r: flash_attention(p["q"], p["q"], p["q"]).sum(),
            {"q": torch.randn(1, 8, 2, 64)}, None)


# ----------------------------------------------------------------- heartbeat
def test_heartbeat_stamps_around_checkpoint_io_match_jax(tmp_path, one_device):
    conf = {"train_batch_size": 2, "steps_per_print": 100, "bf16": {"enabled": False},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "fault_tolerance": {"heartbeat": True, "heartbeat_interval_s": 0.0}}
    stamps = {}
    for side, engine in zip(("jax", "port"), _mlp_engines(
            {**conf, "fault_tolerance": {**conf["fault_tolerance"],
                                         "heartbeat_dir": str(tmp_path / "hb")}}, one_device)):
        seen = stamps[side] = []
        stamp = engine.heartbeat.stamp
        engine.heartbeat.stamp = lambda step, phase=None, force=False: (
            seen.append((step, phase, force)), stamp(step, phase=phase, force=force))[1]
        engine.train_batch({"x": np.ones((2, 8), np.float32)})
        engine.save_checkpoint(str(tmp_path / side))
        engine.train_batch({"x": np.ones((2, 8), np.float32)})
        engine.load_checkpoint(str(tmp_path / side))
        engine.heartbeat.stamp = stamp
    assert stamps["port"] == stamps["jax"] == [
        (1, None, False), (1, "checkpoint_save", True), (1, None, True), (2, None, False),
        (2, "checkpoint_load", True), (1, "resumed", True)]
    beat = read_heartbeats(str(tmp_path / "hb"))[0]
    assert beat["step"] == 1 and beat["phase"] == "resumed"
    engine.heartbeat.close()


def test_training_sections_load():
    conf = load_config({"train_batch_size": 2, "max_consecutive_skips": 2,
                        "curriculum_learning": {"enabled": True, **CURRICULUM},
                        "data_efficiency": {"enabled": True, "data_sampling": {"num_workers": 0}},
                        "fault_tolerance": {"heartbeat": False}})
    assert conf.max_consecutive_skips == 2
    assert conf.effective_curriculum() == CURRICULUM  # the legacy section
    # the knobs that bound collectives and process-group setup load (ROADMAP 11a)
    for knobs in ({"collective_timeout_s": 5.0}, {"init_retries": 1},
                  {"init_retry_backoff_s": 0.25}):
        ft = load_config({"train_batch_size": 2, "fault_tolerance": knobs}).fault_tolerance
        assert all(getattr(ft, k) == v for k, v in knobs.items())
    with pytest.raises(ValueError, match="unknown config field 'future_key'"):
        load_config({"train_batch_size": 2, "data_efficiency": {"future_key": 1}})
    with pytest.raises(ValueError, match="heartbeat_dir"):
        load_config({"train_batch_size": 2, "fault_tolerance": {"heartbeat": True}})

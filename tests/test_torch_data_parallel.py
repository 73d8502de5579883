"""Data-parallel training in the port against the JAX engine on a
``{"data": 2}`` mesh, on the CPU.

One spawn of 2 gloo ranks (``tests/torch_dist_workers.py``, scenario ``dp``)
trains a 2-layer, width-64 Llama through ``deepspeed_tpu_torch.initialize``
(``device="cpu"``, so the kernels' plain versions) with ``fused_adam``, micro
2 a rank x gas 2, clipping and WarmupLR for 3 ``train_batch`` steps on
global batches of 8 rows; rank 1 starts from other params, which the
engine's broadcast from rank 0 replaces.  Here ``deepspeed_tpu.initialize``
trains the same weights (carried by ``params_from_jax``) on the same global
batches over ``jax.devices()[:2]``, its Pallas kernels in interpret mode.
Losses agree within 1e-6 relative, the params by ``_assert_params_close``'s
rule, and the two ranks bit for bit.  The same spawn shows an fp16 overflow
planted on rank 1 alone skipping the step on both ranks, a checkpoint
written by rank 0 alone that loads in the JAX package and in the port at
one rank, a save that fails on rank 0 raising on both, telemetry that
counts the global batch, and the refusals above one rank."""

import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.ops import _pallas
from deepspeed_tpu.parallel.mesh import MeshTopology as JMesh
from deepspeed_tpu.parallel.mesh import reset_topology
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.runtime.config import load_config

from . import torch_dist_workers as W
from .test_torch_train import _assert_params_close, _flat

SHAPE = dict(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, seq=32)
SPAWN_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' results, the JAX engine after its 3 steps, its metrics,
    the checkpoint dir, the JAX and port configs)."""
    out = str(tmp_path_factory.mktemp("dp"))
    jcfg = jllama.LlamaConfig.tiny(**SHAPE)
    cfg = llama.LlamaConfig.tiny(**SHAPE)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(11))
    params = llama.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    torch.save({"cfg": cfg, "params": params}, os.path.join(out, "spec.pt"))
    started = W.start("dp", 2, out, SPAWN_TIMEOUT_S)  # the ranks train while JAX does
    mp = pytest.MonkeyPatch()
    mp.setattr(_pallas, "INTERPRET", True)
    topo = JMesh.from_axis_dict({"data": 2}, devices=jax.devices()[:2])
    try:
        jengine, *_ = deepspeed_tpu.initialize(loss_fn=jllama.make_loss_fn(jcfg),
                                               model_parameters=jparams, config=W.dp_config(),
                                               topology=topo)
        jmetrics = [jengine.train_batch(llama.causal_lm_batch(ids))
                    for ids in W.dp_batches(cfg.vocab_size, cfg.max_seq_len)]
        jeval = float(jengine.eval_batch(llama.causal_lm_batch(W.dp_batches(
            cfg.vocab_size, cfg.max_seq_len, seed=90, steps=1)[0])))
        logs = W.wait(started)
        assert all(rc == 0 for rc, _ in logs), "\n".join(text[-3000:] for _, text in logs)
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        yield ranks, jengine, jmetrics, jeval, os.path.join(out, "ckpt"), jcfg, cfg, topo
    finally:
        mp.undo()
        reset_topology()


def test_batch_layout_and_sizes(run):
    ranks, jengine = run[0], run[1]
    for res in ranks:
        world, dp, tb, micro, gas = res["sizes"]
        assert (world, dp) == (2, 2)
        assert (tb, micro, gas) == (jengine.train_batch_size, jengine.micro_batch_size,
                                    jengine.gradient_accumulation_steps) == (8, 2, 2)


def test_training_matches_jax_on_a_data_mesh(run):
    ranks, jengine, jmetrics, jeval = run[:4]
    lrs = []
    for step, jm in enumerate(jmetrics):
        for res in ranks:
            m = res["steps"][step]
            np.testing.assert_allclose(m["loss"], float(jm.loss), rtol=1e-6)
            np.testing.assert_allclose(m["grad_norm"], float(jm.grad_norm), rtol=1e-4)
            np.testing.assert_allclose(m["lr"], float(jm.lr), rtol=1e-6)
        lrs.append(ranks[0]["steps"][step]["lr"])
    tree = {}
    for name, p in ranks[0]["params"].items():  # the dotted names back into a tree
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p
    _assert_params_close(tree, jengine.state.params, lrs)
    for res in ranks:
        np.testing.assert_allclose(res["eval"], jeval, rtol=1e-5)


def test_the_two_ranks_agree_bit_for_bit(run):
    r0, r1 = run[0]
    assert [s["digest"] for s in r0["steps"]] == [s["digest"] for s in r1["steps"]]
    assert [s["loss"] for s in r0["steps"]] == [s["loss"] for s in r1["steps"]]
    for name, p in r0["params"].items():
        assert torch.equal(p, r1["params"][name]), name


def test_one_flat_gradient_all_reduce_and_the_loss_a_step(run):
    """The comms logger counts, a step, one all-reduce of the fp32 grads (4
    bytes a param) and one of the loss (4 bytes)."""
    for res in run[0]:
        grads = 4 * res["n_params"]
        assert res["logged"]["all_reduce"] == {grads: W.DP_STEPS, 4: W.DP_STEPS}


def test_fp16_overflow_on_one_rank_skips_the_step_on_both(run):
    f0, f1 = (res["fp16"] for res in run[0])
    for f in (f0, f1):
        assert not f["first_skipped"] and f["skipped"] and f["params_kept"]
        assert f["step"] == 1 and f["scale_after"] == f["scale_before"] / 2
    assert f0["digest"] == f1["digest"]


def test_checkpoint_is_one_set_of_files_that_loads_in_jax_and_at_one_rank(run):
    ranks, jengine, _, _, ck, jcfg, cfg, topo = run
    assert [res["writes"] for res in ranks] == [1, 0]  # rank 0 alone writes
    tag = ranks[0]["tag"]
    assert ranks[1]["tag"] == tag == "global_step3"
    assert sorted(os.listdir(ck)) == sorted(["checkpoint_index.json", "latest", tag])
    for res in ranks:  # every rank loads the same files back
        assert res["reloaded_digest"] == ranks[0]["steps"][-1]["digest"]
        assert res["reloaded_step"] == (3, 3)
    # the JAX package loads it
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(12))
    jfresh, *_ = deepspeed_tpu.initialize(loss_fn=jllama.make_loss_fn(jcfg),
                                          model_parameters=jparams, config=W.dp_config(),
                                          topology=topo)
    jfresh.load_checkpoint(ck)
    assert jfresh.global_steps == 3
    want = _flat(jfresh.state.params)
    for name, p in ranks[0]["params"].items():
        np.testing.assert_array_equal(p.numpy(), want[name], err_msg=name)
    # the port loads it at one rank
    params = llama.init_params(cfg, torch.Generator().manual_seed(3))
    engine, *_ = deepspeed_tpu_torch.initialize(
        loss_fn=llama.make_loss_fn(cfg), model_parameters=params,
        config=W.dp_config(gradient_accumulation_steps=4), device="cpu")
    engine.load_checkpoint(ck)
    assert engine.global_steps == 3 and engine.state.step == 3
    for name, p in W._flat(engine.state.params):
        assert torch.equal(p, ranks[0]["params"][name]), name


def test_telemetry_counts_the_whole_job(run):
    """Above one rank a record counts the global batch: its samples, its
    tokens and every rank's FLOPs, one device a rank, so the figures equal
    a one-process run's over the same global batch, and MFU is each rank's
    share of its device."""
    cfg = run[6]
    params = llama.init_params(cfg, torch.Generator().manual_seed(3))
    one, *_ = deepspeed_tpu_torch.initialize(
        loss_fn=llama.make_loss_fn(cfg), model_parameters=params, device="cpu",
        config=W.dp_config(train_micro_batch_size_per_gpu=4, telemetry=W.TELEMETRY))
    one.train_batch(llama.causal_lm_batch(
        W.dp_batches(cfg.vocab_size, cfg.max_seq_len, steps=1, seed=95)[0]))
    want = one._last_telemetry_record
    tokens = 8 * cfg.max_seq_len
    assert one.telemetry.n_chips == 1 and want["flops_per_step"] > 0
    for res in run[0]:
        tel = res["telemetry"]
        rec, secs = tel["record"], tel["record"]["step_time_ms"] / 1e3
        assert tel["n_chips"] == 2
        assert rec["flops_per_step"] == want["flops_per_step"] == 2 * tel["rank_flops"]
        np.testing.assert_allclose(rec["samples_per_sec"] * secs, 8, rtol=1e-9)
        np.testing.assert_allclose(rec["tokens_per_sec"] * secs, tokens, rtol=1e-9)
        np.testing.assert_allclose(rec["mfu"], tel["rank_flops"] / secs / 1e12, rtol=1e-9)


def test_a_failed_save_on_rank_0_raises_on_every_rank(run):
    r0, r1 = (res["failed_save"] for res in run[0])
    assert r0 == {"type": "RuntimeError", "message": "the disk is gone",
                  "checkpoint_error": False}
    assert r1["checkpoint_error"] and "rank 0 failed to save" in r1["message"]
    assert "RuntimeError: the disk is gone" in r1["message"]


def test_refusals_above_one_rank_name_their_item(run):
    for res in run[0]:
        refusals = res["refusals"]
        for name in ("zero1", "zero2", "zero3", "offload_optimizer"):
            assert refusals[name] is not None and "ROADMAP item 11b" in refusals[name], name
        assert refusals["tensor"] is not None and "ROADMAP item 11c" in refusals["tensor"]


@pytest.mark.parametrize("axis,item", [("fsdp", "11b"), ("tensor", "11c"), ("sequence", "11d"),
                                       ("expert", "11e"), ("pipe", "11f")])
def test_every_other_mesh_axis_names_its_item(axis, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        load_config({"train_batch_size": 2, "mesh": {"data": -1, axis: 2}})
    assert load_config({"train_batch_size": 2, "mesh": {"data": 2}}).mesh.data == 2


def test_a_two_rank_mesh_in_one_process_raises_jax_s_error():
    """{"data": 2} loads, and at one rank the engine raises the ValueError of
    JAX's MeshTopology.build."""
    cfg = llama.LlamaConfig.tiny(**SHAPE)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    conf = W.dp_config(mesh={"data": 2})
    with pytest.raises(ValueError, match="multiply to 2 but 1 devices are present") as err:
        deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg), model_parameters=params,
                                       config=conf, device="cpu")
    with pytest.raises(ValueError) as jerr:
        JMesh.from_axis_dict({"data": 2}, devices=jax.devices()[:1])
    assert str(err.value) == str(jerr.value)

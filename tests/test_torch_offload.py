"""ZeRO-Offload in the port on the CPU against the JAX package's, same numpy
inputs and weights (tiny Llama, fp32, ``params_from_jax``):

- ``offload_optimizer: cpu`` and ``nvme`` train step for step with JAX's
  offloaded engine (gas 2, clipping, WarmupLR): losses at rtol 1e-5, params
  within the Adam rule (every element within 2 x sum(lr), 99.9 % within
  1e-5);
- a checkpoint of JAX's offloaded engine loads into the port's offloaded
  engine and the next step matches JAX's, and the reverse; an offloaded
  checkpoint loads into a resident engine; the offloaded save writes the
  resident layout, leaf files byte-identical to JAX's;
- ``eval_batch``, ``get_fp32_params`` and the tensor-fragment API agree;
- the refusals raise JAX's exception types, and ``offload_param: cpu`` alone
  changes nothing in either package.

The JAX engines are built once for the module (their compiles are most of
the cost); their Pallas kernels take the plain reference off the TPU, as the
port's kernels take their plain versions on the CPU."""

import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.parallel.mesh import MeshTopology, reset_topology
from deepspeed_tpu.utils import tensor_fragment as jtf
from deepspeed_tpu_torch import utils as tf
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.runtime import checkpointing as ckpt
from deepspeed_tpu_torch.runtime.tree import tree_leaves

from .test_torch_train import LR, _assert_params_close, _config, _ids, _no_remat_configs

ADAMW = {"type": "adamw", "params": {"lr": LR, "weight_decay": 0.01}}
STEPS = 3


def _offload_config(device, nvme_path=None, **kw):
    section = {"device": device, **({"nvme_path": nvme_path} if nvme_path else {})}
    return _config(optimizer=ADAMW, zero_optimization={"stage": 2, "offload_optimizer": section},
                   **kw)


def _batches():
    return [llama.causal_lm_batch(_ids(40 + s, 4)) for s in range(STEPS)]


def _jax_engine(jcfg, jparams, conf):
    topo = MeshTopology.from_axis_dict({"data": 1}, devices=jax.devices()[:1])
    return deepspeed_tpu.initialize(loss_fn=jllama.make_loss_fn(jcfg), model_parameters=jparams,
                                    config=conf, topology=topo)[0]


def _port_engine(cfg, params, conf):
    return deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg), model_parameters=params,
                                          config=conf, device="cpu")[0]


def _params(seed):
    jcfg, cfg = _no_remat_configs()
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jparams, llama.params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's offloaded engines: ``cpu`` (2 steps, a save, a third step, then
    the probes of the fragment API) and ``nvme`` (3 steps)."""
    root = tmp_path_factory.mktemp("jax_offload")
    jcfg, _, jparams, _ = _params(21)
    batches = _batches()
    out = {}
    for device in ("cpu", "nvme"):
        conf = _offload_config(device, str(root / "swap") if device == "nvme" else None)
        jengine = _jax_engine(jcfg, jparams, conf)
        losses = [float(jengine.train_batch(b).loss) for b in batches[:2]]
        if device == "cpu":
            jengine.save_checkpoint(str(root / "ck"))
        losses.append(float(jengine.train_batch(batches[2]).loss))
        out[device] = {"engine": jengine, "losses": losses,
                       "params": jax.tree_util.tree_map(np.asarray, jengine.get_fp32_params())}
        reset_topology()
    out["ckpt"] = str(root / "ck")
    out["jcfg"] = jcfg
    return out


@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_offloaded_steps_match_jax(jax_runs, device, tmp_path):
    _, cfg, _, params = _params(21)
    engine = _port_engine(cfg, params, _offload_config(
        device, str(tmp_path) if device == "nvme" else None))
    assert engine.state is None and engine._offload_state.device == device
    lrs, losses = [], []
    for b in _batches():
        m = engine.train_batch(b)
        lrs.append(m.lr)
        losses.append(float(m.loss))
    np.testing.assert_allclose(losses, jax_runs[device]["losses"], rtol=1e-5)
    _assert_params_close(tree_map_tensor(engine.get_fp32_params()), jax_runs[device]["params"],
                         lrs)
    if device == "nvme":
        files = os.listdir(os.path.join(str(tmp_path), "dstpu_opt_swap"))
        assert sorted(files) == sorted(f"{k}.{s}.bin" for k in engine._offload_shapes
                                       for s in "mv")


def tree_map_tensor(tree):
    if isinstance(tree, dict):
        return {k: tree_map_tensor(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def test_checkpoints_cross_between_offloaded_engines(jax_runs, tmp_path):
    """JAX's offloaded checkpoint (step 2) into a port offloaded engine from
    another seed: its third step matches JAX's.  The port's offloaded
    checkpoint holds the resident layout and JAX's leaf bytes, and loads
    into JAX's offloaded engine, whose third step matches again."""
    _, cfg, _, params = _params(21)
    _, _, _, other_params = _params(22)
    batches = _batches()
    conf = _offload_config("cpu")
    other = _port_engine(cfg, other_params, conf)
    tag, _ = other.load_checkpoint(jax_runs["ckpt"])
    assert tag == "global_step2" and other.global_steps == 2
    assert other._offload_state.step_count == 2
    m = other.train_batch(batches[2])
    np.testing.assert_allclose(float(m.loss), jax_runs["cpu"]["losses"][2], rtol=1e-5)
    lrs = [float(other.lr_schedule(s)) for s in range(3)]
    _assert_params_close(tree_map_tensor(other.get_fp32_params()), jax_runs["cpu"]["params"], lrs)

    engine = _port_engine(cfg, params, conf)
    for b in batches[:2]:
        engine.train_batch(b)
    engine.save_checkpoint(str(tmp_path / "port"))
    jfiles = {e["key"]: e for e in ckpt.read_metadata(
        os.path.join(jax_runs["ckpt"], tag))["manifest"]}
    pfiles = {e["key"]: e for e in ckpt.read_metadata(str(tmp_path / "port" / tag))["manifest"]}
    assert set(pfiles) - {"torch_rng"} == set(jfiles)
    for key in jfiles:
        assert pfiles[key]["shape"] == jfiles[key]["shape"], key
        assert pfiles[key]["dtype"] == jfiles[key]["dtype"], key
    for key in ("step", "opt_state.step"):
        assert ((tmp_path / "port" / tag / f"{key}.npy").read_bytes()
                == open(os.path.join(jax_runs["ckpt"], tag, f"{key}.npy"), "rb").read())
    jengine = jax_runs["cpu"]["engine"]
    jengine.load_checkpoint(str(tmp_path / "port"))
    assert jengine.global_steps == 2
    jm = jengine.train_batch(batches[2])
    np.testing.assert_allclose(float(jm.loss), jax_runs["cpu"]["losses"][2], rtol=1e-5)
    _assert_params_close(tree_map_tensor(jax.tree_util.tree_map(np.asarray,
                                                                jengine.get_fp32_params())),
                         jax_runs["cpu"]["params"], lrs)


@pytest.mark.parametrize("source", ["jax", "port"])
def test_offloaded_checkpoint_loads_into_a_resident_engine(jax_runs, source, tmp_path):
    _, cfg, _, params = _params(21)
    batches = _batches()
    if source == "jax":
        load_dir = jax_runs["ckpt"]
    else:
        engine = _port_engine(cfg, params, _offload_config("cpu"))
        for b in batches[:2]:
            engine.train_batch(b)
        load_dir = str(tmp_path)
        engine.save_checkpoint(load_dir)
    resident = _port_engine(cfg, _params(23)[3], _config(optimizer=ADAMW))
    resident.load_checkpoint(load_dir)
    assert resident.state.step == 2 and resident.global_steps == 2
    m = resident.train_batch(batches[2])
    np.testing.assert_allclose(float(m.loss), jax_runs["cpu"]["losses"][2], rtol=1e-5)
    lrs = [float(resident.lr_schedule(s)) for s in range(3)]
    _assert_params_close(resident.state.params, jax_runs["cpu"]["params"], lrs)


def test_eval_fp32_params_and_fragments_agree_with_jax(jax_runs):
    """After JAX's nvme engine's 3 steps and the port's: ``eval_batch``,
    ``get_fp32_params``, ``safe_get_full_fp32_param``,
    ``safe_get_full_optimizer_state``; ``safe_set_full_fp32_param`` moves
    the next eval in both packages alike."""
    _, cfg, _, params = _params(21)
    jengine = jax_runs["nvme"]["engine"]
    import tempfile
    with tempfile.TemporaryDirectory() as swap:
        engine = _port_engine(cfg, params, _offload_config("nvme", swap))
        lrs = [engine.train_batch(b).lr for b in _batches()]
        probe = llama.causal_lm_batch(_ids(77, 4))
        np.testing.assert_allclose(float(engine.eval_batch(probe)),
                                   float(jengine.eval_batch(probe)), rtol=1e-5)
        got, want = engine.get_fp32_params(), jengine.get_fp32_params()
        assert [k for k, _ in ckpt.flatten_with_keys(got)] == \
            [k for k, _ in ckpt.flatten_with_keys(want)]
        for path in ("layers.attn.wq", "embed", "final_norm"):
            a = tf.safe_get_full_fp32_param(engine, path)
            b = np.asarray(jtf.safe_get_full_fp32_param(jengine, path))
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 2 * sum(lrs)
            for name in ("exp_avg", "exp_avg_sq"):
                ma = tf.safe_get_full_optimizer_state(engine, path, name)
                mb = jtf.safe_get_full_optimizer_state(jengine, path, name)
                np.testing.assert_allclose(ma, np.asarray(mb).reshape(ma.shape), rtol=1e-3,
                                           atol=1e-7)
        value = np.zeros_like(tf.safe_get_full_fp32_param(engine, "final_norm"))
        tf.safe_set_full_fp32_param(engine, "final_norm", value)
        jtf.safe_set_full_fp32_param(jengine, "final_norm", value)
        assert not tf.safe_get_full_fp32_param(engine, "final_norm").any()
        np.testing.assert_allclose(float(engine.eval_batch(probe)),
                                   float(jengine.eval_batch(probe)), rtol=1e-5)
        assert tf.safe_get_full_grad(engine, "embed") is None
        engine._offload_state.close()


def _refusal(package, conf, **kw):
    jcfg, cfg, jparams, params = _params(21)
    if package == "jax":
        topo = MeshTopology.from_axis_dict({"data": 1}, devices=jax.devices()[:1])
        try:
            return deepspeed_tpu.initialize(loss_fn=jllama.make_loss_fn(jcfg),
                                            model_parameters=kw.pop("params", jparams),
                                            config=conf, topology=topo, **kw)[0]
        finally:
            reset_topology()
    return deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg),
                                          model_parameters=kw.pop("params", params), config=conf,
                                          device="cpu", **kw)[0]


REFUSALS = {
    "fp16_with_offload": (lambda p: _offload_config("cpu", fp16={"enabled": True}, bf16=None),
                          "fp16"),
    "lion_with_offload": (lambda p: dict(_offload_config("cpu"), optimizer={
        "type": "lion", "params": {"lr": LR}}), "adam/adamw"),
    "nvme_without_layer_fn": (lambda p: _config(optimizer=ADAMW, zero_optimization={
        "stage": 3, "offload_param": {"device": "nvme", "nvme_path": p}}), "layer_fn"),
}


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_raise_jax_exception_types(case, package, tmp_path):
    make, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        _refusal(package, make(str(tmp_path)))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_offload_param_cpu_alone_changes_nothing(package):
    """Only ``nvme`` engages layer streaming; ``offload_param: cpu`` trains
    resident, in both packages (JAX ``engine.py:235-259``)."""
    conf = _config(optimizer=ADAMW, zero_optimization={
        "stage": 3, "offload_param": {"device": "cpu", "pin_memory": True, "buffer_count": 2}})
    engine = _refusal(package, conf)
    assert engine._nvme_trainer is None and engine.offload_device is None
    assert engine.state is not None


def test_offload_config_fields_and_telemetry(tmp_path):
    """Both sections take JAX's fields; the offloaded step reports its parts
    and no FLOP count (the step is no one device program)."""
    _, cfg, _, params = _params(21)
    conf = _offload_config("cpu", telemetry={"enabled": True,
                                             "jsonl_path": str(tmp_path / "t.jsonl")})
    conf["zero_optimization"]["offload_optimizer"].update(
        buffer_count=8, pin_memory=True, pipeline_read=True, pipeline_write=True, fast_init=True,
        ratio=0.5)
    conf["zero_optimization"]["offload_param"] = {"device": "none", "buffer_size": 10,
                                                  "max_in_cpu": 0}
    engine = _port_engine(cfg, params, conf)
    assert engine._offload_state.pinned_bytes == 0  # pin_memory is for a CUDA engine
    engine.train_batch(_batches()[0])
    assert engine.telemetry.flops_per_step is None
    assert set(engine.offload_times) == {"compute", "grads_d2h", "cpu_adam", "push_h2d"}
    assert len(tree_leaves(engine._compute)) == len(engine._offload_shapes)

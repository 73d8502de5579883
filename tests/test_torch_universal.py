"""The universal checkpoint in the port on the CPU against the JAX package's:
``ds_to_universal`` of one checkpoint directory gives the same files from
both packages (atom ``.npy`` bytes and the parsed metadata), also with
``--strip-vocab-padding``, for Lion's atoms, and the int8-moment refusal;
``zero_to_fp32`` and the CLI (``python -m
deepspeed_tpu_torch.checkpoint.universal``); each package resumes from the
other's universal directory (``load_universal_checkpoint: true``) and the
next step matches the unbroken run, into resident and offloaded port
engines; a stripped vocab comes back zero-padded; another optimizer
resumes with a warning for the moments it cannot match.  Tiny Llama, fp32."""

import json
import logging
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint import universal as juniversal
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.parallel.mesh import MeshTopology, reset_topology
from deepspeed_tpu_torch.checkpoint import universal
from deepspeed_tpu_torch.models import llama

from .test_torch_train import ADAM8, LR, _assert_params_close, _config, _ids, _no_remat_configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LION = {"type": "lion", "params": {"lr": LR, "weight_decay": 0.01}}
ADAMW = {"type": "adamw", "params": {"lr": LR, "weight_decay": 0.01}}
STRIP = 90  # of the tiny vocabulary's 96 rows


def _params(seed):
    jcfg, cfg = _no_remat_configs()
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jparams, llama.params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _batches():
    return [llama.causal_lm_batch(_ids(60 + s, 4)) for s in range(3)]


def _jax_engine(jcfg, jparams, conf):
    topo = MeshTopology.from_axis_dict({"data": 1}, devices=jax.devices()[:1])
    try:
        return deepspeed_tpu.initialize(loss_fn=jllama.make_loss_fn(jcfg),
                                        model_parameters=jparams, config=conf, topology=topo)[0]
    finally:
        reset_topology()


def _port_engine(cfg, params, conf):
    return deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg), model_parameters=params,
                                          config=conf, device="cpu")[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Checkpoints after 2 steps: JAX's (adamw), the port's (adamw, lion,
    fused_adam8bit); the unbroken third step of each adamw engine."""
    root = tmp_path_factory.mktemp("universal")
    jcfg, cfg, jparams, params = _params(31)
    batches = _batches()
    out = {"root": root}
    jengine = _jax_engine(jcfg, jparams, _config(optimizer=ADAMW))
    for b in batches[:2]:
        jengine.train_batch(b)
    out["jax"] = os.path.join(str(root / "jax"), jengine.save_checkpoint(str(root / "jax")))
    out["jax_loss3"] = float(jengine.train_batch(batches[2]).loss)
    out["jax_params3"] = jax.tree_util.tree_map(np.asarray, jengine.state.params)
    for name, opt in (("port", ADAMW), ("lion", LION), ("adam8", ADAM8)):
        engine = _port_engine(cfg, params, _config(optimizer=opt))
        lrs = [engine.train_batch(b).lr for b in batches[:2]]
        out[name] = os.path.join(str(root / name), engine.save_checkpoint(str(root / name)))
        if name == "port":
            m = engine.train_batch(batches[2])
            out["port_loss3"], out["lrs"] = float(m.loss), lrs + [m.lr]
            out["port_params3"] = {k: v for k, v in engine.get_fp32_params().items()}
    return out


def _tree_files(root):
    found = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            found[os.path.relpath(path, root)] = path
    return found


def _assert_same_universal(a, b):
    fa, fb = _tree_files(a), _tree_files(b)
    assert sorted(fa) == sorted(fb)
    for rel in fa:
        if rel == "universal_metadata.json":
            assert json.load(open(fa[rel])) == json.load(open(fb[rel]))
        else:
            assert open(fa[rel], "rb").read() == open(fb[rel], "rb").read(), rel


@pytest.mark.parametrize("strip", [None, STRIP])
@pytest.mark.parametrize("source", ["jax", "port", "lion"])
def test_conversion_gives_the_same_files_in_both_packages(runs, source, strip, tmp_path):
    universal.ds_to_universal(runs[source], str(tmp_path / "port"), strip_vocab_padding=strip)
    juniversal.ds_to_universal(runs[source], str(tmp_path / "jax"), strip_vocab_padding=strip)
    _assert_same_universal(str(tmp_path / "port"), str(tmp_path / "jax"))
    meta = json.load(open(tmp_path / "port" / "universal_metadata.json"))
    atoms = meta["params"]["embed"]
    assert atoms["fp32"] == [STRIP if strip else 96, 64]
    assert sorted(atoms) == (["exp_avg", "fp32"] if source == "lion"
                             else ["exp_avg", "exp_avg_sq", "fp32"])


def test_int8_moments_refuse_a_vocab_strip_in_both_packages(runs, tmp_path):
    for i, convert in enumerate((universal.ds_to_universal, juniversal.ds_to_universal)):
        with pytest.raises(ValueError, match="quantized int8"):
            convert(runs["adam8"], str(tmp_path / str(i)), strip_vocab_padding=STRIP)
    universal.ds_to_universal(runs["adam8"], str(tmp_path / "port"))
    juniversal.ds_to_universal(runs["adam8"], str(tmp_path / "jax"))
    _assert_same_universal(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_zero_to_fp32_and_the_cli_match_jax(runs, tmp_path):
    got = universal.zero_to_fp32(runs["port"], str(tmp_path / "port.npz"))
    want = juniversal.zero_to_fp32(runs["port"], str(tmp_path / "jax.npz"))
    assert sorted(got) == sorted(want) and "layers.attn.wq" in got
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    env = dict(os.environ, PYTHONPATH=ROOT)
    for args in ([runs["jax"], str(tmp_path / "cli"), "--strip-vocab-padding", str(STRIP)],
                 ["--zero-to-fp32", runs["jax"], str(tmp_path / "cli.npz")]):
        proc = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.checkpoint.universal",
                               *args], cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
    juniversal.ds_to_universal(runs["jax"], str(tmp_path / "ref"), strip_vocab_padding=STRIP)
    _assert_same_universal(str(tmp_path / "cli"), str(tmp_path / "ref"))
    npz, ref = np.load(tmp_path / "cli.npz"), juniversal.zero_to_fp32(runs["jax"])
    assert sorted(npz.files) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(npz[key], ref[key])


@pytest.mark.parametrize("into", ["resident", "offload"])
def test_port_resumes_from_the_jax_universal_dir(runs, into, tmp_path):
    """JAX's checkpoint through JAX's converter; a port engine from another
    seed resumes (``load_dir`` the checkpoint root: the atoms sit under
    ``<tag>/``) and its third step matches JAX's unbroken one."""
    root = tmp_path / "ck"
    tag = os.path.basename(runs["jax"])
    juniversal.ds_to_universal(runs["jax"], str(root / tag))
    (root / "latest").write_text(tag)
    _, cfg, _, other = _params(32)
    conf = _config(optimizer=ADAMW, load_universal_checkpoint=True)
    if into == "offload":
        conf["zero_optimization"] = {"stage": 2, "offload_optimizer": {"device": "cpu"}}
    engine = _port_engine(cfg, other, conf)
    engine.load_checkpoint(str(root))
    assert engine.global_steps == 2 and engine.lr_scheduler.last_step == 2
    m = engine.train_batch(_batches()[2])
    np.testing.assert_allclose(float(m.loss), runs["jax_loss3"], rtol=1e-5)
    params = engine.state.params if into == "resident" else {
        k: torch.from_numpy(v) for k, v in _flatten(engine.get_fp32_params()).items()}
    _assert_params_close(params if into == "resident" else _nest(params),
                         runs["jax_params3"], runs["lrs"])


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict) else {key: v})
    return out


def _nest(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def test_jax_resumes_from_the_port_universal_dir(runs, tmp_path):
    universal.ds_to_universal(runs["port"], str(tmp_path / "uni"))
    jcfg, _, jother, _ = _params(33)
    jengine = _jax_engine(jcfg, jother, _config(optimizer=ADAMW, load_universal_checkpoint=True))
    jengine.load_checkpoint(str(tmp_path / "uni"))
    assert jengine.global_steps == 2
    jm = jengine.train_batch(_batches()[2])
    np.testing.assert_allclose(float(jm.loss), runs["port_loss3"], rtol=1e-5)
    ref = {k: torch.from_numpy(np.array(v)) for k, v in _flatten(
        jax.tree_util.tree_map(np.asarray, jengine.state.params)).items()}
    _assert_params_close(_nest(ref), runs["port_params3"], runs["lrs"])


def test_stripped_vocab_comes_back_zero_padded(runs, tmp_path):
    universal.ds_to_universal(runs["port"], str(tmp_path / "uni"), strip_vocab_padding=STRIP)
    _, cfg, _, other = _params(34)
    engine = _port_engine(cfg, other, _config(optimizer=ADAMW, load_universal_checkpoint=True))
    engine.load_checkpoint(str(tmp_path / "uni"))
    embed = engine.state.params["embed"]
    saved = np.load(os.path.join(runs["port"], "params.embed.npy"))
    np.testing.assert_array_equal(embed[:STRIP].numpy(), saved[:STRIP])
    assert not embed[STRIP:].any() and not engine.state.opt_state.exp_avg["embed"][STRIP:].any()
    np.testing.assert_array_equal(engine.state.params["lm_head"].numpy(),
                                  np.load(os.path.join(runs["port"], "params.lm_head.npy")))
    with pytest.raises(FileNotFoundError, match="universal_metadata.json"):
        engine.load_checkpoint(str(tmp_path / "nowhere"))


def test_another_optimizer_resumes_and_warns_for_unmatched_moments(runs, tmp_path, caplog):
    """Lion's atoms into an adamw engine: the params and Lion's momentum (its
    ``exp_avg``) load; ``exp_avg_sq`` and the step have no atom and keep the
    engine's values, with a warning; an offloaded engine takes the same
    atoms (JAX's offload branch warns only for atoms it cannot place)."""
    universal.ds_to_universal(runs["lion"], str(tmp_path / "uni"))
    _, cfg, _, other = _params(35)
    with caplog.at_level(logging.WARNING):
        engine = _port_engine(cfg, other, _config(optimizer=ADAMW, load_universal_checkpoint=True))
        engine.load_checkpoint(str(tmp_path / "uni"))
    np.testing.assert_array_equal(engine.state.params["final_norm"].numpy(),
                                  np.load(os.path.join(runs["lion"], "params.final_norm.npy")))
    np.testing.assert_array_equal(engine.state.opt_state.exp_avg["embed"].numpy(),
                                  np.load(os.path.join(runs["lion"],
                                                       "opt_state.exp_avg.embed.npy")))
    assert not engine.state.opt_state.exp_avg_sq["embed"].any()
    assert "no atom/passthrough for opt_state.exp_avg_sq" in caplog.text
    conf = _config(optimizer=ADAMW, load_universal_checkpoint=True,
                   zero_optimization={"stage": 1, "offload_optimizer": {"device": "cpu"}})
    off = _port_engine(cfg, other, conf)
    off.load_checkpoint(str(tmp_path / "uni"))
    sd = off._offload_state.state_dict()
    np.testing.assert_array_equal(sd["m"]["embed"].numpy(), np.load(
        os.path.join(runs["lion"], "opt_state.exp_avg.embed.npy")).ravel())
    assert not sd["v"]["embed"].any() and sd["step"] == 0
    np.testing.assert_array_equal(off._offload_state.params["final_norm"].numpy(),
                                  np.load(os.path.join(runs["lion"], "params.final_norm.npy")))
    assert np.isfinite(float(off.train_batch(_batches()[2]).loss))

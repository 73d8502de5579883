"""ZeRO-Infinity in the port on the CPU against the JAX package's: the JAX
tests ``test_nvme_param_offload_via_initialize``,
``test_nvme_stem_and_cpu_moments_via_initialize`` and
``test_nvme_streamed_matches_resident_numerics``
(``tests/unit/test_offload.py``), each held against the JAX trainer on the
same numpy weights and batches.  The toy stem, layer and head functions are
written once in each framework; per-step losses (rtol 1e-5) and the final
stacked weights, stem and head (the Adam rule: every element within 2 x
sum(lr), 99.9 % within 1e-5) are compared.  Then the parameter swapper's
protocol and pool bounds (the JAX file's swapper tests), the streamed
``forward``, and the guards and refusals of the streaming engine."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.parallel import MeshTopology, reset_topology
from deepspeed_tpu_torch.runtime.swap_tensor import (AsyncPartitionedParameterSwapper,
                                                     SwappedLayerTrainer)

L, H, V, B, S, LR = 3, 16, 32, 4, 8, 3e-2


# ------------------------------------------------- the toy model, in both frameworks
def jstem(sp, tokens):
    return sp["embed"][tokens]


def jlayer(p, x):
    return x + jnp.tanh(x @ p["w"] + p["b"])


def jtanh_layer(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def jhead(h, x, labels):
    logp = jax.nn.log_softmax((x @ h["out"]).astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.sum(jax.nn.one_hot(labels, V, dtype=logp.dtype) * logp, axis=-1))


def jmse_head(h, x, y):
    pred = x @ h["out"]
    return jnp.mean((pred - y.astype(pred.dtype)) ** 2).astype(jnp.float32)


def stem(sp, tokens):
    return sp["embed"][tokens.long()]


def layer(p, x):
    return x + torch.tanh(x @ p["w"] + p["b"])


def tanh_layer(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def head(h, x, labels):
    logp = torch.log_softmax((x @ h["out"]).float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).squeeze(-1).mean()


def mse_head(h, x, y):
    pred = x @ h["out"]
    return ((pred - y.to(pred.dtype)) ** 2).mean().float()


def _params(stem_too: bool, out_cols: int):
    rng = np.random.default_rng(0)
    p = {"layers": {"w": (rng.normal(size=(L, H, H)) * 0.3).astype(np.float32),
                    "b": (rng.normal(size=(L, H)) * 0.1).astype(np.float32)},
         "out": (rng.normal(size=(H, out_cols)) * 0.2).astype(np.float32)}
    if stem_too:
        p["stem"] = {"embed": (rng.normal(size=(V, H)) * 0.1).astype(np.float32)}
    return p


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _config(path, moments, **kw):
    zero = {"stage": 3, "offload_param": {"device": "nvme", "nvme_path": path, "buffer_count": 6}}
    if moments == "cpu":
        zero["offload_optimizer"] = {"device": "cpu"}
    return {"train_micro_batch_size_per_gpu": B, "steps_per_print": 1000,
            "optimizer": {"type": "adamw", "params": {"lr": LR, "weight_decay": 0.01}},
            "zero_optimization": zero, "bf16": {"enabled": False}, **kw}


def _engines(tmp_path, moments, stem_too, layer_pair, head_pair, out_cols):
    params = _params(stem_too, out_cols)
    kw = {"stem_fn": (jstem, stem)} if stem_too else {}
    reset_topology()
    topo = MeshTopology.from_axis_dict({"data": 1}, devices=jax.devices()[:1])
    jengine = deepspeed_tpu.initialize(
        loss_fn=lambda p, b, r: 0.0, model_parameters=jax.tree_util.tree_map(jnp.asarray, params),
        topology=topo, config=_config(str(tmp_path / "jax"), moments), layer_fn=layer_pair[0],
        head_fn=head_pair[0], **{k: v[0] for k, v in kw.items()})[0]
    engine = deepspeed_tpu_torch.initialize(
        loss_fn=lambda p, b, r: 0.0, model_parameters=_torch_tree(params),
        config=_config(str(tmp_path / "port"), moments), device="cpu", layer_fn=layer_pair[1],
        head_fn=head_pair[1], **{k: v[1] for k, v in kw.items()})[0]
    return jengine, engine


def _close(got, want, lrs):
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert diff.max() <= 2 * sum(lrs), diff.max()
    assert (diff <= 1e-5).mean() >= 0.999


def _compare_trainers(jengine, engine, batches):
    jl = [float(jengine.train_batch(b).loss) for b in batches]
    metrics = [engine.train_batch(b) for b in batches]
    np.testing.assert_allclose([float(m.loss) for m in metrics], jl, rtol=1e-5)
    lrs = [m.lr for m in metrics]
    jtr, tr = jengine._nvme_trainer, engine._nvme_trainer
    jw, w = jtr.gather_stacked_params(), tr.gather_stacked_params()
    for name in ("w", "b"):
        _close(w[name].numpy(), jw[name], lrs)
    _close(tr.head["out"].numpy(), jtr.head["out"], lrs)
    if tr.stem is not None:
        _close(tr.stem["embed"].numpy(), jtr.stem["embed"], lrs)
    return [float(m.loss) for m in metrics]


def test_nvme_param_offload_via_initialize_matches_jax(tmp_path):
    """``offload_param: nvme`` from config alone through ``initialize``: the
    layers live on disk under ``nvme_path``, moments too; 10 steps against
    JAX's trainer."""
    jengine, engine = _engines(tmp_path, "nvme", False, (jtanh_layer, tanh_layer),
                               (jmse_head, mse_head), H)
    assert engine._nvme_trainer is not None and engine.state is None
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(H, H)).astype(np.float32) * 0.3
    x = rng.normal(size=(B, H)).astype(np.float32)
    batch = {"x": x, "y": np.tanh(x @ w_true)}
    losses = _compare_trainers(jengine, engine, [batch] * 10)
    assert losses[-1] < losses[0] * 0.8, losses
    files = sorted(os.listdir(tmp_path / "port" / "dstpu_param_swap"))
    assert files == sorted(os.listdir(tmp_path / "jax" / "dstpu_param_swap"))
    assert any(".m." in f for f in files) and any(".p." in f for f in files)
    out = engine._nvme_trainer.forward(x)
    np.testing.assert_allclose(out.numpy(), np.asarray(jengine._nvme_trainer.forward(x)),
                               rtol=1e-5, atol=1e-6)


def test_nvme_stem_and_cpu_moments_match_jax(tmp_path):
    """``offload_param: nvme`` with ``offload_optimizer: cpu``: the moments in
    RAM (no moment files), a trainable stem that gets grads through the
    whole stream; 10 steps against JAX's trainer."""
    jengine, engine = _engines(tmp_path, "cpu", True, (jlayer, layer), (jhead, head), V)
    trainer = engine._nvme_trainer
    assert trainer.optimizer_device == "cpu" and trainer._cpu_m is not None
    assert not any(".m." in f or ".v." in f
                   for f in os.listdir(tmp_path / "port" / "dstpu_param_swap"))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, V, (B, S))
    embed_before = trainer.stem["embed"].clone()
    losses = _compare_trainers(jengine, engine, [{"x": tokens, "y": np.roll(tokens, -1, 1)}] * 10)
    assert losses[-1] < losses[0] * 0.9, losses
    assert (trainer.stem["embed"] - embed_before).abs().max() > 1e-4


def test_nvme_streamed_matches_resident_numerics(tmp_path):
    """The streamed path computes the resident path's math: the port's
    streamed engine against JAX's streamed engine, and against the port's
    resident engine over the same composition (stem -> layers -> head)."""
    jengine, engine = _engines(tmp_path, "cpu", True, (jlayer, layer), (jhead, head), V)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(6):
        tokens = rng.integers(0, V, (B, S))
        batches.append({"x": tokens, "y": np.roll(tokens, -1, axis=1)})
    streamed = _compare_trainers(jengine, engine, batches)

    def resident_loss(p, batch, rng):
        x = stem(p["stem"], batch["x"])
        for l in range(L):
            x = layer({k: v[l] for k, v in p["layers"].items()}, x)
        return head({"out": p["out"]}, x, batch["y"])

    params = _torch_tree(_params(True, V))
    resident = deepspeed_tpu_torch.initialize(
        loss_fn=resident_loss, model_parameters=params, device="cpu",
        config={"train_micro_batch_size_per_gpu": B, "steps_per_print": 1000,
                "optimizer": {"type": "adamw", "params": {"lr": LR, "weight_decay": 0.01}},
                "bf16": {"enabled": False}})[0]
    res = [float(resident.train_batch({k: v[None] for k, v in b.items()}).loss) for b in batches]
    np.testing.assert_allclose(streamed, res, rtol=2e-5, atol=1e-6)
    tr = engine._nvme_trainer
    lrs = [LR] * len(batches)
    _close(tr.gather_stacked_params()["w"].numpy(), resident.state.params["layers"]["w"].numpy(),
           lrs)
    _close(tr.stem["embed"].numpy(), resident.state.params["stem"]["embed"].numpy(), lrs)


def test_streaming_engine_guards_and_refusals(tmp_path):
    """The ``ValueError``s of JAX's ``_init_nvme_trainer`` checks, and
    ``NotImplementedError`` from eval, checkpoints and the fp32 export."""
    params = _torch_tree(_params(False, H))
    kw = dict(loss_fn=lambda p, b, r: 0.0, device="cpu", layer_fn=tanh_layer, head_fn=mse_head)
    with pytest.raises(ValueError, match="layer_fn"):
        deepspeed_tpu_torch.initialize(loss_fn=lambda p, b, r: 0.0, model_parameters=params,
                                       config=_config(str(tmp_path), "nvme"), device="cpu")
    with pytest.raises(ValueError, match="'layers'"):
        deepspeed_tpu_torch.initialize(model_parameters={"w": torch.zeros(4, 4)},
                                       config=_config(str(tmp_path), "nvme"), **kw)
    with pytest.raises(ValueError, match="gas=2"):
        deepspeed_tpu_torch.initialize(model_parameters=params, config=_config(
            str(tmp_path), "nvme", gradient_accumulation_steps=2), **kw)
    bad = _config(str(tmp_path), "nvme")
    bad["optimizer"] = {"type": "lion", "params": {"lr": LR}}
    with pytest.raises(ValueError, match="lion"):
        deepspeed_tpu_torch.initialize(model_parameters=params, config=bad, **kw)
    with pytest.raises(NotImplementedError, match="not ported"):
        deepspeed_tpu_torch.initialize(model_parameters=params, config=bad, no_such_fn=1, **kw)
    engine = deepspeed_tpu_torch.initialize(model_parameters=params,
                                            config=_config(str(tmp_path), "nvme"), **kw)[0]
    for call in (lambda: engine.eval_batch({"x": np.zeros((B, H))}),
                 lambda: engine.save_checkpoint(str(tmp_path / "ck")),
                 lambda: engine.load_checkpoint(str(tmp_path / "ck")),
                 lambda: engine.get_fp32_params(),
                 lambda: engine.save_16bit_model(str(tmp_path / "m"))):
        with pytest.raises(NotImplementedError, match="offload_param:nvme"):
            call()


def test_param_swapper_protocol_and_pool_bounds(tmp_path):
    """The JAX file's swapper tests on the port: swap out, prefetch, lend,
    mutate and write back; buffers cycle through a bounded pool; growing
    leaves replace undersized free buffers."""
    sw = AsyncPartitionedParameterSwapper(str(tmp_path / "a"), buffer_count=4)
    a = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    b = torch.ones(8, dtype=torch.bfloat16)
    sw.swap_out("g0", [a, b])
    sw.swap_in_async("g0")
    views = sw.wait_in("g0")
    assert torch.equal(views[0], a) and torch.equal(views[1], b) and views[1].dtype == b.dtype
    views[0].fill_(7.0)
    sw.swap_out("g0", views)
    sw.release("g0")
    assert sw.available_swap_in_buffers() >= 2
    assert (sw.wait_in("g0")[0] == 7.0).all()  # an implicit swap-in
    sw.release("g0")
    assert sw.bytes_written == 2 * (32 * 4 + 8 * 2) and sw.bytes_read == 2 * (32 * 4 + 8 * 2)

    sw = AsyncPartitionedParameterSwapper(str(tmp_path / "b"), buffer_count=2)
    for i in range(6):
        sw.swap_out(f"g{i}", [torch.full((16, ), float(i))])
    for i in range(6):
        assert (sw.wait_in(f"g{i}")[0] == i).all()
        sw.release(f"g{i}")
    assert 1 <= sw.available_swap_in_buffers() <= 2 and sw._allocated <= 2
    sw.swap_out("small", [torch.zeros(16)])
    sw.swap_out("big", [torch.zeros(1 << 18)])
    for key in ("small", "big", "small"):
        sw.wait_in(key)
        sw.release(key)
    assert sw._allocated <= 2
    sw.close()


def test_trainer_offloads_activations_and_streams_moments(tmp_path):
    """``offload_activations`` (the ``cpu_checkpointing`` lever) and disk
    moments give the same losses and weights as activations on the device
    and moments in RAM."""
    params = _params(True, V)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, V, (B, S))
    batch = {"x": tokens, "y": np.roll(tokens, -1, 1)}
    runs = []
    for i, (moments, offload) in enumerate((("cpu", False), ("nvme", True))):
        sw = AsyncPartitionedParameterSwapper(str(tmp_path / str(i)), buffer_count=6)
        tr = SwappedLayerTrainer(layer, L, head, sw, lr=LR, compute_dtype=torch.float32,
                                 stem_fn=stem, optimizer_device=moments,
                                 offload_activations=offload, device="cpu")
        p = _torch_tree(params)
        tr.init_from_stacked(p["layers"], {"out": p["out"]}, stem_params=p["stem"])
        runs.append(([tr.train_step(batch) for _ in range(3)], tr.gather_stacked_params()))
        assert set(tr.last_times) == {"stream_in", "compute", "adam_swap_out"}
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1]["w"], runs[1][1]["w"])

"""The port's FLOPs profiler on the CPU: ``per_module_profile`` rows and
``format_module_table`` text identical to the JAX package's for Llama,
GPT-2 (tied embeddings) and BERT trees; ``profile_fn`` FLOPs equal a hand
count of a small MLP's products (XLA's count, which also holds the
elementwise ops, lies 0-5 % above it); a Llama forward against XLA's count
(which counts the scanned layer body once: 1.0-1.1x the port's count of one
layer, at any depth); each hand kernel's
wrapper, replayed on meta tensors under an open count, adds exactly the
FLOPs its plain version adds; and a train step's count through the
profiler equals the engine telemetry's ``flops_per_step``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.profiling import flops_profiler as jprof
from deepspeed_tpu_torch import initialize, ops
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.ops.attention import flash, paged
from deepspeed_tpu_torch.ops.sparse_attention import attention as sparse
from deepspeed_tpu_torch.profiling import (FlopsProfiler, ProfileResult, get_model_profile,
                                           profile_fn)
from deepspeed_tpu_torch.profiling import flops_profiler as prof
from deepspeed_tpu_torch.runtime.tree import tree_map


@pytest.mark.parametrize("family,tokens", [("llama", 512), ("gpt2", 96), ("bert", 7)])
def test_per_module_table_matches_jax(family, tokens):
    module, cfg = {"llama": (jllama, jllama.LlamaConfig.tiny()),
                   "gpt2": (jgpt2, jgpt2.GPT2Config.tiny()),
                   "bert": (jbert, jbert.BertConfig.tiny())}[family]
    jparams = module.init_params(cfg, jax.random.PRNGKey(0))
    params = tree_map(lambda a: torch.from_numpy(np.array(a)),
                      jax.tree_util.tree_map(np.asarray, jparams))
    rows = prof.per_module_profile(params, tokens)
    assert rows == jprof.per_module_profile(jparams, tokens)
    assert prof.per_module_profile(params, tokens, top_k=3) == rows[:3]
    for top_k in (3, 10, 100):
        assert prof.format_module_table(rows, top_k) == jprof.format_module_table(rows, top_k)
    assert ProfileResult(1.5e12, 2.0e9, 7, 0.0).human() == jprof.ProfileResult(
        1.5e12, 2.0e9, 7, 0.0).human()


def test_profile_fn_counts_an_mlp_by_hand():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 64)).astype(np.float32)
    w1 = rng.normal(size=(64, 256)).astype(np.float32)
    w2 = rng.normal(size=(256, 32)).astype(np.float32)
    hand = 2 * 8 * 64 * 256 + 2 * 8 * 256 * 32
    got = profile_fn(lambda a, b, c: torch.relu(a @ b) @ c,
                     *(torch.from_numpy(t) for t in (x, w1, w2)))
    assert got.flops == hand
    assert got.params == x.size + w1.size + w2.size
    # every op's operands and result: x@w1 (x, w1, h), relu (h, h), h@w2
    assert got.bytes_accessed == 4 * (x.size + w1.size + 8 * 256 + 2 * 8 * 256 + 8 * 256
                                      + w2.size + 8 * 32)
    want = jprof.profile_fn(lambda a, b, c: jax.nn.relu(a @ b) @ c,
                            *(jnp.asarray(t) for t in (x, w1, w2)))
    # XLA's count adds the relu's 8 x 256 elementwise ops: a band of 0-5 % here
    assert hand <= want.flops <= 1.05 * hand


def _flash_inputs(seed=0, b=1, s=16, h=4, kv=2, d=64):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, s, h, d, generator=g)
    k, v = (torch.randn(b, s, kv, d, generator=g) for _ in range(2))
    do = torch.randn(b, s, h, d, generator=g)
    out, lse = flash.flash_fwd_reference(q, k, v, 0.125, True)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def _plain_and_replay(plain, args):
    with prof.count_ops() as ran:
        plain(*args)
    with prof.count_ops() as replayed:
        ops.count_kernel(plain, args, ())
    return ran.flops, replayed.flops, replayed.bytes_accessed


def test_kernel_replays_add_their_plain_versions_flops():
    q, k, v, do, lse, delta = _flash_inputs()
    cases = [(flash.flash_fwd_reference, (q, k, v, 0.125, True)),
             (flash.flash_bwd_dkdv_reference, (q, k, v, do, lse, delta, 0.125, True)),
             (flash.flash_bwd_dq_reference, (q, k, v, do, lse, delta, 0.125, True))]
    lay, block = np.ones((4, 1, 1), np.uint8), 16
    tables = sparse._get_tables(lay, 4, block, 2)
    cases.append((sparse.sparse_fwd_reference, (q, k, v, tables, 0.125, True)))
    pool = torch.randn(6, 2, 4, 64)
    ints = (torch.tensor([[0, 2, 4]], dtype=torch.int32), torch.tensor([9], dtype=torch.int32),
            torch.tensor([4], dtype=torch.int32), torch.tensor([5], dtype=torch.int32))
    cases.append((paged.paged_attention_reference,
                  (torch.randn(1, 5, 4, 64), pool, pool.clone(), *ints, 0.125, None, None)))
    for plain, args in cases:
        ran, replayed, nbytes = _plain_and_replay(plain, args)
        assert ran == replayed > 0, plain.__name__
        assert nbytes == sum(t.numel() * t.element_size() for t in args
                             if isinstance(t, torch.Tensor))
    # the forward and both backward kernels: 4 + 8 + 6 products of B H Sq Sk D
    b, s, h, d = q.shape
    assert [_plain_and_replay(p, a)[0] for p, a in cases[:3]] == [
        n * b * h * s * s * d for n in (4, 8, 6)]


def _engine(cfg, attention_fn=None, telemetry=None):
    conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "bf16": {"enabled": False}, "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    if telemetry is not None:
        conf["telemetry"] = telemetry
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    return initialize(loss_fn=llama.make_loss_fn(cfg, attention_fn=attention_fn),
                      model_parameters=params, config=conf, device="cpu")[0]


def test_train_step_profile_equals_telemetry_count(tmp_path):
    cfg = llama.LlamaConfig.tiny(vocab=96, hidden=64, layers=2, heads=1, kv_heads=1, seq=32)
    batch = llama.causal_lm_batch(np.random.default_rng(1).integers(0, 96, (4, 32)))
    eng = _engine(cfg, flash.flash_attention, {"jsonl_path": str(tmp_path / "t.jsonl")})
    profiler = FlopsProfiler(eng)
    before = tree_map(lambda p: p.clone(), eng.state.params)
    res = profiler.profile_train_step(batch)
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(before), jax.tree_util.tree_leaves(eng.state.params)))
    eng.train_batch(batch)
    assert res.flops == eng.telemetry._flops_per_step
    assert res.params == llama.num_params(cfg) and res.bytes_accessed > 0
    # products (forward, twice backward; the default policy keeps them) and
    # the flash plain versions (forward, remat recompute, dK/dV, dQ)
    D, F, V, L, S = 64, 128, 96, 2, 32
    tokens = 2 * S
    layer = 2 * tokens * (4 * D * D + 3 * D * F)
    attn = (4 + 4 + 8 + 6) * 2 * S * S * D
    assert res.flops == 2 * (L * (3 * layer + attn) + 3 * 2 * tokens * D * V)
    text = profiler.print_model_profile(tokens=tokens, top_k=4)
    assert "layers.mlp.w_gate" in text and "more modules" in text
    fwd = get_model_profile(llama.make_loss_fn(cfg), eng.state.params,
                            {k: torch.from_numpy(v[:2]) for k, v in batch.items()},
                            print_profile=False)
    assert fwd.flops == L * (layer + 4 * tokens * S * D) + 2 * tokens * D * V  # sdpa: 4 S d
    assert fwd.params == llama.num_params(cfg)


@pytest.mark.parametrize("layers", [2, 4])
def test_band_against_xla_cost_analysis(layers):
    """A Llama forward's count against JAX's ``get_model_profile``: XLA counts
    the scanned layer body once (the JAX forward is a ``lax.scan``) and adds
    elementwise ops, so its count sits at 1.0-1.1x the port's count of a
    one-layer model, whatever the depth; the port counts every layer."""
    shape = dict(vocab=96, hidden=64, heads=1, kv_heads=1, seq=32)
    ids = np.random.default_rng(0).integers(0, 96, (2, 32)).astype(np.int32)
    batch = llama.causal_lm_batch(ids)
    jcfg = jllama.LlamaConfig.tiny(layers=layers, **shape)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    want = jprof.get_model_profile(jllama.make_loss_fn(jcfg), jparams,
                                   {k: jnp.asarray(v) for k, v in batch.items()},
                                   print_profile=False)
    counts = {}
    for n in (1, layers):
        cfg = llama.LlamaConfig.tiny(layers=n, **shape)
        params = llama.init_params(cfg, torch.Generator().manual_seed(0))
        counts[n] = get_model_profile(llama.make_loss_fn(cfg), params,
                                      {k: torch.from_numpy(v) for k, v in batch.items()},
                                      print_profile=False).flops
    assert counts[layers] > counts[1]
    assert 1.0 <= want.flops / counts[1] <= 1.1

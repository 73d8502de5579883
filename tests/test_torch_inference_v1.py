"""The port's v1 inference path on the CPU against the JAX package, same numpy
weights (carried by ``params_from_jax``): ``forward_with_cache`` and the KV
cache, ``InferenceEngine`` logits and greedy ``generate``, weight-only
quantized engines (int8 with the JAX quantize kernel in interpret mode, and
int4), the per-layer dequantization of packed leaves, seeded sampling, the HF
conversion and the refusals.  fp32 throughout; the JAX engine serves the
tests' 8-device CPU mesh replicated, which computes what one device does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.inference import InferenceEngine as JInferenceEngine
from deepspeed_tpu.inference import quantization as jquant
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.ops import _pallas
from deepspeed_tpu_torch.inference import InferenceEngine, init_inference
from deepspeed_tpu_torch.inference import quantization as quant
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.ops.quantizer import quantize_int8

VOCAB = 128
CONF = {"dtype": "float32", "max_seq_len": 64}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(_pallas, "INTERPRET", True)


@pytest.fixture(scope="module")
def model():
    shape = dict(vocab=VOCAB, hidden=64, layers=2, heads=4, kv_heads=2, seq=64)
    jcfg, cfg = jllama.LlamaConfig.tiny(**shape), llama.LlamaConfig.tiny(**shape)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    params = llama.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _ids(seed, rows, seq):
    return np.random.default_rng(seed).integers(0, VOCAB, (rows, seq)).astype(np.int32)


def test_forward_with_cache_prefill_plus_decode_equals_forward(model):
    """Prefill and decode through the cache, stitched, equal one full forward
    (2e-4, the JAX test's tolerance), and each call matches the JAX
    ``forward_with_cache``; a decode resumes from a JAX cache."""
    jcfg, cfg, jparams, params = model
    ids = _ids(0, 2, 16)
    full = llama.forward(cfg, params, torch.from_numpy(ids))
    cache = llama.init_cache(cfg, 2, 64, dtype=torch.float32)
    assert cache["k"].shape == (2, 2, 64, 2, 16) and cache["len"] == 0
    jcache = jllama.init_cache(jcfg, 2, 64, dtype=jnp.float32)
    outs = []
    for lo, hi in [(0, 10)] + [(t, t + 1) for t in range(10, 16)]:
        logits, cache = llama.forward_with_cache(cfg, params, torch.from_numpy(ids[:, lo:hi]),
                                                 cache)
        jlogits, jcache = jllama.forward_with_cache(jcfg, jparams, jnp.asarray(ids[:, lo:hi]),
                                                    jcache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
        assert cache["len"] == int(jcache["len"]) == hi
        outs.append(logits)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.detach().numpy(), atol=2e-4,
                               rtol=2e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), atol=1e-5,
                                   rtol=1e-5)
    resumed = llama.cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache), "cpu")
    nxt = _ids(1, 2, 1)
    got, resumed = llama.forward_with_cache(cfg, params, torch.from_numpy(nxt), resumed)
    ref, _ = jllama.forward_with_cache(jcfg, jparams, jnp.asarray(nxt), jcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    assert resumed["len"] == 17


def test_engine_forward_and_greedy_generate_match_jax(model):
    jcfg, cfg, jparams, params = model
    jeng = JInferenceEngine(jllama, jcfg, jparams, config=CONF)
    eng = init_inference(model_module=llama, model_config=cfg, params=params, config=CONF,
                         device="cpu")
    ids = _ids(2, 2, 12)
    np.testing.assert_allclose(eng.forward(ids).numpy(), np.asarray(jeng.forward(ids)),
                               atol=1e-4, rtol=1e-4)
    prompt = ids[:, :6]
    out = eng.generate(prompt, max_new_tokens=10, temperature=0.0)
    assert out.shape == (2, 16)
    np.testing.assert_array_equal(out, jeng.generate(prompt, max_new_tokens=10,
                                                     temperature=0.0))
    # an eos both engines reach stops both at the same length
    eos = int(out[0, 9])
    got = eng.generate(prompt[:1], max_new_tokens=10, temperature=0.0, eos_token_id=eos)
    ref = jeng.generate(prompt[:1], max_new_tokens=10, temperature=0.0, eos_token_id=eos)
    np.testing.assert_array_equal(got, ref)
    assert got.shape[1] < 16


def _jax_packed(jtree):
    """{dotted path: WOQLeaf} of a JAX params tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree, is_leaf=jquant.is_woq_leaf)
    key = lambda path: ".".join(str(getattr(p, "key", p)) for p in path)
    return {key(path): leaf for path, leaf in flat if jquant.is_woq_leaf(leaf)}


def _with_paths(tree, prefix=""):
    """(dotted path, leaf) of a nested-dict tree, in key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _with_paths(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def _port_packed(tree):
    return {path: leaf for path, leaf in _with_paths(tree) if quant.is_woq_leaf(leaf)}


@pytest.mark.parametrize("bits,group_size", [(8, 128), (8, 64), (8, 1536), (4, 64)])
def test_woq_engine_matches_jax(model, bits, group_size):
    """The same leaves packed (paths and count), the same serving bytes, codes
    equal and scales equal (within an ulp of the interpret-mode kernel's:
    ``tests/test_torch_quantizer.py``), logits within 1e-4 and greedy tokens
    identical.  Groups of 128 take the JAX Pallas kernel, 64 its fallback;
    groups of 1536 straddle the 4096-element layers of wq/wo."""
    jcfg, cfg, jparams, params = model
    conf = dict(CONF, quant={"enabled": True, "bits": bits, "group_size": group_size})
    jeng = JInferenceEngine(jllama, jcfg, jparams, config=conf)
    eng = init_inference(model_module=llama, model_config=cfg, params=params, config=conf,
                         device="cpu")
    jpacked, packed = _jax_packed(jeng.params), _port_packed(eng.params)
    assert list(packed) == list(jpacked) and len(packed) == 9  # the norms are too small
    assert quant.packed_nbytes(eng.params) == jquant.packed_nbytes(jeng.params)
    for path, leaf in packed.items():
        jleaf = jpacked[path]
        assert (leaf.bits, leaf.size, leaf.shape) == (jleaf.bits, jleaf.size, jleaf.shape)
        np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(jleaf.q), err_msg=path)
        np.testing.assert_array_max_ulp(leaf.s.numpy(), np.asarray(jleaf.s), maxulp=1)
    ids = _ids(3, 2, 12)
    np.testing.assert_allclose(eng.forward(ids).numpy(), np.asarray(jeng.forward(ids)),
                               atol=1e-4, rtol=1e-4)
    prompt = ids[:, :5]
    np.testing.assert_array_equal(eng.generate(prompt, max_new_tokens=8, temperature=0.0),
                                  jeng.generate(prompt, max_new_tokens=8, temperature=0.0))


def test_packed_leaf_rows_equal_the_whole_dequantized_leaf():
    """``leaf[i]`` (one layer) and ``leaf[ids]`` (rows) are slices of the whole
    dequantization, bit for bit, for groups inside a layer, straddling two
    layers, and longer than a layer."""
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 40, 24)).astype(np.float32))
    for bits, group in ((8, 128), (8, 700), (8, 2048), (8, 7), (4, 128), (4, 1000)):
        leaf = quant.quantize_leaf(x, bits=bits, group_size=group, dtype=torch.bfloat16)
        dense = quant.dequantize_leaf(leaf, torch.bfloat16)
        assert torch.equal(leaf.dequantize(), dense) and dense.shape == x.shape
        for i in (0, 1, 2, -1):
            assert torch.equal(leaf[i], dense[i]), (bits, group, i)
        rows = torch.tensor([[2, 0], [1, 1]])
        assert torch.equal(leaf[rows], dense[rows]), (bits, group)
        table = leaf.dequantize(torch.float32).reshape(120, 24)
        emb = quant.quantize_leaf(table, bits=bits, group_size=group)
        ids = torch.tensor([[119, 0, 57], [3, 3, 118]])
        assert torch.equal(emb[ids], emb.dequantize()[ids]), (bits, group)
    with pytest.raises(IndexError):
        leaf[3]


def test_woq_tree_from_jax_serves_the_jax_packed_tree(model):
    jcfg, cfg, jparams, _ = model
    conf = dict(CONF, quant={"enabled": True, "bits": 8, "group_size": 128})
    jeng = JInferenceEngine(jllama, jcfg, jparams, config=conf)
    tree = quant.woq_tree_from_jax(jax.tree_util.tree_map(np.asarray, jeng.params), "cpu")
    dense = quant.dequantize_tree(tree, torch.float32)
    jdense = jquant.dequantize_tree(jeng.params, jnp.float32)
    for got, ref in zip(_with_paths(dense), jax.tree_util.tree_leaves(jdense)):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref), err_msg=got[0])
    ids = _ids(5, 2, 8)
    logits, _ = llama.forward_with_cache(cfg, tree, torch.from_numpy(ids),
                                         llama.init_cache(cfg, 2, 8, dtype=torch.float32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jeng.forward(ids)), atol=1e-4,
                               rtol=1e-4)


def test_woq_engine_keeps_no_dense_weights(model):
    _, cfg, _, params = model
    eng = InferenceEngine(llama, cfg, params, device="cpu",
                          config={"quant": {"enabled": True, "bits": 8, "group_size": 256}})
    leaves = [leaf for _, leaf in _with_paths(eng.params)]
    assert all(quant.is_woq_leaf(x) or x.dim() < 2 or x.numel() < 4096 for x in leaves)
    dense_ptrs = {p.data_ptr() for _, p in _with_paths(params)}
    assert not any(not quant.is_woq_leaf(x) and x.data_ptr() in dense_ptrs for x in leaves)
    # every non-packed leaf serves in the configured dtype (bfloat16 by default)
    assert {x.dtype for x in leaves if not quant.is_woq_leaf(x)} == {torch.bfloat16}
    assert {x.dtype for x in leaves if quant.is_woq_leaf(x)} == {torch.bfloat16}
    assert eng.forward(_ids(6, 1, 4)).dtype == torch.bfloat16


def test_seeded_sampling_repeats(model):
    _, cfg, _, params = model
    eng = init_inference(model_module=llama, model_config=cfg, params=params, device="cpu",
                         config=dict(CONF, temperature=0.8, top_k=20))
    prompt = np.array([[5, 6, 7]])
    a = eng.generate(prompt, max_new_tokens=6, seed=1)
    b = eng.generate(prompt, max_new_tokens=6, seed=1)
    c = eng.generate(prompt, max_new_tokens=6, seed=2)
    np.testing.assert_array_equal(a, b)
    assert a.shape == c.shape == (1, 9)
    np.testing.assert_array_equal(a[:, :3], prompt)


def test_hf_llama_through_init_inference():
    """``from_hf_state_dict`` + ``config_from_hf`` through ``init_inference(
    hf_model=...)`` match transformers' own forward (no download: a tiny
    random model from its config)."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(vocab_size=96, hidden_size=32, intermediate_size=64,
                                      num_hidden_layers=2, num_attention_heads=4,
                                      num_key_value_heads=2, max_position_embeddings=64,
                                      tie_word_embeddings=False)
    torch.manual_seed(0)
    hf_model = transformers.LlamaForCausalLM(hf_cfg).eval()
    ids = np.random.default_rng(3).integers(0, 96, (2, 10))
    with torch.no_grad():
        hf_logits = hf_model(torch.tensor(ids)).logits.numpy()
    eng = init_inference(hf_model=hf_model, config={"dtype": "float32", "max_seq_len": 32},
                         device="cpu")
    assert eng.model_config.num_kv_heads == 2 and eng.model_config.max_seq_len == 64
    np.testing.assert_allclose(eng.forward(ids).numpy(), hf_logits, atol=2e-4, rtol=2e-3)


def test_refusals_and_jax_config_keys(model, monkeypatch):
    _, cfg, _, params = model
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        init_inference(model_module=llama, model_config=cfg, params=params, device="cpu",
                       config={"tensor_parallel": {"tp_size": 2}})
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        InferenceEngine(llama, cfg, params, device="cpu", topology=object())
    with pytest.raises(ValueError, match="needs"):
        init_inference(config=CONF, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        init_inference(model_module=llama, model_config=cfg, params=params, device="cpu",
                       config={"max_seq_len": 8}).generate(_ids(7, 1, 6), max_new_tokens=4)
    eng = init_inference(model_module=llama, model_config=cfg, params=params, device="cpu",
                         config={"dtype": "float32", "replace_with_kernel_inject": True,
                                 "max_out_tokens": 3, "min_out_tokens": 1,
                                 "tensor_parallel": {"enabled": True, "tp_size": 1}})
    assert eng.generate(_ids(8, 1, 4), temperature=0.0).shape == (1, 7)  # max_out_tokens
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_inference(model_module=llama, model_config=cfg, params=params,
                                           config={"quant": {"enabled": True, "bits": 8}})


def test_quantize_tree_packs_the_llama2_7b_leaves_by_the_jax_rule():
    """At Llama-2-7B's shapes (meta tensors: no memory) the selection rule
    packs 11 leaves, the stacked norms among them."""
    cfg = llama.LlamaConfig.llama2_7b()
    shapes = jax.eval_shape(lambda: jllama.init_params(jllama.LlamaConfig.llama2_7b(),
                                                       jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(lambda s: torch.empty(s.shape, device="meta"), shapes)
    picked = [path for path, leaf in _with_paths(params)
              if leaf.dim() >= 2 and leaf.numel() >= 4096]
    assert sorted(picked) == sorted([
        "embed", "layers.attn.wq", "layers.attn.wk", "layers.attn.wv", "layers.attn.wo",
        "layers.mlp.w_gate", "layers.mlp.w_up", "layers.mlp.w_down", "layers.attn_norm",
        "layers.mlp_norm", "lm_head"])
    assert llama.num_params(cfg) == sum(leaf.numel() for _, leaf in _with_paths(params))
    assert quantize_int8.launches == 0

"""The port's compression library on the CPU against the JAX package's, the
same numpy inputs through both, fp32, compared exactly: fake quantization,
the pruning masks (sparse, row, head 2-D and stacked, channel), a leaf that
is quantized and then pruned (full of ties, every tie kept), the method
order and first-match rule of ``init_compression`` over a Llama tree,
``QuantAct`` dynamic, static and frozen, ``layer_reduction`` (and its
refusal of a mixed tree), ``redundancy_clean`` in its three layer-reduction
spellings, ``shrink_rows`` and the scheduler.  The leaf keys the groups'
regexes match are JAX's ``key_of`` keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import compression as jcomp
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch import compression as comp
from deepspeed_tpu_torch.compression import basic_layer
from deepspeed_tpu_torch.runtime.checkpointing import flatten_with_paths
from deepspeed_tpu_torch.runtime.tree import tree_map


def _w(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(fn_j, fn_p, *arrays, **kw):
    got = fn_p(*[torch.from_numpy(a) for a in arrays], **kw)
    want = fn_j(*[jnp.asarray(a) for a in arrays], **kw)
    return got.numpy(), np.asarray(want)


def _equal(got, want):
    np.testing.assert_array_equal(got, want)


def _llama_tree(seed=0):
    cfg = jllama.LlamaConfig.tiny(vocab=64, hidden=32, layers=4, heads=4, kv_heads=2, seq=16)
    jparams = jax.tree_util.tree_map(np.asarray, jllama.init_params(cfg, jax.random.PRNGKey(seed)))
    return jparams, tree_map(lambda a: torch.from_numpy(np.array(a)), jparams)


def _tree_equal(got, want):
    for path, leaf in flatten_with_paths(got):
        ref = want
        for p in path:
            ref = ref[p]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref), err_msg=".".join(path))


def _jax_keys(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
            for path, _ in flat]


@pytest.mark.parametrize("family", ["llama", "gpt2", "bert"])
def test_leaf_keys_are_jax_key_of(family):
    module, cfg = {"llama": (jllama, jllama.LlamaConfig.tiny()),
                   "gpt2": (jgpt2, jgpt2.GPT2Config.tiny()),
                   "bert": (jbert, jbert.BertConfig.tiny())}[family]
    jparams = module.init_params(cfg, jax.random.PRNGKey(0))
    ports = [".".join(map(str, path)) for path, _ in flatten_with_paths(
        jax.tree_util.tree_map(np.asarray, jparams))]
    assert ports == _jax_keys(jparams)


@pytest.mark.parametrize("bits,group", [(8, 0), (4, 0), (8, 16), (3, 7)])
def test_fake_quantize_matches_jax(bits, group):
    _equal(*_both(jcomp.fake_quantize, comp.fake_quantize, _w(1, 6, 28), bits=bits,
                  group_size=group))


@pytest.mark.parametrize("density", [0.1, 0.5, 0.9])
def test_masks_match_jax(density):
    w = _w(2, 24, 40)
    _equal(*_both(jcomp.sparse_prune_mask, comp.sparse_prune_mask, w, density=density))
    _equal(*_both(jcomp.row_prune_mask, comp.row_prune_mask, w, density=density))
    _equal(*_both(jcomp.channel_prune_mask, comp.channel_prune_mask, w, density=density))
    for axis in ("in", "out"):
        _equal(*_both(jcomp.head_prune_mask, comp.head_prune_mask, w, num_heads=4,
                      density=density, head_axis=axis))


def test_stacked_head_pruning_matches_jax():
    w = _w(3, 3, 32, 32)
    got, want = _both(jcomp.head_prune_mask, comp.head_prune_mask, w, num_heads=8, density=0.5)
    _equal(got, want)
    kept = got[:, ::4, 0].sum(axis=1)  # heads kept in each layer, pruned on its own
    assert kept.tolist() == [4.0, 4.0, 4.0]
    with pytest.raises(ValueError, match="not divisible"):
        comp.head_prune_mask(torch.from_numpy(w), num_heads=5, density=0.5)


def test_quantized_then_pruned_leaf_keeps_every_tie():
    """At 3 bits a leaf holds 7 levels: the threshold ties with many
    elements, and JAX's ``>=`` keeps every tie (a top-k would keep exactly
    k)."""
    w = _w(4, 16, 16)
    q = comp.fake_quantize(torch.from_numpy(w), bits=3)
    assert len(torch.unique(q)) <= 7
    got = (q * comp.sparse_prune_mask(q, 0.1)).numpy()
    jq = jcomp.fake_quantize(jnp.asarray(w), bits=3)
    want = np.asarray(jq * jcomp.sparse_prune_mask(jq, 0.1))
    _equal(got, want)
    assert (got != 0).sum() > round(0.1 * w.size)


def _config():
    return {
        "weight_quantization": {"different_groups": {
            "wq1": {"params": {"target_bits": 3}, "modules": ["attn\\.w[qk]"]},
            "wq2": {"params": {"target_bits": 8}, "modules": ["attn\\."]}}},
        "sparse_pruning": {"different_groups": {
            "sp1": {"params": {"dense_ratio": 0.3}, "modules": ["mlp\\.", "attn\\.wq"]}}},
        "row_pruning": {"different_groups": {
            "rp1": {"params": {"dense_ratio": 0.5}, "modules": ["w_up"]}}},
        "head_pruning": {"shared_parameters": {"num_heads": 4}, "different_groups": {
            "hp1": {"params": {"dense_ratio": 0.75}, "modules": ["attn\\.wo"]}}},
        "channel_pruning": {"different_groups": {
            "cp1": {"params": {"dense_ratio": 0.5}, "modules": ["^embed$"]}}},
    }


def test_init_compression_matches_jax():
    jparams, params = _llama_tree()
    got = comp.init_compression(params, _config())
    want = jax.tree_util.tree_map(np.asarray, jcomp.init_compression(
        jax.tree_util.tree_map(jnp.asarray, jparams), _config()))
    _tree_equal(got, want)
    # wq: the first matching quantize group (3 bits), then pruned: ties kept
    assert len(torch.unique(got["layers"]["attn"]["wq"])) <= 7
    # the norms (2-D [L, D] leaves no group matches) come back as they were
    assert got["layers"]["attn_norm"] is params["layers"]["attn_norm"]
    assert got["final_norm"] is params["final_norm"]
    with pytest.raises(ValueError, match="needs num_heads"):
        comp.init_compression(params, {"head_pruning": {"different_groups": {
            "h": {"modules": ["wo"]}}}})


def test_quant_act_matches_jax(monkeypatch):
    xs = [_w(10 + i, 4, 8) * (i + 1) for i in range(3)]
    for dynamic in (True, False):
        jq, pq = jcomp.QuantAct(bits=4, dynamic=dynamic), comp.QuantAct(bits=4, dynamic=dynamic)
        for x in xs:
            _equal(pq(torch.from_numpy(x)).numpy(), np.asarray(jq(jnp.asarray(x))))
        if not dynamic:
            assert pq.running_max == pytest.approx(jq.running_max, rel=1e-6)
        jq.freeze()
        pq.freeze()
        big = xs[0] * 10
        _equal(pq(torch.from_numpy(big)).numpy(), np.asarray(jq(jnp.asarray(big))))
    # static calibration cannot run under a trace: JAX's jit, the port's compile
    with pytest.raises(RuntimeError, match="static calibration"):
        jax.jit(jcomp.QuantAct(dynamic=False))(jnp.asarray(xs[0]))
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with pytest.raises(RuntimeError, match="static calibration"):
        comp.QuantAct(dynamic=False)(torch.from_numpy(xs[0]))


def test_layer_reduction_and_its_refusal_match_jax():
    jparams, params = _llama_tree()
    got = comp.layer_reduction(params["layers"], [0, 2, 3])
    want = jcomp.layer_reduction(jparams["layers"], [0, 2, 3])
    _tree_equal(got, jax.tree_util.tree_map(np.asarray, want))
    with pytest.raises(ValueError) as jerr:
        jcomp.layer_reduction(jparams, [0])
    with pytest.raises(ValueError) as perr:
        comp.layer_reduction(params, [0])
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="out of range"):
        comp.layer_reduction(params["layers"], [4])


@pytest.mark.parametrize("spelling", [
    {"keep_layers": [1, 3], "module_name_prefix": "layers"},
    {"keep_number_layer": 3, "teacher_layer": 4, "module_name_prefix": "layers"},
    {"keep_number_layer": 2, "teacher_layer": 4}])
def test_redundancy_clean_matches_jax(spelling):
    jparams, params = _llama_tree(1)
    if "module_name_prefix" not in spelling:
        jparams, params = jparams["layers"], params["layers"]
    conf = {**_config(), "layer_reduction": {"enabled": True, **spelling}}
    got = comp.redundancy_clean(params, conf)
    want = jcomp.redundancy_clean(jax.tree_util.tree_map(jnp.asarray, jparams), conf)
    _tree_equal(got, jax.tree_util.tree_map(np.asarray, want))
    lead = {int(leaf.shape[0]) for _, leaf in flatten_with_paths(
        got["layers"] if "layers" in got else got)}
    assert lead == {len(spelling.get("keep_layers", [])) or spelling["keep_number_layer"]}


def test_shrink_rows_and_scheduler_match_jax():
    w = _w(5, 6, 10)
    mask = np.asarray(jcomp.row_prune_mask(jnp.asarray(w), 0.5))[0]
    _equal(basic_layer.shrink_rows(torch.from_numpy(w), torch.from_numpy(mask.copy())).numpy(),
           np.asarray(jcomp.shrink_rows(jnp.asarray(w), mask)))
    for offset, freq in ((0, 1), (3, 2), (5, 0)):
        js, ps = jcomp.CompressionScheduler(offset, freq), comp.CompressionScheduler(offset, freq)
        assert [ps.is_active(s) for s in range(12)] == [js.is_active(s) for s in range(12)]

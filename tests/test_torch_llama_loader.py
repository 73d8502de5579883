"""The port's ``llama.abstract_params`` and ``llama.hf_streaming_loader`` on
the CPU against the JAX package's: the abstract tree's paths, shapes and
dtypes equal ``jax.eval_shape``'s with no storage behind them, and on a
seeded synthetic HuggingFace state dict written here, the loader gives what
JAX's gives for every path and for slices over layers, rows and columns,
with and without ``lm_head.weight``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.models import llama, mistral
from deepspeed_tpu_torch.runtime.tree import tree_leaves

SHAPE = dict(vocab=40, hidden=16, layers=3, heads=4, kv_heads=2, seq=32)
CFG, JCFG = llama.LlamaConfig.tiny(**SHAPE), jllama.LlamaConfig.tiny(**SHAPE)


def _dotted(tree, prefix=""):
    """{dotted path: leaf} of a nested-dict tree."""
    out = {}
    for k, v in tree.items():
        out.update(_dotted(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


# JAX's init_linear multiplies by a numpy float64 scale, which promotes a
# bf16 draw to float32: its bf16 tree holds these leaves in float32, where
# the port's init_params (and so its abstract tree) keeps the dtype asked for
JAX_PROMOTED = {"layers.attn.wq", "layers.attn.wk", "layers.attn.wv", "layers.attn.wo",
                "layers.mlp.w_gate", "layers.mlp.w_up", "layers.mlp.w_down", "lm_head"}


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_abstract_params_match_eval_shape_and_hold_nothing(dtype, jdtype):
    got = _dotted(llama.abstract_params(CFG, dtype=dtype))
    ref = _dotted(jllama.abstract_params(JCFG, dtype=jdtype))
    assert sorted(got) == sorted(ref)
    promoted = JAX_PROMOTED if dtype == torch.bfloat16 else set()
    for path, leaf in got.items():
        assert tuple(leaf.shape) == ref[path].shape, path
        assert leaf.dtype == dtype, path
        assert str(ref[path].dtype) == ("float32" if path in promoted else str(jdtype.dtype))
        assert leaf.is_meta, path
    assert mistral.abstract_params is llama.abstract_params
    assert sum(t.numel() for t in tree_leaves(llama.abstract_params(CFG))) == llama.num_params(CFG)


def _state_dict(with_lm_head):
    rng = np.random.default_rng(0)
    D, F, L, V = CFG.hidden_size, CFG.intermediate_size, CFG.num_layers, CFG.vocab_size
    kvd = CFG.num_kv_heads * D // CFG.num_heads
    sd = {"model.embed_tokens.weight": (V, D), "model.norm.weight": (D, )}
    for i in range(L):
        pre = f"model.layers.{i}."
        sd.update({pre + "self_attn.q_proj.weight": (D, D), pre + "self_attn.k_proj.weight": (kvd, D),
                   pre + "self_attn.v_proj.weight": (kvd, D),
                   pre + "self_attn.o_proj.weight": (D, D), pre + "mlp.gate_proj.weight": (F, D),
                   pre + "mlp.up_proj.weight": (F, D), pre + "mlp.down_proj.weight": (D, F),
                   pre + "input_layernorm.weight": (D, ),
                   pre + "post_attention_layernorm.weight": (D, )})
    if with_lm_head:
        sd["lm_head.weight"] = (V, D)
    return {name: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for name, shape in sd.items()}


SLICES = [(slice(0, 3), ), (slice(1, 3), ), (slice(2, 3), slice(0, 5)),
          (slice(0, 2), slice(3, 9), slice(1, 4)), (slice(None), slice(None), slice(2, 16, 3))]


@pytest.mark.parametrize("with_lm_head", [True, False], ids=["lm_head", "tied_fallback"])
def test_hf_streaming_loader_matches_jax(with_lm_head):
    sd = _state_dict(with_lm_head)
    get_leaf = llama.hf_streaming_loader(CFG, sd.__getitem__)
    jget_leaf = jllama.hf_streaming_loader(JCFG, sd.__getitem__)
    abstract = _dotted(llama.abstract_params(CFG))
    assert "lm_head" in abstract
    for path, leaf in abstract.items():
        got, ref = get_leaf(path, leaf), jget_leaf(path, leaf)
        if not callable(ref):
            assert isinstance(got, np.ndarray) and got.dtype == np.float32
            assert got.shape == tuple(leaf.shape), path
            np.testing.assert_array_equal(got, ref)
            continue
        for idx in SLICES:
            idx = idx[:leaf.dim()]
            a, b = got(idx), ref(idx)
            assert a.dtype == np.float32 and a.shape == b.shape, (path, idx)
            np.testing.assert_array_equal(a, b)
        assert got((slice(0, CFG.num_layers), )).shape == tuple(leaf.shape), path
    lm_head = get_leaf("lm_head", abstract["lm_head"])
    source = "lm_head.weight" if with_lm_head else "model.embed_tokens.weight"
    np.testing.assert_array_equal(lm_head, sd[source].numpy().T)

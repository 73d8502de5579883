"""The port's paged attention on CPU tensors (its plain version) against the
JAX package: the dense-gather fallback and the Pallas kernel in interpret
mode, on the same numpy inputs.  fp32, atol 2e-5: the JAX package's own
kernel-vs-fallback tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import _pallas
from deepspeed_tpu.ops.attention.paged import _dense_fallback
from deepspeed_tpu.ops.attention.paged import paged_attention as jax_paged_attention
from deepspeed_tpu_torch.ops import _build, use_kernel
from deepspeed_tpu_torch.ops.attention import paged as paged_module
from deepspeed_tpu_torch.ops.attention.paged import paged_attention

ATOL = 2e-5

# (name, H, KV, T, n_tokens, lengths, window, alibi)
CASES = [
    ("mha_decode", 4, 4, 1, [1, 1, 1], [5, 20, 31], None, False),
    ("gqa_decode", 4, 2, 1, [1, 1, 1], [5, 20, 31], None, False),
    ("gqa_prefill_padding_rows", 4, 2, 4, [3, 4, 2], [5, 20, 31], None, False),
    ("mha_prefill_zero_length_row", 4, 4, 4, [4, 0, 4], [9, 0, 31], None, False),
    ("gqa_window", 4, 2, 4, [3, 4, 4], [5, 20, 31], 6, False),
    ("gqa_alibi", 4, 2, 4, [3, 4, 4], [5, 20, 31], None, True),
    ("mha_decode_window_alibi_zero_row", 4, 4, 1, [1, 0, 1], [17, 0, 31], 6, True),
]


def _inputs(seed, H, KV, T, n_tokens, lengths, alibi, Dh=32, NB=16, BS=8, MAXB=4):
    rng = np.random.default_rng(seed)
    n = len(lengths)
    lengths = np.asarray(lengths, np.int32)
    n_tokens = np.asarray(n_tokens, np.int32)
    return {
        "q": rng.normal(size=(n, T, H, Dh)).astype(np.float32),
        "kpool": rng.normal(size=(NB, KV, BS, Dh)).astype(np.float32),
        "vpool": rng.normal(size=(NB, KV, BS, Dh)).astype(np.float32),
        "tables": rng.integers(0, NB - 1, (n, MAXB)).astype(np.int32),
        "lengths": lengths,
        "start_pos": lengths - n_tokens,
        "n_tokens": n_tokens,
        "slopes": (np.asarray([0.5, 0.25, 0.125, 0.0625][:H], np.float32) if alibi else None),
    }


@pytest.mark.parametrize("name,H,KV,T,n_tokens,lengths,window,alibi", CASES,
                         ids=[c[0] for c in CASES])
def test_paged_attention_matches_jax(name, H, KV, T, n_tokens, lengths, window, alibi):
    x = _inputs(len(name), H, KV, T, n_tokens, lengths, alibi)
    BS, Dh = 8, 32
    scale = 1.0 / np.sqrt(Dh)
    tt = {k: torch.from_numpy(v) for k, v in x.items() if v is not None}
    got = paged_attention(tt["q"], tt["kpool"], tt["vpool"], tt["tables"], tt["lengths"],
                          tt["start_pos"], tt["n_tokens"], block_size=BS, window=window,
                          alibi_slopes=tt.get("slopes")).numpy()
    jx = {k: jnp.asarray(v) for k, v in x.items() if v is not None}
    ref = np.asarray(_dense_fallback(jx["q"], jx["kpool"], jx["vpool"], jx["tables"],
                                     jx["lengths"], jx["start_pos"], jx["n_tokens"], scale,
                                     window, jx.get("slopes")))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    old = _pallas.INTERPRET
    _pallas.INTERPRET = True
    try:
        kern = np.asarray(jax_paged_attention(jx["q"], jx["kpool"], jx["vpool"], jx["tables"],
                                              jx["lengths"], jx["start_pos"], jx["n_tokens"],
                                              block_size=BS, window=window,
                                              alibi_slopes=jx.get("slopes")))
    finally:
        _pallas.INTERPRET = old
    np.testing.assert_allclose(got, kern, atol=ATOL, rtol=0)
    # rows past n_tokens (and whole zero-length rows) are exact zeros
    pad = np.arange(T)[None, :] >= x["n_tokens"][:, None]
    assert np.all(got[pad] == 0.0)
    assert np.isfinite(got).all()


def test_paged_attention_cpu_path_launches_nothing():
    x = _inputs(0, 4, 2, 1, [1, 1, 1], [5, 20, 31], False)
    before = paged_attention.launches
    t = {k: torch.from_numpy(v) for k, v in x.items() if v is not None}
    paged_attention(t["q"], t["kpool"], t["vpool"], t["tables"], t["lengths"], t["start_pos"],
                    t["n_tokens"], block_size=8)
    assert paged_attention.launches == before


def test_paged_attention_refuses_non_cpu_non_cuda_inputs():
    """Inputs that are not CPU tensors never reach the plain version: a
    non-CUDA device, or a mix of devices, raises instead of computing."""
    x = _inputs(0, 4, 2, 1, [1, 1, 1], [5, 20, 31], False)
    t = {k: torch.from_numpy(v) for k, v in x.items() if v is not None}
    meta_q = t["q"].to("meta")
    with pytest.raises(ValueError, match="all lie on CUDA or all on the CPU"):
        paged_attention(meta_q, t["kpool"], t["vpool"], t["tables"], t["lengths"],
                        t["start_pos"], t["n_tokens"], block_size=8)
    meta = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError, match="all lie on CUDA or all on the CPU"):
        paged_attention(meta["q"], meta["kpool"], meta["vpool"], meta["tables"], meta["lengths"],
                        meta["start_pos"], meta["n_tokens"], block_size=8)
    assert use_kernel(t["q"]) is False


def _without_toolkit(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", "/nonexistent/nvcc")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "never-built")
    monkeypatch.setattr(paged_module, "_LIB", None)


def test_kernel_build_without_nvcc_raises(monkeypatch):
    """On a box without the CUDA toolkit the kernel build raises a clear
    error; nothing falls back to the plain version."""
    _without_toolkit(monkeypatch)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load("paged_attention")


def test_kernel_route_raises_instead_of_computing(monkeypatch):
    """Once the dispatch has picked the kernel (as it does for CUDA tensors),
    a box that cannot build it raises: the wrapper never computes the plain
    version in its place, and counts no launch."""
    _without_toolkit(monkeypatch)
    monkeypatch.setattr(paged_module, "use_kernel", lambda *tensors: True)
    x = _inputs(0, 4, 2, 1, [1, 1, 1], [5, 20, 31], False)
    t = {k: torch.from_numpy(v) for k, v in x.items() if v is not None}
    before = paged_attention.launches
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        paged_attention(t["q"], t["kpool"], t["vpool"], t["tables"], t["lengths"],
                        t["start_pos"], t["n_tokens"], block_size=8)
    assert paged_attention.launches == before

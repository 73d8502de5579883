"""The port's paged attention on CPU tensors (its plain version) against the
JAX package: the dense-gather fallback and the Pallas kernel in interpret
mode, on the same numpy inputs, at head dims 32 and 80 (Phi-2's) and at 71
q heads over one kv head (Falcon-7B's group).  fp32, atol 2e-5: the JAX
package's own kernel-vs-fallback tolerance.  Also the kernels' host
geometry: the CUDA-core and tensor-core row blocks and the decode key
tile."""

import subprocess
from pathlib import Path

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

# (name, H, KV, T, n_tokens, lengths, window, alibi), at head dim 32
BASE_CASES = [
    ("mha_decode", 4, 4, 1, [1, 1, 1], [5, 20, 31], None, False),
    ("gqa_decode", 4, 2, 1, [1, 1, 1], [5, 20, 31], None, False),
    ("gqa_prefill_padding_rows", 4, 2, 4, [3, 4, 2], [5, 20, 31], None, False),
    ("mha_prefill_zero_length_row", 4, 4, 4, [4, 0, 4], [9, 0, 31], None, False),
    ("gqa_window", 4, 2, 4, [3, 4, 4], [5, 20, 31], 6, False),
    ("gqa_alibi", 4, 2, 4, [3, 4, 4], [5, 20, 31], None, True),
    ("mha_decode_window_alibi_zero_row", 4, 4, 1, [1, 0, 1], [17, 0, 31], 6, True),
]
# the same cases at head dim 80, and with Falcon-7B's 71 q heads over 1 kv head
# (name, H, KV, T, n_tokens, lengths, window, alibi, Dh)
CASES = ([(*c, 32) for c in BASE_CASES]
         + [(f"{c[0]}_d80", *c[1:], 80) for c in BASE_CASES]
         + [(f"{c[0]}_mqa71", 71, 1, *c[3:], 32) for c in BASE_CASES])


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
        "slopes": (np.asarray([2.0**-(h + 1) for h in range(H)], np.float32) if alibi else None),
    }


@pytest.mark.parametrize("name,H,KV,T,n_tokens,lengths,window,alibi,Dh", CASES,
                         ids=[c[0] for c in CASES])
def test_paged_attention_matches_jax(name, H, KV, T, n_tokens, lengths, window, alibi, Dh):
    x = _inputs(len(name), H, KV, T, n_tokens, lengths, alibi, Dh=Dh)
    BS = 8
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


@pytest.mark.parametrize("failing_part", [None, 3])
def test_split_source_builds_each_part_then_links_one_library(monkeypatch, tmp_path,
                                                              failing_part):
    """The paged source builds as seven translation units (-DPAGED_PART=0..6,
    each compiled with -c) and one link of their objects into the library;
    the parts' objects are removed. A part nvcc refuses raises with its
    command, links nothing and leaves no library."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    ran = []

    def fake_nvcc(cmd):
        ran.append(cmd)
        refused = f"-DPAGED_PART={failing_part}" in cmd
        if not refused:
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"built")
        return subprocess.CompletedProcess(cmd, int(refused), "", "refused" if refused else "")

    monkeypatch.setattr(_build, "_run", fake_nvcc)
    if failing_part is not None:
        with pytest.raises(_build.KernelBuildError, match=f"-DPAGED_PART={failing_part}"):
            _build.build("paged_attention")
        assert all("-c" in cmd for cmd in ran) and len(ran) == 7
        assert list(tmp_path.iterdir()) == []
        return
    out = _build.build("paged_attention")
    compiles, link = ran[:-1], ran[-1]
    assert sorted(f for cmd in compiles for f in cmd if f.startswith("-D")) == \
        [f"-DPAGED_PART={i}" for i in range(7)]
    assert all("-c" in cmd and "-shared" not in cmd for cmd in compiles)
    assert "-shared" in link and "-c" not in link
    assert link[link.index("-o") + 1].endswith(".tmp")
    assert sorted(link[link.index("-o") + 2:]) == sorted(cmd[cmd.index("-o") + 1]
                                                         for cmd in compiles)
    assert out == _build.library_path("paged_attention") and out.read_bytes() == b"built"
    assert list(tmp_path.iterdir()) == [out]


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


def _row_blocks(chunk, group, rows_a_block):
    """Row-by-row enumeration of a (sequence, kv head)'s chunk x group rows,
    row r being token r // group and q head r % group of the kv head's
    group: {block: [(token, head), ...]} for blocks of ``rows_a_block``."""
    blocks = {}
    for r in range(chunk * group):
        blocks.setdefault(r // rows_a_block, []).append((r // group, r % group))
    return blocks


@pytest.mark.parametrize("group", [1, 4, 7, 32, 64, 71, 128])
def test_cuda_core_and_tensor_core_row_blocks(group):
    """``cuda_core_blocks`` and ``prefill_tc_blocks`` equal a row-by-row
    enumeration at T = 16, 20, 64 and 512: every (token, head) of the kv
    head's group lies in exactly one block.  Falcon-7B's group of 71 cuts
    tokens across blocks; for a group that divides 32, a CUDA-core block
    holds 32 / group whole tokens, as the kernel's blocks did before any
    group was taken (q_tile = 32 / group tokens of group heads a block)."""
    for t in (16, 20, 64, 512):
        for rows, count in ((paged_module.CUDA_CORE_ROWS, paged_module.cuda_core_blocks),
                            (paged_module.TC_ROWS, paged_module.prefill_tc_blocks)):
            blocks = _row_blocks(t, group, rows)
            assert count(t, group) == len(blocks)
            assert sorted(p for b in blocks.values() for p in b) == \
                [(tok, h) for tok in range(t) for h in range(group)]
            assert all(len(b) == rows for i, b in blocks.items() if i < len(blocks) - 1)
        if 32 % group == 0:
            q_tile = 32 // group
            for b, pairs in _row_blocks(t, group, paged_module.CUDA_CORE_ROWS).items():
                assert {tok for tok, _ in pairs} == set(range(b * q_tile,
                                                               min((b + 1) * q_tile, t)))
    assert paged_module.prefill_tc_blocks(512, 71) == 568
    assert paged_module.cuda_core_blocks(64, 71) == 142


def test_decode_key_tile_and_rows():
    """The decode kernel's tile is the largest power of two up to 64 keys
    whose K rows fit in 16 KB, so a warp's quarter divides 32 lanes: the
    tiles of the four tuned head dims are unchanged, and head dim 80 takes
    32 keys in fp32 and 64 in bf16/fp16; 8 rows a block at head dim 80."""
    tile = paged_module.decode_key_tile
    assert [tile(d, 4) for d in (32, 64, 128, 256)] == [64, 64, 32, 16]
    assert [tile(d, 2) for d in (32, 64, 128, 256)] == [64, 64, 64, 32]
    assert (tile(80, 4), tile(80, 2)) == (32, 64)
    for d in paged_module._HEAD_DIMS:
        for item in (2, 4):
            keys = tile(d, item)
            assert keys & (keys - 1) == 0 and 32 % (keys // 4) == 0
            assert keys * d * item <= paged_module.DECODE_TILE_BYTES
            assert d % (32 // (keys // 4)) == 0  # q parts: D split over the lanes of a key
    assert paged_module.decode_rows(80, 71) == 8 and paged_module.decode_rows(80, 1) == 4

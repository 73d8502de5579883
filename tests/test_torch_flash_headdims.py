"""The port's flash attention at head dims 80 (Phi-2) and 256 (GPT-J-6B) on
the CPU, against the JAX package's Pallas flash kernels run in interpret mode
on the same numpy inputs: the forward output and logsumexp (atol=rtol=2e-5)
and the gradients through both outputs (1e-4), causal and not, with GQA and
Sq < Sk; the wrapper's head-dim check; the kernel source's dispatch and its
split build by head dim; and Phi and GPT-J at their real head dims (2 narrow
layers) with the port calling ``flash_attention`` (its plain path here) and
JAX calling its Pallas flash, forward, loss and grads at 1e-4."""

import dataclasses
import re
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gptj as jgptj
from deepspeed_tpu.models import phi as jphi
from deepspeed_tpu.ops import _pallas
from deepspeed_tpu.ops.attention import flash as jflash
from deepspeed_tpu_torch.models import gptj, phi
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.attention import flash
from tests import torch_family_checks as fam

FWD_TOL = 2e-5
GRAD_TOL = 1e-4

# (name, B, Sq, Sk, H, KV, D, causal); JAX blocks of 16, so several q and k
# blocks and the causal block skip are exercised
CASES = [
    ("d80_causal_gqa_s40", 1, 40, 40, 4, 2, 80, True),
    ("d80_full_sq16_lt_sk40", 1, 16, 40, 2, 1, 80, False),
    ("d256_causal_sq16_lt_sk40_gqa", 1, 16, 40, 4, 2, 256, True),
    ("d256_full_s24", 2, 24, 24, 2, 2, 256, False),
]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(_pallas, "INTERPRET", True)


def _inputs(seed, B, Sq, Sk, H, KV, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))


@pytest.mark.parametrize("name,B,Sq,Sk,H,KV,D,causal", CASES, ids=[c[0] for c in CASES])
def test_forward_and_lse_match_jax_kernel(name, B, Sq, Sk, H, KV, D, causal):
    q, k, v = _inputs(len(name), B, Sq, Sk, H, KV, D)
    jout, jlse = jflash.flash_attention_with_lse(*(jnp.asarray(x) for x in (q, k, v)),
                                                 causal=causal, block_q=16, block_k=16)
    out, lse = flash.flash_attention_with_lse(*(torch.from_numpy(x) for x in (q, k, v)),
                                              causal=causal)
    assert out.shape == (B, Sq, H, D) and lse.shape == (B, H, Sq)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("name,B,Sq,Sk,H,KV,D,causal", CASES, ids=[c[0] for c in CASES])
def test_grads_through_out_and_lse_match_jax_kernel(name, B, Sq, Sk, H, KV, D, causal):
    q, k, v = _inputs(100 + len(name), B, Sq, Sk, H, KV, D)

    def jloss(q, k, v):
        o, l = jflash.flash_attention_with_lse(q, k, v, causal=causal, block_q=16, block_k=16)
        return jnp.sum(o**2) + jnp.sum(jnp.sin(l))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o, l = flash.flash_attention_with_lse(tq, tk, tv, causal=causal)
    (o.pow(2).sum() + torch.sin(l).sum()).backward()
    for got, ref, which in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{which}")


@pytest.mark.parametrize("d", [80, 256])
def test_check_takes_80_and_256_and_refuses_96(d):
    """``_check`` (the wrappers' guard before a launch) passes Phi-2's and
    GPT-J-6B's head dims for every dtype and refuses a head dim outside the
    set, naming the set."""
    assert flash._HEAD_DIMS == (64, 80, 128, 256)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q = torch.zeros((1, 8, 4, d), dtype=dtype)
        kv = torch.zeros((1, 8, 2, d), dtype=dtype)
        rows = torch.zeros((1, 4, 8))
        flash._check(q, kv, kv)
        flash._check(q, kv, kv, q, rows, rows)
    q96 = torch.zeros((1, 8, 2, 96), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"head_dim 96 not in \(64, 80, 128, 256\)"):
        flash._check(q96, q96, q96)


SOURCE = _build.CSRC_DIR / "flash_attention.cu"


def test_kernel_source_dispatches_every_head_dim_in_one_part():
    """The C dispatch's head dims are the wrapper's, and each is instantiated
    in exactly one part of the split build (-DFLASH_PART=1..4; part 0 holds
    the C interface and declares them extern)."""
    text = SOURCE.read_text()
    cases = [int(d) for d in re.findall(r"case (\d+):\s*\n\s*return flash_parts::launch_head",
                                        text)]
    assert tuple(cases) == flash._HEAD_DIMS
    instances = re.findall(r"#if FLASH_PART == 0 \|\| FLASH_PART == (\d)\n"
                           r"FLASH_INSTANCE cudaError_t launch_head<(\d+)>", text)
    assert sorted(int(d) for _, d in instances) == sorted(flash._HEAD_DIMS)
    assert sorted(int(p) for p, _ in instances) == [1, 2, 3, 4]
    assert _build.SPLIT_SOURCES["flash_attention"] == ("FLASH_PART", 5)


def test_flash_source_builds_as_five_parts_and_one_link(monkeypatch, tmp_path):
    """The flash source compiles as five translation units at once
    (-DFLASH_PART=0..4, each with -c) and one link of their objects."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    ran = []

    def fake_nvcc(cmd):
        ran.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"built")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "_run", fake_nvcc)
    out = _build.build("flash_attention")
    compiles, link = ran[:-1], ran[-1]
    assert sorted(f for cmd in compiles for f in cmd if f.startswith("-D")) == \
        [f"-DFLASH_PART={i}" for i in range(5)]
    assert all("-c" in cmd and "-shared" not in cmd for cmd in compiles)
    assert "-shared" in link and sorted(link[link.index("-o") + 2:]) == sorted(
        cmd[cmd.index("-o") + 1] for cmd in compiles)
    assert list(tmp_path.iterdir()) == [out]


# Phi-2's head dim (80, partial rotary 32) and GPT-J-6B's (256, rotary 64)
# at 2 narrow layers: 160 and 512 wide over 2 heads
PHI = (dataclasses.replace(jphi.PhiConfig.tiny(vocab=96, hidden=160, heads=2),
                           partial_rotary_factor=0.4),
       dataclasses.replace(phi.PhiConfig.tiny(vocab=96, hidden=160, heads=2),
                           partial_rotary_factor=0.4))
GPTJ = (jgptj.GPTJConfig.tiny(vocab=96, hidden=512, heads=2, rotary_dim=64),
        gptj.GPTJConfig.tiny(vocab=96, hidden=512, heads=2, rotary_dim=64))
FAMILIES = {"phi": (jphi, phi, *PHI), "gptj": (jgptj, gptj, *GPTJ)}
FLASH_FNS = (jflash.flash_attention, flash.flash_attention)


@pytest.mark.parametrize("key", sorted(FAMILIES))
def test_family_at_its_head_dim_through_flash_matches_jax(key):
    jmod, mod, jcfg, cfg = FAMILIES[key]
    dh = cfg.hidden_size // cfg.num_heads
    assert (dh, cfg.rotary_dim) == {"phi": (80, 32), "gptj": (256, 64)}[key]
    fam.check_config(cfg, jcfg)
    jparams, params = fam.pair_params(jmod, mod, jcfg, cfg)
    launched = [fn.launches for fn in (flash.flash_fwd, flash.flash_bwd_dkdv, flash.flash_bwd_dq)]
    fam.check_forward(jmod, mod, jcfg, cfg, jparams, params, attention_fns=FLASH_FNS)
    fam.check_loss_and_grads(jmod, mod, jcfg, cfg, jparams, params, attention_fns=FLASH_FNS)
    # the CPU path is the plain versions: nothing launched, nothing counted
    assert [fn.launches for fn in (flash.flash_fwd, flash.flash_bwd_dkdv,
                                   flash.flash_bwd_dq)] == launched

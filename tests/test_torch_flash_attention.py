"""The port's flash attention on the CPU (its plain versions) against the JAX
package's Pallas flash kernels run in interpret mode, on the same numpy
inputs: forward output and logsumexp (atol=rtol=2e-5, the JAX package's own
kernel-vs-sdpa tolerance) and the gradients through both outputs, the lse
cotangent included (1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import _pallas
from deepspeed_tpu.ops.attention import flash as jflash
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.ops.attention import flash

FWD_TOL = 2e-5
GRAD_TOL = 1e-4

# (name, B, Sq, Sk, H, KV, D, causal); JAX blocks of 16 so several q and k
# blocks (and the causal block skip) are exercised
CASES = [
    ("causal_mha", 1, 32, 32, 4, 4, 16, True),
    ("noncausal_gqa", 1, 32, 32, 4, 2, 16, False),
    ("causal_sq_lt_sk", 1, 16, 40, 4, 2, 16, True),
    ("causal_unaligned_s40", 2, 40, 40, 2, 2, 16, True),
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
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=FWD_TOL, rtol=FWD_TOL)
    plain = flash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    np.testing.assert_array_equal(plain.numpy(), out.numpy())


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


def test_flash_attention_grads_match_jax_kernel():
    q, k, v = _inputs(7, 1, 32, 32, 4, 2, 16)

    def jloss(q, k, v):
        return jnp.sum(jflash.flash_attention(q, k, v, causal=True, block_q=16, block_k=16)**2)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    flash.flash_attention(tq, tk, tv, causal=True).pow(2).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_plain_backward_matches_autograd_of_sdpa():
    """The backward plain versions (which hold the CUDA kernels to account on
    the card) against torch autograd through plain sdpa, GQA and causal."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _inputs(3, 2, 24, 24, 4, 2, 8))
    do = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 24, 4, 8)).astype(np.float32))
    ref = tf.sdpa(q, k, v, causal=True)
    ref.backward(do)
    scale = 1.0 / np.sqrt(8)
    out, lse = flash.flash_fwd_reference(q.detach(), k.detach(), v.detach(), scale, True)
    delta = (do * out).sum(-1).transpose(1, 2)
    args = (q.detach(), k.detach(), v.detach(), do, lse, delta, scale, True)
    dk, dv = flash.flash_bwd_dkdv_reference(*args)
    dq = flash.flash_bwd_dq_reference(*args)
    for got, want in ((dq, q.grad), (dk, k.grad), (dv, v.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FWD_TOL, rtol=FWD_TOL)


def test_dense_mask_goes_to_sdpa_and_cpu_never_launches():
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, 1, 12, 12, 2, 2, 8))
    mask = torch.from_numpy(np.random.default_rng(6).random((1, 1, 12, 12)) > 0.3)
    mask[..., 0] = True
    counts = (flash.flash_fwd.launches, flash.flash_bwd_dkdv.launches,
              flash.flash_bwd_dq.launches)
    got = flash.flash_attention(q, k, v, causal=False, mask=mask)
    torch.testing.assert_close(got, tf.sdpa(q, k, v, causal=False, mask=mask))
    flash.flash_attention(q.requires_grad_(True), k, v).sum().backward()
    assert (flash.flash_fwd.launches, flash.flash_bwd_dkdv.launches,
            flash.flash_bwd_dq.launches) == counts


def test_row_that_sees_no_key_is_zero_with_lse_neg_inf():
    """Causal with Sq > Sk: the first rows see no key; the plain version (and
    the kernel) gives zeros and lse = -1e30 instead of an average of masked
    values."""
    q, k, v = (torch.from_numpy(x) for x in (_inputs(8, 1, 6, 6, 2, 2, 8)[0],
                                             *_inputs(9, 1, 4, 4, 2, 2, 8)[1:]))
    out, lse = flash.flash_fwd_reference(q, k, v, 0.5, True)
    assert torch.all(out[:, :2] == 0) and torch.all(lse[:, :, :2] == flash.NEG_INF)
    assert torch.isfinite(out).all()

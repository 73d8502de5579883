"""The port's Evoformer attention on the CPU against the JAX package's
(plain ops on both sides, no Pallas kernel): forward and gradients within
1e-5, with a mask bias and a pair bias, ``remat`` on and off, and the
gated MSA-row block."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import evoformer as jevo
from deepspeed_tpu_torch.ops.attention import evoformer as evo

ROWS, S, H, D = 3, 12, 4, 8


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(ROWS, S, H, D)).astype(np.float32) for _ in range(3))
    mask = np.where(rng.random((ROWS, 1, 1, S)) < 0.2, -1e9, 0.0).astype(np.float32)
    pair = rng.normal(size=(1, H, S, S)).astype(np.float32)
    return q, k, v, mask, pair


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("n_bias", [0, 1, 2])
def test_evoformer_attention_matches_jax(remat, n_bias):
    q, k, v, mask, pair = _inputs()
    biases = [mask, pair][:n_bias]
    g = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)

    def jloss(q, k, v, *b):
        return jnp.sum(jevo.evoformer_attention(q, k, v, list(b), remat=remat) * g)

    jout = jevo.evoformer_attention(*map(jnp.asarray, (q, k, v)), list(map(jnp.asarray, biases)),
                                    remat=remat)
    jgrads = jax.grad(jloss, argnums=tuple(range(3 + n_bias)))(
        *map(jnp.asarray, (q, k, v, *biases)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, *biases)]
    out = evo.evoformer_attention(*ts[:3], ts[3:], remat=remat)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="at most"):
        evo.evoformer_attention(*ts[:3], [ts[0]] * 3)


def test_msa_row_block_matches_jax():
    rng = np.random.default_rng(2)
    c = 16
    msa = rng.normal(size=(ROWS, S, c)).astype(np.float32)
    pair = rng.normal(size=(H, S, S)).astype(np.float32)
    params = {n: (rng.normal(size=(c, H * D) if n != "wo" else (H * D, c)) * 0.2).astype(
        np.float32) for n in ("wq", "wk", "wv", "wg", "wo")}
    want = jevo.msa_row_attention_with_pair_bias(jnp.asarray(msa), jnp.asarray(pair),
                                                 {k: jnp.asarray(v) for k, v in params.items()},
                                                 H)
    got = evo.msa_row_attention_with_pair_bias(
        torch.from_numpy(msa), torch.from_numpy(pair),
        {k: torch.from_numpy(v) for k, v in params.items()}, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

"""The port's Mistral dense path (``deepspeed_tpu_torch.models.mistral``) on
the CPU against the JAX package's, with a window shorter than the sequence:
``windowed_attention`` itself (queries at the end of the keys, with and
without a caller's mask), ``forward``, and the loss and its grads.  fp32 at
1e-4; the JAX tiny config but a window of 5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import mistral as jmistral
from deepspeed_tpu_torch.models import mistral
from tests import torch_family_checks as fam

SHAPE = dict(vocab=96, window=5)
CFG, JCFG = mistral.MistralConfig.tiny(**SHAPE), jmistral.MistralConfig.tiny(**SHAPE)


@pytest.fixture(scope="module")
def weights():
    return fam.pair_params(jmistral, mistral, JCFG, CFG)


@pytest.mark.parametrize("sq,sk,masked", [(12, 12, False), (4, 12, False), (12, 12, True)])
def test_windowed_attention_matches_jax(sq, sk, masked):
    rng = np.random.default_rng(sq + sk + masked)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, 2, 16)).astype(np.float32) for _ in range(2))
    mask = None
    if masked:
        mask = np.ones((2, 1, 1, sk), bool)
        mask[1, ..., 9:] = False
    got = mistral.windowed_attention(5)(*(torch.from_numpy(x) for x in (q, k, v)),
                                        mask=None if mask is None else torch.from_numpy(mask))
    ref = jmistral.windowed_attention(5)(*(jnp.asarray(x) for x in (q, k, v)),
                                         mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=fam.ATOL, rtol=fam.RTOL)
    assert mistral.windowed_attention(None) is None


def test_forward_loss_and_grads_match_jax(weights):
    """The sequences of 12 and 13 tokens run past the window of 5, and the
    windowed forward differs from the unwindowed Llama forward."""
    fam.check_forward(jmistral, mistral, JCFG, CFG, *weights)
    fam.check_loss_and_grads(jmistral, mistral, JCFG, CFG, *weights)
    ids = torch.from_numpy(fam.token_ids(CFG, (2, 12)))
    windowed = mistral.forward(CFG, weights[1], ids).detach()
    full = mistral.llama.forward(CFG, weights[1], ids).detach()
    assert torch.allclose(windowed[:, :5], full[:, :5], atol=1e-5)
    assert not torch.allclose(windowed[:, 5:], full[:, 5:], atol=1e-3)

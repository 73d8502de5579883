"""The port's block quantizer (its plain version on the CPU) against the JAX
package on the same numpy inputs.  The JAX ``quantize_int8`` runs its Pallas
kernel in interpret mode for groups that are a multiple of 128 and its XLA
fallback for the others.  The int8 codes must EQUAL both, and the fp32
scales must equal the fallback's; the interpret-mode kernel's scales may be
one ulp away, because XLA turns its ``absmax / 127.0`` by a constant into a
multiplication by the reciprocal, where the fallback, the port and the CUDA
kernel divide.  The hand-written kernel is held to the plain version bit
for bit on the card.  int4 (XLA-composed in JAX) is compared the same way."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import _pallas
from deepspeed_tpu.ops.quantizer import quantize as jq
from deepspeed_tpu_torch.ops.quantizer import quantize as q


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(_pallas, "INTERPRET", True)


def _x(seed, n, scale=3.0):
    return (np.random.default_rng(seed).normal(size=n) * scale).astype(np.float32)


def _assert_int8_equal(x_np, group_size, torch_dtype=torch.float32, jax_dtype=jnp.float32):
    """Codes and scales against the JAX fallback (equal) and, where the group
    takes it, the interpret-mode Pallas kernel (codes equal, scales within an
    ulp); returns the port's codes and scales."""
    launches = q.quantize_int8.launches
    codes, scales, n = q.quantize_int8(torch.from_numpy(x_np).to(torch_dtype), group_size)
    assert q.quantize_int8.launches == launches  # the CPU path never launches
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    x = jnp.asarray(x_np).astype(jax_dtype)
    for interpret in (False, True):
        _pallas.INTERPRET = interpret
        jcodes, jscales, jn = jq.quantize_int8(x, group_size)
        assert n == jn == x_np.size
        assert tuple(codes.shape) == jcodes.shape and tuple(scales.shape) == jscales.shape
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        if interpret:
            np.testing.assert_array_max_ulp(scales.numpy(), np.asarray(jscales), maxulp=1)
        else:
            np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    return codes, scales


@pytest.mark.parametrize("group_size", [128, 256, 2048, 64, 100])
def test_quantize_int8_matches_jax(group_size):
    """128/256/2048 take the JAX Pallas kernel, 64/100 its XLA fallback; 5000
    elements leave a tail group (zero-padded in both)."""
    _assert_int8_equal(_x(group_size, 5000), group_size)


def test_quantize_int8_tail_and_zero_groups():
    x = _x(1, 1000)
    x[256:384] = 0.0  # the third group of 128 is all zero: scale 1, codes 0
    codes, scales = _assert_int8_equal(x, 128)
    assert float(scales[2, 0]) == 1.0 and not codes[2].any()
    assert tuple(codes.shape) == (8, 128) and not codes[7, 1000 - 7 * 128:].any()
    _assert_int8_equal(x[:77], 2048)  # fewer elements than a group: one group of 77


def test_quantize_int8_bf16_and_fp16_inputs():
    x = _x(2, 3000)
    _assert_int8_equal(x, 128, torch.bfloat16, jnp.bfloat16)
    _assert_int8_equal(x, 64, torch.bfloat16, jnp.bfloat16)
    _assert_int8_equal(x, 256, torch.float16, jnp.float16)


def test_quantize_int8_rounds_half_to_even():
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -127.0], np.float32)  # scale 1
    codes, _ = _assert_int8_equal(x, 8)
    assert codes[0].tolist() == [127, 0, 2, 2, 0, -2, 126, -127]


def test_int8_roundtrip_within_half_a_scale():
    x = _x(3, 5000)
    codes, scales, n = q.quantize_int8(torch.from_numpy(x), 512)
    back = q.dequantize_int8(codes, scales, n).numpy()
    bound = np.repeat(scales.numpy()[:, 0], 512)[:n] / 2 + 1e-6
    assert (np.abs(back - x) <= bound).all()
    ref = jq.dequantize_int8(jnp.asarray(codes.numpy()), jnp.asarray(scales.numpy()), n)
    np.testing.assert_array_equal(back, np.asarray(ref))
    shaped = q.dequantize_int8(codes, scales, n, shape=(50, 100), dtype=torch.bfloat16)
    assert shaped.shape == (50, 100) and shaped.dtype == torch.bfloat16


@pytest.mark.parametrize("n,group_size", [(4096, 256), (1001, 64), (33, 2048)])
def test_int4_pack_and_unpack_match_jax(n, group_size):
    x = _x(n, n)
    jpacked, jscales, jn = jq.quantize_int4(jnp.asarray(x), group_size)
    packed, scales, got_n = q.quantize_int4(torch.from_numpy(x), group_size)
    assert got_n == jn == n
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    back = q.dequantize_int4(packed, scales, n).numpy()
    np.testing.assert_array_equal(back, np.asarray(jq.dequantize_int4(jpacked, jscales, n)))
    g = packed.shape[1] * 2
    bound = np.repeat(scales.numpy()[:, 0], g)[:n] / 2 + 1e-6
    assert (np.abs(back - x) <= bound).all()


def test_dispatch_refuses_other_devices():
    with pytest.raises(ValueError, match="all lie on CUDA or all on the CPU"):
        q.quantize_int8(torch.empty(256, device="meta"), 128)

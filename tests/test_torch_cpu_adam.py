"""The port's host CPU-Adam (``csrc/cpu_adam.cpp`` through
``ops/adam/cpu_adam.py``) on the CPU: bit for bit the JAX package's native
step (the same source and flags, both built here with g++, the JAX one
through its own ``DeepSpeedCPUAdam``), within 1e-6 of the plain version
``cpu_adamw_plain`` (bias correction at steps 1 and 1000, weight decay), and
a failed build raises where the JAX class falls back to numpy."""

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JaxCPUAdam
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.adam import cpu_adam
from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam, cpu_adamw_plain
from deepspeed_tpu_torch.ops.aio import build_aio_handle

HYPER = dict(lr=3e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.05)


def _state(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 1, n).astype(np.float32)
    m = rng.normal(0, 0.1, n).astype(np.float32)
    v = np.abs(rng.normal(0, 0.01, n)).astype(np.float32)
    return p, m, v


@pytest.mark.parametrize("n", [1, 7, 4096, 100_003])
def test_step_is_bit_identical_to_the_jax_native_step(n):
    jopt = JaxCPUAdam(**HYPER)
    assert jopt._lib is not None, "the JAX package's native library did not build"
    opt = DeepSpeedCPUAdam(**HYPER)
    jp, jm, jv = _state(n, n)
    p, m, v = (torch.from_numpy(a.copy()) for a in (jp, jm, jv))
    rng = np.random.default_rng(n + 1)
    for step in (1, 2, 3, 1000):
        g = rng.normal(0, 1, n).astype(np.float32)
        jopt.step(jp, jm, jv, g, lr=HYPER["lr"] * step ** -0.5, step=step)
        opt.step(p, m, v, torch.from_numpy(g), lr=HYPER["lr"] * step ** -0.5, step=step)
        for got, want in ((p, jp), (m, jm), (v, jv)):
            assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("step", [1, 1000])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_step_is_within_1e6_of_the_plain_version(step, weight_decay):
    n = 50_000
    p, m, v = (torch.from_numpy(a) for a in _state(n, 3))
    g = torch.from_numpy(np.random.default_rng(4).normal(0, 1, n).astype(np.float32))
    ref = [t.clone() for t in (p, m, v)]
    hyper = dict(HYPER, weight_decay=weight_decay)
    DeepSpeedCPUAdam(**hyper).step(p, m, v, g, step=step)
    cpu_adamw_plain(*ref, g, lr=hyper["lr"], beta1=0.9, beta2=0.999, eps=1e-8,
                    weight_decay=weight_decay, step=step)
    for got, want in zip((p, m, v), ref):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_own_step_count_threads_and_input_checks():
    """The optimizer's own 1-based count equals explicit steps; the thread
    count changes no bit (a static schedule of element-wise work); wrong
    dtypes, devices and sizes raise before the library is called."""
    n = 9_999
    a = [torch.from_numpy(x) for x in _state(n, 5)]
    b = [t.clone() for t in a]
    g = torch.from_numpy(np.random.default_rng(6).normal(0, 1, n).astype(np.float32))
    one, many = DeepSpeedCPUAdam(threads=1, **HYPER), DeepSpeedCPUAdam(threads=4, **HYPER)
    assert one.threads == 1 and many.threads == 4
    for step in (1, 2):
        one.step(*a, g)
        many.step(*b, g, step=step)
    assert one.step_count == 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="float32"):
        one.step(a[0].double(), *a[1:], g.double())
    with pytest.raises(ValueError, match="sizes differ"):
        one.step(*a, g[:-1])
    with pytest.raises(TypeError):
        one.step(a[0].numpy(), *a[1:], g)
    assert cpu_adam.default_threads() >= 1


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No numpy fallback: a source g++ refuses, or no g++, raises
    ``KernelBuildError`` from the optimizer and from the aio handle."""
    (tmp_path / "cpu_adam.cpp").write_text("this is not C++\n")
    (tmp_path / "aio.cpp").write_text("neither is this\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(_build.KernelBuildError, match="g\\+\\+ failed on csrc/cpu_adam.cpp"):
        DeepSpeedCPUAdam(**HYPER)
    with pytest.raises(_build.KernelBuildError, match="csrc/aio.cpp"):
        build_aio_handle(1)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(_build.KernelBuildError, match="g\\+\\+ not found"):
        DeepSpeedCPUAdam(**HYPER)


def test_host_library_names_carry_the_source_hash(monkeypatch, tmp_path):
    """An edited source builds under a new name; the flags are the JAX
    package's."""
    assert _build.HOST_FLAGS == ("-O3", "-shared", "-fPIC", "-std=c++17", "-march=native",
                                 "-fopenmp")
    src = (_build.CSRC_DIR / "cpu_adam.cpp").read_text()
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "cpu_adam.cpp").write_text(src)
    first = _build.library_path("cpu_adam")
    (tmp_path / "cpu_adam.cpp").write_text(src + "\n// edited\n")
    assert _build.library_path("cpu_adam") != first
    assert _build.is_host("cpu_adam") and not _build.is_host("fused_adam")

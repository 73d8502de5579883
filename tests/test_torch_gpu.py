"""The port's CUDA path on an NVIDIA GPU: the paged-attention kernel against
its plain PyTorch version on the same CUDA tensors, and a tiny engine on the
GPU against the same engine on the CPU.  Every test here needs a card and
skips without one.  This file imports no JAX, so it runs on a machine that
has only PyTorch: ``python -m pytest --noconftest tests/test_torch_gpu.py``
(the suite's conftest imports JAX)."""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import llama, mistral
from deepspeed_tpu_torch.ops.attention.paged import paged_attention, paged_attention_reference

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (name, dtype, H, KV, Dh, bs, T, lengths, n_tokens, window, alibi)
CASES = [
    ("gqa_decode_fp32", torch.float32, 8, 2, 128, 16, 1, [1, 37, 300, 0], [1, 1, 1, 0], None,
     False),
    ("gqa_prefill_window_bf16", torch.bfloat16, 8, 2, 64, 16, 8, [5, 40, 130, 0],
     [3, 8, 8, 0], 6, False),
    ("mha_alibi_fp16", torch.float16, 4, 4, 32, 8, 4, [3, 9, 17, 33], [3, 1, 2, 4], None, True),
    ("mqa_bs64_dh256_fp32", torch.float32, 8, 1, 256, 64, 5, [70, 1, 200], [5, 1, 2], 50,
     False),
]


def _case(seed, dtype, H, KV, Dh, bs, T, lengths, n_tokens, alibi, device):
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    n_tokens = np.asarray(n_tokens, np.int32)
    need = [-(-int(n) // bs) for n in lengths]
    maxb = max(1, max(need))
    nb = sum(need) + 1
    tables = np.full((len(lengths), maxb), nb - 1, np.int32)  # padding -> trash block
    perm = rng.permutation(nb - 1)
    at = 0
    for i, k in enumerate(need):
        tables[i, :k] = perm[at:at + k]
        at += k
    n = len(lengths)

    def t(a, dt=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return {
        "q": t(rng.normal(size=(n, T, H, Dh)).astype(np.float32), dtype),
        "kpool": t(rng.normal(size=(nb, KV, bs, Dh)).astype(np.float32), dtype),
        "vpool": t(rng.normal(size=(nb, KV, bs, Dh)).astype(np.float32), dtype),
        "tables": t(tables), "lengths": t(lengths), "start_pos": t(lengths - n_tokens),
        "n_tokens": t(n_tokens),
        "slopes": (t(np.asarray([2.0**(-(h + 1)) for h in range(H)], np.float32))
                   if alibi else None),
    }


@pytest.mark.parametrize("name,dtype,H,KV,Dh,bs,T,lengths,n_tokens,window,alibi", CASES,
                         ids=[c[0] for c in CASES])
def test_kernel_matches_plain_version(cuda, name, dtype, H, KV, Dh, bs, T, lengths, n_tokens,
                                      window, alibi):
    x = _case(len(name), dtype, H, KV, Dh, bs, T, lengths, n_tokens, alibi, cuda)
    before = paged_attention.launches
    got = paged_attention(x["q"], x["kpool"], x["vpool"], x["tables"], x["lengths"],
                          x["start_pos"], x["n_tokens"], block_size=bs, window=window,
                          alibi_slopes=x["slopes"])
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_reference(x["q"], x["kpool"], x["vpool"], x["tables"], x["lengths"],
                                    x["start_pos"], x["n_tokens"], 1.0 / np.sqrt(Dh), window,
                                    x["slopes"])
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    pad = torch.arange(T, device=cuda)[None, :] >= x["n_tokens"].long()[:, None]
    assert bool((got[pad] == 0).all())


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x48 = _case(0, torch.float32, 4, 2, 48, 8, 1, [5, 9], [1, 1], False, cuda)
    with pytest.raises(ValueError, match="head_dim 48"):
        paged_attention(x48["q"], x48["kpool"], x48["vpool"], x48["tables"], x48["lengths"],
                        x48["start_pos"], x48["n_tokens"], block_size=8)
    x = _case(0, torch.float32, 4, 2, 32, 8, 1, [5, 9], [1, 1], False, cuda)
    args = (x["kpool"], x["vpool"], x["tables"], x["lengths"], x["start_pos"], x["n_tokens"])
    with pytest.raises(TypeError, match="int32"):
        paged_attention(x["q"], *args[:3], x["lengths"].long(), *args[4:], block_size=8)
    with pytest.raises(ValueError, match="block_size"):
        paged_attention(x["q"], *args, block_size=16)


@pytest.mark.parametrize("module,config", [
    (llama, llama.LlamaConfig.tiny(vocab=128, hidden=128, layers=2, heads=4, kv_heads=2,
                                   seq=128)),
    (mistral, mistral.MistralConfig.tiny(vocab=128, hidden=128, layers=2, heads=4, kv_heads=2,
                                         seq=128, window=8)),
], ids=["llama", "mistral"])
def test_engine_on_gpu_matches_engine_on_cpu(cuda, module, config):
    params = module.init_params(config, torch.Generator().manual_seed(0))
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 10, 11], list(range(20, 45))]
    kw = dict(config={"dtype": "float32"}, num_blocks=64, block_size=16, max_blocks_per_seq=8,
              token_budget=16, max_seqs_per_step=4)
    ref = InferenceEngineV2(module, config, params, device="cpu", **kw).generate(
        prompts, max_new_tokens=6)
    engine = InferenceEngineV2(module, config, params, **kw)
    before = paged_attention.launches
    got = engine.generate(prompts, max_new_tokens=6)
    assert got == ref
    assert paged_attention.launches - before == engine.forward_steps * config.num_layers

"""The port's CUDA path on an NVIDIA GPU: the paged-attention, flash,
fused-AdamW, block-sparse, AdamW-8bit, int8-quantize and fused-Lion kernels
against their plain PyTorch versions on the same CUDA tensors, and tiny
serving engines (v2; v1 dense and weight-only int8) and tiny training engines
(dense with fused AdamW; block-sparse with 8-bit AdamW) on the GPU against the
same engines on the CPU.  Every test here needs a card and
skips without one.  This file imports no JAX, so it runs on a machine that
has only PyTorch: ``python -m pytest --noconftest tests/test_torch_gpu.py``
(the suite's conftest imports JAX)."""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import llama, mistral
from deepspeed_tpu_torch.ops.adam import adam8bit
from deepspeed_tpu_torch.inference import quantization as woq
from deepspeed_tpu_torch.ops.adam.fused_adam import (fused_adamw_flat, fused_adamw_flat_reference,
                                                     fused_lion_flat, fused_lion_flat_reference)
from deepspeed_tpu_torch.ops.attention import flash
from deepspeed_tpu_torch.ops.attention import paged as paged_module
from deepspeed_tpu_torch.ops.attention.paged import paged_attention, paged_attention_reference
from deepspeed_tpu_torch.ops.quantizer import quantize
from deepspeed_tpu_torch.ops.sparse_attention import attention as sparse
from deepspeed_tpu_torch.runtime.config import SparseAttentionConfig

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (name, dtype, H, KV, Dh, bs, T, lengths, n_tokens, window, alibi); T < 16
# takes the split-K decode kernel, T >= 16 with bf16/fp16 and head dim 64 or
# 128 the tensor-core prefill kernel, the rest the CUDA-core kernel
CASES = [
    ("gqa_decode_fp32", torch.float32, 8, 2, 128, 16, 1, [1, 37, 300, 0], [1, 1, 1, 0], None,
     False),
    ("gqa_prefill_window_bf16", torch.bfloat16, 8, 2, 64, 16, 8, [5, 40, 130, 0],
     [3, 8, 8, 0], 6, False),
    ("mha_alibi_fp16", torch.float16, 4, 4, 32, 8, 4, [3, 9, 17, 33], [3, 1, 2, 4], None, True),
    ("mqa_bs64_dh256_fp32", torch.float32, 8, 1, 256, 64, 5, [70, 1, 200], [5, 1, 2], 50,
     False),
    ("gqa_decode_bf16", torch.bfloat16, 32, 8, 128, 16, 1, [1, 700, 2048], [1, 1, 1], 4096,
     False),
    ("tc_gqa4_t16_bs8_window_bf16", torch.bfloat16, 8, 2, 64, 8, 16, [37, 100, 0],
     [16, 5, 0], 20, False),
    ("tc_mha_t64_bs16_alibi_fp16", torch.float16, 4, 4, 128, 16, 64, [64, 200, 77],
     [64, 64, 13], None, True),
    ("tc_gqa8_t512_bs64_decode_row_bf16", torch.bfloat16, 16, 2, 128, 64, 512,
     [1000, 777, 300], [512, 1, 0], 300, False),
    ("tc_mqa32_t16_bs16_fp16", torch.float16, 32, 1, 128, 16, 16, [300, 17], [16, 3], None,
     False),
    ("tc_mqa64_t32_bs128_alibi_bf16", torch.bfloat16, 64, 1, 64, 128, 32, [290, 40], [32, 7],
     None, True),
    # split edges: lengths on and one past a split boundary (both cases split
    # at 256 keys), 1 key beside 4096, a window that starts inside a split
    ("gqa_decode_split_edges_bf16", torch.bfloat16, 32, 8, 128, 16, 1,
     [4096, 1, 768, 769, 1536, 0], [1, 1, 1, 1, 1, 0], 1000, False),
    ("mqa32_decode_split_edges_fp32", torch.float32, 32, 1, 64, 64, 1,
     [4096, 1, 768, 769, 1536, 0], [1, 1, 1, 1, 1, 0], 700, True),
    ("cuda_core_d256_t16_bf16", torch.bfloat16, 8, 2, 256, 16, 16, [40, 300], [16, 9], None,
     False),
    # fp32 chunks of T >= 16 take the CUDA-core kernel: the fp32 slice's
    # Mistral-width prefill (T = 128) and a head dim 32 chunk with ALiBi
    ("cuda_core_gqa4_t128_window_fp32", torch.float32, 32, 8, 128, 16, 128, [70, 33],
     [70, 33], 4096, False),
    ("cuda_core_d32_t20_alibi_fp32", torch.float32, 4, 4, 32, 8, 20, [20, 57, 0],
     [20, 11, 0], 30, True),
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
    """fp32 at 1e-4.  bf16/fp16 held to ``flash.tensor_core_limit`` row by row
    against the plain version on fp32 copies, ``rounded`` rounding P to the
    input type for the tensor-core prefill kernel and nothing (an ulp of the
    store) for the split-K decode and CUDA-core kernels; each case launches
    the route the shape rule names (``decode_launches`` for T < 16); padding
    rows are exact zeros."""
    x = _case(len(name), dtype, H, KV, Dh, bs, T, lengths, n_tokens, alibi, cuda)
    route = paged_module.paged_route(dtype, Dh, T, H // KV)
    tc = route == "prefill_tc"
    assert tc == name.startswith("tc_") and (route == "decode") == (T < 16)
    counts = lambda: (paged_attention.launches, paged_attention.tc_launches,  # noqa: E731
                      paged_attention.decode_launches)
    before = counts()
    args = (x["q"], x["kpool"], x["vpool"], x["tables"], x["lengths"], x["start_pos"],
            x["n_tokens"])
    got = paged_attention(*args, block_size=bs, window=window, alibi_slopes=x["slopes"])
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + tc, before[2] + (route == "decode"))
    scale = 1.0 / np.sqrt(Dh)
    if dtype == torch.float32:
        ref = paged_attention_reference(*args, scale, window, x["slopes"])
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    else:
        f32 = (args[0].float(), args[1].float(), args[2].float(), *args[3:])
        ref = paged_attention_reference(*f32, scale, window, x["slopes"])
        rounded = paged_attention_reference(*f32, scale, window, x["slopes"],
                                            round_to=dtype if tc else None)
        ok, err, ratio, _ = flash.tensor_core_limit(got, ref, rounded)
        assert ok, f"max abs err {err:.3e}, {ratio:.3f} of the limit"
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
    before = (paged_attention.launches, paged_attention.tc_launches,
              paged_attention.decode_launches)
    got = engine.generate(prompts, max_new_tokens=6)
    assert got == ref
    # fp32: steps of padded chunk < 16 on the split-K decode kernel, the rest
    # on the CUDA-core kernel, none on the tensor-core prefill kernel
    head_dim = config.hidden_size // config.num_heads
    group = config.num_heads // config.num_kv_heads
    narrow = sum(k for t, k in engine.chunk_widths.items()
                 if paged_module.paged_route(torch.float32, head_dim, t, group) == "decode")
    assert 0 < narrow
    assert (paged_attention.launches - before[0], paged_attention.tc_launches - before[1],
            paged_attention.decode_launches - before[2]) == (
        engine.forward_steps * config.num_layers, 0, narrow * config.num_layers)


def test_bf16_engine_runs_the_prefill_kernel_on_wide_chunks(cuda):
    """A bf16 Mistral-shaped engine (head dim 64, GQA 4): every step whose
    padded chunk is 16 tokens or more launches the tensor-core prefill
    kernel in every layer, the other steps (decode) the split-K decode
    kernel; the tokens stay inside the vocabulary and the pool is
    reclaimed."""
    config = mistral.MistralConfig.tiny(vocab=128, hidden=256, layers=2, heads=4, kv_heads=1,
                                        seq=256, window=64)
    params = mistral.init_params(config, torch.Generator().manual_seed(1))
    engine = InferenceEngineV2(mistral, config, params, config={"dtype": "bfloat16"},
                               num_blocks=64, block_size=16, max_blocks_per_seq=16,
                               token_budget=64, max_seqs_per_step=4)
    prompts = [list(range(1, 100)), list(range(3, 40)), [5, 6, 7]]
    before = (paged_attention.launches, paged_attention.tc_launches,
              paged_attention.decode_launches)
    results = engine.generate(prompts, max_new_tokens=5, strict=False)
    wide = sum(k for t, k in engine.chunk_widths.items()
               if paged_module.uses_prefill_tensor_cores(torch.bfloat16, 64, t, 4))
    assert 0 < wide < engine.forward_steps
    assert (paged_attention.launches - before[0], paged_attention.tc_launches - before[1],
            paged_attention.decode_launches - before[2]) == (
        engine.forward_steps * config.num_layers, wide * config.num_layers,
        (engine.forward_steps - wide) * config.num_layers)
    for prompt, res in zip(prompts, results):
        assert res.status == "ok" and res.tokens[:len(prompt)] == prompt
        assert all(0 <= tok < config.vocab_size for tok in res.tokens[len(prompt):])
    assert engine.manager.allocator.free_blocks == 63 and not engine.manager.seqs


# ----------------------------------------------------------- training path
FLASH_BASE = (2, 90, 130, 4, 2)  # B, Sq, Sk, H, KV: GQA, sq < sk, lengths not multiples of a tile
FLASH_SHAPES = {"sq130_gt_sk70": (1, 130, 70, 2, 1),  # causal: the first rows see no key
                "s77": (1, 77, 77, 8, 4), "s200": (2, 200, 200, 2, 2)}
FLASH_GRID = ([(dtype, d, causal, None) for dtype in (torch.float32, torch.bfloat16, torch.float16)
               for d in (64, 128) for causal in (True, False)]
              + [(dtype, d, causal, name) for dtype in (torch.bfloat16, torch.float16)
                 for d in (64, 128) for causal in (True, False) for name in FLASH_SHAPES])


@pytest.mark.parametrize("dtype,D,causal,shape", FLASH_GRID,
                         ids=[f"{str(t)[6:]}-d{d}-{'causal' if c else 'full'}"
                              + (f"-{n}" if n else "") for t, d, c, n in FLASH_GRID])
def test_flash_kernels_match_plain_versions(cuda, dtype, D, causal, shape):
    """fp32 takes the CUDA-core kernels, held at 1e-4.  bf16/fp16 take the
    tensor-core forward, dK/dV and dQ, held to ``flash.tensor_core_limit``
    against the fp32 plain version (dQ with its fp32 floor)."""
    rng = np.random.default_rng(D + int(causal))
    B, Sq, Sk, H, KV = FLASH_SHAPES[shape] if shape else FLASH_BASE
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
                   for shape in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D), (B, Sq, H, D)))
    scale = 1.0 / np.sqrt(D)
    tc = dtype != torch.float32
    fns = (flash.flash_fwd, flash.flash_bwd_dkdv, flash.flash_bwd_dq)
    counts = [fn.launches for fn in fns] + [fn.tc_launches for fn in fns]
    out, lse = flash.flash_fwd(q, k, v, scale, causal)
    ref_out, ref_lse = flash.flash_fwd_reference(q, k, v, scale, causal)
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, ref_lse, delta, scale, causal)
    dk, dv = flash.flash_bwd_dkdv(*args)
    dq = flash.flash_bwd_dq(*args)
    torch.cuda.synchronize()
    assert [fn.launches for fn in fns] + [fn.tc_launches for fn in fns] == [
        n + d for n, d in zip(counts, (1, 1, 1, tc, tc, tc))]
    ref_dq = flash.flash_bwd_dq_reference(*args)
    for got in (out, dk, dv, dq):
        assert got.dtype == dtype
    if tc:
        f = [x.float() for x in (q, k, v, do)]
        fwd32 = flash.flash_fwd_reference(*f[:3], scale, causal)
        fwd_r = flash.flash_fwd_reference(*f[:3], scale, causal, round_to=dtype)
        bwd_args = (*f, ref_lse, delta, scale, causal)
        pairs = ((out, fwd32[0], fwd_r[0], None),
                 *zip((dk, dv), flash.flash_bwd_dkdv_reference(*bwd_args),
                      flash.flash_bwd_dkdv_reference(*bwd_args, round_to=dtype), (None, None)),
                 (dq, flash.flash_bwd_dq_reference(*bwd_args),
                  flash.flash_bwd_dq_reference(*bwd_args, round_to=dtype),
                  flash.dq_fp32_floor(*bwd_args)))
        for (got, ref, rounded, floor), part in zip(pairs, ("out", "dk", "dv", "dq")):
            ok, err, ratio, _ = flash.tensor_core_limit(got, ref, rounded, floor)
            assert ok, f"{part}: max abs err {err:.3e}, {ratio:.3f} of the limit"
    else:
        ref_dk, ref_dv = flash.flash_bwd_dkdv_reference(*args)
        for got, ref in ((out, ref_out), (dk, ref_dk), (dv, ref_dv), (dq, ref_dq)):
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


def test_flash_attention_autograd_on_gpu_matches_cpu(cuda):
    rng = np.random.default_rng(0)
    x = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for s in ((2, 70, 4, 64), (2, 70, 2, 64), (2, 70, 2, 64))]
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.detach().clone().to(dev).requires_grad_(True) for t in x]
        out, lse = flash.flash_attention_with_lse(*leaves, causal=True)
        (out.pow(2).sum() + lse.sin().sum()).backward()
        grads.append([t.grad.cpu() for t in leaves])
    for got, ref in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def test_flash_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    """The wrappers raise on what the kernels do not take, for fp32 (CUDA
    cores) and bf16 (tensor cores) alike, and launch nothing: no fallback to
    the other kernels or the plain versions."""
    counts = (flash.flash_fwd.launches, flash.flash_bwd_dkdv.launches)
    q = torch.zeros((1, 8, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="head_dim 32"):
        flash.flash_fwd(q, q, q, 1.0, True)
    k = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="3 q heads over 2"):
        flash.flash_fwd(torch.zeros((1, 8, 3, 64), device=cuda), k, k, 1.0, True)
    q = torch.zeros((1, 8, 4, 64), device=cuda)
    with pytest.raises(TypeError, match="share one of"):
        flash.flash_fwd(q, k.half(), k, 1.0, True)
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, k, 1.0, True)
    q96 = torch.zeros((1, 8, 2, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 96"):
        flash.flash_fwd(q96, q96, q96, 1.0, True)
    rows = torch.zeros((1, 2, 8), device=cuda)
    with pytest.raises(ValueError, match="head_dim 96"):
        flash.flash_bwd_dkdv(q96, q96, q96, q96, rows, rows, 1.0, True)
    kb = k.bfloat16()
    with pytest.raises(ValueError, match="16-byte"):
        flash.flash_fwd(torch.zeros(8 * 2 * 64 + 1, device=cuda, dtype=torch.bfloat16)[1:]
                        .view(1, 8, 2, 64), kb, kb, 1.0, True)
    assert (flash.flash_fwd.launches, flash.flash_bwd_dkdv.launches) == counts


@pytest.mark.parametrize("n", [1000, 4099])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
def test_fused_adamw_kernel_matches_plain_version(cuda, n, grad_dtype):
    rng = np.random.default_rng(n)
    p, m, g = (torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda) for _ in range(3))
    v = m.abs() * 1e-2
    g = g.to(grad_dtype)
    hyper = dict(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1, step=5)
    kernel = [x.clone() for x in (p, m, v)]
    plain = [x.clone() for x in (p, m, v)]
    before = fused_adamw_flat.launches
    fused_adamw_flat(*kernel, g, **hyper)
    torch.cuda.synchronize()
    assert fused_adamw_flat.launches == before + 1
    fused_adamw_flat_reference(*plain, g, **hyper)
    for got, ref in zip(kernel, plain):
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-6)


def test_train_batch_on_gpu_matches_cpu(cuda):
    cfg = llama.LlamaConfig.tiny(vocab=128, hidden=128, layers=2, heads=2, kv_heads=1, seq=64)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "bf16": {"enabled": False},
            "optimizer": {"type": "fused_adam", "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_max_lr": 1e-3,
                                                         "warmup_num_steps": 4}}}
    engines = {dev: deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg),
                                                   model_parameters=params, config=conf,
                                                   device=dev)[0] for dev in ("cpu", "cuda")}
    batch = llama.causal_lm_batch(np.random.default_rng(1).integers(0, 128, (4, 64)))
    before = (flash.flash_fwd.launches, flash.flash_bwd_dq.launches, fused_adamw_flat.launches)
    lrs = []
    for _ in range(2):
        losses = [float(engines[dev].train_batch(batch).loss) for dev in ("cpu", "cuda")]
        assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[0])
        lrs.append(engines["cuda"].lr)
    n_leaves = len(list(_leaves(params)))
    # 2 steps x gas 2 x 2 layers, the forward twice (remat)
    assert (flash.flash_fwd.launches - before[0], flash.flash_bwd_dq.launches - before[1],
            fused_adamw_flat.launches - before[2]) == (16, 8, 2 * n_leaves)
    for a, b in zip(_leaves(engines["cuda"].state.params), _leaves(engines["cpu"].state.params)):
        assert float((a.cpu() - b).abs().max()) <= 2 * 2e-3


def test_bf16_train_batch_runs_the_tensor_core_kernels(cuda):
    """A bf16 training step through the engine: every flash forward (the
    forward and the remat recompute), dK/dV and dQ launch is a tensor-core
    one; the losses are finite and fall."""
    cfg = llama.LlamaConfig.tiny(vocab=128, hidden=256, layers=2, heads=4, kv_heads=2, seq=128)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "bf16": {"enabled": True},
            "optimizer": {"type": "fused_adam", "params": {"lr": 1e-3}}}
    engine = deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg),
                                            model_parameters=params, config=conf)[0]
    batch = llama.causal_lm_batch(np.random.default_rng(2).integers(0, 128, (4, 128)))
    fns = (flash.flash_fwd, flash.flash_bwd_dkdv, flash.flash_bwd_dq)
    before = [(fn.launches, fn.tc_launches) for fn in fns]
    losses = [float(engine.train_batch(batch).loss) for _ in range(3)]
    after = [(fn.launches, fn.tc_launches) for fn in fns]
    (fwd, fwd_tc), (dkdv, dkdv_tc), (dq, dq_tc) = [
        (a[0] - b[0], a[1] - b[1]) for a, b in zip(after, before)]
    # 3 steps x gas 2 x 2 layers; the forward twice (remat)
    assert (fwd, dkdv, dq) == (24, 12, 12)
    assert (fwd_tc, dkdv_tc, dq_tc) == (fwd, dkdv, dq)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------ block-sparse kernels
# (dtype, head dim, layout, block, S, KV of 4 q heads, causal)
SPARSE_GRID = [
    (torch.float32, 64, "fixed", 8, 100, 2, True),
    (torch.bfloat16, 128, "fixed", 16, 256, 4, True),
    (torch.float32, 128, "fixed", 24, 209, 2, True),
    (torch.float16, 64, "bigbird", 32, 300, 1, False),
    (torch.float32, 64, "bslongformer", 40, 200, 4, False),
    (torch.bfloat16, 64, "fixed", 64, 500, 2, True),
    (torch.float32, 128, "variable", 128, 300, 2, True),
]


@pytest.mark.parametrize("dtype,D,mode,block,S,KV,causal", SPARSE_GRID,
                         ids=[f"{str(g[0])[6:]}-d{g[1]}-{g[2]}-b{g[3]}-s{g[4]}" for g in SPARSE_GRID])
def test_sparse_kernels_match_plain_versions(cuda, dtype, D, mode, block, S, KV, causal):
    """fp32 takes the CUDA-core kernels, held at 1e-4.  bf16/fp16 take the
    tensor-core forward, dK/dV and dQ, held to ``flash.tensor_core_limit`` row
    by row against the fp32 plain version (``rounded``: the plain versions
    with ``round_to=``; dQ with ``sparse_dq_fp32_floor``); lse at 1e-4."""
    rng = np.random.default_rng(block + S)
    H, B = 4, 2
    section = SparseAttentionConfig(mode=mode, block=block, different_layout_per_head=True,
                                    num_local_blocks=2, num_random_blocks=1,
                                    attention="unidirectional" if causal else "bidirectional")
    layout = section.build(H).make_layout(-(-S // block) * block)
    tables = sparse._get_tables(layout, H, block, KV)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
                   for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))
    scale = 1.0 / np.sqrt(D)
    tc = dtype != torch.float32
    fns = (sparse.sparse_fwd, sparse.sparse_bwd_dkdv, sparse.sparse_bwd_dq)
    counts = [fn.launches for fn in fns] + [fn.tc_launches for fn in fns]
    out, lse = sparse.sparse_fwd(q, k, v, tables, scale, causal)
    ref_out, ref_lse = sparse.sparse_fwd_reference(q, k, v, tables, scale, causal)
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, ref_lse, delta, tables, scale, causal)
    dk, dv = sparse.sparse_bwd_dkdv(*args)
    dq = sparse.sparse_bwd_dq(*args)
    torch.cuda.synchronize()
    assert [fn.launches for fn in fns] + [fn.tc_launches for fn in fns] == [
        n + d for n, d in zip(counts, (1, 1, 1, tc, tc, tc))]
    for got in (out, dk, dv, dq):
        assert got.dtype == dtype
    if tc:
        f = [x.float() for x in (q, k, v, do)]
        bwd_args = (*f, ref_lse, delta, tables, scale, causal)
        out32 = sparse.sparse_fwd_reference(*f[:3], tables, scale, causal)[0]
        out_r = sparse.sparse_fwd_reference(*f[:3], tables, scale, causal, round_to=dtype)[0]
        pairs = ((out, out32, out_r, None),
                 *zip((dk, dv), sparse.sparse_bwd_dkdv_reference(*bwd_args),
                      sparse.sparse_bwd_dkdv_reference(*bwd_args, round_to=dtype), (None, None)),
                 (dq, sparse.sparse_bwd_dq_reference(*bwd_args),
                  sparse.sparse_bwd_dq_reference(*bwd_args, round_to=dtype),
                  sparse.sparse_dq_fp32_floor(*bwd_args)))
        for (got, ref, rounded, floor), part in zip(pairs, ("out", "dk", "dv", "dq")):
            ok, err, ratio, _ = flash.tensor_core_limit(got, ref, rounded, floor)
            assert ok, f"{part}: max abs err {err:.3e}, {ratio:.3f} of the limit"
    else:
        ref_dk, ref_dv = sparse.sparse_bwd_dkdv_reference(*args)
        for got, ref in ((out, ref_out), (dk, ref_dk), (dv, ref_dv),
                         (dq, sparse.sparse_bwd_dq_reference(*args))):
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


def test_sparse_attention_autograd_on_gpu_matches_cpu(cuda):
    section = SparseAttentionConfig(mode="fixed", block=16, num_local_blocks=2,
                                    attention="unidirectional")
    fn = sparse.make_config_attention_fn(section)
    rng = np.random.default_rng(1)
    x = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for s in ((2, 96, 4, 64), (2, 96, 2, 64), (2, 96, 2, 64))]
    grads, before = [], sparse.sparse_bwd_dq.launches
    for dev in ("cpu", cuda):
        leaves = [t.detach().clone().to(dev).requires_grad_(True) for t in x]
        fn(*leaves, causal=True).pow(2).sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
    assert sparse.sparse_bwd_dq.launches == before + 1
    for got, ref in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def test_sparse_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    layout = SparseAttentionConfig(block=16).build(2).make_layout(32)
    q = torch.zeros((1, 32, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim 48"):
        sparse.sparse_fwd(q, q, q, sparse._get_tables(layout, 2, 16, 2), 1.0, True)
    q = torch.zeros((1, 32, 2, 64), device=cuda)
    layout4 = SparseAttentionConfig(block=16).build(4).make_layout(32)
    with pytest.raises(ValueError, match="tables for 4 q"):
        sparse.sparse_fwd(q, q, q, sparse._get_tables(layout4, 4, 16, 4), 1.0, True)
    with pytest.raises(TypeError, match="share one of"):
        sparse.sparse_fwd(q, q.half(), q, sparse._get_tables(layout, 2, 16, 2), 1.0, True)


# ------------------------------------------------------------ AdamW-8bit
@pytest.mark.parametrize("n", [1000, 2048, 4099])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
def test_adamw8bit_kernel_matches_plain_version(cuda, n, grad_dtype):
    """The int8 codes equal the plain version's bit for bit; p and the scales
    at rtol 1e-6 plus 1e-6 of their largest value."""
    rng = np.random.default_rng(n)
    groups = -(-n // adam8bit.GROUP)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    state = [t((rng.normal(size=n) * 0.02).astype(np.float32)),
             t(rng.integers(-127, 128, (groups, 1024)).astype(np.int8)),
             t(rng.integers(0, 128, (groups, 1024)).astype(np.int8)),
             t((rng.random((groups, 1)) * 1e-3 / 127).astype(np.float32)),
             t((rng.random((groups, 1)) * 1e-3 / 127).astype(np.float32))]
    g = t((rng.normal(size=n) * 1e-3).astype(np.float32)).to(grad_dtype)
    hyper = dict(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1, step=5)
    kernel = [x.clone() for x in state]
    plain = [x.clone() for x in state]
    before = adam8bit.fused_adamw8bit_flat.launches
    adam8bit.fused_adamw8bit_flat(*kernel, g, **hyper)
    torch.cuda.synchronize()
    assert adam8bit.fused_adamw8bit_flat.launches == before + 1
    adam8bit.fused_adamw8bit_flat_reference(*plain, g, **hyper)
    assert torch.equal(kernel[1], plain[1]) and torch.equal(kernel[2], plain[2])
    for i in (0, 3, 4):
        top = float(plain[i].abs().max())
        torch.testing.assert_close(kernel[i], plain[i], atol=1e-6 * top, rtol=1e-6)


def test_sparse_adam8bit_train_batch_on_gpu_matches_cpu(cuda):
    """``initialize`` with the sparse_attention section and fused_adam8bit:
    the GPU engine launches the sparse and AdamW-8bit kernels (and no flash
    kernel) and agrees with the CPU engine."""
    cfg = llama.LlamaConfig.tiny(vocab=128, hidden=128, layers=2, heads=2, kv_heads=1, seq=64)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "bf16": {"enabled": False},
            "optimizer": {"type": "fused_adam8bit", "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "sparse_attention": {"mode": "fixed", "block": 16, "num_local_blocks": 2,
                                 "attention": "unidirectional"}}
    engines = {dev: deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg),
                                                   model_parameters=params, config=conf,
                                                   device=dev)[0] for dev in ("cpu", "cuda")}
    batch = llama.causal_lm_batch(np.random.default_rng(1).integers(0, 128, (4, 64)))
    before = (flash.flash_fwd.launches, sparse.sparse_fwd.launches, sparse.sparse_bwd_dq.launches,
              adam8bit.fused_adamw8bit_flat.launches)
    for _ in range(2):
        losses = [float(engines[dev].train_batch(batch).loss) for dev in ("cpu", "cuda")]
        assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[0])
    n_leaves = len(list(_leaves(params)))
    after = (flash.flash_fwd.launches, sparse.sparse_fwd.launches, sparse.sparse_bwd_dq.launches,
             adam8bit.fused_adamw8bit_flat.launches)
    # 2 steps x gas 2 x 2 layers, the forward twice (remat); no flash launch
    assert tuple(a - b for a, b in zip(after, before)) == (0, 16, 8, 2 * n_leaves)
    for a, b in zip(_leaves(engines["cuda"].state.params), _leaves(engines["cpu"].state.params)):
        assert float((a.cpu() - b).abs().max()) <= 2 * 2e-3


# ------------------------------------------------------------ int8 quantize
@pytest.mark.parametrize("n,group,dtype", [
    (100_003, 64, torch.bfloat16), (100_003, 2048, torch.bfloat16), (10_001, 100, torch.bfloat16),
    (50_000, 2048, torch.float32), (50_000, 256, torch.float16), (77, 2048, torch.float32),
    (100_000, 16384, torch.bfloat16), (1000, 5, torch.float32)])
def test_quantize_int8_kernel_matches_plain_version(cuda, n, group, dtype):
    """Codes and scales equal the plain version's bit for bit: every group
    size (16-byte chunks or single elements, cached in registers or read
    twice), tail groups and an all-zero group."""
    x = torch.from_numpy((np.random.default_rng(n).normal(size=n) * 3).astype(np.float32))
    x[:min(n, 2 * group)][group:] = 0.0  # the second group, where there is one, is all zero
    x = x.to(device=cuda, dtype=dtype)
    before = quantize.quantize_int8.launches
    codes, scales, got_n = quantize.quantize_int8(x, group)
    torch.cuda.synchronize()
    assert quantize.quantize_int8.launches == before + 1 and got_n == n
    ref_codes, ref_scales, _ = quantize.quantize_int8_reference(x, group)
    assert torch.equal(codes, ref_codes) and torch.equal(scales, ref_scales)


def test_quantize_int8_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(256, device=cuda)
    with pytest.raises(TypeError, match="must be one of"):
        quantize.quantize_int8(x.int(), 128)
    with pytest.raises(ValueError, match="contiguous"):
        quantize.quantize_int8(x.view(16, 16).T, 128)


# ------------------------------------------------------------------- Lion
@pytest.mark.parametrize("n", [1000, 4099])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
def test_fused_lion_kernel_matches_plain_version(cuda, n, grad_dtype):
    """p and m equal the plain version's bit for bit (sign(0) = 0 included)."""
    rng = np.random.default_rng(n)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    p, m = t((rng.normal(size=n) * 0.02).astype(np.float32)), t(
        (rng.normal(size=n) * 1e-3).astype(np.float32))
    g = t((rng.normal(size=n) * 1e-3).astype(np.float32)).to(grad_dtype)
    m[:5] = 0.0
    g[:5] = 0.0
    hyper = dict(lr=1e-4, beta1=0.9, beta2=0.99, weight_decay=0.1)
    kernel, plain = [p.clone(), m.clone()], [p.clone(), m.clone()]
    before = fused_lion_flat.launches
    fused_lion_flat(*kernel, g, **hyper)
    torch.cuda.synchronize()
    assert fused_lion_flat.launches == before + 1
    fused_lion_flat_reference(*plain, g, **hyper)
    assert torch.equal(kernel[0], plain[0]) and torch.equal(kernel[1], plain[1])


def test_fused_lion_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    p = torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="all lie on CUDA or all on the CPU"):
        fused_lion_flat(p, p.clone(), torch.zeros(64), lr=1e-3)
    with pytest.raises(TypeError, match="grad must be one of"):
        fused_lion_flat(p, p.clone(), p.half(), lr=1e-3)
    with pytest.raises(ValueError, match="flat"):
        fused_lion_flat(p.view(8, 8), p.clone().view(8, 8), p.view(8, 8), lr=1e-3)


# -------------------------------------------------------------- v1 engine
@pytest.mark.parametrize("quant", [None, {"enabled": True, "bits": 8, "group_size": 128}])
def test_v1_engine_on_gpu_matches_engine_on_cpu(cuda, quant):
    """``init_inference`` on the GPU (the quantize kernel packs the weights)
    against the same engine on the CPU: codes equal, logits close, greedy
    tokens identical."""
    cfg = llama.LlamaConfig.tiny(vocab=128, hidden=128, layers=2, heads=4, kv_heads=2, seq=64)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    conf = {"dtype": "float32", "max_seq_len": 64}
    if quant:
        conf["quant"] = quant
    before = quantize.quantize_int8.launches
    engines = {dev: deepspeed_tpu_torch.init_inference(model_module=llama, model_config=cfg,
                                                       params=params, config=conf, device=dev)
               for dev in ("cpu", "cuda")}
    pairs = [(a, b) for a, b in zip(_leaves(engines["cuda"].params), _leaves(engines["cpu"].params))
             if woq.is_woq_leaf(a)]
    assert quantize.quantize_int8.launches - before == len(pairs) == (9 if quant else 0)
    for a, b in pairs:
        assert torch.equal(a.q.cpu(), b.q) and torch.equal(a.s.cpu(), b.s)
    ids = np.random.default_rng(2).integers(0, 128, (2, 12))
    got, ref = (engines[dev].forward(ids).cpu() for dev in ("cuda", "cpu"))
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(engines["cuda"].generate(ids, max_new_tokens=6, temperature=0.0),
                                  engines["cpu"].generate(ids, max_new_tokens=6, temperature=0.0))

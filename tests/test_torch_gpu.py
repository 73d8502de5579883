"""The port's CUDA path on an NVIDIA GPU: the paged-attention, flash,
fused-AdamW, block-sparse, AdamW-8bit, int8-quantize and fused-Lion kernels
against their plain PyTorch versions on the same CUDA tensors, the v2
engine's CUDA graphs (replay against the eager forward, captures that write
only the trash block, pipelined replays, launch counts under replay, sampled
burst against steps), the copy-on-write block copy and a shared-prefix
serve with graphs (shared blocks never written, tokens equal to the eager
loop's), request tracing on the graph path, and tiny
serving engines (v2; v1 dense and weight-only int8) and tiny training engines
(dense with fused AdamW; block-sparse with 8-bit AdamW) on the GPU against the
same engines on the CPU; BLOOM's paged forward (ALiBi on the kernel's slopes
operand), GPT-2's, BERT's, Phi's (head dim 80) and GPT-J's (256) forward
and grads, and BERT's non-causal flash attention; the remat policies
(host-offloaded inputs, every selective policy bit for bit the default's),
random-LTD through the flash kernels against the plain attention, and the
flash and sparse Functions refusing a second derivative; the CUDA accelerator, the
environment report, the autotuner's runner pruning an out-of-memory point, the
elastic agent restarting a worker on the card, and the collective microbench's
CLI under the per-node launcher at one rank (NCCL).  Every test here needs a card and
skips without one.  This file imports no JAX, so it runs on a machine that
has only PyTorch: ``python -m pytest --noconftest tests/test_torch_gpu.py``
(the suite's conftest imports JAX)."""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, build_engine
from deepspeed_tpu_torch.models import (bert, bloom, falcon, gpt2, gptj, llama, mistral, mixtral,
                                        opt, phi, qwen)
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
# takes the split-K decode kernel, T >= 16 with bf16/fp16 the tensor-core
# prefill kernel (every head dim and group), fp32 at T >= 16 the CUDA-core
# kernel
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
    ("tc_d256_t16_bf16", torch.bfloat16, 8, 2, 256, 16, 16, [40, 300], [16, 9], None, False),
    # the tensor-core prefill kernel's other widths: a group of 128 (a
    # token's heads over two row blocks), head dim 32 with ALiBi and a window
    ("tc_mqa128_t16_bf16", torch.bfloat16, 128, 1, 64, 16, 16, [100, 16, 0], [16, 7, 0], None,
     False),
    ("tc_d32_t20_alibi_window_fp16", torch.float16, 4, 4, 32, 8, 20, [20, 57, 300],
     [20, 11, 1], 30, True),
    # fp32 chunks of T >= 16 take the CUDA-core kernel: the fp32 slice's
    # Mistral-width prefill (T = 128) and a head dim 32 chunk with ALiBi
    ("cuda_core_gqa4_t128_window_fp32", torch.float32, 32, 8, 128, 16, 128, [70, 33],
     [70, 33], 4096, False),
    ("cuda_core_d32_t20_alibi_fp32", torch.float32, 4, 4, 32, 8, 20, [20, 57, 0],
     [20, 11, 0], 30, True),
    # speculative verify rounds of Mistral-7B shape on the split-K decode
    # route: T = k + 1 rows a sequence, each seeing keys up to its own
    # position; the row blocks change at 4 and 8 rows a kv group, 5 and 9
    # are the first odd counts; a short row merges its tail to zeros
    ("verify_t4_gqa4_bf16", torch.bfloat16, 32, 8, 128, 16, 4, [1024, 1000, 1040, 0],
     [4, 4, 2, 0], 4096, False),
    ("verify_t5_gqa4_bf16", torch.bfloat16, 32, 8, 128, 16, 5, [1024, 1001, 1037, 6],
     [5, 5, 3, 5], 4096, False),
    ("verify_t8_gqa4_bf16", torch.bfloat16, 32, 8, 128, 16, 8, [1024, 1003, 1050, 8],
     [8, 8, 1, 8], 4096, False),
    ("verify_t9_gqa4_bf16", torch.bfloat16, 32, 8, 128, 16, 9, [1024, 1009, 1049, 0],
     [9, 9, 4, 0], 4096, False),
    ("verify_t5_gqa4_fp32", torch.float32, 32, 8, 128, 16, 5, [1024, 1001, 1037, 6],
     [5, 5, 3, 5], 4096, False),
    # Qwen2-7B's heads: a GQA group of 7 (28 over 4), head dim 128. A decode
    # row block of 8 cuts a token's 7 heads; a tensor-core block packs 9
    # tokens x 7 heads = 63 rows, so a warp's 16 rows straddle tokens
    ("qwen2_decode_group7_bf16", torch.bfloat16, 28, 4, 128, 16, 1, [1, 700, 1024, 0],
     [1, 1, 1, 0], None, False),
    ("qwen2_verify_t5_group7_bf16", torch.bfloat16, 28, 4, 128, 16, 5, [1024, 1001, 37, 5],
     [5, 5, 3, 5], None, False),
    ("tc_qwen2_group7_t64_bf16", torch.bfloat16, 28, 4, 128, 16, 64, [64, 500, 77],
     [64, 64, 13], None, False),
    ("qwen2_decode_group7_fp32", torch.float32, 28, 4, 128, 16, 1, [1, 700, 1024, 0],
     [1, 1, 1, 0], None, False),
    ("cuda_core_qwen2_group7_t32_fp32", torch.float32, 28, 4, 128, 16, 32, [32, 300],
     [32, 9], None, False),
    # GPT-J-6B's heads: 16 over 16, head dim 256 (bf16 prefill on tensor cores,
    # 32-key tiles; fp32 on the CUDA-core kernel), and its 512-token prefill
    ("gptj_decode_mha_d256_bf16", torch.bfloat16, 16, 16, 256, 16, 1, [1, 900, 2048],
     [1, 1, 1], None, False),
    ("tc_gptj_mha_d256_t32_bf16", torch.bfloat16, 16, 16, 256, 16, 32, [32, 300],
     [32, 9], None, False),
    ("tc_gptj_prefill_t512_bf16", torch.bfloat16, 16, 16, 256, 16, 512, [2048, 700],
     [512, 300], None, False),
    ("gptj_decode_mha_d256_fp32", torch.float32, 16, 16, 256, 16, 1, [1, 900, 2048],
     [1, 1, 1], None, False),
    ("cuda_core_gptj_mha_d256_t32_fp32", torch.float32, 16, 16, 256, 16, 32, [32, 300],
     [32, 9], None, False),
    # OPT-125m's heads: 12 over 12, head dim 64, both bf16 routes
    ("opt_decode_mha_d64_bf16", torch.bfloat16, 12, 12, 64, 16, 1, [1, 900, 1024, 0],
     [1, 1, 1, 0], None, False),
    ("tc_opt_mha_d64_t64_bf16", torch.bfloat16, 12, 12, 64, 16, 64, [64, 500, 77],
     [64, 64, 13], None, False),
    # Phi-2's heads: 32 over 32 at head dim 80 (the decode kernel's column
    # pairs, its 32-key fp32 tiles; the tensor-core kernel's 5 k-steps; the
    # CUDA-core kernel's masked third column a lane), on every route and dtype
    ("phi_decode_d80_bf16", torch.bfloat16, 32, 32, 80, 16, 1, [1, 900, 2048, 0],
     [1, 1, 1, 0], None, False),
    ("phi_verify_t5_d80_alibi_window_fp16", torch.float16, 32, 32, 80, 16, 5,
     [1024, 1001, 37, 5], [5, 5, 3, 5], 500, True),
    ("phi_decode_d80_split_edges_fp32", torch.float32, 32, 32, 80, 16, 1,
     [4096, 1, 768, 769, 0], [1, 1, 1, 1, 0], None, False),
    ("tc_phi_d80_t64_bf16", torch.bfloat16, 32, 32, 80, 16, 64, [64, 500, 77], [64, 64, 13],
     None, False),
    ("tc_d80_gqa4_t20_alibi_window_fp16", torch.float16, 8, 2, 80, 8, 20, [20, 57, 300],
     [20, 11, 1], 30, True),
    ("cuda_core_phi_d80_t32_fp32", torch.float32, 32, 32, 80, 16, 32, [32, 300], [32, 9],
     None, False),
    ("cuda_core_d80_t20_alibi_window_fp32", torch.float32, 4, 4, 80, 8, 20, [20, 57, 0],
     [20, 11, 0], 30, True),
    # Falcon-7B's heads: 71 q heads over 1 kv head at head dim 64 (9 decode
    # row blocks a token; a token's heads across tensor-core and CUDA-core
    # row blocks), on every route and dtype
    ("falcon_decode_mqa71_bf16", torch.bfloat16, 71, 1, 64, 16, 1, [1, 900, 2048, 0],
     [1, 1, 1, 0], None, False),
    ("falcon_verify_t5_mqa71_alibi_window_fp16", torch.float16, 71, 1, 64, 16, 5,
     [1024, 1001, 37, 5], [5, 5, 3, 5], 400, True),
    ("falcon_decode_mqa71_fp32", torch.float32, 71, 1, 64, 16, 1, [4096, 1, 769, 0],
     [1, 1, 1, 0], None, False),
    ("tc_falcon_mqa71_t64_bf16", torch.bfloat16, 71, 1, 64, 16, 64, [64, 500, 77],
     [64, 64, 13], None, False),
    ("tc_mqa71_t20_alibi_window_fp16", torch.float16, 71, 1, 64, 8, 20, [20, 57, 300],
     [20, 11, 1], 30, True),
    ("cuda_core_falcon_mqa71_t32_fp32", torch.float32, 71, 1, 64, 16, 32, [32, 300], [32, 9],
     None, False),
    ("cuda_core_mqa71_t20_alibi_window_fp32", torch.float32, 71, 1, 64, 8, 20, [20, 57, 0],
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
    route = paged_module.paged_route(dtype, T)
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


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, monkeypatch):
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
    # the CUDA-core kernel is built for fp32 only: its C entry refuses bf16
    # and fp16 (the wrapper sends those to the tensor-core kernel)
    xb = _case(0, torch.bfloat16, 4, 2, 64, 8, 16, [20, 9], [16, 9], False, cuda)
    out = torch.empty_like(xb["q"])
    for code in (1, 2):
        rc = paged_module._lib().paged_attention_launch(
            code, xb["q"].data_ptr(), xb["kpool"].data_ptr(), xb["vpool"].data_ptr(),
            xb["tables"].data_ptr(), xb["lengths"].data_ptr(), xb["start_pos"].data_ptr(),
            xb["n_tokens"].data_ptr(), None, out.data_ptr(), 2, 16, 4, 2, 64, 8,
            xb["tables"].shape[1], 0.125, 0, torch.cuda.current_stream().cuda_stream)
        assert rc != 0
    # the tensor-core route checks its own shared memory against the limit
    assert paged_module._lib().paged_prefill_tc_smem_bytes(256) == 101376
    monkeypatch.setattr(paged_module, "_SMEM_LIMIT",
                        paged_module._lib().paged_prefill_tc_smem_bytes(64) - 1)
    with pytest.raises(ValueError, match="prefill_tc"):
        paged_attention(xb["q"], xb["kpool"], xb["vpool"], xb["tables"], xb["lengths"],
                        xb["start_pos"], xb["n_tokens"], block_size=8)


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
    narrow = sum(k for t, k in engine.chunk_widths.items()
                 if paged_module.paged_route(torch.float32, t) == "decode")
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
               if paged_module.uses_prefill_tensor_cores(torch.bfloat16, t))
    assert 0 < wide < engine.forward_steps
    assert (paged_attention.launches - before[0], paged_attention.tc_launches - before[1],
            paged_attention.decode_launches - before[2]) == (
        engine.forward_steps * config.num_layers, wide * config.num_layers,
        (engine.forward_steps - wide) * config.num_layers)
    for prompt, res in zip(prompts, results):
        assert res.status == "ok" and res.tokens[:len(prompt)] == prompt
        assert all(0 <= tok < config.vocab_size for tok in res.tokens[len(prompt):])
    assert engine.manager.allocator.free_blocks == 63 and not engine.manager.seqs


# the served families at kernel head dims (the JAX tiny configs have 16):
# Qwen2 with a GQA group of 7, Mixtral's dense MoE FFN, OPT at 64, GPT-J at 256
FAMILIES = {
    "qwen2": qwen.QwenConfig.tiny(vocab=128, hidden=448, layers=2, heads=14, kv_heads=2, seq=256),
    "mixtral": mixtral.MixtralConfig.tiny(vocab=128, hidden=128, layers=2, heads=4, kv_heads=2,
                                          seq=256),
    "opt": opt.OPTConfig.tiny(vocab=128, hidden=128, layers=2, heads=2, seq=256),
    "gptj": gptj.GPTJConfig(vocab_size=128, hidden_size=512, ffn_dim=1024, num_layers=2,
                            num_heads=2, rotary_dim=64, max_seq_len=256),
    # head dim 80 (32 of it rotated); 71 q heads over one kv head at head dim 32
    "phi": phi.PhiConfig(vocab_size=128, hidden_size=320, ffn_dim=1280, num_layers=2,
                         num_heads=4, max_seq_len=256),
    "falcon": falcon.FalconConfig(vocab_size=128, hidden_size=71 * 32, num_layers=2,
                                  num_heads=71, num_kv_heads=1, max_seq_len=256),
}


@pytest.mark.parametrize("key", sorted(FAMILIES))
def test_family_graphs_match_the_eager_reference_loop(cuda, key):
    """Each served family in fp32 at 2 layers: the fast path with CUDA
    graphs (``build_engine``'s default on the card) and the eager reference
    loop give the same greedy tokens, with every forward step's paged
    launches on the route the shape rule names."""
    from deepspeed_tpu_torch.inference.v2.engine_factory import REGISTRY
    module, cfg = REGISTRY[key], FAMILIES[key]
    params = module.init_params(cfg, torch.Generator().manual_seed(0))
    if key in ("qwen2", "phi"):  # the q/k/v biases start at zero: give them something to add
        gen = torch.Generator().manual_seed(1)
        biases = params["layers"]["attn"] if key == "qwen2" else params["layers"]
        for name in ("bq", "bk", "bv"):
            biases[name].normal_(0.0, 0.1, generator=gen)
    kw = dict(num_blocks=64, block_size=16, max_blocks_per_seq=8, token_budget=32,
              max_seqs_per_step=4)
    graphs = build_engine(key, cfg, params, config={"dtype": "float32"}, **kw)
    eager = build_engine(key, cfg, params, **kw, config={"dtype": "float32",
                                                          "serving_fastpath": {"enabled": False}})
    assert graphs.programs.graphs and not eager.programs.graphs
    ref = eager.generate(GRAPH_PROMPTS, max_new_tokens=6)
    before = (paged_attention.launches, paged_attention.decode_launches)
    got = graphs.generate(GRAPH_PROMPTS, max_new_tokens=6)
    assert got == ref
    narrow = sum(k for t, k in graphs.chunk_widths.items()
                 if paged_module.paged_route(torch.float32, t) == "decode")
    assert (paged_attention.launches - before[0], paged_attention.decode_launches - before[1]) \
        == (graphs.forward_steps * cfg.num_layers, narrow * cfg.num_layers)


# ----------------------------------------------------------- training path
FLASH_BASE = (2, 90, 130, 4, 2)  # B, Sq, Sk, H, KV: GQA, sq < sk, lengths not multiples of a tile
FLASH_SHAPES = {"sq130_gt_sk70": (1, 130, 70, 2, 1),  # causal: the first rows see no key
                "s77": (1, 77, 77, 8, 4), "s200": (2, 200, 200, 2, 2)}
FLASH_GRID = ([(dtype, d, causal, None) for dtype in (torch.float32, torch.bfloat16, torch.float16)
               for d in flash._HEAD_DIMS for causal in (True, False)]
              + [(dtype, d, causal, name) for dtype in (torch.bfloat16, torch.float16)
                 for d in flash._HEAD_DIMS for causal in (True, False) for name in FLASH_SHAPES])


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_bloom_forward_paged_on_gpu_matches_the_plain_version(cuda, dtype, monkeypatch):
    """BLOOM's ``forward_paged`` (head dim 128, ALiBi with BLOOM's slopes)
    over a prefill chunk of 40 and 25 tokens and two decode steps: every
    paged call checked against the plain version on the same inputs (fp32
    at 1e-4; bf16 at ``flash.tensor_core_limit``, P rounded for the
    tensor-core prefill), every route of the dtype taken, and in fp32 the
    logits within 1e-4 of the same forward through the plain version."""
    cfg = bloom.BloomConfig.tiny(vocab=128, hidden=512, layers=2, heads=4, seq=256)
    params = bloom.init_params(cfg, torch.Generator().manual_seed(0))
    params["layers"]["b_qkv"].normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
    params = _to(params, cuda, dtype)
    routes = []

    def checked(q, kpool, vpool, tables, lengths, start_pos, n_tokens, *, block_size,
                softmax_scale, window=None, alibi_slopes=None):
        got = paged_attention(q, kpool, vpool, tables, lengths, start_pos, n_tokens,
                              block_size=block_size, softmax_scale=softmax_scale,
                              alibi_slopes=alibi_slopes)
        route = paged_module.paged_route(q.dtype, q.shape[1])
        routes.append(route)
        f32 = [x.float() for x in (q, kpool, vpool)]
        ints = (tables, lengths, start_pos, n_tokens, softmax_scale, window, alibi_slopes)
        ref = paged_attention_reference(*f32, *ints)
        if q.dtype == torch.float32:
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
        else:
            rounded = paged_attention_reference(
                *f32, *ints, round_to=q.dtype if route == "prefill_tc" else None)
            ok, err, ratio, _ = flash.tensor_core_limit(got, ref, rounded)
            assert ok, f"{route}: max abs err {err:.3e}, {ratio:.3f} of the limit"
        return got

    def plain(q, kpool, vpool, tables, lengths, start_pos, n_tokens, *, block_size,
              softmax_scale, window=None, alibi_slopes=None):
        return paged_attention_reference(q, kpool, vpool, tables, lengths, start_pos, n_tokens,
                                         softmax_scale, window, alibi_slopes)

    outs = {}
    for name, fn in (("kernel", checked), ("plain", plain)):
        monkeypatch.setattr(bloom, "paged_attention", fn)
        kv = bloom.init_paged_cache(cfg, 16, 16, dtype=dtype, device=cuda)
        tables = torch.tensor([[3, 9, 1, 12], [5, 2, 15, 15]], dtype=torch.int32, device=cuda)
        tokens = torch.zeros((2, 40), dtype=torch.int32, device=cuda)
        tokens[0] = torch.arange(40) % 128
        tokens[1, :25] = (torch.arange(25) * 7) % 128
        n_tokens = torch.tensor([40, 25], dtype=torch.int32, device=cuda)
        start = torch.zeros(2, dtype=torch.int32, device=cuda)
        logits = []
        for _ in range(3):
            out, kv = bloom.forward_paged(cfg, params, tokens, n_tokens, start, tables, kv,
                                          block_size=16)
            logits.append(out.float())
            start = start + n_tokens
            tokens = torch.tensor([[17], [33]], dtype=torch.int32, device=cuda)
            n_tokens = torch.ones(2, dtype=torch.int32, device=cuda)
        outs[name] = logits
    wide = "cuda_core" if dtype == torch.float32 else "prefill_tc"
    assert routes == [wide] * 2 + ["decode"] * 4
    if dtype == torch.float32:
        live = [torch.arange(40, device=cuda)[None, :] < torch.tensor([40, 25], device=cuda)[:, None],
                slice(None), slice(None)]
        for got, ref, keep in zip(outs["kernel"], outs["plain"], live):
            torch.testing.assert_close(got[keep], ref[keep], atol=1e-4, rtol=1e-4)


def _to(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)


@pytest.mark.parametrize("key", ["gpt2", "bert"])
def test_gpt2_and_bert_forward_and_grads_on_gpu_match_cpu(cuda, key):
    """fp32, head dim 64: the flash kernels (causal for GPT-2, non-causal
    for BERT; the forward, the remat recompute and both backward kernels a
    layer) against the CPU's plain attention, logits and every grad at
    1e-4."""
    module, config = {"gpt2": (gpt2, gpt2.GPT2Config), "bert": (bert, bert.BertConfig)}[key]
    cfg = config.tiny(vocab=128, hidden=128, layers=2, heads=2, seq=64)
    params = module.init_params(cfg, torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 128, (2, 64)))
    labels = torch.roll(ids, -1, 1)
    results = []
    before = [fn.launches for fn in (flash.flash_fwd, flash.flash_bwd_dkdv, flash.flash_bwd_dq)]
    for dev in ("cpu", cuda):
        p = _to(params, dev, torch.float32)
        leaves = list(_leaves(p))
        for leaf in leaves:
            leaf.requires_grad_(True)
        logits = module.forward(cfg, p, ids.to(dev))
        loss = torch.nn.functional.cross_entropy(logits.flatten(0, 1), labels.to(dev).flatten())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        results.append((logits.detach().cpu(), [g.cpu() for g in grads]))
    after = [fn.launches for fn in (flash.flash_fwd, flash.flash_bwd_dkdv, flash.flash_bwd_dq)]
    assert [a - b for a, b in zip(after, before)] == [4, 2, 2]
    torch.testing.assert_close(results[1][0], results[0][0], atol=1e-4, rtol=1e-4)
    for got, ref in zip(results[1][1], results[0][1]):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("key", ["phi", "gptj"])
def test_phi_and_gptj_forward_and_grads_on_gpu_match_cpu(cuda, key):
    """fp32 at Phi-2's head dim 80 (partial rotary 32) and GPT-J-6B's 256
    (rotary 64), 2 narrow layers: the flash kernels (the forward, the remat
    recompute and both backward kernels a layer) against the CPU's plain
    attention, logits and every grad at 1e-4."""
    import dataclasses
    if key == "phi":
        module = phi
        cfg = dataclasses.replace(phi.PhiConfig.tiny(vocab=128, hidden=160, heads=2),
                                  partial_rotary_factor=0.4)
    else:
        module = gptj
        cfg = gptj.GPTJConfig.tiny(vocab=128, hidden=512, heads=2, rotary_dim=64)
    params = module.init_params(cfg, torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 128, (2, 64)))
    labels = torch.roll(ids, -1, 1)
    results = []
    before = [fn.launches for fn in (flash.flash_fwd, flash.flash_bwd_dkdv, flash.flash_bwd_dq)]
    for dev in ("cpu", cuda):
        p = _to(params, dev, torch.float32)
        leaves = list(_leaves(p))
        for leaf in leaves:
            leaf.requires_grad_(True)
        logits = module.forward(cfg, p, ids.to(dev))
        loss = torch.nn.functional.cross_entropy(logits.flatten(0, 1), labels.to(dev).flatten())
        grads = torch.autograd.grad(loss, leaves)
        results.append((logits.detach().cpu(), [g.cpu() for g in grads]))
    after = [fn.launches for fn in (flash.flash_fwd, flash.flash_bwd_dkdv, flash.flash_bwd_dq)]
    assert [a - b for a, b in zip(after, before)] == [4, 2, 2]
    torch.testing.assert_close(results[1][0], results[0][0], atol=1e-4, rtol=1e-4)
    for got, ref in zip(results[1][1], results[0][1]):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def test_bert_noncausal_flash_is_held_to_the_rounding_limit(cuda):
    """BERT-base's attention (12 heads, head dim 64, 512 keys, no mask) in
    bf16 on the tensor-core forward, against ``flash_fwd_reference`` on fp32
    copies at ``flash.tensor_core_limit`` with P rounded to bf16; lse at
    1e-4."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 512, 12, 64)).astype(np.float32))
               .to(cuda, torch.bfloat16) for _ in range(3))
    scale = 1.0 / np.sqrt(64)
    before = flash.flash_fwd.tc_launches
    out, lse = flash.flash_fwd(q, k, v, scale, False)
    assert flash.flash_fwd.tc_launches == before + 1
    f = [x.float() for x in (q, k, v)]
    ref, ref_lse = flash.flash_fwd_reference(*f, scale, False)
    rounded, _ = flash.flash_fwd_reference(*f, scale, False, round_to=torch.bfloat16)
    ok, err, ratio, _ = flash.tensor_core_limit(out, ref, rounded)
    assert ok, f"max abs err {err:.3e}, {ratio:.3f} of the limit"
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


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


# ------------------------------------------------ v2 fast path: CUDA graphs
GRAPH_CONFIG = mistral.MistralConfig.tiny(vocab=128, hidden=128, layers=2, heads=4, kv_heads=2,
                                          seq=256, window=64)
GRAPH_PROMPTS = [list(range(1, 21)), [9, 10, 11], list(range(30, 41)), [5, 6]]


def _graph_engine(conf=None, **kw):
    params = mistral.init_params(GRAPH_CONFIG, torch.Generator().manual_seed(3))
    kw = {**dict(num_blocks=64, block_size=16, max_blocks_per_seq=8, token_budget=32,
                 max_seqs_per_step=4), **kw}
    return InferenceEngineV2(mistral, GRAPH_CONFIG, params,
                             config={"dtype": "float32", **(conf or {})}, **kw)


def _rows(engine, key, seqs, starts, n_tokens):
    """Packed batch rows of bucket ``key``: each sequence's chunk of
    ``n_tokens`` from ``starts``, its blocks allocated."""
    n, t, b = key
    rows = []
    for i, (seq, start, nt) in enumerate(zip(seqs, starts, n_tokens)):
        engine.manager.ensure_blocks(seq, start + nt)
        packed = np.zeros(3 + t + b, np.int32)
        packed[0] = i
        packed[1:1 + nt] = seq.tokens[start:start + nt]
        packed[1 + t], packed[2 + t] = nt, start
        packed[3 + t:] = engine.manager.block_table_row(seq, width=b)
        rows.append((i, packed))
    return rows


def _two_sequences(engine):
    return [engine.manager.add_sequence(0, list(range(1, 18))),
            engine.manager.add_sequence(1, list(range(40, 50)))]


def test_graph_replay_matches_the_eager_forward(cuda):
    """A prefill bucket (T=16) and then a decode bucket (T=1) over the same
    two sequences, replayed from their captured graphs, give the eager
    forward's last-row logits bit for bit on the same inputs and KV, hence
    the same greedy tokens."""
    engine = _graph_engine()
    trash = engine.manager.trash_block
    seqs = _two_sequences(engine)
    for key, starts, n_tokens in (((2, 16, 4), [0, 0], [16, 9]), ((2, 1, 4), [16, 9], [1, 1])):
        program = engine._fwd_program(key)
        assert program.graph is not None
        engine.batch_state.update(key, _rows(engine, key, seqs, starts, n_tokens), n_active=2,
                                  trash_block=trash)
        got = program().clone()
        slot = engine.batch_state.slot(key, trash)
        logits, _ = mistral.forward_paged(GRAPH_CONFIG, engine.params, *slot.buffers(),
                                          engine.kv, block_size=16)
        last = (slot.n_tokens.long() - 1).clamp_min(0)
        eager = logits[torch.arange(2, device=cuda), last]
        assert torch.equal(got, eager), (got - eager).abs().max().item()
        assert torch.equal(got.argmax(-1), eager.argmax(-1))


def test_graph_capture_writes_only_the_trash_block(cuda):
    """The warm-up before a capture executes for real: with the slot's live
    rows neutralized it writes no KV block but the trash block, and the
    slot's rows are restored afterwards.  The same holds for a burst step."""
    engine = _graph_engine()
    trash = engine.manager.trash_block
    gen = torch.Generator(device=cuda).manual_seed(0)
    for pool in engine.kv.values():
        pool.copy_(torch.randn(pool.shape, generator=gen, device=cuda))
    key = (2, 16, 4)
    slot = engine.batch_state.slot(key, trash)
    engine.batch_state.update(key, _rows(engine, key, _two_sequences(engine), [0, 0], [16, 9]),
                              n_active=2, trash_block=trash)
    rows_before = [t.clone() for t in slot.buffers()]
    kv_before = {k: v[:, :trash].clone() for k, v in engine.kv.items()}
    engine._fwd_program(key)
    engine._burst_program(2, 4)
    torch.cuda.synchronize()
    for k, v in engine.kv.items():
        assert torch.equal(v[:, :trash], kv_before[k]), k
    for got, want in zip(slot.buffers(), rows_before):
        assert torch.equal(got, want)
    assert engine.ledger.total == 2 and engine.ledger.count("cold") == 2


def test_pipelined_graph_replays_patch_the_synchronous_tokens(cuda):
    """Stepwise decode through the pipelined loop replays one decode graph
    step after step while the host patches the step before: each step's
    tokens live in a tensor of its own, so the patched tokens equal the
    synchronous loop's and the eager reference loop's."""
    stepwise = {"serving_fastpath": {"fusion_min_steps": 10**6}}
    synchronous = {"serving_fastpath": {"fusion_min_steps": 10**6, "pipeline_depth": 0}}
    reference = {"serving_fastpath": {"enabled": False}}
    outs = {name: _graph_engine(conf).generate(GRAPH_PROMPTS, max_new_tokens=9)
            for name, conf in (("pipelined", stepwise), ("synchronous", synchronous),
                               ("reference", reference))}
    assert outs["pipelined"] == outs["synchronous"] == outs["reference"]


def test_graph_replays_count_their_launches(cuda):
    """Launch counters advance by what each replay launches (the capture's
    own calls are not counted): a warm serve that builds nothing counts
    forward steps x layers, split by route; the first serve does too."""
    engine = _graph_engine()
    counts = lambda: (paged_attention.launches, paged_attention.tc_launches,  # noqa: E731
                      paged_attention.decode_launches)
    for serve in range(2):
        before, steps, widths = counts(), engine.forward_steps, dict(engine.chunk_widths)
        built = engine.ledger.total
        engine.generate(GRAPH_PROMPTS, max_new_tokens=12)
        steps = engine.forward_steps - steps
        narrow = sum(k - widths.get(t, 0) for t, k in engine.chunk_widths.items() if t < 16)
        assert 0 < narrow < steps
        got = tuple(a - b for a, b in zip(counts(), before))
        assert got == (steps * GRAPH_CONFIG.num_layers, 0, narrow * GRAPH_CONFIG.num_layers)
        if serve == 1:
            assert engine.ledger.total == built  # nothing captured: replays only
    assert engine.counters.burst_tokens > 0 and engine.ledger.warm_total == 0


def test_sampled_burst_equals_stepwise_on_gpu(cuda):
    """Sampled decode from one seed: a burst (one graph replayed k times)
    and k pipelined-free steps draw the same tokens from the engine's
    generator."""
    conf = {"temperature": 1.0, "top_k": 20, "seed": 5}

    def primed():
        engine = _graph_engine(conf)
        engine.put([0, 1], GRAPH_PROMPTS[:2])
        while len(engine.step(greedy=False)) < 2:
            pass
        return engine

    a = primed()
    stepwise = {0: [], 1: []}
    for _ in range(6):
        for uid, tok in a.step(greedy=False).items():
            stepwise[uid].append(tok)
    assert primed().decode_burst(6, greedy=False) == stepwise


SHARED_HEADER = list(range(60, 92))  # two full blocks of 16


def _shared_prompts():
    """Requests behind one 32-token header with their own tails, one that is
    exactly the header (cached to its last token: the CoW copy), and one
    with nothing shared."""
    return ([SHARED_HEADER + list(range(100 + 7 * i, 103 + 9 * i)) for i in range(3)]
            + [list(SHARED_HEADER), [7, 8, 9, 10, 11]])


def test_cow_copy_keeps_kv_storage_and_equals_a_host_copy(cuda):
    """The copy-on-write block copy writes into the pool the graphs captured
    (every leaf keeps its storage), makes block ``dst`` a copy of block
    ``src`` in every leaf and changes no other block, with no host sync."""
    engine = _graph_engine()
    gen = torch.Generator(device=cuda).manual_seed(1)
    for pool in engine.kv.values():
        pool.copy_(torch.randn(pool.shape, generator=gen, device=cuda))
    ptrs = {k: v.data_ptr() for k, v in engine.kv.items()}
    host = {k: v.cpu() for k, v in engine.kv.items()}
    before = engine.counters.snapshot()
    src, dst = 5, 17
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a synchronizing call inside raises
    try:
        engine.manager.cow_copy(src, dst)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    d = engine.counters.delta_since(before)
    assert (d["dispatches"], d["uploads"], d["upload_ints"], d["host_syncs"]) == (1, 1, 2, 0)
    for k, leaf in engine.kv.items():
        assert leaf.data_ptr() == ptrs[k], k
        want = host[k].clone()
        want[:, dst] = host[k][:, src]
        assert torch.equal(leaf.cpu(), want), k


def test_graph_shared_prefix_serve_keeps_shared_blocks_and_matches_eager(cuda):
    """A shared-prefix serve on the fast path with CUDA graphs: every block
    offered to the prefix tree holds, when its last mapper releases it, the
    bytes it held when it was registered (no request wrote a shared block),
    and the tokens equal the eager reference loop's and the cache-off
    serve's, in fp32."""
    prompts = _shared_prompts()
    engine = _graph_engine()
    cache = engine.manager.prefix_cache
    snaps, changed = {}, []
    register, invalidate = cache.register, cache.invalidate_blocks

    def on_register(h, parent, block, tokens):
        # enqueued after the forward that wrote the block: its final bytes
        if register(h, parent, block, tokens):
            snaps[block] = {k: v[:, block].clone() for k, v in engine.kv.items()}
            return True
        return False

    def on_invalidate(blocks):
        for b in blocks:
            snap = snaps.pop(b, None)
            if snap is not None and not all(torch.equal(engine.kv[k][:, b], v)
                                            for k, v in snap.items()):
                changed.append(b)
        invalidate(blocks)

    cache.register, cache.invalidate_blocks = on_register, on_invalidate
    out = engine.generate(prompts, max_new_tokens=10)
    pc = engine.health()["prefix_cache"]
    assert pc["hits_total"] > 0 and pc["cow_copies_total"] == 1 and pc["entries"] == 0
    # realized savings against the observatory's counterfactual: a CoW copy
    # recomputes its prompt's last position, one token of its block
    obs = engine.health()["kv"]["prefix"]
    assert pc["hit_blocks_total"] == obs["duplicate_blocks_total"]
    assert pc["tokens_saved_total"] + pc["cow_copies_total"] == obs["prefill_tokens_saved_total"]
    assert not changed and not snaps
    engine.check_kv_invariant()
    assert engine.programs.graphs and engine.ledger.total > 0
    eager = _graph_engine({"serving_fastpath": {"enabled": False}})
    off = _graph_engine({"serving_prefix_cache": {"enabled": False}})
    assert eager.generate(prompts, max_new_tokens=10) == out
    assert off.generate(prompts, max_new_tokens=10) == out
    assert eager.health()["prefix_cache"] == pc


class _StepClock:
    """Each read returns the time, then advances it by 0.01 s."""

    def __init__(self):
        self.t, self.calls = 0.0, 0

    def __call__(self):
        self.calls += 1
        t, self.t = self.t, self.t + 0.01
        return t


class _Sink:
    def __init__(self):
        self.records = []

    def record_trace(self, record):
        self.records.append(record)


def test_graph_serve_traces_match_cpu_and_leave_counters(cuda):
    """Request tracing on the graph path under a fake clock: the trace
    records, percentiles and flight recorder equal the CPU engine's (the
    stamps follow host control flow), and tracing on leaves the tokens and
    every ServeCounters field of a tracing-off serve."""
    traced = {"serving_tracing": {"enabled": True}}
    params = mistral.init_params(GRAPH_CONFIG, torch.Generator().manual_seed(3))
    kw = dict(num_blocks=64, block_size=16, max_blocks_per_seq=8, token_budget=32,
              max_seqs_per_step=4)
    views = {}
    for name, device, conf in (("graphs", "cuda", traced), ("cpu", "cpu", traced),
                               ("off", "cuda", {})):
        engine = InferenceEngineV2(mistral, GRAPH_CONFIG, params, device=device,
                                   clock=_StepClock(), config={"dtype": "float32", **conf}, **kw)
        sink = engine.tracer.telemetry = _Sink()
        out = engine.generate(GRAPH_PROMPTS, max_new_tokens=9, strict=False)
        assert engine.programs.graphs == (device == "cuda")
        views[name] = {"tokens": [r.tokens for r in out], "records": sink.records,
                       "percentiles": engine.tracer.percentiles(),
                       "recorder": [e for e in engine.tracer.recorder.tail()
                                    if e["event"] != "warm_recompile"],
                       "counters": engine.counters.snapshot()}
    assert views["graphs"]["records"] and {r["status"] for r in views["graphs"]["records"]} == {
        "ok"}
    for key in ("tokens", "records", "percentiles", "recorder"):
        assert views["graphs"][key] == views["cpu"][key], key
    assert views["graphs"]["tokens"] == views["off"]["tokens"]
    assert views["graphs"]["counters"] == views["off"]["counters"]
    assert not views["off"]["records"]


def test_deferred_tokens_wait_for_their_own_copy(cuda):
    """A dispatched step's tokens start their copy to pinned host memory at
    dispatch, behind an event: ``wait()`` returns them (one counted host
    sync) while a later long kernel on the stream may still run, and the
    values equal the device tensor's."""
    from deepspeed_tpu_torch.inference.v2.fastpath import DeferredTokens, ServeCounters
    counters = ServeCounters()
    toks = torch.arange(7, dtype=torch.int32, device=cuda) * 3
    deferred = DeferredTokens(toks_dev=toks, emits=[], row_of={}, counters=counters)
    assert deferred._copy is not None and deferred._copy[0].is_pinned()
    big = torch.randn(4096, 4096, device=cuda)
    for _ in range(20):  # work queued after the step, still running at the wait
        big = big @ big
        big = big / big.norm()
    got = deferred.wait()
    assert got.tolist() == toks.cpu().tolist() and counters.host_syncs == 1
    assert deferred.wait() is got and counters.host_syncs == 1
    cpu = DeferredTokens(toks_dev=toks.cpu(), emits=[], row_of={}, counters=counters)
    assert cpu._copy is None and cpu.wait().tolist() == got.tolist()


# ------------------------------------------- v2 fast path: speculative decoding
def test_spec_verify_under_graphs_matches_spec_off(cuda):
    """Greedy speculative rounds replayed from their captured verify (and
    draft) graphs give the spec-off tokens: the n-gram drafter, and the
    target attached as its own drafter with every draft accepted; with k
    pinned (the same rounds each serve) a second serve builds nothing, and
    the drafter starts each reused uid's request afresh."""
    prompts = [p * 3 for p in GRAPH_PROMPTS]  # repetitive: the n-gram drafter finds matches
    want = _graph_engine().generate(prompts, max_new_tokens=20)
    ngram = _graph_engine({"serving_spec_decode": {"enabled": True, "k": 4,
                                                   "adaptive_k": False}})
    selfd = _graph_engine({"serving_spec_decode": {"enabled": True, "drafter": "model",
                                                   "k": 7, "adaptive_k": False}})
    selfd.attach_draft_model(mistral, GRAPH_CONFIG,
                             mistral.init_params(GRAPH_CONFIG, torch.Generator().manual_seed(3)))
    for engine in (ngram, selfd):
        assert engine.generate(prompts, max_new_tokens=20) == want
        built = engine.ledger.total
        assert engine.generate(prompts, max_new_tokens=20) == want
        assert engine.ledger.total == built and engine.ledger.warm_total == 0
        assert engine.counters.spec_rounds > 0
        assert all(engine.programs._programs[("spec_verify", key)].graph is not None
                   for key in engine.programs.keys("spec_verify"))
    assert selfd.health()["spec_decode"]["acceptance_rate"] == 1.0
    assert selfd.ledger.by_site["draft"]["cold"] > 0


def test_sampled_verify_rounds_under_graphs_draw_fresh_numbers(cuda):
    """The sampled verify samples after its graph's replay, from the engine's
    generator: two rounds never repeat a draw, and a seeded rerun repeats
    the run."""
    from deepspeed_tpu_torch.inference.v2.spec_decode import rejection_select
    conf = {"temperature": 1.0, "top_k": 0, "seed": 5,
            "serving_spec_decode": {"enabled": True, "k": 3, "adaptive_k": False}}
    a = _graph_engine(conf).generate(GRAPH_PROMPTS, max_new_tokens=12, greedy=False)
    engine = _graph_engine(conf)
    assert engine.generate(GRAPH_PROMPTS, max_new_tokens=12, greedy=False) == a
    assert engine.counters.spec_rounds > 0
    logits = torch.randn((512, 4, 128), device=cuda)
    draft = torch.zeros((512, 3), dtype=torch.int32, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    r1 = rejection_select(logits, draft, gen, sample_cfg=(1.0, 0, 1.0))
    r2 = rejection_select(logits, draft, gen, sample_cfg=(1.0, 0, 1.0))
    assert not torch.equal(r1, r2)
    gen.manual_seed(7)
    assert torch.equal(rejection_select(logits, draft, gen, sample_cfg=(1.0, 0, 1.0)), r1)


# ------------------------------------------------- checkpoints and fp16 training
def _ckpt_engine(cfg, params, device, **over):
    conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "bf16": {"enabled": False},
            "optimizer": {"type": "fused_adam", "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "checkpoint": {"checkpoint_engine": "async"}}
    conf.update(over)
    return deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg), model_parameters=params,
                                          config=conf, device=device)[0]


def _state_leaves(engine):
    from deepspeed_tpu_torch.runtime.checkpointing import flatten_with_keys
    return [(k, v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in flatten_with_keys(engine.state)]


@pytest.mark.parametrize("writer,reader", [("cuda", "cuda"), ("cpu", "cuda"), ("cuda", "cpu")])
def test_checkpoint_round_trip_between_devices_with_the_async_engine(cuda, tmp_path, writer,
                                                                     reader):
    """A bf16 engine's state, saved by the async writer from one device,
    loads on the other (the device taken from the loading engine); the
    loaded state equals the saved one bit for bit, and on the card the next
    two steps equal the writer's."""
    cfg = llama.LlamaConfig.tiny(vocab=128, hidden=128, layers=2, heads=2, kv_heads=1, seq=64)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    batches = [llama.causal_lm_batch(np.random.default_rng(s).integers(0, 128, (4, 64)))
               for s in range(4)]
    src = _ckpt_engine(cfg, params, writer, bf16={"enabled": True})
    for b in batches[:2]:
        src.train_batch(b)
    src.save_checkpoint(str(tmp_path))
    dst = _ckpt_engine(cfg, llama.init_params(cfg, torch.Generator().manual_seed(1)), reader,
                       bf16={"enabled": True}, seed=7)
    assert dst.load_checkpoint(str(tmp_path))[0] == "global_step2"
    assert all(v.device.type == reader for _, v in _state_leaves_raw(dst))
    for (key, a), (_, b) in zip(_state_leaves(dst), _state_leaves(src)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b), key
    if writer == reader:
        for b in batches[2:]:
            assert float(src.train_batch(b).loss) == float(dst.train_batch(b).loss)
        for (key, a), (_, b) in zip(_state_leaves(dst), _state_leaves(src)):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b), key


def _state_leaves_raw(engine):
    from deepspeed_tpu_torch.runtime.checkpointing import flatten_with_keys
    return [(k, v) for k, v in flatten_with_keys(engine.state) if isinstance(v, torch.Tensor)]


def test_fp16_overflow_step_launches_no_fused_adamw(cuda):
    """fp16 on the card: a step that overflows (a static scale of 2**30)
    launches the fp16 flash kernels on tensor cores and no fused AdamW,
    keeps ``TrainState.step`` and the params; a step at a scale of 128
    launches AdamW once a leaf and agrees with the CPU engine."""
    cfg = llama.LlamaConfig.tiny(vocab=128, hidden=128, layers=2, heads=2, kv_heads=1, seq=64)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    n_leaves = len(list(_leaves(params)))
    batch = llama.causal_lm_batch(np.random.default_rng(2).integers(0, 128, (4, 64)))
    big = _ckpt_engine(cfg, params, "cuda", bf16=None, fp16={"enabled": True,
                                                             "loss_scale": 2.0**30})
    assert big.compute_dtype == torch.float16
    before = {k: v.clone() for k, v in _state_leaves_raw(big)}
    counts = (flash.flash_fwd.tc_launches, fused_adamw_flat.launches)
    m = big.train_batch(batch)
    assert m.skipped and big.state.step == 0 and big.global_steps == 1
    assert (flash.flash_fwd.tc_launches - counts[0], fused_adamw_flat.launches - counts[1]) \
        == (8, 0)
    for key, value in _state_leaves_raw(big):
        assert torch.equal(value, before[key]), key
    engines = {dev: _ckpt_engine(cfg, params, dev, bf16=None,
                                 fp16={"enabled": True, "loss_scale": 128.0})
               for dev in ("cpu", "cuda")}
    counts = fused_adamw_flat.launches
    losses = {dev: engines[dev].train_batch(batch) for dev in engines}
    assert fused_adamw_flat.launches - counts == n_leaves
    assert not losses["cuda"].skipped and not losses["cpu"].skipped
    assert abs(float(losses["cuda"].loss) - float(losses["cpu"].loss)) <= 2e-3 * float(
        losses["cpu"].loss)


def _llama_grads(cfg, params, batch, device, generator=None, ltd_keep=None, attention_fn=None):
    """(loss, grads) of the tiny Llama's loss on ``device``, optionally under
    a random-LTD scope keeping ``ltd_keep`` tokens."""
    from deepspeed_tpu_torch.models import transformer
    from deepspeed_tpu_torch.runtime.tree import tree_leaves, tree_map
    p = tree_map(lambda t: t.detach().to(device).requires_grad_(True), params)
    loss_fn = llama.make_loss_fn(cfg, attention_fn=attention_fn)
    if ltd_keep is not None:
        loss_fn = transformer.scoped_random_ltd(loss_fn, {"keep": ltd_keep})
    b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    loss = loss_fn(p, b, generator)
    return loss, torch.autograd.grad(loss, tree_leaves(p))


def test_offload_checkpoint_parks_pinned_host_bytes_and_matches_plain_grads(cuda):
    """``remat_policy="offload_inputs"``: after the forward each layer's input
    (B x S x D x 4 bytes) waits in pinned host memory, the backward takes it
    back, and the grads equal full recompute's on the card."""
    import dataclasses
    from deepspeed_tpu_torch.runtime.activation_checkpointing import offload_checkpoint
    cfg = llama.LlamaConfig.tiny(vocab=128, hidden=128, layers=3, heads=2, kv_heads=1, seq=64)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    batch = llama.causal_lm_batch(np.random.default_rng(3).integers(0, 128, (2, 64)))
    ref_loss, ref = _llama_grads(dataclasses.replace(cfg, remat_policy="nothing_saveable"),
                                 params, batch, cuda)
    off_cfg = dataclasses.replace(cfg, remat_policy="offload_inputs")
    offload_checkpoint.host_bytes = offload_checkpoint.peak_host_bytes = 0
    loss, grads = _llama_grads(off_cfg, params, batch, cuda)
    assert offload_checkpoint.peak_host_bytes == 3 * 2 * 64 * 128 * 4
    assert offload_checkpoint.host_bytes == 0
    assert float(loss) == float(ref_loss)
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable", "everything_saveable",
                                    "save_anything_except_these_names"])
def test_remat_policies_on_gpu_give_the_default_policy_s_grads(cuda, policy):
    """bf16 through flash on the card: each policy's loss and grads equal the
    default policy's bit for bit (a kept product and its recompute are the
    same cuBLAS call on the same inputs)."""
    import dataclasses
    cfg = llama.LlamaConfig.tiny(vocab=128, hidden=256, layers=2, heads=4, kv_heads=2, seq=128)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    batch = llama.causal_lm_batch(np.random.default_rng(2).integers(0, 128, (2, 128)))
    ref_loss, ref = _llama_grads(cfg, params, batch, cuda)
    before = flash.flash_fwd.launches
    loss, grads = _llama_grads(dataclasses.replace(cfg, remat_policy=policy), params, batch, cuda)
    # the forward kernel runs again in the recompute under every policy but one
    assert flash.flash_fwd.launches - before == (2 if policy == "everything_saveable" else 4)
    assert torch.equal(loss, ref_loss)
    for g, r in zip(grads, ref):
        assert torch.equal(g, r)


def test_random_ltd_scan_kernel_path_equals_plain_path(cuda):
    """Random-LTD on the card, fp32: the middle layers run the flash kernels at
    Sq = Sk = keep on the kept tokens; the same draws (one seeded CUDA
    generator) through the plain attention give the same loss and grads."""
    from deepspeed_tpu_torch.models.transformer import sdpa
    cfg = llama.LlamaConfig.tiny(vocab=128, hidden=128, layers=4, heads=2, kv_heads=1, seq=256)
    params = llama.init_params(cfg, torch.Generator().manual_seed(1))
    batch = llama.causal_lm_batch(np.random.default_rng(4).integers(0, 128, (2, 256)))
    before = flash.flash_fwd.launches
    out = {}
    for name, fn in (("kernel", None), ("plain", sdpa)):
        gen = torch.Generator(device="cuda").manual_seed(5)
        out[name] = _llama_grads(cfg, params, batch, cuda, generator=gen, ltd_keep=96,
                                 attention_fn=fn)
    assert flash.flash_fwd.launches - before == 2 * 4  # forward and recompute, 4 layers
    torch.testing.assert_close(out["kernel"][0], out["plain"][0], rtol=1e-4, atol=1e-5)
    for g, r in zip(out["kernel"][1], out["plain"][1]):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


def test_flash_and_sparse_refuse_a_second_derivative(cuda):
    from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue
    q = torch.randn(1, 128, 2, 64, device=cuda)
    with pytest.raises(RuntimeError, match="differentiable once"):
        Eigenvalue(max_iter=2).compute_eigenvalue(
            lambda p, b, r: flash.flash_attention(p["q"], p["q"], p["q"]).sum(), {"q": q}, None)
    fn = sparse.make_config_attention_fn(SparseAttentionConfig(mode="fixed", block=16))
    with pytest.raises(RuntimeError, match="differentiable once"):
        Eigenvalue(max_iter=2).compute_eigenvalue(
            lambda p, b, r: fn(p["q"], p["q"], p["q"]).sum(), {"q": q}, None)


def test_watchdog_on_the_card_reads_each_verdict_one_step_late(cuda):
    """bf16 on CUDA: the watchdog copies each step's loss and grad norm to
    pinned memory and reads them after the next step is queued, so a streak
    of ``max_consecutive_skips`` non-finite steps raises one step later than
    on the CPU, naming the step that completed it."""
    from deepspeed_tpu_torch.runtime.engine import NonFiniteLossError
    params = {"w": torch.randn(8, 8, generator=torch.Generator().manual_seed(0)) / 3}

    def loss_fn(p, batch, rng):
        return ((batch["x"].to(p["w"].dtype) @ p["w"]) ** 2).mean().float()

    engine = deepspeed_tpu_torch.initialize(
        loss_fn=loss_fn, model_parameters=params,
        config={"train_batch_size": 2, "bf16": {"enabled": True}, "max_consecutive_skips": 2,
                "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}})[0]
    good = {"x": np.ones((2, 8), np.float32)}
    bad = {"x": np.full((2, 8), np.nan, np.float32)}
    engine.train_batch(good)
    engine.train_batch(bad)
    engine.train_batch(bad)  # the second bad step: its verdict is still on its way
    assert engine._consecutive_bad_steps == 1
    with pytest.raises(NonFiniteLossError, match="at global step 3"):
        engine.train_batch(good)


def _offload_conf(**zero):
    return {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "bf16": {"enabled": False},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "zero_optimization": {"stage": 2, **zero}}


def test_offload_pinned_step_on_gpu_matches_cpu(cuda):
    """``offload_optimizer: {device: cpu, pin_memory: true}`` on the card: the
    master params and the grads' staging are page-locked, the step takes
    the host CPU-Adam once a leaf and no fused-AdamW launch, and losses and
    params follow the same offloaded engine on the CPU."""
    from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
    cfg = llama.LlamaConfig.tiny(vocab=128, hidden=128, layers=2, heads=2, kv_heads=1, seq=64)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    conf = _offload_conf(offload_optimizer={"device": "cpu", "pin_memory": True})
    engines = {dev: deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg),
                                                   model_parameters=params, config=conf,
                                                   device=dev)[0] for dev in ("cpu", "cuda")}
    host = engines["cuda"]._offload_state
    assert host.pinned_bytes == 4 * sum(p.numel() for p in _leaves(params))
    assert all(t.is_pinned() for t in host.params.values())
    assert all(t.is_pinned() for t in engines["cuda"]._grad_staging.values())
    assert engines["cpu"]._offload_state.pinned_bytes == 0
    batch = llama.causal_lm_batch(np.random.default_rng(1).integers(0, 128, (4, 64)))
    before = (fused_adamw_flat.launches, DeepSpeedCPUAdam.launches, flash.flash_fwd.launches)
    for _ in range(2):
        losses = [float(engines[dev].train_batch(batch).loss) for dev in ("cpu", "cuda")]
        assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[0])
    assert fused_adamw_flat.launches == before[0]
    assert DeepSpeedCPUAdam.launches - before[1] == 2 * 2 * len(list(_leaves(params)))
    assert flash.flash_fwd.launches - before[2] == 2 * 2 * 2 * 2  # steps x gas x layers x remat
    got, want = engines["cuda"].get_fp32_params(), engines["cpu"].get_fp32_params()
    for a, b in zip(_leaves(got), _leaves(want)):
        assert float(np.abs(a - b).max()) <= 2 * 2e-3
    host.close()


def test_infinity_streams_layers_through_flash_on_gpu(cuda, tmp_path):
    """``offload_param: nvme`` with the moments in RAM, a tiny Llama's layers
    streamed through the flash kernels on the card: each layer and step
    launches 2 forwards (the stream, the backward's recompute), 1 dK/dV and
    1 dQ; losses and stacked params follow the same engine on the CPU."""
    from deepspeed_tpu_torch.models import transformer
    cfg = llama.LlamaConfig.tiny(vocab=128, hidden=128, layers=2, heads=2, kv_heads=2, seq=64)
    base = llama.init_params(cfg, torch.Generator().manual_seed(0))

    def build(dev):
        d = torch.device(dev)
        attention = transformer.resolve_attention(None, d)
        cos, sin = transformer.device_rotary_tables(64, 64, cfg.rope_theta, str(d))
        layer_fn = lambda p, x: llama._layer(cfg, cos, sin, attention, x, p)
        stem_fn = lambda sp, t: sp["embed"][t.long()]

        def head_fn(h, x, labels):
            x = transformer.rms_norm(x, h["final_norm"], cfg.rms_eps)
            return transformer.cross_entropy_loss(x @ h["lm_head"].to(x.dtype), labels)

        params = {"stem": {"embed": base["embed"]}, "layers": base["layers"],
                  "final_norm": base["final_norm"], "lm_head": base["lm_head"]}
        conf = {"train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": False},
                "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
                "zero_optimization": {"stage": 3, "offload_optimizer": {"device": "cpu"},
                                      "offload_param": {"device": "nvme", "buffer_count": 6,
                                                        "nvme_path": str(tmp_path / dev)}}}
        return deepspeed_tpu_torch.initialize(loss_fn=lambda p, b, r: 0.0, model_parameters=params,
                                              config=conf, device=dev, layer_fn=layer_fn,
                                              stem_fn=stem_fn, head_fn=head_fn)[0]

    engines = {dev: build(dev) for dev in ("cpu", "cuda")}
    rows = llama.causal_lm_batch(np.random.default_rng(2).integers(0, 128, (2, 64)))
    batch = {"x": rows["input_ids"], "y": rows["labels"]}
    fns = (flash.flash_fwd, flash.flash_bwd_dkdv, flash.flash_bwd_dq)
    before = [fn.launches for fn in fns]
    for _ in range(2):
        losses = [float(engines[dev].train_batch(batch).loss) for dev in ("cpu", "cuda")]
        assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[0])
    assert [fn.launches - b for fn, b in zip(fns, before)] == [8, 4, 4]
    got = engines["cuda"]._nvme_trainer.gather_stacked_params()
    want = engines["cpu"]._nvme_trainer.gather_stacked_params()
    for a, b in zip(_leaves(got), _leaves(want)):
        assert float((a - b).abs().max()) <= 2 * 2e-3


def test_flash_launches_count_their_plain_versions_flops(cuda):
    """On the card a FLOP count holds what the plain versions add on the CPU:
    the same forward and backward through flash_attention on both."""
    from deepspeed_tpu_torch.profiling.flops_profiler import count_ops
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 64, 4, 64, generator=g) for _ in range(3))
    counts = {}
    for dev in ("cpu", "cuda"):
        ts = [t.to(dev, torch.bfloat16 if dev == "cuda" else torch.float32).requires_grad_(True)
              for t in (q, k, v)]
        with count_ops() as count:
            flash.flash_attention(*ts, causal=True).float().sum().backward()
        counts[dev] = (count.flops, count.bytes_accessed)
    assert counts["cuda"][0] == counts["cpu"][0] == (4 + 8 + 6) * 2 * 4 * 64 * 64 * 64
    assert counts["cuda"][1] > 0


def test_hybrid_engine_on_gpu_matches_cpu(cuda):
    """The hybrid engine in fp32 on the card and the CPU: the same logits
    before and after a step (flash against the plain attention), the same
    greedy rollouts, one inference engine, LoRA fused within the same
    limit."""
    import dataclasses

    from deepspeed_tpu_torch.runtime.config import load_config
    from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine
    from deepspeed_tpu_torch.runtime.tree import tree_map
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab=128, hidden=256, layers=2, heads=4,
                                                     kv_heads=2, seq=64), remat=False)
    base = llama.init_params(cfg, torch.Generator().manual_seed(0))
    conf = {"train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": False},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    rng = np.random.default_rng(0)
    lora = {"layers": {"attn": {"wq": {"a": rng.normal(size=(2, 256, 8)).astype(np.float32) * .1,
                                       "b": rng.normal(size=(2, 8, 256)).astype(np.float32) * .1,
                                       "alpha": 16.0}}}}
    ids = rng.integers(1, 128, (2, 16))
    batch = llama.causal_lm_batch(rng.integers(0, 128, (2, 64)))
    out = {}
    for dev in ("cpu", "cuda"):
        eng = DeepSpeedHybridEngine(loss_fn=llama.make_loss_fn(cfg),
                                    params=tree_map(lambda p: p.clone(), base),
                                    config=load_config(conf), device=dev, model_module=llama,
                                    model_config=cfg, inference_config={"max_seq_len": 64})
        first = eng.eval_forward(ids).cpu()
        inf = eng._inf_engine
        eng.train_batch(batch)
        gen = eng.generate(ids, max_new_tokens=8, temperature=0.0)
        eng.set_lora(lora)
        out[dev] = (first, eng.eval_forward(ids).cpu(), gen, eng._inf_engine is inf)
    for a, b in zip(out["cpu"][:2], out["cuda"][:2]):
        assert float((a - b).abs().max()) <= 1e-4 * max(1.0, float(a.abs().max()))
    np.testing.assert_array_equal(out["cpu"][2], out["cuda"][2])
    assert out["cuda"][3]


def test_accelerator_on_gpu(cuda):
    """``get_accelerator()`` on the card: name, count and memory; its events
    are torch.cuda.Event's; a captured graph replays the eager product bit
    for bit with new inputs; pinned memory; the synchronized timer reads at
    least the device time of what it timed; the backend is nccl."""
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.utils.timer import SynchronizedWallClockTimer
    acc = get_accelerator()
    assert acc.device_name(0) == "cuda:0" and acc.device_count() == torch.cuda.device_count()
    assert acc.total_memory() == torch.cuda.get_device_properties(0).total_memory
    assert acc.communication_backend_name() == "nccl"
    gen = torch.Generator(device="cuda").manual_seed(0)
    a, b, a2 = (torch.randn(512, 512, device="cuda", generator=gen).bfloat16() for _ in range(3))
    graph = acc.create_graph()
    acc.capture_to_graph(graph, lambda x: x @ b, a.clone())
    assert torch.equal(acc.replay_graph(graph, a2), a2 @ b)
    assert acc.is_pinned(acc.pin_memory(torch.ones(1024)))
    timers = SynchronizedWallClockTimer()
    ev = [acc.Event(enable_timing=True) for _ in range(2)]
    timers("mm").start(sync=True)
    ev[0].record()
    for _ in range(20):
        a @ b
    ev[1].record()
    timers("mm").stop(sync=True)
    assert timers("mm").elapsed() >= ev[0].elapsed_time(ev[1]) > 0


def test_env_report_reads_every_library_built_on_gpu(cuda, capsys):
    from deepspeed_tpu_torch import env_report
    rows = env_report.op_report()
    assert [r[0] for r in rows] and all(r[1] and r[2] for r in rows), rows
    assert env_report.main() == 0
    assert torch.cuda.get_device_name(0) in capsys.readouterr().out


def test_autotune_runner_prunes_an_oom_and_frees_every_engine_on_gpu(cuda):
    """The runner on a tiny Llama on the card: a micro-batch that fits
    reports finite metrics, one the card refuses is pruned (None), and the
    memory allocated after them equals the memory before within 16 MiB."""
    import dataclasses

    from deepspeed_tpu_torch.autotuning.autotuner import make_engine_runner
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab=32000, hidden=256, layers=2, heads=2,
                                                     kv_heads=2, seq=1024), remat=True)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                               device="cuda")
    rng = np.random.default_rng(0)
    runner = make_engine_runner(
        llama.make_loss_fn(cfg), params, warmup_steps=1, measure_steps=1,
        example_batch_fn=lambda n: llama.causal_lm_batch(rng.integers(0, 32000, (n, 1024))))
    conf = {"gradient_accumulation_steps": 1, "bf16": {"enabled": True},
            "optimizer": {"type": "fused_adam", "params": {"lr": 1e-4}}}
    # the first experiment also makes what a process keeps once (cuBLAS's
    # workspace): measure from after it
    assert runner(dict(conf, train_micro_batch_size_per_gpu=2)) is not None
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    assert runner(dict(conf, train_micro_batch_size_per_gpu=4096)) is None
    metrics = runner(dict(conf, train_micro_batch_size_per_gpu=2))
    assert metrics is not None and all(np.isfinite(list(metrics.values())))
    assert abs(torch.cuda.memory_allocated() - before) <= 16 << 20


def test_elastic_agent_restarts_a_gpu_worker(cuda, tmp_path):
    """The agent over a worker that takes the card: generation 0 exits 1,
    generation 1 sees the restart ordinal and RANK, and runs on cuda."""
    import sys

    from deepspeed_tpu_torch.elasticity import DSElasticAgent
    script = ("import os, sys, torch\n"
              "assert torch.cuda.is_available()\n"
              "x = torch.ones(4, device='cuda').sum().item()\n"
              "sys.exit(1 if os.environ['DSTPU_ELASTIC_RESTART'] == '0' else 0)\n")
    agent = DSElasticAgent([sys.executable, "-c", script], world_size=1, max_restarts=2,
                           poll_interval=0.05)
    assert agent.run() == 0 and agent.restart_count == 1


def test_comm_benchmark_cli_under_the_launcher_at_one_rank(cuda):
    """``launch -m deepspeed_tpu_torch.comm.benchmark`` on a one-card host:
    one process, a world-size-1 NCCL group from the launcher's env, and
    JAX's line for an axis of one rank."""
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               CUDA_VISIBLE_DEVICES=os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0],
               PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
    env.pop("DSTPU_WORLD_INFO", None)
    run = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch", "-m",
                          "deepspeed_tpu_torch.comm.benchmark", "--elems", "1048576", "--iters",
                          "2"], env=env, cwd=root, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert "axis 'data' has world size 1" in run.stdout
    assert "torch.distributed initialized: rank 0/1" in run.stdout + run.stderr
    assert "(nccl)" in run.stdout + run.stderr

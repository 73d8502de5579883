#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:
  1. device: the card's name and power limit, and the paged-attention kernel's
     build (nvcc, sm_90a, into deepspeed_tpu_torch/build/) with its seconds;
  2. kernel vs plain: ``paged_attention`` (the hand-written kernel) against
     ``paged_attention_reference`` (the plain PyTorch version) on CUDA tensors,
     at Mistral-7B and Llama-2-7B shapes and on small edge cases, with times
     for the kernel, the plain version, torch's scaled_dot_product_attention
     over the gathered context (a yardstick only; the port never calls it)
     and the card's bound for the same work;
  3. serve: ``build_engine("mistral", MistralConfig.mistral_7b(), ...)`` in
     bf16 with seeded random weights answers 16 requests through greedy
     ``generate``, and every forward step goes through the kernel; the same
     serve again under torch.profiler splits the device time by kernel;
  4. the slice against its plain version: a 2-layer, full-width Mistral in
     fp32, one prefill and three decode steps of ``forward_paged`` on CUDA
     (kernel) and on a CPU copy (plain path) with the same weights and KV.

fp32 matrix products and convolutions run in full fp32 (TF32 is switched
off), so fp32 comparisons differ only by the order of summation.  The last
lines are the kernels' JSON record, then ``{"ok": true, "device": ...}``.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float16": 989e12, "torch.float32": 67e12}
TIMED_RUNS = 25
REPLACES = "deepspeed_tpu/ops/attention/paged.py:40"  # _paged_kernel, pl.pallas_call at :141
SOURCE = "deepspeed_tpu_torch/csrc/paged_attention.cu"


def log(*parts):
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phase 1
def phase_device():
    import torch

    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.attention import paged
    card = nvidia_smi_line()
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    paged._lib()
    log(f"[device] paged_attention kernel ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds.get('paged_attention', 0.0):.2f} s)")
    for line in _build.build_log.get("paged_attention", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[device] ptxas: {line.strip()}")
    return card


# ------------------------------------------------------------------ phase 2
def make_case(seed, *, N, T, H, KV, Dh, bs, lengths, n_tokens, dtype, window=None,
              alibi=False):
    """Random q and pools, each sequence's blocks scattered over the pool,
    padded table slots pointing at the trash block (the last one)."""
    import torch
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    n_tokens = np.asarray(n_tokens, np.int32)
    need = [-(-int(L) // bs) for L in lengths]
    maxb = max(1, max(need))
    nb = sum(need) + 1
    perm = rng.permutation(nb - 1)
    tables = np.full((N, maxb), nb - 1, np.int32)
    at = 0
    for i, k in enumerate(need):
        tables[i, :k] = perm[at:at + k]
        at += k
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    case = {
        "q": torch.randn((N, T, H, Dh), generator=g, device=dev).to(dtype),
        "kpool": torch.randn((nb, KV, bs, Dh), generator=g, device=dev).to(dtype),
        "vpool": torch.randn((nb, KV, bs, Dh), generator=g, device=dev).to(dtype),
        "tables": torch.from_numpy(tables).to(dev),
        "lengths": torch.from_numpy(lengths).to(dev),
        "start_pos": torch.from_numpy(lengths - n_tokens).to(dev),
        "n_tokens": torch.from_numpy(n_tokens).to(dev),
        "alibi_slopes": (torch.tensor([2.0**(-8.0 * (h + 1) / H) for h in range(H)],
                                      device=dev) if alibi else None),
        "block_size": bs, "window": window,
    }
    return case


def run_kernel(c):
    from deepspeed_tpu_torch.ops.attention.paged import paged_attention
    return paged_attention(c["q"], c["kpool"], c["vpool"], c["tables"], c["lengths"],
                           c["start_pos"], c["n_tokens"], block_size=c["block_size"],
                           window=c["window"], alibi_slopes=c["alibi_slopes"])


def run_plain(c):
    from deepspeed_tpu_torch.ops.attention.paged import paged_attention_reference
    dh = c["q"].shape[-1]
    return paged_attention_reference(c["q"], c["kpool"], c["vpool"], c["tables"], c["lengths"],
                                     c["start_pos"], c["n_tokens"], 1.0 / np.sqrt(dh),
                                     c["window"], c["alibi_slopes"])


def compare(name, c):
    import torch
    from deepspeed_tpu_torch.ops.attention.paged import paged_attention
    before = paged_attention.launches
    got = run_kernel(c)
    torch.cuda.synchronize()
    if paged_attention.launches != before + 1:
        raise AssertionError(f"{name}: the kernel did not launch")
    ref = run_plain(c)
    tol = 1e-4 if c["q"].dtype == torch.float32 else 2e-2
    got32, ref32 = got.float(), ref.float()
    err = (got32 - ref32).abs()
    bad = err > tol + tol * ref32.abs()
    if not torch.isfinite(got32).all() or bad.any():
        raise AssertionError(f"{name}: kernel disagrees with the plain version: max abs err "
                             f"{err.max().item():.3e}, {int(bad.sum())} elements beyond "
                             f"atol=rtol={tol}")
    pad = (torch.arange(got.shape[1], device=got.device)[None, :]
           >= c["n_tokens"].long()[:, None])
    if (got[pad] != 0).any():
        raise AssertionError(f"{name}: padding rows are not exact zeros")
    max_err = err.max().item()
    log(f"[kernel] {name}: ok, max abs err {max_err:.3e} (atol=rtol={tol}, {c['q'].dtype})")
    return max_err


def work(c):
    """Bytes the function must move and operations it must do for this
    case's data: each live key/value row read once, q read and o written
    once; scores and the weighted sum over the keys each row may see."""
    lengths = c["lengths"].cpu().numpy()
    start = c["start_pos"].cpu().numpy()
    ntok = c["n_tokens"].cpu().numpy()
    N, T, H, Dh = c["q"].shape
    KV = c["kpool"].shape[1]
    elt = c["q"].element_size()
    window = c["window"]
    live_keys = 0
    row_keys = 0
    for n in range(N):
        if ntok[n] == 0:
            continue
        lo = 0 if window is None else max(0, int(start[n]) - window + 1)
        live_keys += int(lengths[n]) - lo
        for t in range(int(ntok[n])):
            qpos = int(start[n]) + t
            first = 0 if window is None else max(0, qpos - window + 1)
            row_keys += min(qpos + 1, int(lengths[n])) - first
    nbytes = (2 * live_keys * KV * Dh * elt + 2 * N * T * H * Dh * elt
              + c["tables"].numel() * 4 + 3 * N * 4)
    flops = 4.0 * row_keys * H * Dh
    return nbytes, flops


def time_ms(fn, runs=TIMED_RUNS):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def library_call(c):
    """torch's scaled_dot_product_attention over the gathered dense context
    (gathered outside the timed call): the yardstick, never used by the port."""
    import torch
    import torch.nn.functional as F
    q = c["q"]
    N, T, H, Dh = q.shape
    maxb = c["tables"].shape[1]
    KV, bs = c["kpool"].shape[1], c["kpool"].shape[2]
    idx = c["tables"].long()
    k = c["kpool"][idx].transpose(2, 3).reshape(N, maxb * bs, KV, Dh)
    v = c["vpool"][idx].transpose(2, 3).reshape(N, maxb * bs, KV, Dh)
    k = torch.repeat_interleave(k, H // KV, dim=2).transpose(1, 2).contiguous()
    v = torch.repeat_interleave(v, H // KV, dim=2).transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    qpos = c["start_pos"].long()[:, None] + torch.arange(T, device=q.device)[None, :]
    kpos = torch.arange(maxb * bs, device=q.device)[None, None, :]
    mask = (kpos <= qpos[:, :, None]) & (kpos < c["lengths"].long()[:, None, None])
    if c["window"] is not None:
        mask = mask & (kpos > qpos[:, :, None] - c["window"])
    mask = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)


def measure(name, c):
    import torch
    nbytes, flops = work(c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(c["q"].dtype)] * 1e3
    rec = {
        "ms": time_ms(lambda: run_kernel(c)),
        "plain_ms": time_ms(lambda: run_plain(c)),
        "library_ms": time_ms(library_call(c)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }
    torch.cuda.synchronize()
    log(f"[kernel] {name}: kernel_ms {rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} "
        f"library_ms {rec['library_ms']:.4f} bound_ms {rec['bound_ms']:.4f} "
        f"({rec['bound_by']}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return rec


def phase_kernel(card):
    """Kernel vs plain on the card; returns the Mistral decode and prefill
    measurements and the largest bf16 error at Mistral shapes."""
    import torch
    from deepspeed_tpu_torch.ops.attention.paged import paged_attention
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    decode_lengths = np.concatenate([[1, 4096], rng.integers(1, 4097, 30)])
    mistral = dict(H=32, KV=8, Dh=128, bs=16, window=4096)
    cases = {
        "mistral_decode": make_case(1, N=32, T=1, lengths=decode_lengths, n_tokens=[1] * 32,
                                    dtype=bf16, **mistral),
        "mistral_prefill": make_case(2, N=2, T=512, lengths=[2048, 700], n_tokens=[512, 300],
                                     dtype=bf16, **mistral),
        "llama2_decode": make_case(3, N=32, T=1, H=32, KV=32, Dh=128, bs=16,
                                   lengths=decode_lengths, n_tokens=[1] * 32, dtype=bf16),
    }
    small = dict(N=4, T=8, H=8, KV=2, Dh=64, bs=16, lengths=[5, 40, 130, 0],
                 n_tokens=[3, 8, 8, 0])
    for dtype, tag in ((torch.float32, "fp32"), (bf16, "bf16")):
        cases[f"small_window_{tag}"] = make_case(4, dtype=dtype, window=6, **small)
        cases[f"small_alibi_{tag}"] = make_case(5, dtype=dtype, alibi=True, **small)
        cases[f"small_padding_zero_row_{tag}"] = make_case(6, dtype=dtype, **small)
    cases["mqa_bs64_dh256_fp16"] = make_case(7, N=3, T=5, H=8, KV=1, Dh=256, bs=64,
                                             lengths=[70, 1, 200], n_tokens=[5, 1, 2],
                                             dtype=torch.float16, window=50)
    cases["mha_bs8_dh32_fp32"] = make_case(8, N=5, T=3, H=2, KV=2, Dh=32, bs=8,
                                           lengths=[3, 9, 17, 0, 33], n_tokens=[3, 1, 2, 0, 3],
                                           dtype=torch.float32, alibi=True, window=9)
    errs = {name: compare(name, c) for name, c in cases.items()}
    recs = {name: measure(name, cases[name])
            for name in ("mistral_decode", "mistral_prefill", "llama2_decode")}
    for name, rec in recs.items():
        log(f"[kernel] {name} on {card}: {json.dumps({k: rec[k] for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by')})}")
    paged_attention.launches = 0
    return recs, max(errs["mistral_decode"], errs["mistral_prefill"])


# ------------------------------------------------------------------ phase 3
def phase_serve(card, seed=0):
    import torch
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    from deepspeed_tpu_torch.models.mistral import MistralConfig, init_params, num_params
    from deepspeed_tpu_torch.ops.attention.paged import paged_attention
    cfg = MistralConfig.mistral_7b()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    n_params = sum(p.numel() for p in _leaves(params))
    if n_params != num_params(cfg):
        raise AssertionError(f"init_params made {n_params} params, num_params says "
                             f"{num_params(cfg)}")
    num_blocks, block_size = 2048, 16
    engine = build_engine("mistral", cfg, params, config={"dtype": "bfloat16", "seed": seed},
                          device="cuda", num_blocks=num_blocks, block_size=block_size,
                          max_blocks_per_seq=256, token_budget=512, max_seqs_per_step=32)
    torch.cuda.synchronize()
    log(f"[serve] mistral_7b: {n_params / 1e9:.3f} B params "
        f"({sum(p.numel() * p.element_size() for p in _leaves(params)) / 1e9:.2f} GB bf16), "
        f"KV pool {sum(v.numel() * v.element_size() for v in engine.kv.values()) / 2**30:.2f} "
        f"GiB, set up in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(seed)
    lens = np.concatenate([[32, 2048], rng.integers(32, 2049, 14)])
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]
    max_new = 32
    paged_attention.launches = 0
    steps0 = engine.forward_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.generate(prompts, max_new_tokens=max_new, strict=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    steps = engine.forward_steps - steps0
    for prompt, res in zip(prompts, results):
        if res.status != "ok" or len(res.tokens) != len(prompt) + max_new:
            raise AssertionError(f"request {res.uid}: status {res.status} ({res.reason}), "
                                 f"{len(res.tokens)} tokens for a {len(prompt)}-token prompt")
        if res.tokens[:len(prompt)] != prompt:
            raise AssertionError(f"request {res.uid}: prompt not echoed")
        if not all(0 <= tok < cfg.vocab_size for tok in res.tokens[len(prompt):]):
            raise AssertionError(f"request {res.uid}: token id outside the vocabulary")
    free = engine.manager.allocator.free_blocks
    if free != num_blocks - 1 or engine.manager.seqs:
        raise AssertionError(f"KV pool not reclaimed: {free} of {num_blocks - 1} blocks free, "
                             f"{len(engine.manager.seqs)} sequences tracked")
    if launches != steps * cfg.num_layers:
        raise AssertionError(f"paged_attention launched {launches} times over {steps} forward "
                             f"steps x {cfg.num_layers} layers")
    generated = max_new * len(prompts)
    log(f"[serve] {len(prompts)} requests ({int(lens.sum())} prompt tokens, "
        f"{generated} generated) all ok on {card}: wall {wall:.3f} s, "
        f"{generated / wall:.1f} generated tok/s, {(int(lens.sum()) + generated) / wall:.1f} "
        f"total tok/s, {steps} steps, mean step {wall / steps * 1e3:.2f} ms, "
        f"paged_attention launches {launches} = {steps} x {cfg.num_layers}, "
        f"{engine.tokens_run} real tokens in {engine.positions_run} padded positions")
    profile_serve(engine, prompts, max_new, card, wall)
    del engine, params
    torch.cuda.empty_cache()
    return launches


def profile_serve(engine, prompts, max_new, card, wall_s, top=12):
    """Serve the same requests again under torch.profiler and split the
    device time by kernel: paged attention, matrix products, the rest, then
    the ``top`` kernels by device time.  The timed run (``wall_s``) is not
    profiled; the device's idle share is its busy time against that wall,
    since the profiler slows the host down several times over."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.generate(prompts, max_new_tokens=max_new, strict=False)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"paged_attention": 0.0, "matmul": 0.0, "other": 0.0}
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append((us / 1e3, evt.count, evt.key))
        name = evt.key.lower()
        if "paged_attention" in name:
            groups["paged_attention"] += us / 1e3
        elif any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass", "sm90")):
            groups["matmul"] += us / 1e3
        else:
            groups["other"] += us / 1e3
    busy = sum(groups.values())
    if busy == 0.0:
        log("[profile] device time not measured: the profiler saw no CUDA kernels")
        return
    shares = ", ".join(f"{k} {v:.1f} ms ({v / busy:.1%})" for k, v in groups.items())
    log(f"[profile] serve under torch.profiler on {card}: device busy {busy:.1f} ms, "
        f"{busy / (wall_s * 1e3):.1%} of the unprofiled serve's {wall_s * 1e3:.1f} ms wall "
        f"(idle {1 - busy / (wall_s * 1e3):.1%}; the profiled serve took {wall_ms:.1f} ms); "
        f"{shares}")
    for ms, count, name in sorted(kernels, reverse=True)[:top]:
        log(f"[profile]   {ms:9.2f} ms {count:6d} calls  {name[:110]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------------------ phase 4
def phase_slice(seed=1):
    """2-layer full-width Mistral in fp32: kernel path on CUDA vs plain path
    on a CPU copy, same weights and KV state."""
    import torch
    from deepspeed_tpu_torch.models import mistral
    cfg = dataclasses.replace(mistral.MistralConfig.mistral_7b(), num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = mistral.init_params(cfg, gen, dtype=torch.float32, device="cuda")
    params_cpu = _to(params, "cpu")
    bs, nb = 16, 40
    kv = mistral.init_paged_cache(cfg, nb, bs, dtype=torch.float32, device="cuda")
    kv_cpu = mistral.init_paged_cache(cfg, nb, bs, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(seed)
    plen = [70, 33]
    maxb = 8
    tables = np.full((2, maxb), nb - 1, np.int32)
    tables[0, :6] = [3, 9, 1, 12, 20, 7]
    tables[1, :4] = [5, 30, 2, 11]
    tokens = np.zeros((2, 128), np.int32)
    for i, n in enumerate(plen):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)
    n_tokens = np.asarray(plen, np.int32)
    start = np.zeros(2, np.int32)
    worst = 0.0
    for step in range(4):
        outs = []
        for dev, p, cache in (("cuda", params, kv), ("cpu", params_cpu, kv_cpu)):
            args = [torch.from_numpy(a).to(dev) for a in (tokens, n_tokens, start, tables)]
            logits, _ = mistral.forward_paged(cfg, p, *args, cache, block_size=bs)
            last = torch.from_numpy(n_tokens.astype(np.int64) - 1).to(dev)
            outs.append(logits[torch.arange(2, device=dev), last].float().cpu())
        got, ref = outs
        err = (got - ref).abs()
        if not torch.isfinite(got).all() or (err > 2e-3 + 2e-3 * ref.abs()).any():
            raise AssertionError(f"slice step {step}: CUDA logits differ from the plain path "
                                 f"by up to {err.max().item():.3e}")
        picks_gpu, picks_cpu = got.argmax(-1), ref.argmax(-1)
        if not torch.equal(picks_gpu, picks_cpu):
            raise AssertionError(f"slice step {step}: greedy picks differ {picks_gpu.tolist()} "
                                 f"vs {picks_cpu.tolist()}")
        worst = max(worst, err.max().item())
        start = start + n_tokens
        tokens = picks_gpu.numpy().astype(np.int32)[:, None]
        n_tokens = np.ones(2, np.int32)
    # every block but the trash block, which takes the padded tokens' colliding writes
    kv_err = max((kv[k][:, :-1].cpu() - kv_cpu[k][:, :-1]).abs().max().item()
                 for k in ("k", "v"))
    log(f"[slice] mistral_7b width, 2 layers, fp32: prefill + 3 decode steps, CUDA kernel path "
        f"vs CPU plain path: max logit abs err {worst:.3e} (atol=rtol=2e-3), KV max abs err "
        f"{kv_err:.3e}, greedy picks identical")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ------------------------------------------------------------------ main
def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "deepspeed_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (deepspeed_tpu_torch/ not "
              "found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[setup] TF32 off for matmul and cuDNN: fp32 runs in full fp32")
    t_start = time.perf_counter()
    with torch.no_grad():
        card = phase_device()
        recs, max_err = phase_kernel(card)
        launches = phase_serve(card)
        phase_slice()
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s on {card}")
    dec, pre = recs["mistral_decode"], recs["mistral_prefill"]
    kernel = {"name": "paged_attention", "route": "cuda", "source": SOURCE,
              "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
              **{k: dec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
              "shape": "mistral_7b decode N=32 T=1 lengths 1-4096 bf16",
              "prefill": {k: pre[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "library_ms")}}
    log(card)
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

(``python3 chip_smoke.py --serving-worker ...`` is the serving worker that
[slice-recover] supervises; see :func:`serving_worker`.)

Phases, each of which raises (and the script exits non-zero) on failure:
  1. device: the card's name and power limit, and the build of the six
     kernel sources (nvcc, sm_90a, into deepspeed_tpu_torch/build/, one nvcc
     each, all started together) with their seconds and ptxas lines;
  2. kernel vs plain, each on CUDA tensors against its plain PyTorch version,
     with times for the kernel, the plain version, a PyTorch library call
     that computes the same function (a yardstick only; the port never calls
     it) and the card's bound for the same work:
     ``paged_attention`` at Mistral-7B and Llama-2-7B decode and prefill
     shapes, the serve's decode step and on edge cases, every chunk of fewer
     than 16 tokens on the split-K decode kernel and its merge (split
     boundaries, a window that begins inside a split, 4096 keys beside 1,
     GQA groups of 1-32, head dims 64-256), bf16/fp16 chunks of 16 or more
     tokens on the tensor-core prefill kernel, both held to
     ``flash.tensor_core_limit`` row by row (a kernel run that drops the last
     16-key block of every sequence, or the last 64 rows scaled by 1.05, and
     a decode run whose last split of every sequence is left out of the
     merge, must fail it), fp32 at 1e-4, and a split-size A/B at the Llama-2
     decode shape; speculative decoding's verify rounds (Mistral-7B, 16
     sequences of about 1,024 keys, T = 4, 5, 8 and 9 on the decode kernel,
     16 on the tensor-core kernel, fp32 T = 5); the served families' heads:
     Qwen2-7B (a GQA group of 7, head dim 128) at decode over about 1,024
     keys, T = 5, a 512-token prefill on tensor cores and fp32 decode, and
     GPT-J-6B (16 over 16, head dim 256) at decode and a 512-token prefill
     on the CUDA-core kernel, OPT-125m (12 over 12, head dim 64) at decode
     and a 512-token prefill on tensor cores; BLOOM-7b1 (32 over 32, head
     dim 128) with its ALiBi slopes at decode, T = 5 and a 512-token
     prefill, and BLOOM-176B's 112 heads on short sequences on every route,
     each BLOOM case also run without its slopes, which must fail (SDPA's
     yardstick takes the bias as a float mask); the flash forward and both backward
     kernels at the training shape (B=2, S=2048, 32 heads, head dim 128, bf16,
     causal), GQA, sq < sk, sq > sk (rows that see no key), non-causal, head
     dim 64 and unaligned lengths, BERT-base's non-causal attention (B=8,
     S=512, 12 heads, head dim 64, bf16), Phi-2's (32 heads of 80) and
     GPT-J-6B's (16 heads of 256) attention at B=2, S=2048, bf16, causal and
     their edges in fp32, bf16 and fp16, bf16/fp16 forward, dK/dV and dQ on tensor
     cores held to ``flash.tensor_core_limit`` row by row (and a late query
     tile of out or dQ scaled by 1.05 or the last key tile of dK/dV zeroed
     must fail it), fp32 on CUDA cores at 1e-4, and at head dims 80 and 256
     every output with columns 64-79 or 128-255 zeroed must fail its check;
     the fused AdamW kernel over
     the training run's
     largest leaf (w_gate of 8 layers, 360.7 M elements) with an fp32 and a
     bf16 grad; the three block-sparse kernels at the sparse training shape
     (B=1, S=4096, 32 heads, head dim 128, bf16, causal, the documented
     ``fixed`` layout at block 16, and at blocks 64 and 128), GQA, a padded
     tail, non-causal bigbird, blocks 24 and 8, bf16/fp16 forward, dK/dV and
     dQ on tensor cores held to ``flash.tensor_core_limit`` row by row
     (dK/dV with the last layout block or a local-only key tile zeroed, dQ
     and out with their last 64 rows scaled by 1.05, and the forward on K/V
     whose last layout block is zeroed, must fail it), fp32 at 1e-4, and the
     tensor-core kernels timed with their tiles launched longest walk first
     against index order; the
     AdamW-8bit kernel over the
     same w_gate leaf with an fp32 and a bf16 grad, and a tail group; the
     int8 quantize kernel over the full-depth Llama-2-7B w_gate leaf (1.443 G
     bf16 elements, groups of 2048, the v1 engine's weight-only path) and on
     small cases (groups of 5-16384, tails, a zero group, fp32 and fp16); the
     fused Lion kernel over the 8-layer w_gate leaf, fp32 and bf16 grads;
     both bit for bit;
  3. serve: ``build_engine("mistral", MistralConfig.mistral_7b(), ...)`` in
     bf16 with seeded random weights answers 16 requests through greedy
     ``generate`` on the serving fast path (device-resident batch state,
     pipelined dispatch, fused decode bursts, every bucket forward and burst
     step replayed from a captured CUDA graph), and every forward step goes
     through the kernel: the tensor-core prefill kernel at every step whose
     padded chunk is 16 tokens or more, the split-K decode kernel at every
     other, counted under replay; the fast path's counters, captures and
     graph pool; a second serve of the same prompts captures nothing and
     gives the same tokens; serve-tracing: a second engine with request
     tracing on serves the same prompts cold and then warm in turns with the
     first, with ServeCounters and tokens equal to the untraced serves', a
     complete span chain ending ok for each request and a Chrome trace with
     one track per request and the kv_pool counter track, and prints the
     TTFT, TBT, end-to-end and queue-wait percentiles and the wall with
     tracing on and off; serve-perf, serve-ops, serve-telemetry: three more
     engines, each with one observability feature on (the perf observatory;
     the ops endpoint with a thread scraping it; a telemetry collector with
     a torch.profiler serve window), cold and then warm in turns with the
     feature-off engine, ServeCounters and tokens equal to its serves:
     phase spans summing to the wall, no warm recompile, every dispatch
     costed (roofline and burst share printed), mid-serve scrapes that
     strict-parse with the counters the engine holds, /healthz equal to
     health(), gauge and per-request trace records, and a Chrome trace that
     names the paged decode and prefill kernels; the same serve again under
     torch.profiler splits
     the device time by kernel (decode, merge, prefill and the CUDA-core
     kernel apart); the reference loop (``serving_fastpath.enabled=False``)
     and the fast path serve the same prompts in two pairs, in turns,
     after one untimed serve of the reference; with
     nothing shared between the prompts the prefix cache (on by default)
     leaves the loop's 62 forward steps and 47 host syncs as they were;
     serve-journal: the warm engine serves the prompts with the request
     journal on (throughput mode) and off, with ServeCounters and tokens
     equal and the journal replaying to 16 ok entries equal to the results;
     serve-recover: an in-process ``ServingSupervisor`` over engines on the
     same params, the first crashing at its journal's 2nd writing flush, one
     restart, 16 ok, every journaled prefix kept, and the recovery's wall;
     serve-prefix: the same engine serves 16 requests behind one
     1024-token system prompt (tails of 32-256 tokens) and two that are
     exactly the prompt, in 4 waves put while the wave before decodes,
     through ``put`` / ``step`` / ``decode_burst`` with the prefix cache on
     and off, both tracing requests (TTFT, TBT and end-to-end percentiles
     of each serve): the realized savings equal the KV observatory's
     counterfactual, the device runs exactly the positions the cache left,
     the census invariant holds, pool and prefix tree drain, and every block
     the tree registered holds its bytes until its last mapper releases it;
     two on/off pairs in turns, then one serve of each under
     torch.profiler; serve-qos: an engine with tracing and multi-tenant QoS
     on serves [serve]'s prompts in the default tenant with [serve]'s
     counters, tokens and paged launches, then an interactive tenant's 4
     prompts alone and behind a batch tenant's flood of 10 long prompts
     under a per-tenant token-rate quota: the interactive TTFT p95 within
     2x its baseline, the flood shed quota_exceeded with a finite hint and
     not blacked out, the per-tenant ledger and exposition checked;
     serve-fleet: ``FleetRouter`` over 2 replicas of the engine serves 24
     requests behind 8 shared headers in two tenants, each header's
     requests on its affinity home with prefix hits there, placement and
     hit blocks equal to the CPU rehearsal's, no block shared across
     tenants, the fleet /metrics strict-parsed;
     serve-spec: speculative decoding on the same params and pool: the
     n-gram drafter (k 4) on the 16 prompts cold and warm (launches by
     route equal to the forwards the verify rounds add, no warm capture,
     the spec families agree with the counters), the cycling workload of
     the bench's spec A/B at full width (attention output zeroed, 16
     self-continued 512-token prompts, 128 new tokens, spec off against
     n-gram k 8, one measured pass: acceptance >= 0.5) and the target
     attached as its own drafter (k 15, the tensor-core verify; both pools
     reclaimed);
     serve-qwen2, serve-mixtral, serve-opt, serve-gptj: ``build_engine``
     under each family's key, bf16, seeded random weights, the fast path
     with graphs, at full width (Qwen2-7B, OPT-125m and GPT-J-6B at full
     depth, Mixtral-8x7B at 8 of its 32 layers); 8 prompts of 32-1,024
     tokens, 16 new tokens, a cold and a warm serve: every request ok, the
     pool reclaimed, paged launches by route equal to the forward steps by
     padded width times the layers (prefill steps on tensor cores, GPT-J's
     on the CUDA-core kernel, decode steps on split-K), the warm serve
     building nothing and giving the same tokens; tok/s, mean step, idle
     share, peak memory and graph pool printed; the same for Phi-2 and
     Falcon-7B, and for BLOOM-7b1 through ``InferenceEngineV2(bloom, ...)``
     (serve-bloom: ALiBi on the paged kernel's slopes operand), whose
     weights then serve-v1-bloom serves through ``init_inference`` (8
     prompts of 512 tokens, 64 new; no kernel launched);
  4. slice: a 2-layer, full-width Mistral in fp32, one prefill and three
     decode steps of ``forward_paged`` on CUDA (kernel) and on a CPU copy
     (plain path) with the same weights and KV; slice-serve: the same width
     through ``InferenceEngineV2``, the fast path with graphs, the reference
     loop eager on CUDA and the fast path on the CPU token for token on a
     closed batch and on requests arriving mid-decode, the prewarm's
     captures leaving every KV block but the trash block unchanged, a
     sampled burst equal to sampled steps, and the same scenario with
     tracing on under a fake clock: trace records, terminal statuses and
     percentiles of the graphs on CUDA equal to the fast path's on the CPU,
     and of the eager reference loop on CUDA equal to the CPU's;
     slice-prefix: the serve-prefix workload at 2 layers in fp32 with a
     192-token header and waves of 2,
     graphs, eager and CPU with the cache on and off, token for token, the
     logits of every dispatched emit on the card within 2e-3 of the CPU's;
     slice-recover: slice-serve's engine crashed and recovered, in process
     and over worker processes under ``supervise_command`` (a crash leaving
     a torn frame, a hang found by heartbeat staleness, the restart budget
     spent and every request finalized failed), the recovered tokens equal
     to the uninterrupted run on the card and on the CPU, no worker left,
     and the crash case's supervisor serving the fleet /metrics (workers
     publishing under its DSTPU_OPS_DIR) with a completed-requests counter
     that never goes down across the restart; slice-fleet: three replicas
     of that engine behind ``FleetRouter``, one crashing mid-decode past
     its restart budget: every request ok and token-identical to an
     uninterrupted engine, its journaled work migrated, none lost, the
     fleet counters monotone, prefix hits on the affinity home, a quota
     shed surfaced and not re-routed; slice-spec: ``spec_decode_smoke``'s
     contract at the slice's width: greedy spec on equal to spec off under
     25 % allocator faults and under expiring deadlines, the sampler's
     marginal on the card within TV 0.08, health and families agreeing,
     the target as its own drafter accepting every draft; slice-families:
     each family at its serve's width and 2 layers in fp32, on the card:
     ``forward_paged`` through the kernel against the same function with
     the plain paged version (a prefill chunk and two decode steps, 1e-4),
     and the fast path with graphs against the eager reference loop, token
     for token; BLOOM also its v1 ``forward_with_cache`` on the card
     against the CPU (a prefill and 3 decode steps, greedy picks equal);
  5. train: ``initialize`` with Llama-2-7B at full width cut to 8 layers, bf16,
     remat, fused AdamW, WarmupLR, clipping; 6 optimizer steps of 2 x 2 x 2048
     tokens through the flash and fused-AdamW kernels, launch counts checked
     against the step formula (every flash forward, dK/dV and dQ launch a
     tensor-core one), one more step under torch.profiler; train-telemetry:
     a fresh engine on the same config with telemetry (a record a step, the
     first step's FLOPs counted by FlopCounterMode, each flash launch adding
     its plain version's, and held to the count from the shapes, mfu
     against the peak named by the device) and the ops
     endpoint, 6 steps, a torch.profiler step window (the steps neither
     profiled nor writing its trace timed apart, the trace export alone);
     both under LlamaConfig's default remat policy
     (``dots_with_no_batch_dims_saveable``: the x @ W outputs kept);
     train-remat: the same model, params and batch under
     ``nothing_saveable``, ``dots_saveable`` and ``offload_inputs`` (3
     steps each, one engine at a time): step-1 loss and grad norm equal
     [train]'s bit for bit, launches by each policy's formula, the products
     a micro-batch's backward reruns, the layer inputs parked in pinned host
     memory and the micro-batch peak they take off the card; train-data: 64
     seeded documents written and read as an ``MMIDIDX`` dataset and trained
     through ``initialize(training_data=)`` at 4 layers with
     ``data_efficiency`` (a seqlen curriculum 1024 -> 2048, random-LTD
     keeping 512 -> 1536 tokens of the two middle layers, flash at those
     lengths), the watchdog and the heartbeat, 8 steps: the schedules, the
     launch formula, a loader resumed at step 3, the heartbeat's last step,
     the fp32 kernels against the plain attention with one fixed index set,
     and the Hessian eigenvalue (equal to the CPU's; refused through flash);
     host-ops (after train): the two host libraries built with g++, the
     host C++ CPU-Adam over the 8-layer w_gate leaf against its plain
     version, ``torch.optim.AdamW(fused=True)`` on CPU tensors and its bound
     (28 B an element at the host's copy rate), 1 GiB written and read
     through the aio library, whether the temp dir's filesystem takes
     O_DIRECT, the host CPU and its threads; train-offload: [train]'s run
     under ``offload_optimizer: {device: cpu, pin_memory: true}``, 3 steps:
     step 1's loss bit for bit [train]'s, then within a bf16 limit, sampled
     params within the Adam rule of [train]'s at step 3, [train]'s flash
     launches, no fused AdamW, the step split (device, grads to host,
     CPU-Adam, push) and peak memory beside [train]'s; train-infinity:
     ``offload_param: nvme`` with the moments in RAM at 2 full-width layers,
     micro 1 x 2048, 3 steps through ``initialize(layer_fn=, stem_fn=,
     head_fn=)``: losses and params against a resident engine over the same
     composition, parameter files only on disk, 2 flash forwards, 1 dK/dV
     and 1 dQ a layer and step, disk bytes and the step split;
     train-universal: a narrow Llama offloaded 2 steps, saved, converted by
     the CLI's ``universal.main`` (in process), resumed by a
     resident and an offloaded engine with ``load_universal_checkpoint``:
     the third step against the unbroken run; train-hybrid: a
     ``DeepSpeedHybridEngine`` on [train]'s model, config and batch with
     LoRA (rank 16, wq and wv): greedy rollouts, two steps, the flip, the
     rollouts again, fuse/unfuse/fuse, a step; served logits bit for bit
     the current weights' (a stale leaf planted across the flip must fail
     that), one inference engine, the train step on the base weights,
     launches by part, the peak and the flip's memory, one step through
     the FLOPs profiler with its per-module table; compress: every method
     of ``init_compression`` on [train]'s shapes (kept shares, levels,
     untouched leaves), ``redundancy_clean`` to a 4-of-8-layer student
     trained 2 steps; profile: a small Llama's step counted on the card and
     the CPU (equal), and [train-hybrid]'s against the shapes' count;
     evoformer: Evoformer attention at an MSA shape, card against CPU,
     forward and gradients in fp32 and bf16;
  6. train-8bit: the same run with ``fused_adam8bit`` (int8 moments) through
     the AdamW-8bit kernel; train-sparse: the config's ``sparse_attention``
     section (DeepSpeed's documented ``fixed`` example, unidirectional) with
     ``fused_adam8bit``, micro 1 x gas 2 x seq 4096, through the three sparse
     kernels (every forward, dK/dV and dQ launch a tensor-core one) and no flash
     launch; each with launch counts checked against the step formula and
     one more step under torch.profiler;
  7. train slice: 1 full-width layer in fp32, sequences of 128 tokens, the
     CUDA engine (kernels) against the CPU engine (plain versions) from the
     same params: losses, step-1 grads and the params after 2 steps; once
     with fused_adam and dense attention, followed on the same two engines
     by one fused Lion step through ``fused_lion_flat`` on every leaf
     (train-slice-lion), once with the sparse section and fused_adam8bit;
     train-dense:
     GPT-2-350m (S=1024), BERT-base (S=512, no mask) and Phi-2 (S=2048, head
     dim 80) at full width and depth and GPT-J-6B (S=2048, head dim 256) at
     full width and 8 of its 28 layers, in bf16, 5 steps each through the
     flash kernels (causal and non-causal) and fused AdamW, launch counts
     against the step formula, BERT once more with a padding mask (no flash
     launch); each at 2 layers in fp32 on the card against the CPU (forward
     and grads), BERT with a mask (a token behind it changes no unmasked
     logit), and Mistral-7B's windowed dense forward at 2 layers;
     train-resume: Llama-2-7B width at 2 layers in bf16 with fused_adam and
     with fused_adam8bit, 4 unbroken steps against 2 + save_checkpoint + a
     fresh engine from another seed + load_checkpoint + 2, bit for bit, the
     resumed launches against the step formula, a truncated leaf refused
     and fallback_to_valid taking the earlier tag, save and load GB/s,
     get_fp32_params and the save_16bit_model header; train-fp16: the same
     model in fp16 with a dynamic loss scale from 2**32: skipped steps
     launch no fused AdamW and halve the scale, then falling losses, fp16
     flash on tensor cores, a mid-run checkpoint resumed bit for bit;
  8. serve-v1: ``init_inference`` with Llama-2-7B at full width and depth in
     bf16, 8 prompts of 512 tokens, 64 greedy new tokens through
     ``generate``; serve-v1-int8: the same with weight-only int8 (11 leaves
     packed by the quantize kernel at construction, one layer dequantized at
     a time), its logits against the dense engine's and its peak memory
     against the dense one's; slice-v1: a 2-layer full-width v1 engine in
     fp32, dense and int8, on CUDA against the same engine on the CPU.

fp32 matrix products and convolutions run in full fp32 (TF32 is switched
off), so fp32 comparisons differ only by the order of summation.  Each
phase's seconds are logged on a ``[seconds]`` line of their own.  The last
lines are the host libraries' JSON record (``[host-ops] {...}``), the card's
name and power limit, the kernels' JSON record, then ``{"ok": true,
"device": ...}``.
"""

import collections
import contextlib
import dataclasses
import json
import os
import re
import shutil
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
FLASH_SOURCE = "deepspeed_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {  # bodies in deepspeed_tpu/ops/attention/flash.py (pallas_call at :104, :252, :285)
    "flash_fwd": "deepspeed_tpu/ops/attention/flash.py:37",
    "flash_bwd_dkdv": "deepspeed_tpu/ops/attention/flash.py:133",
    "flash_bwd_dq": "deepspeed_tpu/ops/attention/flash.py:177",
}
FLASH_VARIANTS = {
    "flash_fwd": "tensor cores for bf16/fp16 (wgmma; 64-key tiles at head dim 256, head dim 80 "
                 "in two 64-column swizzle blocks), CUDA cores for fp32",
    "flash_bwd_dkdv": "tensor cores for bf16/fp16 (mma.sync m16n8k16; at head dim 256 8 warps "
                      "a block, P^T and dS^T through shared memory), CUDA cores for fp32 "
                      "(32-row tiles at 256)",
    "flash_bwd_dq": "tensor cores for bf16/fp16 (mma.sync m16n8k16; at head dim 256 8 warps a "
                    "block, dS through shared memory), CUDA cores for fp32 (32-row tiles at "
                    "256)",
}
ADAM_SOURCE = "deepspeed_tpu_torch/csrc/fused_adam.cu"
ADAM_REPLACES = "deepspeed_tpu/ops/adam/fused_adam.py:53"  # _adamw_kernel, pallas_call at :41
SPARSE_SOURCE = "deepspeed_tpu_torch/csrc/sparse_attention.cu"
SPARSE_REPLACES = {  # bodies in deepspeed_tpu/ops/sparse_attention/attention.py (pallas_call at :155, :307, :340)
    "sparse_fwd": "deepspeed_tpu/ops/sparse_attention/attention.py:75",
    "sparse_bwd_dkdv": "deepspeed_tpu/ops/sparse_attention/attention.py:170",
    "sparse_bwd_dq": "deepspeed_tpu/ops/sparse_attention/attention.py:217",
}
ADAM8_SOURCE = "deepspeed_tpu_torch/csrc/adam8bit.cu"
ADAM8_REPLACES = "deepspeed_tpu/ops/adam/adam8bit.py:59"  # _adamw8_kernel, pallas_call at :118
QUANT_SOURCE = "deepspeed_tpu_torch/csrc/quantize.cu"
QUANT_REPLACES = "deepspeed_tpu/ops/quantizer/quantize.py:27"  # _quant_kernel, pallas_call at :56
LION_REPLACES = "deepspeed_tpu/ops/adam/fused_adam.py:90"  # _lion_kernel, pallas_call at :41
KERNEL_SOURCES = ("paged_attention", "flash_attention", "fused_adam", "sparse_attention",
                  "adam8bit", "quantize")
TRAIN_LAYERS = 8  # Llama-2-7B width; 32 layers' fp32 state (~108 GB) exceeds one card
W_GATE = TRAIN_LAYERS * 4096 * 11008  # the [train] run's stacked w_gate leaf, one launch
W_GATE_FULL = 32 * 4096 * 11008  # Llama-2-7B's stacked w_gate leaf, the quantize kernel's case
# DeepSpeed's documented sparse_attention example (config-json docs), causal for Llama
SPARSE_CONFIG = {"mode": "fixed", "block": 16, "different_layout_per_head": True,
                 "num_local_blocks": 4, "num_global_blocks": 1,
                 "num_different_global_patterns": 4, "horizontal_global_attention": False,
                 "attention": "unidirectional"}


def log(*parts):
    print(*parts, flush=True)


@contextlib.contextmanager
def phase_timer(tag):
    """Log the seconds a phase took, on a line of its own."""
    t0 = time.perf_counter()
    yield
    log(f"[seconds] [{tag}] {time.perf_counter() - t0:.1f} s")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phase 1
def phase_device():
    import torch

    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.adam import adam8bit, fused_adam
    from deepspeed_tpu_torch.ops.attention import flash, paged
    from deepspeed_tpu_torch.ops.quantizer import quantize
    from deepspeed_tpu_torch.ops.sparse_attention import attention as sparse
    card = nvidia_smi_line()
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all(KERNEL_SOURCES + HOST_SOURCES)  # the host libraries' g++ beside nvcc
    paged._lib(), flash._lib(), fused_adam._lib(), sparse._lib(), adam8bit._lib(), quantize._lib()
    log(f"[device] {len(KERNEL_SOURCES)} kernel libraries and {len(HOST_SOURCES)} host "
        f"libraries ready in {time.perf_counter() - t0:.2f} s, built in parallel")
    for name in KERNEL_SOURCES:
        log(f"[device] {name}: nvcc {_build.build_seconds.get(name, 0.0):.2f} s")
        for line in _build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[device] ptxas: {line.strip()}")
    for source, kernels in USAGE_KERNELS.items():
        for kernel, (regs, spill) in sorted(ptxas_usage(_build.build_log[source], kernels)
                                            .items()):
            log(f"[device] ptxas {kernel}: {regs} registers, {spill} bytes spill stores")
    return card


PAGED_TYPES = {"f": "float", "13__nv_bfloat16": "bf16", "6__half": "fp16"}
# the kernels whose instances [device] lists one a line, by source; the last
# template argument of a CUDA-core flash backward instance is its tile
USAGE_KERNELS = {
    "paged_attention": ("paged_prefill_tc_kernel", "paged_attention_kernel",
                        "paged_decode_kernel"),
    "flash_attention": ("flash_fwd_tc_kernel", "flash_bwd_dkdv_tc_kernel",
                        "flash_bwd_dkdv_tc_wide_kernel", "flash_bwd_dq_tc_kernel",
                        "flash_bwd_dq_tc_wide_kernel", "flash_fwd_kernel",
                        "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"),
}


def ptxas_usage(build_log, kernels):
    """{"<kernel><type, head dim[, n]>": (registers, spill-store bytes)} of
    the named kernels' instances from nvcc's ``-Xptxas -v`` output: an
    entry's "Compiling entry" line, then its spill line and its "Used N
    registers" line."""
    usage, entry, spill = {}, None, 0
    pattern = re.compile(r"Compiling entry function '\S*?(" + "|".join(kernels)
                         + r")I(\w+?)Li(\d+)E(?:Li(\d+)E)?")
    for line in build_log.splitlines():
        found = pattern.search(line)
        if "Compiling entry" in line:
            rows = f", {found.group(4)}" if found and found.group(4) else ""
            entry = (f"{found.group(1)}<{PAGED_TYPES.get(found.group(2), found.group(2))}, "
                     f"{found.group(3)}{rows}>" if found else None)
        elif entry and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif entry and "registers" in line:
            usage[entry] = (int(re.search(r"Used (\d+) registers", line).group(1)), spill)
            entry = None
    return usage


# ------------------------------------------------------------------ phase 2
def make_case(seed, *, N, T, H, KV, Dh, bs, lengths, n_tokens, dtype, window=None,
              alibi=False, slopes=None):
    """Random q and pools, each sequence's blocks scattered over the pool,
    padded table slots pointing at the trash block (the last one).  ALiBi
    with ``slopes`` [H] (BLOOM's) or, with ``alibi``, 2^(-8 (h + 1) / H)."""
    import torch
    rng = np.random.default_rng(seed)
    if slopes is None and alibi:
        slopes = [2.0**(-8.0 * (h + 1) / H) for h in range(H)]
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
        "alibi_slopes": (None if slopes is None else
                         torch.from_numpy(np.asarray(slopes, np.float32)).to(dev)),
        "block_size": bs, "window": window,
    }
    return case


def run_kernel(c):
    from deepspeed_tpu_torch.ops.attention.paged import paged_attention
    return paged_attention(c["q"], c["kpool"], c["vpool"], c["tables"], c["lengths"],
                           c["start_pos"], c["n_tokens"], block_size=c["block_size"],
                           window=c["window"], alibi_slopes=c["alibi_slopes"])


def run_plain(c, round_to=None, fp32=False):
    """The plain version on the case's inputs, or (``fp32``) on fp32 copies of
    them; ``round_to`` rounds P as the tensor-core kernel does."""
    from deepspeed_tpu_torch.ops.attention.paged import paged_attention_reference
    dh = c["q"].shape[-1]
    q, kpool, vpool = ((x.float() if fp32 else x) for x in (c["q"], c["kpool"], c["vpool"]))
    return paged_attention_reference(q, kpool, vpool, c["tables"], c["lengths"], c["start_pos"],
                                     c["n_tokens"], 1.0 / np.sqrt(dh), c["window"],
                                     c["alibi_slopes"], round_to=round_to)


def paged_variant(c):
    """The route the case takes by the wrapper's own rule: "decode" (split-K
    decode kernel and merge), "prefill_tc" or "cuda_core"."""
    from deepspeed_tpu_torch.ops.attention.paged import paged_route
    return paged_route(c["q"].dtype, c["q"].shape[1])


ROUTE_NAMES = {"decode": "split-K decode", "prefill_tc": "tensor-core prefill",
               "cuda_core": "CUDA-core"}
# a paged case's record in the kernels line: the times, and the bound
PAGED_FIELDS = ("ms", "graph_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")


def decode_parts(c, keys=None):
    """The split-K decode kernel's partials for the case, at the wrapper's
    split (or ``keys`` a split): (ml, acc, keys)."""
    from deepspeed_tpu_torch.ops.attention import paged
    q, kpool = c["q"], c["kpool"]
    bs = c["block_size"]
    if keys is None:
        keys, _ = paged.decode_split(c["tables"].shape[1] * bs, bs, q.shape[0], kpool.shape[1],
                                     paged._row_blocks(q, kpool), paged._sms(q.device))
    splits = -(-c["tables"].shape[1] * bs // keys)
    ints = (c["tables"], c["lengths"], c["start_pos"], c["n_tokens"])
    ml, acc = paged._decode_partials(q, kpool, c["vpool"], ints, c["alibi_slopes"],
                                     1.0 / np.sqrt(q.shape[-1]), c["window"], keys, splits)
    return ml, acc, keys


def last_split_dropped(c):
    """The decode kernel's run with each sequence's last split that holds a
    live key left out of the (kernel) merge."""
    from deepspeed_tpu_torch.ops.attention import paged
    ml, acc, keys = decode_parts(c)
    for n, length in enumerate(c["lengths"].tolist()):
        if length > 0:
            last = (length - 1) // keys
            ml[n, :, :, last, 0] = -1e30
            ml[n, :, :, last, 1] = 0.0
            acc[n, :, :, last] = 0.0
    return paged._merge(ml, acc, c["n_tokens"], c["q"].dtype)


def late_rows_scaled(got, n_tokens, rows=64, factor=1.05):
    """``got`` with the last ``rows`` live (token, head) rows of every
    sequence scaled by ``factor``: a late tile gone wrong."""
    import torch
    bad = got.clone(memory_format=torch.contiguous_format)
    n, t, h, d = got.shape
    flat = bad.view(n, t * h, d)
    for i, ntok in enumerate(n_tokens.tolist()):
        lo = max(0, ntok * h - rows)
        flat[i, lo:ntok * h] = (flat[i, lo:ntok * h].float() * factor).to(bad.dtype)
    return bad


def width_faults(c, got):
    """The failures a kernel that covered only 32-divisible widths or 32-row
    head blocks would show: at head dim 80 ``got`` with columns 64-79
    zeroed; at a GQA group of 71 with q heads 64-70 of every kv head
    zeroed.  Empty for other shapes."""
    n, t, h, d = got.shape
    group = h // c["kpool"].shape[1]
    faults = {}
    if d == 80:
        bad = got.clone()
        bad[..., 64:] = 0
        faults["columns 64-79 zeroed"] = bad
    if group == 71:
        bad = got.clone()
        bad.view(n, t, h // group, group, d)[:, :, :, 64:] = 0
        faults["heads 64-70 zeroed"] = bad
    return faults


def slope_faults(name, c):
    """A BLOOM case's kernel run without its ALiBi slopes: the failure a
    wrapper or model that lost the operand would show.  Empty for other
    cases."""
    if "bloom" not in name:
        return {}
    return {"slopes dropped": run_kernel(dict(c, alibi_slopes=None))}


def compare(name, c):
    """The kernel once against its plain version.  fp32 at atol=rtol 1e-4;
    bf16/fp16 held to ``flash.tensor_core_limit`` row by row (a row is one
    (sequence, token, q head) over Dh) against the plain version on fp32
    copies, with ``rounded`` the plain version that rounds P to the kernel's
    type for the tensor-core prefill kernel, and no rounding (the limit is an
    ulp of the store) for the split-K decode and CUDA-core kernels.  The
    limit must reject the kernel run with the last 16-key block of every
    sequence dropped, the last 64 live rows of every sequence scaled by 1.05
    and, for the decode kernel, the last split of every sequence left out of
    the merge.  At head dim 80 and at a group of 71 the check (either one)
    must also reject :func:`width_faults`, and a BLOOM case the kernel run
    without its slopes (:func:`slope_faults`).  Padding rows are exact
    zeros."""
    import torch
    from deepspeed_tpu_torch.ops.attention import flash
    from deepspeed_tpu_torch.ops.attention.paged import paged_attention
    route = paged_variant(c)
    tc, dec = route == "prefill_tc", route == "decode"
    variant = ROUTE_NAMES[route]
    counts = lambda: (paged_attention.launches, paged_attention.tc_launches,  # noqa: E731
                      paged_attention.decode_launches)
    before = counts()
    got = run_kernel(c)
    torch.cuda.synchronize()
    if counts() != (before[0] + 1, before[1] + tc, before[2] + dec):
        raise AssertionError(f"{name}: the {variant} kernel did not launch")
    dtype = c["q"].dtype
    if dtype == torch.float32:
        ref = run_plain(c)
        err = (got - ref).abs()
        bad = err > 1e-4 + 1e-4 * ref.abs()
        if not torch.isfinite(got).all() or bad.any():
            raise AssertionError(f"{name}: kernel disagrees with the plain version: max abs err "
                                 f"{err.max().item():.3e}, {int(bad.sum())} elements beyond "
                                 f"atol=rtol=1e-4")
        max_err, rule = err.max().item(), "atol=rtol=1e-4"
        beyond = {}
        for fault, wrong in {**width_faults(c, got), **slope_faults(name, c)}.items():
            beyond[fault] = int(((wrong - ref).abs() > 1e-4 + 1e-4 * ref.abs()).sum())
            if not beyond[fault]:
                raise AssertionError(f"{name}: atol=rtol=1e-4 passes a kernel with the {fault}")
        if beyond:
            rule += "; " + ", ".join(f"{fault}: {k} elements beyond, rejected"
                                     for fault, k in beyond.items())
    else:
        ref = run_plain(c, fp32=True)
        rounded = run_plain(c, round_to=dtype if tc else None, fp32=True)
        ok, max_err, ratio, median = flash.tensor_core_limit(got, ref, rounded)
        if not ok:
            raise AssertionError(f"{name}: {variant} kernel beyond the limit: max abs err "
                                 f"{max_err:.3e}, {ratio:.3f} of 2 max_row|rounded - ref| + eps "
                                 f"max_row|ref|")
        dropped = dict(c, lengths=(c["lengths"] - 16).clamp_min(0))
        faults = {"last 16-key block dropped": run_kernel(dropped),
                  "last 64 rows x1.05": late_rows_scaled(got, c["n_tokens"])}
        if dec:
            faults["last split left out of the merge"] = last_split_dropped(c)
        faults.update(width_faults(c, got))
        faults.update(slope_faults(name, c))
        shares = {}
        for fault, bad in faults.items():
            passed, _, shares[fault], _ = flash.tensor_core_limit(bad, ref, rounded)
            if passed:
                raise AssertionError(f"{name}: the limit passes a kernel with the {fault} "
                                     f"({shares[fault]:.3f} of it)")
        rule = (f"tensor-core limit 2 max_row|rounded - fp32| + eps max_row|fp32| with rounded = "
                f"{'P rounded to ' + str(dtype) if tc else 'no rounding (the store alone)'}, "
                f"median row limit {median:.3e}, at {ratio:.3f} of it; "
                + ", ".join(f"{fault} at {share:.2f}, rejected" for fault, share in shares.items()))
    pad = (torch.arange(got.shape[1], device=got.device)[None, :]
           >= c["n_tokens"].long()[:, None])
    if (got[pad] != 0).any():
        raise AssertionError(f"{name}: padding rows are not exact zeros")
    log(f"[kernel] {name}: ok ({variant}), max abs err {max_err:.3e} ({rule}; {dtype})")
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
    slopes = 0 if c["alibi_slopes"] is None else H * 4
    nbytes = (2 * live_keys * KV * Dh * elt + 2 * N * T * H * Dh * elt
              + c["tables"].numel() * 4 + 3 * N * 4 + slopes)
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
    (gathered outside the timed call), the ALiBi bias of an ALiBi case as a
    float ``attn_mask`` in q's type (built outside the timed call): the
    yardstick, never used by the port."""
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
    if c["alibi_slopes"] is not None:
        bias = c["alibi_slopes"].float()[None, :, None, None] * kpos[:, :, None, :].float()
        mask = torch.where(mask, bias, torch.finfo(q.dtype).min).to(q.dtype)
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)


GRAPH_CALLS = 16


def graph_ms(fn):
    """The device's time for one call of ``fn``: a CUDA graph of
    ``GRAPH_CALLS`` calls back to back, replayed, over ``GRAPH_CALLS``.  No
    host work (the wrapper's checks, the launch) lies between the calls, as
    when the v2 engine replays a step; ``time_ms`` of one eager call also
    holds the host's share, all of it for a call that takes the device a
    few microseconds."""
    import torch
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    return time_ms(graph.replay) / GRAPH_CALLS


def paged_times(card):
    """[paged-times]: one eager call (``time_ms``) and the graph-replay time
    (``graph_ms``) of each case of ``PAGED_TIMED``, with whatever
    ``deepspeed_tpu_torch`` is first on sys.path; builds only the paged
    library.  ``python3 chip_smoke.py --paged-times DIR`` puts the checkout
    in DIR first, so that two trees are compared on one card, in turns, by
    the same cases and clocks.  Prints one JSON line."""
    import torch
    from deepspeed_tpu_torch.ops.attention import paged
    log(f"[paged-times] {paged.__file__} on {card}")
    paged._lib()
    cases = paged_cases()
    out = {}
    with torch.no_grad():
        for name in PAGED_TIMED:
            c = cases[name]
            out[name] = {"ms": time_ms(lambda: run_kernel(c)),
                         "graph_ms": graph_ms(lambda: run_kernel(c))}
    log(json.dumps({"paged_times": out, "package": paged.__file__}))
    return 0


def measure(name, c):
    import torch
    nbytes, flops = work(c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(c["q"].dtype)] * 1e3
    rec = {
        "ms": time_ms(lambda: run_kernel(c)),
        "graph_ms": graph_ms(lambda: run_kernel(c)),
        "plain_ms": time_ms(lambda: run_plain(c)),
        "library_ms": time_ms(library_call(c)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }
    torch.cuda.synchronize()
    log(f"[kernel] {name}: kernel_ms {rec['ms']:.4f} (graph replay {rec['graph_ms']:.4f}) "
        f"plain_ms {rec['plain_ms']:.4f} library_ms {rec['library_ms']:.4f} bound_ms "
        f"{rec['bound_ms']:.4f} ({rec['bound_by']}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP)")
    return rec


def paged_cases():
    """The paged cases of [kernel], by name: Mistral-7B and Llama-2-7B decode
    and prefill, the small edges, the tensor-core prefill kernel's edges,
    the decode kernel's, the verify rounds, the families' heads and the
    CUDA-core kernel's fp32 chunks."""
    import torch
    rng = np.random.default_rng(0)
    bf16, fp16 = torch.bfloat16, torch.float16
    decode_lengths = np.concatenate([[1, 4096], rng.integers(1, 4097, 30)])
    mistral = dict(H=32, KV=8, Dh=128, bs=16, window=4096)
    llama2 = dict(H=32, KV=32, Dh=128, bs=16)
    cases = {
        "mistral_decode": make_case(1, N=32, T=1, lengths=decode_lengths, n_tokens=[1] * 32,
                                    dtype=bf16, **mistral),
        "mistral_prefill": make_case(2, N=2, T=512, lengths=[2048, 700], n_tokens=[512, 300],
                                     dtype=bf16, **mistral),
        "llama2_decode": make_case(3, N=32, T=1, lengths=decode_lengths, n_tokens=[1] * 32,
                                   dtype=bf16, **llama2),
        "llama2_prefill": make_case(9, N=2, T=512, lengths=[2048, 700], n_tokens=[512, 300],
                                    dtype=bf16, **llama2),
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
    # the tensor-core prefill kernel's edges: chunk starts off the 64-key
    # tile, T = 16 / 20 / 64 / 512, blocks of 8-128 keys, head dims 32, 64,
    # 128 and 256 (32-key tiles), GQA groups of 1, 4, 8, 32, 64 and 128 (MQA;
    # a token's heads over two row blocks), a window, ALiBi, zero-length rows
    # and a decode row padded into a 512-token step
    prefill_edges = {
        "t16_bs8_d64_gqa4_window": dict(N=3, T=16, H=8, KV=2, Dh=64, bs=8, lengths=[37, 100, 0],
                                        n_tokens=[16, 5, 0], window=20),
        "t64_bs16_d128_mha_alibi": dict(N=3, T=64, H=4, KV=4, Dh=128, bs=16,
                                        lengths=[64, 200, 77], n_tokens=[64, 64, 13], alibi=True),
        "t512_bs64_d128_gqa8_window_decode_row": dict(N=3, T=512, H=16, KV=2, Dh=128, bs=64,
                                                      lengths=[1000, 777, 300],
                                                      n_tokens=[512, 1, 0], window=300),
        "t64_bs64_d64_mqa8_alibi_window": dict(N=2, T=64, H=8, KV=1, Dh=64, bs=64,
                                               lengths=[130, 50], n_tokens=[64, 50], alibi=True,
                                               window=40),
        "t16_bs16_d128_gqa4_mistral": dict(N=2, T=16, H=32, KV=8, Dh=128, bs=16,
                                           lengths=[2000, 16], n_tokens=[16, 16], window=4096),
        "t16_bs16_d128_mqa32": dict(N=2, T=16, H=32, KV=1, Dh=128, bs=16, lengths=[300, 17],
                                    n_tokens=[16, 3]),
        "t32_bs128_d64_mqa64_alibi": dict(N=2, T=32, H=64, KV=1, Dh=64, bs=128,
                                          lengths=[290, 40], n_tokens=[32, 7], alibi=True),
        "t16_bs16_d256_gqa4_window": dict(N=3, T=16, H=8, KV=2, Dh=256, bs=16,
                                          lengths=[40, 300, 0], n_tokens=[16, 9, 0], window=100),
        "t20_bs8_d32_alibi_window": dict(N=3, T=20, H=4, KV=4, Dh=32, bs=8, lengths=[20, 57, 300],
                                         n_tokens=[20, 11, 1], alibi=True, window=30),
        "t16_bs16_d64_mqa128": dict(N=2, T=16, H=128, KV=1, Dh=64, bs=16, lengths=[100, 16],
                                    n_tokens=[16, 16]),
    }
    for seed, (edge, kw) in enumerate(prefill_edges.items(), start=100):
        for dtype, tag in ((bf16, "bf16"), (fp16, "fp16")):
            cases[f"prefill_{edge}_{tag}"] = make_case(seed, dtype=dtype, **kw)
    cases.update(decode_edges())
    cases.update(verify_cases())
    cases.update(family_cases())
    cases.update(bloom_cases())
    # the CUDA-core kernel's chunks (fp32 at T >= 16): the fp32 slice's
    # Mistral-width prefill, head dim 256, Phi-2's heads (32 over 32 at head
    # dim 80: a lane's third column masked) and Falcon-7B's (71 over 1 at
    # head dim 64: a token's heads across 32-row blocks)
    cuda_core_edges = {
        "cuda_core_slice_t128_fp32": dict(N=2, T=128, lengths=[70, 33], n_tokens=[70, 33],
                                          dtype=torch.float32, **mistral),
        "cuda_core_t64_d256_mha_fp32": dict(N=2, T=64, H=4, KV=4, Dh=256, bs=32,
                                            lengths=[64, 500], n_tokens=[64, 37],
                                            dtype=torch.float32),
        "cuda_core_t64_d80_mha_fp32": dict(N=2, T=64, H=32, KV=32, Dh=80, bs=16,
                                           lengths=[64, 500], n_tokens=[64, 37],
                                           dtype=torch.float32),
        "cuda_core_t32_d64_mqa71_fp32": dict(N=2, T=32, H=71, KV=1, Dh=64, bs=16,
                                             lengths=[32, 300], n_tokens=[32, 9],
                                             dtype=torch.float32),
    }
    for seed, (edge, kw) in enumerate(cuda_core_edges.items(), start=300):
        cases[edge] = make_case(seed, **kw)
    return cases


def phase_kernel(card):
    """Kernel vs plain on the card; returns the Mistral and Llama-2 decode and
    prefill measurements and the largest bf16 error at Mistral shapes."""
    from deepspeed_tpu_torch.ops.attention.paged import paged_attention
    cases = paged_cases()
    errs = {name: compare(name, c) for name, c in cases.items()}
    routes = {name: paged_variant(c) for name, c in cases.items()}
    wrong = {name: route for name, route in routes.items()
             if route != ("decode" if cases[name]["q"].shape[1] < 16
                          else "cuda_core" if name.startswith("cuda_core") else "prefill_tc")}
    if wrong or set(routes.values()) != set(ROUTE_NAMES):
        raise AssertionError(f"cases do not follow the route rule: {wrong or routes}")
    log(f"[kernel] paged cases by route: "
        + ", ".join(f"{ROUTE_NAMES[r]} {sum(v == r for v in routes.values())}"
                    for r in ROUTE_NAMES))
    recs = {name: measure(name, cases[name])
            for name in ("mistral_decode", "mistral_prefill", "llama2_decode", "llama2_prefill",
                         "serve_decode_n16", *CUDA_CORE_CASES, *MOVED_CASES, *VERIFY_CASES,
                         *FAMILY_CASES, *PHI_FALCON_CASES, *BLOOM_CASES)}
    for name, rec in recs.items():
        log(f"[kernel] {name} on {card}: {json.dumps({k: rec[k] for k in PAGED_FIELDS})}")
    for name in ("llama2_decode", "mistral_decode", "serve_decode_n16"):
        split_ab(name, cases[name])
    paged_attention.launches = paged_attention.tc_launches = paged_attention.decode_launches = 0
    return recs, max(errs["mistral_decode"], errs["mistral_prefill"])


def decode_edges():
    """The split-K decode kernel's edges (bf16 unless named): a length that
    ends exactly on a split boundary and one a key past it; a window that
    begins inside a split; one sequence of 4096 keys; a GQA group of 32 at
    T=1; the serve's decode step (N=16, lengths 32-2080, a 4096-key table);
    fp16 and fp32 at head dims 64 and 256 with blocks of 8 and 128."""
    import torch
    from deepspeed_tpu_torch.ops.attention import paged
    bf16 = torch.bfloat16
    mistral = dict(H=32, KV=8, Dh=128, bs=16)
    keys, _ = paged.decode_split(4096, 16, 8, 8, 1, paged._sms("cuda"))
    rng = np.random.default_rng(7)
    edges = {
        "decode_split_boundary": dict(N=8, T=1, lengths=[keys, 2 * keys, keys + 1, 2 * keys - 1,
                                                         1, 4096, 64, 0],
                                      n_tokens=[1] * 7 + [0], dtype=bf16, **mistral),
        "decode_window_in_split": dict(N=8, T=1, lengths=[4096, 3 * keys + 40, keys + 300, 700,
                                                          2 * keys, 1, 5, 4000],
                                       n_tokens=[1] * 8, dtype=bf16, window=keys // 2 + 37,
                                       **mistral),
        "decode_n1_4096": dict(N=1, T=1, lengths=[4096], n_tokens=[1], dtype=bf16, window=4096,
                               **mistral),
        "decode_group32_t1": dict(N=4, T=1, H=32, KV=1, Dh=128, bs=16, lengths=[3000, 1, 257, 0],
                                  n_tokens=[1, 1, 1, 0], dtype=bf16),
        "serve_decode_n16": dict(N=16, T=1, lengths=np.concatenate([[32, 2080],
                                                                    rng.integers(32, 2081, 14)]),
                                 n_tokens=[1] * 16, dtype=bf16, window=4096, **mistral),
        "decode_t7_gqa8_d64_bs8_alibi_fp16": dict(N=3, T=7, H=16, KV=2, Dh=64, bs=8,
                                                  lengths=[900, 7, 300], n_tokens=[7, 7, 2],
                                                  dtype=torch.float16, alibi=True, window=500),
        "decode_t1_d256_bs128_fp32": dict(N=3, T=1, H=8, KV=2, Dh=256, bs=128,
                                          lengths=[1500, 129, 128], n_tokens=[1, 1, 1],
                                          dtype=torch.float32, window=300),
    }
    cases = {name: make_case(200 + i, **kw) for i, (name, kw) in enumerate(edges.items())}
    # the serve's tables reach 256 slots (max_blocks_per_seq) whatever the lengths
    tables = cases["serve_decode_n16"]["tables"]
    trash = int(cases["serve_decode_n16"]["kpool"].shape[0]) - 1
    cases["serve_decode_n16"]["tables"] = torch.cat(
        [tables, torch.full((16, 256 - tables.shape[1]), trash, dtype=torch.int32,
                            device=tables.device)], 1).contiguous()
    return cases


# [serve-spec]'s verify shapes: a speculative round of n = 16 Mistral-7B
# sequences scores k + 1 positions each over about 1,024 keys; widths 2-15
# take the split-K decode route (rows = T x group 4: the row blocks change
# at 4 and 8, and 5 and 9 are the first odd counts the default ladders
# give), 16 the tensor-core prefill route; the fp32 case runs at the
# [slice-spec] width
VERIFY_CASES = ("verify_t4_bf16", "verify_t5_bf16", "verify_t8_bf16", "verify_t9_bf16",
                "verify_t16_bf16", "verify_t5_fp32")


def verify_cases():
    """Paged Mistral-7B verify rounds, n = 16, blocks of 16, a context of
    1,000-1,050 keys (a 4096-key window), one row padded past a short
    n_tokens: the kernel must see keys up to each row's own position."""
    import torch
    rng = np.random.default_rng(11)
    mistral = dict(N=16, H=32, KV=8, Dh=128, bs=16, window=4096)
    cases = {}
    for i, name in enumerate(VERIFY_CASES):
        t = int(name.split("_")[1][1:])
        dtype = torch.float32 if name.endswith("fp32") else torch.bfloat16
        lengths = rng.integers(1000, 1051, 16)
        n_tokens = np.full(16, t)
        n_tokens[3] = max(1, t // 2)  # a row whose tail positions merge to zeros
        cases[name] = make_case(400 + i, T=t, lengths=lengths, n_tokens=n_tokens, dtype=dtype,
                                **mistral)
    return cases


# the served families' heads that no earlier case had: Qwen2-7B (28 q heads
# over 4 kv heads, a GQA group of 7, head dim 128) at decode (16 sequences
# of about 1,024 keys), a T = 5 chunk, a 512-token prefill on tensor cores
# and fp32 decode; GPT-J-6B (16 over 16, head dim 256) at decode and a
# 512-token prefill on tensor cores (32-key tiles); OPT-125m (12 over 12,
# head dim 64) at decode and a 512-token prefill on tensor cores, the two
# bf16 routes [serve-opt] runs
FAMILY_CASES = ("qwen2_decode_n16_bf16", "qwen2_t5_n16_bf16", "qwen2_prefill_t512_bf16",
                "qwen2_decode_n16_fp32", "gptj_decode_n16_bf16", "gptj_prefill_t512_bf16",
                "opt_decode_n16_bf16", "opt_prefill_t512_bf16")
# Phi-2 (32 q heads over 32 at head dim 80) and Falcon-7B (71 over 1 at head
# dim 64) at the shapes of FAMILY_CASES: decode on the small-row instance
# (Phi) and on 9 row blocks of 8 a kv head (Falcon), a T = 5 chunk on the
# 8-row instance, a 512-token prefill on tensor cores (568 row blocks of 64
# a sequence for Falcon), Phi's fp32 decode on 32-key tiles; and the masks
# (ALiBi, a window) at head dim 80 on both bf16/fp16 routes
PHI_FALCON_CASES = ("phi2_decode_n16_bf16", "phi2_t5_n16_bf16", "phi2_prefill_t512_bf16",
                    "phi2_decode_n16_fp32", "falcon7b_decode_n16_bf16", "falcon7b_t5_n16_bf16",
                    "falcon7b_prefill_t512_bf16", "prefill_t20_bs8_d80_alibi_window_fp16",
                    "decode_t1_bs8_d80_alibi_window_fp16")
# BLOOM-7b1 (32 over 32 at head dim 128, ALiBi with BLOOM's slopes) at the
# shapes of FAMILY_CASES, timed: decode and a T = 5 chunk on the split-K
# kernel, a 512-token prefill on tensor cores, the scores gaining up to
# 2,048 x 0.84; bloom_cases() adds BLOOM-176B's 112 heads (the interleaved
# slopes of a head count that is no power of two, heads past 64) on short
# sequences, on every route
BLOOM_CASES = ("bloom7b1_decode_n16_bf16", "bloom7b1_t5_n16_bf16", "bloom7b1_prefill_t512_bf16")
CUDA_CORE_CASES = ("cuda_core_slice_t128_fp32", "cuda_core_t64_d256_mha_fp32",
                   "cuda_core_t64_d80_mha_fp32", "cuda_core_t32_d64_mqa71_fp32")
# the bf16/fp16 shapes the CUDA-core kernel served until it kept only fp32,
# timed on tensor cores: head dim 256 with GQA 4 and a window, head dim 32
# with ALiBi and a window, a group of 128
MOVED_CASES = ("prefill_t16_bs16_d256_gqa4_window_bf16", "prefill_t20_bs8_d32_alibi_window_fp16",
               "prefill_t16_bs16_d64_mqa128_bf16")
# the paged cases --paged-times times: the prefill cases (bf16/fp16, T >= 16),
# the decode cases at head dims 64, 128 and 256 and the fp32 CUDA-core chunk,
# shapes that a tree without head dim 80 or a group of 71 takes too
PAGED_TIMED = ("mistral_prefill", "llama2_prefill", "qwen2_prefill_t512_bf16",
               "opt_prefill_t512_bf16", "gptj_prefill_t512_bf16", *MOVED_CASES,
               "mistral_decode", "llama2_decode", "serve_decode_n16", "qwen2_decode_n16_bf16",
               "qwen2_t5_n16_bf16", "qwen2_decode_n16_fp32", "gptj_decode_n16_bf16",
               "opt_decode_n16_bf16", "verify_t5_bf16", "verify_t9_bf16",
               "decode_t1_d256_bs128_fp32", "cuda_core_slice_t128_fp32")


def family_cases():
    """Qwen2-7B, GPT-J-6B, OPT-125m, Phi-2 and Falcon-7B shapes, blocks of
    16: a group of 7 fills a tensor-core block with 64 rows (9 tokens x 7
    heads and one more row, so a warp's 16 rows straddle tokens and a
    token's heads straddle blocks) and cuts a token's heads across decode
    row blocks; OPT's group of 1 at head dim 64 fills a tensor-core block
    with 64 tokens of one head; Phi-2 runs head dim 80 and Falcon-7B a group
    of 71 on every route (``PHI_FALCON_CASES``)."""
    import torch
    rng = np.random.default_rng(13)
    bf16, fp32 = torch.bfloat16, torch.float32
    qwen2 = dict(H=28, KV=4, Dh=128, bs=16)
    gptj = dict(H=16, KV=16, Dh=256, bs=16)
    opt = dict(H=12, KV=12, Dh=64, bs=16)
    decode = lambda: dict(N=16, T=1, lengths=rng.integers(1000, 1051, 16),  # noqa: E731
                          n_tokens=[1] * 16)
    t5_lengths = rng.integers(1000, 1051, 16)
    t5_tokens = np.full(16, 5)
    t5_tokens[3] = 2  # a row whose tail positions merge to zeros
    prefill = dict(N=2, T=512, lengths=[2048, 700], n_tokens=[512, 300])
    shapes = {
        "qwen2_decode_n16_bf16": dict(dtype=bf16, **decode(), **qwen2),
        "qwen2_t5_n16_bf16": dict(N=16, T=5, lengths=t5_lengths, n_tokens=t5_tokens, dtype=bf16,
                                  **qwen2),
        "qwen2_prefill_t512_bf16": dict(dtype=bf16, **prefill, **qwen2),
        "qwen2_decode_n16_fp32": dict(dtype=fp32, **decode(), **qwen2),
        "gptj_decode_n16_bf16": dict(dtype=bf16, **decode(), **gptj),
        "gptj_prefill_t512_bf16": dict(dtype=bf16, **prefill, **gptj),
        "opt_decode_n16_bf16": dict(dtype=bf16, **decode(), **opt),
        "opt_prefill_t512_bf16": dict(dtype=bf16, **prefill, **opt),
    }
    phi2 = dict(H=32, KV=32, Dh=80, bs=16)
    falcon7b = dict(H=71, KV=1, Dh=64, bs=16)
    t5 = lambda: dict(N=16, T=5, lengths=t5_lengths, n_tokens=t5_tokens)  # noqa: E731
    masks = dict(N=3, H=4, KV=4, Dh=80, bs=8, lengths=[20, 57, 300], alibi=True, window=30)
    shapes.update({
        "phi2_decode_n16_bf16": dict(dtype=bf16, **decode(), **phi2),
        "phi2_t5_n16_bf16": dict(dtype=bf16, **t5(), **phi2),
        "phi2_prefill_t512_bf16": dict(dtype=bf16, **prefill, **phi2),
        "phi2_decode_n16_fp32": dict(dtype=fp32, **decode(), **phi2),
        "falcon7b_decode_n16_bf16": dict(dtype=bf16, **decode(), **falcon7b),
        "falcon7b_t5_n16_bf16": dict(dtype=bf16, **t5(), **falcon7b),
        "falcon7b_prefill_t512_bf16": dict(dtype=bf16, **prefill, **falcon7b),
        "prefill_t20_bs8_d80_alibi_window_fp16": dict(T=20, n_tokens=[20, 11, 1],
                                                      dtype=torch.float16, **masks),
        "decode_t1_bs8_d80_alibi_window_fp16": dict(T=1, n_tokens=[1, 1, 1],
                                                    dtype=torch.float16, **masks),
    })
    return {name: make_case(500 + i, **kw) for i, (name, kw) in enumerate(shapes.items())}


def bloom_cases():
    """``BLOOM_CASES`` and four BLOOM-176B cases (112 heads: decode at T = 3,
    a T = 16 prefill on tensor cores, fp32 decode, a T = 16 fp32 chunk on
    CUDA cores), blocks of 16, with the slopes of
    ``models.bloom.alibi_slopes``; the BLOOM-7b1 lengths and token counts
    are FAMILY_CASES'."""
    import torch
    from deepspeed_tpu_torch.models.bloom import alibi_slopes
    rng = np.random.default_rng(17)
    bf16 = torch.bfloat16
    b7 = dict(H=32, KV=32, Dh=128, bs=16, slopes=alibi_slopes(32))
    b176 = dict(H=112, KV=112, Dh=128, bs=16, slopes=alibi_slopes(112))
    t5_tokens = np.full(16, 5)
    t5_tokens[3] = 2  # a row whose tail positions merge to zeros
    shapes = {
        "bloom7b1_decode_n16_bf16": dict(N=16, T=1, lengths=rng.integers(1000, 1051, 16),
                                         n_tokens=[1] * 16, dtype=bf16, **b7),
        "bloom7b1_t5_n16_bf16": dict(N=16, T=5, lengths=rng.integers(1000, 1051, 16),
                                     n_tokens=t5_tokens, dtype=bf16, **b7),
        "bloom7b1_prefill_t512_bf16": dict(N=2, T=512, lengths=[2048, 700], n_tokens=[512, 300],
                                           dtype=bf16, **b7),
        "bloom176b_h112_decode_t3_bf16": dict(N=3, T=3, lengths=[40, 130, 7], n_tokens=[3, 3, 2],
                                              dtype=bf16, **b176),
        "bloom176b_h112_prefill_t16_bf16": dict(N=2, T=16, lengths=[200, 16], n_tokens=[16, 16],
                                                dtype=bf16, **b176),
        "bloom176b_h112_decode_t1_fp32": dict(N=3, T=1, lengths=[90, 1, 33], n_tokens=[1, 1, 1],
                                              dtype=torch.float32, **b176),
        "cuda_core_bloom176b_h112_t16_fp32": dict(N=2, T=16, lengths=[70, 16],
                                                  n_tokens=[16, 16], dtype=torch.float32,
                                                  **b176),
    }
    return {name: make_case(600 + i, **kw) for i, (name, kw) in enumerate(shapes.items())}


def split_ab(name, c):
    """The decode kernel and its merge at the wrapper's split size against
    half of it, twice it and one split (no split-K), in turns (rule, half,
    double, one, then back): what the split size buys."""
    from deepspeed_tpu_torch.ops.attention import paged
    rule_keys = decode_parts(c)[2]
    context = c["tables"].shape[1] * c["block_size"]
    unit = max(c["block_size"], paged.DECODE_TILE)
    half = max(unit, rule_keys // 2 // unit * unit)
    sizes = {f"rule ({rule_keys} keys)": rule_keys,
             f"half ({half} keys)": half,
             f"double ({min(context, 2 * rule_keys)} keys)": min(context, 2 * rule_keys),
             f"one split ({context} keys)": context}
    times = {label: [] for label in sizes}
    for label in list(sizes) + list(sizes)[::-1]:
        keys = sizes[label]
        times[label].append(time_ms(lambda: paged._merge(*decode_parts(c, keys)[:2],
                                                         c["n_tokens"], c["q"].dtype)))
    log(f"[kernel] {name} split size A/B (decode + merge, in turns): "
        + ", ".join(f"{label} {statistics.mean(t):.4f} ms" for label, t in times.items()))


def bound(nbytes, flops, dtype):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for the inputs' type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_case(seed, *, B, Sq, Sk, H, KV, D, dtype):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(dtype)
    return {"q": rand(B, Sq, H, D), "k": rand(B, Sk, KV, D), "v": rand(B, Sk, KV, D),
            "do": rand(B, Sq, H, D)}


def flash_backward_inputs(c, causal):
    """The plain forward's out and lse, and delta = rowsum(do * out), shared by
    the backward kernels and their plain versions."""
    from deepspeed_tpu_torch.ops.attention.flash import flash_fwd_reference
    scale = 1.0 / np.sqrt(c["q"].shape[-1])
    out, lse = flash_fwd_reference(c["q"], c["k"], c["v"], scale, causal)
    delta = (c["do"].float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return scale, lse, delta


def _rms(t):
    """Root mean square of ``t``: the typical magnitude a limit is set against."""
    return t.float().square().mean().sqrt().item()


def _max_err(name, got, ref, atol, rtol):
    """Largest |got - ref|; raises where it passes atol + rtol * |ref| or got
    is not finite."""
    import torch
    got32, ref32 = got.float(), ref.float()
    err = (got32 - ref32).abs()
    bad = err > atol + rtol * ref32.abs()
    if not bool(torch.isfinite(got32).all()) or bad.any():
        raise AssertionError(f"{name}: kernel disagrees with the plain version: max abs err "
                             f"{err.max().item():.3e}, {int(bad.sum())} elements beyond "
                             f"atol={atol:.3e} rtol={rtol} (rms of the plain result "
                             f"{_rms(ref32):.3e})")
    return err.max().item()


def check_adamw(name, bufs, plain):
    """Each of p, m, v against its plain version, at rtol 1e-6 and an atol of
    1e-6 of that buffer's own largest value, so that a v left unchanged, or
    without its (1 - beta2) g^2 term, does not pass; returns the largest
    error."""
    err = 0.0
    for part, got, ref in zip("pmv", bufs, plain):
        err = max(err, _max_err(f"{name} {part}", got, ref,
                                1e-6 * ref.abs().max().item(), 1e-6))
    return err


def compare_flash(name, c, causal):
    """Each flash kernel once against its plain version; returns the largest
    error of each kernel's outputs.  fp32 runs the CUDA-core kernels, held at
    1e-4; bf16/fp16 run the tensor-core forward, dK/dV and dQ, held to
    ``flash.tensor_core_limit`` against the fp32 plain version."""
    import torch
    from deepspeed_tpu_torch.ops.attention import flash
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    scale, lse_ref, delta = flash_backward_inputs(c, causal)
    tc = flash.uses_tensor_cores(q.dtype)
    fns = (flash.flash_fwd, flash.flash_bwd_dkdv, flash.flash_bwd_dq)
    counts = [fn.launches for fn in fns] + [fn.tc_launches for fn in fns]
    out, lse = flash.flash_fwd(q, k, v, scale, causal)
    dk, dv = flash.flash_bwd_dkdv(q, k, v, do, lse_ref, delta, scale, causal)
    dq = flash.flash_bwd_dq(q, k, v, do, lse_ref, delta, scale, causal)
    torch.cuda.synchronize()
    now = [fn.launches for fn in fns] + [fn.tc_launches for fn in fns]
    if now != [n + d for n, d in zip(counts, (1, 1, 1, tc, tc, tc))]:
        raise AssertionError(f"{name}: a flash kernel did not launch, or not the "
                             f"{'tensor-core' if tc else 'CUDA-core'} variant")
    got = {"out": out, "dk": dk, "dv": dv, "dq": dq}
    rms, err = {}, {}
    if tc:
        f = [x.float() for x in (q, k, v, do)]
        bwd_args = (*f, lse_ref, delta, scale, causal)
        refs = {"out": flash.flash_fwd_reference(*f[:3], scale, causal)[0]}
        rounded = {"out": flash.flash_fwd_reference(*f[:3], scale, causal, round_to=q.dtype)[0]}
        refs["dk"], refs["dv"] = flash.flash_bwd_dkdv_reference(*bwd_args)
        rounded["dk"], rounded["dv"] = flash.flash_bwd_dkdv_reference(*bwd_args,
                                                                      round_to=q.dtype)
        refs["dq"] = flash.flash_bwd_dq_reference(*bwd_args)
        rounded["dq"] = flash.flash_bwd_dq_reference(*bwd_args, round_to=q.dtype)
        # dQ's rows that see one key are 0 exactly: their fp32 noise needs the floor
        floors = {"dq": flash.dq_fp32_floor(*bwd_args)}
        ratios, limits, faults = {}, {}, {}
        for part in ("out", "dk", "dv", "dq"):
            ok, err[part], ratios[part], limits[part] = flash.tensor_core_limit(
                got[part], refs[part], rounded[part], floors.get(part))
            rms[part] = _rms(refs[part])
            if not ok:
                raise AssertionError(
                    f"{name} {part}: tensor-core kernel beyond the limit: max abs err "
                    f"{err[part]:.3e}, {ratios[part]:.3f} of 2 max_row|rounded - ref| + eps "
                    f"max_row|ref| (rms of the fp32 plain result {rms[part]:.3e})")
            # the limit must reject a late tile gone wrong: the last 64 rows of
            # out or dQ scaled by 1.05, the last 64 keys of dK or dV zeroed
            bad = got[part].clone()
            scaled = part in ("out", "dq")
            bad[:, -64:] = (bad[:, -64:].float() * 1.05).to(bad.dtype) if scaled else 0
            passed, _, faults[part], _ = flash.tensor_core_limit(bad, refs[part], rounded[part],
                                                                 floors.get(part))
            if passed:
                raise AssertionError(f"{name} {part}: the limit passes a faulty last tile "
                                     f"({faults[part]:.3f} of it)")
        rule = (f"out/dk/dv/dq: tensor-core limit 2 max_row|rounded - fp32| + eps "
                f"max_row|fp32| (dq: + its fp32 floor), median row limit {limits['out']:.3e}/{limits['dk']:.3e}/"
                f"{limits['dv']:.3e}/{limits['dq']:.3e}, at {ratios['out']:.3f}/"
                f"{ratios['dk']:.3f}/{ratios['dv']:.3f}/{ratios['dq']:.3f} of it; faulty last "
                f"tile (out and dq x1.05, dk/dv zeroed) at {faults['out']:.2f}/"
                f"{faults['dk']:.2f}/{faults['dv']:.2f}/{faults['dq']:.2f}, rejected")
        passes = lambda part, bad: flash.tensor_core_limit(  # noqa: E731
            bad, refs[part], rounded[part], floors.get(part))[0]
    else:
        bwd_args = (q, k, v, do, lse_ref, delta, scale, causal)
        refs = {"out": flash.flash_fwd_reference(q, k, v, scale, causal)[0],
                "dq": flash.flash_bwd_dq_reference(*bwd_args)}
        refs["dk"], refs["dv"] = flash.flash_bwd_dkdv_reference(*bwd_args)
        for part in ("out", "dk", "dv", "dq"):
            rms[part] = _rms(refs[part])
            err[part] = _max_err(f"{name} {part}", got[part], refs[part], 1e-4, 1e-4)
        rule = "CUDA cores, atol=rtol=1e-4"
        passes = lambda part, bad: bool(  # noqa: E731
            ((bad.float() - refs[part].float()).abs()
             <= 1e-4 + 1e-4 * refs[part].float().abs()).all())
    rule += flash_column_faults(name, got, passes)
    errs = {"flash_fwd": max(err["out"], _max_err(f"{name} lse", lse, lse_ref, 1e-4, 1e-4)),
            "flash_bwd_dkdv": max(err["dk"], err["dv"]),
            "flash_bwd_dq": err["dq"]}
    log(f"[kernel] {name}: ok, max abs err out/lse {errs['flash_fwd']:.3e} dk/dv "
        f"{errs['flash_bwd_dkdv']:.3e} dq {errs['flash_bwd_dq']:.3e} ({rule}; rms out "
        f"{rms['out']:.3e} dk {rms['dk']:.3e} dv {rms['dv']:.3e} dq {rms['dq']:.3e}; lse "
        f"atol=rtol=1e-4; {q.dtype}, causal={causal})")
    return errs


# the head-dim columns a flash kernel could drop at Phi-2's and GPT-J-6B's
# widths: at D = 80 the 16 past the first 64-column block (a forward that
# took D / 64 blocks would leave them out), at D = 256 the upper half
FLASH_COLUMN_FAULTS = {80: (64, 80), 256: (128, 256)}


def flash_column_faults(name, got, passes):
    """At a head dim of ``FLASH_COLUMN_FAULTS``, each of out, dK, dV and dQ
    with those columns zeroed must fail ``passes(part, faulty output)``, the
    case's own rule; returns the log's note ("" at other head dims)."""
    d = got["out"].shape[-1]
    if d not in FLASH_COLUMN_FAULTS:
        return ""
    lo, hi = FLASH_COLUMN_FAULTS[d]
    for part, out in got.items():
        bad = out.clone()
        bad[..., lo:hi] = 0
        if passes(part, bad):
            raise AssertionError(f"{name} {part}: the check passes columns {lo}-{hi - 1} zeroed")
    return f"; columns {lo}-{hi - 1} zeroed rejected on out/dk/dv/dq"


def flash_work(c, causal):
    """(bytes, operations) of each flash kernel for this case: each input read
    once and each output written once; 4 D operations per visible (query,
    key) pair forward, 8 D for dK/dV, 6 D for dQ."""
    B, Sq, H, D = c["q"].shape
    Sk, KV = c["k"].shape[1], c["k"].shape[2]
    if causal:
        pairs = sum(min(Sk, max(0, i + Sk - Sq + 1)) for i in range(Sq))
    else:
        pairs = Sq * Sk
    pairs *= B * H
    elt = c["q"].element_size()
    qo = B * Sq * H * D * elt      # one [B, Sq, H, D] tensor
    kv = B * Sk * KV * D * elt     # one [B, Sk, KV, D] tensor
    rows = B * H * Sq * 4          # one fp32 [B, H, Sq] vector
    return {"flash_fwd": (2 * qo + 2 * kv + rows, 4.0 * D * pairs),
            "flash_bwd_dkdv": (2 * qo + 4 * kv + 2 * rows, 8.0 * D * pairs),
            "flash_bwd_dq": (3 * qo + 2 * kv + 2 * rows, 6.0 * D * pairs)}


def measure_flash(name, c, causal):
    """Times of the three flash kernels, their plain versions, the bound and
    torch's scaled_dot_product_attention (forward; backward computing dq, dk
    and dv in one call) as the library yardstick."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.attention import flash
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    scale, lse, delta = flash_backward_inputs(c, causal)
    group = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt = torch.repeat_interleave(k, group, dim=2).transpose(1, 2).contiguous().requires_grad_(True)
    vt = torch.repeat_interleave(v, group, dim=2).transpose(1, 2).contiguous().requires_grad_(True)
    dot = do.transpose(1, 2).contiguous()
    with torch.no_grad():
        sdpa_fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        fwd_lib = time_ms(sdpa_fwd)
    with torch.enable_grad():
        out_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        bwd_lib = time_ms(lambda: torch.autograd.grad(out_lib, (qt, kt, vt), dot,
                                                      retain_graph=True))
    del out_lib
    runs = {
        "flash_fwd": (lambda: flash.flash_fwd(q, k, v, scale, causal),
                      lambda: flash.flash_fwd_reference(q, k, v, scale, causal), fwd_lib),
        "flash_bwd_dkdv": (lambda: flash.flash_bwd_dkdv(q, k, v, do, lse, delta, scale, causal),
                           lambda: flash.flash_bwd_dkdv_reference(q, k, v, do, lse, delta, scale,
                                                                  causal), bwd_lib),
        "flash_bwd_dq": (lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, causal),
                         lambda: flash.flash_bwd_dq_reference(q, k, v, do, lse, delta, scale,
                                                              causal), bwd_lib),
    }
    work_by_kernel = flash_work(c, causal)
    recs = {}
    for kname, (kernel, plain, library_ms) in runs.items():
        nbytes, flops = work_by_kernel[kname]
        bound_ms, bound_by = bound(nbytes, flops, q.dtype)
        ms = time_ms(kernel)
        recs[kname] = {"ms": ms, "plain_ms": time_ms(plain, runs=5), "library_ms": library_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                       "flops": flops, "tflops": flops / ms / 1e9}
        r = recs[kname]
        log(f"[kernel] {name} {kname}: kernel_ms {ms:.4f} plain_ms {r['plain_ms']:.4f} "
            f"library_ms {library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; kernel {r['tflops']:.2f} TFLOP/s)")
    # the autograd path the model runs: forward, delta, both backward kernels
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))

    def fwd_bwd():
        out = flash.flash_attention(qg, kg, vg, causal=causal)
        torch.autograd.grad(out, (qg, kg, vg), do)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        torch.autograd.grad(out, (qt, kt, vt), dot)

    with torch.enable_grad():
        both, both_lib = time_ms(fwd_bwd, runs=10), time_ms(sdpa_fwd_bwd, runs=10)
    log(f"[kernel] {name} flash_attention forward + backward (autograd): {both:.4f} ms, "
        f"sdpa {both_lib:.4f} ms")
    return recs


def measure_adamw(name, n, grad_dtype, seed):
    """The fused AdamW kernel against its plain version over one flat leaf of
    ``n`` elements; torch.optim.AdamW(fused=True).step() on an fp32 copy of the
    grad is the library yardstick (it decays p before the update, so it is the
    same work, not the same rounding)."""
    import torch
    from deepspeed_tpu_torch.ops.adam.fused_adam import (fused_adamw_flat,
                                                         fused_adamw_flat_reference)
    g = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn(n, generator=g, device="cuda") * 0.02
    m = torch.randn(n, generator=g, device="cuda") * 1e-3
    v = torch.rand(n, generator=g, device="cuda") * 1e-6
    grad = (torch.randn(n, generator=g, device="cuda") * 1e-3).to(grad_dtype)
    hyper = dict(lr=3e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.1, step=3)
    bufs = [x.clone() for x in (p, m, v)]
    plain = [x.clone() for x in (p, m, v)]
    before = fused_adamw_flat.launches
    fused_adamw_flat(*bufs, grad, **hyper)
    torch.cuda.synchronize()
    if fused_adamw_flat.launches != before + 1:
        raise AssertionError(f"{name}: the fused AdamW kernel did not launch")
    fused_adamw_flat_reference(*plain, grad, **hyper)
    err = check_adamw(name, bufs, plain)
    log(f"[kernel] {name}: ok, max abs err {err:.3e} (rtol 1e-6, atol 1e-6 x max|plain| of each "
        f"buffer; max|p| {plain[0].abs().max().item():.3e} max|m| "
        f"{plain[1].abs().max().item():.3e} max|v| {plain[2].abs().max().item():.3e}, "
        f"(1 - beta2) g^2 up to {(1 - hyper['beta2']) * grad.float().square().max().item():.3e}; "
        f"{grad_dtype} grad)")
    nbytes = n * (6 * 4 + grad.element_size())
    bound_ms, bound_by = bound(nbytes, 16.0 * n, torch.float32)
    ms = time_ms(lambda: fused_adamw_flat(*bufs, grad, **hyper))
    plain_ms = time_ms(lambda: fused_adamw_flat_reference(*plain, grad, **hyper))
    lib_p = p.clone().requires_grad_(False)
    lib_p.grad = grad.float()
    opt = torch.optim.AdamW([lib_p], lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1,
                            fused=True)
    library_ms = time_ms(opt.step)
    rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes, "max_abs_err": err}
    log(f"[kernel] {name}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}: {nbytes / 1e9:.3f} GB; kernel "
        f"{nbytes / ms / 1e6:.0f} GB/s)")
    return rec


BERT_FLASH_CASE = "bert_base_noncausal_b8_s512_bf16"
# [train-phi]'s and [train-gptj]'s attention at B = 2 (the Llama training
# shape's batch): Phi-2's 32 heads of 80, GPT-J-6B's 16 of 256 (the Llama
# shape's work, 4096 wide)
FAMILY_FLASH_CASES = {"phi": "phi2_train_causal_b2_s2048_d80_bf16",
                      "gptj": "gptj_train_causal_b2_s2048_d256_bf16"}


def phase_train_kernels(card):
    """The training path's kernels against their plain versions on the card:
    flash at the training shape, BERT-base's non-causal shape, Phi-2's and
    GPT-J-6B's training shapes (head dims 80 and 256), GQA and edge cases;
    fused AdamW over one 7B-width leaf.  Returns the measured records (the
    BERT, Phi-2 and GPT-J cases' under ``<kernel>_bert``, ``_phi``, ``_gptj``)
    and the largest errors."""
    import torch
    bf16 = torch.bfloat16
    cases = {
        "train_causal_bf16": (flash_case(11, B=2, Sq=2048, Sk=2048, H=32, KV=32, D=128,
                                         dtype=bf16), True),
        "gqa_h32_kv8_bf16": (flash_case(12, B=2, Sq=1024, Sk=1024, H=32, KV=8, D=128,
                                        dtype=bf16), True),
        "sq100_lt_sk300_d64_fp32": (flash_case(13, B=1, Sq=100, Sk=300, H=4, KV=2, D=64,
                                               dtype=torch.float32), True),
        "unaligned_s200_d128_fp16": (flash_case(14, B=2, Sq=200, Sk=200, H=2, KV=2, D=128,
                                                dtype=torch.float16), True),
        "noncausal_s130_d64_fp32": (flash_case(15, B=1, Sq=130, Sk=70, H=4, KV=1, D=64,
                                               dtype=torch.float32), False),
        "unaligned_s77_d128_bf16": (flash_case(16, B=1, Sq=77, Sk=77, H=8, KV=4, D=128,
                                               dtype=bf16), True),
        # the tensor-core kernels' edges: sq < sk, non-causal, D = 64, and
        # causal sq > sk, where the first rows see no key
        "sq90_lt_sk130_d128_bf16": (flash_case(17, B=2, Sq=90, Sk=130, H=4, KV=2, D=128,
                                               dtype=bf16), True),
        "sq100_lt_sk300_d64_fp16": (flash_case(18, B=1, Sq=100, Sk=300, H=4, KV=2, D=64,
                                               dtype=torch.float16), True),
        "noncausal_s130_d64_bf16": (flash_case(19, B=1, Sq=130, Sk=70, H=4, KV=1, D=64,
                                               dtype=bf16), False),
        "noncausal_s200_d128_fp16": (flash_case(20, B=2, Sq=200, Sk=200, H=2, KV=2, D=128,
                                                dtype=torch.float16), False),
        "sq130_gt_sk70_d64_bf16": (flash_case(21, B=1, Sq=130, Sk=70, H=4, KV=2, D=64,
                                              dtype=bf16), True),
        "sq200_gt_sk90_d128_fp16": (flash_case(22, B=2, Sq=200, Sk=90, H=2, KV=1, D=128,
                                               dtype=torch.float16), True),
        # [train-bert]'s BERT-base attention: non-causal, head dim 64
        BERT_FLASH_CASE: (flash_case(23, B=8, Sq=512, Sk=512, H=12, KV=12, D=64, dtype=bf16),
                          False),
        # [train-phi] and [train-gptj]: head dims 80 and 256
        FAMILY_FLASH_CASES["phi"]: (flash_case(24, B=2, Sq=2048, Sk=2048, H=32, KV=32, D=80,
                                               dtype=bf16), True),
        FAMILY_FLASH_CASES["gptj"]: (flash_case(25, B=2, Sq=2048, Sk=2048, H=16, KV=16,
                                                D=256, dtype=bf16), True),
        # their edges on both routes: sq < sk, sq > sk (rows that see no
        # key), non-causal, GQA, lengths off the tiles
        "sq100_lt_sk300_gqa_d80_fp32": (flash_case(26, B=1, Sq=100, Sk=300, H=4, KV=2, D=80,
                                                   dtype=torch.float32), True),
        "sq130_gt_sk70_d80_fp16": (flash_case(27, B=1, Sq=130, Sk=70, H=4, KV=2, D=80,
                                              dtype=torch.float16), True),
        "noncausal_s130_kv1_d80_fp16": (flash_case(28, B=1, Sq=130, Sk=70, H=4, KV=1, D=80,
                                                   dtype=torch.float16), False),
        "unaligned_s77_d80_bf16": (flash_case(29, B=1, Sq=77, Sk=77, H=8, KV=4, D=80,
                                              dtype=bf16), True),
        "noncausal_s200_d80_fp32": (flash_case(30, B=2, Sq=200, Sk=200, H=2, KV=2, D=80,
                                               dtype=torch.float32), False),
        "sq90_lt_sk130_gqa_d256_fp16": (flash_case(31, B=2, Sq=90, Sk=130, H=4, KV=2, D=256,
                                                   dtype=torch.float16), True),
        "sq130_gt_sk70_d256_fp32": (flash_case(32, B=1, Sq=130, Sk=70, H=4, KV=2, D=256,
                                               dtype=torch.float32), True),
        "noncausal_s200_d256_fp16": (flash_case(33, B=2, Sq=200, Sk=200, H=2, KV=2, D=256,
                                                dtype=torch.float16), False),
        "unaligned_s77_kv1_d256_bf16": (flash_case(34, B=1, Sq=77, Sk=77, H=4, KV=1, D=256,
                                                   dtype=bf16), True),
        "unaligned_s200_gqa_d256_fp32": (flash_case(35, B=1, Sq=200, Sk=200, H=4, KV=1,
                                                    D=256, dtype=torch.float32), True),
    }
    errs = {}
    for name, (c, causal) in cases.items():
        for kname, e in compare_flash(name, c, causal).items():
            errs[kname] = max(errs.get(kname, 0.0), e)
    recs = measure_flash("train_causal_bf16", *cases["train_causal_bf16"])
    for suffix, case in (("bert", BERT_FLASH_CASE), ("phi", FAMILY_FLASH_CASES["phi"]),
                         ("gptj", FAMILY_FLASH_CASES["gptj"])):
        for kname, rec in measure_flash(case, *cases[case]).items():
            recs[f"{kname}_{suffix}"] = rec
    del cases
    torch.cuda.empty_cache()
    adam_f32 = measure_adamw("adamw_w_gate_fp32_grad", W_GATE, torch.float32, 21)
    adam_bf16 = measure_adamw("adamw_w_gate_bf16_grad", W_GATE, bf16, 22)
    recs["fused_adamw"] = adam_f32
    recs["fused_adamw_bf16_grad"] = adam_bf16
    errs["fused_adamw"] = max(adam_f32["max_abs_err"], adam_bf16["max_abs_err"])
    torch.cuda.empty_cache()
    for name, rec in recs.items():
        log(f"[kernel] {name} on {card}: {json.dumps({k: rec[k] for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by')})}")
    return recs, errs


# ------------------------------------------------------ phase 2, sparse kernels
def sparse_layout(heads, seq, **over):
    """The layout of ``SPARSE_CONFIG`` (with ``over`` replacing its keys) for
    ``heads`` heads, covering ``seq`` rounded up to the block."""
    from deepspeed_tpu_torch.runtime.config import SparseAttentionConfig
    cfg = SparseAttentionConfig(**{**SPARSE_CONFIG, **over})
    return cfg.build(heads).make_layout(-(-seq // cfg.block) * cfg.block), cfg.block


def sparse_case(seed, *, B, S, H, KV, D, dtype, causal, **layout):
    from deepspeed_tpu_torch.ops.sparse_attention.attention import _get_tables
    c = flash_case(seed, B=B, Sq=S, Sk=S, H=H, KV=KV, D=D, dtype=dtype)
    lay, block = sparse_layout(H, S, **layout)
    c.update(layout=lay, tables=_get_tables(lay, H, block, KV), causal=causal)
    return c


def sparse_backward_inputs(c):
    """The plain forward's lse and delta = rowsum(do * out), shared by the
    backward kernels and their plain versions."""
    from deepspeed_tpu_torch.ops.sparse_attention.attention import sparse_fwd_reference
    scale = 1.0 / np.sqrt(c["q"].shape[-1])
    out, lse = sparse_fwd_reference(c["q"], c["k"], c["v"], c["tables"], scale, c["causal"])
    delta = (c["do"].float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return scale, lse, delta


def sparse_faults(c, got, refs, rounded, floors):
    """The kernels' bf16/fp16 outputs spoiled five ways, each of which the
    row limit must reject: dK and dV with the last layout block's keys
    zeroed; dK and dV with the keys of one local-only tile zeroed (kv head
    0's tile with the shortest walk, which no global query block sees);
    dQ and out with their last 64 query rows scaled by 1.05; the forward run
    on K and V whose last layout block is zeroed.  Returns {fault: share of
    the limit}; raises where the limit passes one."""
    import torch
    from deepspeed_tpu_torch.ops.attention import flash
    from deepspeed_tpu_torch.ops.sparse_attention.attention import sparse_fwd, tile_positions
    tb = c["tables"]
    S = c["q"].shape[1]
    last = torch.arange((tb.layout.shape[1] - 1) * tb.block, S, device=c["q"].device)
    tiles = (tile_positions(tb.k_order[0], tb.block, S, int(t)) for t in tb.k_tile_order[0][::-1])
    local = next(pos for pos in tiles if (pos >= 0).any())
    local = torch.from_numpy(local[local >= 0]).to(c["q"].device)
    shares = {}
    for fault, part, spoil in (
            ("last_block_zeroed_dk", "dk", lambda x: x.index_fill_(1, last, 0)),
            ("last_block_zeroed_dv", "dv", lambda x: x.index_fill_(1, last, 0)),
            ("local_tile_zeroed_dk", "dk", lambda x: x[:, :, :1].index_fill_(1, local, 0)),
            ("local_tile_zeroed_dv", "dv", lambda x: x[:, :, :1].index_fill_(1, local, 0)),
            ("dq_last_rows_x1.05", "dq", lambda x: x[:, -64:].copy_(x[:, -64:].float() * 1.05)),
            ("out_last_rows_x1.05", "out", lambda x: x[:, -64:].copy_(x[:, -64:].float() * 1.05)),
            ("fwd_last_block_kv_zeroed", "out", None)):
        if spoil is None:
            k0, v0 = c["k"].index_fill(1, last, 0), c["v"].index_fill(1, last, 0)
            bad = sparse_fwd(c["q"], k0, v0, tb, 1.0 / np.sqrt(c["q"].shape[-1]),
                             c["causal"])[0]
        else:
            bad = got[part].clone()
            spoil(bad)
        passed, _, shares[fault], _ = flash.tensor_core_limit(bad, refs[part], rounded[part],
                                                              floors.get(part))
        if passed:
            raise AssertionError(f"{c.get('name', '')} {fault}: the row limit passes a faulty "
                                 f"kernel run ({shares[fault]:.3f} of it)")
    return shares


def compare_sparse(name, c):
    """Each sparse kernel once against its plain version; returns the largest
    error of each kernel's outputs.  fp32 is held at 1e-4.  bf16/fp16 are held
    to ``flash.tensor_core_limit`` row by row against the fp32 plain version
    on the inputs' values: out, dK, dV and dQ (tensor-core kernels) with
    ``rounded`` = the plain versions with ``round_to=`` the dtype, dQ with
    ``sparse_dq_fp32_floor``; lse at 1e-4, as flash's; the faulted runs of
    :func:`sparse_faults` must fail it."""
    import torch
    from deepspeed_tpu_torch.ops.attention import flash
    from deepspeed_tpu_torch.ops.sparse_attention import attention as sp
    q, k, v, do, tb, causal = c["q"], c["k"], c["v"], c["do"], c["tables"], c["causal"]
    scale, lse_ref, delta = sparse_backward_inputs(c)
    tc = flash.uses_tensor_cores(q.dtype)
    fns = (sp.sparse_fwd, sp.sparse_bwd_dkdv, sp.sparse_bwd_dq)
    counts = [fn.launches for fn in fns] + [fn.tc_launches for fn in fns]
    out, lse = sp.sparse_fwd(q, k, v, tb, scale, causal)
    dk, dv = sp.sparse_bwd_dkdv(q, k, v, do, lse_ref, delta, tb, scale, causal)
    dq = sp.sparse_bwd_dq(q, k, v, do, lse_ref, delta, tb, scale, causal)
    torch.cuda.synchronize()
    now = [fn.launches for fn in fns] + [fn.tc_launches for fn in fns]
    if now != [n + d for n, d in zip(counts, (1, 1, 1, tc, tc, tc))]:
        raise AssertionError(f"{name}: a sparse kernel did not launch, or not the "
                             f"{'tensor-core' if tc else 'CUDA-core'} variant")
    got = {"out": out, "dk": dk, "dv": dv, "dq": dq}
    if not tc:
        bwd_args = (q, k, v, do, lse_ref, delta, tb, scale, causal)
        refs = {"out": sp.sparse_fwd_reference(q, k, v, tb, scale, causal)[0],
                "dq": sp.sparse_bwd_dq_reference(*bwd_args)}
        refs["dk"], refs["dv"] = sp.sparse_bwd_dkdv_reference(*bwd_args)
        rms = {part: _rms(ref) for part, ref in refs.items()}
        err = {part: _max_err(f"{name} {part}", got[part], refs[part], 1e-4, 1e-4)
               for part in refs}
        rule = "CUDA cores, atol=rtol=1e-4"
    else:
        f = [x.float() for x in (q, k, v, do)]
        bwd_args = (*f, lse_ref, delta, tb, scale, causal)
        refs = {"out": sp.sparse_fwd_reference(*f[:3], tb, scale, causal)[0],
                "dq": sp.sparse_bwd_dq_reference(*bwd_args)}
        refs["dk"], refs["dv"] = sp.sparse_bwd_dkdv_reference(*bwd_args)
        rounded = {"out": sp.sparse_fwd_reference(*f[:3], tb, scale, causal, round_to=q.dtype)[0],
                   "dq": sp.sparse_bwd_dq_reference(*bwd_args, round_to=q.dtype)}
        rounded["dk"], rounded["dv"] = sp.sparse_bwd_dkdv_reference(*bwd_args, round_to=q.dtype)
        # query 0 sees only key 0: its dQ is 0 exactly, fp32 noise on both sides
        floors = {"dq": sp.sparse_dq_fp32_floor(*bwd_args)}
        rms, err, ratios, limits = {}, {}, {}, {}
        for part in ("out", "dk", "dv", "dq"):
            ok, err[part], ratios[part], limits[part] = flash.tensor_core_limit(
                got[part], refs[part], rounded[part], floors.get(part))
            rms[part] = _rms(refs[part])
            if not ok:
                raise AssertionError(
                    f"{name} {part}: kernel beyond the row limit: max abs err {err[part]:.3e}, "
                    f"{ratios[part]:.3f} of 2 max_row|rounded - ref| + eps max_row|ref| (rms of "
                    f"the fp32 plain result {rms[part]:.3e})")
        shares = sparse_faults({**c, "name": name}, got, refs, rounded, floors)
        rule = (f"row limit 2 max_row|rounded - fp32| + eps max_row|fp32| (out/dk/dv/dq "
                f"tensor cores, rounded = round_to={q.dtype}, dq + its fp32 floor), median "
                f"row limit "
                f"{limits['out']:.3e}/{limits['dk']:.3e}/{limits['dv']:.3e}/{limits['dq']:.3e}, "
                f"at {ratios['out']:.3f}/{ratios['dk']:.3f}/{ratios['dv']:.3f}/"
                f"{ratios['dq']:.3f} of it; faulted runs rejected at "
                + ", ".join(f"{fault} {share:.2f}" for fault, share in shares.items()))
    errs = {"sparse_fwd": max(err["out"], _max_err(f"{name} lse", lse, lse_ref, 1e-4, 1e-4)),
            "sparse_bwd_dkdv": max(err["dk"], err["dv"]), "sparse_bwd_dq": err["dq"]}
    B, S, H, D = q.shape
    log(f"[kernel] {name}: ok, max abs err out/lse {errs['sparse_fwd']:.3e} dk/dv "
        f"{errs['sparse_bwd_dkdv']:.3e} dq {errs['sparse_bwd_dq']:.3e} ({rule}; rms out "
        f"{rms['out']:.3e} dk {rms['dk']:.3e} dv {rms['dv']:.3e} dq {rms['dq']:.3e}; lse "
        f"atol=rtol=1e-4; {q.dtype}, B={B} S={S} H={H} KV={k.shape[2]} D={D} block "
        f"{tb.block}, causal={causal})")
    return errs


def sparse_work(c):
    """(bytes, operations) of each sparse kernel for this case: each input
    read once (the tables it walks included) and each output written once;
    4 D operations per live (query, key) pair forward, 8 D for dK/dV, 6 D for
    dQ, counted from the layout (``live_pairs``)."""
    from deepspeed_tpu_torch.ops.sparse_attention.attention import live_pairs
    B, S, H, D = c["q"].shape
    KV, tb = c["k"].shape[2], c["tables"]
    pairs = B * live_pairs(tb.layout, tb.block, S, c["causal"], H)
    elt = c["q"].element_size()
    qo, kv, rows = B * S * H * D * elt, B * S * KV * D * elt, B * H * S * 4
    fwd_tables = tb.layout.nbytes + tb.q_order.nbytes + tb.k_walk.nbytes + tb.k_cnt.nbytes
    bwd_tables = tb.layout.nbytes + tb.k_order.nbytes + tb.q_walk.nbytes + tb.q_cnt.nbytes
    return {"sparse_fwd": (2 * qo + 2 * kv + rows + fwd_tables, 4.0 * D * pairs),
            "sparse_bwd_dkdv": (2 * qo + 4 * kv + 2 * rows + bwd_tables, 8.0 * D * pairs),
            "sparse_bwd_dq": (3 * qo + 2 * kv + 2 * rows + fwd_tables, 6.0 * D * pairs)}, pairs


def measure_sparse(name, c, plain=True):
    """Times of the three sparse kernels against the bound; with ``plain``
    also their plain versions and torch's scaled_dot_product_attention with
    the layout's boolean element mask (the same function computed dense:
    forward; backward computing dq, dk and dv in one call) as the library
    yardstick."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.sparse_attention import attention as sp
    q, k, v, do, tb, causal = c["q"], c["k"], c["v"], c["do"], c["tables"], c["causal"]
    scale, lse, delta = sparse_backward_inputs(c)
    work, pairs = sparse_work(c)
    lib = {"sparse_fwd": None, "sparse_bwd_dkdv": None, "sparse_bwd_dq": None}
    if plain:
        group = q.shape[2] // k.shape[2]
        qt = q.transpose(1, 2).contiguous().requires_grad_(True)
        kt = torch.repeat_interleave(k, group, 2).transpose(1, 2).contiguous().requires_grad_(True)
        vt = torch.repeat_interleave(v, group, 2).transpose(1, 2).contiguous().requires_grad_(True)
        dot = do.transpose(1, 2).contiguous()
        mask = tb.element_mask(q.shape[1], causal, q.device)[None]
        with torch.no_grad():
            fwd_lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        with torch.enable_grad():
            out_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            bwd_lib = time_ms(lambda: torch.autograd.grad(out_lib, (qt, kt, vt), dot,
                                                          retain_graph=True), runs=10)
        del out_lib, mask
        lib = {"sparse_fwd": fwd_lib, "sparse_bwd_dkdv": bwd_lib, "sparse_bwd_dq": bwd_lib}
    args = (q, k, v, do, lse, delta, tb, scale, causal)
    runs = {
        "sparse_fwd": (lambda: sp.sparse_fwd(q, k, v, tb, scale, causal),
                       lambda: sp.sparse_fwd_reference(q, k, v, tb, scale, causal)),
        "sparse_bwd_dkdv": (lambda: sp.sparse_bwd_dkdv(*args),
                            lambda: sp.sparse_bwd_dkdv_reference(*args)),
        "sparse_bwd_dq": (lambda: sp.sparse_bwd_dq(*args),
                          lambda: sp.sparse_bwd_dq_reference(*args)),
    }
    recs = {}
    for kname, (kernel, plain_fn) in runs.items():
        nbytes, flops = work[kname]
        bound_ms, bound_by = bound(nbytes, flops, q.dtype)
        ms = time_ms(kernel)
        recs[kname] = {"ms": ms, "plain_ms": time_ms(plain_fn, runs=5) if plain else None,
                       "library_ms": lib[kname], "bound_ms": bound_ms, "bound_by": bound_by,
                       "bytes": nbytes, "flops": flops, "tflops": flops / ms / 1e9}
        r = recs[kname]
        extra = (f" plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f}"
                 if plain else "")
        log(f"[kernel] {name} {kname}: kernel_ms {ms:.4f}{extra} bound_ms {bound_ms:.4f} "
            f"({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP over {pairs} live "
            f"pairs; kernel {r['tflops']:.2f} TFLOP/s)")
    if plain:
        launch_order_ab(name, c, args)
    return recs


def launch_order_ab(name, c, args):
    """The tensor-core forward and backward kernels with their tiles launched
    longest walk first (the tables' order) against the tiles in index order,
    in turns (longest, index, index, longest): what the launch order buys."""
    import copy
    from deepspeed_tpu_torch.ops.sparse_attention import attention as sp
    tb = c["tables"]
    in_index = copy.copy(tb)
    in_index._device = {}
    in_index.q_tile_order = np.broadcast_to(np.arange(tb.n_tiles, dtype=np.int32),
                                            tb.q_tile_order.shape).copy()
    in_index.k_tile_order = np.broadcast_to(np.arange(tb.n_tiles, dtype=np.int32),
                                            tb.k_tile_order.shape).copy()
    chunks = -(-tb.q_cnt * tb.block // sp.TILE)  # 64-query chunks of each (q head, key tile)
    walks = chunks.reshape(tb.n_kv_heads, -1, tb.n_tiles).sum(1)
    fwd_walks = -(-tb.k_cnt * tb.block // sp.TILE)  # 64-key chunks of each (q head, query tile)
    runs = (("sparse_fwd", lambda tables: sp.sparse_fwd(*args[:3], tables, *args[7:]), fwd_walks,
             "forward walks, 64-key chunks a query tile (before the causal stop)"),
            ("sparse_bwd_dkdv", lambda tables: sp.sparse_bwd_dkdv(*args[:6], tables, *args[7:]),
             walks, "dK/dV walks, 64-query chunks a key tile"),
            ("sparse_bwd_dq", lambda tables: sp.sparse_bwd_dq(*args[:6], tables, *args[7:]),
             fwd_walks, "dQ walks, 64-key chunks a query tile (before the causal stop)"))
    for kname, fn, w, what in runs:
        times = {"longest first": [], "index order": []}
        for order in ("longest first", "index order", "index order", "longest first"):
            tables = tb if order == "longest first" else in_index
            times[order].append(time_ms(lambda: fn(tables)))
        log(f"[kernel] {name} {kname} launch order: longest walk first "
            f"{statistics.mean(times['longest first']):.4f} ms, tile index order "
            f"{statistics.mean(times['index order']):.4f} ms ({what}: max {w.max()}, mean "
            f"{w.mean():.2f}, median {np.median(w):.0f})")


def phase_sparse_kernels(card):
    """The three sparse kernels against their plain versions on the card, at
    the sparse training shape and on edge cases; times at the training
    shape.  Returns the records at block 16 and the largest errors."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    train = dict(B=1, S=4096, H=32, KV=32, D=128, dtype=bf16, causal=True)
    cases = {
        "sparse_train_b16_bf16": sparse_case(31, **train),
        "sparse_train_b64_bf16": sparse_case(32, **train, block=64),
        "sparse_train_b128_bf16": sparse_case(33, **train, block=128),
        "sparse_gqa_h32_kv8_bf16": sparse_case(34, B=1, S=2048, H=32, KV=8, D=128, dtype=bf16,
                                               causal=True),
        "sparse_tail_s1000_d64_fp32": sparse_case(35, B=2, S=1000, H=4, KV=2, D=64, dtype=f32,
                                                  causal=True),
        "sparse_bigbird_noncausal_fp32": sparse_case(
            36, B=1, S=512, H=4, KV=4, D=128, dtype=f32, causal=False, mode="bigbird", block=32,
            attention="bidirectional", num_random_blocks=2),
        "sparse_block24_s209_fp32": sparse_case(37, B=1, S=209, H=4, KV=2, D=64, dtype=f32,
                                                causal=True, block=24),
        "sparse_block8_s100_fp16": sparse_case(38, B=2, S=100, H=2, KV=1, D=128,
                                               dtype=torch.float16, causal=True, block=8,
                                               num_local_blocks=2, num_different_global_patterns=2),
        # the tensor-core backward on the edges above: a padded tail at D = 64,
        # non-causal bigbird, block 24
        "sparse_tail_s1000_d64_bf16": sparse_case(39, B=2, S=1000, H=4, KV=2, D=64, dtype=bf16,
                                                  causal=True),
        "sparse_bigbird_noncausal_fp16": sparse_case(
            40, B=1, S=512, H=4, KV=4, D=128, dtype=torch.float16, causal=False, mode="bigbird",
            block=32, attention="bidirectional", num_random_blocks=2),
        "sparse_block24_s209_bf16": sparse_case(41, B=1, S=209, H=4, KV=2, D=64, dtype=bf16,
                                                causal=True, block=24),
    }
    errs = {}
    for name, c in cases.items():
        for kname, e in compare_sparse(name, c).items():
            errs[kname] = max(errs.get(kname, 0.0), e)
    recs = measure_sparse("sparse_train_b16_bf16", cases["sparse_train_b16_bf16"])
    for block in (64, 128):
        measure_sparse(f"sparse_train_b{block}_bf16", cases[f"sparse_train_b{block}_bf16"],
                       plain=False)
    del cases
    torch.cuda.empty_cache()
    for name, rec in recs.items():
        log(f"[kernel] {name} on {card}: {json.dumps({k: rec[k] for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by')})}")
    return recs, errs


# ------------------------------------------------------ phase 2, AdamW-8bit
ADAMW8_HYPER = dict(lr=3e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.1, step=3)


def adamw8_state(gen, n, device, grad_dtype=None):
    """[p, m8, v8, sm, sv, grad] of a state some steps in: p ~ 0.02, |m| up
    to 1e-3, sqrt(v) up to 1e-3, grad ~ 1e-3 (fp32 unless ``grad_dtype``)."""
    import torch
    groups = -(-n // 1024)
    codes = lambda lo: torch.randint(lo, 128, (groups, 1024), generator=gen, device=device,
                                     dtype=torch.int8)
    scales = lambda: torch.rand((groups, 1), generator=gen, device=device) * (1e-3 / 127)
    p = torch.randn(n, generator=gen, device=device) * 0.02
    m8, v8, sm, sv = codes(-127), codes(0), scales(), scales()
    grad = torch.randn(n, generator=gen, device=device) * 1e-3
    return [p, m8, v8, sm, sv, grad.to(grad_dtype or torch.float32)]


def check_adamw8(name, bufs, plain, n):
    """The kernel's p, codes and scales against the plain version's: the int8
    codes equal, p and the scales at rtol 1e-6 plus 1e-6 of each buffer's
    largest value, and the dequantized m and v nonzero for most elements
    (so that codes never written back, or all zero, do not pass); returns the
    largest error."""
    import torch
    from deepspeed_tpu_torch.ops.adam.adam8bit import dequantize_moments
    for part, i in (("m codes", 1), ("sqrt(v) codes", 2)):
        if not torch.equal(bufs[i], plain[i]):
            diff = (bufs[i].int() - plain[i].int()).abs()
            raise AssertionError(f"{name} {part}: kernel disagrees with the plain version: "
                                 f"{int((diff != 0).sum())} codes differ, by up to "
                                 f"{int(diff.max())}")
    err = max(_max_err(f"{name} {part}", bufs[i], plain[i], 1e-6 * plain[i].abs().max().item(),
                       1e-6) for part, i in (("p", 0), ("m scales", 3), ("sqrt(v) scales", 4)))
    m, v = dequantize_moments(*bufs[1:5], n)
    live = min(float((m != 0).float().mean()), float((v != 0).float().mean()))
    if live < 0.5:
        raise AssertionError(f"{name}: only {live:.1%} of the dequantized moments are nonzero")
    return err


def measure_adamw8(name, n, grad_dtype, seed, time_it=True):
    """The AdamW-8bit kernel against its plain version over one flat leaf of
    ``n`` elements; no PyTorch call computes this function, so there is no
    library time."""
    import torch
    from deepspeed_tpu_torch.ops.adam.adam8bit import (fused_adamw8bit_flat,
                                                       fused_adamw8bit_flat_reference)
    *state, grad = adamw8_state(torch.Generator(device="cuda").manual_seed(seed), n, "cuda",
                                grad_dtype)
    bufs = [x.clone() for x in state]
    plain = [x.clone() for x in state]
    before = fused_adamw8bit_flat.launches
    fused_adamw8bit_flat(*bufs, grad, **ADAMW8_HYPER)
    torch.cuda.synchronize()
    if fused_adamw8bit_flat.launches != before + 1:
        raise AssertionError(f"{name}: the AdamW-8bit kernel did not launch")
    fused_adamw8bit_flat_reference(*plain, grad, **ADAMW8_HYPER)
    err = check_adamw8(name, bufs, plain, n)
    log(f"[kernel] {name}: ok, int8 codes equal, max abs err of p and scales {err:.3e} (rtol "
        f"1e-6, atol 1e-6 x max|plain| of each buffer; max|p| {plain[0].abs().max().item():.3e} "
        f"max m scale {plain[3].max().item():.3e} max sqrt(v) scale "
        f"{plain[4].max().item():.3e}; {grad_dtype} grad, n={n})")
    if not time_it:
        return {"max_abs_err": err}
    groups = state[1].shape[0]
    nbytes = n * (2 * 4 + grad.element_size() + 4) + groups * 16
    bound_ms, bound_by = bound(nbytes, 30.0 * n, torch.float32)
    ms = time_ms(lambda: fused_adamw8bit_flat(*bufs, grad, **ADAMW8_HYPER))
    plain_ms = time_ms(lambda: fused_adamw8bit_flat_reference(*plain, grad, **ADAMW8_HYPER),
                       runs=5)
    rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes, "max_abs_err": err}
    log(f"[kernel] {name}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms none "
        f"bound_ms {bound_ms:.4f} ({bound_by}: {nbytes / 1e9:.3f} GB; kernel "
        f"{nbytes / ms / 1e6:.0f} GB/s)")
    return rec


def phase_adamw8_kernels(card):
    """The AdamW-8bit kernel against its plain version on the [train] run's
    stacked w_gate leaf (fp32 and bf16 grad) and on a tail group."""
    import torch
    recs = {"adamw8bit": measure_adamw8("adamw8_w_gate_fp32_grad", W_GATE, torch.float32, 41),
            "adamw8bit_bf16_grad": measure_adamw8("adamw8_w_gate_bf16_grad", W_GATE,
                                                  torch.bfloat16, 42)}
    torch.cuda.empty_cache()
    err = max(recs["adamw8bit"]["max_abs_err"], recs["adamw8bit_bf16_grad"]["max_abs_err"])
    for dtype in (torch.float32, torch.bfloat16):
        err = max(err, measure_adamw8(f"adamw8_tail_n1000_{str(dtype)[6:]}_grad", 1000, dtype,
                                      43, time_it=False)["max_abs_err"])
    for name, rec in recs.items():
        log(f"[kernel] {name} on {card}: {json.dumps({k: rec[k] for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by')})}")
    return recs, err


# ------------------------------------------ phase 2, int8 quantize and Lion
def check_bitwise(name, got, ref, parts):
    """Each output of a kernel EQUAL to its plain version's (``parts`` names
    them); returns the largest difference, 0.0."""
    import torch
    for part, a, b in zip(parts, got, ref):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            diff = ((a.double() - b.double()).abs() if a.shape == b.shape
                    else torch.tensor([float("inf")]))
            raise AssertionError(f"{name} {part}: kernel disagrees with the plain version: "
                                 f"{int((diff != 0).sum())} elements differ, by up to "
                                 f"{diff.max().item():.3e} ({tuple(a.shape)} {a.dtype} vs "
                                 f"{tuple(b.shape)} {b.dtype})")
    return 0.0


def measure_quantize(name, x, group, time_it=False):
    """The int8 quantize kernel against its plain version on ``x``, codes and
    scales bit for bit; with ``time_it`` also the times and the byte bound.
    No PyTorch call computes this function (``torch.quantize_per_channel``
    takes given scales and clamps to [-128, 127]), so there is no library
    time."""
    import torch
    from deepspeed_tpu_torch.ops.quantizer.quantize import quantize_int8, quantize_int8_reference
    before = quantize_int8.launches
    q, scales, n = quantize_int8(x, group)
    torch.cuda.synchronize()
    if quantize_int8.launches != before + 1:
        raise AssertionError(f"{name}: the quantize kernel did not launch")
    rq, rs, rn = quantize_int8_reference(x, group)
    err = check_bitwise(name, (q, scales), (rq, rs), ("codes", "scales"))
    live = float((rq != 0).float().mean())
    if n != rn or (x.abs().max() > 0 and live < 0.5):
        raise AssertionError(f"{name}: n {n} vs {rn}, {live:.1%} of the codes nonzero")
    groups, g = q.shape
    log(f"[kernel] {name}: ok, codes and scales equal to the plain version's (n={n}, {groups} "
        f"groups of {g}, {x.dtype}; {live:.1%} of codes nonzero, scales "
        f"{rs.min().item():.3e} to {rs.max().item():.3e})")
    if not time_it:
        return {"max_abs_err": err}
    del rq, rs
    torch.cuda.empty_cache()
    nbytes = n * x.element_size() + groups * g + groups * 4
    bound_ms, bound_by = bound(nbytes, 4.0 * n, torch.float32)
    ms = time_ms(lambda: quantize_int8(x, group))
    plain_ms = time_ms(lambda: quantize_int8_reference(x, group), runs=3)
    rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes, "max_abs_err": err}
    log(f"[kernel] {name}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms none "
        f"bound_ms {bound_ms:.4f} ({bound_by}: {nbytes / 1e9:.3f} GB; kernel "
        f"{nbytes / ms / 1e6:.0f} GB/s)")
    return rec


def phase_quantize_kernels(card):
    """The int8 quantize kernel against its plain version: the full-depth
    Llama-2-7B w_gate leaf in bf16, groups of 2048 (timed), and small cases
    that reach every branch of the kernel."""
    import torch
    from deepspeed_tpu_torch.ops.quantizer.quantize import quantize_int8_reference
    gen = torch.Generator(device="cuda").manual_seed(51)
    rand = lambda n, dtype=torch.bfloat16: (torch.randn(n, generator=gen, device="cuda")
                                            * 3.0).to(dtype)
    zero_group = rand(10_000)
    zero_group[2048:4096] = 0.0
    small = {  # name: (x, group)
        "quant_g64_bf16": (rand(100_003), 64),
        "quant_g128_bf16": (rand(100_003), 128),
        "quant_g2048_tail_bf16": (rand(100_003), 2048),
        "quant_g2048_zero_group_bf16": (zero_group, 2048),
        "quant_g2048_fp32": (rand(50_000, torch.float32), 2048),
        "quant_g256_fp16": (rand(50_000, torch.float16), 256),
        "quant_g100_unaligned_bf16": (rand(10_001), 100),
        "quant_g5_bf16": (rand(1000), 5),
        "quant_g16384_bf16": (rand(100_000), 16384),
        "quant_n77_lt_group_fp32": (rand(77, torch.float32), 2048),
    }
    err = max(measure_quantize(name, x, g)["max_abs_err"] for name, (x, g) in small.items())
    codes, scales, _ = quantize_int8_reference(zero_group, 2048)  # equal to the kernel's
    if float(scales[1, 0]) != 1.0 or codes[1].any():
        raise AssertionError("the all-zero group's scale is not 1 or its codes not 0")
    del small, zero_group, codes, scales
    w_gate = (torch.randn((32, 4096, 11008), generator=gen, device="cuda", dtype=torch.bfloat16)
              .mul_(1.0 / np.sqrt(4096)))
    rec = measure_quantize("quant_w_gate_llama2_7b_bf16", w_gate, 2048, time_it=True)
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    del w_gate
    torch.cuda.empty_cache()
    log(f"[kernel] quantize_int8 on {card}: {json.dumps({k: rec[k] for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by')})}")
    return rec


LION_HYPER = dict(lr=1e-4, beta1=0.9, beta2=0.99, weight_decay=0.1)


def lion_state(gen, n, device, grad_dtype=None):
    """[p, m, grad] of a Lion state some steps in: p ~ 0.02, m ~ 1e-3, grad ~
    1e-3 (fp32 unless ``grad_dtype``)."""
    import torch
    p = torch.randn(n, generator=gen, device=device) * 0.02
    m = torch.randn(n, generator=gen, device=device) * 1e-3
    grad = torch.randn(n, generator=gen, device=device) * 1e-3
    return [p, m, grad.to(grad_dtype or torch.float32)]


def measure_lion(name, n, grad_dtype, seed, time_it=True):
    """The fused Lion kernel against its plain version over one flat leaf of
    ``n`` elements, p and m bit for bit; torch.optim has no Lion, so there is
    no library time."""
    import torch
    from deepspeed_tpu_torch.ops.adam.fused_adam import fused_lion_flat, fused_lion_flat_reference
    *state, grad = lion_state(torch.Generator(device="cuda").manual_seed(seed), n, "cuda",
                              grad_dtype)
    bufs = [x.clone() for x in state]
    plain = [x.clone() for x in state]
    before = fused_lion_flat.launches
    fused_lion_flat(*bufs, grad, **LION_HYPER)
    torch.cuda.synchronize()
    if fused_lion_flat.launches != before + 1:
        raise AssertionError(f"{name}: the Lion kernel did not launch")
    fused_lion_flat_reference(*plain, grad, **LION_HYPER)
    err = check_bitwise(name, bufs, plain, "pm")
    moved = float((plain[0] != state[0]).float().mean())
    if moved < 0.99:
        raise AssertionError(f"{name}: only {moved:.1%} of p moved")
    log(f"[kernel] {name}: ok, p and m equal to the plain version's ({grad_dtype} grad, n={n}, "
        f"{moved:.2%} of p moved)")
    if not time_it:
        return {"max_abs_err": err}
    nbytes = n * (4 * 4 + grad.element_size())
    bound_ms, bound_by = bound(nbytes, 10.0 * n, torch.float32)
    ms = time_ms(lambda: fused_lion_flat(*bufs, grad, **LION_HYPER))
    plain_ms = time_ms(lambda: fused_lion_flat_reference(*plain, grad, **LION_HYPER), runs=5)
    rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes, "max_abs_err": err}
    log(f"[kernel] {name}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms none "
        f"bound_ms {bound_ms:.4f} ({bound_by}: {nbytes / 1e9:.3f} GB; kernel "
        f"{nbytes / ms / 1e6:.0f} GB/s)")
    return rec


def phase_lion_kernels(card):
    """The fused Lion kernel against its plain version on the [train] run's
    stacked w_gate leaf (fp32 and bf16 grad) and on a tail of n % 4."""
    import torch
    recs = {"fused_lion": measure_lion("lion_w_gate_fp32_grad", W_GATE, torch.float32, 61),
            "fused_lion_bf16_grad": measure_lion("lion_w_gate_bf16_grad", W_GATE,
                                                 torch.bfloat16, 62)}
    torch.cuda.empty_cache()
    err = max(r["max_abs_err"] for r in recs.values())
    for dtype in (torch.float32, torch.bfloat16):
        err = max(err, measure_lion(f"lion_tail_n1003_{str(dtype)[6:]}_grad", 1003, dtype, 63,
                                    time_it=False)["max_abs_err"])
    recs["fused_lion"]["max_abs_err"] = err
    for name, rec in recs.items():
        log(f"[kernel] {name} on {card}: {json.dumps({k: rec[k] for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by')})}")
    return recs


# ------------------------------------------------------------------ phase 3
def serve_timed(engine, prompts, max_new):
    """One ``generate`` over the prompts, synchronized: (results, wall s)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.generate(prompts, max_new_tokens=max_new, strict=False)
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def log_fastpath(tag, engine, before, built_before, card):
    """The fast path's host-link counters over one serve (``before`` is a
    ``ServeCounters`` snapshot), the bucket programs it captured by class
    with their wall time, and the bytes of the graphs' shared memory pool."""
    d = engine.counters.delta_since(before)
    ledger = engine.ledger
    pool = engine.programs.pool_bytes()
    log(f"[{tag}] fast path on {card}: host syncs {d['host_syncs']}, loop iterations "
        f"{d['loop_iterations']}, flushes {d['flushes']}, tokens by burst {d['burst_tokens']} / "
        f"by step {d['step_tokens']}, dispatches {d['dispatches']}, uploads {d['uploads']} "
        f"({d['upload_ints']} ints), programs built {ledger.total - built_before}; captures "
        f"so far by site and class {json.dumps(ledger.by_site)}, wall s by class "
        f"{json.dumps({c: round(w, 4) for c, w in ledger.wall_by_class.items()})}; graph pool "
        f"{'not measured' if pool is None else f'{pool / 2**30:.3f} GiB'}")
    return d


def serve_prompts(seed, vocab):
    """[serve]'s 16 prompts: lengths 32, 2048 and 14 drawn from 32-2048."""
    rng = np.random.default_rng(seed)
    lens = np.concatenate([[32, 2048], rng.integers(32, 2049, 14)])
    return [rng.integers(0, vocab, int(n)).tolist() for n in lens]


def latency_line(tracer):
    """TTFT, TBT, end-to-end and queue-wait p50/p95/p99 in ms from the
    tracer's histograms (each a bucket's geometric midpoint, 6 buckets a
    decade), with each histogram's count, exact mean and exact max."""
    parts = []
    for name, snap in tracer.latency_snapshot().items():
        if not snap["count"]:
            parts.append(f"{name} empty")
            continue
        parts.append(f"{name} p50/p95/p99 {snap['p50'] * 1e3:.3f} / {snap['p95'] * 1e3:.3f} / "
                     f"{snap['p99'] * 1e3:.3f} ms (n={snap['count']}, mean "
                     f"{snap['mean'] * 1e3:.3f}, max {snap['max'] * 1e3:.3f})")
    return "; ".join(parts)


class TraceSink:
    """Collects the per-request trace records a tracer exports (the
    ``record_trace`` seam a telemetry collector fills)."""

    def __init__(self):
        self.records = []

    def record_trace(self, record):
        self.records.append(record)


def check_trace_chains(tag, sink, results):
    """Every request has one exported trace whose terminal equals its
    result's status; an ok request's chain is queue_wait, prefill, decode
    with every span closed and its last event ``ok``."""
    by_uid = {}
    for r in sink.records:
        if r["uid"] in by_uid:
            raise AssertionError(f"[{tag}] request {r['uid']} has two traces")
        by_uid[r["uid"]] = r
    if set(by_uid) != {res.uid for res in results}:
        raise AssertionError(f"[{tag}] traces for {sorted(by_uid)}, requests "
                             f"{sorted(res.uid for res in results)}")
    for res in results:
        r = by_uid[res.uid]
        names = [sp["name"] for sp in r["spans"]]
        if (r["status"] != res.status or names[:1] != ["queue_wait"]
                or not {"prefill", "decode"} <= set(names)
                or any(sp["end"] is None for sp in r["spans"]) or r["events"][-1][0] != "ok"):
            raise AssertionError(f"[{tag}] request {res.uid} ({res.status}): incomplete trace "
                                 f"{r['status']}, spans {names}, last event {r['events'][-1]}")
    return by_uid


def check_chrome_trace(tag, path, n_requests):
    """The Chrome trace parses, has one track (tid) of spans and instants per
    request and the ``kv_pool`` counter track."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    tids = {e["tid"] for e in events if e["ph"] in ("X", "i")}
    counters = [e for e in events if e["ph"] == "C" and e["name"] == "kv_pool"]
    if tids != set(range(n_requests)) or not counters:
        raise AssertionError(f"[{tag}] Chrome trace {path}: request tracks {sorted(tids)}, "
                             f"{len(counters)} kv_pool samples")
    return len(events), len(counters)


def rehearse_serve_latency(step_ms=5.0, position_us=25.5, seed=0):
    """CPU rehearsal of [serve]'s latency percentiles, for a prediction:
    [serve]'s 16 prompts, pool and scheduler through the fast path with
    tracing on, at a tiny width on the CPU, on a clock that only a forward
    advances, by a modeled device time of ``step_ms`` plus ``position_us``
    per padded position (a burst advances it once per step).  The host
    control flow (steps, syncs, which patch makes which token visible) is
    [serve]'s; the clock is a model, and it runs one step ahead of the
    card's where the loop dispatches step N before it patches step N-1.
    Also times the tracer's hooks on the host (perf_counter).  Run:
    ``python3 -c "import chip_smoke as c; c.rehearse_serve_latency()"``."""
    import types
    import torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import mistral
    cfg = mistral.MistralConfig.tiny(vocab=256, hidden=64, layers=2, heads=4, kv_heads=2,
                                     seq=4096, window=4096)
    params = mistral.init_params(cfg, torch.Generator().manual_seed(seed))
    now = [0.0]

    def forward_paged(config, p, tokens, *args, **kw):
        now[0] += (step_ms + position_us * tokens.numel() / 1e3) / 1e3
        return mistral.forward_paged(config, p, tokens, *args, **kw)

    model = types.SimpleNamespace(forward_paged=forward_paged,
                                  init_paged_cache=mistral.init_paged_cache)
    engine = InferenceEngineV2(model, cfg, params, clock=lambda: now[0], device="cpu",
                               config={"dtype": "float32", "serving_tracing": {"enabled": True}},
                               num_blocks=2048, block_size=16, max_blocks_per_seq=256,
                               token_budget=512, max_seqs_per_step=32)
    host = [0.0, 0]
    tracer = engine.tracer
    for name in ("event", "tick", "observe_queue_wait", "on_submit", "on_shed", "on_admit",
                 "on_chunks", "on_tokens_map", "on_burst_tokens", "on_preempt", "on_terminal"):
        def timed(*a, _fn=getattr(tracer, name), **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                host[0] += time.perf_counter() - t0
                host[1] += 1
        setattr(tracer, name, timed)
    results = engine.generate(serve_prompts(seed, cfg.vocab_size), max_new_tokens=32,
                              strict=False)
    c = engine.counters.snapshot()
    log(f"[rehearse-serve] CPU, tiny width, modeled clock ({step_ms} ms a step + {position_us} "
        f"us a padded position): {sum(r.ok for r in results)} of {len(results)} ok, "
        f"{engine.forward_steps} forward steps, {c['host_syncs']} host syncs, modeled wall "
        f"{now[0]:.3f} s; {latency_line(tracer)}; tracer hooks {host[1]} calls in "
        f"{host[0] * 1e3:.3f} ms of host time")
    return tracer.latency_snapshot()


def rehearse_serve_perf(seed=0):
    """CPU rehearsal of [serve-perf]'s roofline, for a prediction: [serve]'s
    16 prompts, pool and scheduler through the fast path with the
    observatory on, at a tiny width on the CPU, served twice (cold, then
    warm after a roofline reset), with each fwd bucket costed by
    ``paged_bucket_cost`` at Mistral-7B's full width in bf16.  The host
    control flow (steps, syncs, buckets) is [serve]'s, so the warm serve's
    roofline bytes, FLOPs, tokens and dispatches are the card's; the wall is
    not.  Run: ``python3 -c "import chip_smoke as c; c.rehearse_serve_perf()"``."""
    import types
    import torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import mistral
    cfg = mistral.MistralConfig.tiny(vocab=256, hidden=64, layers=2, heads=4, kv_heads=2,
                                     seq=4096, window=4096)
    full = mistral.MistralConfig.mistral_7b()
    params = mistral.init_params(cfg, torch.Generator().manual_seed(seed))

    def cost(config, n, t, b, block_size, dtype):
        return mistral.paged_bucket_cost(full, n, t, b, block_size, torch.bfloat16)

    model = types.SimpleNamespace(forward_paged=mistral.forward_paged,
                                  init_paged_cache=mistral.init_paged_cache,
                                  paged_bucket_cost=cost)
    engine = InferenceEngineV2(model, cfg, params, device="cpu",
                               config={"dtype": "float32", "serving_perf": {"enabled": True}},
                               num_blocks=2048, block_size=16, max_blocks_per_seq=256,
                               token_budget=512, max_seqs_per_step=32)
    prompts = serve_prompts(seed, cfg.vocab_size)
    engine.generate(prompts, max_new_tokens=32, strict=False)
    engine.roofline.reset()
    c0 = engine.counters.snapshot()
    engine.generate(prompts, max_new_tokens=32, strict=False)
    d = engine.counters.delta_since(c0)
    roof = engine.roofline
    log(f"[rehearse-serve-perf] CPU, tiny width, costs at mistral_7b width in bf16: warm serve "
        f"{d['loop_iterations']} iterations, {d['host_syncs']} host syncs, {roof.dispatches} "
        f"costed dispatches ({roof.uncosted_dispatches} uncosted) of {roof.tokens} tokens, "
        f"{len(roof._costs)} costed buckets; {roof.bytes:.6e} bytes ({roof.bytes / roof.tokens:.6e} "
        f"a token), {roof.flops:.6e} FLOPs; tokens by burst {d['burst_tokens']} / by step "
        f"{d['step_tokens']}; at {HBM_BYTES_PER_S / 1e9:.0f} GB/s the bytes take "
        f"{roof.bytes / HBM_BYTES_PER_S:.4f} s, at 989 TFLOP/s the FLOPs "
        f"{roof.flops / 989e12:.4f} s")
    return roof.snapshot()


def rehearse_serve_journal(step_ms=5.0, position_us=25.5, seed=0):
    """CPU rehearsal of [serve-journal] and [serve-recover], for a
    prediction: [serve]'s 16 prompts, pool and scheduler through the fast
    path at a tiny width (vocabulary 256) on the CPU, on the modeled clock
    of :func:`rehearse_serve_latency`.  Journal on (throughput mode) against
    off: ServeCounters, tokens, the journal's frames and its host time (a
    timer around each journal call); its bytes with the admit records of
    [serve]'s real prompts (token ids below 32000) in place of the
    rehearsal's.  Then the in-process crash at the 2nd writing flush of a
    strict journal and the recovery: where the crash falls, the recovered
    prefixes, and the modeled device time before and after it.  Run:
    ``python3 -c "import chip_smoke as c; c.rehearse_serve_journal()"``."""
    import types
    import torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, ServingSupervisor
    from deepspeed_tpu_torch.inference.v2.journal import RequestJournal, replay_journal
    from deepspeed_tpu_torch.models import mistral
    from deepspeed_tpu_torch.utils.wal import encode_frame, scan_frames
    cfg = mistral.MistralConfig.tiny(vocab=256, hidden=64, layers=2, heads=4, kv_heads=2,
                                     seq=4096, window=4096)
    params = mistral.init_params(cfg, torch.Generator().manual_seed(seed))
    now = [0.0]

    def forward_paged(config, p, tokens, *args, **kw):
        now[0] += (step_ms + position_us * tokens.numel() / 1e3) / 1e3
        return mistral.forward_paged(config, p, tokens, *args, **kw)

    model = types.SimpleNamespace(forward_paged=forward_paged,
                                  init_paged_cache=mistral.init_paged_cache)

    def engine():
        return InferenceEngineV2(model, cfg, params, clock=lambda: now[0], device="cpu",
                                 config={"dtype": "float32", "seed": seed}, num_blocks=2048,
                                 block_size=16, max_blocks_per_seq=256, token_budget=512,
                                 max_seqs_per_step=32)

    prompts = serve_prompts(seed, cfg.vocab_size)
    path = out_path("rehearse_serve_journal.wal")
    on, off = engine(), engine()
    on.journal = RequestJournal(path, fsync_every=0, seed=seed)
    host = [0.0, 0]
    for name in ("record_admit", "note_token_map", "flush", "record_terminal"):
        def timed(*a, _fn=getattr(on.journal, name), **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                host[0] += time.perf_counter() - t0
                host[1] += 1
        setattr(on.journal, name, timed)
    on.journal.open_generation(0)
    r_on = on.generate(prompts, max_new_tokens=32, strict=False)
    on.journal.close()
    r_off = off.generate(prompts, max_new_tokens=32, strict=False)
    if on.counters.snapshot() != off.counters.snapshot() or \
            [r.tokens for r in r_on] != [r.tokens for r in r_off]:
        raise AssertionError("[rehearse-journal] the journal changed the counters or tokens")
    frames = scan_frames(path)[0]
    admits = [f for f in frames if f.startswith(b'{"t":"admit"')]
    real = serve_prompts(seed, 32000)
    scratch = RequestJournal(out_path("rehearse_admits.wal"), fsync_every=0, seed=seed)
    real_admit_bytes = 0
    for uid, prompt in enumerate(real):
        scratch.record_admit(uid, prompt, max_new_tokens=32, prefix_len=0)
    for rec in scratch._record_buffer:
        real_admit_bytes += len(encode_frame(json.dumps(rec, separators=(",", ":")).encode()))
    size = os.path.getsize(path)
    predicted = size - sum(len(encode_frame(f)) for f in admits) + real_admit_bytes
    c = on.counters.snapshot()
    log(f"[rehearse-journal] CPU, tiny width: {on.forward_steps} forward steps, "
        f"{c['host_syncs']} host syncs, {c['loop_iterations']} loop iterations, counters and "
        f"tokens equal journal on and off; journal {size} bytes in {len(frames)} frames "
        f"({sum(f[:1] == b'\x01' for f in frames)} token frames); with [serve]'s real prompt "
        f"ids {predicted} bytes; journal calls {host[1]} in {host[0] * 1e3:.3f} ms of host time")
    marks, builds = {}, []

    def factory():
        e = engine()
        if not builds:
            e.journal = crashy_journal(out_path("rehearse_serve_recover.wal"), fsync_every=1,
                                       seed=seed, marks=marks)
        builds.append((e, now[0]))
        return e

    start = now[0]
    sup = ServingSupervisor(factory, journal_path=os.path.join(OUT_DIR,
                                                               "rehearse_serve_recover.wal"),
                            config={"max_restarts": 2})
    out = sup.serve(prompts, max_new_tokens=32)
    state = replay_journal(os.path.join(OUT_DIR, "rehearse_serve_recover.wal"))
    prefixes = sorted(e.prefix_len for e in state.entries.values() if e.prefix_len)
    survivor, rebuilt_at = builds[-1]
    log(f"[rehearse-journal] crash at the 2nd writing flush after {builds[0][0].forward_steps} "
        f"forward steps ({rebuilt_at - start:.3f} s modeled), {sup.restarts_total} restart, "
        f"{sum(r.ok for r in out)} ok, {len(prefixes)} recovered with prefixes {prefixes}; the "
        f"recovery serve {survivor.forward_steps} forward steps, "
        f"{survivor.counters.host_syncs} host syncs, {now[0] - rebuilt_at:.3f} s modeled; "
        f"{sum(a.tokens == b.tokens for a, b in zip(out, r_off))} of {len(out)} streams equal "
        f"the uninterrupted run's")
    return {"bytes": predicted, "frames": len(frames), "host_ms": host[0] * 1e3}


def first_divergence(a, b, prompts):
    """For each request, the first generated position where two serves'
    tokens differ (None where they agree)."""
    return [_first_diff(x.tokens[len(p):], y.tokens[len(p):]) for p, x, y in zip(prompts, a, b)]


def phase_serve(card, seed=0):
    import torch
    from deepspeed_tpu_torch.runtime.tree import tree_leaves
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    from deepspeed_tpu_torch.models.mistral import MistralConfig, init_params, num_params
    from deepspeed_tpu_torch.ops.attention.paged import paged_attention
    cfg = MistralConfig.mistral_7b()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(params))
    if n_params != num_params(cfg):
        raise AssertionError(f"init_params made {n_params} params, num_params says "
                             f"{num_params(cfg)}")
    num_blocks, block_size = 2048, 16
    kw = dict(device="cuda", num_blocks=num_blocks, block_size=block_size,
              max_blocks_per_seq=256, token_budget=512, max_seqs_per_step=32)
    engine = build_engine("mistral", cfg, params, config={"dtype": "bfloat16", "seed": seed},
                          **kw)
    if not (engine.fastpath.enabled and engine.programs.graphs):
        raise AssertionError("the default engine on CUDA does not run the fast path's graphs")
    torch.cuda.synchronize()
    log(f"[serve] mistral_7b: {n_params / 1e9:.3f} B params "
        f"({sum(p.numel() * p.element_size() for p in tree_leaves(params)) / 1e9:.2f} GB bf16), "
        f"KV pool {sum(v.numel() * v.element_size() for v in engine.kv.values()) / 2**30:.2f} "
        f"GiB, set up in {time.perf_counter() - t0:.2f} s")
    prompts = serve_prompts(seed, cfg.vocab_size)
    n_prompt = sum(len(p) for p in prompts)
    max_new = 32
    paged_attention.launches = paged_attention.tc_launches = paged_attention.decode_launches = 0
    steps0 = engine.forward_steps
    widths0 = dict(engine.chunk_widths)
    counters0 = engine.counters.snapshot()
    results, wall = serve_timed(engine, prompts, max_new)
    launches, tc_launches = paged_attention.launches, paged_attention.tc_launches
    decode_launches = paged_attention.decode_launches
    steps = engine.forward_steps - steps0
    widths = {t: k - widths0.get(t, 0) for t, k in engine.chunk_widths.items()
              if k > widths0.get(t, 0)}
    _, tc_steps, decode_steps = route_launches(widths, 1, torch.bfloat16)
    check_serve_results("serve", engine, prompts, results, max_new, cfg.vocab_size)
    if launches != steps * cfg.num_layers:
        raise AssertionError(f"paged_attention launched {launches} times over {steps} forward "
                             f"steps x {cfg.num_layers} layers")
    if tc_launches != tc_steps * cfg.num_layers:
        raise AssertionError(f"paged_attention launched the tensor-core prefill kernel "
                             f"{tc_launches} times; {tc_steps} steps of chunk width >= 16 "
                             f"({widths}) x {cfg.num_layers} layers")
    if decode_launches != decode_steps * cfg.num_layers:
        raise AssertionError(f"paged_attention launched the split-K decode kernel "
                             f"{decode_launches} times; {decode_steps} steps of chunk width < 16 "
                             f"({widths}) x {cfg.num_layers} layers")
    generated = max_new * len(prompts)
    log(f"[serve] {len(prompts)} requests ({n_prompt} prompt tokens, "
        f"{generated} generated) all ok on {card}: wall {wall:.3f} s, "
        f"{generated / wall:.1f} generated tok/s, {(n_prompt + generated) / wall:.1f} "
        f"total tok/s, {steps} forward steps (a burst of k counts k), mean step "
        f"{wall / steps * 1e3:.2f} ms, "
        f"paged_attention launches {launches} = {steps} x {cfg.num_layers}, of them "
        f"tensor-core prefill {tc_launches} = {tc_steps} steps of chunk width >= 16 x "
        f"{cfg.num_layers}, split-K decode {decode_launches} = {decode_steps} steps of chunk "
        f"width < 16 x {cfg.num_layers} (steps by padded chunk width "
        f"{dict(sorted(widths.items()))}), "
        f"{engine.tokens_run} real tokens in {engine.positions_run} padded positions")
    first = log_fastpath("serve", engine, counters0, 0, card)
    if first["host_syncs"] >= steps:
        raise AssertionError(f"{first['host_syncs']} host syncs for {steps} forward steps: the "
                             f"decode did not fuse")
    # nothing is shared between these prompts: the prefix cache and the KV
    # census (both on by default) must leave the loop's counts as they were
    pc = engine.health()["prefix_cache"]
    if (steps, first["host_syncs"]) != (SERVE_STEPS, SERVE_HOST_SYNCS) or pc["hit_blocks_total"]:
        raise AssertionError(f"[serve] {steps} forward steps and {first['host_syncs']} host "
                             f"syncs (expected {SERVE_STEPS} and {SERVE_HOST_SYNCS}), prefix "
                             f"cache {pc}")
    # the same serve again: every bucket is built, so nothing is captured
    counters1, built, paged1 = engine.counters.snapshot(), engine.ledger.total, paged_counts()
    again, wall2 = serve_timed(engine, prompts, max_new)
    warm_launches = tuple(b - a for a, b in zip(paged1, paged_counts()))
    if engine.ledger.total != built or engine.ledger.warm_total:
        raise AssertionError(f"the second serve built {engine.ledger.total - built} programs "
                             f"({engine.ledger.warm_total} warm)")
    if [r.tokens for r in again] != [r.tokens for r in results]:
        raise AssertionError(f"the second serve's tokens differ from the first's at "
                             f"{first_divergence(results, again, prompts)}")
    log(f"[serve] second serve of the same prompts on {card}: wall {wall2:.3f} s, 0 captures, "
        f"tokens identical to the first serve, paged launches (total, tensor-core prefill, "
        f"split-K decode) {warm_launches}")
    warm = log_fastpath("serve", engine, counters1, built, card)
    with phase_timer("serve-journal"):
        phase_serve_journal(card, engine, prompts, max_new, results)
    with phase_timer("serve-tracing"):
        serve_tracing(card, cfg, params, kw, engine, prompts, max_new, results, first, warm,
                      wall2)
    for tag, fn in (("serve-perf", serve_perf), ("serve-ops", serve_ops),
                    ("serve-telemetry", serve_telemetry)):
        with phase_timer(tag):
            fn(card, cfg, params, kw, engine, prompts, max_new, results, first, warm, wall2)
    with phase_timer("profile"):
        busy = {"fast path": profile_serve(engine, prompts, max_new, card, wall2)}
    with phase_timer("serve-pairs"):
        serve_pairs(card, cfg, params, kw, engine, prompts, max_new, busy)
    del engine
    torch.cuda.empty_cache()
    with phase_timer("serve-recover"):
        phase_serve_recover(card, cfg, params, kw, prompts, max_new, results, seed)
    torch.cuda.empty_cache()
    with phase_timer("serve-prefix"):
        prefix = phase_serve_prefix(card, cfg, params, kw, seed)
    with phase_timer("serve-qos"):
        serve_qos(card, cfg, params, kw, prompts, max_new, results, first, warm, warm_launches,
                  seed)
    with phase_timer("serve-fleet"):
        serve_fleet(card, cfg, params, kw, seed)
    with phase_timer("serve-spec"):
        spec = serve_spec(card, cfg, params, kw, prompts, max_new, results, wall2, seed)
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "tc_launches": tc_launches, "decode_launches": decode_launches,
            "serve_prefix": prefix, "serve_spec": spec}


def serve_tracing(card, cfg, params, kw, off, prompts, max_new, results, first, warm, wall_off):
    """[serve] with request tracing on: a second engine, tracing on and a
    Chrome trace under chiprun_out/, serves the same prompts cold and then
    warm in turns with the tracing-off engine (on, off, on).  Gates: every
    serve's ServeCounters equal to the tracing-off engine's (the cold one's
    to its first serve, captures included; the warm ones' to its warm
    serve: 62 forward steps, 47 host syncs), the same tokens, a complete
    span chain ending ``ok`` for each of the 16 requests, and a Chrome
    trace that parses with one track per request and the ``kv_pool``
    counter track.  Prints the last traced serve's TTFT, TBT, end-to-end and
    queue-wait percentiles, and the walls with tracing on and off (not
    gated)."""
    import torch
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                        "serve_chrome_trace.json")
    if os.path.exists(path):
        os.remove(path)
    traced = build_engine("mistral", cfg, params, **kw, config={
        "dtype": off.config.dtype, "seed": off.config.seed,
        "serving_tracing": {"enabled": True, "chrome_trace_path": path}})
    engines = {"on": traced, "off": off}
    walls = {"on": [], "off": [wall_off]}

    def serve(name, want, label):
        e = engines[name]
        sink = e.tracer.telemetry = TraceSink()
        e.tracer.reset_histograms()
        c0 = e.counters.snapshot()
        got, wall = serve_timed(e, prompts, max_new)
        d = e.counters.delta_since(c0)
        if d != want:
            raise AssertionError(f"[serve-tracing] tracing {name}, {label}: ServeCounters {d}, "
                                 f"the tracing-off engine's {want}")
        if [r.tokens for r in got] != [r.tokens for r in results]:
            raise AssertionError(f"[serve-tracing] tracing {name}, {label}: tokens differ at "
                                 f"{first_divergence(results, got, prompts)}")
        if name == "on":
            check_trace_chains("serve-tracing", sink, got)
        elif sink.records:
            raise AssertionError("[serve-tracing] the tracing-off engine exported traces")
        return wall

    wall_cold = serve("on", first, "cold serve")
    for name in ("on", "off", "on"):
        walls[name].append(serve(name, warm, "warm serve"))
    n_events, n_counter = check_chrome_trace("serve-tracing", path, len(prompts))
    tr = traced.tracer
    log(f"[serve-tracing] tracing on, {card}: cold serve {wall_cold:.3f} s with ServeCounters "
        f"equal to the tracing-off engine's first serve ({first['compiles']} captures); warm "
        f"serves with ServeCounters equal to its warm serve ({warm['host_syncs']} host syncs), "
        f"tokens identical, {len(prompts)} complete span chains ending ok in each traced serve; "
        f"Chrome trace {os.path.relpath(path)}: {n_events} events, {len(prompts)} request "
        f"tracks, {n_counter} kv_pool samples")
    log(f"[serve-tracing] last traced warm serve on {card}: {latency_line(tr)}")
    cost = statistics.mean(walls["on"]) - statistics.mean(walls["off"])
    log(f"[serve-tracing] warm walls in turns (off, on, off, on) on {card}: tracing off "
        + ", ".join(f"{w:.3f}" for w in walls["off"]) + " s, on "
        + ", ".join(f"{w:.3f}" for w in walls["on"]) + f" s; tracing costs {cost * 1e3:+.1f} ms "
        f"a serve ({cost / statistics.mean(walls['off']):+.2%}, not gated); recorder "
        f"{tr.recorder.events_total} events, {tr.completed_total} traces completed")
    del traced, engines
    torch.cuda.empty_cache()


def observed_turns(tag, card, engine, off, prompts, max_new, results, first, warm, wall_off,
                   before=None):
    """A second engine of [serve]'s model with an observability feature on:
    its cold serve, then warm serves in turns with the feature-off engine
    ``off`` (on, off, on).  Every serve's ServeCounters equal the off
    engine's (the cold one's its first serve, captures included; the warm
    ones' its warm serve) and its tokens [serve]'s.  ``before(engine)``
    runs before each warm serve of ``engine`` (a reset, a scraper).
    Returns (cold wall, walls by side, the last warm serve's results)."""
    engines = {"on": engine, "off": off}
    walls = {"on": [], "off": [wall_off]}

    def serve(name, want, label):
        e = engines[name]
        if before is not None and name == "on" and label == "warm serve":
            before(e)
        c0 = e.counters.snapshot()
        got, wall = serve_timed(e, prompts, max_new)
        d = e.counters.delta_since(c0)
        if d != want:
            raise AssertionError(f"[{tag}] {name}, {label}: ServeCounters {d}, the feature-off "
                                 f"engine's {want}")
        if [r.tokens for r in got] != [r.tokens for r in results]:
            raise AssertionError(f"[{tag}] {name}, {label}: tokens differ at "
                                 f"{first_divergence(results, got, prompts)}")
        return got, wall

    _, wall_cold = serve("on", first, "cold serve")
    last = None
    for name in ("on", "off", "on"):
        got, wall = serve(name, warm, "warm serve")
        walls[name].append(wall)
        last = got if name == "on" else last
    cost = statistics.mean(walls["on"]) - statistics.mean(walls["off"])
    log(f"[{tag}] on {card}: cold serve {wall_cold:.3f} s with ServeCounters equal to the "
        f"feature-off engine's first serve ({first['compiles']} captures); warm serves with "
        f"ServeCounters equal to its warm serve ({warm['host_syncs']} host syncs), tokens "
        f"identical; warm walls in turns (off, on, off, on): off "
        + ", ".join(f"{w:.3f}" for w in walls["off"]) + " s, on "
        + ", ".join(f"{w:.3f}" for w in walls["on"]) + f" s; on costs {cost * 1e3:+.1f} ms a "
        f"serve ({cost / statistics.mean(walls['off']):+.2%}, not gated)")
    return wall_cold, walls, last


def serve_perf(card, cfg, params, kw, off, prompts, max_new, results, first, warm, wall_off):
    """[serve-perf]: [serve]'s engine config with ``serving_perf`` on
    (``peak_flops_per_chip`` 989e12; ``hbm_gbps_spec`` the default 3350),
    cold and then warm in turns with the observatory-off engine.  The
    profiler and the roofline are reset before each warm serve; on the last
    one: every phase of ``PHASES`` sampled, the per-phase totals summing to
    the profiler's wall within 1e-6 s, no warm recompile over the engine's
    life, ``counters.compiles == ledger.total``, no uncosted dispatch and
    finite roofline gauges.  Prints the per-phase totals, p50 and p99, the
    roofline against the card's bandwidth and peak, and the burst share of
    tokens (bursts are not dispatched through the roofline)."""
    import torch
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    from deepspeed_tpu_torch.monitor.perf import PHASES
    engine = build_engine("mistral", cfg, params, **kw, config={
        "dtype": off.config.dtype, "seed": off.config.seed,
        "serving_perf": {"enabled": True, "peak_flops_per_chip": TRAIN_PEAK_FLOPS}})

    def reset(e):
        e.phase_profiler.reset()
        e.roofline.reset()

    _, walls, _ = observed_turns("serve-perf", card, engine, off, prompts, max_new, results,
                                 first, warm, wall_off, before=reset)
    snap = engine.health()["perf"]
    prof, roof, led = engine.phase_profiler, engine.roofline, engine.ledger
    empty = [p for p in PHASES if prof.hists[p].count == 0]
    span_err = abs(sum(prof.totals.values()) - prof.wall_s)
    gauges = roof.gauges(prof.wall_s)
    if (empty or span_err > 1e-6 or led.warm_total or engine.counters.compiles != led.total
            or roof.uncosted_dispatches or not all(np.isfinite(v) for v in gauges.values())):
        raise AssertionError(f"[serve-perf] phases never sampled {empty}, spans off the wall by "
                             f"{span_err:.3e} s, warm recompiles {led.warm_total}, compiles "
                             f"{engine.counters.compiles} vs ledger {led.total}, uncosted "
                             f"dispatches {roof.uncosted_dispatches}, gauges {gauges}")
    phases = "; ".join(f"{p} {snap['phases'][p]['total_s'] * 1e3:.3f} ms (p50 "
                       f"{snap['phases'][p]['p50'] * 1e3:.4f}, p99 "
                       f"{snap['phases'][p]['p99'] * 1e3:.4f} ms, n={snap['phases'][p]['count']})"
                       for p in PHASES)
    log(f"[serve-perf] last warm serve on {card}: {prof.iterations} iterations over a profiler "
        f"wall of {prof.wall_s:.6f} s (serve wall {walls['on'][-1]:.3f} s), spans summing to "
        f"it within {span_err:.1e} s; {phases}")
    d = warm
    burst = d["burst_tokens"] / max(d["burst_tokens"] + d["step_tokens"], 1)
    log(f"[serve-perf] roofline on {card}: {len(roof._costs)} costed buckets, {roof.dispatches} "
        f"dispatches ({roof.uncosted_dispatches} uncosted) of {roof.tokens} tokens, "
        f"{roof.bytes:.6e} bytes and {roof.flops:.6e} FLOPs (analytic least cost, "
        f"models.llama.paged_bucket_cost); hbm_bytes_per_token "
        f"{gauges['serving_hbm_bytes_per_token']:.6e}, roofline_fraction "
        f"{gauges['serving_roofline_fraction']:.6f} of {roof.hbm_gbps_spec:.0f} GB/s, "
        f"model_flops_utilization {gauges['serving_model_flops_utilization']:.6f} of "
        f"{TRAIN_PEAK_FLOPS / 1e12:.0f} TFLOP/s; the roofline covers stepwise dispatches only: "
        f"tokens by burst {d['burst_tokens']} / by step {d['step_tokens']} (burst share "
        f"{burst:.1%}); compile ledger {json.dumps(led.snapshot()['by_site'])}, warm 0")
    del engine
    torch.cuda.empty_cache()


def serve_ops(card, cfg, params, kw, off, prompts, max_new, results, first, warm, wall_off):
    """[serve-ops]: [serve]'s engine config with ``ops_server`` on
    (127.0.0.1, port 0, refresh 0.25 s) and tracing on, cold and then warm
    in turns with the ops-off engine, a thread scraping /metrics and
    /healthz through each warm serve.  Gates on the last one: at least one
    mid-serve /metrics scrape strict-parses; after it
    ``dstpu_serving_completed_total`` equals ``manager.completed_requests``
    and rose by 16 over the serve, ``dstpu_fastpath_host_syncs_total``
    equals ``counters.host_syncs``, the TTFT/TBT/e2e histograms are not
    empty, /healthz equals ``health()`` through JSON and /statez has the
    flight recorder's tail.  Prints the scrapes and the walls."""
    import threading
    import torch
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    from deepspeed_tpu_torch.monitor.exposition import parse_exposition
    from deepspeed_tpu_torch.monitor.ops_server import scrape
    engine = build_engine("mistral", cfg, params, **kw, config={
        "dtype": off.config.dtype, "seed": off.config.seed,
        "serving_tracing": {"enabled": True},
        "ops_server": {"enabled": True, "host": "127.0.0.1", "port": 0,
                       "refresh_interval_s": 0.25}})
    url = engine.ops.url
    state = {}

    def counter(fams, name):
        return sum(v for _, _, v in fams[name]["samples"])

    def scraper(stop):
        while not stop.is_set():
            try:
                fams = parse_exposition(scrape(url("/metrics")))
                json.loads(scrape(url("/healthz")))
            except Exception as exc:
                state["errors"].append(repr(exc))
                return
            state["scrapes"] += 1
            state["completed"].append(counter(fams, "dstpu_serving_completed_total"))
            stop.wait(0.05)

    def start(e):
        for t in state.get("threads", []):
            t[0].set()
            t[1].join(timeout=10.0)
        state.update(scrapes=0, errors=[], completed=[], threads=[],
                     before=counter(parse_exposition(scrape(url("/metrics"))),
                                    "dstpu_serving_completed_total"))
        stop = threading.Event()
        thread = threading.Thread(target=scraper, args=(stop, ), daemon=True)
        thread.start()
        state["threads"].append((stop, thread))

    try:
        _, walls, _ = observed_turns("serve-ops", card, engine, off, prompts, max_new, results,
                                     first, warm, wall_off, before=start)
    finally:
        for stop, thread in state.get("threads", []):
            stop.set()
            thread.join(timeout=10.0)
    try:
        fams = parse_exposition(scrape(url("/metrics")))
        completed = counter(fams, "dstpu_serving_completed_total")
        empty = [name for name in ("ttft", "tbt", "e2e")
                 if not counter(fams, f"dstpu_request_{name}_seconds")]
        health = json.loads(scrape(url("/healthz")))
        statez = json.loads(scrape(url("/statez")))
        if (state["errors"] or not state["scrapes"]
                or completed != engine.manager.completed_requests
                or completed - state["before"] != len(prompts)
                or counter(fams, "dstpu_fastpath_host_syncs_total") != engine.counters.host_syncs
                or empty or health != json.loads(json.dumps(engine.health()))
                or not statez["flight_recorder"]):
            raise AssertionError(
                f"[serve-ops] scrapes {state['scrapes']} (errors {state['errors']}), completed "
                f"{state['before']} -> {completed} (manager {engine.manager.completed_requests}), "
                f"host syncs {counter(fams, 'dstpu_fastpath_host_syncs_total')} vs "
                f"{engine.counters.host_syncs}, empty histograms {empty}, /healthz equal "
                f"{health == json.loads(json.dumps(engine.health()))}, flight recorder "
                f"{len(statez['flight_recorder'])}")
        log(f"[serve-ops] last warm serve on {card}: {state['scrapes']} /metrics + /healthz "
            f"scrapes during it, all strict-parsed (completed seen "
            f"{sorted(set(state['completed']))}); after it dstpu_serving_completed_total "
            f"{completed:.0f} = manager.completed_requests, up {completed - state['before']:.0f}; "
            f"host syncs {engine.counters.host_syncs}; TTFT/TBT/e2e histograms filled; /healthz "
            f"= health(), /statez {len(statez['flight_recorder'])} recorder events; "
            f"{len(fams)} families; {engine._ops.cache.refreshes} refreshes")
    finally:
        engine.close_ops()
    del engine
    torch.cuda.empty_cache()


# [serve-telemetry]'s capture window in serve iterations: [serve]'s iterations
# 0-30 are prefill steps (chunks of 512 and 256) and 31-46 decode, so four
# iterations across the change of route see both paged kernels
SERVE_WINDOW = (29, 33)


def serve_telemetry(card, cfg, params, kw, off, prompts, max_new, results, first, warm,
                    wall_off):
    """[serve-telemetry]: [serve]'s engine config with tracing on and a
    ``TelemetryCollector`` attached (JSONL under chiprun_out/, a serve
    window over iterations :data:`SERVE_WINDOW` of each generate()), cold and then warm
    in turns with the plain engine, in a phase of its own (one profiler at a
    time).  Gates: ``kind: gauges`` records under Inference/Serving and
    Inference/Scheduler, one ``kind: trace`` record per request of each
    serve, and a Chrome trace of each serve's window that names the paged
    decode and prefill kernels."""
    import torch
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    from deepspeed_tpu_torch.monitor.telemetry import TelemetryCollector
    from deepspeed_tpu_torch.runtime.config import TelemetryConfig
    out = os.path.join(OUT_DIR, "serve_telemetry")
    shutil.rmtree(out, ignore_errors=True)  # an earlier run's records and traces
    collector = TelemetryCollector(TelemetryConfig(
        jsonl_path=os.path.join(out, "telemetry.jsonl"), jsonl_flush_every=64,
        profile_serve_iteration_start=SERVE_WINDOW[0],
        profile_serve_iteration_stop=SERVE_WINDOW[1], profile_dir=os.path.join(out, "traces")))
    engine = build_engine("mistral", cfg, params, **kw, telemetry=collector, config={
        "dtype": off.config.dtype, "seed": off.config.seed,
        "serving_tracing": {"enabled": True}})
    observed_turns("serve-telemetry", card, engine, off, prompts, max_new, results, first, warm,
                   wall_off)
    collector.close()
    with open(os.path.join(out, "telemetry.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    kinds = collections.Counter((r["kind"], r.get("prefix")) for r in records)
    traces = [r for r in records if r["kind"] == "trace"]
    found = {}
    for path in collector.traces_written:
        with open(path) as fh:
            names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
        found[path] = {label for label, needle in PAGED_NEEDLES
                       if any(needle in n for n in names)}
    serves = 3  # cold, then two warm serves with the collector attached
    if (not kinds[("gauges", "Inference/Serving")] or not kinds[("gauges", "Inference/Scheduler")]
            or len(traces) != serves * len(prompts)
            or {r["status"] for r in traces} != {"ok"}
            or len(found) != serves
            or any(not {"paged_decode", "paged_prefill_tc"} <= f for f in found.values())):
        raise AssertionError(f"[serve-telemetry] records {dict(kinds)}, {len(traces)} traces "
                             f"(want {serves} x {len(prompts)}), kernels by trace file {found}")
    sizes = [os.path.getsize(p) for p in collector.traces_written]
    log(f"[serve-telemetry] on {card}: {len(records)} JSONL records "
        + ", ".join(f"{k}{'/' + p if p else ''} {n}" for (k, p), n in sorted(kinds.items()))
        + f"; {len(sizes)} Chrome traces (one a serve, iterations {SERVE_WINDOW[0]}-"
        f"{SERVE_WINDOW[1] - 1}), "
        + ", ".join(f"{b / 2**20:.2f}" for b in sizes)
        + f" MiB, each naming {sorted(set.union(*found.values()))}")
    del engine
    torch.cuda.empty_cache()


def serve_pairs(card, cfg, params, kw, fast, prompts, max_new, busy):
    """The parent's loop (``serving_fastpath.enabled=False``: rebuild and
    upload every step, one sync a step, pow2 table widths, eager bursts)
    against the fast path on the same prompts: the reference engine's first
    serve (its warm-up, untimed), then two pairs in turns (reference, fast,
    fast, reference): wall of each timed serve,
    device busy time of each loop from one profiled serve, idle share.  In
    bf16 the two loops may pick different split-K widths (pow2 against
    stepped tables), so tokens can differ: the first diverging position of
    each request is printed, not gated."""
    import torch
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    ref = build_engine("mistral", cfg, params, config={"dtype": "bfloat16", "seed": 0,
                                                       "serving_fastpath": {"enabled": False}},
                       **kw)
    engines = {"reference": ref, "fast path": fast}
    walls = {name: [] for name in engines}
    outs = {}
    ref.generate(prompts, max_new_tokens=max_new, strict=False)
    for name in ("reference", "fast path", "fast path", "reference"):
        outs[name], wall = serve_timed(engines[name], prompts, max_new)
        walls[name].append(wall)
    busy["reference"] = profile_device(
        lambda: ref.generate(prompts, max_new_tokens=max_new, strict=False), card, "profile",
        "reference-loop serve", walls["reference"][-1] * 1e3, PAGED_NEEDLES)
    for name, ws in walls.items():
        b = busy[name]
        log(f"[serve-pairs] {name} on {card}: walls in turns "
            + ", ".join(f"{w:.3f}" for w in ws)
            + f" s (mean {statistics.mean(ws):.3f}); device busy "
            + ("not measured" if b is None else
               f"{b:.1f} ms, idle " + ", ".join(f"{1 - b / (w * 1e3):.1%}" for w in ws)))
    log(f"[serve-pairs] first generated position where the reference loop's tokens differ from "
        f"the fast path's, by request: {first_divergence(outs['reference'], outs['fast path'], prompts)}")
    del ref, engines
    torch.cuda.empty_cache()


PAGED_NEEDLES = (("paged_decode", "paged_decode_kernel"),
                 ("paged_decode_merge", "paged_decode_merge_kernel"),
                 ("paged_prefill_tc", "paged_prefill_tc_kernel"),
                 ("paged_cuda_core", "paged_attention_kernel"))


def profile_serve(engine, prompts, max_new, card, wall_s):
    """Serve the same requests again under torch.profiler: device time split
    into the paged split-K decode kernel, its merge, the tensor-core prefill
    and the CUDA-core kernel, matrix products and the rest; the timed run
    (``wall_s``) is not profiled.  Returns the device's busy ms."""
    return profile_device(lambda: engine.generate(prompts, max_new_tokens=max_new, strict=False),
                          card, "profile", "serve", wall_s * 1e3, PAGED_NEEDLES)


MATMUL_NEEDLES = ("gemm", "nvjet", "xmma", "cutlass", "sm90")


def profile_device(run, card, tag, label, wall_ms, needles, top=12):
    """``run()`` once more under torch.profiler: device time by kernel group
    (``needles``: (group, substring of the kernel name) pairs; then matrix
    products and the rest), and the top ``top`` kernels.  The device's idle
    share is its busy time against ``wall_ms``, the unprofiled run's wall,
    since the profiler slows the host down.  Returns the busy ms (None where
    the profiler saw no CUDA kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3
    groups = {key: 0.0 for key, _ in needles}
    groups.update(matmul=0.0, other=0.0)
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append((us / 1e3, evt.count, evt.key))
        name = evt.key.lower()
        key = next((key for key, needle in needles if needle in name), None)
        if key is None:
            key = "matmul" if any(k in name for k in MATMUL_NEEDLES) else "other"
        groups[key] += us / 1e3
    busy = sum(groups.values())
    if busy == 0.0:
        log(f"[{tag}] device time not measured: the profiler saw no CUDA kernels")
        return None
    shares = ", ".join(f"{k} {v:.1f} ms ({v / busy:.1%})" for k, v in groups.items() if v)
    log(f"[{tag}] {label} under torch.profiler on {card}: device busy {busy:.1f} ms, "
        f"{busy / wall_ms:.1%} of the unprofiled {label}'s {wall_ms:.1f} ms (idle "
        f"{1 - busy / wall_ms:.1%}; the profiled {label} took {prof_ms:.1f} ms); {shares}")
    for ms, count, name in sorted(kernels, reverse=True)[:top]:
        log(f"[{tag}]   {ms:9.2f} ms {count:6d} calls  {name[:110]}")
    return busy


# ------------------------------------------------------------------ phase 4
def phase_slice(seed=1):
    """2-layer full-width Mistral in fp32: kernel path on CUDA vs plain path
    on a CPU copy, same weights and KV state."""
    import torch
    from deepspeed_tpu_torch.runtime.tree import tree_map
    from deepspeed_tpu_torch.models import mistral
    from deepspeed_tpu_torch.ops.attention.paged import paged_attention
    cfg = dataclasses.replace(mistral.MistralConfig.mistral_7b(), num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = mistral.init_params(cfg, gen, dtype=torch.float32, device="cuda")
    params_cpu = tree_map(lambda t: t.cpu(), params)
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
    paged_attention.launches = paged_attention.tc_launches = paged_attention.decode_launches = 0
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
    # the fp32 prefill chunk (T = 128) on the CUDA-core kernel, the three
    # decode steps on the split-K decode kernel, in each layer
    counts = (paged_attention.launches, paged_attention.tc_launches,
              paged_attention.decode_launches)
    if counts != (4 * cfg.num_layers, 0, 3 * cfg.num_layers):
        raise AssertionError(f"slice: paged_attention (launches, tensor-core, decode) {counts}, "
                             f"expected one CUDA-core prefill and three decode steps x "
                             f"{cfg.num_layers} layers")
    # every block but the trash block, which takes the padded tokens' colliding writes
    kv_err = max((kv[k][:, :-1].cpu() - kv_cpu[k][:, :-1]).abs().max().item()
                 for k in ("k", "v"))
    log(f"[slice] mistral_7b width, 2 layers, fp32: prefill + 3 decode steps, CUDA kernel path "
        f"vs CPU plain path: max logit abs err {worst:.3e} (atol=rtol=2e-3), KV max abs err "
        f"{kv_err:.3e}, greedy picks identical; paged launches: CUDA-core "
        f"{counts[0] - counts[1] - counts[2]}, split-K decode {counts[2]}")


def serve_waves(engine, prompts, arrivals, max_new):
    """Requests arriving mid-decode (``arrivals``: {step index: [uids]}),
    driven through ``put`` / ``step`` / ``decode_burst`` as the bench's
    mixed-arrival scenario drives them: once the live set is decode-only,
    up to k steps fuse into one burst, capped so arrivals land on their
    step.  Returns each uid's tokens."""
    produced = {u: 0 for u in range(len(prompts))}
    tokens = {}
    pending = dict(arrivals)
    step_i = 0
    while len(tokens) < len(prompts):
        if step_i in pending:
            uids = pending.pop(step_i)
            engine.put(uids, [prompts[u] for u in uids])

        def retire(uid, n_new):
            produced[uid] += n_new
            if produced[uid] >= max_new:
                tokens[uid] = list(engine.manager.seqs[uid].tokens)
                engine.flush(uid)

        live = [u for u, s in engine.manager.seqs.items() if not s.done]
        k = min((max_new - produced[u] for u in live), default=0)
        if pending:
            k = min(k, min(pending) - step_i)
        if k >= 2:
            burst = engine.decode_burst(k)
            if burst is not None:
                for uid, toks in burst.items():
                    retire(uid, len(toks))
                step_i += k
                continue
        out = engine.step()
        if not out and not pending and not engine.manager.seqs:
            raise AssertionError("serve_waves: nothing live and requests unfinished")
        for uid in out:
            retire(uid, 1)
        step_i += 1
    return [tokens[u] for u in range(len(prompts))]


def phase_slice_serve(seed=3):
    """2-layer full-width Mistral in fp32 through ``InferenceEngineV2``: the
    fast path with CUDA graphs, the reference loop eager on CUDA, and the fast
    path on the CPU must give identical tokens, on a closed batch and on
    requests arriving mid-decode.  The prewarm's captures, taken with live
    sequences in the engine and random KV, leave every block but the trash
    block as it was.  A sampled burst and sampled steps from one seed draw
    the same tokens."""
    import torch
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    from deepspeed_tpu_torch.models import mistral
    from deepspeed_tpu_torch.runtime.tree import tree_map
    cfg = dataclasses.replace(mistral.MistralConfig.mistral_7b(), num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = mistral.init_params(cfg, gen, dtype=torch.float32, device="cuda")
    params_cpu = tree_map(lambda t: t.cpu(), params)
    kw = dict(num_blocks=160, block_size=16, max_blocks_per_seq=16, token_budget=64,
              max_seqs_per_step=8)
    fp32 = {"dtype": "float32"}
    engines = {
        "graphs": build_engine("mistral", cfg, params, config=fp32, device="cuda", **kw),
        "eager": build_engine("mistral", cfg, params, device="cuda", **kw,
                              config={**fp32, "serving_fastpath": {"enabled": False}}),
        "cpu": build_engine("mistral", cfg, params_cpu, config=fp32, device="cpu", **kw),
    }
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in (5, 150, 33, 70, 12, 97)]
    max_new = 12
    # prewarm with live sequences over random KV: only the trash block may change
    graphs = engines["graphs"]
    trash = graphs.manager.trash_block
    for pool in graphs.kv.values():
        pool.copy_(torch.randn(pool.shape, generator=gen, device="cuda"))
    graphs.put(list(range(len(prompts))), prompts)
    kv_before = {k: v[:, :trash].clone() for k, v in graphs.kv.items()}
    graphs._prewarm(max_new)
    torch.cuda.synchronize()
    changed = [k for k, v in graphs.kv.items() if not torch.equal(v[:, :trash], kv_before[k])]
    prewarmed = graphs.ledger.count("prewarmed")
    if changed or not prewarmed:
        raise AssertionError(f"slice-serve: the prewarm ({prewarmed} captures) changed KV "
                             f"outside the trash block in {changed}")
    for uid in range(len(prompts)):
        graphs.flush(uid)
    del kv_before
    closed = {name: e.generate(prompts, max_new_tokens=max_new) for name, e in engines.items()}
    arrivals = {0: [0, 1, 2], 5: [3], 9: [4, 5]}
    waves = {name: serve_waves(e, prompts, arrivals, max_new) for name, e in engines.items()}
    for scenario, outs in (("closed batch", closed), ("arrivals mid-decode", waves)):
        if not outs["graphs"] == outs["eager"] == outs["cpu"]:
            raise AssertionError(f"slice-serve {scenario}: tokens differ: graphs vs eager at "
                                 f"{[_first_diff(a, b) for a, b in zip(outs['graphs'], outs['eager'])]}, "
                                 f"graphs vs cpu at "
                                 f"{[_first_diff(a, b) for a, b in zip(outs['graphs'], outs['cpu'])]}")
    c = graphs.counters.snapshot()
    log(f"[slice-serve] mistral_7b width, 2 layers, fp32: fast path with CUDA graphs == reference "
        f"loop eager on CUDA == fast path on the CPU, token for token, on a closed batch of "
        f"{len(prompts)} and on 3 waves arriving mid-decode; prewarm: {prewarmed} captures, KV "
        f"outside the trash block unchanged; graphs engine: {graphs.ledger.total} captures "
        f"{json.dumps(graphs.ledger.by_site)}, host syncs {c['host_syncs']}, burst / step tokens "
        f"{c['burst_tokens']} / {c['step_tokens']}")
    sampled = {"temperature": 1.0, "top_k": 20, "seed": 5}

    def primed():
        e = build_engine("mistral", cfg, params, config={**fp32, **sampled}, device="cuda", **kw)
        e.put([0, 1], prompts[:2])
        while len(e.step(greedy=False)) < 2:
            pass
        return e

    a = primed()
    stepwise = {0: [], 1: []}
    for _ in range(6):
        for uid, tok in a.step(greedy=False).items():
            stepwise[uid].append(tok)
    burst = primed().decode_burst(6, greedy=False)
    if burst != stepwise:
        raise AssertionError(f"slice-serve: a sampled burst {burst} differs from sampled steps "
                             f"{stepwise}")
    log(f"[slice-serve] sampled decode (temperature 1, top-k 20, seed 5): a 6-step burst (one "
        f"graph replayed 6 times) == 6 stepwise steps, token for token: {burst}")
    slice_serve_traces(cfg, params, params_cpu, kw, prompts, arrivals, max_new)


class StepClock:
    """A fake clock: each read returns the time, then advances it by
    ``tick`` s, so the stamps a tracer takes follow the host control flow
    alone."""

    def __init__(self, tick):
        self.t, self.tick, self.calls = 0.0, tick, 0

    def __call__(self):
        self.calls += 1
        t = self.t
        self.t += self.tick
        return t


def traced_replay(engine, prompts, arrivals, max_new):
    """[slice-serve]'s scenario on a tracing engine: what the tracer saw."""
    sink = engine.tracer.telemetry = TraceSink()
    closed = engine.generate(prompts, max_new_tokens=max_new, strict=False)
    waves = serve_waves(engine, prompts, arrivals, max_new)
    tr = engine.tracer
    return {"statuses": [(r.uid, r.status, r.finish_reason) for r in closed],
            "tokens": [r.tokens for r in closed], "waves": waves, "records": sink.records,
            "live": tr.live_uids(), "percentiles": tr.percentiles(),
            "latency": tr.latency_snapshot(), "clock_reads": engine._clock.calls,
            "recorder": [e for e in tr.recorder.tail() if e["event"] != "warm_recompile"]}


def slice_serve_traces(cfg, params, params_cpu, kw, prompts, arrivals, max_new):
    """[slice-serve] with tracing on under a fake clock: the closed batch and
    the three waves, on the fast path with graphs (CUDA) against the fast
    path on the CPU, and on the reference loop eager on CUDA against the
    reference loop on the CPU.  The stamps follow host control flow, so the
    per-request trace records, the terminal statuses, the percentiles and
    the flight recorder (compile events aside) must be identical."""
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    traced = {"dtype": "float32", "serving_tracing": {"enabled": True}}
    ref = {**traced, "serving_fastpath": {"enabled": False}}
    runs = {}
    for name, device, p, conf in (("graphs", "cuda", params, traced),
                                  ("cpu", "cpu", params_cpu, traced),
                                  ("eager", "cuda", params, ref),
                                  ("cpu reference", "cpu", params_cpu, ref)):
        e = build_engine("mistral", cfg, p, config=conf, device=device, clock=StepClock(0.01),
                         **kw)
        runs[name] = traced_replay(e, prompts, arrivals, max_new)
        del e
    for a, b in (("graphs", "cpu"), ("eager", "cpu reference")):
        diff = [k for k in runs[a] if runs[a][k] != runs[b][k]]
        if diff:
            raise AssertionError(f"[slice-serve] traced under a fake clock: {a} differs from "
                                 f"{b} in {diff}")
    g = runs["graphs"]
    if g["live"] or {r["status"] for r in g["records"]} != {"ok"}:
        raise AssertionError(f"[slice-serve] traced: live traces {g['live']}, statuses "
                             f"{sorted({r['status'] for r in g['records']})}")
    p50 = lambda run, m: run["percentiles"][m]["p50"]  # noqa: E731
    log(f"[slice-serve] tracing on, fake clock (0.01 s a read): graphs on CUDA == fast path on "
        f"the CPU and eager reference loop on CUDA == reference loop on the CPU in "
        f"{len(g['records'])} trace records (closed batch and 3 waves), terminal statuses, "
        f"percentiles, {len(g['recorder'])} recorder events and {g['clock_reads']} / "
        f"{runs['eager']['clock_reads']} clock reads; fake-clock TTFT p50 {p50(g, 'ttft'):.4f} "
        f"/ {p50(runs['eager'], 'ttft'):.4f} s, TBT p50 {p50(g, 'tbt'):.4f} / "
        f"{p50(runs['eager'], 'tbt'):.4f} s")


def _first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


# ------------------------------------------------------------- prefix cache
SERVE_STEPS, SERVE_HOST_SYNCS = 62, 47  # [serve]'s counts with nothing to share


def prefix_workload(seed, vocab, bs, header_blocks, tails, n_requests, wave):
    """Requests behind one system prompt of ``header_blocks`` full blocks,
    each with its own tail (``tails``: the range of tail lengths), in waves
    of ``wave``; two more requests are exactly the header: one arrives with
    the first wave, beside the request that computes the header (it maps the
    header late, then copies its last block), one with a later wave (it maps
    at admit and copies).  Returns (prompts, waves of uids)."""
    rng = np.random.default_rng(seed)
    header = rng.integers(0, vocab, header_blocks * bs).tolist()
    lens = rng.integers(tails[0], tails[1] + 1, n_requests)
    prompts = [header + rng.integers(0, vocab, int(n)).tolist() for n in lens]
    prompts += [list(header), list(header)]
    waves = [list(range(i, min(i + wave, n_requests))) for i in range(0, n_requests, wave)]
    waves[0].append(n_requests)
    waves[len(waves) // 2].append(n_requests + 1)
    return prompts, waves


def prefix_waves(engine, prompts, waves, max_new):
    """Serve ``prompts`` through ``put`` / ``step`` / ``decode_burst``: a
    wave is put once every request of the wave before it has its first
    token (the next wave arrives while the previous one decodes); once the
    last wave is in and the live set is decode-only, up to k steps fuse into
    one burst.  Each request is flushed at ``max_new`` tokens.  Returns each
    uid's tokens."""
    produced, tokens = {}, {}
    queue, last = list(waves), []

    def finish(uid, n_new):
        produced[uid] += n_new
        if produced[uid] >= max_new:
            tokens[uid] = list(engine.manager.seqs[uid].tokens)
            engine.flush(uid)

    while len(tokens) < len(prompts):
        if queue and all(produced[u] >= 1 for u in last):
            last = queue.pop(0)
            produced.update({u: 0 for u in last})
            engine.put(last, [prompts[u] for u in last])
        live = [u for u, s in engine.manager.seqs.items() if not s.done]
        k = min((max_new - produced[u] for u in live), default=0)
        if not queue and k >= 2:
            burst = engine.decode_burst(k)
            if burst is not None:
                for uid, toks in burst.items():
                    finish(uid, len(toks))
                continue
        out = engine.step()
        if not out and not queue and not engine.manager.seqs:
            raise AssertionError("prefix_waves: nothing live and requests unfinished")
        for uid in out:
            finish(uid, 1)
    if engine.manager.failures:
        raise AssertionError(f"prefix_waves: failed requests {engine.manager.failures}")
    return [tokens[u] for u in range(len(prompts))]


class SharedBlockWatch:
    """Holds every block the engine's prefix tree registers against the
    bytes it held at registration, until its last mapper releases it.  The
    copy is enqueued right after the forward that completed the block, so
    it holds the block's final KV; at release (the tree drops the entry when
    the refcount reaches zero, after the last sharer's final step and before
    the block can be reused) the block must still hold those bytes: no
    request wrote a shared block.  Its compares sync the card, so it watches
    one serve that is not timed."""

    def __init__(self, engine):
        import torch
        self.torch, self.engine = torch, engine
        self.cache = engine.manager.prefix_cache
        self._register, self._invalidate = self.cache.register, self.cache.invalidate_blocks
        self.cache.register, self.cache.invalidate_blocks = self.register, self.invalidate
        self.snaps, self.checked, self.changed = {}, 0, []

    def register(self, h, parent, block, tokens):
        if not self._register(h, parent, block, tokens):
            return False
        self.snaps[block] = {k: v[:, block].clone() for k, v in self.engine.kv.items()}
        return True

    def invalidate(self, blocks):
        for b in blocks:
            snap = self.snaps.pop(b, None)
            if snap is not None:
                self.checked += 1
                if not all(self.torch.equal(self.engine.kv[k][:, b], v) for k, v in snap.items()):
                    self.changed.append(b)
        self._invalidate(blocks)

    def close(self):
        self.cache.register, self.cache.invalidate_blocks = self._register, self._invalidate
        return self.checked, self.changed, len(self.snaps)


def built_by_site(engine):
    """Programs the engine has built, by "site:class" (captures on the card)."""
    return {f"{site}:{cls}": n for site, per in engine.ledger.by_site.items()
            for cls, n in per.items()}


def prefix_serve(engine, prompts, waves, max_new, *, watch=False):
    """One synchronized serve of the prefix workload and what it moved:
    wall, forward steps, real and padded positions (and the padded ones in
    steps of chunk width >= 2), paged launches by route, the fast path's
    counters, the prefix cache's and the observatory's deltas, and the
    programs built by class."""
    import torch
    from deepspeed_tpu_torch.ops.attention.paged import paged_attention
    cuda = engine.device.type == "cuda"
    widths = {}
    count = engine._count_forward

    def counted(n, t, tokens, steps=1):
        widths[t] = widths.get(t, 0) + n * t * steps
        count(n, t, tokens, steps)

    engine._count_forward = counted
    pc0 = engine.health()["prefix_cache"]
    obs0 = engine.health()["kv"]["prefix"]
    c0, built0 = engine.counters.snapshot(), built_by_site(engine)
    capture_s0 = sum(engine.ledger.wall_by_class.values())
    steps0, tok0, pos0 = engine.forward_steps, engine.tokens_run, engine.positions_run
    paged_attention.launches = paged_attention.tc_launches = paged_attention.decode_launches = 0
    w = SharedBlockWatch(engine) if watch else None
    engine.tracer.reset_histograms()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        outs = prefix_waves(engine, prompts, waves, max_new)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del engine._count_forward
        watched = w.close() if w is not None else None
    launches = (paged_attention.launches, paged_attention.tc_launches,
                paged_attention.decode_launches)
    pc, obs = engine.health()["prefix_cache"], engine.health()["kv"]["prefix"]
    delta = lambda a, b, keys: {k: a[k] - b.get(k, 0) for k in keys}  # noqa: E731
    return outs, {
        "wall": wall, "steps": engine.forward_steps - steps0,
        "real": engine.tokens_run - tok0, "padded": engine.positions_run - pos0,
        "padded_prefill": sum(v for t, v in widths.items() if t >= 2),
        "launches": launches, "counters": engine.counters.delta_since(c0),
        "built": {c: n - built0.get(c, 0) for c, n in built_by_site(engine).items()
                  if n - built0.get(c, 0)},
        "build_s": sum(engine.ledger.wall_by_class.values()) - capture_s0,
        "cache": (delta(pc, pc0, ("hit_blocks_total", "hits_total", "cow_copies_total",
                                  "misses_total", "tokens_saved_total", "deferrals_total"))
                  if pc["enabled"] else None),
        "hit_rate": pc.get("realized_hit_rate"),
        "obs": delta(obs, obs0, ("duplicate_blocks_total", "prefill_tokens_saved_total",
                                 "prompt_blocks_total")),
        "watched": watched, "latency": latency_line(engine.tracer),
        "ttft": engine.tracer.ttft.snapshot()}


def check_prefix_serve(tag, engine, prompts, outs, r, max_new, vocab):
    """Every request ok; the device ran exactly the positions the cache left
    (real positions = prompt tokens - tokens saved + the decode inputs); the
    realized savings equal the observatory's counterfactual; the census
    invariant holds; pool and tree are drained."""
    for uid, (prompt, toks) in enumerate(zip(prompts, outs)):
        if len(toks) != len(prompt) + max_new or toks[:len(prompt)] != prompt:
            raise AssertionError(f"[{tag}] request {uid}: {len(toks)} tokens for a "
                                 f"{len(prompt)}-token prompt, or the prompt not echoed")
        if not all(0 <= t < vocab for t in toks[len(prompt):]):
            raise AssertionError(f"[{tag}] request {uid}: token id outside the vocabulary")
    saved = r["cache"]["tokens_saved_total"] if r["cache"] else 0
    want = sum(len(p) for p in prompts) - saved + len(prompts) * (max_new - 1)
    if r["real"] != want:
        raise AssertionError(f"[{tag}] the forwards ran {r['real']} real positions, expected "
                             f"{want} (prompt tokens - {saved} saved + decode inputs)")
    c, o = r["cache"], r["obs"]
    if c is not None:
        # a CoW copy recomputes its prompt's last position: one token of the
        # block the observatory counts as saved
        if (c["hit_blocks_total"] != o["duplicate_blocks_total"]
                or c["tokens_saved_total"] + c["cow_copies_total"]
                != o["prefill_tokens_saved_total"]):
            raise AssertionError(f"[{tag}] realized savings {c} differ from the observatory's "
                                 f"counterfactual {o}")
        if engine.health()["prefix_cache"]["entries"] != 0:
            raise AssertionError(f"[{tag}] prefix tree not drained: "
                                 f"{engine.health()['prefix_cache']}")
    engine.check_kv_invariant()
    free = engine.manager.allocator.free_blocks
    if free != engine.manager.allocator.num_blocks - 1 or engine.manager.seqs:
        raise AssertionError(f"[{tag}] KV pool not reclaimed: {free} blocks free, "
                             f"{len(engine.manager.seqs)} sequences tracked")


def log_prefix_serve(tag, name, r, card, max_new, n_requests):
    launches, tc, dec = r["launches"]
    d, c = r["counters"], r["cache"]
    log(f"[{tag}] {name} on {card}: wall {r['wall']:.3f} s, {r['steps']} forward steps, "
        f"{r['real']} real / {r['padded']} padded positions ({r['padded_prefill']} padded in "
        f"steps of chunk width >= 2), real prefill positions "
        f"{r['real'] - n_requests * (max_new - 1)}; "
        + (f"tokens saved {c['tokens_saved_total']}, hit blocks {c['hit_blocks_total']} "
           f"({c['hits_total']} shared, {c['cow_copies_total']} CoW copies), misses "
           f"{c['misses_total']}, deferrals {c['deferrals_total']}, realized hit rate "
           f"{r['hit_rate']:.4f}; " if c else "cache off; ")
        + f"observatory: {r['obs']['prefill_tokens_saved_total']} tokens saved, "
        f"{r['obs']['duplicate_blocks_total']} of {r['obs']['prompt_blocks_total']} prompt "
        f"blocks duplicate; host syncs {d['host_syncs']}, dispatches {d['dispatches']}, uploads "
        f"{d['uploads']} ({d['upload_ints']} ints), burst / step tokens {d['burst_tokens']} / "
        f"{d['step_tokens']}; programs built by site and class {json.dumps(r['built'])} in "
        f"{r['build_s']:.3f} s; paged launches "
        f"{launches}: tensor-core prefill {tc}, split-K decode {dec}, CUDA-core "
        f"{launches - tc - dec}")


def phase_serve_prefix(card, cfg, params, kw, seed=0):
    """[serve-prefix]: Mistral-7B in bf16 at full width, [serve]'s pool and
    scheduler, 16 requests behind a 1024-token system prompt with tails of
    32-256 tokens and two that are exactly the prompt, in 4 waves, 32 greedy
    new tokens each, through the cache-on engine (the default) and a
    cache-off one.  The first serve of each is checked (the cache-on one
    with every shared block watched) and builds its graphs; then two pairs
    in turns (on, off, off, on); then one serve of each under
    torch.profiler.  Both engines
    trace requests: each serve's TTFT, TBT and end-to-end percentiles
    (from ``put`` to the first token, between tokens, to ``flush``) show
    what the cache does for users.  Returns the checked cache-on serve's
    paged launches."""
    import torch
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    bs = kw["block_size"]
    prompts, waves = prefix_workload(seed + 10, cfg.vocab_size, bs, 64, (32, 256), 16, 4)
    max_new = 32
    conf = {"dtype": "bfloat16", "seed": seed, "serving_tracing": {"enabled": True}}
    engines = {"cache on": build_engine("mistral", cfg, params, config=conf, **kw),
               "cache off": build_engine("mistral", cfg, params, **kw, config={
                   **conf, "serving_prefix_cache": {"enabled": False}})}
    if (engines["cache on"].manager.prefix_cache is None
            or engines["cache off"].manager.prefix_cache is not None):
        raise AssertionError("serve-prefix: the default engine does not run the prefix cache")
    log(f"[serve-prefix] {len(prompts)} requests ({sum(len(p) for p in prompts)} prompt "
        f"tokens) behind one {64 * bs}-token system prompt, waves "
        f"{[len(w) for w in waves]}, {max_new} new tokens each")
    outs, runs = {}, {name: [] for name in engines}
    head_dim = cfg.hidden_size // cfg.num_heads
    for name, engine in engines.items():
        outs[name], r = prefix_serve(engine, prompts, waves, max_new, watch=name == "cache on")
        check_prefix_serve("serve-prefix", engine, prompts, outs[name], r, max_new,
                           cfg.vocab_size)
        if r["launches"][0] != r["steps"] * cfg.num_layers:
            raise AssertionError(f"[serve-prefix] {name}: paged_attention launched "
                                 f"{r['launches'][0]} times over {r['steps']} steps x "
                                 f"{cfg.num_layers} layers")
        log_prefix_serve("serve-prefix", f"{name}, first serve (checked)", r, card, max_new,
                         len(prompts))
        if name == "cache on":
            checked, changed, left = r["watched"]
            if changed or left or not checked:
                raise AssertionError(f"[serve-prefix] shared blocks written: {changed} of "
                                     f"{checked} watched changed, {left} never released")
            log(f"[serve-prefix] {checked} registered blocks (header and full tail blocks) "
                f"held their bytes from registration to their last mapper's release: no "
                f"request wrote a shared block")
            prefix_launches = dict(zip(("launches", "tc_launches", "decode_launches"),
                                       r["launches"]))
        runs[name].append(r)
    for name in ("cache on", "cache off", "cache off", "cache on"):
        got, r = prefix_serve(engines[name], prompts, waves, max_new)
        if got != outs[name]:
            raise AssertionError(f"[serve-prefix] {name}: a repeated serve's tokens differ at "
                                 f"{[_first_diff(a, b) for a, b in zip(got, outs[name])]}")
        check_prefix_serve("serve-prefix", engines[name], prompts, got, r, max_new,
                           cfg.vocab_size)
        runs[name].append(r)
    for name, rs in runs.items():
        log_prefix_serve("serve-prefix", f"{name}, last timed serve", rs[-1], card, max_new,
                         len(prompts))
        log(f"[serve-prefix] {name} on {card}: walls "
            + ", ".join(f"{r['wall']:.3f}" for r in rs[1:]) + " s (in turns); programs built "
            f"after the first serve: {sum(sum(r['built'].values()) for r in rs[1:])}")
        log(f"[serve-prefix] {name}, last timed serve on {card}: {rs[-1]['latency']}")
        log(f"[serve-prefix] {name}, TTFT p50/p95/p99 of the two timed serves on {card}: "
            + ", ".join(f"{r['ttft']['p50'] * 1e3:.3f} / {r['ttft']['p95'] * 1e3:.3f} / "
                        f"{r['ttft']['p99'] * 1e3:.3f} ms" for r in rs[1:]))
    busy = {}
    for name, engine in engines.items():
        wall_ms = statistics.mean(r["wall"] for r in runs[name][1:]) * 1e3
        busy[name] = profile_device(lambda e=engine: prefix_waves(e, prompts, waves, max_new),
                                    card, "serve-prefix", f"{name} serve", wall_ms,
                                    PAGED_NEEDLES)
    log(f"[serve-prefix] first generated position where the cache-on tokens differ from the "
        f"cache-off ones (bf16: shared KV was computed in other batch shapes), by request: "
        f"{[_first_diff(a[len(p):], b[len(p):]) for p, a, b in zip(prompts, outs['cache on'], outs['cache off'])]}")
    del engines
    torch.cuda.empty_cache()
    return prefix_launches


def record_emit_logits(engine):
    """The last-position logits of every row that emitted a token at a
    dispatched step, by (uid, position), read back to the host."""
    rec, last = {}, {}
    pick, dispatch = engine._pick_rows, engine._dispatch_step

    def pick_rows(rows, greedy):
        last["rows"] = rows
        return pick(rows, greedy)

    def dispatch_step(greedy):
        d = dispatch(greedy)
        if d is not None:
            rows = last["rows"].float().cpu()
            for uid, pos, i in d.emits:
                rec[(uid, pos)] = rows[i]
        return d

    engine._pick_rows, engine._dispatch_step = pick_rows, dispatch_step
    return rec


def phase_slice_prefix(seed=4, device="cuda"):
    """[slice-prefix]: the prefix workload at Mistral-7B width, 2 layers,
    fp32, small waves, through the fast path with CUDA graphs, the reference
    loop eager on the card and the fast path on the CPU, each with the cache
    on and off: tokens identical across the six runs, and the logits of
    every dispatched emit on the card within 2e-3 of the CPU path's."""
    import torch
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    from deepspeed_tpu_torch.models import mistral
    from deepspeed_tpu_torch.runtime.tree import tree_map
    cfg = dataclasses.replace(mistral.MistralConfig.mistral_7b(), num_layers=2)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = mistral.init_params(cfg, gen, dtype=torch.float32, device=device)
    params_cpu = tree_map(lambda t: t.cpu(), params)
    # a budget of 128 splits the header 128 + 64: the writer's second chunk
    # completes the header's last blocks with budget to spare, so a request
    # of its wave that needs them waits a step (defer_shared_prefill)
    kw = dict(num_blocks=256, block_size=16, max_blocks_per_seq=16, token_budget=128,
              max_seqs_per_step=8)
    prompts, waves = prefix_workload(seed, cfg.vocab_size, 16, 12, (5, 40), 8, 2)
    max_new = 8
    fp32 = {"dtype": "float32"}
    runs = {}
    for cache in (True, False):
        conf = {**fp32, "serving_prefix_cache": {"enabled": cache}}
        for name, dev, p, extra in (("graphs", device, params, {}),
                                    ("eager", device, params,
                                     {"serving_fastpath": {"enabled": False}}),
                                    ("cpu", "cpu", params_cpu, {})):
            engine = build_engine("mistral", cfg, p, config={**conf, **extra}, device=dev, **kw)
            logits = record_emit_logits(engine) if name != "eager" else None
            outs, r = prefix_serve(engine, prompts, waves, max_new, watch=cache)
            for hook in ("_pick_rows", "_dispatch_step"):
                engine.__dict__.pop(hook, None)  # the hooks' closures hold the engine
            check_prefix_serve("slice-prefix", engine, prompts, outs, r, max_new,
                               cfg.vocab_size)
            if cache and (r["watched"][1] or r["watched"][2]):
                raise AssertionError(f"[slice-prefix] {name}: shared blocks written "
                                     f"{r['watched']}")
            runs[(name, cache)] = (outs, r, logits)
    ref = runs[("cpu", True)][0]
    bad = {k: [_first_diff(a, b) for a, b in zip(v[0], ref)] for k, v in runs.items()
           if v[0] != ref}
    if bad:
        raise AssertionError(f"[slice-prefix] tokens differ from the CPU path with the cache on "
                             f"at {bad}")
    worst = 0.0
    for cache in (True, False):
        got, want = runs[("graphs", cache)][2], runs[("cpu", cache)][2]
        if set(got) != set(want):
            raise AssertionError(f"[slice-prefix] emits differ: {sorted(set(got) ^ set(want))}")
        for key, row in want.items():
            err = (got[key] - row).abs()
            if not torch.isfinite(got[key]).all() or (err > 2e-3 + 2e-3 * row.abs()).any():
                raise AssertionError(f"[slice-prefix] logits of {key} differ from the CPU "
                                     f"path's by up to {err.max().item():.3e}")
            worst = max(worst, err.max().item())
    on = runs[("graphs", True)][1]
    log(f"[slice-prefix] mistral_7b width, 2 layers, fp32, {len(prompts)} requests in waves "
        f"{[len(w) for w in waves]} behind a {12 * 16}-token header: graphs == eager == CPU, "
        f"cache on == cache off, token for token; logits of "
        f"{len(runs[('graphs', True)][2]) + len(runs[('graphs', False)][2])} dispatched emits "
        f"within 2e-3 of the CPU path (max abs err {worst:.3e}); cache on, graphs: tokens "
        f"saved {on['cache']['tokens_saved_total']}, CoW copies {on['cache']['cow_copies_total']}, "
        f"deferrals {on['cache']['deferrals_total']}, real positions {on['real']} against "
        f"{runs[('graphs', False)][1]['real']} with the cache off, paged launches "
        f"{on['launches']}, {on['watched'][0]} registered blocks unchanged to their release")


# ------------------------------------------------ serving fault tolerance
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
# [slice-recover]: [slice-serve]'s width, pool, prompts and budget
SLICE_RECOVER_SEED = 3
SLICE_KW = dict(num_blocks=160, block_size=16, max_blocks_per_seq=16, token_budget=64,
                max_seqs_per_step=8)
SLICE_MAX_NEW = 12
# subprocess supervision: stamps every 50 ms; a worker that stops stamping
# for HANG_TIMEOUT_S after its first stamp is hung, one that never stamps
# within STARTUP_GRACE_S (imports, CUDA context, weights, captures) too
HEARTBEAT_INTERVAL_S, HANG_TIMEOUT_S, STARTUP_GRACE_S = 0.05, 6.0, 120.0
TORN_FRAME = b"DSWL\x09\x00"  # the start of a frame a dying writer never finished


def out_path(name):
    """A fresh file under chiprun_out/ (an earlier run's copy removed)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, name)
    if os.path.exists(path):
        os.remove(path)
    return path


def crashy_journal(path, *, fsync_every, seed, at=2, marks=None):
    """A request journal whose ``at``-th writing flush raises after its
    frame is on disk: an engine crash at that wave (once: the flush of the
    engine's unwinding then writes what the abort patched).
    ``marks["crash"]`` takes the host clock at the raise and
    ``marks["journal_at_crash"]`` the file's bytes."""
    from deepspeed_tpu_torch.inference.v2.journal import RequestJournal

    class CrashyJournal(RequestJournal):
        writes = 0

        def flush(self):
            wrote = super().flush()
            if wrote:
                self.writes += 1
                if self.writes == at:
                    if marks is not None:
                        marks["crash"] = time.perf_counter()
                        with open(self.path, "rb") as fh:
                            marks["journal_at_crash"] = fh.read()
                    raise RuntimeError(f"injected engine crash at journal flush {self.writes}")
            return wrote

    journal = CrashyJournal(path, fsync_every=fsync_every, seed=seed)
    journal.open_generation(0)
    return journal


def check_journal_matches(tag, state, results):
    """Every request of ``results`` is journaled ``ok`` with prompt + emitted
    equal to its tokens."""
    for r in results:
        entry = state.entries.get(r.uid)
        if entry is None or not entry.done or entry.terminal["status"] != r.status \
                or entry.prompt + entry.emitted != r.tokens:
            raise AssertionError(f"[{tag}] request {r.uid} ({r.status}, {len(r.tokens)} tokens) "
                                 f"journaled as {entry}")


def phase_serve_journal(card, engine, prompts, max_new, results):
    """[serve-journal]: [serve]'s engine, warm, serves its prompts once with
    the request journal on in throughput mode (``fsync_every=0``) and once
    with it off.  Gates: ServeCounters equal field by field (62 forward
    steps, 47 host syncs), the same tokens as [serve], and the journal
    replays to 16 ``ok`` entries whose prompt + emitted tokens equal the
    results.  Prints both walls and the journal's bytes and frames; the
    journal's wall cost is reported, not gated."""
    import torch
    from deepspeed_tpu_torch.inference.v2.journal import RequestJournal, replay_journal
    from deepspeed_tpu_torch.utils.wal import scan_frames
    path = out_path("serve_journal.wal")
    runs = {}
    for name in ("on", "off"):
        engine.journal = None
        if name == "on":
            engine.journal = RequestJournal(path, fsync_every=0, seed=engine.config.seed)
            engine.journal.open_generation(0)
        before, steps0, built = engine.counters.snapshot(), engine.forward_steps, \
            engine.ledger.total
        out, wall = serve_timed(engine, prompts, max_new)
        if name == "on":
            engine.journal.close()
            engine.journal = None
        runs[name] = (out, wall, engine.counters.delta_since(before),
                      engine.forward_steps - steps0, engine.ledger.total - built)
    (on, wall_on, d_on, steps_on, built_on), (off, wall_off, d_off, steps_off, _) = \
        runs["on"], runs["off"]
    if d_on != d_off or (steps_on, d_on["host_syncs"]) != (SERVE_STEPS, SERVE_HOST_SYNCS) \
            or steps_off != steps_on or built_on:
        raise AssertionError(f"[serve-journal] ServeCounters with the journal {d_on} "
                             f"({steps_on} steps, {built_on} programs built) against without "
                             f"{d_off} ({steps_off} steps); expected {SERVE_STEPS} steps and "
                             f"{SERVE_HOST_SYNCS} syncs")
    want = [r.tokens for r in results]
    if [r.tokens for r in on] != want or [r.tokens for r in off] != want:
        raise AssertionError(f"[serve-journal] tokens differ from [serve]'s: on at "
                             f"{first_divergence(results, on, prompts)}, off at "
                             f"{first_divergence(results, off, prompts)}")
    state = replay_journal(path, truncate=False)
    if len(state.entries) != len(prompts) or state.incomplete() or state.truncated_tail:
        raise AssertionError(f"[serve-journal] the journal replays to {len(state.entries)} "
                             f"entries, {len(state.incomplete())} incomplete, tail "
                             f"{state.truncated_tail}")
    check_journal_matches("serve-journal", state, on)
    frames = scan_frames(path)[0]
    n_tok = sum(f[:1] == b"\x01" for f in frames)
    torch.cuda.synchronize()
    log(f"[serve-journal] {len(prompts)} requests on {card}: journal on (throughput mode, "
        f"fsync_every=0) wall {wall_on:.3f} s, off {wall_off:.3f} s ({wall_on - wall_off:+.3f} s, "
        f"{(wall_on / wall_off - 1) * 100:+.2f} %, not gated); ServeCounters equal "
        f"({steps_on} steps, {d_on['host_syncs']} host syncs, {d_on['flushes']} flushes), tokens "
        f"identical to [serve]'s; journal {os.path.getsize(path)} bytes in {len(frames)} frames "
        f"({state.records} records: {state.generations} open, {len(state.entries)} admits, "
        f"{n_tok} token frames, {len(state.entries)} ends) replayed to {len(state.entries)} ok "
        f"entries equal to the results")
    return {"wall_on": wall_on, "wall_off": wall_off, "bytes": os.path.getsize(path),
            "frames": len(frames)}


def phase_serve_recover(card, cfg, params, kw, prompts, max_new, results, seed=0):
    """[serve-recover]: [serve]'s model (the params already on the card),
    pool and prompts under an in-process ``ServingSupervisor``.  The first
    engine's journal (strict mode) raises at its second writing flush; the
    supervisor rebuilds the engine (new pool, new graph captures), replays
    the journal and re-admits every request with the prefix it had emitted.
    Gates: one restart, no degradation, 16 results ``ok`` with prompt +
    generated equal to the journal's prompt + emitted (the recovered
    prefixes kept), at least one request recovered with a prefix, and
    ``health()["fault_tolerance"]["restarts_total"] == 1`` on the surviving
    engine.  Prints how many streams equal [serve]'s (bf16 re-prefill may
    change later tokens; not gated) and the recovery's wall: the journal's
    replay (timed again on the file as the crash left it), the rebuild, its
    captures and the rest of the serve."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import ServingSupervisor
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    from deepspeed_tpu_torch.inference.v2.journal import replay_journal
    path = out_path("serve_recover.wal")
    builds, marks = [], {}

    def factory():
        t0 = time.perf_counter()
        engine = build_engine("mistral", cfg, params, config={"dtype": "bfloat16", "seed": seed},
                              **kw)
        if not builds:
            engine.journal = crashy_journal(path, fsync_every=1, seed=seed, marks=marks)
        torch.cuda.synchronize()
        builds.append((engine, time.perf_counter() - t0))
        return engine

    sup = ServingSupervisor(factory, journal_path=path, config={"max_restarts": 2})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sup.serve(prompts, max_new_tokens=max_new)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    survivor, rebuild_s = builds[-1]
    ft = survivor.health()["fault_tolerance"]
    state = replay_journal(path, truncate=False)
    if (sup.restarts_total, sup.degraded, len(builds), ft["restarts_total"]) != (1, False, 2, 1) \
            or not all(r.ok for r in out) or "crash" not in marks:
        raise AssertionError(f"[serve-recover] restarts {sup.restarts_total}, degraded "
                             f"{sup.degraded}, {len(builds)} engines, health {ft}, statuses "
                             f"{[r.status for r in out]}")
    check_journal_matches("serve-recover", state, out)
    prefixes = {u: e.prefix_len for u, e in state.entries.items() if e.prefix_len}
    if not prefixes or ft["recovered_requests_total"] != len(prefixes) \
            or sup.recovered_requests_total != len(prefixes):
        raise AssertionError(f"[serve-recover] prefixes {prefixes}, recovered "
                             f"{ft['recovered_requests_total']} / {sup.recovered_requests_total}")
    for r, p in zip(out, prompts):
        n = prefixes.get(r.uid, 0)
        if len(r.tokens) != len(p) + max_new or r.tokens[:len(p)] != p:
            raise AssertionError(f"[serve-recover] request {r.uid}: {len(r.tokens)} tokens for a "
                                 f"{len(p)}-token prompt")
        if r.tokens[len(p):len(p) + n] != state.entries[r.uid].emitted[:n]:
            raise AssertionError(f"[serve-recover] request {r.uid}: the journaled prefix of "
                                 f"{n} tokens was not kept")
    same = sum(a.tokens == b.tokens for a, b in zip(out, results))
    replay_copy = out_path("serve_recover_at_crash.wal")
    with open(replay_copy, "wb") as fh:
        fh.write(marks["journal_at_crash"])
    t_replay = time.perf_counter()
    at_crash = replay_journal(replay_copy, truncate=False)
    replay_s = time.perf_counter() - t_replay
    captures_s = sum(survivor.ledger.wall_by_class.values())
    recovery_s = t_end - marks["crash"]
    steps = survivor.forward_steps
    log(f"[serve-recover] {len(prompts)} requests on {card}: the first engine crashed at its "
        f"journal's 2nd writing flush {marks['crash'] - t0:.3f} s into the serve, 1 restart, not "
        f"degraded, {len(out)} ok; requests recovered with a prefix: {len(prefixes)} (lengths "
        f"{sorted(prefixes.values())}), each result's prefix equal to the journal's; "
        f"{same} of {len(out)} streams token-identical to [serve]'s (bf16 re-prefill of prompt + "
        f"prefix, not gated); wall {t_end - t0:.3f} s, recovery {recovery_s:.3f} s from the "
        f"crash: replay {replay_s * 1e3:.2f} ms ({at_crash.records} records, "
        f"{len(marks['journal_at_crash'])} bytes), rebuild {rebuild_s:.3f} s, captures "
        f"{captures_s:.3f} s ({survivor.ledger.total} programs), the rest "
        f"{recovery_s - replay_s - rebuild_s - captures_s:.3f} s ({steps} forward steps)")
    return {"recovery_s": recovery_s, "replay_s": replay_s, "rebuild_s": rebuild_s,
            "captures_s": captures_s, "same": same}


def slice_recover_model(cfg, device):
    """[slice-recover]'s fp32 weights on ``device``, from its seed: the
    parent and every worker process make the same ones."""
    import torch
    from deepspeed_tpu_torch.models import mistral
    gen = torch.Generator(device=device).manual_seed(SLICE_RECOVER_SEED)
    return mistral.init_params(cfg, gen, dtype=torch.float32, device=device)


def slice_recover_prompts(vocab):
    """[slice-serve]'s six prompts (5-150 tokens)."""
    rng = np.random.default_rng(SLICE_RECOVER_SEED)
    return [rng.integers(0, vocab, int(n)).tolist() for n in (5, 150, 33, 70, 12, 97)]


def serving_worker(fault, out, device, cfg_json) -> int:
    """``python3 chip_smoke.py --serving-worker FAULT OUT DEVICE CONFIG``: one
    generation of a supervised serving worker.  The engine arms its journal
    and heartbeat from the supervisor's env and serves [slice-recover]'s
    requests through ``recover_and_serve``; ``OUT`` gets one JSON line
    (pid, generation, the torn tail found at startup).  FAULT: ``crash``
    appends a torn frame and exits the process at the journal's 2nd writing
    flush of generation 0, ``hang`` stops serving (and stamping) there,
    ``always`` crashes at the 1st writing flush of every generation (the
    restart budget's case), ``none`` serves."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import ServeSpec, recover_and_serve
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    from deepspeed_tpu_torch.inference.v2.journal import replay_journal
    from deepspeed_tpu_torch.models.mistral import MistralConfig
    from deepspeed_tpu_torch.runtime.heartbeat import SERVING_GENERATION_ENV, SERVING_JOURNAL_ENV
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 as the parent runs it
    torch.backends.cudnn.allow_tf32 = False
    generation = int(os.environ[SERVING_GENERATION_ENV])
    path = os.environ[SERVING_JOURNAL_ENV]
    tail = replay_journal(path, truncate=False).truncated_tail
    with open(out, "a") as fh:
        fh.write(json.dumps({"pid": os.getpid(), "generation": generation, "tail": tail}) + "\n")
    cfg = MistralConfig(**json.loads(cfg_json))
    engine = build_engine("mistral", cfg, slice_recover_model(cfg, device),
                          config={"dtype": "float32"}, device=device, **SLICE_KW)
    if engine.journal is None or not engine._heartbeat.enabled:
        raise RuntimeError("serving worker: no journal or heartbeat armed from the env")
    at = {"crash": 2, "hang": 2, "always": 1}.get(fault) if (generation == 0
                                                            or fault == "always") else None
    if at is not None:
        flush, writes = engine.journal.flush, []

        def faulty_flush():
            wrote = flush()
            if wrote:
                writes.append(1)
                if len(writes) == at:
                    if fault == "hang":
                        time.sleep(3600)  # the loop and its stamps stop here
                    with open(path, "ab") as fh:
                        fh.write(TORN_FRAME)
                    os._exit(3)
            return wrote

        engine.journal.flush = faulty_flush
    specs = [ServeSpec(u, p) for u, p in enumerate(slice_recover_prompts(cfg.vocab_size))]
    results = recover_and_serve(engine, specs, max_new_tokens=SLICE_MAX_NEW)
    engine.journal.close()
    return 0 if all(r.ok for r in results.values()) else 1


def supervise_worker(tag, fault, cfg, device, ops=False, **over):
    """Supervise ``serving_worker`` with ``fault`` over a fresh journal;
    returns the supervisor, its report, each generation's record and the
    seconds it took.  Every generation's process must be gone after (no
    orphan).  With ``ops`` the supervisor serves its fleet endpoint (its
    workers publish under the exported ``DSTPU_OPS_DIR``) and a thread
    scrapes its /metrics every 50 ms while the workers run; the report then
    carries ``scrapes``: (fleet ``dstpu_serving_completed_total``,
    ``dstpu_supervisor_generations_total``) of each scrape, and ``final``:
    the families of one scrape after the run."""
    import threading
    from deepspeed_tpu_torch.inference.v2 import ServingSupervisor
    from deepspeed_tpu_torch.monitor.exposition import parse_exposition
    from deepspeed_tpu_torch.monitor.ops_server import scrape
    journal = out_path(f"slice_recover_{fault}.wal")
    out = out_path(f"slice_recover_{fault}_workers.jsonl")
    hb = os.path.join(OUT_DIR, f"slice_recover_{fault}_hb")
    shutil.rmtree(hb, ignore_errors=True)  # an earlier run's stamps would read as stale
    sup = ServingSupervisor(journal_path=journal, config={
        "max_restarts": 2, "heartbeat_interval_s": HEARTBEAT_INTERVAL_S,
        "hang_timeout_s": HANG_TIMEOUT_S, "startup_grace_s": STARTUP_GRACE_S, **over},
        ops_server={"enabled": True} if ops else None)
    scrapes, stop = [], threading.Event()

    def total(fams, name):
        return sum(v for _, _, v in fams[name]["samples"]) if name in fams else None

    def scraper():
        while not stop.wait(0.05):
            fams = parse_exposition(scrape(sup.ops.url("/metrics")))
            scrapes.append((total(fams, "dstpu_serving_completed_total"),
                            total(fams, "dstpu_supervisor_generations_total")))

    thread = threading.Thread(target=scraper, daemon=True)
    if ops:
        thread.start()
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    try:
        report = sup.supervise_command(
            [sys.executable, os.path.abspath(__file__), "--serving-worker", fault, out, device,
             json.dumps(dataclasses.asdict(cfg))], cwd=here, heartbeat_base=hb)
    finally:
        stop.set()
        if ops:
            thread.join(timeout=10.0)
    seconds = time.perf_counter() - t0
    if ops:
        report["scrapes"] = scrapes
        report["final"] = parse_exposition(scrape(sup.ops.url("/metrics")))
        sup.close_ops()
    with open(out) as fh:
        workers = [json.loads(line) for line in fh]
    for w in workers:
        try:
            os.kill(w["pid"], 0)
        except ProcessLookupError:
            continue
        raise AssertionError(f"[{tag}] {fault}: worker pid {w['pid']} (generation "
                             f"{w['generation']}) outlived its supervisor")
    return sup, report, workers, seconds, journal


def ft_state_view(state, provenance=True):
    """A replayed journal's entries without the admit wall stamps; without
    ``provenance``, without the recovered prefix lengths either (an
    in-process crash journals the tokens its unwinding patches, a killed
    process does not, so the two recover from prefixes of other lengths
    into the same streams)."""
    return {u: (e.prompt, e.emitted, e.terminal, e.max_new_tokens, e.priority, e.ttl_s)
            + ((e.prefix_len, e.admits) if provenance else ())
            for u, e in state.entries.items()}


def phase_slice_recover(device="cuda", cfg=None):
    """[slice-recover]: [slice-serve]'s 2-layer fp32 Mistral engine (graphs
    on the card), its six prompts, 12 new tokens, crashed and recovered.

    In process: ``ServingSupervisor`` over a factory whose first engine's
    journal raises at its 2nd writing flush.  Over a subprocess:
    ``supervise_command`` of ``serving_worker`` (this script run with
    ``--serving-worker``), three supervisors side by side, in four cases: a
    crash (``os._exit`` at flush 2)
    that leaves a torn frame for the next generation's startup; a hang (the
    loop stops at flush 2), found by heartbeat staleness (stamps every
    HEARTBEAT_INTERVAL_S, HANG_TIMEOUT_S after the last one, STARTUP_GRACE_S
    before the first); budget exhaustion (a crash at flush 1 of every
    generation, ``max_restarts=1``), where the supervisor degrades to
    drain-only and finalizes every journaled request ``failed``; and the
    crash case's journal replayed by the port to the state of the
    in-process crash's.  Gates: recovered tokens identical to the
    uninterrupted run on the device and on the CPU in both modes, one
    restart each, the hang indicted by staleness, no worker left running."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import ServingSupervisor
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    from deepspeed_tpu_torch.inference.v2.journal import replay_journal
    from deepspeed_tpu_torch.models import mistral
    from deepspeed_tpu_torch.runtime.tree import tree_map
    if cfg is None:
        cfg = dataclasses.replace(mistral.MistralConfig.mistral_7b(), num_layers=2)
    params = slice_recover_model(cfg, device)
    prompts = slice_recover_prompts(cfg.vocab_size)
    fp32 = {"dtype": "float32"}
    t0 = time.perf_counter()
    want = build_engine("mistral", cfg, params, config=fp32, device=device,
                        **SLICE_KW).generate(prompts, max_new_tokens=SLICE_MAX_NEW)
    cpu = build_engine("mistral", cfg, tree_map(lambda t: t.cpu(), params), config=fp32,
                       device="cpu", **SLICE_KW).generate(prompts, max_new_tokens=SLICE_MAX_NEW)
    if cpu != want:
        raise AssertionError(f"[slice-recover] the uninterrupted run on {device} differs from "
                             f"the CPU's at {[_first_diff(a, b) for a, b in zip(want, cpu)]}")
    # ---- in process
    path = out_path("slice_recover_inprocess.wal")
    builds = []

    def factory():
        engine = build_engine("mistral", cfg, params, config=fp32, device=device, **SLICE_KW)
        if not builds:
            engine.journal = crashy_journal(path, fsync_every=1, seed=engine.config.seed)
        builds.append(engine)
        return engine

    sup = ServingSupervisor(factory, journal_path=path, config={"max_restarts": 2})
    got = sup.serve(prompts, max_new_tokens=SLICE_MAX_NEW)
    inprocess = replay_journal(path)
    if (sup.restarts_total, sup.degraded) != (1, False) or [r.tokens for r in got] != want \
            or not sup.recovered_requests_total:
        raise AssertionError(f"[slice-recover] in process: restarts {sup.restarts_total}, "
                             f"degraded {sup.degraded}, recovered "
                             f"{sup.recovered_requests_total}, tokens differ from the "
                             f"uninterrupted run at "
                             f"{[_first_diff(r.tokens, w) for r, w in zip(got, want)]}")
    log(f"[slice-recover] mistral_7b width, 2 layers, fp32, {len(prompts)} requests, "
        f"{SLICE_MAX_NEW} new, in process on {device}: crash at the journal's 2nd writing flush, "
        f"1 restart, {sup.recovered_requests_total} requests recovered with a prefix, tokens "
        f"identical to the uninterrupted run on {device} and on the CPU "
        f"({time.perf_counter() - t0:.1f} s with the two reference runs)")
    del builds[:]
    if device == "cuda":
        torch.cuda.empty_cache()
    # ---- over a subprocess: the three supervised runs side by side, each
    # with its own supervisor, journal and workers (one card holds them)
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futures = {fault: pool.submit(supervise_worker, "slice-recover", fault, cfg, device,
                                      ops=fault == "crash",
                                      **({"max_restarts": 1} if fault == "always" else {}))
                   for fault in ("crash", "hang", "always")}
        runs = {fault: f.result() for fault, f in futures.items()}
    sup, report, workers, secs, journal = runs["crash"]
    tokens = [report["results"][u].tokens for u in range(len(prompts))]
    failed = [e["detail"] for e in sup.recorder.tail() if e["event"] == "worker_failed"]
    tails = [w["tail"] for w in workers]
    if ((report["generations"], report["restarts"], report["degraded"]) != (2, 1, False)
            or tokens != want or tails[0] is not None or not tails[1]
            or report["state"].incomplete() or failed != ["worker exited rc=3"]):
        raise AssertionError(f"[slice-recover] crash: report {report['generations']} "
                             f"generations, {report['restarts']} restarts, degraded "
                             f"{report['degraded']}, failures {failed}, tails {tails}, tokens "
                             f"differ at {[_first_diff(a, b) for a, b in zip(tokens, want)]}")
    # the fleet endpoint across the crash: monotone, ending at the ok count
    seen = [c for c, _ in report["scrapes"] if c is not None]
    final = report["final"]
    n_ok = sum(r.ok for r in report["results"].values())
    completed = sum(v for _, _, v in final["dstpu_serving_completed_total"]["samples"])
    generations = final["dstpu_supervisor_generations_total"]["samples"][0][2]
    restarts = final["dstpu_supervisor_restarts_total"]["samples"][0][2]
    if (not seen or seen != sorted(seen) or completed != n_ok or n_ok != len(prompts)
            or (generations, restarts) != (2, 1)):
        raise AssertionError(f"[slice-recover] fleet /metrics across the crash: completed seen "
                             f"{seen}, final {completed} for {n_ok} ok, generations "
                             f"{generations}, restarts {restarts}")
    replayed = replay_journal(journal, truncate=False)
    if ft_state_view(replayed) != ft_state_view(report["state"]) \
            or ft_state_view(replayed, False) != ft_state_view(inprocess, False):
        raise AssertionError("[slice-recover] the crash case's journal replays to another state "
                             "than the supervisor's report or the in-process crash's streams")
    log(f"[slice-recover] over a subprocess on {device}: crash (os._exit at flush 2) with a torn "
        f"frame found at the next startup ({tails[1]}), 1 restart, tokens identical to the "
        f"uninterrupted run; the journal ({os.path.getsize(journal)} bytes, "
        f"{replayed.records} records, {replayed.generations} generations) replays to the "
        f"supervisor's state and to the in-process crash's streams and terminals; "
        f"{len(workers)} workers, none left running; {secs:.1f} s; the supervisor's fleet "
        f"/metrics over {len(report['scrapes'])} scrapes: dstpu_serving_completed_total "
        f"{sorted(set(seen))} (never down), {completed:.0f} = the ok requests at the end, "
        f"generations {generations:.0f}, restarts {restarts:.0f}")
    sup, report, workers, secs, _ = runs["hang"]
    tokens = [report["results"][u].tokens for u in range(len(prompts))]
    events = sup.recorder.tail()
    hang = [e for e in events if e["event"] == "hang_detected"]
    failed = [e["detail"] for e in events if e["event"] == "worker_failed"]
    if ((report["generations"], report["restarts"], report["degraded"]) != (2, 1, False)
            or tokens != want or len(hang) != 1 or len(failed) != 1
            or "heartbeat stale" not in failed[0]):
        raise AssertionError(f"[slice-recover] hang: report {report['generations']} "
                             f"generations, {report['restarts']} restarts, hang events {hang}, "
                             f"failures {failed}, tokens differ at "
                             f"{[_first_diff(a, b) for a, b in zip(tokens, want)]}")
    log(f"[slice-recover] over a subprocess on {device}: hang (serving stopped at flush 2) "
        f"indicted by heartbeat staleness ({hang[0]['age_s']} s without a stamp, "
        f"hang_timeout_s={HANG_TIMEOUT_S}, startup_grace_s={STARTUP_GRACE_S}, stamps every "
        f"{HEARTBEAT_INTERVAL_S} s), killed and reaped, 1 restart, tokens identical to the "
        f"uninterrupted run; {len(workers)} workers, none left running; {secs:.1f} s")
    sup, report, workers, secs, journal = runs["always"]
    state = report["state"]
    statuses = {u: e.terminal["status"] if e.terminal else None for u, e in state.entries.items()}
    if (not report["degraded"] or report["generations"] != 3 or len(state.entries) != len(prompts)
            or set(statuses.values()) != {"failed"} or len(report["results"]) != len(prompts)
            or "degraded" not in [e["event"] for e in sup.recorder.tail()]):
        raise AssertionError(f"[slice-recover] budget: degraded {report['degraded']}, "
                             f"{report['generations']} generations, statuses {statuses}")
    log(f"[slice-recover] over a subprocess on {device}: restart budget (max_restarts=1, a crash "
        f"at flush 1 of every generation) exhausted after {report['restarts']} failures, "
        f"degraded to drain-only, the drain generation failed too, all {len(state.entries)} "
        f"journaled requests finalized failed; {len(workers)} workers, none left running; "
        f"{secs:.1f} s")


# ------------------------------------------------------- QoS and the fleet
# [serve-qos]: the flood tenant's per-tenant override, and the names of the
# tenants whose passes only warm the engine up (same override, same shapes)
QOS_FLOOD = {"tokens_per_s": 2048.0, "token_burst": 4096.0, "max_kv_blocks": 512}
QOS_TTFT_FLOOR_S = 0.05  # the interactive TTFT gate's floor under its baseline


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def paged_counts():
    """(launches, tensor-core prefill launches, split-K decode launches) of
    the paged-attention wrapper so far."""
    from deepspeed_tpu_torch.ops.attention.paged import paged_attention
    return (paged_attention.launches, paged_attention.tc_launches,
            paged_attention.decode_launches)


def max_memory_line(tag, device, when):
    import torch
    if torch.device(device).type == "cuda":
        log(f"[{tag}] {when}: torch.cuda.max_memory_allocated() "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def qos_prompts(seed, vocab):
    """[serve-qos]'s interactive prompts (4 of 64-128 tokens, at most 512
    together: one prefill step at [serve]'s budget) and flood prompts (10 of
    1024-2048 tokens)."""
    rng = np.random.default_rng(seed + 20)
    inter = [rng.integers(0, vocab, int(n)).tolist() for n in rng.integers(64, 129, 4)]
    flood = [rng.integers(0, vocab, int(n)).tolist() for n in rng.integers(1024, 2049, 10)]
    return inter, flood


def qos_pass(engine, prompts, tenants, classes, max_new):
    """One synchronized ``generate`` with QoS identities: (results, wall s,
    programs built during it)."""
    device = engine.device
    built = engine.ledger.total
    _sync(device)
    t0 = time.perf_counter()
    results = engine.generate(prompts, max_new_tokens=max_new, strict=False, tenants=tenants,
                              service_classes=classes)
    _sync(device)
    return results, time.perf_counter() - t0, engine.ledger.total - built


def serve_qos(card, cfg, params, kw, prompts, max_new, results, first, warm, warm_launches,
              seed=0):
    """[serve-qos]: [serve]'s engine (Mistral-7B bf16, pool, budget, fast
    path with graphs) with request tracing and ``serving_qos`` on.

    1. Identity: [serve]'s 16 prompts through the default tenant with no
       quotas, cold then warm: ServeCounters equal to [serve]'s first and
       warm serves, the same tokens, and the warm serve's paged launches
       (total, tensor-core prefill, split-K decode) equal to [serve]'s warm
       serve's.
    2. Baseline: an ``interactive`` tenant's 4 prompts of 64-128 tokens, 32
       new tokens, nothing else in flight: its TTFT p95.
    3. Noisy neighbour: the same 4 prompts behind a ``batch``-class flood
       tenant's 10 prompts of 1024-2048 tokens (flood first in the call),
       the flood under ``QOS_FLOOD`` (2048 tokens/s, burst 4096, 512 KV
       blocks).
    Passes 2 and 3 are each run once first under other tenant names (the
    same override), so their graphs are built before the measured passes.
    Gates: every interactive request ok; its TTFT p95 at most 2x the
    baseline's (floored at QOS_TTFT_FLOOR_S); at least one flood request
    shed ``quota_exceeded``, every flood shed retryable with 0 <
    retry_after_s < 120; at least one flood request ok; the policy's
    admitted/shed ledger equal to the results; no stall, the pool reclaimed,
    nothing live or queued; the ``serving_tenant_*`` families strict-parse
    from ``populate_from_engine`` with per-tenant TTFT counts equal to the
    requests; ``health()["qos"]`` JSON-serializable.  Returns the measured
    numbers."""
    import torch
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    from deepspeed_tpu_torch.inference.v2.qos import BATCH, INTERACTIVE, QUOTA_EXCEEDED
    from deepspeed_tpu_torch.monitor.exposition import parse_exposition, render
    from deepspeed_tpu_torch.monitor.metrics import MetricsRegistry, populate_from_engine
    device = kw["device"]
    log(f"[serve-qos] {nvidia_smi_line() if torch.device(device).type == 'cuda' else card}")
    max_memory_line("serve-qos", device, "start")
    engine = build_engine("mistral", cfg, params, **kw, config={
        "dtype": "bfloat16", "seed": seed, "serving_tracing": {"enabled": True},
        "serving_qos": {"enabled": True, "tenants": {"flood": QOS_FLOOD,
                                                     "flood_warm": QOS_FLOOD}}})
    if engine.qos is None or engine.admission.qos is None or engine.scheduler.qos is None:
        raise AssertionError("[serve-qos] serving_qos on did not arm the policy")
    # ---- 1. identity: the default tenant with no quotas is [serve]
    walls = {}
    for label, want in (("cold", first), ("warm", warm)):
        c0, l0 = engine.counters.snapshot(), paged_counts()
        got, wall = serve_timed(engine, prompts, max_new)
        d = engine.counters.delta_since(c0)
        launched = tuple(b - a for a, b in zip(l0, paged_counts()))
        if d != want:
            raise AssertionError(f"[serve-qos] {label} serve: ServeCounters {d}, [serve]'s {want}")
        if [r.tokens for r in got] != [r.tokens for r in results]:
            raise AssertionError(f"[serve-qos] {label} serve: tokens differ from [serve]'s at "
                                 f"{first_divergence(results, got, prompts)}")
        if label == "warm" and launched != warm_launches:
            raise AssertionError(f"[serve-qos] warm serve: paged launches (total, prefill, "
                                 f"decode) {launched}, [serve]'s warm serve {warm_launches}")
        walls[label] = wall
    log(f"[serve-qos] identity on {card}: {len(prompts)} requests of the default tenant, cold "
        f"serve {walls['cold']:.3f} s with ServeCounters equal to [serve]'s first serve "
        f"({first['compiles']} captures), warm serve {walls['warm']:.3f} s with ServeCounters "
        f"equal to [serve]'s warm serve ({warm['host_syncs']} host syncs), tokens identical, "
        f"paged launches (total, tensor-core prefill, split-K decode) {launched} equal to "
        f"[serve]'s warm serve's")
    inter, flood = qos_prompts(seed, cfg.vocab_size)
    n_i, n_f = len(inter), len(flood)
    # ---- 2. the interactive tenant alone (a warm-up pass first)
    qos_pass(engine, inter, ["int_warm"] * n_i, [INTERACTIVE] * n_i, max_new)
    base, walls["baseline"], built_base = qos_pass(engine, inter, ["int_base"] * n_i,
                                                   [INTERACTIVE] * n_i, max_new)
    if not all(r.ok for r in base):
        raise AssertionError(f"[serve-qos] baseline statuses {[r.status for r in base]}")
    hists = engine.tracer.tenant_histograms()
    base_p = hists[("int_base", "ttft")].percentiles()
    # ---- 3. the flood first, the interactive trickle behind it
    mixed_prompts = flood + inter
    qos_pass(engine, mixed_prompts, ["flood_warm"] * n_f + ["int_warm2"] * n_i,
             [BATCH] * n_f + [INTERACTIVE] * n_i, max_new)
    mixed, walls["noisy"], built_noisy = qos_pass(
        engine, mixed_prompts, ["flood"] * n_f + ["int_live"] * n_i,
        [BATCH] * n_f + [INTERACTIVE] * n_i, max_new)
    flood_res, live = mixed[:n_f], mixed[n_f:]
    if not all(r.ok for r in live):
        raise AssertionError(f"[serve-qos] interactive statuses under the flood "
                             f"{[r.status for r in live]}")
    sheds = [r for r in flood_res if r.status == "shed"]
    quota = [r for r in sheds if r.shed_code == QUOTA_EXCEEDED]
    bad = [(r.uid, r.shed_code, r.retryable, r.retry_after_s) for r in sheds
           if r.shed_code != QUOTA_EXCEEDED or not r.retryable or r.retry_after_s is None
           or not 0 < r.retry_after_s < 120]
    flood_ok = [r for r in flood_res if r.ok]
    if not quota or bad or not flood_ok or len(flood_ok) + len(sheds) != n_f:
        raise AssertionError(f"[serve-qos] flood: statuses {[r.status for r in flood_res]}, "
                             f"malformed sheds {bad}")
    hists = engine.tracer.tenant_histograms()
    live_p = hists[("int_live", "ttft")].percentiles()
    limit = 2.0 * max(base_p["p95"], QOS_TTFT_FLOOR_S)
    if live_p["p95"] > limit:
        raise AssertionError(f"[serve-qos] interactive TTFT p95 {live_p['p95']:.4f} s under the "
                             f"flood, over 2x its baseline {base_p['p95']:.4f} s (limit "
                             f"{limit:.4f} s)")
    pol = engine.qos
    want_admitted = {("flood", BATCH): len(flood_ok), ("int_live", INTERACTIVE): n_i}
    got_admitted = {k: pol.admitted_by_tenant.get(k) for k in want_admitted}
    got_shed = {k: v for k, v in pol.shed_by_tenant.items() if k[0] in ("flood", "int_live")}
    if got_admitted != want_admitted or got_shed != {("flood", QUOTA_EXCEEDED): len(quota)}:
        raise AssertionError(f"[serve-qos] ledger admitted {got_admitted} (results "
                             f"{want_admitted}), shed {got_shed} ({len(quota)} quota sheds)")
    health = engine.health()
    free = engine.manager.allocator.free_blocks
    if (health["stalls_total"], health["live_seqs"], health["queue_depth"]) != (0, 0, 0) \
            or free != engine.manager.allocator.num_blocks - 1 or engine.manager.seqs:
        raise AssertionError(f"[serve-qos] stalls {health['stalls_total']}, live "
                             f"{health['live_seqs']}, queued {health['queue_depth']}, free "
                             f"blocks {free}, {len(engine.manager.seqs)} sequences tracked")
    reg = MetricsRegistry()
    populate_from_engine(reg, engine)
    fams = parse_exposition(render(reg))
    ttft_counts = {labels.get("tenant"): v for name, labels, v
                   in fams["dstpu_serving_tenant_ttft_seconds"]["samples"]
                   if name.endswith("_count")}
    want_counts = {"int_base": n_i, "int_live": n_i, "flood": len(flood_ok)}
    if any(ttft_counts.get(t) != float(n) for t, n in want_counts.items()):
        raise AssertionError(f"[serve-qos] per-tenant TTFT counts {ttft_counts}, requests "
                             f"{want_counts}")
    for family in ("dstpu_serving_tenant_admitted_total", "dstpu_serving_tenant_shed_total",
                   "dstpu_serving_tenant_tokens_total",
                   "dstpu_serving_tenant_retry_after_seconds", "dstpu_serving_tenant_e2e_seconds"):
        if family not in fams:
            raise AssertionError(f"[serve-qos] {family} missing from the exposition")
    qos_json = json.dumps(health["qos"])
    charged = pol.tokens_by_tenant["flood"]
    flood_tokens = [len(p) for p in flood]
    log(f"[serve-qos] per-tenant TTFT on {card}: baseline (int_base, alone) p50 / p95 "
        f"{base_p['p50'] * 1e3:.3f} / {base_p['p95'] * 1e3:.3f} ms; under the flood (int_live) "
        f"{live_p['p50'] * 1e3:.3f} / {live_p['p95'] * 1e3:.3f} ms (gate p95 <= "
        f"{limit * 1e3:.1f} ms); flood "
        + " / ".join(f"{hists[('flood', 'ttft')].percentiles()[q] * 1e3:.3f}" for q in
                     ("p50", "p95")) + " ms")
    log(f"[serve-qos] noisy neighbour on {card}: flood of {n_f} prompts "
        f"({sum(flood_tokens)} tokens, {min(flood_tokens)}-{max(flood_tokens)} each): "
        f"{len(flood_ok)} ok, sheds by code {dict(collections.Counter(r.shed_code for r in sheds))}, "
        f"retry_after_s {sorted(round(r.retry_after_s, 4) for r in quota)}; the flood's admitted "
        f"tokens {charged} against its burst of {QOS_FLOOD['token_burst']:.0f} at "
        f"{QOS_FLOOD['tokens_per_s']:.0f} tokens/s; interactive {n_i} of {n_i} ok; "
        f"health()['qos'] {len(qos_json)} bytes of JSON")
    log(f"[serve-qos] walls on {card}: identity cold {walls['cold']:.3f} s, warm "
        f"{walls['warm']:.3f} s; baseline {walls['baseline']:.3f} s ({built_base} programs "
        f"built); noisy {walls['noisy']:.3f} s ({built_noisy} programs built); stalls 0, pool "
        f"reclaimed")
    max_memory_line("serve-qos", device, "end")
    del engine
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"base_p95": base_p["p95"], "live_p95": live_p["p95"], "flood_ok": len(flood_ok),
            "quota_sheds": len(quota), "charged": charged}


# [serve-fleet]: the placement of each uid, routed totals, affinity count and
# hit blocks by replica that the CPU rehearsal predicts
# (``rehearse_serve_fleet()``); the card's counts are gated equal to them
FLEET_PREDICTED = {"placed": [0, 1, 0, 0, 1, 0, 0, 0] * 3, "routed_total": [18, 6],
                   "affinity_routed_total": 24, "hit_blocks": [384, 128]}


def fleet_workload(seed, vocab, bs):
    """[serve-fleet]'s 24 requests: 8 headers of 32 blocks, 3 requests each
    with a seeded tail of 16-128 tokens, in rounds (one request of every
    header a round); headers 0-3 belong to tenant ``acme``, 4-7 to
    ``globex``.  Returns (prompts, tenants, header of each request)."""
    rng = np.random.default_rng(seed + 30)
    headers = [rng.integers(0, vocab, 32 * bs).tolist() for _ in range(8)]
    prompts, tenants, header_of = [], [], []
    for _ in range(3):
        for h, header in enumerate(headers):
            prompts.append(header + rng.integers(0, vocab, int(rng.integers(16, 129))).tolist())
            tenants.append("acme" if h < 4 else "globex")
            header_of.append(h)
    return prompts, tenants, header_of


def serve_fleet_run(cfg, params, kw, seed, journal_dir, dtype, max_new=32, ops=True):
    """``FleetRouter`` over 2 in-process replicas of ``build_engine("mistral",
    ...)`` (prefix cache on, each replica's journal under ``journal_dir``,
    ``affinity_blocks`` 1, the fleet ``ops_server`` on port 0 with ``ops``)
    serving :func:`fleet_workload`.  Every engine audits its KV census after
    every schedule (a block shared across tenants raises).  Returns the
    router, the results, the replica of each uid, each engine's census
    audits and the most blocks it held shared at once, and the wall."""
    from deepspeed_tpu_torch.inference.v2 import FleetRouter
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    device = kw["device"]
    prompts, tenants, _ = fleet_workload(seed, cfg.vocab_size, kw["block_size"])
    audits = []

    def factory():
        engine = build_engine("mistral", cfg, params, **kw, config={"dtype": dtype, "seed": seed})
        real, mgr, seen = engine.scheduler.schedule, engine.manager, {"audits": 0, "shared": 0}

        def schedule(*args, **kwargs):
            out = real(*args, **kwargs)
            mgr.census.check_against(mgr.allocator, mgr.seqs)
            seen["audits"] += 1
            seen["shared"] = max(seen["shared"], mgr.census.shared_blocks())
            return out

        engine.scheduler.schedule = schedule
        audits.append(seen)
        return engine

    router = FleetRouter([factory, factory], journal_dir=journal_dir,
                         config={"replicas": 2, "affinity_blocks": 1},
                         ft_config={"enabled": True}, block_size=kw["block_size"],
                         ops_server={"enabled": True, "port": 0} if ops else None)
    _sync(device)
    t0 = time.perf_counter()
    results = router.serve(prompts, max_new_tokens=max_new, tenants=tenants)
    _sync(device)
    wall = time.perf_counter() - t0
    placed = {e["uid"]: e["replica"] for e in router.recorder.tail() if e["event"] == "route"}
    return router, results, placed, audits, wall


def fleet_counts(router, placed):
    """What the rehearsal predicts and the card must equal: the replica of
    each uid, the routed totals, the affinity counters and each replica's
    realized prefix-cache hit blocks."""
    return {"placed": [placed[u] for u in sorted(placed)],
            "routed_total": list(router.routed_total),
            "affinity_routed_total": router.affinity_routed_total,
            "hit_blocks": [r.health["prefix_cache"]["hit_blocks_total"] for r in router.replicas]}


def check_fleet_run(tag, router, results, placed, audits, prompts, tenants, header_of, max_new):
    """[serve-fleet]'s gates but the equality with the rehearsal."""
    if not all(r.ok for r in results) or router.lost_total or \
            any(len(r.tokens) != len(p) + max_new for r, p in zip(results, prompts)):
        raise AssertionError(f"[{tag}] statuses {[r.status for r in results]}, lost "
                             f"{router.lost_total}")
    groups = collections.defaultdict(set)
    for uid, (tenant, h) in enumerate(zip(tenants, header_of)):
        groups[(tenant, h)].add(placed[uid])
        home = router._affinity_home(prompts[uid], tenant)
        if placed[uid] != home:
            raise AssertionError(f"[{tag}] request {uid} ({tenant}, header {h}) on replica "
                                 f"{placed[uid]}, its affinity home is {home}")
    if any(len(v) != 1 for v in groups.values()) or sum(router.routed_total) != len(prompts):
        raise AssertionError(f"[{tag}] placement by (tenant, header) {dict(groups)}, routed "
                             f"{router.routed_total}")
    homes = {next(iter(v)) for v in groups.values()}
    for i in homes:
        pc = router.replicas[i].health["prefix_cache"]
        if not pc["hit_blocks_total"] > 0:
            raise AssertionError(f"[{tag}] home replica {i} realized no prefix hit: {pc}")
    if not audits or any(a["audits"] == 0 for a in audits):
        raise AssertionError(f"[{tag}] census audits {audits}")
    return homes


def serve_fleet(card, cfg, params, kw, seed=0, max_new=32):
    """[serve-fleet]: ``FleetRouter`` over 2 in-process replicas of [serve]'s
    Mistral-7B bf16 engine sharing the card and the params (each engine its
    own KV pool and graphs, built per serve by its replica's supervisor),
    :func:`fleet_workload`'s 24 requests behind 8 headers of 512 tokens in
    two tenants, 32 new tokens.  Gates: every request ok and
    ``lost_total == 0``; each (tenant, header)'s requests on one replica,
    its ``_affinity_home``; ``sum(routed_total) == 24``; every home replica
    with prefix-cache hit blocks; the census audit after every schedule
    finds no block shared across tenants; one scrape of the router's fleet
    ``/metrics`` strict-parses with the ``populate_from_router`` families
    and the absorbed replicas' counters (completed requests 24); the
    placement, routed totals, affinity count and hit blocks equal
    ``FLEET_PREDICTED`` (the CPU rehearsal's).  Prints the fleet's wall
    against one engine serving the same 24 requests (not gated: the
    replicas serve in turn on one card)."""
    import tempfile
    import torch
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    from deepspeed_tpu_torch.monitor.exposition import parse_exposition
    from deepspeed_tpu_torch.monitor.ops_server import scrape
    device = kw["device"]
    log(f"[serve-fleet] {nvidia_smi_line() if torch.device(device).type == 'cuda' else card}")
    max_memory_line("serve-fleet", device, "start")
    prompts, tenants, header_of = fleet_workload(seed, cfg.vocab_size, kw["block_size"])
    with tempfile.TemporaryDirectory(prefix="serve_fleet_") as tmp:
        router, results, placed, audits, wall = serve_fleet_run(cfg, params, kw, seed, tmp,
                                                                "bfloat16", max_new)
        try:
            homes = check_fleet_run("serve-fleet", router, results, placed, audits, prompts,
                                    tenants, header_of, max_new)
            counts = fleet_counts(router, placed)
            if counts != FLEET_PREDICTED:
                raise AssertionError(f"[serve-fleet] counts {counts}, the rehearsal's "
                                     f"{FLEET_PREDICTED}")
            fams = parse_exposition(scrape(router.ops.url("/metrics")))
            completed = sum(v for _, _, v in fams["dstpu_serving_completed_total"]["samples"])
            routed = {labels["replica"]: v for _, labels, v
                      in fams["dstpu_router_routed_total"]["samples"]}
            by_tenant = {labels["tenant"]: v for _, labels, v
                         in fams["dstpu_router_tenant_routed_total"]["samples"]}
            if (completed != len(prompts) or routed != {str(i): float(n) for i, n in
                                                        enumerate(router.routed_total)}
                    or by_tenant != {"acme": 12.0, "globex": 12.0}
                    or fams["dstpu_router_lost_total"]["samples"][0][2] != 0):
                raise AssertionError(f"[serve-fleet] fleet /metrics: completed {completed}, "
                                     f"routed {routed}, by tenant {by_tenant}")
        finally:
            router.close()
    log(f"[serve-fleet] on {card}: {len(prompts)} requests ({sum(len(p) for p in prompts)} "
        f"prompt tokens, 8 headers of {32 * kw['block_size']} tokens in tenants acme and "
        f"globex), all ok, lost 0; routed {router.routed_total}, affinity "
        f"{router.affinity_routed_total}, homes {sorted(homes)}, every (tenant, header) on its "
        f"home; hit blocks by "
        f"replica {counts['hit_blocks']}, placement and counts equal to the CPU rehearsal's; "
        f"census audits {[a['audits'] for a in audits]} with at "
        f"most {[a['shared'] for a in audits]} blocks shared at once, none across tenants; "
        f"fleet /metrics scraped: {len(fams)} families, completed {completed:.0f}")
    # one engine serving the same 24 requests, cold as each replica's engine
    _sync(device)
    t0 = time.perf_counter()
    single = build_engine("mistral", cfg, params, **kw, config={"dtype": "bfloat16", "seed": seed})
    one = single.generate(prompts, max_new_tokens=max_new, strict=False)
    _sync(device)
    wall_one = time.perf_counter() - t0
    same = sum(a.tokens == b.tokens for a, b in zip(one, results))
    log(f"[serve-fleet] walls on {card}: the fleet {wall:.3f} s (2 replicas in turn, each a "
        f"cold engine with its captures) against one engine {wall_one:.3f} s (cold, the same "
        f"24 requests in one batch; not gated); {same} of {len(prompts)} streams token-identical "
        f"to the single engine's (bf16 in other batch shapes, not gated)")
    max_memory_line("serve-fleet", device, "end")
    del single, router
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return counts


def rehearse_serve_fleet(seed=0):
    """CPU rehearsal of [serve-fleet], for a prediction: its workload, pool,
    scheduler and router at a tiny width on the CPU (the vocabulary of
    Mistral-7B, so the prompts and their affinity homes are the card's).
    The host control flow decides placement and prefix hits, so the counts
    are the card's.  Run: ``python3 -c "import chip_smoke as c;
    c.rehearse_serve_fleet()"``."""
    import tempfile
    import torch
    from deepspeed_tpu_torch.models import mistral
    full = mistral.MistralConfig.mistral_7b()
    cfg = mistral.MistralConfig.tiny(vocab=full.vocab_size, hidden=64, layers=2, heads=4,
                                     kv_heads=2, seq=4096, window=4096)
    params = mistral.init_params(cfg, torch.Generator().manual_seed(seed))
    kw = dict(device="cpu", num_blocks=2048, block_size=16, max_blocks_per_seq=256,
              token_budget=512, max_seqs_per_step=32)
    prompts, tenants, header_of = fleet_workload(seed, cfg.vocab_size, kw["block_size"])
    with tempfile.TemporaryDirectory(prefix="rehearse_fleet_") as tmp:
        router, results, placed, audits, _ = serve_fleet_run(cfg, params, kw, seed, tmp,
                                                             "float32", ops=False)
    check_fleet_run("rehearse-serve-fleet", router, results, placed, audits, prompts, tenants,
                    header_of, 32)
    counts = fleet_counts(router, placed)
    log(f"[rehearse-serve-fleet] CPU, tiny width: {json.dumps(counts)}; census audits "
        f"{[a['audits'] for a in audits]}, most blocks shared at once "
        f"{[a['shared'] for a in audits]}")
    return counts


def rehearse_serve_qos(seed=0):
    """CPU rehearsal of [serve-qos]'s counts, for a prediction: the same
    engine config, prompts and passes at a tiny width on the CPU (the
    vocabulary of Mistral-7B): which flood requests are admitted and shed,
    the retry hints and the ledger (host control flow; the wall and the
    TTFTs are not the card's).  Run: ``python3 -c "import chip_smoke as c;
    c.rehearse_serve_qos()"``."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2.qos import BATCH, INTERACTIVE
    from deepspeed_tpu_torch.models import mistral
    full = mistral.MistralConfig.mistral_7b()
    cfg = mistral.MistralConfig.tiny(vocab=full.vocab_size, hidden=64, layers=2, heads=4,
                                     kv_heads=2, seq=4096, window=4096)
    params = mistral.init_params(cfg, torch.Generator().manual_seed(seed))
    engine = InferenceEngineV2(mistral, cfg, params, device="cpu", config={
        "dtype": "float32", "serving_tracing": {"enabled": True},
        "serving_qos": {"enabled": True, "tenants": {"flood": QOS_FLOOD}}},
        num_blocks=2048, block_size=16, max_blocks_per_seq=256, token_budget=512,
        max_seqs_per_step=32)
    inter, flood = qos_prompts(seed, cfg.vocab_size)
    mixed, _, _ = qos_pass(engine, flood + inter, ["flood"] * len(flood) + ["int_live"] * 4,
                           [BATCH] * len(flood) + [INTERACTIVE] * 4, 32)
    view = {"statuses": [r.status for r in mixed],
            "retry_after_s": [r.retry_after_s for r in mixed if r.status == "shed"],
            "qos": engine.health()["qos"], "forward_steps": engine.forward_steps,
            "inter_lens": [len(p) for p in inter], "flood_lens": [len(p) for p in flood]}
    log(f"[rehearse-serve-qos] CPU, tiny width: {json.dumps(view)}")
    return view


# [slice-fleet]: [slice-recover]'s width and pool, the lane's three replicas
SLICE_FLEET_HEADER_SEED = 5


def arm_fleet_crash(engine):
    """Make an engine die right after its second productive serve event (a
    dispatched step or a non-empty decode burst, bursts clamped to 2 steps):
    every generation then dies mid-decode with journaled in-flight prefixes
    and no terminals (the ``fleet_smoke`` lane's fault)."""
    events = {"n": 0}

    def productive():
        events["n"] += 1
        if events["n"] >= 2:
            raise RuntimeError("injected mid-decode crash")

    real_burst, real_dispatch = engine.decode_burst, engine._dispatch_step

    def burst(k, *args, **kwargs):
        out = real_burst(min(int(k), 2), *args, **kwargs)
        if out:
            productive()
        return out

    def dispatch(*args, **kwargs):
        out = real_dispatch(*args, **kwargs)
        if out is not None:
            productive()
        return out

    engine.decode_burst, engine._dispatch_step = burst, dispatch
    return engine


def fleet_counters(families):
    """Every counter sample of a parsed exposition by (name, labels)."""
    return {(name, tuple(sorted(labels.items()))): value
            for body in families.values() if body["type"] == "counter"
            for name, labels, value in body["samples"]}


def phase_slice_fleet(device="cuda", cfg=None):
    """[slice-fleet]: the ``fleet_smoke`` lane's contract on the card at
    [slice-recover]'s fp32 2-layer width, pool and budget.  Three
    in-process replicas behind ``FleetRouter`` (``affinity_blocks`` 1,
    journals with ``max_restarts`` 1, ``serving_qos`` on with a tenant
    ``tight`` of 4 tokens' burst); wave 1 (four requests, two of them
    behind one shared 16-token header) with every replica healthy, wave 2
    (four more) with replica 0's engines crashing mid-decode until its
    restart budget runs out, then a request routed around the drained
    replica beside one of tenant ``tight`` over its quota.  Gates: (a)
    every request ok; (b) every stream token-identical to an uninterrupted
    single engine's (QoS off) on the device; (c) the fleet ``/metrics``
    strict-parses and every fleet counter is monotone across the failover;
    (d) the header pair's home realizes prefix hits; (e) ``lost_total ==
    0`` and every admit journaled anywhere is terminal somewhere; the
    quota-shed request is surfaced (``quota_exceeded``), not re-routed:
    ``quota_sheds_by_tenant == {"tight": 1}`` and one journal holds its
    uid."""
    import tempfile
    import torch
    from deepspeed_tpu_torch.inference.v2 import FleetRouter
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    from deepspeed_tpu_torch.inference.v2.journal import replay_journal
    from deepspeed_tpu_torch.inference.v2.qos import QUOTA_EXCEEDED
    from deepspeed_tpu_torch.models import mistral
    from deepspeed_tpu_torch.monitor.exposition import parse_exposition
    if cfg is None:
        cfg = dataclasses.replace(mistral.MistralConfig.mistral_7b(), num_layers=2)
    if torch.device(device).type == "cuda":
        log(f"[slice-fleet] {nvidia_smi_line()}")
    max_memory_line("slice-fleet", device, "start")
    params = slice_recover_model(cfg, device)
    bs = SLICE_KW["block_size"]
    base = slice_recover_prompts(cfg.vocab_size)
    rng = np.random.default_rng(SLICE_FLEET_HEADER_SEED)
    header = rng.integers(0, cfg.vocab_size, bs).tolist()
    pair = [header + rng.integers(0, cfg.vocab_size, n).tolist() for n in (3, 5)]
    mixed = base[:2] + pair + base[2:]
    wave1, wave2 = mixed[:4], mixed[4:]
    late, tight = [3, 1, 4, 1, 5], rng.integers(0, cfg.vocab_size, 12).tolist()
    t0 = time.perf_counter()
    want = build_engine("mistral", cfg, params, config={"dtype": "float32"}, device=device,
                        **SLICE_KW).generate(mixed + [late], max_new_tokens=SLICE_MAX_NEW)
    fault = {"armed": False}
    qos_cfg = {"enabled": True, "tenants": {"tight": {"tokens_per_s": 1.0, "token_burst": 4.0}}}

    def factory(index):
        def build():
            engine = build_engine("mistral", cfg, params, device=device, **SLICE_KW,
                                  config={"dtype": "float32", "serving_qos": qos_cfg})
            return arm_fleet_crash(engine) if index == 0 and fault["armed"] else engine
        return build

    with tempfile.TemporaryDirectory(prefix="slice_fleet_") as tmp:
        router = FleetRouter([factory(r) for r in range(3)], journal_dir=tmp,
                             config={"replicas": 3, "affinity_blocks": 1,
                                     "health_stale_s": 600.0},
                             ft_config={"enabled": True, "max_restarts": 1, "fsync_every": 1},
                             block_size=bs)
        home = router._affinity_home(pair[0])
        out1 = router.serve(wave1, uids=list(range(len(wave1))), max_new_tokens=SLICE_MAX_NEW)
        scrape1 = parse_exposition(router.metrics_text())
        hits = [v for _, labels, v in scrape1["dstpu_serving_kv_prefix_hits_total"]["samples"]
                if labels.get("rank") == str(home)]
        fault["armed"] = True
        out2 = router.serve(wave2, uids=list(range(len(wave1), len(mixed))),
                            max_new_tokens=SLICE_MAX_NEW)
        scrape2 = parse_exposition(router.metrics_text())
        routed0 = router.routed_total[0]
        out3 = router.serve([late, tight], uids=[99, 100], max_new_tokens=SLICE_MAX_NEW,
                            tenants=["default", "tight"])
        scrape3 = parse_exposition(router.metrics_text())
        states = {r.index: replay_journal(r.journal_path, truncate=False)
                  for r in router.replicas if os.path.exists(r.journal_path)}
        router.close()
    got = [r.tokens for r in out1 + out2] + [out3[0].tokens]
    if not all(r.ok for r in out1 + out2 + out3[:1]) or got != want:
        raise AssertionError(f"[slice-fleet] (a, b) statuses "
                             f"{[r.status for r in out1 + out2 + out3]}, tokens differ from the "
                             f"uninterrupted run at {[_first_diff(a, b) for a, b in zip(got, want)]}")
    migrations = [e for e in router.recorder.tail() if e["event"] == "migrate"]
    if (router.migrations_total != 1 or not router.replicas[0].drained
            or not any(e["emitted"] > 0 for e in migrations)
            or router.routed_total[0] != routed0):
        raise AssertionError(f"[slice-fleet] failover: migrations {router.migrations_total}, "
                             f"drained {[r.drained for r in router.replicas]}, migrate events "
                             f"{migrations}, routed {router.routed_total}")
    regressed = {}
    for before, after in ((scrape1, scrape2), (scrape2, scrape3)):
        b, a = fleet_counters(before), fleet_counters(after)
        regressed.update({k: (b[k], a[k]) for k in b if k in a and a[k] < b[k] - 1e-9})
    if regressed or fleet_counters(scrape2)[("dstpu_router_migrations_total", ())] != 1.0:
        raise AssertionError(f"[slice-fleet] (c) fleet counters went backwards: {regressed}")
    if not hits or max(hits) <= 0:
        raise AssertionError(f"[slice-fleet] (d) no prefix hit on home replica {home}: {hits}")
    admitted = set().union(*(s.entries for s in states.values()))
    terminal = {u for s in states.values() for u, e in s.entries.items() if e.done}
    if router.lost_total or admitted - terminal:
        raise AssertionError(f"[slice-fleet] (e) lost {router.lost_total}, journaled without a "
                             f"terminal anywhere {sorted(admitted - terminal)}")
    shed = out3[1]
    holders = [i for i, s in states.items() if 100 in s.entries]
    if (shed.status != "shed" or shed.shed_code != QUOTA_EXCEEDED or not shed.retryable
            or router.quota_sheds_by_tenant != {"tight": 1} or len(holders) != 1
            or router.reroutes_total):
        raise AssertionError(f"[slice-fleet] quota shed: {shed}, quota sheds "
                             f"{router.quota_sheds_by_tenant}, journals holding it {holders}, "
                             f"reroutes {router.reroutes_total}")
    log(f"[slice-fleet] hidden {cfg.hidden_size}, {cfg.num_layers} layers, fp32, 3 replicas on "
        f"{device}: {len(mixed) + 1} requests ok and token-identical to the uninterrupted run; wave 2's replica 0 crashed "
        f"mid-decode past its budget (max_restarts 1), drained, {router.migrated_requests_total} "
        f"requests migrated ({sum(e['emitted'] > 0 for e in migrations)} with an emitted prefix), "
        f"lost 0, every journaled admit terminal; fleet counters monotone over 3 scrapes "
        f"({len(fleet_counters(scrape3))} counter samples); prefix hits on home replica {home}: "
        f"{max(hits):.0f}; tenant tight's request shed quota_exceeded (retry_after_s "
        f"{shed.retry_after_s}), surfaced once, in one journal, not re-routed; routed "
        f"{router.routed_total}; {time.perf_counter() - t0:.1f} s")
    max_memory_line("slice-fleet", device, "end")
    del router
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 5
# -------------------------------------------------- speculative decoding
SPEC_NGRAM = {"enabled": True, "drafter": "ngram", "k": 4}
SPEC_CYCLE = {"enabled": True, "drafter": "ngram", "k": 8}
# measured passes of the cycling A/B after its warm pass (one, so that the
# whole run fits its 1200 s on a slower host)
SPEC_CYCLE_TIMED = 1
SPEC_SELF = {"enabled": True, "drafter": "model", "k": 15, "adaptive_k": False}
SPEC_CYCLE_REQUESTS, SPEC_CYCLE_PROMPT, SPEC_CYCLE_NEW = 16, 512, 128
SPEC_DRAFT_BLOCKS = 1280  # the drafter's pool: [serve]'s prompts need about 1,040 blocks


def route_launches(widths, layers, dtype):
    """(total, tensor-core prefill, split-K decode) paged launches that
    forwards by padded chunk width (``{width: forwards}``) make over
    ``layers`` layers, by the wrapper's own rule."""
    from deepspeed_tpu_torch.ops.attention.paged import paged_route
    routes = [(paged_route(dtype, t), k) for t, k in widths.items()]
    return (sum(k for _, k in routes) * layers,
            sum(k for r, k in routes if r == "prefill_tc") * layers,
            sum(k for r, k in routes if r == "decode") * layers)


def program_keys(engine):
    """The (site, key) of every program the engine has built."""
    return {(site, repr(key)) for site in ("fwd", "burst", "spec_verify", "draft")
            for key in engine.programs.keys(site)}


def widths_since(counter, before):
    return {t: k - before.get(t, 0) for t, k in counter.items() if k > before.get(t, 0)}


def check_serve_results(tag, engine, prompts, results, max_new, vocab):
    """Every request ok with the prompt echoed and ``max_new`` tokens in the
    vocabulary; the pool reclaimed, nothing tracked."""
    for prompt, res in zip(prompts, results):
        if res.status != "ok" or len(res.tokens) != len(prompt) + max_new:
            raise AssertionError(f"[{tag}] request {res.uid}: status {res.status} "
                                 f"({res.reason}), {len(res.tokens)} tokens for a "
                                 f"{len(prompt)}-token prompt")
        if res.tokens[:len(prompt)] != prompt:
            raise AssertionError(f"[{tag}] request {res.uid}: prompt not echoed")
        if not all(0 <= tok < vocab for tok in res.tokens[len(prompt):]):
            raise AssertionError(f"[{tag}] request {res.uid}: token id outside the vocabulary")
    free = engine.manager.allocator.free_blocks
    if free != engine.manager.allocator.num_blocks - 1 or engine.manager.seqs:
        raise AssertionError(f"[{tag}] KV pool not reclaimed: {free} blocks free, "
                             f"{len(engine.manager.seqs)} sequences tracked")


def counted_pass(tag, engine, cfg, run, drafter=None):
    """``run()`` synchronized: (its result, wall s, programs built, paged
    launches by route, the engine's and the drafter's forwards by padded
    width).  Gates: the launches equal the forwards the engine (fwd steps,
    burst steps, verify rounds) and the model drafter (catch-ups, steps)
    ran, by padded width and route, times the layers."""
    counts0, widths0 = paged_counts(), dict(engine.chunk_widths)
    dwidths0 = dict(drafter.chunk_widths) if drafter is not None else {}
    built = engine.ledger.total
    _sync(engine.device)
    t0 = time.perf_counter()
    results = run()
    _sync(engine.device)
    wall = time.perf_counter() - t0
    launches = tuple(b - a for a, b in zip(counts0, paged_counts()))
    widths = widths_since(engine.chunk_widths, widths0)
    dwidths = widths_since(drafter.chunk_widths, dwidths0) if drafter is not None else {}
    dtype = engine.dtype
    want = tuple(a + b for a, b in zip(route_launches(widths, cfg.num_layers, dtype),
                                       route_launches(dwidths, cfg.num_layers, dtype)))
    if engine.device.type == "cuda" and launches != want:
        raise AssertionError(f"[{tag}] paged launches (total, tensor-core, decode) {launches}; "
                             f"the engine's forwards by width {widths} and the drafter's "
                             f"{dwidths} x {cfg.num_layers} layers give {want}")
    return results, wall, engine.ledger.total - built, launches, widths, dwidths


def spec_line(engine):
    h = engine.health()["spec_decode"]
    per_round = (h["emitted_total"] / max(sum(h["tokens_per_verify"].values()), 1))
    return h, (f"acceptance {h['acceptance_rate']:.4f}, tokens per verify per sequence "
               f"{per_round:.3f} (histogram {h['tokens_per_verify']}), rounds "
               f"{h['rounds_total']}, fallback rounds {h['fallback_rounds_total']}, live k "
               f"{h['k']}")


def check_spec_families(tag, engine):
    """The serving_spec_* families strict-parse and agree with
    ``health()["spec_decode"]`` and the ServeCounters."""
    from deepspeed_tpu_torch.monitor.exposition import parse_exposition, render
    from deepspeed_tpu_torch.monitor.metrics import MetricsRegistry, populate_from_engine
    h = engine.health()["spec_decode"]
    c = engine.counters
    if (c.spec_proposed, c.spec_accepted, c.spec_rounds) != (
            h["proposed_total"], h["accepted_total"], h["rounds_total"]):
        raise AssertionError(f"[{tag}] ServeCounters spec tail {c.snapshot()} against the stats "
                             f"{h}")
    reg = MetricsRegistry()
    populate_from_engine(reg, engine)
    fams = parse_exposition(render(reg))
    val = lambda name: fams[f"dstpu_serving_spec_{name}"]["samples"][0][2]  # noqa: E731
    tpv = sum(v for n, _, v in fams["dstpu_serving_spec_tokens_per_verify"]["samples"]
              if n.endswith("_count"))
    got = (val("proposed_total"), val("accepted_total"), val("rounds_total"),
           val("fallback_rounds_total"), tpv)
    want = (h["proposed_total"], h["accepted_total"], h["rounds_total"],
            h["fallback_rounds_total"], sum(h["tokens_per_verify"].values()))
    if (got != tuple(float(x) for x in want)
            or abs(val("acceptance") - h["acceptance_rate"]) > 1e-4):
        raise AssertionError(f"[{tag}] serving_spec_* families {got} against health {want}")
    return len(fams)


def spec_cycle_params(params):
    """[serve-spec]'s cycling target: the params with every layer's attention
    output projection zeroed (a new leaf; the others shared), so the logits
    depend on the current token alone and greedy decode falls into a cycle."""
    import torch
    layers = params["layers"]
    attn = {**layers["attn"], "wo": torch.zeros_like(layers["attn"]["wo"])}
    return {**params, "layers": {**layers, "attn": attn}}


def spec_drive(engine, prompts, max_new):
    """``bench.measure_serving_spec``'s drive: one wave put at once, then
    ``_fused_decode`` over the smallest remaining budget while it is 2 or
    more, ``step`` otherwise, each request flushed at ``max_new`` tokens.
    Returns (tokens generated, wall s, each request's tokens)."""
    n = len(prompts)
    device = engine.device
    produced = {u: 0 for u in range(n)}
    final = {}
    tokens = 0
    _sync(device)
    t0 = time.perf_counter()
    engine.put(list(range(n)), prompts)
    for _ in range(100 * n * max_new):
        if len(final) == n:
            break
        k = min(max_new - produced[u] for u in range(n) if u not in final)
        out = engine._fused_decode(k, greedy=True, eos_token_id=None) if k >= 2 else None
        if out is None:
            out = {u: [t] for u, t in engine.step().items()}
        for uid, toks in out.items():
            produced[uid] += len(toks)
            tokens += len(toks)
            if produced[uid] >= max_new:
                final[uid] = list(engine.manager.seqs[uid].tokens)
                engine.manager.seqs[uid].done = True
                engine.flush(uid)
    _sync(device)
    wall = time.perf_counter() - t0
    if len(final) != n:
        raise AssertionError(f"spec drive: {n - len(final)} requests unfinished")
    return tokens, wall, [final[u] for u in range(n)]


def cycle_departure(prompt, generated):
    """The first generated position whose token is not the successor the
    prompt's cycle gives its predecessor (None if the stream stays on it)."""
    succ = dict(zip(prompt[:-1], prompt[1:]))  # the latest occurrence wins
    prev = prompt[-1]
    for i, tok in enumerate(generated):
        if succ.get(prev) != tok:
            return i
        prev = tok
    return None


def cycle_entered(prompt):
    """(whether the prompt's last token occurred before in it, the distance
    back to that occurrence): with the logits a function of the current
    token, a repeat means the greedy stream has entered its cycle."""
    last = prompt[-1]
    for back in range(1, len(prompt)):
        if prompt[-1 - back] == last:
            return True, back
    return False, None


def serve_spec(card, cfg, params, kw, prompts, max_new, results, warm_wall, seed=0):
    """[serve-spec]: speculative decoding on [serve]'s Mistral-7B bf16 engine
    setup (pool, budget, fast path with graphs), in three parts:

    1. n-gram (k 4) on [serve]'s 16 prompts, 32 new tokens, cold, warm and
       again: every request ok, rounds > 0, warm recompiles 0 and the third
       serve captures nothing (the controller carries its floor count from
       serve to serve, so the warm serve may first reach a bucket), the
       pool reclaimed; the paged launches equal the fwd
       steps, burst steps and verify rounds by padded width and route x 32
       layers; the spec counters equal the stats and the serving_spec_*
       families strict-parse and agree.
    2. The cycling workload of ``bench.measure_serving_spec`` at full width:
       ``wo`` zeroed, 16 seeded 8-token seeds continued 504 tokens by the
       spec-off engine, then 128 new tokens spec off and on (n-gram, k 8),
       each engine warmed once and timed over ``SPEC_CYCLE_TIMED`` pass(es)
       through ``_fused_decode``: every request finished, acceptance >= 0.5, no warm
       recompile (the captures of each pass are printed).
    3. The target attached as its own drafter (k 15, adaptive off) on
       [serve]'s prompts, cold then warm: every request ok, both pools
       reclaimed, the draft and verify programs captured once (the warm
       serve builds nothing), the launches of the engine's and the
       drafter's forwards as in 1; then twice through part 2's drive on its
       prompts (its window lets the k 15 round run): verify rounds of width
       16 on the tensor-core route.
    Returns the parts' numbers."""
    import torch
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    device = kw["device"]
    on_card = torch.device(device).type == "cuda"
    vocab = cfg.vocab_size
    log(f"[serve-spec] {nvidia_smi_line() if on_card else card}")
    max_memory_line("serve-spec", device, "start")
    out = {}
    # ---- 1. n-gram on [serve]'s prompts
    engine = build_engine("mistral", cfg, params, **kw, config={
        "dtype": "bfloat16", "seed": seed, "serving_spec_decode": SPEC_NGRAM})
    passes = {}
    for label in ("cold", "warm", "again"):
        before, keys = engine.counters.snapshot(), program_keys(engine)
        res, wall, built, launches, widths, _ = counted_pass(
            "serve-spec", engine, cfg,
            lambda: engine.generate(prompts, max_new_tokens=max_new, strict=False))
        check_serve_results("serve-spec", engine, prompts, res, max_new, vocab)
        passes[label] = (res, wall, sorted(program_keys(engine) - keys), launches, widths,
                         engine.counters.delta_since(before))
    # the adaptive controller carries its floor count across serves, so the
    # warm serve's re-probe may reach a (live set, k) the cold serve did not:
    # it builds that bucket cold (never a key again: warm recompiles stay 0),
    # and once the walk has been seen a serve builds nothing
    res, wall, built, launches, widths, delta = passes["warm"]
    if passes["again"][2] or engine.ledger.warm_total:
        raise AssertionError(f"[serve-spec] the third n-gram serve built {passes['again'][2]} "
                             f"({engine.ledger.warm_total} warm recompiles)")
    h, line = spec_line(engine)
    if h["rounds_total"] <= 0:
        raise AssertionError(f"[serve-spec] no verify round ran: {h}")
    n_fams = check_spec_families("serve-spec", engine)
    same = sum(a.tokens == b.tokens for a, b in zip(res, results))
    verify = {t: k for t, k in widths.items() if t > 1 and t <= SPEC_NGRAM["k"] + 1}
    log(f"[serve-spec] n-gram k {SPEC_NGRAM['k']} on [serve]'s {len(prompts)} prompts, "
        f"{max_new} new tokens, on {card}: cold {passes['cold'][1]:.3f} s "
        f"({len(passes['cold'][2])} captures, by site and class "
        f"{json.dumps(engine.ledger.by_site)} after all three serves), warm {wall:.3f} s "
        f"(captures {built}), again {passes['again'][1]:.3f} s (0 captures), warm recompiles "
        f"0, against [serve]'s warm {warm_wall:.3f} s; all ok, pool reclaimed; {line}; verify "
        f"rounds cold {passes['cold'][5]['spec_rounds']}, warm {delta['spec_rounds']}, again "
        f"{passes['again'][5]['spec_rounds']} (the controller keeps its k across serves); "
        f"warm serve: host syncs {delta['host_syncs']}, forwards by padded width "
        f"{dict(sorted(widths.items()))} (verify widths {verify}); paged launches (total, "
        f"tensor-core prefill, split-K decode) {launches} = those forwards x {cfg.num_layers} "
        f"layers; spec counters equal the stats, {n_fams} families strict-parsed; "
        f"{same} of {len(prompts)} streams token-identical to [serve]'s spec-off serve (bf16, "
        f"not gated)")
    out["ngram"] = {"cold_s": passes["cold"][1], "warm_s": wall, "launches": launches,
                    "acceptance": h["acceptance_rate"], "rounds": h["rounds_total"],
                    "same": same}
    max_memory_line("serve-spec", device, "after the n-gram part")
    del engine, passes, res
    if on_card:
        torch.cuda.empty_cache()
    # ---- 2. the cycling workload
    log(f"[serve-spec] {nvidia_smi_line() if on_card else card}")
    cyc = spec_cycle_params(params)
    mk = lambda spec: build_engine("mistral", cfg, cyc, **kw, config={  # noqa: E731
        "dtype": "bfloat16", "seed": seed, **({"serving_spec_decode": spec} if spec else {})})
    eng_off, eng_on = mk(None), mk(SPEC_CYCLE)
    rng = np.random.default_rng(seed + 30)
    seeds = [rng.integers(1, vocab, 8).tolist() for _ in range(SPEC_CYCLE_REQUESTS)]
    t0 = time.perf_counter()
    cont = eng_off.generate(seeds, max_new_tokens=SPEC_CYCLE_PROMPT - 8)
    cyc_prompts = [c[:SPEC_CYCLE_PROMPT] for c in cont]
    entered = [cycle_entered(p) for p in cyc_prompts]
    log(f"[serve-spec] cycling prompts: {len(seeds)} seeds of 8 tokens continued "
        f"{SPEC_CYCLE_PROMPT - 8} tokens spec off in {time.perf_counter() - t0:.2f} s; "
        f"{sum(e for e, _ in entered)} of {len(entered)} have entered their cycle, cycle "
        f"lengths {[b for _, b in entered]}")
    walls, streams, builds = {}, {}, {}
    for name, eng in (("off", eng_off), ("on", eng_on)):
        # one warm pass, then SPEC_CYCLE_TIMED measured ones, the best kept
        # (the bench takes 3); the controller carries its EWMA from pass to
        # pass, so a timed pass may still reach a new bucket: its captures
        # are printed
        built = eng.ledger.total
        spec_drive(eng, cyc_prompts, SPEC_CYCLE_NEW)
        warm = eng.ledger.total - built
        timed = []
        best = 0.0
        for _ in range(SPEC_CYCLE_TIMED):
            built = eng.ledger.total
            toks, wall, finals = spec_drive(eng, cyc_prompts, SPEC_CYCLE_NEW)
            timed.append(eng.ledger.total - built)
            if toks != SPEC_CYCLE_REQUESTS * SPEC_CYCLE_NEW:
                raise AssertionError(f"[serve-spec] cycling drive ({name}) made {toks} tokens")
            best = max(best, toks / wall) if wall > 0 else best
        if eng.ledger.warm_total:
            raise AssertionError(f"[serve-spec] cycling drive ({name}): "
                                 f"{eng.ledger.warm_total} warm recompiles")
        check_serve_results("serve-spec", eng, [], [], 0, vocab)
        walls[name], streams[name], builds[name] = best, finals, (warm, timed)
    h, line = spec_line(eng_on)
    if h["acceptance_rate"] < 0.5:
        raise AssertionError(f"[serve-spec] cycling acceptance {h['acceptance_rate']} < 0.5: {h}")
    same = sum(a == b for a, b in zip(streams["on"], streams["off"]))
    ratio = walls["on"] / walls["off"] if walls["off"] else float("nan")
    departs = [cycle_departure(p, f[len(p):]) for p, f in zip(cyc_prompts, streams["on"])]
    log(f"[serve-spec] cycling workload on {card} ({SPEC_CYCLE_REQUESTS} requests of "
        f"{SPEC_CYCLE_PROMPT} tokens, {SPEC_CYCLE_NEW} new, wo zeroed, best of "
        f"{SPEC_CYCLE_TIMED} after a warm pass, through _fused_decode): spec off "
        f"{walls['off']:.1f} tok/s, spec on (n-gram k "
        f"{SPEC_CYCLE['k']}) {walls['on']:.1f} tok/s, ratio {ratio:.3f}; {line}; captures off "
        f"{json.dumps(eng_off.ledger.by_site)}, on {json.dumps(eng_on.ledger.by_site)}, "
        f"captures in the warm pass and the timed passes: off {builds['off']}, on "
        f"{builds['on']}, warm recompiles 0; {same} of {len(cyc_prompts)} streams "
        f"token-identical spec on and off (bf16, not gated); the first generated token off "
        f"the prompt's cycle, by request (None: on it throughout) {departs}")
    out["cycle"] = {"off_tok_s": walls["off"], "on_tok_s": walls["on"], "ratio": ratio,
                    "acceptance": h["acceptance_rate"], "k": h["k"], "same": same}
    max_memory_line("serve-spec", device, "after the cycling part")
    del eng_off, eng_on, cyc, mk
    if on_card:
        torch.cuda.empty_cache()
    # ---- 3. the target as its own drafter
    log(f"[serve-spec] {nvidia_smi_line() if on_card else card}")
    from deepspeed_tpu_torch.models import mistral
    engine = build_engine("mistral", cfg, params, **kw, config={
        "dtype": "bfloat16", "seed": seed, "serving_spec_decode": SPEC_SELF})
    engine.attach_draft_model(mistral, cfg, params, num_blocks=SPEC_DRAFT_BLOCKS)
    drafter = engine._drafter
    passes = {}
    for label in ("cold", "warm"):
        res, wall, built, launches, widths, dwidths = counted_pass(
            "serve-spec", engine, cfg,
            lambda: engine.generate(prompts, max_new_tokens=max_new, strict=False),
            drafter=drafter)
        check_serve_results("serve-spec", engine, prompts, res, max_new, vocab)
        drafter._gc(set())
        if len(drafter._free) != SPEC_DRAFT_BLOCKS - 1:
            raise AssertionError(f"[serve-spec] the drafter's pool holds "
                                 f"{SPEC_DRAFT_BLOCKS - 1 - len(drafter._free)} blocks")
        passes[label] = (res, wall, built, launches, widths, dwidths)
    res, wall, built, launches, widths, dwidths = passes["warm"]
    by_site = engine.ledger.by_site
    if built or engine.ledger.warm_total or not by_site.get("draft") \
            or not by_site.get("spec_verify"):
        raise AssertionError(f"[serve-spec] self-drafting: the warm serve built {built} programs "
                             f"({engine.ledger.warm_total} warm), captures {by_site}")
    h, line = spec_line(engine)
    same = sum(a.tokens == b.tokens for a, b in zip(res, results))
    log(f"[serve-spec] the target as its own drafter (k {SPEC_SELF['k']}, adaptive off, draft "
        f"pool {SPEC_DRAFT_BLOCKS} blocks) on [serve]'s prompts on {card}: cold "
        f"{passes['cold'][1]:.3f} s, warm {wall:.3f} s against [serve]'s warm {warm_wall:.3f} "
        f"s; all ok, both pools reclaimed; {line}; captures by site "
        f"{json.dumps(by_site)}, the warm serve 0; warm forwards by padded width: engine "
        f"{dict(sorted(widths.items()))}, drafter {dict(sorted(dwidths.items()))}; paged "
        f"launches {launches} = their forwards x {cfg.num_layers} layers; {same} of "
        f"{len(prompts)} streams token-identical to [serve]'s (bf16, not gated)")
    # [serve]'s SplitFuse serve leaves a fused window of a few tokens, so
    # its rounds stay narrow; the cycling drive's window (about 113 tokens)
    # lets the k 15 round run: a verify of width 16 on the tensor-core route
    drives = []
    for _ in range(2):  # the first builds what the drive hits
        before = engine.counters.snapshot()
        drive, dwall, dbuilt, dlaunches, dw, ddw = counted_pass(
            "serve-spec", engine, cfg, lambda: spec_drive(engine, cyc_prompts, SPEC_CYCLE_NEW),
            drafter=drafter)
        if drive[0] != SPEC_CYCLE_REQUESTS * SPEC_CYCLE_NEW:
            raise AssertionError(f"[serve-spec] self-drafting drive made {drive[0]} tokens")
        drives.append((drive, dwall, dbuilt, dlaunches, dw, ddw,
                       engine.counters.delta_since(before)))
    drive, dwall, dbuilt, dlaunches, dw, ddw, dd = drives[1]
    wide = dw.get(SPEC_SELF["k"] + 1, 0)
    if not wide or (on_card and dlaunches[1] < wide * cfg.num_layers) \
            or engine.ledger.warm_total:
        raise AssertionError(f"[serve-spec] self-drafting drive: {wide} verify rounds of width "
                             f"{SPEC_SELF['k'] + 1}, launches {dlaunches}, "
                             f"{engine.ledger.warm_total} warm recompiles")
    log(f"[serve-spec] the self-drafting engine through the cycling drive's prompts (wo kept; "
        f"{SPEC_CYCLE_REQUESTS} x {SPEC_CYCLE_PROMPT} tokens, {SPEC_CYCLE_NEW} new) on {card}: "
        f"{drive[0] / drive[1]:.1f} tok/s in its second pass ({dbuilt} captures; the first "
        f"{drives[0][2]}), {wide} verify rounds of width {SPEC_SELF['k'] + 1} on the tensor-core "
        f"route, acceptance over the pass "
        f"{dd['spec_accepted'] / max(dd['spec_proposed'], 1):.4f} ({dd['spec_rounds']} rounds); "
        f"forwards by padded width: engine {dict(sorted(dw.items()))}, drafter "
        f"{dict(sorted(ddw.items()))}; paged launches (total, tensor-core prefill, split-K "
        f"decode) {dlaunches} = their forwards x {cfg.num_layers} layers")
    out["self"] = {"cold_s": passes["cold"][1], "warm_s": wall, "launches": launches,
                   "acceptance": h["acceptance_rate"], "same": same,
                   "drive_tok_s": drive[0] / drive[1], "drive_launches": dlaunches}
    max_memory_line("serve-spec", device, "end")
    del engine, drafter, passes
    if on_card:
        torch.cuda.empty_cache()
    return out


def faulty_allocator(num_blocks, fail_rate, seed):
    """The port's allocator failing each ``allocate`` with probability
    ``fail_rate`` from a seeded ``random.Random`` (the JAX package's test
    allocator's schedule), before the free list changes."""
    import random

    from deepspeed_tpu_torch.inference.v2.blocked_allocator import (BlockedAllocator,
                                                                    KVAllocationError)

    class FaultyAllocator(BlockedAllocator):

        def __init__(self):
            super().__init__(num_blocks)
            self._rng = random.Random(seed)
            self.injected_failures = 0

        def allocate(self, n):
            if self._rng.random() < fail_rate:
                self.injected_failures += 1
                raise KVAllocationError("injected allocation failure")
            return super().allocate(n)

    return FaultyAllocator()


def phase_slice_spec(device="cuda", cfg=None):
    """[slice-spec]: ``spec_decode_smoke``'s contract at [slice-serve]'s fp32
    2-layer Mistral-7B width and pool, on the card: (a) greedy spec on
    (n-gram, k 4) token-identical to spec off under 25 % allocator faults,
    the pool reclaimed, no stall, speculation engaged; (b) the same with
    deadlines expiring mid-decode on a fake clock; (c) the card's
    ``rejection_select`` at T > 0 ((0.9, 0, 1.0), V 24, k 3, 4,000 draws)
    within total variation 0.08 of the filtered target; (d) the health
    section and the families agree with the counters, and a spec-off engine
    renders no spec family; (e) the target attached as its own drafter
    accepts every draft (rate 1.0) with the spec-off tokens."""
    import torch
    from deepspeed_tpu_torch.inference.engine import _filter_logits
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    from deepspeed_tpu_torch.inference.v2.spec_decode import rejection_select
    from deepspeed_tpu_torch.models import mistral
    from deepspeed_tpu_torch.monitor.metrics import MetricsRegistry, populate_from_engine
    on_card = torch.device(device).type == "cuda"
    if cfg is None:
        cfg = dataclasses.replace(mistral.MistralConfig.mistral_7b(), num_layers=2)
    log(f"[slice-spec] {nvidia_smi_line() if on_card else device}")
    params = slice_recover_model(cfg, device)
    prompts = slice_recover_prompts(cfg.vocab_size)
    nb = SLICE_KW["num_blocks"]

    def mk(spec, **over):
        conf = {"dtype": "float32"}
        if spec:
            conf["serving_spec_decode"] = spec
        return build_engine("mistral", cfg, params, config=conf, device=device,
                            **{**SLICE_KW, **over})

    # (a) greedy identity under 25 % allocator faults
    def faulted(spec):
        engine = mk(spec)
        engine.manager.allocator = faulty_allocator(nb, 0.25, 7)
        res = engine.generate(prompts, max_new_tokens=SLICE_MAX_NEW, strict=False)
        alloc = engine.manager.allocator
        if not alloc.injected_failures or alloc.free_blocks != nb - 1 \
                or engine.health()["stalls_total"]:
            raise AssertionError(f"[slice-spec] faulted serve: {alloc.injected_failures} "
                                 f"injected failures, {alloc.free_blocks} of {nb - 1} blocks "
                                 f"free, {engine.health()['stalls_total']} stalls")
        return [(r.status, r.tokens) for r in res], engine

    spec_res, spec_eng = faulted(SPEC_NGRAM)
    off_res, _ = faulted(None)
    if spec_res != off_res:
        raise AssertionError(f"[slice-spec] spec on diverged from spec off under faults at "
                             f"{[_first_diff(a[1], b[1]) for a, b in zip(spec_res, off_res)]}")
    h = spec_eng.health()["spec_decode"]
    healthy = mk(SPEC_NGRAM).generate(prompts, max_new_tokens=SLICE_MAX_NEW)
    if h["rounds_total"] <= 0 or [t for _, t in spec_res] != healthy:
        raise AssertionError(f"[slice-spec] speculation did not engage ({h}) or the faulted "
                             f"run differs from the healthy one")
    # (b) deadlines expiring mid-decode on a fake clock
    expiring = {}
    for name, spec in (("on", SPEC_NGRAM), ("off", None)):
        engine = mk(spec, clock=StepClock(0.05))
        res = engine.generate(prompts[:2], max_new_tokens=64, strict=False, ttl_s=0.4)
        expiring[name] = [(r.uid, r.status, r.tokens) for r in res]
    if expiring["on"] != expiring["off"]:
        raise AssertionError(f"[slice-spec] deadline partials differ: {expiring}")
    # (c) the sampler's first-position marginal at T > 0, on the device
    sample_cfg, v, k, draws = (0.9, 0, 1.0), 24, 3, 4000
    base = torch.from_numpy(np.random.default_rng(3).normal(0.0, 1.5, size=(1, k + 1, v))
                            .astype(np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    packed = rejection_select(base.repeat(draws, 1, 1),
                              torch.tensor([[1, 2, 3]], dtype=torch.int32,
                                           device=device).repeat(draws, 1),
                              gen, sample_cfg=sample_cfg)
    freq = np.bincount(packed[:, 1].cpu().numpy(), minlength=v) / draws
    target = torch.softmax(_filter_logits(base[0, :1], temperature=sample_cfg[0],
                                          top_k=sample_cfg[1], top_p=sample_cfg[2])[0],
                           dim=-1).cpu().numpy()
    tv = 0.5 * float(np.abs(freq - target).sum())
    if tv >= 0.08:
        raise AssertionError(f"[slice-spec] the sampler's marginal is {tv:.4f} from the "
                             f"filtered target in total variation (limit 0.08)")
    # (d) the health section and the families agree; spec off renders none
    n_fams = check_spec_families("slice-spec", spec_eng)
    reg = MetricsRegistry()
    populate_from_engine(reg, mk(None))
    if any("spec" in name for name in reg.families):
        raise AssertionError(f"[slice-spec] a spec-off engine renders "
                             f"{[n for n in reg.families if 'spec' in n]}")
    # (e) the target as its own drafter
    self_eng = mk({"enabled": True, "drafter": "model", "k": 4})
    self_eng.attach_draft_model(mistral, cfg, params)
    got = self_eng.generate(prompts, max_new_tokens=SLICE_MAX_NEW)
    hs = self_eng.health()["spec_decode"]
    if got != healthy or hs["acceptance_rate"] != 1.0 or hs["rounds_total"] <= 0:
        raise AssertionError(f"[slice-spec] self-drafting: acceptance {hs['acceptance_rate']}, "
                             f"tokens equal to spec off: {got == healthy}")
    log(f"[slice-spec] mistral_7b width, 2 layers, fp32, on {device}: (a) spec on == spec off "
        f"under 25 % allocator faults ({spec_eng.manager.allocator.injected_failures} injected "
        f"with spec on), == the healthy run, pool reclaimed, 0 stalls, {h['rounds_total']} "
        f"rounds, acceptance {h['acceptance_rate']}; (b) deadline partials equal "
        f"({[s for _, s, _ in expiring['on']]}); (c) sampler TV {tv:.4f} < 0.08 over {draws} "
        f"draws; (d) health, counters and {n_fams} families agree, spec off renders no spec "
        f"family; (e) self-drafting acceptance {hs['acceptance_rate']} over "
        f"{hs['rounds_total']} rounds, tokens equal to spec off")
    return {"tv": tv, "rounds": h["rounds_total"]}


# ------------------------------------------------------------ model families
# the families build_engine serves beside Llama and Mistral, at their
# published widths and depths, but Mixtral-8x7B: 8 of its 32 layers (about
# 93 GB of bf16 weights at full depth, more than one card holds)
SERVE_FAMILIES = ("qwen2", "mixtral", "opt", "gptj", "phi", "falcon")
# [slice-families]'s: the served families and BLOOM, which [serve-bloom]
# serves on its own (its weights go on to [serve-v1-bloom])
SLICE_FAMILIES = SERVE_FAMILIES + ("bloom", )
FAMILY_SERVE_LAYERS = {"mixtral": 8}
FAMILY_REQUESTS, FAMILY_MAX_NEW = 8, 16
# 8 prompts of at most 1,024 tokens and 16 new: at most 65 blocks of 16 each
FAMILY_KW = dict(num_blocks=576, block_size=16, max_blocks_per_seq=72, token_budget=512,
                 max_seqs_per_step=32)
# the paged route a family's prefill steps (padded chunk >= 16) take in bf16
FAMILY_PREFILL_ROUTE = {"qwen2": "prefill_tc", "mixtral": "prefill_tc", "opt": "prefill_tc",
                        "gptj": "prefill_tc", "phi": "prefill_tc", "falcon": "prefill_tc",
                        "bloom": "prefill_tc"}


def family_config(key, layers=None):
    """(module, config) of a served family at its published width, at
    ``layers`` layers (default: its own depth, or FAMILY_SERVE_LAYERS's)."""
    from deepspeed_tpu_torch.inference.v2.engine_factory import REGISTRY
    from deepspeed_tpu_torch.models import bloom, falcon, gptj, mixtral, opt, phi, qwen
    cfg = {"qwen2": qwen.QwenConfig.qwen2_7b, "mixtral": mixtral.MixtralConfig.mixtral_8x7b,
           "opt": opt.OPTConfig.opt_125m, "gptj": gptj.GPTJConfig.gptj_6b,
           "phi": phi.PhiConfig.phi_2, "falcon": falcon.FalconConfig.falcon_7b,
           "bloom": bloom.BloomConfig.bloom_7b1}[key]()
    layers = layers or FAMILY_SERVE_LAYERS.get(key)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return (bloom if key == "bloom" else REGISTRY[key]), cfg


def family_engine(key, module, cfg, params, **kw):
    """``build_engine`` under the family's key; BLOOM, which has none (as in
    the JAX factory), through ``InferenceEngineV2(bloom, ...)``."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2.engine_factory import REGISTRY, build_engine
    if key in REGISTRY:
        return build_engine(key, cfg, params, **kw)
    return InferenceEngineV2(module, cfg, params, **kw)


def family_params(module, cfg, seed, dtype, device="cuda"):
    """Seeded random weights drawn on ``device``; the q/k/v biases (zeros
    from ``init_params``: Qwen2's ``layers.attn.b*``, OPT's and Phi's flat
    ``layers.b*``, BLOOM's fused ``layers.b_qkv``) are drawn too, so that
    they add something."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    params = module.init_params(cfg, gen, dtype=dtype, device=device)
    for leaves in (params["layers"].get("attn", {}), params["layers"]):
        for name in ("bq", "bk", "bv", "b_qkv"):
            if name in leaves:
                leaves[name].normal_(0.0, 0.1, generator=gen)
    return params


def heads_of(cfg):
    """(head dim, GQA group) of a model config (MHA families have no
    ``num_kv_heads``)."""
    kv = getattr(cfg, "num_kv_heads", cfg.num_heads)
    return cfg.hidden_size // cfg.num_heads, cfg.num_heads // kv


def family_prompts(seed, vocab):
    """A family serve's prompts: lengths 32, 1024 and 6 drawn from 32-1024."""
    rng = np.random.default_rng(seed)
    lens = np.concatenate([[32, 1024], rng.integers(32, 1025, FAMILY_REQUESTS - 2)])
    return [rng.integers(0, vocab, int(n)).tolist() for n in lens]


def route_split(launches):
    """(tensor-core prefill, split-K decode, CUDA-core) of a (total,
    tensor-core, decode) launch count."""
    total, tc, dec = launches
    return tc, dec, total - tc - dec


def serve_family(card, key, seed=0, device="cuda", config=None, kw=None, params=None):
    """[serve-<key>]: ``build_engine(key, ...)`` (:func:`family_engine`) in
    bf16 (fp32 off the card) from seeded random weights drawn on the device
    (or ``params``, the caller's), the fast path with CUDA
    graphs; 8 prompts of 32-1,024 tokens, greedy, 16 new tokens, a cold and a
    warm serve.  Gates: every request ok and the pool reclaimed; paged
    launches equal the forward steps by padded width and route times the
    layers (counted under replay), prefill steps on the family's route
    (tensor cores at every head dim, none on the CUDA-core kernel) and
    decode steps on split-K; the warm serve builds nothing and gives the cold serve's
    tokens.  Prints tok/s, the mean step, the device's idle share (the warm
    serve again under torch.profiler), peak memory and the graph pool."""
    import torch
    from deepspeed_tpu_torch.runtime.tree import tree_leaves
    tag = f"serve-{key}"
    module, cfg = config or family_config(key)
    on_card = torch.device(device).type == "cuda"
    dtype_name = "bfloat16" if on_card else "float32"
    dtype = getattr(torch, dtype_name)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if params is None:
        params = family_params(module, cfg, seed, dtype, device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    if n_params != module.num_params(cfg):
        raise AssertionError(f"[{tag}] init_params made {n_params} params, num_params says "
                             f"{module.num_params(cfg)}")
    engine = family_engine(key, module, cfg, params, config={"dtype": dtype_name, "seed": seed},
                           device=device, **(kw or FAMILY_KW))
    if on_card and not (engine.fastpath.enabled and engine.programs.graphs):
        raise AssertionError(f"[{tag}] the engine on CUDA does not run the fast path's graphs")
    _sync(device)
    head_dim, group = heads_of(cfg)
    log(f"[{tag}] {cfg.num_layers} layers, hidden {cfg.hidden_size}, {cfg.num_heads} q heads "
        f"over {cfg.num_heads // group} kv heads, head dim {head_dim}, vocab {cfg.vocab_size}: "
        f"{n_params / 1e9:.3f} B params "
        f"({sum(p.numel() * p.element_size() for p in tree_leaves(params)) / 1e9:.2f} GB "
        f"{dtype}), set up in {time.perf_counter() - t0:.2f} s")
    prompts = family_prompts(seed, cfg.vocab_size)
    generated = FAMILY_MAX_NEW * len(prompts)
    run = lambda: engine.generate(prompts, max_new_tokens=FAMILY_MAX_NEW, strict=False)  # noqa: E731
    passes = {}
    for label in ("cold", "warm"):
        results, wall, built, launches, widths, _ = counted_pass(tag, engine, cfg, run)
        check_serve_results(tag, engine, prompts, results, FAMILY_MAX_NEW, cfg.vocab_size)
        steps = sum(widths.values())
        tc, dec, cc = route_split(launches)
        prefill = {"prefill_tc": tc, "cuda_core": cc}
        want = FAMILY_PREFILL_ROUTE[key]
        if on_card and (not dec or not prefill[want] or any(
                v for route, v in prefill.items() if route != want)):
            raise AssertionError(f"[{tag}] {label}: launches tensor-core {tc}, split-K {dec}, "
                                 f"CUDA-core {cc}; prefill steps belong on {ROUTE_NAMES[want]}")
        passes[label] = dict(results=results, wall=wall, built=built, launches=launches,
                             steps=steps)
        log(f"[{tag}] {label} serve on {card}: {len(prompts)} requests "
            f"({sum(len(p) for p in prompts)} prompt tokens, {generated} generated) all ok, wall "
            f"{wall:.3f} s, {generated / wall:.1f} generated tok/s, {steps} forward steps, mean "
            f"step {wall / steps * 1e3:.2f} ms, {built} programs built; paged launches "
            f"{launches[0]} = {steps} x {cfg.num_layers}: tensor-core prefill {tc}, split-K "
            f"decode {dec}, CUDA-core {cc} (steps by padded width {dict(sorted(widths.items()))})")
    cold, warm = passes["cold"], passes["warm"]
    if warm["built"] or engine.ledger.warm_total:
        raise AssertionError(f"[{tag}] the warm serve built {warm['built']} programs "
                             f"({engine.ledger.warm_total} warm)")
    if [r.tokens for r in warm["results"]] != [r.tokens for r in cold["results"]]:
        raise AssertionError(f"[{tag}] the warm serve's tokens differ from the cold serve's at "
                             f"{first_divergence(cold['results'], warm['results'], prompts)}")
    busy = None
    if on_card:
        busy = profile_device(run, card, f"profile-{key}", "warm serve", warm["wall"] * 1e3,
                              PAGED_NEEDLES, top=6)
    pool = engine.programs.pool_bytes()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    idle = "not measured" if busy is None else f"{1 - busy / (warm['wall'] * 1e3):.1%}"
    peak_s = "not measured" if peak is None else f"{peak / 2**30:.2f} GiB"
    pool_s = "not measured" if pool is None else f"{pool / 2**30:.3f} GiB"
    log(f"[{tag}] warm serve: 0 captures, tokens identical to the cold serve; idle share "
        f"{idle}, peak memory {peak_s}, graph pool {pool_s}")
    del engine, params
    if on_card:
        torch.cuda.empty_cache()
    return {"launches": dict(zip(("tensor_core", "split_k", "cuda_core"),
                                 route_split(cold["launches"]))),
            "steps": cold["steps"], "layers": cfg.num_layers,
            "tok_s": generated / warm["wall"], "step_ms": warm["wall"] / warm["steps"] * 1e3}


def phase_serve_families(card, seed=0):
    """[serve-qwen2], [serve-mixtral], [serve-opt], [serve-gptj],
    [serve-phi], [serve-falcon] one after the other (each frees its weights
    before the next)."""
    out = {}
    for key in SERVE_FAMILIES:
        with phase_timer(f"serve-{key}"):
            out[key] = serve_family(card, key, seed)
    return out


def phase_serve_bloom(card, seed=0):
    """[serve-bloom]: BLOOM-7b1 at full width and depth in bf16 (seeded
    random weights on the card) through ``InferenceEngineV2(bloom, ...)``,
    :func:`serve_family`'s serve and gates, ALiBi on the paged kernel's
    slopes operand; then [serve-v1-bloom], the same weights through
    ``init_inference(model_module=bloom, ...)`` after the v2 engine and its
    pool are freed, with :func:`serve_v1`'s serve and gates and no kernel
    launched.  Returns [serve-bloom]'s summary."""
    import torch
    import deepspeed_tpu_torch
    module, cfg = family_config("bloom")
    params = family_params(module, cfg, seed, torch.bfloat16)
    with phase_timer("serve-bloom"):
        served = serve_family(card, "bloom", seed, params=params)
    torch.cuda.empty_cache()
    with phase_timer("serve-v1-bloom"):
        t0 = time.perf_counter()
        engine = deepspeed_tpu_torch.init_inference(
            model_module=module, model_config=cfg, params=params,
            config={"dtype": "bfloat16", "max_seq_len": V1_PROMPT + V1_NEW})
        log(f"[serve-v1-bloom] bloom_7b1 through the v1 engine, the [serve-bloom] weights, set "
            f"up in {time.perf_counter() - t0:.2f} s")
        prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (V1_BATCH, V1_PROMPT))
        before = launch_counts()
        serve_v1(card, "serve-v1-bloom", engine, prompts, cfg.vocab_size)
        if launch_counts() != before:
            raise AssertionError(f"[serve-v1-bloom] launched {launch_counts()} (before "
                                 f"{before}); the v1 path's biased attention is plain torch")
    del engine, params
    torch.cuda.empty_cache()
    return served


@contextlib.contextmanager
def plain_paged_attention():
    """The families' ``forward_paged`` with the paged attention's plain
    version (``paged_attention_reference``) in place of the kernel wrapper,
    on the same (CUDA) tensors: Llama-shaped families (Qwen2, Mixtral) call
    it from ``models/llama.py``, OPT, GPT-J, Phi, Falcon and BLOOM from
    their own modules."""
    from deepspeed_tpu_torch.models import bloom, falcon, gptj, llama, opt, phi
    from deepspeed_tpu_torch.ops.attention.paged import paged_attention_reference

    def plain(q, kpool, vpool, tables, lengths, start_pos, n_tokens, *, block_size,
              softmax_scale=None, window=None, alibi_slopes=None):
        scale = softmax_scale if softmax_scale is not None else 1.0 / np.sqrt(q.shape[-1])
        return paged_attention_reference(q, kpool, vpool, tables, lengths, start_pos, n_tokens,
                                         scale, window, alibi_slopes)

    modules = (llama, opt, gptj, phi, falcon, bloom)
    saved = [m.paged_attention for m in modules]
    for m in modules:
        m.paged_attention = plain
    try:
        yield
    finally:
        for m, fn in zip(modules, saved):
            m.paged_attention = fn


def slice_family_paged(key, module, cfg, params, device):
    """Check 1: one prefill chunk (70 and 33 tokens in a chunk of 128) and
    two decode steps of ``forward_paged`` through the kernel and through the
    plain paged version, each on its own pool: logits of every live row
    within atol = rtol = 1e-4, fed the kernel path's greedy picks.  Returns
    the largest error and the (total, tensor-core, decode) launches."""
    import torch
    bs, nb = 16, 40
    kv = module.init_paged_cache(cfg, nb, bs, dtype=torch.float32, device=device)
    kv_plain = module.init_paged_cache(cfg, nb, bs, dtype=torch.float32, device=device)
    rng = np.random.default_rng(SLICE_FAMILIES.index(key))
    tables = np.full((2, 8), nb - 1, np.int32)
    tables[0, :6] = [3, 9, 1, 12, 20, 7]
    tables[1, :4] = [5, 30, 2, 11]
    plen = [70, 33]
    tokens = np.zeros((2, 128), np.int32)
    for i, n in enumerate(plen):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)
    n_tokens, start = np.asarray(plen, np.int32), np.zeros(2, np.int32)
    worst = 0.0
    counts0 = paged_counts()
    for step in range(3):
        args = [torch.from_numpy(a).to(device) for a in (tokens, n_tokens, start, tables)]
        got, _ = module.forward_paged(cfg, params, *args, kv, block_size=bs)
        with plain_paged_attention():
            ref, _ = module.forward_paged(cfg, params, *args, kv_plain, block_size=bs)
        live = torch.arange(tokens.shape[1], device=device)[None, :] < args[1].long()[:, None]
        err = (got - ref).abs()[live]
        bad = err > 1e-4 + 1e-4 * ref.abs()[live]
        if not torch.isfinite(got).all() or bad.any():
            raise AssertionError(f"[slice-families] {key} step {step}: the kernel path's logits "
                                 f"differ from the plain version's by up to "
                                 f"{err.max().item():.3e} ({int(bad.sum())} beyond 1e-4)")
        worst = max(worst, err.max().item())
        last = (args[1].long() - 1).clamp_min(0)
        picks = got[torch.arange(2, device=device), last].argmax(-1)
        start = start + n_tokens
        tokens = picks.cpu().numpy().astype(np.int32)[:, None]
        n_tokens = np.ones(2, np.int32)
    return worst, tuple(b - a for a, b in zip(counts0, paged_counts()))


def phase_slice_families(seed=6, device="cuda", configs=None):
    """[slice-families]: each served family and BLOOM in fp32 at its serve's
    width and 2 layers, on the card alone: check 1
    (:func:`slice_family_paged`), with the prefill chunk on the CUDA-core
    route and the decode steps on split-K in each layer; check 2, the fast
    path with CUDA graphs against the eager reference loop, token for token,
    over 4 prompts; for BLOOM, check 3 (:func:`slice_bloom_v1`), its v1
    cached forward on the card against the CPU."""
    import torch
    kw = dict(num_blocks=64, block_size=16, max_blocks_per_seq=8, token_budget=64,
              max_seqs_per_step=4)
    fp32 = {"dtype": "float32"}
    for key in SLICE_FAMILIES:
        t0 = time.perf_counter()
        module, cfg = (configs or {}).get(key) or family_config(key, layers=2)
        params = family_params(module, cfg, seed, torch.float32, device)
        worst, launches = slice_family_paged(key, module, cfg, params, device)
        on_card = torch.device(device).type == "cuda"
        if on_card and launches != (3 * cfg.num_layers, 0, 2 * cfg.num_layers):
            raise AssertionError(f"[slice-families] {key}: paged (launches, tensor-core, decode) "
                                 f"{launches}, expected a CUDA-core prefill and two split-K "
                                 f"decode steps x {cfg.num_layers} layers")
        graphs = family_engine(key, module, cfg, params, config=fp32, device=device, **kw)
        eager = family_engine(key, module, cfg, params, device=device, **kw,
                              config={**fp32, "serving_fastpath": {"enabled": False}})
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in (5, 40, 17, 90)]
        got = graphs.generate(prompts, max_new_tokens=8)
        ref = eager.generate(prompts, max_new_tokens=8)
        if got != ref or graphs.programs.graphs != on_card:
            raise AssertionError(f"[slice-families] {key}: graphs ({graphs.programs.graphs}) vs "
                                 f"eager tokens differ at "
                                 f"{[_first_diff(a, b) for a, b in zip(got, ref)]}")
        log(f"[slice-families] {key} at its serve's width, {cfg.num_layers} layers, fp32, on "
            f"{device}: forward_paged through the kernel vs the plain paged version, prefill + "
            f"2 decode steps, max logit abs err {worst:.3e} (atol=rtol=1e-4), paged launches "
            f"(total, tensor-core, decode) {launches}; fast path with {graphs.ledger.total} "
            f"captures == eager reference loop, token for token, over {len(prompts)} prompts"
            f"{slice_bloom_v1(cfg, params, device) if key == 'bloom' else ''}; "
            f"{time.perf_counter() - t0:.1f} s")
        del graphs, eager, params
        if on_card:
            torch.cuda.empty_cache()


def slice_bloom_v1(cfg, params, device, seed=7):
    """Check 3 of [slice-families] for BLOOM: ``forward_with_cache`` over a
    prefill of 2 x 16 tokens and 3 greedy decode steps on ``device`` against
    the same on a CPU copy of the weights, each with its own cache: logits
    within atol = rtol = 1e-4, the greedy picks equal, no kernel launched
    (the v1 path's biased attention is plain torch).  Returns a note for the
    phase's line."""
    import torch
    from deepspeed_tpu_torch.models import bloom
    from deepspeed_tpu_torch.runtime.tree import tree_map
    params_cpu = tree_map(lambda t: t.cpu(), params)
    cache, cache_cpu = (bloom.init_cache(cfg, 2, 32, dtype=torch.float32, device=dev)
                        for dev in (device, "cpu"))
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 16))
    before, worst, picks = launch_counts(), 0.0, []
    for step in range(4):
        x = torch.from_numpy(ids if step == 0 else picks[-1][:, None])
        got, cache = bloom.forward_with_cache(cfg, params, x.to(device), cache)
        ref, cache_cpu = bloom.forward_with_cache(cfg, params_cpu, x, cache_cpu)
        worst = max(worst, _max_err(f"[slice-families] bloom v1 step {step}", got.cpu(), ref,
                                    1e-4, 1e-4))
        pick, pick_cpu = got[:, -1].argmax(-1).cpu().numpy(), ref[:, -1].argmax(-1).numpy()
        if not np.array_equal(pick, pick_cpu):
            raise AssertionError(f"[slice-families] bloom v1 step {step}: greedy picks "
                                 f"{pick} on {device}, {pick_cpu} on the CPU")
        picks.append(pick)
    if launch_counts() != before:
        raise AssertionError(f"[slice-families] bloom v1: launched {launch_counts()} (before "
                             f"{before}); the v1 path runs no kernel")
    return (f"; v1 forward_with_cache (prefill 2 x 16, 3 decode steps) on {device} vs the CPU: "
            f"max logit abs err {worst:.3e} (atol=rtol=1e-4), greedy picks "
            f"{np.stack(picks, 1).tolist()} equal, no kernel launched")


TRAIN_PEAK_FLOPS = 989e12  # bf16 dense tensor-core peak of the H100 SXM
KERNEL_NAMES = ("paged_attention", "flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq", "fused_adamw",
                "sparse_fwd", "sparse_bwd_dkdv", "sparse_bwd_dq", "adamw8bit", "fused_lion",
                "quantize_int8")
# the kernels whose bf16 launches in a training step must all be tensor-core ones
TC_TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq", "sparse_fwd",
                    "sparse_bwd_dkdv", "sparse_bwd_dq")


def train_config(*, micro, gas, bf16, seed, lr=3e-4, optimizer="fused_adam", sparse=None):
    conf = {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas,
            "gradient_clipping": 1.0, "bf16": {"enabled": bf16}, "steps_per_print": 1000,
            "seed": seed,
            "optimizer": {"type": optimizer, "params": {"lr": lr, "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_min_lr": 0.0, "warmup_max_lr": lr,
                                     "warmup_num_steps": 10, "warmup_type": "linear"}}}
    if sparse is not None:
        conf["sparse_attention"] = dict(sparse)
    return conf


def _kernel_wrappers():
    """Every kernel wrapper of the port by name; each counts its launches."""
    from deepspeed_tpu_torch.ops.adam.adam8bit import fused_adamw8bit_flat
    from deepspeed_tpu_torch.ops.adam.fused_adam import fused_adamw_flat, fused_lion_flat
    from deepspeed_tpu_torch.ops.attention import flash
    from deepspeed_tpu_torch.ops.attention.paged import paged_attention
    from deepspeed_tpu_torch.ops.quantizer.quantize import quantize_int8
    from deepspeed_tpu_torch.ops.sparse_attention import attention as sp
    return dict(zip(KERNEL_NAMES, (paged_attention, flash.flash_fwd, flash.flash_bwd_dkdv,
                                   flash.flash_bwd_dq, fused_adamw_flat, sp.sparse_fwd,
                                   sp.sparse_bwd_dkdv, sp.sparse_bwd_dq, fused_adamw8bit_flat,
                                   fused_lion_flat, quantize_int8)))


def launch_counts():
    return {name: fn.launches for name, fn in _kernel_wrappers().items()}


def reset_launch_counts():
    for fn in _kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "tc_launches"):
            fn.tc_launches = 0
        if hasattr(fn, "decode_launches"):
            fn.decode_launches = 0


REMAT_DEFAULT = "dots_with_no_batch_dims_saveable"  # LlamaConfig's, as JAX's


def expected_launches(*, steps, gas, layers, n_leaves, optimizer, sparse,
                      policy=REMAT_DEFAULT):
    """Each kernel's launches over ``steps`` train steps: the attention forward
    twice a layer and micro-batch (forward and the remat recompute: the
    kernels run through ctypes, where no remat policy can keep their
    outputs) but once under ``everything_saveable``, each backward kernel
    once, the optimizer kernel once a leaf and step."""
    attn = "sparse" if sparse is not None else "flash"
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    counts.update({f"{attn}_fwd": steps * gas * layers * (1 if policy == "everything_saveable"
                                                          else 2),
                   f"{attn}_bwd_dkdv": steps * gas * layers,
                   f"{attn}_bwd_dq": steps * gas * layers,
                   "adamw8bit" if optimizer == "fused_adam8bit" else "fused_adamw": steps * n_leaves})
    return counts


def phase_train(card, seed=0, layers=TRAIN_LAYERS, steps=6, micro=2, gas=2, seq=2048,
                tag="train", optimizer="fused_adam", sparse=None, baseline=None, after_step=None):
    """Llama-2-7B width, cut to ``layers`` layers, trained in bf16 for
    ``steps`` optimizer steps on one seeded batch through ``initialize`` and
    ``train_batch``, with ``optimizer`` and, where given, the ``sparse``
    attention section; ``baseline`` is an earlier run's summary to print
    beside this one's; ``after_step(engine, step)``, where given, is called
    after each step (1-based).  Returns (launch counts over the steps,
    summary)."""
    import torch
    from deepspeed_tpu_torch.runtime.tree import tree_leaves
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), num_layers=layers, remat=True)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                               dtype=torch.float32, device="cuda")
    n_leaves = len(tree_leaves(params))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        loss_fn=llama.make_loss_fn(cfg), model_parameters=params,
        config=train_config(micro=micro, gas=gas, bf16=True, seed=seed, optimizer=optimizer,
                            sparse=sparse))
    del params
    torch.cuda.empty_cache()
    n_params = llama.num_params(cfg)
    rng = np.random.default_rng(seed)
    batch = llama.causal_lm_batch(rng.integers(0, cfg.vocab_size, (micro * gas, seq)))
    tokens = micro * gas * seq
    head_dim = cfg.hidden_size // cfg.num_heads
    if sparse is None:
        step_flops = llama.flops_per_token(cfg, seq) * tokens
        work = "flops_per_token"
    else:
        from deepspeed_tpu_torch.ops.sparse_attention.attention import live_pairs
        lay, block = sparse_layout(cfg.num_heads, seq, **sparse)
        pairs = live_pairs(lay, block, seq, True, cfg.num_heads)  # one row, all heads
        # forward 4 D, remat recompute 4 D, dK/dV 8 D, dQ 6 D a live pair
        attn_flops = (4 + 4 + 8 + 6) * head_dim * pairs * micro * gas * layers
        step_flops = 6.0 * n_params * tokens + attn_flops
        work = (f"6 N a token + {attn_flops / 1e12:.2f} TFLOP of live-block attention "
                f"(forward, recompute, backward; {pairs} live pairs a sequence), not "
                f"flops_per_token's dense attention term")
    log(f"[{tag}] llama2_7b width x {layers} layers: {n_params / 1e9:.3f} B params, set up in "
        f"{time.perf_counter() - t0:.2f} s; bf16, remat ({cfg.remat_policy}), {optimizer}, "
        f"WarmupLR, clip 1.0, "
        f"{'sparse_attention ' + json.dumps(sparse) + ', ' if sparse else ''}micro {micro} x "
        f"gas {gas} x seq {seq} = {tokens} tokens a step, {step_flops / 1e12:.1f} TFLOP a step "
        f"({work})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times, norms = [], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        metrics = engine.train_batch(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics.loss))
        norms.append(float(metrics.grad_norm))
        if after_step is not None:
            after_step(engine, i + 1)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = expected_launches(steps=steps, gas=gas, layers=layers, n_leaves=n_leaves,
                                 optimizer=optimizer, sparse=sparse)
    if launches != expected:
        raise AssertionError(f"[{tag}] launch counts {launches} != step formula {expected}")
    wrappers = _kernel_wrappers()
    tc = {name: wrappers[name].tc_launches for name in TC_TRAIN_KERNELS}
    if any(tc[name] != launches[name] for name in tc):
        raise AssertionError(f"[{tag}] not every bf16 flash and sparse forward, dK/dV and dQ "
                             f"launch was a tensor-core one: {tc} of {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] losses not finite and falling: {losses}")
    step_s = statistics.mean(times[1:])
    summary = {"step_ms": step_s * 1e3, "tokens_s": tokens / step_s,
               "mfu": step_flops / step_s / TRAIN_PEAK_FLOPS, "peak_gb": peak_gb,
               "tc_launches": tc, "loss1": losses[0], "norm1": norms[0], "losses": losses,
               "times": times}
    beside = ""
    if baseline is not None:
        beside = (f" ([train]: {baseline['step_ms']:.1f} ms, {baseline['tokens_s']:.1f} "
                  f"tokens/s, mfu {baseline['mfu']:.4f}, peak {baseline['peak_gb']:.2f} GB)")
    log(f"[{tag}] {steps} steps on {card}: losses {[round(x, 4) for x in losses]}; step ms "
        f"{[round(t * 1e3, 1) for t in times]} (first includes warm-up); steps 2-{steps}: "
        f"{summary['step_ms']:.1f} ms a step, {summary['tokens_s']:.1f} tokens/s, mfu "
        f"{summary['mfu']:.4f} (of {TRAIN_PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16), peak memory "
        f"{peak_gb:.2f} GB{beside}; launches "
        f"{ {k: v for k, v in launches.items() if v} } = step formula, every other kernel 0; "
        f"tensor-core launches { {k: v for k, v in tc.items() if v} }")
    profile_train(engine, batch, card, step_s, tag=f"profile-{tag}")
    del engine
    torch.cuda.empty_cache()
    return launches, summary


def train_step_products(cfg, micro, gas, seq, attention=True):
    """The FLOPs the profiler's count (``FlopCounterMode``) must hold for one
    [train] step on the card, from the shapes: per micro-batch and layer,
    each weight product forward and twice in the backward (grads of input
    and weight); under ``nothing_saveable`` again in the remat recompute but
    ``w_down`` (non-reentrant checkpointing stops the recompute at the last
    activation the backward saves), under the default
    ``dots_with_no_batch_dims_saveable`` not at all (the products are kept);
    the lm_head forward and twice backward; the embedding a gather.  With
    ``attention``, what each flash launch adds for its plain version:
    ``4 B H S^2 Dh`` a forward (run twice, forward and remat recompute, but
    under ``everything_saveable``), 8 for dK/dV, 6 for dQ; without it, the
    products alone (the count before the kernels were counted)."""
    D, F, L, V = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.vocab_size
    H, KV = cfg.num_heads, cfg.num_kv_heads
    Dh = D // H
    tokens = micro * seq
    layer = 2 * tokens * (D * H * Dh + 2 * D * KV * Dh + H * Dh * D + 3 * D * F)
    w_down = 2 * tokens * F * D
    head = 2 * tokens * D * V
    recompute = layer - w_down if cfg.remat_policy in (None, "nothing_saveable") else 0
    forwards = 1 if cfg.remat_policy == "everything_saveable" or not cfg.remat else 2
    attn = (4 * forwards + 8 + 6) * micro * H * seq * seq * Dh if attention else 0
    return gas * (L * (3 * layer + recompute + attn) + 3 * head)


def phase_train_telemetry(card, baseline, seed=0, layers=TRAIN_LAYERS, steps=6, micro=2, gas=2,
                          seq=2048):
    """[train-telemetry]: a fresh engine on [train]'s config (Llama-2-7B
    width, ``layers`` layers, bf16, remat, ``fused_adam``, micro x gas x
    seq) with ``telemetry`` (JSONL under chiprun_out/, a step window
    [2, 3)) and ``ops_server`` on, ``steps`` steps.  Gates: one
    ``train_step`` record a step with the JAX keys; ``mfu`` not null with
    the peak detected from the device's name; ``flops_per_step`` within 1 %
    of :func:`train_step_products`; ``hbm.peak_bytes_in_use`` within 5 % of
    ``torch.cuda.max_memory_allocated()``; a trace file in ``profile_dir``;
    a /metrics scrape with ``dstpu_train_steps_total`` equal to ``steps``.
    Prints the step times beside [train]'s (``baseline``): the one sync a
    step that telemetry adds is the cost to see."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.monitor.exposition import parse_exposition
    from deepspeed_tpu_torch.monitor.ops_server import scrape
    from deepspeed_tpu_torch.monitor.telemetry import detect_peak_flops_per_chip
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), num_layers=layers, remat=True)
    out = os.path.join(OUT_DIR, "train_telemetry")
    shutil.rmtree(out, ignore_errors=True)
    conf = train_config(micro=micro, gas=gas, bf16=True, seed=seed)
    conf["telemetry"] = {"jsonl_path": os.path.join(out, "telemetry.jsonl"),
                         "profile_step_start": 2, "profile_step_stop": 3,
                         "profile_dir": os.path.join(out, "traces")}
    conf["ops_server"] = {"enabled": True, "refresh_interval_s": 0.0}
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                               dtype=torch.float32, device="cuda")
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        loss_fn=llama.make_loss_fn(cfg), model_parameters=params, config=conf)
    del params
    torch.cuda.empty_cache()
    batch = llama.causal_lm_batch(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (micro * gas, seq)))
    # the window's trace is written when the window closes, at the start of
    # the step after it: time that export on its own and note its step
    exports = []
    stop_trace = engine.telemetry.stop_trace

    def timed_stop_trace():
        t0 = time.perf_counter()
        path = stop_trace()
        exports.append((len(times) + 1, time.perf_counter() - t0))
        return path

    engine.telemetry.stop_trace = timed_stop_trace
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    try:
        for _ in range(steps):
            t0 = time.perf_counter()
            engine.train_batch(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        fams = parse_exposition(scrape(engine.ops.url("/metrics")))
    finally:
        engine.close_ops()
        engine.telemetry.close()
    with open(conf["telemetry"]["jsonl_path"]) as fh:
        records = [json.loads(line) for line in fh]
    keys = ("loss", "step_time_ms", "samples_per_sec", "tokens_per_sec", "flops_per_step",
            "tflops_per_sec", "mfu", "hbm")
    want = train_step_products(cfg, micro, gas, seq)
    products = train_step_products(cfg, micro, gas, seq, attention=False)
    tel = engine.telemetry
    flops = records[0]["flops_per_step"] if records else None
    last = records[-1] if records else {}
    traces = tel.traces_written
    steps_total = fams.get("dstpu_train_steps_total", {"samples": [(None, None, None)]})
    if (len(records) != steps or {r["kind"] for r in records} != {"train_step"}
            or any(k not in r for r in records for k in keys)
            or any(r["mfu"] is None for r in records)
            or not tel.peak_flops_per_chip == detect_peak_flops_per_chip() == TRAIN_PEAK_FLOPS
            or flops is None or abs(flops - want) > 0.01 * want
            or abs(last["hbm"]["peak_bytes_in_use"] - peak) > 0.05 * peak
            or len(traces) != 1 or not os.path.getsize(traces[0])
            or steps_total["samples"][0][2] != steps):
        raise AssertionError(
            f"[train-telemetry] {len(records)} records (kinds {[r['kind'] for r in records]}), "
            f"mfu {[r.get('mfu') for r in records]}, peak {tel.peak_flops_per_chip}, flops "
            f"{flops} vs predicted {want}, hbm peak {last.get('hbm')} vs {peak}, traces "
            f"{traces}, steps_total {steps_total['samples']}")
    step_s = statistics.mean(times[1:])
    log(f"[train-telemetry] llama2_7b width x {layers} layers, bf16, remat, fused_adam, "
        f"{micro} x {gas} x {seq} tokens, telemetry + step window [2, 3) + ops endpoint, "
        f"{steps} steps on {card}: {len(records)} train_step records, losses "
        f"{[round(r['loss'], 4) for r in records]}; flops_per_step {flops:.6e} counted by "
        f"FlopCounterMode on step 1, the flash launches' plain FLOPs included, = predicted "
        f"{want:.6e} ({(flops - want) / want:+.2e}; products alone {products:.6e}, mfu under "
        f"that count {[round(r['mfu'] * products / flops, 4) for r in records]}; "
        f"phase_train's analytic step_flops {llama.flops_per_token(cfg, seq) * micro * gas * seq:.6e} "
        f"counts model FLOPs with attention and without remat); mfu "
        f"{[round(r['mfu'], 4) for r in records]} (peak {tel.peak_flops_per_chip / 1e12:.0f} "
        f"TFLOP/s from the device name); hbm peak_bytes_in_use {last['hbm']['peak_bytes_in_use']} "
        f"vs max_memory_allocated {peak} ({(last['hbm']['peak_bytes_in_use'] - peak) / peak:+.2%}); "
        f"trace {os.path.relpath(traces[0])} {os.path.getsize(traces[0]) / 2**20:.2f} MiB; "
        f"/metrics dstpu_train_steps_total {steps_total['samples'][0][2]:.0f}")
    # step 1 counts FLOPs, the window [2, 3) profiles step 3, and the step
    # that closes the window writes the trace: the steps outside all three
    export_step, export_s = exports[0] if exports else (None, 0.0)
    plain = [t for i, t in enumerate(times, start=1) if i not in (1, 3, export_step)]
    plain_s = statistics.mean(plain) if plain else float("nan")
    log(f"[train-telemetry] step ms {[round(t * 1e3, 1) for t in times]} (step 1 counts FLOPs, "
        f"step 3 is profiled, step {export_step} writes the trace); steps 2-{steps}: "
        f"{step_s * 1e3:.1f} ms a step against [train]'s {baseline['step_ms']:.1f} ms "
        f"({step_s * 1e3 / baseline['step_ms'] - 1:+.2%}); the {len(plain)} steps neither "
        f"profiled nor writing the trace: {plain_s * 1e3:.1f} ms a step "
        f"({plain_s * 1e3 / baseline['step_ms'] - 1:+.2%} against [train]); the trace export "
        f"alone {export_s * 1e3:.1f} ms, inside step {export_step}'s "
        f"{times[export_step - 1] * 1e3 if export_step else float('nan'):.1f} ms; record step "
        f"times {[round(r['step_time_ms'], 1) for r in records]} ms (a record's span leaves the "
        f"export out)")
    del engine
    torch.cuda.empty_cache()


REMAT_POLICIES = ("nothing_saveable", "dots_saveable", "offload_inputs")
# the backward's recomputed x @ W products a layer (w_down's is not rerun under
# nothing_saveable: the recompute stops at the last activation the backward
# needs; offload_inputs reruns the whole layer)
REMAT_RECOMPUTED = {"nothing_saveable": 6, "dots_saveable": 0, "offload_inputs": 7,
                    REMAT_DEFAULT: 0}


def micro_batch_probe(engine, batch):
    """One micro-batch's forward and backward at the engine's params, the
    peak counter reset just before the forward.  Returns a dict, bytes above
    the allocation before the forward: ``fwd_peak`` (the forward's peak),
    ``held`` (what the forward leaves for the backward), ``peak`` (forward
    and backward); ``parked`` (pinned host bytes after the forward) and
    ``products`` (``aten.mm``/``addmm`` run in the backward)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from deepspeed_tpu_torch.runtime.activation_checkpointing import offload_checkpoint
    from deepspeed_tpu_torch.runtime.tree import tree_map

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    on_card = engine.device.type == "cuda"
    micro = tree_map(lambda x: x[0], engine._gas_layout(batch))
    params = engine._compute_params()
    _sync(engine.device)
    offload_checkpoint.host_bytes = offload_checkpoint.peak_host_bytes = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if on_card else 0
    loss = engine.loss_fn(params, micro, engine.generator)
    parked = offload_checkpoint.host_bytes
    _sync(engine.device)
    fwd_peak = torch.cuda.max_memory_allocated() - base if on_card else 0
    held = torch.cuda.memory_allocated() - base if on_card else 0
    with Products() as seen:
        loss.backward()
    _sync(engine.device)
    peak = torch.cuda.max_memory_allocated() - base if on_card else 0
    if offload_checkpoint.host_bytes:
        raise AssertionError(f"{offload_checkpoint.host_bytes} pinned bytes still parked after "
                             f"the backward")
    del params, loss
    return {"fwd_peak": fwd_peak, "held": held, "peak": peak, "parked": parked,
            "products": seen.n}


def phase_train_remat(card, baseline, seed=0, layers=TRAIN_LAYERS, steps=3, micro=2, gas=2,
                      seq=2048, device="cuda", width=None):
    """[train-remat]: [train]'s model, config, params and batch under each of
    ``REMAT_POLICIES`` ([train] itself is the default policy's run), one
    engine at a time, ``steps`` steps each.  Gates: the step-1 loss and grad
    norm equal [train]'s (``baseline``) bit for bit; launches equal the
    policy's formula; one micro-batch's backward reruns the policy's
    products; under ``offload_inputs`` the forward parks layers x micro x
    seq x hidden x 2 bytes in pinned host memory, and leaves exactly that
    much less on the card for the backward than ``nothing_saveable``, with
    a forward peak at least half of it lower.  (The micro-batch's peak over
    forward and backward comes at the backward's end, where the weight
    grads are stacked and no layer input is held any more: there offload
    saves nothing, and it is printed beside the others.)  Returns
    the launch counts by policy.  ``device="cpu"`` with ``width`` (a tiny
    LlamaConfig) and a ``baseline`` from ``phase_train`` at that config
    rehearses it on the CPU (nothing is parked there, peaks are not read)."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.runtime.tree import tree_leaves
    rng = np.random.default_rng(seed)
    batch = None
    out, launches_by_policy = {}, {}
    on_card = device == "cuda"
    for policy in REMAT_POLICIES:
        cfg = dataclasses.replace(width or llama.LlamaConfig.llama2_7b(), num_layers=layers,
                                  remat=True, remat_policy=policy)
        if batch is None:
            batch = llama.causal_lm_batch(rng.integers(0, cfg.vocab_size, (micro * gas, seq)))
        params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                                   dtype=torch.float32, device=device)
        n_leaves = len(tree_leaves(params))
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            loss_fn=llama.make_loss_fn(cfg), model_parameters=params,
            config=train_config(micro=micro, gas=gas, bf16=True, seed=seed), device=device)
        del params
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times, first = [], None
        for _ in range(steps):
            t0 = time.perf_counter()
            metrics = engine.train_batch(batch)
            _sync(device)
            times.append(time.perf_counter() - t0)
            if first is None:
                first = (float(metrics.loss), float(metrics.grad_norm))
        launches = launch_counts() if on_card else expected_launches(
            steps=steps, gas=gas, layers=layers, n_leaves=n_leaves, optimizer="fused_adam",
            sparse=None, policy=policy)  # the CPU launches no kernel
        step_peak = torch.cuda.max_memory_allocated() if on_card else 0
        expected = expected_launches(steps=steps, gas=gas, layers=layers, n_leaves=n_leaves,
                                     optimizer="fused_adam", sparse=None, policy=policy)
        if launches != expected:
            raise AssertionError(f"[train-remat] {policy}: launches {launches} != formula "
                                 f"{expected}")
        if first != (baseline["loss1"], baseline["norm1"]):
            raise AssertionError(f"[train-remat] {policy}: step-1 loss and grad norm {first} != "
                                 f"[train]'s {(baseline['loss1'], baseline['norm1'])}")
        probe = micro_batch_probe(engine, batch)
        parked = probe["parked"]
        recomputed = probe["products"] - 2 * (7 * layers + 1)  # the backward's own: 2 a product
        want_parked = layers * micro * seq * cfg.hidden_size * 2 \
            if policy == "offload_inputs" and on_card else 0
        if parked != want_parked or recomputed != REMAT_RECOMPUTED[policy] * layers:
            raise AssertionError(f"[train-remat] {policy}: {parked} pinned bytes parked (want "
                                 f"{want_parked}), {recomputed} products recomputed (want "
                                 f"{REMAT_RECOMPUTED[policy] * layers})")
        out[policy] = {"step_ms": statistics.mean(times[1:]) * 1e3, "step_peak": step_peak,
                       **probe, "recomputed": recomputed}
        launches_by_policy[policy] = launches
        del engine
        if on_card:
            torch.cuda.empty_cache()
    off, full = out["offload_inputs"], out["nothing_saveable"]
    held_drop, fwd_drop = full["held"] - off["held"], full["fwd_peak"] - off["fwd_peak"]
    if on_card and (held_drop != off["parked"] or fwd_drop < off["parked"] // 2):
        raise AssertionError(f"[train-remat] offload_inputs leaves {held_drop} bytes less on the "
                             f"card after the forward than nothing_saveable (want the "
                             f"{off['parked']} parked) and peaks {fwd_drop} bytes lower in the "
                             f"forward (want at least {off['parked'] // 2})")
    rows = "; ".join(
        f"{p}: {r['step_ms']:.1f} ms a step, step peak {r['step_peak'] / 1e9:.2f} GB; a "
        f"micro-batch (above its start): forward peak {r['fwd_peak'] / 1e6:.1f} MB, held for the "
        f"backward {r['held'] / 1e6:.1f} MB, forward + backward peak {r['peak'] / 1e6:.1f} MB; "
        f"{r['recomputed']} products recomputed, {r['parked']} bytes parked"
        for p, r in out.items())
    log(f"[train-remat] llama2_7b width x {layers} layers, bf16, fused_adam, {micro} x {gas} x "
        f"{seq}, {steps} steps a policy on {card}: {rows}; [{REMAT_DEFAULT}] ([train]): "
        f"{baseline['step_ms']:.1f} ms, peak {baseline['peak_gb']:.2f} GB; step-1 loss "
        f"{baseline['loss1']!r} and grad norm {baseline['norm1']!r} equal under every policy; "
        f"offload_inputs against nothing_saveable: {held_drop} bytes less held after the forward "
        f"(= the bytes parked), forward peak {fwd_drop / 1e6:.1f} MB lower, forward + backward "
        f"peak {(full['peak'] - off['peak']) / 1e6:+.1f} MB lower")
    return launches_by_policy


DATA_LAYERS = 4  # two middle layers for random-LTD
DATA_DOCS, DATA_SEQ, DATA_TOKENS = 64, 2048, 4096  # documents drawn from 4096 token ids
DATA_STEPS = 8
DATA_CURRICULUM = {"schedule_type": "fixed_linear", "min_difficulty": 1024,
                   "max_difficulty": 2048,
                   "schedule_config": {"total_curriculum_step": 6, "difficulty_step": 256}}
DATA_LTD = {"random_ltd_schedule": {"min_value": 512, "max_value": 1536,
                                    "schedule_config": {"seq_per_step": 256,
                                                        "require_steps": 6}}}


class TokenDocs:
    """Documents of an ``MMapIndexedDataset`` as {input_ids, labels} rows."""

    def __init__(self, data):
        self.data = data

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        from deepspeed_tpu_torch.models import llama
        row = llama.causal_lm_batch(np.asarray(self.data[i], np.int64)[None])
        return {k: v[0] for k, v in row.items()}


def ramp(lo, hi, step, total, quantum):
    """The curriculum's and random-LTD's linear schedule, from its formula."""
    value = int((lo + min(1.0, step / total) * (hi - lo)) // quantum * quantum)
    return max(lo, min(hi, value))


def phase_train_data(card, seed=0, layers=DATA_LAYERS, micro=2, gas=2, device="cuda",
                     width=None):
    """[train-data]: 64 seeded documents of 2,048 tokens written with
    ``MMapIndexedDatasetBuilder`` and read back through
    ``MMapIndexedDataset``, trained through ``initialize(training_data=,
    config=)`` at Llama-2-7B width and ``layers`` layers in bf16 with
    ``data_efficiency`` (a seqlen curriculum 1024 -> 2048 over 6 steps,
    random-LTD keeping 512 -> 1536 tokens over 6 steps), the watchdog and
    the heartbeat, ``DATA_STEPS`` steps.  Gates: finite falling losses; each
    step's length and kept tokens are the schedules'; launches equal the
    formula; the loader's state after step 3 gives a fresh loader batch 4;
    the heartbeat carries the last step; one fp32 forward and backward with
    one fixed index set, flash kernels against the plain attention on the
    card (rtol 1e-4); ``Eigenvalue`` on a small CUDA MLP equal to the CPU's
    (1e-3) and refused on a flash-backed loss.  Returns the launch counts.
    ``device="cpu"`` with ``width`` (a tiny LlamaConfig) rehearses it on the
    CPU, where no kernel launches and flash's plain version runs."""
    import tempfile
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama, transformer
    from deepspeed_tpu_torch.ops.attention.flash import flash_attention
    from deepspeed_tpu_torch.runtime import eigenvalue
    from deepspeed_tpu_torch.runtime.data_pipeline import (MMapIndexedDataset,
                                                           MMapIndexedDatasetBuilder, random_ltd)
    from deepspeed_tpu_torch.runtime.dataloader import CurriculumDataLoader
    from deepspeed_tpu_torch.runtime.heartbeat import read_heartbeats
    from deepspeed_tpu_torch.runtime.tree import tree_leaves, tree_map
    root = tempfile.mkdtemp(prefix="train_data_")
    try:
        t0 = time.perf_counter()
        builder = MMapIndexedDatasetBuilder(os.path.join(root, "docs"), dtype=np.uint16)
        docs = np.random.default_rng(seed).integers(0, DATA_TOKENS, (DATA_DOCS, DATA_SEQ))
        for doc in docs:
            builder.add_item(doc)
            builder.end_document()
        builder.finalize()
        data = MMapIndexedDataset(os.path.join(root, "docs"))
        if len(data) != DATA_DOCS or not np.array_equal(data[DATA_DOCS - 1], docs[-1]):
            raise AssertionError("[train-data] the indexed dataset does not read back")
        dataset = TokenDocs(data)
        on_card = device == "cuda"
        cfg = dataclasses.replace(width or llama.LlamaConfig.llama2_7b(), num_layers=layers,
                                  remat=True)
        conf = train_config(micro=micro, gas=gas, bf16=True, seed=seed)
        conf.update({"max_consecutive_skips": 3,
                     "fault_tolerance": {"heartbeat": True, "heartbeat_interval_s": 0.0,
                                         "heartbeat_dir": os.path.join(root, "hb")},
                     "data_efficiency": {"enabled": True, "seed": seed, "data_sampling": {
                         "curriculum_learning": {"enabled": True, "curriculum_metrics": {
                             "seqlen": DATA_CURRICULUM}}},
                         "data_routing": {"enabled": True, "random_ltd": DATA_LTD}}})
        params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                                   dtype=torch.float32, device=device)
        n_leaves = len(tree_leaves(params))
        engine, _, loader, _ = deepspeed_tpu_torch.initialize(
            loss_fn=llama.make_loss_fn(cfg), model_parameters=params, training_data=dataset,
            config=conf, device=device)
        del params
        if on_card:
            torch.cuda.empty_cache()
        if not isinstance(loader, CurriculumDataLoader):
            raise AssertionError(f"[train-data] initialize built a {type(loader).__name__}")
        setup_s = time.perf_counter() - t0
        losses, seqs, keeps, times, batches = [], [], [], [], []
        resume_state = None
        _sync(device)
        reset_launch_counts()
        it = iter(loader)
        for step in range(DATA_STEPS):
            batch = next(it)
            batches.append(batch)
            t0 = time.perf_counter()
            metrics = engine.train_batch(batch)
            losses.append(float(metrics.loss))
            times.append(time.perf_counter() - t0)
            seqs.append(batch["input_ids"].shape[1])
            keeps.append(engine._ltd_state["keep"])
            if step == 2:
                resume_state = json.loads(json.dumps(loader.state_dict()))
        expected = expected_launches(steps=DATA_STEPS, gas=gas, layers=layers, n_leaves=n_leaves,
                                     optimizer="fused_adam", sparse=None)
        launches = launch_counts() if on_card else expected  # the CPU launches no kernel
        engine.heartbeat.close()
        want_seqs = [ramp(1024, 2048, k, 6, 256) for k in range(1, DATA_STEPS + 1)]
        want_keeps = [ramp(512, 1536, s, 6, 256) for s in range(DATA_STEPS)]
        beat = read_heartbeats(os.path.join(root, "hb")).get(0, {})
        fresh = CurriculumDataLoader(dataset, batch_size=engine.train_batch_size,
                                     gradient_accumulation_steps=gas,
                                     curriculum=engine.config.effective_curriculum(), seed=seed)
        fresh.load_state_dict(resume_state)
        again = next(iter(fresh))
        if (not all(np.isfinite(losses)) or not losses[-1] < losses[0] or seqs != want_seqs
                or keeps != want_keeps or launches != expected or beat.get("step") != DATA_STEPS
                or not engine._ltd_state.get("engaged")
                or any(not np.array_equal(again[k], batches[3][k]) for k in again)):
            raise AssertionError(
                f"[train-data] losses {losses}, lengths {seqs} (want {want_seqs}), kept {keeps} "
                f"(want {want_keeps}), launches {launches} (formula {expected}), heartbeat "
                f"{beat}, LTD engaged {engine._ltd_state.get('engaged')}, resumed batch 4 "
                f"{'equal' if all(np.array_equal(again[k], batches[3][k]) for k in again) else 'differs'}")
        del engine
        if on_card:
            torch.cuda.empty_cache()
        log(f"[train-data] {DATA_DOCS} documents of {DATA_SEQ} tokens through "
            f"MMapIndexedDataset, initialize(training_data=) -> CurriculumDataLoader, llama2_7b "
            f"width x {layers} layers, bf16, fused_adam, watchdog 3, heartbeat; set up in "
            f"{setup_s:.2f} s; {DATA_STEPS} steps on {card}: losses "
            f"{[round(x, 4) for x in losses]}; lengths {seqs} and kept tokens {keeps} = the "
            f"schedules; step ms {[round(t * 1e3, 1) for t in times]}; launches "
            f"{ {k: v for k, v in launches.items() if v} } = formula; batch 4 from a fresh "
            f"loader resumed at step 3 equal; heartbeat step {beat.get('step')}")
        # one fp32 forward and backward at these shapes, one fixed index set:
        # flash kernels against the plain attention, both on the card
        keep = 1024
        fixed = torch.sort(torch.randperm(DATA_SEQ, generator=torch.Generator().manual_seed(
            seed))[:keep]).values.to(device)
        sampler = random_ltd.sample_token_indices
        random_ltd.sample_token_indices = lambda generator, seq_len, k: fixed
        try:
            cfg32 = dataclasses.replace(cfg, remat_policy=REMAT_DEFAULT)
            params = llama.init_params(cfg32, torch.Generator(device=device).manual_seed(seed + 1),
                                       dtype=torch.float32, device=device)
            row = {k: torch.from_numpy(np.stack([dataset[i][k] for i in range(micro)])).to(device)
                   for k in ("input_ids", "labels")}
            res = {}
            for name, fn in (("kernel", None), ("plain", transformer.sdpa)):
                p = tree_map(lambda t: t.detach().requires_grad_(True), params)
                loss_fn = transformer.scoped_random_ltd(llama.make_loss_fn(cfg32, attention_fn=fn),
                                                        {"keep": keep})
                loss = loss_fn(p, row, torch.Generator(device=device))
                res[name] = (float(loss.detach()), torch.autograd.grad(loss, tree_leaves(p)))
                del p, loss
        finally:
            random_ltd.sample_token_indices = sampler
        losses32 = (res["kernel"][0], res["plain"][0])
        if not abs(losses32[0] - losses32[1]) <= 1e-4 * abs(losses32[1]):
            raise AssertionError(f"[train-data] fp32 losses {losses32} (kernel, plain; rtol "
                                 f"1e-4)")
        worst = 0.0
        for i, (g, r) in enumerate(zip(res["kernel"][1], res["plain"][1])):
            top = r.abs().max().item()
            worst = max(worst, _max_err(f"[train-data] fp32 grad of leaf {i}", g, r,
                                        1e-4 * top, 1e-4) / (top or 1.0))
        del res, params
        if on_card:
            torch.cuda.empty_cache()
        # the Hessian eigenvalue: double backward on plain math, refused by flash
        gen = np.random.default_rng(seed)
        mlp = {"w1": gen.normal(size=(64, 128)).astype(np.float32) / 8,
               "w2": gen.normal(size=(128, 1)).astype(np.float32) / 11}
        xy = {"x": gen.normal(size=(256, 64)).astype(np.float32),
              "y": gen.normal(size=(256, 1)).astype(np.float32)}

        def mlp_loss(p, b, r):
            return ((torch.tanh(b["x"] @ p["w1"]) @ p["w2"] - b["y"]) ** 2).mean()

        eig = {}
        for dev in (device, "cpu"):
            to = lambda tree: {k: torch.from_numpy(v).to(dev) for k, v in tree.items()}
            eig[dev] = eigenvalue.Eigenvalue(max_iter=300, tol=1e-7).compute_eigenvalue(
                mlp_loss, to(mlp), to(xy))["eigenvalue"]
        if not abs(eig[device] - eig["cpu"]) <= 1e-3 * abs(eig["cpu"]):
            raise AssertionError(f"[train-data] Hessian eigenvalue {eig[device]} on the card vs "
                                 f"{eig['cpu']} on the CPU (rtol 1e-3)")
        q = torch.randn(1, 256, 2, 128, device=device)
        try:
            eigenvalue.Eigenvalue(max_iter=2).compute_eigenvalue(
                lambda p, b, r: flash_attention(p["q"], p["q"], p["q"]).sum(), {"q": q}, None)
            raise AssertionError("[train-data] a second derivative through flash did not raise")
        except RuntimeError as exc:
            if "differentiable once" not in str(exc):
                raise
        log(f"[train-data] fp32 forward and backward at {micro} x {DATA_SEQ}, keep {keep} of "
            f"one fixed index set: flash kernels vs plain attention on the card, losses "
            f"{losses32[0]!r} vs {losses32[1]!r}, grads at most {worst:.3e} of their leaf's "
            f"largest (rtol 1e-4, atol 1e-4 x max|leaf|); Hessian eigenvalue of a 64-128-1 MLP "
            f"{eig[device]!r} on the card vs {eig['cpu']!r} on the CPU (rtol 1e-3); a second "
            f"derivative through flash refused")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


PROFILE_GROUPS = (("flash_fwd", "flash_fwd"), ("flash_bwd_dkdv", "flash_bwd_dkdv"),
                  ("flash_bwd_dq", "flash_bwd_dq"),
                  ("sparse_fwd", "sparse_fwd"), ("sparse_bwd_dkdv", "sparse_bwd_dkdv"),
                  ("sparse_bwd_dq", "sparse_bwd_dq"),
                  ("adamw8", "adamw8bit_kernel"), ("adamw", "adamw_kernel"))


def profile_train(engine, batch, card, step_s, tag="profile-train"):
    """One more step under torch.profiler: device time by kernel group (flash
    and sparse forward and backward, AdamW, AdamW-8bit), matrix products and
    the rest, against the unprofiled mean step."""
    profile_device(lambda: engine.train_batch(batch), card, tag, "step", step_s * 1e3,
                   PROFILE_GROUPS)


# [train-dense]: optimizer steps, micro-batch x gas, and by family the lr
# that WarmupLR reaches after its 10 warm-up steps: 1e-3 for the small
# models, [train]'s 3e-4 for the billions (at 1e-3 Phi-2's and GPT-J's
# fifth loss rose above the fourth)
DENSE_STEPS, DENSE_MICRO, DENSE_GAS = 5, 4, 2
DENSE_LR = {"gpt2": 1e-3, "bert": 1e-3, "phi": 3e-4, "gptj": 3e-4}
# GPT-J-6B trains at 8 of its 28 layers: at full depth its 6.05 B params'
# fp32 state (params, grads, two moments: 16 bytes a param, about 97 GB)
# exceeds one card
GPTJ_TRAIN_LAYERS = 8


def dense_families():
    """{key: (module, published config, sequence length)} of [train-dense]:
    GPT-2-350m, BERT-base and Phi-2 at full depth, GPT-J-6B at
    ``GPTJ_TRAIN_LAYERS``."""
    from deepspeed_tpu_torch.models import bert, gpt2, gptj, phi
    return {"gpt2": (gpt2, gpt2.GPT2Config.gpt2_350m(), 1024),
            "bert": (bert, bert.BertConfig.bert_base(), 512),
            "phi": (phi, phi.PhiConfig.phi_2(), 2048),
            "gptj": (gptj, dataclasses.replace(gptj.GPTJConfig.gptj_6b(),
                                               num_layers=GPTJ_TRAIN_LAYERS), 2048)}


def dense_batch(key, vocab, rows, seq, seed):
    """Causal LMs: next-token pairs (``llama.causal_lm_batch``); BERT: MLM
    labels at every 4th position (``tests/unit/test_models.py``'s drive)."""
    from deepspeed_tpu_torch.models import llama
    ids = np.random.default_rng(seed).integers(0, vocab, (rows, seq))
    if key != "bert":
        return llama.causal_lm_batch(ids)
    labels = np.full_like(ids, -100)
    labels[:, ::4] = ids[:, ::4]
    return {"input_ids": ids, "labels": labels}


def padding_mask(rows, seq, pad):
    """[rows, seq] int32 attention mask whose odd rows pad their last ``pad``
    keys."""
    mask = np.ones((rows, seq), np.int32)
    mask[1::2, seq - pad:] = 0
    return mask


def train_dense_family(card, key, module, cfg, seq, seed=0, device="cuda", cut=""):
    """``DENSE_STEPS`` ``train_batch`` steps of ``module`` at ``cfg``
    through ``initialize`` (bf16 on the card, remat, ``fused_adam``, WarmupLR,
    clip 1.0) on one fixed batch of micro x gas rows of ``seq`` tokens;
    ``cut`` names a depth cut in the log.  Gates: finite losses that fall;
    launches equal to the step formula, every flash launch a tensor-core
    one.  For BERT one more step with a padding mask: no flash launch (the
    masked attention is plain ``sdpa``), the fused AdamW step as before.
    Returns (launches, summary)."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.tree import tree_leaves
    tag = f"train-{key}"
    on_card = torch.device(device).type == "cuda"
    micro, gas, steps, lr = DENSE_MICRO, DENSE_GAS, DENSE_STEPS, DENSE_LR[key]
    t0 = time.perf_counter()
    params = module.init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                                dtype=torch.float32, device=device)
    n_leaves, n_params = len(tree_leaves(params)), module.num_params(cfg)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        loss_fn=module.make_loss_fn(cfg), model_parameters=params, device=device,
        config=train_config(micro=micro, gas=gas, bf16=on_card, seed=seed, lr=lr))
    del params
    batch = dense_batch(key, cfg.vocab_size, micro * gas, seq, seed)
    tokens = micro * gas * seq
    # 6 N a token and the attention products (llama.flops_per_token's term)
    step_flops = (6.0 * n_params + 12 * cfg.num_layers * cfg.hidden_size * seq) * tokens
    log(f"[{tag}] {cfg.num_layers} layers{cut}, hidden {cfg.hidden_size}, {cfg.num_heads} "
        f"heads of {cfg.hidden_size // cfg.num_heads}, vocab {cfg.vocab_size}: "
        f"{n_params / 1e6:.1f} M params, set up in {time.perf_counter() - t0:.2f} s; "
        f"{'bf16' if on_card else 'fp32'}, remat, fused_adam, WarmupLR to {lr}, clip "
        f"1.0, micro {micro} x gas {gas} x seq {seq} = {tokens} tokens a step, "
        f"{step_flops / 1e12:.2f} TFLOP a step")
    _sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = engine.train_batch(batch)
        _sync(device)
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics.loss))
    launches = launch_counts()
    expected = expected_launches(steps=steps, gas=gas, layers=cfg.num_layers, n_leaves=n_leaves,
                                 optimizer="fused_adam", sparse=None)
    wrappers = _kernel_wrappers()
    tc = {name: wrappers[name].tc_launches for name in TC_TRAIN_KERNELS[:3]}
    if on_card and (launches != expected or any(tc[k] != launches[k] for k in tc)):
        raise AssertionError(f"[{tag}] launches {launches}, tensor-core {tc}; the step formula "
                             f"gives {expected}, every flash launch on tensor cores")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] losses not finite and falling: {losses}")
    step_s = statistics.mean(times[1:])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
    summary = {"step_ms": step_s * 1e3, "tokens_s": tokens / step_s,
               "mfu": step_flops / step_s / TRAIN_PEAK_FLOPS, "peak_gb": peak_gb,
               "launches": launches}
    log(f"[{tag}] {steps} steps on {card}: losses {[round(x, 4) for x in losses]}; step ms "
        f"{[round(t * 1e3, 1) for t in times]} (first includes warm-up); steps 2-{steps}: "
        f"{summary['step_ms']:.1f} ms a step, {summary['tokens_s']:.1f} tokens/s, mfu "
        f"{summary['mfu']:.4f} (of {TRAIN_PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16), peak memory "
        f"{peak_gb:.2f} GB; launches { {k: v for k, v in launches.items() if v} } = step "
        f"formula, tensor-core { {k: v for k, v in tc.items() if v} }")
    if on_card:
        profile_train(engine, batch, card, step_s, tag=f"profile-{tag}")
    if key == "bert":
        masked = dict(batch, attention_mask=padding_mask(micro * gas, seq, 64))
        reset_launch_counts()
        loss = float(engine.train_batch(masked).loss)
        _sync(device)
        got = {k: v for k, v in launch_counts().items() if v}
        if not np.isfinite(loss) or (on_card and got != {"fused_adamw": n_leaves}):
            raise AssertionError(f"[{tag}] the masked step: loss {loss}, launches {got}; "
                                 f"expected fused_adamw {n_leaves} and no flash launch")
        log(f"[{tag}] one more step with a padding mask (64 keys of every other row): loss "
            f"{loss:.4f}, launches {got}: the masked attention goes to sdpa, no flash launch")
    del engine
    if on_card:
        torch.cuda.empty_cache()
    return launches, summary


def dense_slice_check(tag, module, cfg, batch, device, seed=3, **forward_kw):
    """``module.forward`` and the grads of its loss (``make_loss_fn``'s
    cross entropy) in fp32 on ``device`` against a CPU copy of the same
    weights, the tolerances of [train-slice]: the loss at rtol 1e-4, the
    logits and each leaf's grad at rtol 1e-4 and an atol of 1e-4 of its
    largest value.  Returns (max logit error, max grad error relative to
    its leaf's largest grad, launches on ``device``)."""
    import torch
    from deepspeed_tpu_torch.models.transformer import cross_entropy_loss
    from deepspeed_tpu_torch.runtime.tree import tree_leaves, tree_map
    params = module.init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                                dtype=torch.float32, device=device)
    out = []
    for dev, p in ((device, params), ("cpu", tree_map(lambda t: t.cpu(), params))):
        p = tree_map(lambda t: t.detach().requires_grad_(True), p)
        kw = {k: torch.from_numpy(v).to(dev) for k, v in forward_kw.items()}
        before = launch_counts()
        with torch.enable_grad():
            logits = module.forward(cfg, p, torch.from_numpy(batch["input_ids"]).to(dev), **kw)
            loss = cross_entropy_loss(logits, torch.from_numpy(batch["labels"]).to(dev))
            # BERT's type_emb without token types: a zero grad, as the engine gives it
            grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True,
                                        materialize_grads=True)
        _sync(dev)
        launched = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
        out.append((logits.detach().cpu(), loss.item(), [g.cpu() for g in grads], launched))
    (logits, loss, grads, launched), (ref_logits, ref_loss, ref_grads, _) = out
    if not abs(loss - ref_loss) <= 1e-4 * abs(ref_loss):
        raise AssertionError(f"[{tag}] loss {loss} on {device}, {ref_loss} on the CPU")
    top = ref_logits.abs().max().item()
    logit_err = _max_err(f"[{tag}] logits", logits, ref_logits, 1e-4 * top, 1e-4)
    grad_rel = 0.0
    for i, (g, r) in enumerate(zip(grads, ref_grads)):
        top = r.abs().max().item()
        err = _max_err(f"[{tag}] grad of leaf {i}", g, r, 1e-4 * top, 1e-4)
        grad_rel = max(grad_rel, err / top if top else 0.0)
    return logit_err, grad_rel, launched


def phase_train_dense(card, device="cuda", configs=None, mistral_cfg=None):
    """[train-dense]: GPT-2-350m (S = 1024, causal), BERT-base (S = 512,
    non-causal, no mask) and Phi-2 (S = 2048, head dim 80) at full width and
    depth, and GPT-J-6B (S = 2048, head dim 256) at full width and
    ``GPTJ_TRAIN_LAYERS`` of its 28 layers, trained by
    :func:`train_dense_family` through the flash kernels and fused AdamW;
    then each at 2 layers in fp32 (:func:`dense_slice_check`: a flash
    forward, the remat recompute and both backward kernels a layer, on the
    CUDA-core kernels at head dims 64, 80 and 256), BERT with a padding mask
    (no flash launch; a token changed behind the mask leaves every unmasked
    logit as it was), and Mistral-7B's windowed dense forward at 2 layers
    with a window of 32 under a sequence of 96 (the masked ``sdpa`` on every
    device), each on ``device`` against the CPU.  ``configs`` ({key:
    (module, cfg, seq)}) and ``mistral_cfg`` replace the published
    configurations for a rehearsal.  Returns the flash and AdamW launches of
    the full-size runs, and their summaries, by family."""
    import torch
    from deepspeed_tpu_torch.models import mistral
    from deepspeed_tpu_torch.runtime.tree import tree_map
    on_card = torch.device(device).type == "cuda"
    families = configs or dense_families()
    out, summaries = {}, {}
    for key, (module, cfg, seq) in families.items():
        cut = f" (of {module.GPTJConfig.gptj_6b().num_layers}: the fp32 state of all of them " \
              f"exceeds one card)" if key == "gptj" and configs is None else ""
        with phase_timer(f"train-{key}"):
            out[key], summaries[key] = train_dense_family(card, key, module, cfg, seq,
                                                          device=device, cut=cut)
    for key, (module, cfg, _) in families.items():
        small = dataclasses.replace(cfg, num_layers=2)
        batch = dense_batch(key, small.vocab_size, 2, 128, seed=5)
        logit_err, grad_rel, launched = dense_slice_check(f"train-{key}-slice", module, small,
                                                          batch, device)
        want = {"flash_fwd": 4, "flash_bwd_dkdv": 2, "flash_bwd_dq": 2}
        if on_card and launched != want:
            raise AssertionError(f"[train-{key}-slice] launched {launched}, expected {want}")
        log(f"[train-{key}-slice] 2 layers at full width, fp32, 2 x 128 tokens, {device} vs the "
            f"CPU: loss within rtol 1e-4, logits max abs err {logit_err:.3e}, grads at most "
            f"{grad_rel:.3e} of their leaf's largest (rtol 1e-4, atol 1e-4 x max|leaf|); "
            f"launches {launched}")
    module, cfg, _ = families["bert"]
    small = dataclasses.replace(cfg, num_layers=2)
    batch = dense_batch("bert", small.vocab_size, 2, 128, seed=6)
    mask = padding_mask(2, 128, 32)
    logit_err, grad_rel, launched = dense_slice_check("train-bert-masked", module, small, batch,
                                                      device, attention_mask=mask)
    if launched:
        raise AssertionError(f"[train-bert-masked] launched {launched}: a masked attention "
                             f"goes to sdpa")
    params = module.init_params(small, torch.Generator(device=device).manual_seed(3),
                                device=device)
    ids = batch["input_ids"].copy()
    ids[1, -5] = (ids[1, -5] + 7) % small.vocab_size  # behind row 1's mask
    run = lambda x: module.forward(small, params, torch.from_numpy(x).to(device),  # noqa: E731
                                   attention_mask=torch.from_numpy(mask).to(device))
    moved = (run(ids) - run(batch["input_ids"]))[1, :128 - 32].abs().max().item()
    if moved > 1e-5:
        raise AssertionError(f"[train-bert-masked] a token behind the mask moved the unmasked "
                             f"logits by {moved:.3e}")
    log(f"[train-bert-masked] 2 layers, fp32, a padding mask over 32 keys of row 1, {device} vs "
        f"the CPU: logits max abs err {logit_err:.3e}, grads at most {grad_rel:.3e} of their "
        f"leaf's largest; no flash launch; a token changed behind the mask moved the unmasked "
        f"logits by {moved:.3e} (gate 1e-5)")
    mcfg = mistral_cfg or dataclasses.replace(mistral.MistralConfig.mistral_7b(), num_layers=2,
                                              sliding_window=32)
    mparams = mistral.init_params(mcfg, torch.Generator(device=device).manual_seed(4),
                                  device=device)
    ids = np.random.default_rng(4).integers(0, mcfg.vocab_size, (1, 96))
    before = launch_counts()
    got = mistral.forward(mcfg, mparams, torch.from_numpy(ids).to(device)).cpu()
    launched = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    ref = mistral.forward(mcfg, tree_map(lambda t: t.cpu(), mparams), torch.from_numpy(ids))
    err = _max_err("[train-mistral-windowed] logits", got, ref, 1e-4 * ref.abs().max().item(),
                   1e-4)
    if launched:
        raise AssertionError(f"[train-mistral-windowed] launched {launched}: the windowed "
                             f"attention is the masked sdpa")
    log(f"[train-mistral-windowed] mistral_7b width, 2 layers, fp32, window "
        f"{mcfg.sliding_window} under 96 tokens, {device} vs the CPU: logits max abs err "
        f"{err:.3e} (rtol 1e-4, atol 1e-4 x max|logit|); no kernel launched")
    del params, mparams
    if on_card:
        torch.cuda.empty_cache()
    return out, summaries


# [train-resume] and [train-fp16]: Llama-2-7B at full width cut to 2 layers
# (about 0.667 B params), micro 2 x gas 2 x seq 2048
RESUME_LAYERS = 2
RESUME_OPTIMIZERS = ("fused_adam", "fused_adam8bit")
RESUME_STEPS = 4  # two before the save, two after the load
# the optimizer whose run also saves an earlier tag and loads a copy with a
# truncated leaf: the smaller state, since a save runs at about 0.4 GB/s on
# an H100 host's disk and the two phases have 100 s
FALLBACK_OPTIMIZER = "fused_adam8bit"
# fp16: from 2**32 the scale halves on every overflow (hysteresis 1); the
# phase steps until FP16_CLEAN steps have been taken (at most FP16_MAX_STEPS)
# and saves after the FP16_SAVE_AFTER-th clean one
FP16_CONFIG = {"enabled": True, "initial_scale_power": 32, "hysteresis": 1,
               "loss_scale_window": 1000}
FP16_CLEAN, FP16_SAVE_AFTER, FP16_MAX_STEPS = 6, 2, 40
# the first clean fp16 step's grad norm against bf16's at the same params:
# the two differ by rounding only (2**-8 a bf16 element), while a grad left
# scaled, unscaled twice or not divided by gas misses by 2x or more
FP16_NORM_RTOL = 5e-2


class LaunchDtypes:
    """Stands in for the flash library while a phase runs: counts each
    ``*_launch`` call by its dtype code (0 fp32, 1 bf16, 2 fp16) and
    forwards it."""

    def __init__(self, lib):
        self.lib, self.codes = lib, collections.Counter()

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if not name.endswith("_launch"):
            return fn

        def call(*args):
            self.codes[(name, args[0])] += 1
            return fn(*args)

        return call


@contextlib.contextmanager
def flash_dtypes(on_card):
    """Yield a Counter of flash launches by (C entry, dtype code) while the
    block runs on the card (empty on the CPU, where no kernel launches)."""
    from deepspeed_tpu_torch.ops.attention import flash
    if not on_card:
        yield collections.Counter()
        return
    original = flash._lib
    recorder = LaunchDtypes(original())
    flash._lib = lambda: recorder
    try:
        yield recorder.codes
    finally:
        flash._lib = original


def resume_engine(cfg, conf, seed, device):
    """A Llama engine on ``device`` with params drawn from ``seed``."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama
    params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                               dtype=torch.float32, device=device)
    return deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg), model_parameters=params,
                                          config=dict(conf, seed=seed), device=device)[0]


def resume_batches(cfg, n, seq, rows, seed):
    from deepspeed_tpu_torch.models import llama
    rng = np.random.default_rng(seed)
    return [llama.causal_lm_batch(rng.integers(0, cfg.vocab_size, (rows, seq)))
            for _ in range(n)]


def states_identical(tag, got, want):
    """Raise unless every leaf of the two train states is equal bit for bit
    (tensors compared on their device); returns the number of leaves."""
    import torch
    from deepspeed_tpu_torch.runtime.checkpointing import flatten_with_keys
    a, b = dict(flatten_with_keys(got)), dict(flatten_with_keys(want))
    if list(a) != list(b):
        raise AssertionError(f"[{tag}] state keys differ: {list(a)} vs {list(b)}")
    for key in a:
        x, y = a[key], b[key]
        same = torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        if not same:
            diff = ((x.float() - y.float()).abs().max().item() if isinstance(x, torch.Tensor)
                    else f"{x} vs {y}")
            raise AssertionError(f"[{tag}] leaf {key} differs from the unbroken run: {diff}")
    return len(a)


def checkpoint_bytes(path):
    from deepspeed_tpu_torch.runtime.checkpointing import read_metadata
    return sum(e["nbytes"] for e in read_metadata(path)["manifest"])


@contextlib.contextmanager
def checkpoint_parts(engine):
    """Seconds spent in the parts of a save or load while the block runs:
    each leaf's copy to the host, its ``.npy`` write, its fsync and its CRC
    read-back (a save), each leaf's copy to the device (a load; its read
    from the file falls in the rest).  The
    timers wrap the checkpointing module's own helpers and the engine's
    writer, so the save and load themselves do no extra work."""
    from deepspeed_tpu_torch.runtime import checkpointing
    parts = collections.Counter()

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                parts[name] += time.perf_counter() - t0
        return call

    names = {"to_host": "device to host", "fsync_file": "fsync", "file_crc32": "CRC read-back",
             "_restore_leaf": "host to device"}
    saved = {name: getattr(checkpointing, name) for name in names}
    writer = engine.checkpoint_engine
    for name, label in names.items():
        setattr(checkpointing, name, timed(label, saved[name]))
    writer.save = timed("npy write", writer.save)
    try:
        yield parts
    finally:
        for name, fn in saved.items():
            setattr(checkpointing, name, fn)
        del writer.save


def parts_line(parts, total):
    rest = total - sum(parts.values())
    return ", ".join([f"{k} {v:.2f} s" for k, v in parts.items()] + [f"the rest {rest:.2f} s"])


def truncated_copy(src, dst, tag, key):
    """``dst``: ``src`` hard-linked file by file, with leaf ``key`` of ``tag``
    a separate copy cut to half its bytes."""
    shutil.copytree(src, dst, copy_function=os.link)
    leaf = os.path.join(dst, tag, key + ".npy")
    with open(leaf, "rb") as fh:
        data = fh.read()
    os.remove(leaf)  # break the link before writing
    with open(leaf, "wb") as fh:
        fh.write(data[:len(data) // 2])


def train_resume_one(card, cfg, optimizer, root, seed, device, micro, gas, seq):
    """One optimizer of [train-resume]; see :func:`phase_train_resume`."""
    import torch
    from deepspeed_tpu_torch.runtime.checkpointing import CheckpointError
    from deepspeed_tpu_torch.runtime.tree import tree_leaves
    from deepspeed_tpu_torch.utils import safetensors_io
    tag = f"train-resume {optimizer}"
    on_card = torch.device(device).type == "cuda"
    conf = train_config(micro=micro, gas=gas, bf16=True, seed=seed, optimizer=optimizer)
    batches = resume_batches(cfg, RESUME_STEPS, seq, micro * gas, seed)
    half = RESUME_STEPS // 2
    unbroken = resume_engine(cfg, conf, seed, device)
    n_leaves = len(tree_leaves(unbroken.state.params))
    ref, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        ref.append(float(unbroken.train_batch(batch).loss))
        _sync(device)
        times.append(time.perf_counter() - t0)
    fallback = optimizer == FALLBACK_OPTIMIZER
    first = resume_engine(cfg, conf, seed, device)
    losses = [float(first.train_batch(batches[0]).loss)]
    if fallback:
        first.save_checkpoint(os.path.join(root, "ck"))  # the earlier tag
    losses.append(float(first.train_batch(batches[1]).loss))
    _sync(device)
    with checkpoint_parts(first) as save_parts:
        t0 = time.perf_counter()
        saved_tag = first.save_checkpoint(os.path.join(root, "ck"))
        save_s = time.perf_counter() - t0
    del first
    if on_card:
        torch.cuda.empty_cache()
    nbytes = checkpoint_bytes(os.path.join(root, "ck", saved_tag))
    resumed = resume_engine(cfg, conf, seed + 1, device)
    fell_back = "not run"
    if fallback:
        truncated_copy(os.path.join(root, "ck"), os.path.join(root, "cut"), saved_tag,
                       "params.layers.mlp.w_down")
        try:
            resumed.load_checkpoint(os.path.join(root, "cut"))
            raise AssertionError(f"[{tag}] a truncated leaf loaded without an error")
        except CheckpointError as exc:
            fell_back = f"refused ({str(exc)[:90]}...), then loaded "
        loaded, _ = resumed.load_checkpoint(os.path.join(root, "cut"), fallback_to_valid=True)
        if loaded != "global_step1" or resumed.global_steps != 1 or resumed.state.step != 1:
            raise AssertionError(f"[{tag}] fallback_to_valid loaded {loaded} at step "
                                 f"{resumed.global_steps}, expected global_step1")
        fell_back += f"{loaded} with fallback_to_valid"
        shutil.rmtree(os.path.join(root, "cut"))
    _sync(device)
    with checkpoint_parts(resumed) as load_parts:
        t0 = time.perf_counter()
        loaded, _ = resumed.load_checkpoint(os.path.join(root, "ck"))  # through `latest`
        _sync(device)
        load_s = time.perf_counter() - t0
    reset_launch_counts()
    with flash_dtypes(on_card) as dtypes:
        losses += [float(resumed.train_batch(b).loss) for b in batches[half:]]
    launches = launch_counts()
    expected = expected_launches(steps=RESUME_STEPS - half, gas=gas, layers=cfg.num_layers,
                                 n_leaves=n_leaves, optimizer=optimizer, sparse=None)
    wrappers = _kernel_wrappers()
    tc = {name: wrappers[name].tc_launches for name in TC_TRAIN_KERNELS[:3]}
    if on_card and (launches != expected or any(tc[k] != launches[k] for k in tc)
                    or set(code for _, code in dtypes) != {1}):
        raise AssertionError(f"[{tag}] resumed launches {launches}, tensor-core {tc}, by dtype "
                             f"{dict(dtypes)}; the step formula gives {expected}, every flash "
                             f"launch a bf16 tensor-core one")
    if losses != ref:
        raise AssertionError(f"[{tag}] losses {losses} != the unbroken run's {ref}")
    n = states_identical(tag, resumed.state, unbroken.state)
    if not all(np.isfinite(ref)):
        raise AssertionError(f"[{tag}] losses not finite: {ref}")
    summary = {"step_ms": statistics.mean(times[1:]) * 1e3, "save_s": save_s, "load_s": load_s,
               "gb": nbytes / 1e9}
    log(f"[{tag}] on {card}: losses {[round(x, 4) for x in ref]} unbroken = 2 steps + "
        f"save_checkpoint + a fresh engine from seed {seed + 1} + load_checkpoint ({loaded}, "
        f"through latest) + 2 steps, bit for bit; {n} state leaves identical (params, "
        f"{type(resumed.state.opt_state).__name__}); unbroken step ms "
        f"{[round(t * 1e3, 1) for t in times]}; checkpoint {nbytes / 1e9:.3f} GB: save "
        f"{save_s:.2f} s ({nbytes / 1e9 / save_s:.2f} GB/s: {parts_line(save_parts, save_s)}), "
        f"load {load_s:.2f} s ({nbytes / 1e9 / load_s:.2f} GB/s: "
        f"{parts_line(load_parts, load_s)}) on the host's disk (warm page cache); resumed "
        f"launches { {k: v for k, v in launches.items() if v} } = step formula, flash by dtype "
        f"code {dict(dtypes)}; a copy with a truncated w_down leaf: {fell_back}")
    if optimizer == "fused_adam":
        fp32 = resumed.get_fp32_params()
        for (key, p), (_, arr) in zip(flatten_state(resumed.state.params), flatten_state(fp32)):
            if not np.array_equal(p.cpu().numpy(), arr):
                raise AssertionError(f"[{tag}] get_fp32_params() differs from the state at {key}")
        del fp32
        t0 = time.perf_counter()
        path = resumed.save_16bit_model(os.path.join(root, "model16"))
        header = safetensors_io.read_header(path)
        keys = [k for k, _ in flatten_state(resumed.state.params)]
        bad = [k for k, p in flatten_state(resumed.state.params)
               if header[k]["dtype"] != "BF16" or header[k]["shape"] != list(p.shape)
               or header[k]["data_offsets"][1] - header[k]["data_offsets"][0] != 2 * p.numel()]
        if sorted(k for k in header if k != "__metadata__") != sorted(keys) or bad:
            raise AssertionError(f"[{tag}] save_16bit_model header: bad entries {bad}")
        log(f"[{tag}] get_fp32_params() equals the state bit for bit; save_16bit_model wrote "
            f"{os.path.getsize(path) / 1e9:.3f} GB in {time.perf_counter() - t0:.2f} s, its header "
            f"lists all {len(keys)} param keys as BF16 with 2 bytes an element")
        os.remove(path)
    shutil.rmtree(os.path.join(root, "ck"))
    del resumed, unbroken
    if on_card:
        torch.cuda.empty_cache()
    return launches, summary


def flatten_state(tree):
    from deepspeed_tpu_torch.runtime.checkpointing import flatten_with_keys
    return list(flatten_with_keys(tree))


def resume_config(layers=RESUME_LAYERS):
    from deepspeed_tpu_torch.models import llama
    return dataclasses.replace(llama.LlamaConfig.llama2_7b(), num_layers=layers, remat=True)


def scratch_dir(cfg, tag):
    """A fresh directory under the system's temp dir for the phase's
    checkpoints, after checking it can hold twice the largest state (fp32
    params, m and v)."""
    import tempfile
    from deepspeed_tpu_torch.models import llama
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    need = 2 * 12 * llama.num_params(cfg)
    usage = shutil.disk_usage(root)
    log(f"[{tag}] checkpoints under {root}: disk {usage.total / 1e9:.1f} GB, free "
        f"{usage.free / 1e9:.1f} GB, twice the largest state {need / 1e9:.1f} GB")
    if usage.free < need:
        shutil.rmtree(root, ignore_errors=True)
        raise RuntimeError(f"[{tag}] {root} has {usage.free / 1e9:.1f} GB free, under twice the "
                           f"largest state ({need / 1e9:.1f} GB)")
    return root


def phase_train_resume(card, seed=0, device="cuda", cfg=None, micro=2, gas=2, seq=2048):
    """[train-resume]: Llama-2-7B at full width cut to ``RESUME_LAYERS``
    layers, bf16, remat, WarmupLR, clip 1.0, micro 2 x gas 2 x seq 2048, once
    with ``fused_adam`` and once with ``fused_adam8bit``.  For each: one
    engine takes 4 steps unbroken; a second from the same seed takes 2, saves
    (``global_step2``) and is deleted; a third from another seed loads and
    takes the last 2.  Gates: the losses
    and every state leaf bit for bit equal to the unbroken run's; the resumed
    steps' launches equal to the step formula, every flash launch a bf16
    tensor-core one.  In the ``FALLBACK_OPTIMIZER`` run the second engine
    also saves after its first step, and a copy with one leaf of the newer
    tag truncated must raise ``CheckpointError`` and, with
    ``fallback_to_valid``, load the earlier tag.  With ``fused_adam`` also
    ``get_fp32_params`` against the state and the header of
    ``save_16bit_model``.  ``cfg`` (and the batch shape) replace the
    published configuration for a rehearsal.  Returns (launches by optimizer,
    summaries by optimizer)."""
    cfg = cfg or resume_config()
    root = scratch_dir(cfg, "train-resume")
    launches, summaries = {}, {}
    try:
        for optimizer in RESUME_OPTIMIZERS:
            with phase_timer(f"train-resume {optimizer}"):
                launches[optimizer], summaries[optimizer] = train_resume_one(
                    card, cfg, optimizer, root, seed, device, micro, gas, seq)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, summaries


def phase_train_fp16(card, bf16_ms, seed=0, device="cuda", cfg=None, micro=2, gas=2, seq=2048):
    """[train-fp16]: [train-resume]'s model and batch in fp16 with
    ``fused_adam`` and a dynamic loss scale from 2**32 (hysteresis 1, window
    1000), stepping until ``FP16_CLEAN`` steps have been taken.  Gates: at
    least one early step skipped; on each skipped step 0 fused AdamW
    launches, ``TrainState.step`` unchanged and the scale halved; after the
    first clean step, finite losses that fall; every flash launch a
    tensor-core one on fp16 inputs; a ``save_checkpoint`` after the
    ``FP16_SAVE_AFTER``-th clean step, loaded by a fresh engine from another
    seed, whose steps from there equal the unbroken ones bit for bit (loss
    scale included); the first clean step's grad norm (unscaled, before
    clipping, at the initial params since every skip left them put) within
    ``FP16_NORM_RTOL`` of a bf16 engine's from the same seed on the same
    batch.  ``bf16_ms`` maps names to bf16 step times of the same run,
    printed beside the fp16 one."""
    import torch
    from deepspeed_tpu_torch.ops.adam.fused_adam import fused_adamw_flat
    from deepspeed_tpu_torch.runtime.optimizers import global_grad_norm
    from deepspeed_tpu_torch.runtime.tree import tree_leaves
    on_card = torch.device(device).type == "cuda"
    cfg = cfg or resume_config()
    conf = dict(train_config(micro=micro, gas=gas, bf16=False, seed=seed), fp16=FP16_CONFIG)
    batches = resume_batches(cfg, 4, seq, micro * gas, seed + 7)
    # the reference norms, before the counted run: bf16 needs no loss scale
    reference = resume_engine(cfg, train_config(micro=micro, gas=gas, bf16=True, seed=seed),
                              seed, device)
    ref_norms = [float(global_grad_norm(reference.accumulate_gradients(b)[0])) for b in batches]
    del reference
    if on_card:
        torch.cuda.empty_cache()
    root = scratch_dir(cfg, "train-fp16")
    try:
        engine = resume_engine(cfg, conf, seed, device)
        if engine.compute_dtype != torch.float16:
            raise AssertionError(f"[train-fp16] compute dtype {engine.compute_dtype}")
        n_leaves = len(tree_leaves(engine.state.params))
        reset_launch_counts()
        rows, saved_at = [], None
        with flash_dtypes(on_card) as dtypes:
            while sum(not r["skipped"] for r in rows) < FP16_CLEAN:
                if len(rows) == FP16_MAX_STEPS:
                    raise AssertionError(f"[train-fp16] {FP16_MAX_STEPS} steps, only "
                                         f"{sum(not r['skipped'] for r in rows)} clean: {rows}")
                step_before, adam_before = engine.state.step, fused_adamw_flat.launches
                t0 = time.perf_counter()
                m = engine.train_batch(batches[len(rows) % len(batches)])
                loss = float(m.loss)
                _sync(device)
                row = {"loss": loss, "skipped": m.skipped, "scale": m.loss_scale,
                       "ms": (time.perf_counter() - t0) * 1e3,
                       "adam": fused_adamw_flat.launches - adam_before,
                       "norm": float(m.grad_norm)}
                rows.append(row)
                if m.skipped:
                    if (engine.state.step != step_before or (on_card and row["adam"] != 0)
                            or engine.state.loss_scale.cur_scale != m.loss_scale / 2):
                        raise AssertionError(f"[train-fp16] skipped step {len(rows)}: step "
                                             f"{step_before} -> {engine.state.step}, AdamW "
                                             f"launches {row['adam']}, scale {m.loss_scale} -> "
                                             f"{engine.state.loss_scale.cur_scale}")
                elif engine.state.step != step_before + 1 or (on_card and row["adam"] != n_leaves):
                    raise AssertionError(f"[train-fp16] clean step {len(rows)}: {row}")
                if saved_at is None and sum(not r["skipped"] for r in rows) == FP16_SAVE_AFTER:
                    t0 = time.perf_counter()
                    engine.save_checkpoint(os.path.join(root, "ck"))
                    save_s = time.perf_counter() - t0
                    saved_at = len(rows)
        launches = launch_counts()
        wrappers = _kernel_wrappers()
        tc = {name: wrappers[name].tc_launches for name in TC_TRAIN_KERNELS[:3]}
        steps = len(rows)
        clean = [r for r in rows if not r["skipped"]]
        expected = expected_launches(steps=steps, gas=gas, layers=cfg.num_layers,
                                     n_leaves=n_leaves, optimizer="fused_adam", sparse=None)
        expected["fused_adamw"] = len(clean) * n_leaves
        if on_card and (launches != expected or any(tc[k] != launches[k] for k in tc)
                        or set(code for _, code in dtypes) != {2}):
            raise AssertionError(f"[train-fp16] launches {launches}, tensor-core {tc}, by dtype "
                                 f"{dict(dtypes)}; expected {expected}, every flash launch an "
                                 f"fp16 tensor-core one")
        first_clean = next(i for i, r in enumerate(rows) if not r["skipped"])
        after = [r["loss"] for r in rows[first_clean:]]
        if not rows[0]["skipped"] or not all(np.isfinite(after)) or not after[-1] < after[0]:
            raise AssertionError(f"[train-fp16] want a skipped first step, then finite falling "
                                 f"losses: {rows}")
        norm, ref_norm = rows[first_clean]["norm"], ref_norms[first_clean % len(batches)]
        norm_err = abs(norm - ref_norm) / ref_norm
        if not norm_err <= FP16_NORM_RTOL:
            raise AssertionError(f"[train-fp16] first clean step's grad norm {norm} (scale "
                                 f"{rows[first_clean]['scale']}) against bf16's {ref_norm}: "
                                 f"relative difference {norm_err} over {FP16_NORM_RTOL}")
        resumed = resume_engine(cfg, conf, seed + 1, device)
        t0 = time.perf_counter()
        resumed.load_checkpoint(os.path.join(root, "ck"))
        load_s = time.perf_counter() - t0
        tail = []
        for i in range(saved_at, steps):
            m = resumed.train_batch(batches[i % len(batches)])
            tail.append({"loss": float(m.loss), "skipped": m.skipped, "scale": m.loss_scale})
        want = [{k: r[k] for k in ("loss", "skipped", "scale")} for r in rows[saved_at:]]
        if tail != want:
            raise AssertionError(f"[train-fp16] resumed steps {tail} != unbroken {want}")
        n = states_identical("train-fp16", resumed.state, engine.state)
        nbytes = checkpoint_bytes(os.path.join(root, "ck", f"global_step{saved_at}"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    clean_ms = statistics.mean(r["ms"] for r in clean[1:])
    beside = ", ".join(f"{name} {ms:.1f} ms" for name, ms in bf16_ms.items())
    log(f"[train-fp16] llama2_7b width x {cfg.num_layers} layers on {card}, fp16, fused_adam, "
        f"dynamic loss scale from 2**32 (hysteresis 1, window 1000): {steps} steps, "
        f"{steps - len(clean)} skipped (scales {[r['scale'] for r in rows]}), losses "
        f"{[round(r['loss'], 4) for r in rows]}; fused AdamW launches by step "
        f"{[r['adam'] for r in rows]}; first clean step's grad norm {norm:.6g} (unscaled "
        f"from {rows[first_clean]['scale']:g}) against a bf16 engine's {ref_norm:.6g} at the "
        f"same params and batch: relative difference {norm_err:.3g} (limit {FP16_NORM_RTOL}); "
        f"launches { {k: v for k, v in launches.items() if v} } = "
        f"step formula with AdamW on clean steps only, flash by dtype code {dict(dtypes)}; "
        f"clean steps 2-{len(clean)}: {clean_ms:.1f} ms a step (bf16 beside it: {beside}); "
        f"saved after step {saved_at} ({nbytes / 1e9:.3f} GB, {save_s:.2f} s), a fresh engine "
        f"from seed {seed + 1} loaded it in {load_s:.2f} s and its {steps - saved_at} steps "
        f"equal the unbroken ones bit for bit, {n} state leaves identical (loss_scale "
        f"{engine.state.loss_scale})")
    del engine, resumed
    if on_card:
        torch.cuda.empty_cache()
    return launches, {"step_ms": clean_ms, "steps": steps, "skipped": steps - len(clean)}


# [train-slice*]'s depth: one full-width layer, and sequences of 128
# tokens.  Its CPU engine sets the phase's time (on an NVIDIA H100 80GB
# HBM3 at 700.00 W: about 250 s for the three at 2 layers; 197.5 s at one
# layer and 256 tokens on a slower host, where chip_smoke.py took 851.5 s
# with the observability phases, 147.1 s at 128); the comparisons do not
# depend on the depth or the length.
TRAIN_SLICE_LAYERS = 1


def phase_train_slice(seed=1, steps=2, micro=2, gas=2, seq=128, tag="train-slice",
                      optimizer="fused_adam", sparse=None, lion_step=False):
    """``TRAIN_SLICE_LAYERS`` full-width Llama-2-7B layers in fp32: the CUDA engine (kernels)
    against the CPU engine (plain versions), same params and batch, with
    ``optimizer`` and, where given, the ``sparse`` attention section.  With
    ``lion_step`` one fused Lion step a leaf follows on the same two engines
    ([train-slice-lion], :func:`lion_fused_step`); returns its Lion launches
    (None without it)."""
    import torch
    from deepspeed_tpu_torch.runtime.tree import tree_leaves, tree_map
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), num_layers=TRAIN_SLICE_LAYERS,
                              remat=True)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                               dtype=torch.float32, device="cuda")
    params_cpu = tree_map(lambda t: t.cpu(), params)
    engines = {}
    conf = train_config(micro=micro, gas=gas, bf16=False, seed=seed, optimizer=optimizer,
                        sparse=sparse)
    for dev, p in (("cuda", params), ("cpu", params_cpu)):
        engines[dev], _, _, _ = deepspeed_tpu_torch.initialize(
            loss_fn=llama.make_loss_fn(cfg), model_parameters=p, config=conf, device=dev)
    del params, params_cpu
    rng = np.random.default_rng(seed)
    batch = llama.causal_lm_batch(rng.integers(0, cfg.vocab_size, (micro * gas, seq)))
    t0 = time.perf_counter()
    reset_launch_counts()
    grads = {dev: engines[dev].accumulate_gradients(batch)[0] for dev in engines}
    # per leaf: rtol 1e-4 and an atol of 1e-4 of that leaf's largest grad
    grad_err, grad_rel, grad_rms = 0.0, 0.0, []
    for i, (g_gpu, g_cpu) in enumerate(zip(tree_leaves(grads["cuda"]),
                                           tree_leaves(grads["cpu"]))):
        top = g_cpu.abs().max().item()
        err = _max_err(f"[{tag}] step-1 grad of leaf {i}", g_gpu.cpu(), g_cpu, 1e-4 * top, 1e-4)
        grad_err, grad_rel = max(grad_err, err), max(grad_rel, err / top if top else 0.0)
        grad_rms.append(_rms(g_cpu))
    del grads
    losses, lrs = {"cuda": [], "cpu": []}, []
    for _ in range(steps):
        for dev, engine in engines.items():
            metrics = engine.train_batch(batch)
            losses[dev].append(float(metrics.loss))
        lrs.append(metrics.lr)
    launches = {k: v for k, v in launch_counts().items() if v}
    attn = "sparse" if sparse is not None else "flash"
    adam = {"fused_adam": "fused_adamw", "fused_adam8bit": "adamw8bit"}[optimizer]
    if set(launches) != {f"{attn}_fwd", f"{attn}_bwd_dkdv", f"{attn}_bwd_dq", adam}:
        raise AssertionError(f"[{tag}] the CUDA engine launched {launches}, not the "
                             f"{attn} and {adam} kernels alone")
    for lg, lc in zip(losses["cuda"], losses["cpu"]):
        if not abs(lg - lc) <= 1e-4 * abs(lc):
            raise AssertionError(f"[{tag}] losses differ: CUDA {losses['cuda']} vs CPU "
                                 f"{losses['cpu']} (rtol 1e-4)")
    # Adam's m/sqrt(v), and Lion's sign, turn a sign flip of a near-zero grad
    # into a full-lr step, so params may differ by up to 2 lr a step; nearly
    # all agree closely
    worst, n_close, n_total, limit = params_agree(tag, engines, lrs, steps)
    fused = ""
    lion_launches = None
    if lion_step:
        t_lion = time.perf_counter()
        lion_launches, lr = lion_fused_step(engines, batch, lrs[-1])
        lrs.append(lr)
        steps += 1
        worst, n_close, n_total, limit = params_agree(tag, engines, lrs, steps)
        fused = (f"; then [train-slice-lion]: one fused Lion step a leaf through "
                 f"fused_lion_flat on the same engines ({lion_launches} launches on CUDA, "
                 f"{time.perf_counter() - t_lion:.1f} s)")
    log(f"[{tag}] llama2_7b width, {cfg.num_layers} layers, fp32, seq {seq}, micro {micro} x gas {gas}, "
        f"{optimizer}{', sparse ' + sparse['mode'] + ' block ' + str(sparse['block']) if sparse else ''}, "
        f"{steps} steps, CUDA kernels ({launches}) vs CPU plain versions in "
        f"{time.perf_counter() - t0:.1f} s: losses {losses['cuda']} vs {losses['cpu']} (rtol "
        f"1e-4); step-1 grads max abs err {grad_err:.3e}, at most {grad_rel:.3e} of its leaf's "
        f"largest grad (rtol 1e-4, atol 1e-4 x max|leaf|; rms per leaf {min(grad_rms):.3e} to "
        f"{max(grad_rms):.3e}){fused}; params max abs diff {worst:.3e} (limit 2 x sum(lr) "
        f"= {limit:.3e}), {n_close / n_total:.5%} within 1e-5")
    del engines
    torch.cuda.empty_cache()
    return lion_launches


def params_agree(tag, engines, lrs, steps):
    """The CUDA engine's params against the CPU engine's: every element within
    2 x sum(lr), 99.9 % within 1e-5; returns (max diff, count within 1e-5,
    count, limit)."""
    from deepspeed_tpu_torch.runtime.tree import tree_leaves
    limit = 2.0 * sum(lrs)
    worst, n_close, n_total = 0.0, 0, 0
    for p_gpu, p_cpu in zip(tree_leaves(engines["cuda"].state.params),
                            tree_leaves(engines["cpu"].state.params)):
        diff = (p_gpu.cpu() - p_cpu).abs()
        worst = max(worst, diff.max().item())
        n_close += int((diff <= 1e-5).sum())
        n_total += diff.numel()
    if worst > limit or n_close < 0.999 * n_total:
        raise AssertionError(f"[{tag}] params after {steps} steps: max abs diff "
                             f"{worst:.3e} (limit {limit:.3e}), {n_close / n_total:.5%} within "
                             f"1e-5 (need 99.9 %)")
    return worst, n_close, n_total, limit


def lion_fused_step(engines, batch, lr):
    """One Lion step taken the fused way, as a user calls the public
    ``fused_lion_flat`` on flat buffers: each engine's grads at its params,
    then one call a leaf on its params and Lion momentum, in place (the
    kernel on CUDA, the plain version on the CPU).  The launch counts are set
    to 0 just before and read just after; returns (Lion launches, lr)."""
    import torch
    from deepspeed_tpu_torch.ops.adam.fused_adam import fused_lion_flat
    from deepspeed_tpu_torch.runtime.tree import tree_leaves
    # lion()'s default betas, train_config's weight decay
    hyper = dict(lr=lr, beta1=0.9, beta2=0.99, weight_decay=0.1)
    grads = {dev: engine.accumulate_gradients(batch)[0] for dev, engine in engines.items()}
    torch.cuda.synchronize()
    reset_launch_counts()
    n_leaves = 0
    for dev, engine in engines.items():
        state = engine.state
        for p, m, g in zip(tree_leaves(state.params), tree_leaves(state.opt_state.exp_avg),
                           tree_leaves(grads[dev])):
            fused_lion_flat(p.view(-1), m.view(-1), g.view(-1), **hyper)
            n_leaves += dev == "cuda"
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if v}
    if launches != {"fused_lion": n_leaves}:
        raise AssertionError(f"the fused Lion step launched {launches}, not fused_lion once for "
                             f"each of the {n_leaves} leaves")
    return n_leaves, lr


# ------------------------------------------------------------------ phase 8
V1_BATCH, V1_PROMPT, V1_NEW = 8, 512, 64
V1_PROFILE_NEW = 8  # new tokens of the generate run again under torch.profiler
# int8 against dense logits at full depth.  Random weights lose correlation
# with depth (a CPU study at hidden 512: 0.9993 at 2 layers, 0.9988 at 8,
# 0.9986 at 32); the H100 gave 0.99803 at Llama-2-7B's 32 layers.  The JAX
# test's 0.999 (2 layers) is held by [slice-v1].
V1_INT8_CORR = 0.995


def serve_v1(card, tag, engine, prompts, vocab):
    """Greedy ``generate`` of ``V1_NEW`` tokens for ``prompts`` after a
    ``generate`` of one token (prefill and the first pick), after a short
    warm-up call; peak device memory from a reset after construction; checks
    the output, profiles a ``generate`` of ``V1_PROFILE_NEW`` tokens and
    returns the summary."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.generate(prompts[:, :16], max_new_tokens=2, temperature=0.0)  # cuBLAS set-up
    t0 = time.perf_counter()
    first = engine.generate(prompts, max_new_tokens=1, temperature=0.0)
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=V1_NEW, temperature=0.0)
    total_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    b, s = prompts.shape
    if out.shape != (b, s + V1_NEW) or not np.array_equal(out[:, :s], prompts):
        raise AssertionError(f"[{tag}] output {out.shape}, prompt echoed "
                             f"{np.array_equal(out[:, :s], prompts)}")
    if not ((out >= 0) & (out < vocab)).all() or not np.array_equal(out[:, :s + 1], first):
        raise AssertionError(f"[{tag}] tokens outside the vocabulary, or the first pick differs "
                             f"between the two calls")
    summary = {"prefill_ms": prefill_s * 1e3,
               "decode_ms": (total_s - prefill_s) / (V1_NEW - 1) * 1e3,
               "tokens_s": b * V1_NEW / total_s, "wall_s": total_s, "peak_gb": peak_gb}
    log(f"[{tag}] {b} prompts x {s} tokens, {V1_NEW} greedy new tokens each, output {out.shape} "
        f"inside the vocabulary, on {card}: prefill (generate of 1 token) "
        f"{summary['prefill_ms']:.2f} ms, mean decode step {summary['decode_ms']:.2f} ms, "
        f"{summary['tokens_s']:.1f} generated tok/s ({total_s:.3f} s), peak memory "
        f"{peak_gb:.2f} GB from a reset after construction")
    # the profiler's own cost grows with the kernels it records (about 47 s
    # for a 64-token generate, each engine): profile a shorter generate,
    # against the same generate unprofiled
    t0 = time.perf_counter()
    engine.generate(prompts, max_new_tokens=V1_PROFILE_NEW, temperature=0.0)
    short_s = time.perf_counter() - t0
    profile_device(lambda: engine.generate(prompts, max_new_tokens=V1_PROFILE_NEW,
                                           temperature=0.0),
                   card, f"profile-{tag}", f"generate of {V1_PROFILE_NEW} tokens",
                   short_s * 1e3, (("softmax", "softmax"), ))
    return summary


def _corrcoef(a, b):
    """Pearson correlation of two tensors' elements, in float64."""
    x, y = a.double().flatten(), b.double().flatten()
    x, y = x - x.mean(), y - y.mean()
    return float((x * y).sum() / (x.norm() * y.norm()))


def phase_serve_v1(card, seed=0):
    """Llama-2-7B at full width and depth in bf16 (seeded random weights)
    through ``init_inference``: the dense engine, then the weight-only int8
    one built from the same weights (11 quantize launches at construction),
    each serving the same 8 prompts of 512 tokens; the dense weights are
    freed before the int8 engine serves.  Returns (int8 summary, quantize
    launches)."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.quantization import (dequantize_tree, is_woq_leaf,
                                                            packed_nbytes)
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.runtime.tree import tree_leaves
    cfg = llama.LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                               dtype=torch.bfloat16, device="cuda")
    dense_bytes = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (V1_BATCH, V1_PROMPT))
    conf = {"dtype": "bfloat16", "max_seq_len": V1_PROMPT + V1_NEW}
    reset_launch_counts()
    engine = deepspeed_tpu_torch.init_inference(model_module=llama, model_config=cfg,
                                                params=params, config=conf)
    log(f"[serve-v1] llama2_7b: {llama.num_params(cfg) / 1e9:.3f} B params, {cfg.num_layers} "
        f"layers, {dense_bytes / 1e9:.2f} GB bf16, set up in {time.perf_counter() - t0:.2f} s")
    dense = serve_v1(card, "serve-v1", engine, prompts, cfg.vocab_size)
    launches = {k: v for k, v in launch_counts().items() if v}
    if launches:  # the cached forward's masked attention goes to sdpa
        raise AssertionError(f"[serve-v1] launched {launches}; the dense v1 path runs no kernel")
    ref_logits = engine.forward(prompts).cpu()
    del engine
    reset_launch_counts()
    t0 = time.perf_counter()
    engine = deepspeed_tpu_torch.init_inference(
        model_module=llama, model_config=cfg, params=params,
        config=dict(conf, quant={"enabled": True, "bits": 8}))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    packed = packed_nbytes(engine.params)
    n_packed = sum(is_woq_leaf(x) for x in tree_leaves(engine.params))
    log(f"[serve-v1-int8] {n_packed} leaves packed in {build_s:.2f} s: {packed / 1e9:.3f} GB "
        f"resident ({packed / dense_bytes:.3f} of bf16), groups of 2048")
    if not 0.49 < packed / dense_bytes < 0.51:
        raise AssertionError(f"[serve-v1-int8] {packed} packed bytes against {dense_bytes} bf16")
    int8 = serve_v1(card, "serve-v1-int8", engine, prompts, cfg.vocab_size)
    launches = {k: v for k, v in launch_counts().items() if v}
    if launches != {"quantize_int8": 11} or n_packed != 11:
        raise AssertionError(f"[serve-v1-int8] launched {launches} with {n_packed} packed leaves; "
                             f"expected quantize_int8 11 times at construction and nothing else")
    logits = engine.forward(prompts)
    corr = _corrcoef(logits, ref_logits.cuda())
    saved = dense["peak_gb"] - int8["peak_gb"]
    # the same weights dequantized whole, served dense: the per-layer
    # dequantization must compute what whole-tree dequantization computes
    dequantized = deepspeed_tpu_torch.init_inference(
        model_module=llama, model_config=cfg, config=conf,
        params=dequantize_tree(engine.params, torch.bfloat16))
    same = dequantized.forward(prompts)
    same_corr, same_err = _corrcoef(logits, same), (logits - same).abs().max().item()
    log(f"[serve-v1-int8] prefill logits against the dense engine's: correlation {corr:.6f} "
        f"(gate > {V1_INT8_CORR}; the 2-layer [slice-v1] holds the JAX test's 0.999); against "
        f"a dense engine serving the dequantized weights: correlation {same_corr:.8f}, max abs "
        f"diff {same_err:.3e} (gate > 0.99999); peak {int8['peak_gb']:.2f} GB against "
        f"{dense['peak_gb']:.2f} GB dense, {saved:.2f} GB less (gate >= 4); decode step "
        f"{int8['decode_ms']:.2f} ms against {dense['decode_ms']:.2f} ms dense; quantize_int8 "
        f"launches {launches['quantize_int8']}")
    if not (corr > V1_INT8_CORR and same_corr > 0.99999) or saved < 4.0:
        raise AssertionError(f"[serve-v1-int8] correlation {corr:.6f} (dequantized "
                             f"{same_corr:.8f}), peak saved {saved:.2f} GB")
    del engine, dequantized, ref_logits, logits, same
    torch.cuda.empty_cache()
    return int8, launches["quantize_int8"]


def phase_slice_v1(seed=2):
    """2 full-width Llama-2-7B layers in fp32 through the v1 engine, dense and
    weight-only int8: the CUDA engine (quantize kernel, cuBLAS) against the
    same engine on the CPU (plain versions), same weights and prompts."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.quantization import is_woq_leaf
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.quantizer.quantize import quantize_int8
    from deepspeed_tpu_torch.runtime.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), num_layers=2)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                               dtype=torch.float32, device="cuda")
    params_cpu = tree_map(lambda t: t.cpu(), params)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 16))
    t0 = time.perf_counter()
    notes, dense_logits = [], None
    for quant in (None, {"enabled": True, "bits": 8}):
        conf = {"dtype": "float32", "max_seq_len": 64}
        if quant:
            conf["quant"] = quant
        before = quantize_int8.launches
        engines = {dev: deepspeed_tpu_torch.init_inference(model_module=llama, model_config=cfg,
                                                           params=p, config=conf, device=dev)
                   for dev, p in (("cuda", params), ("cpu", params_cpu))}
        name = "int8" if quant else "dense"
        if quant:
            launched = quantize_int8.launches - before
            pairs = list(zip(tree_leaves(engines["cuda"].params),
                             tree_leaves(engines["cpu"].params)))
            packed = [(a, b) for a, b in pairs if is_woq_leaf(a)]
            if launched != 11 or len(packed) != 11:
                raise AssertionError(f"[slice-v1] {launched} quantize launches, {len(packed)} "
                                     f"packed leaves (expected 11)")
            for i, (a, b) in enumerate(packed):
                check_bitwise(f"[slice-v1] packed leaf {i}", (a.q.cpu(), a.s.cpu()), (b.q, b.s),
                              ("codes", "scales"))
        got, ref = (engines[dev].forward(prompts).float().cpu() for dev in ("cuda", "cpu"))
        err = (got - ref).abs()
        if not torch.isfinite(got).all() or (err > 2e-3 + 2e-3 * ref.abs()).any():
            raise AssertionError(f"[slice-v1] {name}: CUDA logits differ from the CPU engine's by "
                                 f"up to {err.max().item():.3e}")
        if quant:  # the JAX test's criterion, at its depth (test_inference_v1.py:90)
            corr = _corrcoef(got, dense_logits)
            if not corr > 0.999:
                raise AssertionError(f"[slice-v1] int8 logits against dense: correlation "
                                     f"{corr:.6f}")
            notes.append(f"int8 against dense logits (CUDA): correlation {corr:.6f} (gate > 0.999)")
        dense_logits = got
        toks = {dev: engines[dev].generate(prompts, max_new_tokens=8, temperature=0.0)
                for dev in engines}
        if not np.array_equal(toks["cuda"], toks["cpu"]):
            raise AssertionError(f"[slice-v1] {name}: greedy tokens differ {toks['cuda'][:, 16:]} "
                                 f"vs {toks['cpu'][:, 16:]}")
        notes.append(f"{name}: logits max abs err {err.max().item():.3e}, 8 greedy tokens "
                     f"identical" + (", 11 packed leaves' codes and scales equal (the kernel's vs "
                                     "the plain version's)" if quant else ""))
        del engines
    log(f"[slice-v1] llama2_7b width, 2 layers, fp32, 2 prompts x 16 tokens, CUDA v1 engine vs "
        f"CPU v1 engine in {time.perf_counter() - t0:.1f} s (atol=rtol=2e-3): "
        + "; ".join(notes))
    del params, params_cpu
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ main
# --------------------------------------------- ZeRO-Offload and ZeRO-Infinity
HOST_SOURCES = ("cpu_adam", "aio")  # host C++ built with g++ (ops/_build.py HOST_FLAGS)
CPU_ADAM_SOURCE = "deepspeed_tpu_torch/csrc/cpu_adam.cpp"
AIO_SOURCE = "deepspeed_tpu_torch/csrc/aio.cpp"
CPU_ADAM_HYPER = dict(lr=3e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
CPU_ADAM_LIMIT = 1e-6  # |got - plain| <= limit * (1 + |plain|), the CPU tests' limit
CPU_ADAM_BYTES = 28  # a step reads p, m, v, g and writes p, m, v: 7 fp32 a element
# steps of [train] whose params [train-offload] holds its own to: step 1 (one
# update apart: the optimizers' rounding only) and OFFLOAD_STEPS
OFFLOAD_SAMPLED_STEPS = (1, 3)
STEP1_PARAM_ATOL = 1e-6  # one AdamW update of lr <= 3e-5 apart in rounding only
# bf16 after two more steps: the shares of the elements within 1e-5 of the
# reference's, pooled and in every leaf.  offload_probe.py's witness on an
# H100 80GB HBM3 at 700 W (two resident runs one fp32 ulp apart after step
# 1) keeps 99.77 % pooled and 99.51 % in its least leaf; a leaf left at its
# step-1 value keeps 3-9 % of its elements (the embedding, whose unbatched
# rows barely move, 78 %), and a faulted norm leaf leaves the pool at
# 99.45-99.73 %: the pooled share alone misses it
BF16_POOLED_SHARE = 0.995
BF16_LEAF_SHARE = 0.99
AIO_BYTES = 1 << 30
AIO_REQUESTS = 8  # the 1 GiB in 8 files, as the swapper writes a layer's leaves
OFFLOAD_STEPS = 3
OFFLOAD_SAMPLE = 1 << 20  # elements sampled from each leaf of [train]'s state at step 3
LOSS_RTOL_BF16 = 2e-3  # losses after bf16 updates of another rounding: a quarter of bf16's eps
OFFLOAD_PREDICTED_DROP_GB = 22.57  # 12 B a param (fp32 master, m, v) x 1.881 B params
INFINITY_LAYERS = 2
INFINITY_STEPS = 3
UNIVERSAL_WIDTH = dict(vocab=4096, hidden=512, layers=2, heads=4, kv_heads=4, seq=512)


def host_line():
    """(the host CPU's model, its threads and MemTotal as a line, MemTotal bytes)."""
    import platform
    model, mem = None, 0
    try:  # lscpu names ARM parts too, where /proc/cpuinfo has no "model name"
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        model = next((line.split(":", 1)[1].strip() for line in out.splitlines()
                      if line.startswith("Model name")), None)
    except (OSError, subprocess.SubprocessError):
        pass
    if model in (None, "unknown"):  # a virtual CPU may hide its name: family and model
        with open("/proc/cpuinfo") as fh:
            info = {k.strip(): v.strip() for k, v in (line.split(":", 1) for line in fh
                                                      if ":" in line)}
        model = " ".join(f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model")
                         if k in info) or "unknown"
    model = f"{model} ({platform.machine()})"
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemTotal"):
                mem = int(line.split()[1]) * 1024
    return (f"{model}, {os.cpu_count()} threads ({len(os.sched_getaffinity(0))} usable), "
            f"MemTotal {mem / 1e9:.1f} GB"), mem


def odirect_probe(root):
    """Whether ``root``'s filesystem takes an O_DIRECT write of one aligned
    block (the aio library falls back to buffered I/O per file, unsaid)."""
    import mmap
    path = os.path.join(root, "odirect_probe.bin")
    try:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC | os.O_DIRECT, 0o644)
    except OSError as exc:
        return False, f"open refused ({exc.strerror})"
    try:
        block = mmap.mmap(-1, 4096)  # page-aligned
        os.write(fd, block)
        return True, "accepted"
    except OSError as exc:
        return False, f"write refused ({exc.strerror})"
    finally:
        os.close(fd)
        os.unlink(path)


def seeded_normal(n, seed, device, scale=1.0, positive=False):
    """``n`` seeded fp32 normals on ``device`` (absolute values with
    ``positive``) times ``scale``."""
    import torch
    out = torch.randn(n, device=device, generator=torch.Generator(device=device).manual_seed(seed))
    out = out.abs() if positive else out
    return out.mul_(scale)


def host_ms(fn, runs=3):
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def phase_host_ops(card, n=W_GATE, aio_bytes=AIO_BYTES, device="cuda"):
    """[host-ops]: the two host libraries.  Builds both with g++; steps
    DeepSpeedCPUAdam over ``n`` fp32 elements (the 8-layer w_gate leaf, the
    optimizer rows' shape) laid out as the offloaded step holds them (p and
    the grad in page-locked flat buffers, m and v pageable), timed before any
    torch op of this phase runs on the host's cores; holds it against
    ``cpu_adamw_plain`` on the same inputs (``CPU_ADAM_LIMIT``); times
    ``torch.optim.AdamW(fused=True)`` on CPU tensors and the bound (28 B an
    element over the host's memory rate, from 1 GiB ``copy_`` and ``add_``
    probes); writes and reads ``aio_bytes`` through the aio library under
    the temp dir's filesystem and probes whether it takes O_DIRECT.  The
    inputs are drawn on ``device`` (the CPU in a rehearsal).  Returns the
    host-ops records."""
    import tempfile

    import torch
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam, cpu_adamw_plain
    from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
    from deepspeed_tpu_torch.runtime.swap_tensor.optimizer_swapper import flat_views, host_buffer
    host, mem = host_line()
    _build.build_all(HOST_SOURCES)
    log(f"[host-ops] {card}; host {host}; g++ build "
        f"{ {k: round(_build.build_seconds.get(k, 0.0), 2) for k in HOST_SOURCES} } s; threads in "
        f"this process {len(os.listdir('/proc/self/task'))}")
    # a state Adam could reach: v at least m^2, so that m / sqrt(v) stays bounded
    p, m, g = (seeded_normal(n, 1, device), seeded_normal(n, 2, device, scale=0.01),
               seeded_normal(n, 4, device))
    v = seeded_normal(n, 3, device, scale=1e-4, positive=True).addcmul_(m, m)
    state = flat_views(host_buffer(2 * n, torch.device(device).type == "cuda"), {"p": n, "g": n})
    state.update(m=torch.zeros(n), v=torch.zeros(n))

    def load():
        for key, t in (("p", p), ("m", m), ("v", v), ("g", g)):
            state[key].copy_(t)
        _sync(device)

    load()
    opt = DeepSpeedCPUAdam(**CPU_ADAM_HYPER)
    args = [state[k] for k in ("p", "m", "v", "g")]
    steps = iter(range(1, 100))
    adam_ms = host_ms(lambda: opt.step(*args, step=next(steps)))
    load()
    opt.step(*args, step=1)
    ref = [t.cpu() for t in (p, m, v, g)]
    b1, b2 = CPU_ADAM_HYPER["betas"]
    t0 = time.perf_counter()
    cpu_adamw_plain(*ref, lr=CPU_ADAM_HYPER["lr"], beta1=b1, beta2=b2,
                    eps=CPU_ADAM_HYPER["eps"], weight_decay=CPU_ADAM_HYPER["weight_decay"], step=1)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = over = 0.0
    for got, want in zip(args, ref):  # compared on ``device``
        got, want = got.to(device), want.to(device)
        diff = (got - want).abs_()
        err = max(err, float(diff.max()))
        over = max(over, float((diff - CPU_ADAM_LIMIT * (1 + want.abs())).max()))
        del got, want, diff
    if over > 0:
        raise AssertionError(f"[host-ops] CPU-Adam against the plain version: max abs err "
                             f"{err:.3e} passes the limit {CPU_ADAM_LIMIT} x (1 + |plain|)")
    param = torch.nn.Parameter(p.cpu())
    param.grad = ref[3]
    del ref
    library = torch.optim.AdamW([param], lr=CPU_ADAM_HYPER["lr"], betas=(b1, b2),
                                eps=CPU_ADAM_HYPER["eps"],
                                weight_decay=CPU_ADAM_HYPER["weight_decay"], fused=True)
    library_ms = host_ms(library.step)
    del param, library, p, m, v, g
    # the host's memory rate, two probes of 1 GiB: a copy_ (its writes also
    # read the destination's lines first, uncounted) and an in-place add_,
    # AdamW's pattern; the bound takes the faster
    src = torch.ones(AIO_BYTES // 4)
    dst = torch.empty_like(src)
    copy_rate = 2 * src.nbytes / (host_ms(lambda: dst.copy_(src), runs=5) / 1e3)
    inplace_rate = 2 * src.nbytes / (host_ms(lambda: src.add_(1.0), runs=5) / 1e3)
    rate = max(copy_rate, inplace_rate)
    del src, dst
    bound_ms = CPU_ADAM_BYTES * n / rate * 1e3
    cpu_adam = {"name": "cpu_adam", "route": "host C++ (g++ -O3 -march=native -fopenmp)",
                "source": CPU_ADAM_SOURCE, "replaces": "deepspeed_tpu/csrc/cpu_adam/cpu_adam.cpp",
                "ms": adam_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                "library_ms": library_ms, "library": "torch.optim.AdamW(fused=True) on CPU tensors",
                "max_abs_err": err, "threads": opt.threads, "n": n,
                "copy_gbps": copy_rate / 1e9, "inplace_gbps": inplace_rate / 1e9}
    log(f"[host-ops] cpu_adam n={n} fp32 ({opt.threads} OpenMP threads; p and grad page-locked, "
        f"m and v pageable, as the offloaded step): {adam_ms:.1f} ms a step "
        f"({CPU_ADAM_BYTES * n / adam_ms / 1e6:.2f} GB/s), plain version {plain_ms:.1f} ms, "
        f"{cpu_adam['library']} {library_ms:.1f} ms, bound {bound_ms:.1f} ms (28 B an element at "
        f"{rate / 1e9:.2f} GB/s, read + write: copy_ {copy_rate / 1e9:.2f}, in-place add_ "
        f"{inplace_rate / 1e9:.2f} GB/s); max abs err {err:.3e} "
        f"against the plain version (limit {CPU_ADAM_LIMIT} x (1 + |plain|))")
    root = tempfile.mkdtemp(prefix="chip_smoke_aio_")
    try:
        odirect, why = odirect_probe(root)
        usage = shutil.disk_usage(root)
        bufs = state["p"][:aio_bytes // 4].chunk(AIO_REQUESTS)  # the stepped params
        outs = [torch.empty_like(b) for b in bufs]
        handle = AsyncIOHandle(4, use_odirect=True)
        paths = [os.path.join(root, f"chunk{i}.bin") for i in range(AIO_REQUESTS)]
        t0 = time.perf_counter()
        for r in [handle.pwrite(path, b) for path, b in zip(paths, bufs)]:
            handle.wait(r)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for r in [handle.pread(path, o) for path, o in zip(paths, outs)]:
            handle.wait(r)
        read_s = time.perf_counter() - t0
        handle.close()
        if not all(torch.equal(a, b) for a, b in zip(bufs, outs)):
            raise AssertionError("[host-ops] aio read back other bytes than it wrote")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del state, args, bufs, outs
    aio = {"name": "aio", "route": "host C++ (g++, pread/pwrite thread pool)",
           "source": AIO_SOURCE, "replaces": "deepspeed_tpu/csrc/aio/aio.cpp",
           "write_gbps": aio_bytes / write_s / 1e9, "read_gbps": aio_bytes / read_s / 1e9,
           "write_ms": write_s * 1e3, "read_ms": read_s * 1e3, "odirect": odirect,
           "bytes": aio_bytes, "requests": AIO_REQUESTS, "threads": 4}
    log(f"[host-ops] aio {aio_bytes / 2**30:.0f} GiB in {AIO_REQUESTS} files under {root} (disk "
        f"{usage.total / 1e9:.1f} GB, {usage.free / 1e9:.1f} GB free; O_DIRECT {why}): write "
        f"{aio['write_gbps']:.3f} GB/s, read {aio['read_gbps']:.3f} GB/s"
        f"{'' if odirect else ' (buffered: the read is warm, from the page cache)'}")
    return {"cpu_adam": cpu_adam, "aio": aio, "host": host, "mem_total": mem}


def sample_index(n, key):
    import zlib

    import torch
    if n <= OFFLOAD_SAMPLE:
        return torch.arange(n)
    gen = torch.Generator().manual_seed(zlib.crc32(key.encode()))
    return torch.randint(0, n, (OFFLOAD_SAMPLE, ), generator=gen)


def sampled_leaves(tree):
    """Up to ``OFFLOAD_SAMPLE`` elements of every leaf, at positions seeded by
    its key, on the host."""
    from deepspeed_tpu_torch.runtime.checkpointing import flatten_with_keys
    out = {}
    for key, leaf in flatten_with_keys(tree):
        flat = leaf.detach().reshape(-1)
        out[key] = flat[sample_index(flat.numel(), key).to(flat.device)].float().cpu()
    return out


def close_shares(got, want):
    """(max abs diff, {key: share of the leaf's elements within 1e-5}, the
    share of all the elements) of ``got`` against ``want`` (dicts of host
    tensors by key)."""
    worst, shares, close, total = 0.0, {}, 0, 0
    for key, ref in want.items():
        diff = (got[key].float() - ref.float()).abs()
        worst = max(worst, float(diff.max()))
        n = int((diff <= 1e-5).sum())
        shares[key] = n / diff.numel()
        close, total = close + n, total + diff.numel()
    return worst, shares, close / total


def adam_rule(tag, got, want, lrs, pooled_share=0.999, leaf_share=0.999):
    """Every element within 2 x sum(lr), ``pooled_share`` (99.9 %) of all the
    elements and ``leaf_share`` of every leaf's within 1e-5; returns a line
    that says so."""
    limit = 2.0 * sum(lrs)
    worst, shares, pooled = close_shares(got, want)
    low = min(shares, key=shares.get)
    line = (f"max abs diff {worst:.3e} (limit {limit:.3e}), {pooled:.5%} within 1e-5 (need "
            f"{pooled_share:.1%}), least leaf {low} {shares[low]:.5%} (need {leaf_share:.1%})")
    if worst > limit or pooled < pooled_share or shares[low] < leaf_share:
        raise AssertionError(f"[{tag}] params: {line}; by leaf {shares}")
    return line


def offload_train_config(micro, gas, seed, device="cpu", pin=True, **kw):
    conf = train_config(micro=micro, gas=gas, bf16=True, seed=seed, optimizer="adamw", **kw)
    conf["zero_optimization"] = {"stage": 2, "offload_optimizer": {"device": device,
                                                                   "pin_memory": pin}}
    return conf


def phase_train_offload(card, dense, train_sample, seed=0, layers=TRAIN_LAYERS,
                        steps=OFFLOAD_STEPS, micro=2, gas=2, seq=2048, device="cuda", cfg=None):
    """[train-offload]: ``offload_optimizer: {device: cpu, pin_memory: true}``
    at [train]'s shape (Llama-2-7B width, ``layers`` layers, bf16, the
    default remat policy, micro x gas x seq, WarmupLR, clip 1.0, the same
    seed, params and batch), ``steps`` steps.  Gates: step 1's loss equals
    [train]'s bit for bit; later losses within ``LOSS_RTOL_BF16``; the
    sampled params (``train_sample``: [train]'s by step) within
    ``STEP1_PARAM_ATOL`` of [train]'s after step 1 and within the Adam rule
    (``BF16_POOLED_SHARE`` and ``BF16_LEAF_SHARE``) at step ``steps``;
    flash launches equal to [train]'s a step and no fused-AdamW launch; one
    CPU-Adam call a leaf and step.  Reports the step split, the pinning and
    peak memory beside [train]'s (the push casts on the card: PERF.md).  ``device`` and ``cfg`` (a narrower Llama) rehearse it on the
    CPU.  Returns (launch counts, summary)."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
    from deepspeed_tpu_torch.runtime.tree import tree_leaves
    tag = "train-offload"
    on_card = torch.device(device).type == "cuda"
    cfg = cfg or dataclasses.replace(llama.LlamaConfig.llama2_7b(), num_layers=layers, remat=True)
    layers = cfg.num_layers
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                               dtype=torch.float32, device=device)
    n_leaves = len(tree_leaves(params))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        loss_fn=llama.make_loss_fn(cfg), model_parameters=params, device=device,
        config=offload_train_config(micro, gas, seed))
    del params
    if on_card:
        torch.cuda.empty_cache()
    host = engine._offload_state
    setup_s = time.perf_counter() - t0
    n_params = llama.num_params(cfg)
    log(f"[{tag}] llama2_7b width x {layers} layers, {n_params / 1e9:.3f} B params; host state "
        f"{12 * n_params / 1e9:.2f} GB (fp32 p, m, v) + {4 * n_params / 1e9:.2f} GB grad staging; "
        f"pinned {host.pinned_bytes / 1e9:.2f} GB of master params in {host.pin_seconds:.2f} s; "
        f"set up in {setup_s:.2f} s; CPU-Adam threads {host.opt.threads}")
    rng = np.random.default_rng(seed)
    batch = llama.causal_lm_batch(rng.integers(0, cfg.vocab_size, (micro * gas, seq)))
    _sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    adam_before = DeepSpeedCPUAdam.launches
    losses, times, parts = [], [], []
    step1 = None
    for i in range(steps):
        t0 = time.perf_counter()
        metrics = engine.train_batch(batch)
        _sync(device)
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics.loss))
        parts.append(dict(engine.offload_times))
        if i == 0:
            step1 = sampled_leaves(engine._offload_host_state()["params"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
    launches = launch_counts()
    adam_calls = DeepSpeedCPUAdam.launches - adam_before
    expected = dict.fromkeys(KERNEL_NAMES, 0)
    if on_card:
        expected.update(flash_fwd=steps * gas * layers * 2, flash_bwd_dkdv=steps * gas * layers,
                        flash_bwd_dq=steps * gas * layers)
    if launches != expected:
        raise AssertionError(f"[{tag}] launch counts {launches} != {expected} ([train]'s flash "
                             f"launches a step, no fused AdamW)")
    if adam_calls != steps * n_leaves:
        raise AssertionError(f"[{tag}] {adam_calls} CPU-Adam calls, not {steps} x {n_leaves}")
    if losses[0] != dense["losses"][0]:
        raise AssertionError(f"[{tag}] step 1 loss {losses[0]!r} != [train]'s "
                             f"{dense['losses'][0]!r}: the same params and batch")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[1:], dense["losses"][1:steps])]
    if max(rel) > LOSS_RTOL_BF16:
        raise AssertionError(f"[{tag}] losses {losses} against [train]'s "
                             f"{dense['losses'][:steps]}: relative {rel} > {LOSS_RTOL_BF16}")
    lrs = [float(engine.lr_schedule(s)) for s in range(steps)]
    step1_diff = max(float((step1[k] - ref).abs().max()) for k, ref in train_sample[1].items())
    if step1_diff > STEP1_PARAM_ATOL:
        raise AssertionError(f"[{tag}] params after step 1 {step1_diff:.3e} from [train]'s "
                             f"(limit {STEP1_PARAM_ATOL}): the host CPU-Adam's update is not the "
                             f"fused kernel's")
    rule = adam_rule(tag, sampled_leaves(engine._offload_host_state()["params"]),
                     train_sample[steps], lrs, BF16_POOLED_SHARE, BF16_LEAF_SHARE)
    mean = {k: statistics.mean(p[k] for p in parts[1:]) * 1e3 for k in parts[0]}
    step_ms = statistics.mean(times[1:]) * 1e3
    log(f"[{tag}] {steps} steps on {card}: losses {losses} ([train]'s "
        f"{dense['losses'][:steps]}: step 1 bit for bit, then relative {max(rel):.2e} <= "
        f"{LOSS_RTOL_BF16}); params (a {OFFLOAD_SAMPLE}-element sample of each of {n_leaves} "
        f"leaves) against [train]'s: after step 1 max abs diff {step1_diff:.3e} (limit "
        f"{STEP1_PARAM_ATOL}), at step {steps} {rule}; step ms "
        f"{[round(t * 1e3, 1) for t in times]}; steps 2-{steps}: {step_ms:.1f} ms a step "
        f"([train] {dense['step_ms']:.1f} ms) = device compute {mean['compute']:.1f} + grads "
        f"to host {mean['grads_d2h']:.1f} + CPU-Adam {mean['cpu_adam']:.1f} ("
        f"{CPU_ADAM_BYTES * n_params / mean['cpu_adam'] / 1e6:.2f} GB/s) + push to the card "
        f"{mean['push_h2d']:.1f} ms; peak device memory {peak_gb:.2f} GB against [train]'s "
        f"{dense['peak_gb']:.2f} GB: {dense['peak_gb'] - peak_gb:.2f} GB lower (predicted "
        f"{OFFLOAD_PREDICTED_DROP_GB:.2f}); launches "
        f"{ {k: v for k, v in launches.items() if v} }, fused_adamw 0, CPU-Adam {adam_calls}")
    host.close()
    del engine
    if on_card:
        torch.cuda.empty_cache()
    return launches, {"step_ms": step_ms, "parts_ms": mean, "peak_gb": peak_gb,
                      "losses": losses, "cpu_adam_calls": adam_calls,
                      "cpu_adam_gbps": CPU_ADAM_BYTES * n_params / (mean["cpu_adam"] / 1e3) / 1e9,
                      "pin_s": host.pin_seconds}


def infinity_model(cfg, device):
    """(layer_fn, stem_fn, head_fn) over the port's Llama layer, as
    ``benchmarks/run_infinity_7b.py`` builds them from JAX's: caller code."""
    import torch
    from deepspeed_tpu_torch.models import llama, transformer
    dev = torch.device(device)
    attention = transformer.resolve_attention(None, dev)
    cos, sin = transformer.device_rotary_tables(cfg.hidden_size // cfg.num_heads,
                                                cfg.max_seq_len, cfg.rope_theta, str(dev))

    def layer_fn(p, x):
        return llama._layer(cfg, cos, sin, attention, x, p)

    def stem_fn(sp, tokens):
        return sp["embed"][tokens.long()]

    def head_fn(h, x, labels):
        x = transformer.rms_norm(x, h["final_norm"], cfg.rms_eps)
        return transformer.cross_entropy_loss(x @ h["lm_head"].to(x.dtype), labels)

    return layer_fn, stem_fn, head_fn


def phase_train_infinity(card, seed=0, layers=INFINITY_LAYERS, steps=INFINITY_STEPS, seq=2048,
                         device="cuda", cfg=None):
    """[train-infinity]: ``offload_param: {device: nvme, nvme_path: <temp
    dir>, buffer_count: 6}`` with ``offload_optimizer: {device: cpu}`` at
    Llama-2-7B width, ``layers`` layers, micro 1 x seq, ``steps`` steps, bf16,
    through ``initialize(layer_fn=, stem_fn=, head_fn=)``.  Gates: the losses
    within ``LOSS_RTOL_BF16`` of a resident engine over the same composition
    (stem -> layers -> head, no clipping, as the trainer) and its params
    after ``steps`` steps within the Adam rule; the swap directory holds
    parameter files only; a layer's flash launches a step are 2 forwards
    (the stream and the backward's recompute), 1 dK/dV and 1 dQ.  Reports
    disk bytes a step, the step split and peak memory.  ``device`` and
    ``cfg`` (a narrower Llama) rehearse it on the CPU.  Returns (launch
    counts, summary)."""
    import tempfile

    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
    from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
    tag = "train-infinity"
    on_card = torch.device(device).type == "cuda"
    cfg = cfg or dataclasses.replace(llama.LlamaConfig.llama2_7b(), num_layers=layers,
                                     remat=False)
    layers = cfg.num_layers
    layer_fn, stem_fn, head_fn = infinity_model(cfg, device)
    base = llama.init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                             dtype=torch.float32, device=device)
    params = {"stem": {"embed": base["embed"]}, "layers": base["layers"],
              "final_norm": base["final_norm"], "lm_head": base["lm_head"]}
    del base
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, seq))
    rows = llama.causal_lm_batch(ids)
    batch = {"x": rows["input_ids"], "y": rows["labels"]}
    conf = train_config(micro=1, gas=1, bf16=True, seed=seed, optimizer="adamw")
    conf["gradient_clipping"] = 0.0  # the streaming trainer does not clip, as JAX's

    def resident_loss(p, b, rng):
        x = stem_fn(p["stem"], b["x"])
        for l in range(layers):
            x = layer_fn({k: {n: w[l] for n, w in v.items()} if isinstance(v, dict) else v[l]
                          for k, v in p["layers"].items()}, x)
        return head_fn(p, x, b["y"])

    resident = deepspeed_tpu_torch.initialize(loss_fn=resident_loss, model_parameters=params,
                                              config=conf, device=device)[0]
    ref_losses = [float(resident.train_batch(batch).loss)
                  for _ in range(steps)]
    ref_flat = {key: leaf.detach().cpu() for key, leaf in flatten_state(resident.state.params)}
    del resident
    if on_card:
        torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_nvme_")
    try:
        zero = {"stage": 3, "offload_param": {"device": "nvme", "nvme_path": root,
                                              "buffer_count": 6},
                "offload_optimizer": {"device": "cpu"}}
        t0 = time.perf_counter()
        engine = deepspeed_tpu_torch.initialize(
            loss_fn=lambda p, b, r: 0.0, model_parameters=params,
            config=dict(conf, zero_optimization=zero), layer_fn=layer_fn, head_fn=head_fn,
            stem_fn=stem_fn, device=device)[0]
        del params
        if on_card:
            torch.cuda.empty_cache()
        setup_s = time.perf_counter() - t0
        trainer = engine._nvme_trainer
        swapper = trainer.swapper
        files = os.listdir(swapper.dir)
        if any(".m." in f or ".v." in f for f in files):
            raise AssertionError(f"[{tag}] moment files in the swap directory: {sorted(files)}")
        _sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        adam_before, aio_before = DeepSpeedCPUAdam.launches, AsyncIOHandle.requests
        losses, times, parts, io = [], [], [], []
        for _ in range(steps):
            read0, written0 = swapper.bytes_read, swapper.bytes_written
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch).loss))
            _sync(device)
            times.append(time.perf_counter() - t0)
            parts.append(dict(trainer.last_times))
            io.append((swapper.bytes_read - read0, swapper.bytes_written - written0))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
        launches = launch_counts()
        adam_calls = DeepSpeedCPUAdam.launches - adam_before
        aio_requests = AsyncIOHandle.requests - aio_before
        n_layer_leaves = len(trainer._cpu_m[0])
        if adam_calls != steps * layers * n_layer_leaves:
            raise AssertionError(f"[{tag}] {adam_calls} CPU-Adam calls, not {steps} x {layers} "
                                 f"x {n_layer_leaves}")
        expected = dict.fromkeys(KERNEL_NAMES, 0)
        if on_card:
            expected.update(flash_fwd=2 * layers * steps, flash_bwd_dkdv=layers * steps,
                            flash_bwd_dq=layers * steps)
        if launches != expected:
            raise AssertionError(f"[{tag}] launch counts {launches} != {expected} (a layer a "
                                 f"step: 2 forwards, 1 dK/dV, 1 dQ)")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        if max(rel) > LOSS_RTOL_BF16:
            raise AssertionError(f"[{tag}] losses {losses} against the resident engine's "
                                 f"{ref_losses}: relative {rel} > {LOSS_RTOL_BF16}")
        lrs = [float(engine.lr_schedule(s)) for s in range(steps)]
        got = {"params.stem.embed": trainer.stem["embed"].cpu(),
               "params.final_norm": trainer.head["final_norm"].cpu(),
               "params.lm_head": trainer.head["lm_head"].cpu()}
        got.update({f"params.layers.{k}": v for k, v in
                    flatten_state(trainer.gather_stacked_params())})
        got = {k[len("params."):]: v for k, v in got.items()}
        rule = adam_rule(tag, got, ref_flat, lrs, BF16_POOLED_SHARE, BF16_LEAF_SHARE)
        n_params = llama.num_params(cfg)
        mean = {k: statistics.mean(p[k] for p in parts[1:]) * 1e3 for k in parts[0]}
        step_ms = statistics.mean(times[1:]) * 1e3
        read_gb, write_gb = (statistics.mean(x[i] for x in io) / 1e9 for i in range(2))
        log(f"[{tag}] llama2_7b width x {layers} layers ({n_params / 1e9:.3f} B params), micro 1 "
            f"x seq {seq}, bf16, layers on disk under {root} (buffer_count 6), moments in RAM; set "
            f"up in {setup_s:.2f} s; {steps} steps on {card}: losses {losses} (resident "
            f"{ref_losses}: relative {max(rel):.2e} <= {LOSS_RTOL_BF16}); params against the "
            f"resident engine's: {rule}; step ms "
            f"{[round(t * 1e3, 1) for t in times]}; steps "
            f"2-{steps}: {step_ms:.1f} ms = stream-in {mean['stream_in']:.1f} + compute "
            f"{mean['compute']:.1f} + CPU-Adam and swap-out {mean['adam_swap_out']:.1f} ms; disk "
            f"{read_gb:.3f} GB read and {write_gb:.3f} GB written a step "
            f"({read_gb / (step_ms / 1e3):.3f} and {write_gb / (step_ms / 1e3):.3f} GB/s over "
            f"the step); peak device memory {peak_gb:.2f} GB; launches "
            f"{ {k: v for k, v in launches.items() if v} }, CPU-Adam {adam_calls}, aio requests "
            f"{aio_requests}; swap files {len(files)}, parameters only")
        swapper.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, {"step_ms": step_ms, "parts_ms": mean, "peak_gb": peak_gb,
                      "read_gb": read_gb, "write_gb": write_gb, "losses": losses,
                      "cpu_adam_calls": adam_calls, "aio_requests": aio_requests}


def phase_train_universal(card, seed=0, device="cuda", width=None, micro=2, steps=3):
    """[train-universal] at a narrow Llama (``UNIVERSAL_WIDTH``, bf16, flash
    at head dim 128): an offloaded engine trains 2 steps and saves, takes a
    third (the unbroken run); the converter's CLI entry (``universal.main``,
    what ``python -m deepspeed_tpu_torch.checkpoint.universal`` runs, here in
    process) converts the save; a resident and an offloaded engine from
    another seed, each with ``load_universal_checkpoint: true``, resume and
    take the third step.
    Gates: the resumed step's loss equals the unbroken one's within
    ``LOSS_RTOL_BF16`` and the params are within the Adam rule."""
    import tempfile

    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint import universal
    from deepspeed_tpu_torch.models import llama
    tag = "train-universal"
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(**(width or UNIVERSAL_WIDTH)), remat=True)
    seq = cfg.max_seq_len
    gen = lambda s: torch.Generator(device=device).manual_seed(s)
    rng = np.random.default_rng(seed)
    batches = [llama.causal_lm_batch(rng.integers(0, cfg.vocab_size, (micro, seq)))
               for _ in range(steps)]
    engine_of = lambda s, conf: deepspeed_tpu_torch.initialize(
        loss_fn=llama.make_loss_fn(cfg), config=conf, device=device,
        model_parameters=llama.init_params(cfg, gen(s), dtype=torch.float32, device=device))[0]
    root = tempfile.mkdtemp(prefix="chip_smoke_universal_")
    try:
        unbroken = engine_of(seed, offload_train_config(micro, 1, seed, pin=device == "cuda"))
        for b in batches[:-1]:
            unbroken.train_batch(b)
        ck = os.path.join(root, "ck")
        saved = os.path.join(ck, unbroken.save_checkpoint(ck))
        want_loss = float(unbroken.train_batch(batches[-1]).loss)
        want = {k: v.clone() for k, v in flatten_state(unbroken._offload_host_state()["params"])}
        lrs = [float(unbroken.lr_schedule(s)) for s in range(steps)]
        unbroken._offload_state.close()
        del unbroken
        uni = os.path.join(root, "universal")
        t0 = time.perf_counter()
        # the CLI's entry (what ``python -m deepspeed_tpu_torch.checkpoint.universal SAVED
        # UNI`` runs) in this process: a fresh interpreter spends seconds importing torch
        universal.main([saved, uni])
        convert_s = time.perf_counter() - t0
        lines = []
        for kind, conf in (("resident", train_config(micro=micro, gas=1, bf16=True, seed=seed,
                                                     optimizer="adamw")),
                           ("offloaded", offload_train_config(micro, 1, seed,
                                                              pin=device == "cuda"))):
            conf["load_universal_checkpoint"] = True
            engine = engine_of(seed + 1, conf)
            engine.load_checkpoint(uni)
            if engine.global_steps != steps - 1:
                raise AssertionError(f"[{tag}] {kind} resumed at step {engine.global_steps}")
            loss = float(engine.train_batch(batches[-1]).loss)
            if abs(loss - want_loss) > LOSS_RTOL_BF16 * abs(want_loss):
                raise AssertionError(f"[{tag}] {kind} resumed step loss {loss} against the "
                                     f"unbroken run's {want_loss}")
            got = dict(flatten_state(engine._master_params()))
            rule = adam_rule(tag, {k: v.cpu() for k, v in got.items()}, want, lrs)
            lines.append(f"{kind}: loss {loss!r} (unbroken {want_loss!r}), params {rule}")
            if kind == "offloaded":
                engine._offload_state.close()
            del engine
        log(f"[{tag}] Llama {UNIVERSAL_WIDTH if width is None else width} bf16 on {card}: "
            f"offloaded 2 steps, save, the CLI's main converted in {convert_s:.2f} s "
            f"({len(os.listdir(os.path.join(uni, 'zero')))} atom dirs); resumed step 3, "
            f"{'; '.join(lines)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# [train-hybrid]: RLHF's train <-> generate flip over [train]'s model, with
# LoRA adapters of rank HYBRID_RANK on attn.wq and attn.wv of every layer
HYBRID_RANK = 16
HYBRID_ALPHA = 32.0
HYBRID_PROMPTS, HYBRID_PROMPT_LEN, HYBRID_NEW = 4, 128, 64
HYBRID_STALE_LEAF = ("layers", "mlp", "w_down")  # the leaf the planted fault leaves stale


def hybrid_lora(cfg, seed, device):
    """Seeded adapters {"a": [L, in, r], "b": [L, r, out], "alpha"} on wq and wv."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    L, D = cfg.num_layers, cfg.hidden_size
    kv = cfg.num_kv_heads * (D // cfg.num_heads)

    def adapter(out):
        return {"a": torch.randn((L, D, HYBRID_RANK), generator=gen, device=device) * 0.02,
                "b": torch.randn((L, HYBRID_RANK, out), generator=gen, device=device) * 0.02,
                "alpha": HYBRID_ALPHA}

    return {"layers": {"attn": {"wq": adapter(D), "wv": adapter(kv)}}}


def hybrid_reference(engine, cfg, ids):
    """``llama.forward`` over the engine's current weights (the masters cast
    to the compute dtype, with the adapters fused the same way when the
    engine serves them fused) through ``sdpa``: the v1 engine's cached
    forward passes its attention a mask, which ``flash_attention`` hands to
    ``sdpa`` as JAX's hands it to XLA (``flash.py:389-390``), so generation
    launches no flash kernel in either package."""
    import torch
    from deepspeed_tpu_torch.models.transformer import sdpa
    from deepspeed_tpu_torch.runtime.tree import tree_map
    params = tree_map(lambda p: p.to(engine.compute_dtype), engine.state.params)
    if engine._lora is not None and engine._lora_fused:
        params = engine._fuse_lora_tree(params, engine._lora)
    from deepspeed_tpu_torch.models import llama
    with torch.no_grad():
        return llama.forward(cfg, params, torch.as_tensor(ids, device=engine.device),
                             attention_fn=sdpa)


def launches_since(before):
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def phase_train_hybrid(card, dense, seed=0, layers=TRAIN_LAYERS, micro=2, gas=2, seq=2048,
                       device="cuda", cfg=None, lr=3e-4):
    """[train-hybrid]: a ``DeepSpeedHybridEngine`` on [train]'s model, config
    and batch (Llama-2-7B width, ``layers`` layers, bf16, remat, fused AdamW,
    micro x gas x seq) with LoRA adapters (rank 16) on attn.wq and attn.wv of
    every layer.  In order: a greedy ``generate`` of 4 prompts of 128 tokens
    and 64 new ones; two train steps; the flip (timed), a prefill (timed) and
    the greedy rollouts again; fuse, unfuse, fuse; one more step.  Gates: (a)
    ``eval_forward`` equals ``llama.forward`` over the current weights cast
    to bf16 (through ``sdpa``, the attention the cached forward's masked
    call takes), bit for bit, and a planted fault (the flip leaves
    ``HYBRID_STALE_LEAF`` stale) fails that check; (b) the rollouts change
    after the steps; (c) fused logits equal a manual fuse, unfuse gives the
    base logits back and fuse again the fused ones, bit for bit; (d) one
    ``InferenceEngine`` object serves the phase; (e) the train step sees the
    base weights: one batch's loss through ``accumulate_gradients`` (no
    optimizer step) with the adapters attached equals it with them detached;
    (f) flash forward, dK/dV, dQ and fused AdamW launches by part
    (generation: none, the cached forward's attention is masked and runs
    ``sdpa``, as JAX's runs XLA; training: the step formula for the three
    steps and the two (e) passes), every one a tensor-core launch; (g) the peak at most [train]'s
    (``dense``) plus one bf16 copy of the weights, the KV cache and 1 GB,
    and the second flip's peak no higher than the first's (which allocates
    the serving buffers), the bytes held after it within 64 MiB of the
    first's.
    Then one step profiled by ``FlopsProfiler`` with its per-module table.
    Returns (launches by part, summary); ``device="cpu"`` with ``cfg`` (a
    tiny LlamaConfig) and a larger ``lr`` (a tiny model's greedy rollouts
    outlast two steps at [train]'s) rehearses it on the CPU, without the
    launch and memory gates."""
    import torch
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.profiling.flops_profiler import FlopsProfiler
    from deepspeed_tpu_torch.runtime.config import load_config
    from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine
    from deepspeed_tpu_torch.runtime.tree import tree_leaves
    on_card = torch.device(device).type == "cuda"
    if cfg is None:
        cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), num_layers=layers, remat=True)
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                               dtype=torch.float32, device=device)
    n_leaves = len(tree_leaves(params))
    lora = hybrid_lora(cfg, seed + 1, device)
    engine = DeepSpeedHybridEngine(
        loss_fn=llama.make_loss_fn(cfg), params=params,
        config=load_config(train_config(micro=micro, gas=gas, bf16=True, seed=seed, lr=lr)),
        device=device, model_module=llama, model_config=cfg, lora_params=lora)
    del params
    rng = np.random.default_rng(seed)
    batch = llama.causal_lm_batch(rng.integers(0, cfg.vocab_size, (micro * gas, seq)))
    prompts = np.random.default_rng(seed + 1).integers(1, cfg.vocab_size,
                                                       (HYBRID_PROMPTS, HYBRID_PROMPT_LEN))
    n_params = llama.num_params(cfg)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    log(f"[train-hybrid] llama2_7b width x {L} layers ({n_params / 1e9:.3f} B params), bf16, "
        f"remat, fused_adam, {micro} x {gas} x {seq} tokens a step, LoRA rank {HYBRID_RANK} on "
        f"attn.wq and attn.wv of {L} layers; set up in {time.perf_counter() - t0:.2f} s")

    def served_matches():
        served = engine.eval_forward(prompts)
        return torch.equal(served, hybrid_reference(engine, cfg, prompts)), served

    def gen():
        out = engine.generate(prompts, max_new_tokens=HYBRID_NEW, temperature=0.0)
        _sync(device)
        return out

    reset_launch_counts()
    parts = {"generate": dict.fromkeys(KERNEL_NAMES, 0), "train": dict.fromkeys(KERNEL_NAMES, 0)}

    def add(part, before):
        for k, v in launches_since(before).items():
            parts[part][k] += v

    # 1. the first flip (it builds the inference engine) and the rollouts
    held0 = torch.cuda.memory_allocated() if on_card else 0
    before = launch_counts()
    t1 = time.perf_counter()
    gen1 = gen()
    first_s = time.perf_counter() - t1
    add("generate", before)
    inf = engine._inf_engine
    flip1_peak = torch.cuda.max_memory_allocated() - held0 if on_card else 0
    held1 = torch.cuda.memory_allocated() if on_card else 0
    # 2. two train steps
    losses, times = [], []

    def step():
        b = launch_counts()
        ts = time.perf_counter()
        m = engine.train_batch(batch)
        _sync(device)
        times.append(time.perf_counter() - ts)
        losses.append(float(m.loss))
        add("train", b)

    step()
    step()
    # 3. the flip, a prefill, the rollouts again
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    t1 = time.perf_counter()
    engine._refresh_inference()
    _sync(device)
    flip_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    engine.generate(prompts, max_new_tokens=1, temperature=0.0)
    _sync(device)
    prefill_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    gen2 = gen()
    gen_s = time.perf_counter() - t1
    add("generate", before)
    flip2_peak = torch.cuda.max_memory_allocated() - held1 if on_card else 0
    held2 = torch.cuda.memory_allocated() if on_card else 0
    if np.array_equal(gen1, gen2):
        raise AssertionError("[train-hybrid] (b) the rollouts did not change after two steps")
    # 4. fuse (as attached), unfuse, fuse
    before = launch_counts()
    ok_fused, fused = served_matches()
    engine.unfuse_lora_weight()
    ok_base, base = served_matches()
    engine.fuse_lora_weight()
    fused_again = engine.eval_forward(prompts)
    add("generate", before)
    if not (ok_fused and ok_base and torch.equal(fused_again, fused)
            and not torch.equal(fused, base)):
        raise AssertionError(f"[train-hybrid] (a)/(c) served logits: fused = manual fuse "
                             f"{ok_fused}, base = llama.forward {ok_base}, fuse again "
                             f"{torch.equal(fused_again, fused)}, fused != base "
                             f"{not torch.equal(fused, base)}")
    # 5. one more step, then the planted fault: the flip skips one leaf
    step()
    write_leaf = engine._write_leaf

    def stale(path, buf, src, adapter):
        if path != HYBRID_STALE_LEAF:
            write_leaf(path, buf, src, adapter)

    before = launch_counts()
    engine._write_leaf = stale
    caught = not served_matches()[0]
    engine._write_leaf = write_leaf
    engine._params_version = -1
    ok_after, _ = served_matches()
    add("generate", before)
    if not caught or not ok_after:
        raise AssertionError(f"[train-hybrid] (a) stale {'.'.join(HYBRID_STALE_LEAF)} caught "
                             f"{caught}; fresh flip matches {ok_after}")
    # (e) the train step sees the base weights
    before = launch_counts()
    grads, with_lora = engine.accumulate_gradients(batch)
    del grads
    engine.set_lora(None)
    grads, without = engine.accumulate_gradients(batch)
    del grads
    add("train", before)
    if not torch.equal(with_lora, without):
        raise AssertionError(f"[train-hybrid] (e) loss with the adapters {float(with_lora)} != "
                             f"without {float(without)}")
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    # (d), (f), (g)
    if engine._inf_engine is not inf:
        raise AssertionError("[train-hybrid] (d) the inference engine was rebuilt")
    passes = 3 + 2  # three optimizer steps and the two (e) gradient passes
    want_gen = dict.fromkeys(KERNEL_NAMES, 0)  # masked attention: sdpa, no kernel
    want_train = expected_launches(steps=3, gas=gas, layers=L, n_leaves=n_leaves,
                                   optimizer="fused_adam", sparse=None)
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        want_train[name] = want_train[name] * passes // 3
    wrappers = _kernel_wrappers()
    tc = {name: wrappers[name].tc_launches for name in ("flash_fwd", "flash_bwd_dkdv",
                                                         "flash_bwd_dq")}
    bound_gb = dense["peak_gb"] + 2 * n_params / 1e9 + kv_cache_gb(cfg) + 1.0
    if on_card:
        total = {k: parts["generate"][k] + parts["train"][k] for k in KERNEL_NAMES}
        if (parts["generate"] != want_gen or parts["train"] != want_train
                or any(tc[k] != total[k] for k in tc)):
            raise AssertionError(f"[train-hybrid] (f) launches {parts} != generate {want_gen}, "
                                 f"train {want_train}; tensor-core {tc}")
        if peak > bound_gb or flip2_peak > flip1_peak or held2 > held1 + 2**26:
            raise AssertionError(f"[train-hybrid] (g) peak {peak:.2f} GB (bound {bound_gb:.2f}); "
                                 f"flip peaks {flip1_peak} then {flip2_peak} B; held {held1} "
                                 f"then {held2} B")
    step_s = statistics.mean(times[1:])
    decode_tps = HYBRID_PROMPTS * (HYBRID_NEW - 1) / max(gen_s - prefill_s, 1e-9)
    summary = {"step_ms": step_s * 1e3, "flip_ms": flip_s * 1e3, "prefill_ms": prefill_s * 1e3,
               "decode_tokens_s": decode_tps, "peak_gb": peak, "first_generate_s": first_s,
               "flip1_peak_b": flip1_peak, "flip2_peak_b": flip2_peak, "losses": losses}
    log(f"[train-hybrid] on {card}: losses {[round(x, 4) for x in losses]}; step ms "
        f"{[round(t * 1e3, 1) for t in times]} (steps 2-3 mean {step_s * 1e3:.1f}; [train]: "
        f"{dense['step_ms']:.1f}); the flip (cast of {n_params / 1e9:.3f} B params into the "
        f"serving buffers) {flip_s * 1e3:.1f} ms; prefill of {HYBRID_PROMPTS} x "
        f"{HYBRID_PROMPT_LEN} {prefill_s * 1e3:.1f} ms; {HYBRID_NEW} new tokens in "
        f"{gen_s * 1e3:.1f} ms: {decode_tps:.1f} decode tokens/s; first generate (builds the "
        f"engine) {first_s:.2f} s; rollouts changed at "
        f"{int((gen1 != gen2).any(axis=1).sum())} of {HYBRID_PROMPTS} prompts")
    log(f"[train-hybrid] (a) eval_forward = llama.forward (sdpa) bit for bit, fused and not; "
        f"the stale {'.'.join(HYBRID_STALE_LEAF)} caught; (c) fuse/unfuse/fuse bit for bit; (d) one "
        f"InferenceEngine; (e) loss {float(with_lora):.6f} with and without the adapters; (f) "
        f"launches generate {({k: v for k, v in parts['generate'].items() if v})}, train "
        f"{({k: v for k, v in parts['train'].items() if v})}, tensor-core {tc}; (g) peak "
        f"{peak:.2f} GB (bound {bound_gb:.2f}: [train] {dense['peak_gb']:.2f} + bf16 weights "
        f"{2 * n_params / 1e9:.2f} + KV {kv_cache_gb(cfg):.3f} + 1), flip peaks "
        f"{flip1_peak / 1e9:.3f} then {flip2_peak / 1e9:.3f} GB, held {held1 / 1e9:.3f} then "
        f"{held2 / 1e9:.3f} GB")
    # one step's count through the FLOPs profiler, and its per-module table
    profiler = FlopsProfiler(engine)
    t1 = time.perf_counter()
    res = profiler.profile_train_step(batch)
    _sync(device)
    summary["profile_s"] = time.perf_counter() - t1
    summary["profile"] = res
    table = profiler.print_model_profile(tokens=micro * gas * seq, top_k=10)
    log(f"[train-hybrid] FlopsProfiler.profile_train_step in {summary['profile_s']:.2f} s: "
        f"{res.human()} (bytes: every aten op's operands and results, unfused, plus the "
        f"kernels' own)\n" + table)
    del engine
    if on_card:
        torch.cuda.empty_cache()
    return parts, summary


def kv_cache_gb(cfg):
    """The v1 engine's bf16 KV cache for [train-hybrid]'s rollouts."""
    dh = cfg.hidden_size // cfg.num_heads
    return (2 * cfg.num_layers * HYBRID_PROMPTS * (HYBRID_PROMPT_LEN + HYBRID_NEW)
            * cfg.num_kv_heads * dh * 2 / 1e9)


def compress_config():
    """One group of each method over Llama's tree."""
    return {"weight_quantization": {"different_groups": {
                "wq": {"params": {"target_bits": 8}, "modules": ["attn\\."]}}},
            "sparse_pruning": {"different_groups": {
                "sp": {"params": {"dense_ratio": 0.5}, "modules": ["mlp\\."]}}},
            "head_pruning": {"shared_parameters": {"num_heads": 32}, "different_groups": {
                "hp": {"params": {"dense_ratio": 0.75}, "modules": ["attn\\.wo"]}}},
            "row_pruning": {"different_groups": {
                "rp": {"params": {"dense_ratio": 0.5}, "modules": ["^lm_head$"]}}},
            "channel_pruning": {"different_groups": {
                "cp": {"params": {"dense_ratio": 0.5}, "modules": ["^embed$"]}}}}


def phase_compress(card, seed=5, layers=TRAIN_LAYERS, micro=2, gas=2, seq=2048, device="cuda",
                   cfg=None, heads=32):
    """[compress]: fresh seeded fp32 params of [train]'s shapes on the card;
    ``init_compression`` with one group of each method (int8 weight
    quantization on attn.*, sparse pruning at 0.5 on mlp.*, head pruning at
    0.75 of 32 heads on attn.wo, row pruning on lm_head, channel pruning on
    embed), each method also timed alone.  Gates: the kept share of each
    mask is its target k with only threshold ties above it (#(> t) < k <=
    #(>= t)), heads within one of 24 in each layer; each quantized leaf at
    most 255 levels; leaves no group matches returned unchanged.  Then
    ``redundancy_clean`` keeps 4 of 8 teacher layers under
    ``module_name_prefix`` "layers": the student's layers equal teacher
    layers ``linspace(0, 7, 4).round()`` bit for bit, and the 4-layer
    student trains 2 steps through the kernels (finite losses, launches =
    the step formula).  Returns the student's launches."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import compression
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.runtime.checkpointing import flatten_with_paths
    on_card = torch.device(device).type == "cuda"
    if cfg is None:
        cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), num_layers=layers, remat=True)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    teacher = llama.init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                                dtype=torch.float32, device=device)
    conf = compress_config()
    conf["head_pruning"]["shared_parameters"]["num_heads"] = heads
    times = {}
    for method in conf:
        _sync(device)
        t0 = time.perf_counter()
        alone = compression.init_compression(teacher, {method: conf[method]})
        _sync(device)
        times[method] = (time.perf_counter() - t0) * 1e3
        del alone
    t0 = time.perf_counter()
    out = compression.init_compression(teacher, conf)
    _sync(device)
    times["all five"] = (time.perf_counter() - t0) * 1e3
    flat_in, flat_out = dict(flatten_with_paths(teacher)), dict(flatten_with_paths(out))
    report, bad = {}, []

    def kept_check(name, kept, scores, density):
        k = max(1, int(round(scores.numel() * density)))
        t = torch.sort(scores.reshape(-1)).values[-k]
        above = int((scores > t).sum())
        report[name] = f"{kept}/{scores.numel()} (target {k}, +{kept - k} ties)"
        if not above < k <= kept == int((scores >= t).sum()):
            bad.append(f"{name}: kept {kept}, target {k}, above the threshold {above}")

    for name in ("wq", "wk", "wv", "wo"):
        levels = int(torch.unique(flat_out[("layers", "attn", name)]).numel())
        report[f"attn.{name} levels"] = levels
        if levels > 255:
            bad.append(f"attn.{name}: {levels} levels")
    for name in ("w_gate", "w_up", "w_down"):
        w = flat_in[("layers", "mlp", name)]
        kept_check(f"mlp.{name}", int((flat_out[("layers", "mlp", name)] != 0).sum()),
                   w.abs(), 0.5)
    wo = flat_out[("layers", "attn", "wo")]
    dh = wo.shape[1] // heads
    kept_heads = (wo.reshape(wo.shape[0], heads, dh, -1) != 0).flatten(2).any(-1).sum(-1)
    report["attn.wo heads kept"] = kept_heads.tolist()
    if any(abs(int(h) - round(0.75 * heads)) > 1 for h in kept_heads):
        bad.append(f"attn.wo heads kept {kept_heads.tolist()}")
    head = flat_in[("lm_head", )]
    kept_check("lm_head rows", int((flat_out[("lm_head", )] != 0).any(0).sum()),
               head.abs().sum(0), 0.5)
    emb = flat_in[("embed", )]
    kept_check("embed channels", int((flat_out[("embed", )] != 0).any(1).sum()),
               emb.abs().sum(1), 0.5)
    untouched = [p for p in flat_in if p not in {("layers", "attn", n) for n in
                                                 ("wq", "wk", "wv", "wo")}
                 | {("layers", "mlp", n) for n in ("w_gate", "w_up", "w_down")}
                 | {("lm_head", ), ("embed", )}]
    if any(flat_out[p] is not flat_in[p] or not torch.equal(flat_out[p], flat_in[p])
           for p in untouched):
        bad.append("an untouched leaf changed")
    if bad:
        raise AssertionError(f"[compress] {bad}")
    del teacher, flat_in
    keep = np.linspace(0, cfg.num_layers - 1, 4).round().astype(int).tolist()
    t0 = time.perf_counter()
    student = compression.redundancy_clean(out, {"layer_reduction": {
        "enabled": True, "keep_number_layer": 4, "teacher_layer": cfg.num_layers,
        "module_name_prefix": "layers"}})
    _sync(device)
    times["redundancy_clean"] = (time.perf_counter() - t0) * 1e3
    for path, leaf in flatten_with_paths(student["layers"]):
        whole = flat_out[("layers", ) + path]
        if not all(torch.equal(leaf[i], whole[j]) for i, j in enumerate(keep)):
            raise AssertionError(f"[compress] student layer of {'.'.join(path)} != teacher "
                                 f"layers {keep}")
    del out, flat_out
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    scfg = dataclasses.replace(cfg, num_layers=4)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        loss_fn=llama.make_loss_fn(scfg), model_parameters=student,
        config=train_config(micro=micro, gas=gas, bf16=True, seed=seed), device=device)
    n_leaves = len(list(flatten_with_paths(student)))
    del student
    batch = llama.causal_lm_batch(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (micro * gas, seq)))
    reset_launch_counts()
    losses = [float(engine.train_batch(batch).loss) for _ in range(2)]
    _sync(device)
    launches = launch_counts()
    want = expected_launches(steps=2, gas=gas, layers=4, n_leaves=n_leaves,
                             optimizer="fused_adam", sparse=None)
    if not all(np.isfinite(losses)) or (on_card and launches != want):
        raise AssertionError(f"[compress] student losses {losses}, launches {launches} != {want}")
    log(f"[compress] llama2_7b width x {cfg.num_layers} layers fp32 on {card}: ms by method "
        f"{ {k: round(v, 1) for k, v in times.items()} } (the largest leaf "
        f"{cfg.num_layers * cfg.hidden_size * cfg.intermediate_size} elements sorted); {report}; "
        f"untouched leaves the same objects; student layers {keep} of {cfg.num_layers} bit for "
        f"bit; peak {peak:.2f} GB; student 2 steps, losses {[round(x, 4) for x in losses]}, "
        f"launches {({k: v for k, v in launches.items() if v})} = step formula")
    del engine
    if on_card:
        torch.cuda.empty_cache()
    return launches


PROFILE_WIDTH = dict(vocab=4096, hidden=512, layers=2, heads=4, kv_heads=4, seq=512)


def phase_profile(card, hybrid, seed=0, micro=2, gas=2, seq=512, layers=TRAIN_LAYERS,
                  hybrid_seq=2048):
    """[profile]: one step of a 2-layer, width-512 Llama (``PROFILE_WIDTH``,
    bf16, flash at head dim 128) profiled by ``FlopsProfiler`` on the card
    and on the CPU, both through ``flash_attention`` (the CPU runs its plain
    versions, the card's launches add theirs): FLOPs within 0.5 %.  Then
    [train-hybrid]'s profiled step (``hybrid``) against the count from its
    shapes (:func:`train_step_products`: products and the flash launches'
    plain FLOPs), within 1 %."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.attention.flash import flash_attention
    from deepspeed_tpu_torch.profiling.flops_profiler import FlopsProfiler
    cfg = llama.LlamaConfig.tiny(**PROFILE_WIDTH)
    batch = llama.causal_lm_batch(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (micro * gas, seq)))
    res = {}
    for device in ("cuda", "cpu"):
        params = llama.init_params(cfg, torch.Generator().manual_seed(seed))
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            loss_fn=llama.make_loss_fn(cfg, attention_fn=flash_attention),
            model_parameters=params,
            config=train_config(micro=micro, gas=gas, bf16=True, seed=seed), device=device)
        t0 = time.perf_counter()
        res[device] = FlopsProfiler(engine).profile_train_step(batch)
        _sync(device)
        res[device + "_s"] = time.perf_counter() - t0
        del engine
    want = train_step_products(cfg, micro, gas, seq)
    card_f, cpu_f = res["cuda"].flops, res["cpu"].flops
    big = dataclasses.replace(llama.LlamaConfig.llama2_7b(), num_layers=layers, remat=True)
    hybrid_want = train_step_products(big, micro, gas, hybrid_seq)
    hybrid_products = train_step_products(big, micro, gas, hybrid_seq, attention=False)
    got = hybrid.flops
    if (abs(card_f - cpu_f) > 0.005 * cpu_f or abs(card_f - want) > 0.01 * want
            or abs(got - hybrid_want) > 0.01 * hybrid_want):
        raise AssertionError(f"[profile] FLOPs card {card_f:.6e} vs CPU {cpu_f:.6e}; "
                             f"[train-hybrid] {got:.6e} vs {hybrid_want:.6e}")
    log(f"[profile] one step of Llama {PROFILE_WIDTH} ({micro} x {gas} x {seq}) on {card}: "
        f"FLOPs card {card_f:.6e} ({res['cuda_s']:.2f} s), CPU {cpu_f:.6e} "
        f"({res['cpu_s']:.2f} s), {(card_f - cpu_f) / cpu_f:+.2e} apart; from the shapes "
        f"{want:.6e}; bytes card {res['cuda'].bytes_accessed:.6e}, CPU "
        f"{res['cpu'].bytes_accessed:.6e}. [train-hybrid]'s step: profiled {got:.6e} FLOPs, "
        f"from the shapes {hybrid_want:.6e} ({(got - hybrid_want) / hybrid_want:+.2e}): "
        f"products {hybrid_products:.6e} + flash (4 forward + 4 recompute + 8 dK/dV + 6 dQ) "
        f"B H S^2 Dh {hybrid_want - hybrid_products:.6e} "
        f"({(hybrid_want - hybrid_products) / hybrid_products:+.2%} over the products)")


EVO_SHAPE = (128, 256, 8, 32)  # MSA rows, residues, heads, head dim
EVO_TOL = {"float32": 2e-5, "bfloat16": 2.0**-5}  # of the reference's largest magnitude


def phase_evoformer(card, seed=0, shape=EVO_SHAPE, device="cuda"):
    """[evoformer]: ``evoformer_attention`` (remat) with a mask bias
    [rows, 1, 1, S] and a pair bias [1, H, S, S] at an MSA shape of 128
    rows x 256 residues x 8 heads x 32, forward and the gradients of q, k, v
    and the pair bias, on the card in fp32 and bf16 against the CPU's fp32
    on the same (bf16-representable) inputs: within ``EVO_TOL`` of the
    reference's largest magnitude (fp32 2e-5; bf16 2^-5, eight bf16 ulps)."""
    import torch
    from deepspeed_tpu_torch.ops.attention.evoformer import evoformer_attention
    rows, s, h, d = shape
    gen = torch.Generator().manual_seed(seed)
    q, k, v, g = (torch.randn(rows, s, h, d, generator=gen).bfloat16().float()
                  for _ in range(4))
    mask = torch.where(torch.rand(rows, 1, 1, s, generator=gen) < 0.1, -1e9, 0.0)
    pair = torch.randn(1, h, s, s, generator=gen).bfloat16().float()

    def run(dev, dtype):
        ts = [t.to(dev, dtype).requires_grad_(True) for t in (q, k, v)]
        pb = pair.to(dev, dtype).requires_grad_(True)
        t0 = time.perf_counter()
        out = evoformer_attention(*ts, [mask.to(dev, dtype), pb], remat=True)
        grads = torch.autograd.grad((out * g.to(dev, dtype)).sum(), ts + [pb])
        _sync(dev)
        return [x.detach().float().cpu() for x in (out, *grads)], time.perf_counter() - t0

    ref, cpu_s = run("cpu", torch.float32)
    lines = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        run(device, dtype)  # warm-up
        got, t = run(device, dtype)
        errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, ref)]
        if max(errs) > EVO_TOL[name] or not all(bool(torch.isfinite(a).all()) for a in got):
            raise AssertionError(f"[evoformer] {name}: errors (out, dq, dk, dv, dpair) {errs} "
                                 f"over {EVO_TOL[name]}")
        lines.append(f"{name} {t * 1e3:.1f} ms, max |err| / max |ref| (out, dq, dk, dv, dpair) "
                     f"{[f'{e:.2e}' for e in errs]} <= {EVO_TOL[name]:.2e}")
    log(f"[evoformer] {rows} rows x {s} residues x {h} heads x {d}, mask and pair bias, remat, "
        f"forward + backward on {card} against the CPU's fp32 ({cpu_s:.2f} s): "
        + "; ".join(lines))


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "deepspeed_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (deepspeed_tpu_torch/ not "
              "found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    if sys.argv[1:2] == ["--serving-worker"]:
        return serving_worker(*sys.argv[2:6])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--paged-times"]:
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        return paged_times(nvidia_smi_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[setup] TF32 off for matmul and cuDNN: fp32 runs in full fp32")
    t_start = time.perf_counter()
    with torch.no_grad():
        with phase_timer("device"):
            card = phase_device()
        with phase_timer("kernel paged"):
            recs, max_err = phase_kernel(card)
    with phase_timer("kernel flash, adamw"):
        train_recs, train_errs = phase_train_kernels(card)
    with phase_timer("kernel sparse"):
        sparse_recs, sparse_errs = phase_sparse_kernels(card)
    with phase_timer("kernel adamw8bit"):
        adam8_recs, adam8_err = phase_adamw8_kernels(card)
    with torch.no_grad():
        with phase_timer("kernel quantize"):
            quant_rec = phase_quantize_kernels(card)
        with phase_timer("kernel lion"):
            lion_recs = phase_lion_kernels(card)
        with phase_timer("serve, all of its parts"):
            launches = phase_serve(card)
        with phase_timer("serve-families"):
            families = phase_serve_families(card)
        families["bloom"] = phase_serve_bloom(card)
        with phase_timer("slice"):
            phase_slice()
        with phase_timer("slice-serve"):
            phase_slice_serve()
        with phase_timer("slice-prefix"):
            phase_slice_prefix()
        with phase_timer("slice-recover"):
            phase_slice_recover()
        with phase_timer("slice-fleet"):
            phase_slice_fleet()
        with phase_timer("slice-spec"):
            phase_slice_spec()
        with phase_timer("slice-families"):
            phase_slice_families()
    train_sample = {}

    def sample_train_state(engine, step):
        if step in OFFLOAD_SAMPLED_STEPS:
            train_sample[step] = sampled_leaves(engine.state.params)

    with phase_timer("train"):
        train_launches, dense = phase_train(card, after_step=sample_train_state)
    with phase_timer("host-ops"):
        host_ops = phase_host_ops(card)
    with phase_timer("train-offload"):
        offload_launches, offload = phase_train_offload(card, dense, train_sample)
    del train_sample
    with phase_timer("train-telemetry"):
        phase_train_telemetry(card, dense)
    with phase_timer("train-remat"):
        remat_launches = phase_train_remat(card, dense)
    with phase_timer("train-data"):
        data_launches = phase_train_data(card)
    with phase_timer("train-infinity"):
        infinity_launches, infinity = phase_train_infinity(card)
    with phase_timer("train-universal"):
        phase_train_universal(card)
    with phase_timer("train-hybrid"):
        hybrid_launches, hybrid = phase_train_hybrid(card, dense)
    with phase_timer("compress"):
        compress_launches = phase_compress(card)
    with phase_timer("profile"):
        phase_profile(card, hybrid["profile"])
    with phase_timer("evoformer"):
        phase_evoformer(card)
    with phase_timer("train-8bit"):
        adam8_launches, _ = phase_train(card, tag="train-8bit", optimizer="fused_adam8bit",
                                        baseline=dense)
    with phase_timer("train-sparse"):
        sparse_launches, sparse_train = phase_train(
            card, tag="train-sparse", optimizer="fused_adam8bit", sparse=SPARSE_CONFIG, micro=1,
            gas=2, seq=4096, baseline=dense)
    with phase_timer("train-slice, train-slice-lion"):
        lion_launches = phase_train_slice(lion_step=True)
    with phase_timer("train-slice-sparse"):
        phase_train_slice(tag="train-slice-sparse", optimizer="fused_adam8bit",
                          sparse=SPARSE_CONFIG)
    with phase_timer("train-dense"):
        dense_launches, _ = phase_train_dense(card)
    with phase_timer("train-resume"):
        resume_launches, resumed = phase_train_resume(card)
    with phase_timer("train-fp16"):
        fp16_launches, _ = phase_train_fp16(
            card, {f"[train-resume] fused_adam, {RESUME_LAYERS} layers": resumed["fused_adam"]
                   ["step_ms"], f"[train] {TRAIN_LAYERS} layers": dense["step_ms"]})
    with phase_timer("serve-v1, serve-v1-int8"):
        _, quant_launches = phase_serve_v1(card)
    with phase_timer("slice-v1"):
        phase_slice_v1()
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s on {card}")
    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{"name": "paged_attention", "route": "cuda", "source": SOURCE,
                "replaces": REPLACES, "launches": launches["launches"],
                "decode_launches": launches["decode_launches"],
                "tc_launches": launches["tc_launches"], "max_abs_err": max_err,
                "serve_prefix_launches": launches["serve_prefix"],
                "serve_spec_launches": {part: launches["serve_spec"][part]["launches"]
                                        for part in ("ngram", "self")},
                **{k: recs["mistral_decode"][k] for k in fields},
                "shape": "mistral_7b decode N=32 T=1 lengths 1-4096 bf16",
                "variant": "three routes by dtype and chunk: split-K decode "
                           "(paged_decode_kernel + paged_decode_merge_kernel, CUDA cores, "
                           "cp.async) for every chunk of T < 16; tensor cores "
                           "(paged_prefill_tc_kernel, mma.sync m16n8k16, 64-row blocks of the "
                           "T x group rows, 64-key tiles, 32 at head dim 256) for bf16/fp16 "
                           "chunks of T >= 16; CUDA cores (paged_attention_kernel, fp32 only, "
                           "32-row blocks of the T x group rows) for fp32 chunks of T >= 16; "
                           "each route at head dims 32, 64, 80, 128 and 256 and any group",
                "serve_decode_n16": {k: recs["serve_decode_n16"][k] for k in PAGED_FIELDS},
                "prefill": {k: recs["mistral_prefill"][k] for k in PAGED_FIELDS},
                "llama2_decode": {k: recs["llama2_decode"][k] for k in PAGED_FIELDS},
                "llama2_prefill": {k: recs["llama2_prefill"][k] for k in PAGED_FIELDS},
                "cuda_core": {name: {k: rec[k] for k in PAGED_FIELDS}
                              for name, rec in recs.items() if name.startswith("cuda_core")},
                "moved_to_tensor_cores": {name: {k: recs[name][k] for k in PAGED_FIELDS}
                                          for name in MOVED_CASES},
                "verify": {name: {k: recs[name][k] for k in PAGED_FIELDS}
                           for name in VERIFY_CASES},
                "families": {name: {k: recs[name][k] for k in PAGED_FIELDS}
                             for name in FAMILY_CASES + PHI_FALCON_CASES + BLOOM_CASES},
                "serve_families_launches": families}]
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        kernels.append({"name": name, "route": "cuda", "source": FLASH_SOURCE,
                        "replaces": FLASH_REPLACES[name], "launches": train_launches[name],
                        "max_abs_err": train_errs[name],
                        **{k: train_recs[name][k] for k in fields},
                        "shape": "B=2 S=2048 H=KV=32 D=128 bf16 causal",
                        "bert_noncausal": {k: train_recs[f"{name}_bert"][k] for k in fields},
                        "bert_shape": "B=8 S=512 H=KV=12 D=64 bf16 non-causal",
                        "phi2": {k: train_recs[f"{name}_phi"][k] for k in fields},
                        "phi2_shape": "B=2 S=2048 H=KV=32 D=80 bf16 causal",
                        "gptj": {k: train_recs[f"{name}_gptj"][k] for k in fields},
                        "gptj_shape": "B=2 S=2048 H=KV=16 D=256 bf16 causal",
                        "head_dims": [64, 80, 128, 256],
                        "train_dense_launches": {key: dense_launches[key][name]
                                                 for key in dense_launches},
                        "train_resume_launches": {opt: resume_launches[opt][name]
                                                  for opt in resume_launches},
                        "train_fp16_launches": fp16_launches[name],
                        "train_remat_launches": {policy: remat_launches[policy][name]
                                                 for policy in remat_launches},
                        "train_data_launches": data_launches[name],
                        "train_offload_launches": offload_launches[name],
                        "train_infinity_launches": infinity_launches[name],
                        "train_hybrid_launches": {part: hybrid_launches[part][name]
                                                  for part in hybrid_launches},
                        "compress_student_launches": compress_launches[name],
                        "variant": FLASH_VARIANTS[name]})
    adam = train_recs["fused_adamw"]
    kernels.append({"name": "fused_adamw", "route": "cuda", "source": ADAM_SOURCE,
                    "replaces": ADAM_REPLACES, "launches": train_launches["fused_adamw"],
                    "max_abs_err": train_errs["fused_adamw"], **{k: adam[k] for k in fields},
                    "shape": f"n={W_GATE} (the stacked w_gate leaf of [train]) fp32 p/m/v, "
                             f"fp32 grad",
                    "train_dense_launches": {key: dense_launches[key]["fused_adamw"]
                                             for key in dense_launches},
                    "train_resume_launches": resume_launches["fused_adam"]["fused_adamw"],
                    "train_fp16_launches": fp16_launches["fused_adamw"],
                    "train_remat_launches": {policy: remat_launches[policy]["fused_adamw"]
                                             for policy in remat_launches},
                    "train_data_launches": data_launches["fused_adamw"],
                    "train_offload_launches": offload_launches["fused_adamw"],
                    "train_hybrid_launches": hybrid_launches["train"]["fused_adamw"],
                    "compress_student_launches": compress_launches["fused_adamw"],
                    "bf16_grad": {k: train_recs["fused_adamw_bf16_grad"][k] for k in fields}})
    for name in ("sparse_fwd", "sparse_bwd_dkdv", "sparse_bwd_dq"):
        kernels.append({"name": name, "route": "cuda", "source": SPARSE_SOURCE,
                        "replaces": SPARSE_REPLACES[name], "launches": sparse_launches[name],
                        "max_abs_err": sparse_errs[name],
                        **{k: sparse_recs[name][k] for k in fields},
                        "shape": "B=1 S=4096 H=KV=32 D=128 bf16 causal, fixed layout block 16 "
                                 "([train-sparse]'s)",
                        "variant": "tensor cores for bf16/fp16 (mma.sync m16n8k16, gathered "
                                   "64-position tiles, longest walks first), CUDA cores for fp32",
                        "tc_launches": sparse_train["tc_launches"][name]})
    adam8 = adam8_recs["adamw8bit"]
    kernels.append({"name": "adamw8bit", "route": "cuda", "source": ADAM8_SOURCE,
                    "replaces": ADAM8_REPLACES, "launches": adam8_launches["adamw8bit"],
                    "train_resume_launches": resume_launches["fused_adam8bit"]["adamw8bit"],
                    "max_abs_err": adam8_err, **{k: adam8[k] for k in fields},
                    "shape": f"n={W_GATE} (the stacked w_gate leaf of [train-8bit]) fp32 p, int8 "
                             f"m/sqrt(v), fp32 grad",
                    "bf16_grad": {k: adam8_recs["adamw8bit_bf16_grad"][k] for k in fields}})
    lion = lion_recs["fused_lion"]
    kernels.append({"name": "fused_lion", "route": "cuda", "source": ADAM_SOURCE,
                    "replaces": LION_REPLACES, "launches": lion_launches,
                    "max_abs_err": lion["max_abs_err"], **{k: lion[k] for k in fields},
                    "shape": f"n={W_GATE} (the stacked w_gate leaf of [train]) fp32 p/m, fp32 "
                             f"grad",
                    "bf16_grad": {k: lion_recs["fused_lion_bf16_grad"][k] for k in fields}})
    kernels.append({"name": "quantize_int8", "route": "cuda", "source": QUANT_SOURCE,
                    "replaces": QUANT_REPLACES, "launches": quant_launches,
                    "max_abs_err": quant_rec["max_abs_err"], **{k: quant_rec[k] for k in fields},
                    "shape": f"n={W_GATE_FULL} (Llama-2-7B's stacked w_gate leaf) bf16, groups "
                             f"of 2048"})
    # the host libraries of the offload paths: not TPU kernels, so a line of their own
    host_ops["cpu_adam"].update(train_offload_launches=offload["cpu_adam_calls"],
                                train_offload_gbps=offload["cpu_adam_gbps"],
                                train_infinity_launches=infinity["cpu_adam_calls"])
    host_ops["aio"].update(train_infinity_requests=infinity["aio_requests"])
    log("[host-ops] " + json.dumps({"host": host_ops["host"],
                                    "host_ops": [host_ops["cpu_adam"], host_ops["aio"]]}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

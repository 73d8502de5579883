"""One-off measurements on the card for the offload phases of ``chip_smoke.py``.

    python3 offload_probe.py [PART ...]      (default: every part, in this order)

witness     what the gate ``BF16_CLOSE_SHARE`` of [train-offload] and
            [train-infinity] rests on: two resident [train] runs (Llama-2-7B
            width, 8 layers, bf16, fused AdamW, the smoke's seed and batch)
            whose fp32 masters after step 1 differ by one ulp in every element
            (up or down at random), read at step 3 leaf by leaf through the
            smoke's sample of each leaf; beside it a planted fault, each leaf
            in turn left at its step-1 value.
cpu-adam    ``DeepSpeedCPUAdam`` over the 8-layer w_gate leaf with its four
            buffers made in several ways, to find why [host-ops] and the
            offloaded step ran it at different rates.
cast        where the offloaded step's push casts: the w_gate leaf's fp32
            master, page-locked on the host, into its bf16 copy on the card,
            cast on the card (fp32 over PCIe) or on the host (bf16 over PCIe
            from pageable memory).
phases      the smoke's [host-ops], [train-offload], [train-infinity] and
            [train-universal] as ``chip_smoke.py`` runs them, after the
            witness's first [train] run.
full-depth  Llama-2-7B at its 32 layers, micro 1 x gas 1 x seq 2048, under
            ``offload_optimizer: {device: cpu, pin_memory: true}``, 2 steps,
            when the host's MemAvailable holds the host state (16 B a param);
            otherwise it says why and runs nothing.

Run it from a checkout of the repository on a machine with one CUDA card.  A
part that fails prints its traceback and the next part runs; the exit code
is 1 if any failed.
"""

import os
import statistics
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

PARTS = ("witness", "cpu-adam", "cast", "phases", "full-depth")
log = cs.log


def witness(card, shared):
    """The per-leaf shares within 1e-5 at step 3 of two runs one ulp apart
    after step 1, and of a leaf not updated after step 1."""
    import torch
    from deepspeed_tpu_torch.runtime.tree import tree_leaves
    samples = {"a": {}, "b": {}}

    def sampler(run, nudge):
        def after(engine, step):
            if step in cs.OFFLOAD_SAMPLED_STEPS:
                samples[run][step] = cs.sampled_leaves(engine.state.params)
            if nudge and step == 1:
                gen = torch.Generator(device="cuda").manual_seed(7)
                inf = torch.tensor(float("inf"), device="cuda")
                for leaf in tree_leaves(engine.state.params):
                    up = torch.rand(leaf.shape, generator=gen, device="cuda") < 0.5
                    leaf.copy_(torch.nextafter(leaf, torch.where(up, inf, -inf)))
                    del up
        return after

    _, dense = cs.phase_train(card, after_step=sampler("a", False))
    shared.update(dense=dense, train_sample=samples["a"])
    cs.phase_train(card, steps=3, tag="train-witness", after_step=sampler("b", True))
    a3, b3, a1 = samples["a"][3], samples["b"][3], samples["a"][1]
    worst, shares, pooled = cs.close_shares(b3, a3)
    sizes = {k: v.numel() for k, v in a3.items()}
    total = sum(sizes.values())
    log(f"[witness] {card}: [train] twice, the second's fp32 masters moved one ulp (random "
        f"direction) in every element after step 1; at step 3, sampled leaves ({sizes}): max abs "
        f"diff {worst:.3e}; share within 1e-5 by leaf {shares}; least "
        f"{min(shares.values()):.5%}; pooled {pooled:.5%}")
    _, fault, _ = cs.close_shares(a1, a3)
    for key in sorted(sizes, key=sizes.get):
        pooled = (sum(shares[k] * sizes[k] for k in sizes if k != key)
                  + fault[key] * sizes[key]) / total
        log(f"[witness] planted fault: {key} ({sizes[key]} sampled of {total}) left at its step-1 "
            f"value: that leaf {fault[key]:.5%} within 1e-5, pooled over every leaf {pooled:.5%}")


def cpu_adam_variants(card, n=cs.W_GATE):
    """DeepSpeedCPUAdam's median of 8 steps over ``n`` elements (after one
    warm step) with its buffers made each way in turn, each step's time
    beside it."""
    import torch
    from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam, default_threads
    from deepspeed_tpu_torch.runtime.swap_tensor.optimizer_swapper import flat_views, host_buffer
    thp = quota = "unknown"
    if os.path.exists("/sys/kernel/mm/transparent_hugepage/enabled"):
        with open("/sys/kernel/mm/transparent_hugepage/enabled") as fh:
            thp = fh.read().strip()
    with open("/proc/self/maps") as fh:
        gomp = sorted({line.split()[-1] for line in fh if "gomp" in line})
    if os.path.exists("/sys/fs/cgroup/cpu.max"):
        with open("/sys/fs/cgroup/cpu.max") as fh:
            quota = fh.read().strip()
    with open("/proc/loadavg") as fh:
        load = fh.read().strip()
    log(f"[cpu-adam] {card}; transparent hugepages {thp}; OpenMP runtimes mapped {gomp}; "
        f"torch threads {torch.get_num_threads()}, library threads {default_threads()}; cgroup "
        f"cpu.max {quota}; loadavg {load}; threads in this process {len(os.listdir('/proc/self/task'))}")
    m = cs.seeded_normal(n, 2, "cuda", scale=0.01)
    dev = [cs.seeded_normal(n, 1, "cuda"), m,
           cs.seeded_normal(n, 3, "cuda", scale=1e-4, positive=True).addcmul_(m, m),
           cs.seeded_normal(n, 4, "cuda")]
    in_step = [dev[0], torch.zeros_like(m), torch.zeros_like(m), dev[3] * 2e-5]
    del m
    small = torch.ones(1 << 24)

    def timed(label, bufs, src=dev, before=None, runs=8, threads=None):
        if src is not None:
            for b, d in zip(bufs, src):
                b.copy_(d)
            torch.cuda.synchronize()
        steps = iter(range(1, 100))
        run = DeepSpeedCPUAdam(threads=threads, **cs.CPU_ADAM_HYPER)

        def call():
            if before is not None:
                before()
            t0 = time.perf_counter()
            run.step(*bufs, step=next(steps))
            return time.perf_counter() - t0

        call()
        times = [call() * 1e3 for _ in range(runs)]
        ms = statistics.median(times)
        log(f"[cpu-adam] {label}: {ms:.1f} ms ({cs.CPU_ADAM_BYTES * n / ms / 1e6:.2f} GB/s); "
            f"steps {[round(t, 1) for t in times]} ms")

    def step_layout():
        bufs = flat_views(host_buffer(2 * n, True), {"p": n, "g": n})
        return [bufs["p"], torch.zeros(n), torch.zeros(n), bufs["g"]]

    timed("step layout (p, g page-locked flat; m, v torch.zeros), [host-ops]' values",
          step_layout())
    timed("step layout, the offloaded step's magnitudes (m = v = 0 at step 1, g 2e-5 x N)",
          step_layout(), src=in_step)
    timed("all four page-locked, one flat buffer",
          list(flat_views(host_buffer(4 * n, True), dict.fromkeys("pmvg", n)).values()))
    timed("all four pageable, torch.empty", [torch.empty(n) for _ in range(4)])
    timed("all four pageable, torch.zeros", [torch.zeros(n) for _ in range(4)])
    timed("pageable: .cpu() of the card's tensors, then clone()",
          [d.cpu().clone() for d in dev], src=None)
    timed("clone()d, a 64 MiB torch add_ on the host before each step",
          [d.cpu().clone() for d in dev], src=None, before=lambda: small.add_(1.0))
    timed("step layout, 7 library threads (one core left)", step_layout(), threads=7)
    timed("step layout again (drift)", step_layout())


def cast_placement(card, n=cs.W_GATE):
    """The push of one leaf both ways, median of 5 after one."""
    import torch
    from deepspeed_tpu_torch.runtime.swap_tensor.optimizer_swapper import host_buffer
    src = host_buffer(n, True).copy_(cs.seeded_normal(n, 1, "cuda"))
    leaf = torch.empty(n, dtype=torch.bfloat16, device="cuda")

    def on_card():
        leaf.copy_(src, non_blocking=True)
        torch.cuda.synchronize()

    def on_host():
        leaf.copy_(src.to(torch.bfloat16))
        torch.cuda.synchronize()

    card_ms, host_ms = cs.host_ms(on_card, runs=5), cs.host_ms(on_host, runs=5)
    log(f"[cast] {card}: the w_gate leaf ({n} fp32, page-locked) into its bf16 copy on the card: "
        f"cast on the card {card_ms:.1f} ms ({4 * n / card_ms / 1e6:.2f} GB/s over PCIe), cast on "
        f"the host {host_ms:.1f} ms")


def phases(card, shared):
    if "dense" not in shared:
        witness(card, shared)
    for tag, run in (("host-ops", lambda: cs.phase_host_ops(card)),
                     ("train-offload", lambda: cs.phase_train_offload(
                         card, shared["dense"], shared["train_sample"])),
                     ("train-infinity", lambda: cs.phase_train_infinity(card)),
                     ("train-universal", lambda: cs.phase_train_universal(card))):
        with cs.phase_timer(tag):
            try:
                run()
            except Exception:  # the next phase runs all the same
                log(f"[{tag}] FAILED\n{traceback.format_exc()}")
                shared["failed"] = True


def full_depth(card, seed=0, steps=2, seq=2048):
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama
    cfg = llama.LlamaConfig.llama2_7b()
    n_params = llama.num_params(cfg)
    need = 16 * n_params
    host, _ = cs.host_line()
    with open("/proc/meminfo") as fh:
        avail = next(int(line.split()[1]) * 1024 for line in fh
                     if line.startswith("MemAvailable"))
    log(f"[full-depth] {card}; host {host}, MemAvailable {avail / 1e9:.1f} GB; Llama-2-7B "
        f"{n_params / 1e9:.3f} B params need {12 * n_params / 1e9:.1f} GB of fp32 p, m, v and "
        f"{4 * n_params / 1e9:.1f} GB of grad staging on the host ({need / 1e9:.1f} GB)")
    if need > 0.9 * avail:
        log(f"[full-depth] not run: {need / 1e9:.1f} GB of host state > 90 % of MemAvailable "
            f"{avail / 1e9:.1f} GB")
        return
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                               dtype=torch.float32, device="cuda")
    engine = deepspeed_tpu_torch.initialize(loss_fn=llama.make_loss_fn(cfg),
                                            model_parameters=params,
                                            config=cs.offload_train_config(1, 1, seed))[0]
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batch = llama.causal_lm_batch(np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                                       (1, seq)))
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch).loss))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"[full-depth] {steps} steps: losses {losses}, step ms "
        f"{[round(t * 1e3, 1) for t in times]}, last split {engine.offload_times}, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("offload_probe: no CUDA device", file=sys.stderr)
        return 2
    parts = sys.argv[1:] or list(PARTS)
    unknown = sorted(set(parts) - set(PARTS))
    if unknown:
        print(f"offload_probe: unknown parts {unknown}; choose from {PARTS}", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    t0 = time.perf_counter()
    card_parts = set(parts) - {"cpu-adam", "cast"}
    _build.build_all((("flash_attention", "fused_adam") if card_parts else ()) + cs.HOST_SOURCES)
    log(f"[probe] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; libraries "
        f"built in {time.perf_counter() - t0:.1f} s")
    shared = {}
    runs = {"witness": lambda: witness(card, shared), "cpu-adam": lambda: cpu_adam_variants(card),
            "cast": lambda: cast_placement(card), "phases": lambda: phases(card, shared),
            "full-depth": lambda: full_depth(card)}
    for part in parts:
        with cs.phase_timer(part):
            try:
                runs[part]()
            except Exception:
                log(f"[{part}] FAILED\n{traceback.format_exc()}")
                shared["failed"] = True
    return 1 if shared.get("failed") else 0


if __name__ == "__main__":
    sys.exit(main())

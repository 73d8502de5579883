"""Per-bucket programs of the serving fast path: CUDA graphs on the card.

Counterpart of the JAX engine's bucket compiles (``_compiled_fwd`` /
``_aot_compile_fwd`` and ``_compiled_burst`` in
``deepspeed_tpu/inference/v2/engine_v2.py``): where XLA compiles one program
per ``(n, t, b)`` bucket, the port captures the bucket's forward once into a
CUDA graph and replays it at every step that lands in the bucket, so a
32-layer forward costs one launch on the host instead of several hundred.

A program is a function of static tensors: the bucket's persistent batch
buffers (``fastpath.DeviceBatchState``) or the burst's own inputs, the
params and the KV pool, all of which keep their addresses.  Building one on
the card:

- saves the static inputs, neutralizes them (``n_tokens`` 0, block tables
  all trash) and runs the function once on a side stream.  That warm-up
  executes for real: it fills the rotary-table cache, builds the kernel
  library and sets cuBLAS up before capture, and with neutral rows its only
  KV writes land in the trash block;
- captures the function on the same stream into a graph that draws its
  memory from one pool shared by every bucket (replays are serialized on one
  stream, so their scratch may alias);
- restores the static inputs, and restores the kernel wrappers' launch
  counters, which the warm-up and the capture bumped in Python: a replay
  adds the launches the capture recorded, so the counts equal the kernels
  the card actually ran on the serving path.

A replay overwrites the graph's outputs, so a caller consumes them (in
stream order) before the next replay of the same graph and keeps nothing of
them across steps.  A capture that fails raises: there is no eager fallback
on the card.  On the CPU (and in the reference loop) a program is the eager
function itself; its first use is its build.  Every build is recorded in the
engine's compile ledger, and then handed to the engine's ``on_build(site,
key)`` hook (the counterpart of the JAX engine's cost capture at its AOT
compile: the engine notes a ``"fwd"`` bucket's cost for the roofline there).
"""

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ...ops.attention.paged import paged_attention

# kernel-wrapper launch counters that a graph replay must advance
LAUNCH_COUNTERS = ((paged_attention, ("launches", "tc_launches", "decode_launches")), )


def _read_counters() -> Dict[Tuple[object, str], int]:
    return {(fn, name): getattr(fn, name) for fn, names in LAUNCH_COUNTERS for name in names}


def _write_counters(values: Dict[Tuple[object, str], int]) -> None:
    for (fn, name), v in values.items():
        setattr(fn, name, v)


class BucketProgram:
    """One bucket's program: ``program()`` replays its graph (adding the
    launches the capture recorded) and returns its static outputs, or runs
    the eager function where there is no graph."""

    def __init__(self, fn: Callable, graph=None, outputs=None,
                 launches: Optional[Dict[Tuple[object, str], int]] = None):
        self.fn = fn
        self.graph = graph
        self.outputs = outputs
        self.launches = launches or {}

    def __call__(self):
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        for (fn, name), d in self.launches.items():
            setattr(fn, name, getattr(fn, name) + d)
        return self.outputs


class BucketPrograms:
    """The engine's program cache, keyed ``(site, key)``: ``("fwd", (n, t,
    b))`` for a stepwise bucket forward, ``("burst", (n, b))`` for one step
    of a decode burst, ``("spec_verify", (n, k, b, sample_cfg))`` for a
    speculative verify and ``("draft", ...)`` for a draft model's catch-up
    and step.  ``graphs`` selects capture (the fast path on the card) over
    eager functions.  ``on_build(site, key)``, when given, runs
    once after each build."""

    def __init__(self, ledger, device, graphs: bool,
                 on_build: Optional[Callable[[str, object], None]] = None):
        self.ledger = ledger
        self.device = torch.device(device)
        self.graphs = graphs
        self.on_build = on_build
        self._programs: Dict[Tuple[str, object], BucketProgram] = {}
        self._pool = None
        self._stream = None

    def __contains__(self, site_key) -> bool:
        return site_key in self._programs

    def keys(self, site: str):
        return [key for s, key in self._programs if s == site]

    def get(self, site: str, key, make: Callable, *, prewarmed: bool = False) -> BucketProgram:
        """The program for ``(site, key)``, built on first use from
        ``make() -> (fn, static_inputs, neutralize)``."""
        prog = self._programs.get((site, key))
        if prog is None:
            fn, static, neutralize = make()
            t0 = time.perf_counter()
            prog = self._capture(fn, static, neutralize) if self.graphs else BucketProgram(fn)
            self.ledger.record(site, key, wall_s=time.perf_counter() - t0, prewarmed=prewarmed)
            self._programs[(site, key)] = prog
            if self.on_build is not None:
                self.on_build(site, key)
        return prog

    def _capture(self, fn: Callable, static: Sequence[torch.Tensor],
                 neutralize: Callable) -> BucketProgram:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        saved = [t.clone() for t in static]
        neutralize()
        counts = _read_counters()
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            fn()  # warm-up on neutral rows: caches, kernel library, cuBLAS
        current.wait_stream(self._stream)
        warm = _read_counters()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            outputs = fn()
        captured = _read_counters()
        _write_counters(counts)
        for t, s in zip(static, saved):
            t.copy_(s)
        torch.cuda.synchronize(self.device)
        launches = {c: captured[c] - warm[c] for c in captured if captured[c] != warm[c]}
        return BucketProgram(fn, graph, outputs, launches)

    def pool_bytes(self) -> Optional[int]:
        """Device bytes the shared graph pool holds (its segments in the
        caching allocator), None where this torch's memory snapshot does not
        name a segment's pool."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        total, named = 0, False
        for seg in torch.cuda.memory_snapshot():
            if "segment_pool_id" in seg:
                named = True
                if tuple(seg["segment_pool_id"]) == pool:
                    total += seg["total_size"]
        return total if named else None

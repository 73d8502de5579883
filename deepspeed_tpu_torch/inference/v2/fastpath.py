"""Serving fast path: device-resident batch state and deferred host syncs.

Counterpart of ``deepspeed_tpu/inference/v2/fastpath.py``.  The reference
step rebuilds the whole padded batch on the host every step (four uploads)
and blocks on the sampled tokens before it can schedule the next step.  This
module holds the host-link pieces the engine's fast path composes:

- :class:`DeviceBatchState` keeps persistent device buffers per
  ``(n_seqs, chunk, table_width)`` bucket (tokens, n_tokens, start_pos, block
  tables) and updates them with ONE packed upload and one scatter of the rows
  that changed since the bucket's last step.  The buffers keep their
  addresses (every write is in place), so they are the static inputs of the
  bucket's captured CUDA graph (``cuda_graphs.py``).
- :class:`DeferredTokens` is the handle to one step's sampled tokens still on
  the device.  The engine appends :data:`PENDING_TOKEN` placeholders at
  dispatch and patches them when the handle is materialized: one step later
  in the pipelined serve loop, at once in the synchronous ``step()`` API.
  :func:`materialize` is the one place v2 serving converts a device value to
  the host.
- :class:`DeferredRuns` is its variable-length sibling for speculative
  decoding: one verify round's packed accept runs, absorbed in one sync.
- :class:`ServeCounters` counts host syncs, dispatches, uploads and builds,
  which is what the fast-path tests assert on.

Nothing here schedules or owns sequences: that stays in the scheduler and the
ragged manager.  The JAX module's mesh placement (tensor-parallel serving) is
not ported yet.
"""

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# host-side placeholder for a sampled-but-not-yet-fetched token.  Negative so
# it can never collide with a real vocab id; it only ever appears as the LAST
# entry of a live sequence's token list between dispatch and materialize.
PENDING_TOKEN = -1

# device-side mirror sentinel for a token slot that is fed on the device from
# the previous step's sampled tokens (the host never knows the value, so the
# mirror records "fed" instead of a real id and the diff never re-uploads it)
FED_SENTINEL = np.int32(-(2**31) + 1)


class ServeCounters:
    """Lifetime counters for the serve loop's host-link behaviour.

    ``host_syncs``   device->host materializations (the expensive round trips)
    ``dispatches``   program launches (forward / pick / burst / scatter / feed)
    ``uploads``      host->device transfers issued
    ``upload_ints``  int32 elements moved host->device by those transfers
    ``compiles``     bucket programs built so far (``monitor/perf.py``)
    ``loop_iterations`` serve-loop iterations observed
    ``step_tokens`` / ``burst_tokens``  tokens emitted stepwise vs fused
    ``flushes``      pipeline flushes forced by wave boundaries
    ``spec_rounds`` / ``spec_proposed`` / ``spec_accepted``  speculative
    decoding's verify rounds, draft tokens proposed and draft tokens accepted
    """

    FIELDS = ("host_syncs", "dispatches", "uploads", "upload_ints", "compiles",
              "loop_iterations", "step_tokens", "burst_tokens", "flushes",
              "spec_rounds", "spec_proposed", "spec_accepted")

    def __init__(self):
        for f in self.FIELDS:
            setattr(self, f, 0)

    def snapshot(self) -> Dict[str, int]:
        return {f: int(getattr(self, f)) for f in self.FIELDS}

    def delta_since(self, snap: Dict[str, int]) -> Dict[str, int]:
        return {f: int(getattr(self, f)) - snap.get(f, 0) for f in self.FIELDS}


def materialize(dev_tensor: torch.Tensor,
                counters: Optional[ServeCounters] = None, *,
                copy: Optional[Tuple[torch.Tensor, object]] = None) -> np.ndarray:
    """THE device->host sync for v2 serving step results: every fetch of
    sampled tokens and done masks funnels through here, so it is counted.

    ``copy`` is ``(pinned host tensor, CUDA event)`` of a copy already on
    the stream (``DeferredTokens`` starts it at dispatch): the sync then
    waits for that copy alone, not for whatever the stream ran after it."""
    if counters is not None:
        counters.host_syncs += 1
    if copy is not None:
        host, ready = copy
        ready.synchronize()
        return host.numpy()
    return dev_tensor.cpu().numpy()


def pinned_copy(dev_tensor) -> Optional[Tuple[torch.Tensor, object]]:
    """On the card, enqueue ``dev_tensor``'s copy to pinned host memory with
    an event after it: ``(host tensor, event)`` for :func:`materialize` to
    wait on, so the sync waits for this copy alone and not for whatever the
    stream runs after it.  None elsewhere."""
    if not (isinstance(dev_tensor, torch.Tensor) and dev_tensor.is_cuda):
        return None
    host = torch.empty(dev_tensor.shape, dtype=dev_tensor.dtype, pin_memory=True)
    host.copy_(dev_tensor, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


@dataclasses.dataclass
class DeferredTokens:
    """Handle to one dispatched step's sampled tokens still on the device.

    ``toks_dev`` is this step's own tensor (a fresh output of the pick, never
    a buffer a later step or graph replay writes into).  ``emits`` holds
    ``(uid, position_in_seq_tokens, batch_row)`` for every sequence that
    produced a next token this step; those positions hold
    :data:`PENDING_TOKEN` until :meth:`patch`.  ``row_of`` maps uid -> batch
    row for feeding the NEXT step's input tokens on the device.

    ``tracer`` (``monitor/tracing.py`` ``RequestTracer``): the first
    :meth:`patch` is the moment this step's tokens become host-visible,
    exactly where per-request TTFT/TBT marks belong.  They are reported once
    although ``patch()`` itself is idempotent (the burst path pre-patches the
    in-flight handle and the serve loop settles it again).

    ``journal`` (``journal.py`` ``RequestJournal``): the same host-visibility
    moment is where emitted tokens enter the durable request journal's
    buffer — tokens the journal never saw die with a crash and are
    regenerated identically from the journaled prefix, so buffering at this
    seam adds no device sync and no extra fetch.

    On the card the tokens' copy to pinned host memory is enqueued at
    construction, right behind the step's pick, with an event after it:
    :meth:`wait` waits for that copy, not for the next step the serve loop
    has dispatched meanwhile (as a JAX fetch waits for its own array), so
    the host absorbs step N-1 while the device runs step N.
    """
    toks_dev: object
    emits: List[Tuple[int, int, int]]
    row_of: Dict[int, int]
    counters: Optional[ServeCounters] = None
    tracer: Optional[object] = None
    journal: Optional[object] = None
    _cached: Optional[np.ndarray] = None
    _trace_reported: bool = False
    _copy: Optional[Tuple[torch.Tensor, object]] = None

    def __post_init__(self):
        self._copy = pinned_copy(self.toks_dev)

    def wait(self) -> np.ndarray:
        """Materialize the sampled tokens (idempotent)."""
        if self._cached is None:
            self._cached = materialize(self.toks_dev, self.counters, copy=self._copy)
        return self._cached

    def patch(self, manager) -> Dict[int, int]:
        """Write the real token values over the placeholders and return the
        ``{uid: token}`` map of sequences that emitted this step.  Sequences
        that vanished (retired or evicted mid-flight) are skipped, and so are
        those whose placeholder was truncated (finish overshoot): the patch
        keys on the recorded position still holding :data:`PENDING_TOKEN`."""
        toks = self.wait()
        out: Dict[int, int] = {}
        for uid, pos, row in self.emits:
            seq = manager.seqs.get(uid)
            if seq is None:
                continue
            tok = int(toks[row])
            if pos < len(seq.tokens) and seq.tokens[pos] == PENDING_TOKEN:
                seq.tokens[pos] = tok
            out[uid] = tok
        if not self._trace_reported and (self.tracer is not None
                                         or self.journal is not None):
            self._trace_reported = True  # patch() is idempotent; the marks are not
            if self.tracer is not None:
                self.tracer.event("absorb", tokens=len(out))
                self.tracer.on_tokens_map(out)
            if self.journal is not None:
                self.journal.note_token_map(out)
        return out

    def drop_emit(self, uid: int) -> None:
        """Forget a uid's pending emit (its overshoot token was truncated)."""
        self.emits = [e for e in self.emits if e[0] != uid]
        self.row_of.pop(uid, None)


@dataclasses.dataclass
class DeferredRuns:
    """Handle to one speculative verify round's packed accept runs still on
    the device: the variable-length sibling of :class:`DeferredTokens`.

    ``packed_dev`` holds ``[n, k+2]`` int32 rows ``[count | e_0 .. e_k]``
    from the verify's rejection sampler: row i emits its first ``count``
    tokens (1 <= count <= k+1, the accepted draft prefix plus one corrected
    or bonus token).  The count and the run ride the SAME tensor, so a whole
    round costs one counted :func:`materialize`, whatever the per-sequence
    acceptance lengths.  On the card its copy to pinned memory is enqueued
    at construction, right behind the verify, and the fetch waits on that
    copy's event alone.

    ``uids`` maps batch row -> sequence uid for the live rows; padded rows
    beyond ``len(uids)`` carry garbage runs and are never read.
    """
    packed_dev: object
    uids: List[int]
    counters: Optional[ServeCounters] = None
    _cached: Optional[np.ndarray] = None
    _copy: Optional[Tuple[torch.Tensor, object]] = None

    def __post_init__(self):
        self._copy = pinned_copy(self.packed_dev)

    def wait(self) -> np.ndarray:
        """Materialize the packed accept runs (idempotent)."""
        if self._cached is None:
            self._cached = materialize(self.packed_dev, self.counters, copy=self._copy)
        return self._cached

    def runs(self) -> Dict[int, List[int]]:
        """``{uid: emitted tokens}``, each row cut to its accept count.  The
        runs are VERIFIED output (accepted prefix + the resampled token):
        unverified draft tails never leave this handle, so the journal and
        the tracer never see a token the target did not endorse."""
        packed = self.wait()
        out: Dict[int, List[int]] = {}
        for i, uid in enumerate(self.uids):
            count = int(packed[i, 0])
            out[uid] = [int(t) for t in packed[i, 1:1 + count]]
        return out


@dataclasses.dataclass
class _Slot:
    """One bucket's persistent device buffers plus their host mirror."""
    tokens: torch.Tensor     # [n, t] int32
    n_tokens: torch.Tensor   # [n] int32
    start_pos: torch.Tensor  # [n] int32
    tables: torch.Tensor     # [n, b] int32
    mirror: np.ndarray       # host [n, 3 + t + b] packed rows
    active_rows: int = 0

    def buffers(self) -> Tuple[torch.Tensor, ...]:
        return self.tokens, self.n_tokens, self.start_pos, self.tables


def upload(arr: np.ndarray, device) -> torch.Tensor:
    """One host->device transfer of a host array: on the card through pinned
    memory and a non-blocking copy (the host buffer stays alive until the
    copy has run), on the CPU the array's own tensor."""
    host = torch.from_numpy(arr)
    if torch.device(device).type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host


def round_up_pow2(n: int) -> int:
    """Next power of two >= n: the one bucketing primitive shared by batch
    shapes (the engine's ``_bucket``) and scatter-row padding."""
    b = 1
    while b < n:
        b *= 2
    return b


class DeviceBatchState:
    """Per-bucket persistent batch buffers with incremental scatter updates.

    Rows are packed on the host as ``[row | tokens(t) | n_tokens | start_pos |
    tables(b)]``, so a step's delta is ONE ``[m, 3 + t + b]`` int32 upload and
    one scatter into the four buffers, instead of four full-batch uploads.
    The host mirror tracks exactly what the device holds, so a shrinking batch
    neutralizes its stale rows (n_tokens 0, tables all trash) without
    re-uploading unchanged ones: a stale row left live would write KV into
    blocks the allocator may have handed to another sequence.

    Every write is in place (``index_copy_``), so a slot's buffers keep their
    addresses for the life of the engine.  On the card the packed delta goes
    through pinned host memory and a ``non_blocking`` copy.
    """

    def __init__(self, counters: ServeCounters, device):
        self.counters = counters
        self.device = torch.device(device)
        self._slots: Dict[Tuple[int, int, int], _Slot] = {}

    # ------------------------------------------------------------------ slots
    def slot(self, key: Tuple[int, int, int], trash_block: int) -> _Slot:
        s = self._slots.get(key)
        if s is None:
            n, t, b = key
            mirror = np.zeros((n, 3 + t + b), np.int32)
            mirror[:, 0] = np.arange(n)
            mirror[:, 3 + t:] = trash_block
            zeros = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=self.device)
            s = _Slot(tokens=zeros(n, t), n_tokens=zeros(n), start_pos=zeros(n),
                      tables=torch.full((n, b), trash_block, dtype=torch.int32,
                                        device=self.device),
                      mirror=mirror)
            self._slots[key] = s
        return s

    # ----------------------------------------------------------------- update
    def update(self, key: Tuple[int, int, int], rows: List[Tuple[int, np.ndarray]],
               n_active: int, trash_block: int) -> _Slot:
        """Scatter ``rows`` ([(row_index, packed_row)]) into the bucket's
        device buffers, neutralizing any previously active row beyond
        ``n_active``.  Unchanged rows (mirror match) cost nothing."""
        s = self.slot(key, trash_block)
        n, t, b = key
        changed: List[np.ndarray] = []
        for i, packed in rows:
            if not np.array_equal(packed[1:], s.mirror[i, 1:]):
                changed.append(packed)
                s.mirror[i, 1:] = packed[1:]
        neutral = None
        for i in range(n_active, s.active_rows):
            if neutral is None:
                neutral = np.zeros(3 + t + b, np.int32)
                neutral[3 + t:] = trash_block
            if not np.array_equal(neutral[1:], s.mirror[i, 1:]):
                row = neutral.copy()
                row[0] = i
                changed.append(row)
                s.mirror[i, 1:] = row[1:]
        s.active_rows = n_active
        if changed:
            m = len(changed)
            # pad to a power of two with a repeat of the last row (as the JAX
            # engine pads to bound its compiled shapes): duplicate indices
            # carry identical values, so the write order cannot matter
            changed.extend([changed[-1]] * (round_up_pow2(m) - m))
            packed = np.stack(changed)
            self.counters.uploads += 1
            self.counters.upload_ints += int(packed.size)
            self.counters.dispatches += 1
            dev = upload(packed, self.device)
            idx = dev[:, 0].long()
            s.tokens.index_copy_(0, idx, dev[:, 1:1 + t])
            s.n_tokens.index_copy_(0, idx, dev[:, 1 + t])
            s.start_pos.index_copy_(0, idx, dev[:, 2 + t])
            s.tables.index_copy_(0, idx, dev[:, 3 + t:])
        return s

    def feed(self, key: Tuple[int, int, int], toks_prev: torch.Tensor,
             pairs: List[Tuple[int, int]]) -> None:
        """Feed previous-step sampled tokens into this step's input slots
        entirely on the device (``pairs``: (dst_row, src_row))."""
        if not pairs:
            return
        s = self._slots[key]
        m_pad = round_up_pow2(len(pairs))
        arr = np.empty((m_pad, 2), np.int32)
        arr[:len(pairs)] = pairs
        arr[len(pairs):] = pairs[-1]  # duplicate writes carry identical values
        self.counters.uploads += 1
        self.counters.upload_ints += int(arr.size)
        self.counters.dispatches += 1
        dev = upload(arr, self.device).long()
        s.tokens[:, 0].index_copy_(0, dev[:, 0], toks_prev[dev[:, 1]])

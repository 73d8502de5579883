"""Durable request journal — the serving WAL behind crash recovery.

Counterpart of ``deepspeed_tpu/inference/v2/journal.py``, and format-
compatible with it: the frame layout (``utils/wal.py``), the record schema
(``JOURNAL_FORMAT_VERSION``) and the binary ``tok`` payload are the same, so
a journal written by either package replays in the other's
:func:`replay_journal` to the same :class:`JournalState`.  The multi-tenant
QoS identity (``tenant``/``cls`` on the admit record, the shed ``code`` on
the end record) is written only when it differs from the defaults, so a
QoS-off journal carries none of those keys.

A serving-process crash (OOM, preempted VM, wedged device) would otherwise
destroy every queued and in-flight request: the engine's admission, deadline
and watchdog resilience is all in-process.  This module makes the v2
engine's request state crash-durable with an append-only, CRC-framed
write-ahead log ("the tail that wasn't durably written never happened",
applied to a log file):

- ``admit`` — one record per admitted request: uid, prompt, priority,
  effective TTL + a WALL-clock admit stamp (the engine's monotonic clock is
  meaningless across a process restart, so cross-generation deadline math
  runs on wall time: recovered requests keep their ORIGINAL TTL clock),
  ``max_new_tokens``/``eos_token_id``/``greedy``, and the request's sampling
  key ``(engine seed, uid)``.  Determinism scope, honestly: GREEDY recovered
  decodes are byte-identical to an uninterrupted run (deterministic from the
  token prefix alone — the smoke proves it end-to-end).  SAMPLED decode
  continues from the journaled prefix but is NOT guaranteed to reproduce the
  uninterrupted stream: the engine rng is engine-wide and advances with
  batch history, which a restart cannot replay; the key is recorded as
  forensic provenance and as the seam a future per-request rng would need.
  Re-admissions after a recovery append a fresh ``admit`` carrying
  ``prefix_len`` — the emitted-prefix provenance (admission.py); replay
  keeps the emitted stream exactly up to that prefix, and an admit with
  ``prefix_len=0`` starts the uid clean (uids are reused across serve
  calls, so every admit is authoritative for the request's identity).
- ``tok`` — batched emitted-token deltas, appended at wave-boundary flushes
  where the host ALREADY holds the materialized ints (zero extra device
  syncs; ``fsync_every`` amortizes the disk barrier).  Tokens emitted after
  the last flush die with the process — and are regenerated identically on
  recovery, because the journaled prefix pins the decode continuation.
- ``end`` — one terminal record mirroring the request's ``RequestResult``
  status, so replay can tell finished work from work to re-admit.

Replay (:func:`replay_journal`) tolerates a torn tail by truncating at the
first bad frame and folds the record stream into per-uid
:class:`JournalEntry` state; :meth:`JournalState.incomplete` is the set a
supervised restart re-admits *with their already-emitted token prefix* so
recovered decodes continue from where they died instead of restarting from
scratch.

All host-side; tokens arriving here are python ints the serve loop already
materialized (no device sync).  Wall-clock reads go through the injectable
``wall_clock`` seam (bound to ``time.time`` as a default), so tests drive
fake time.
"""

import dataclasses
import json
import logging
import os
import struct
import time
from array import array
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

from ...utils.wal import encode_frame, scan_frames, truncate_torn_tail

logger = logging.getLogger(__name__)

JOURNAL_FORMAT_VERSION = 1

# token-delta frames are the journal's volume (one per wave, every emitted
# token rides one) and dominate its host cost — they use a compact binary
# payload (~1µs/token to encode) instead of JSON (~10µs/token), keeping the
# durability tax well under the serve loop's own python cost.  Metadata
# records (open/admit/end — a handful per request) stay JSON for
# debuggability.  A binary payload is tagged by its first byte; JSON
# payloads always start with '{'.
TOK_BINARY_TAG = b"\x01"
_TOK_GROUP = struct.Struct("<qI")  # uid (i64), token count (u32)


def _encode_tok_payload(delta: Dict[int, List[int]]) -> bytes:
    parts = [TOK_BINARY_TAG]
    for uid, toks in delta.items():
        parts.append(_TOK_GROUP.pack(int(uid), len(toks)))
        parts.append(array("i", toks).tobytes())
    return b"".join(parts)


def _decode_tok_payload(payload: bytes) -> Dict[int, List[int]]:
    delta: Dict[int, List[int]] = {}
    off = 1
    n = len(payload)
    while off + _TOK_GROUP.size <= n:
        uid, count = _TOK_GROUP.unpack_from(payload, off)
        off += _TOK_GROUP.size
        end = off + 4 * count
        if end > n:
            break  # CRC said the frame is whole; defend against skew anyway
        toks = array("i")
        toks.frombytes(payload[off:end])
        delta.setdefault(uid, []).extend(toks.tolist())
        off = end
    return delta


@dataclasses.dataclass
class JournalEntry:
    """Folded per-uid journal state after replay."""
    uid: int
    prompt: List[int]
    priority: int = 0
    # TTL budget as of the LATEST admit (a re-admission journals the
    # remaining budget), paired with that admit's wall stamp — the two
    # compose so the ORIGINAL deadline survives any number of restarts
    ttl_s: Optional[float] = None
    admit_wall: float = 0.0
    max_new_tokens: int = 0
    eos_token_id: Optional[int] = None
    greedy: bool = True
    sampling_key: Tuple[int, int] = (0, 0)
    emitted: List[int] = dataclasses.field(default_factory=list)
    prefix_len: int = 0                    # provenance of the latest admit
    admits: int = 0                        # admit records seen (1 + recoveries)
    terminal: Optional[Dict[str, Any]] = None
    # QoS identity: journaled at admit so recovery re-admits a request
    # under its ORIGINAL tenant and service class — a restart can never
    # launder best-effort traffic into interactive or detach a request from
    # its tenant's quota accounting.  Absent keys fold to these defaults
    tenant: str = "default"
    service_class: str = "interactive"

    @property
    def done(self) -> bool:
        return self.terminal is not None

    def ttl_remaining(self, now_wall: float) -> Optional[float]:
        """Seconds of the ORIGINAL TTL budget left at ``now_wall`` (None =
        no deadline): the latest-admit budget minus the wall time elapsed
        since that admit.  Recovery passes this as the re-admission TTL so
        a restart never refreshes — and never double-shrinks — a request's
        deadline."""
        if self.ttl_s is None:
            return None
        return self.ttl_s - max(0.0, now_wall - self.admit_wall)


@dataclasses.dataclass
class JournalState:
    """Everything a replay learned: per-uid entries + file forensics."""
    entries: Dict[int, JournalEntry] = dataclasses.field(default_factory=dict)
    records: int = 0
    generations: int = 0                   # open records seen (journal lifetimes)
    truncated_tail: Optional[str] = None   # torn-tail description, if any

    def incomplete(self) -> List[JournalEntry]:
        """Admitted-but-not-terminal entries, in first-admit order — the
        recovery set a supervised restart re-admits with prefix."""
        return [e for e in self.entries.values() if not e.done]


class RequestJournal:
    """Append-only CRC-framed request WAL for one serving engine.

    The engine drives four hooks: :meth:`record_admit` when a request clears
    admission, :meth:`note_tokens` as sampled tokens become host-visible
    (buffered — no IO), :meth:`flush` at wave boundaries (ONE ``tok`` frame
    for everything buffered; fsync every ``fsync_every`` flushes, 0 = only
    at close), and :meth:`record_terminal` when a ``RequestResult`` is
    constructed (strict mode writes + fsyncs it eagerly — a lost terminal
    means replay re-serves finished work; throughput mode batches it into
    the next wave flush, a one-iteration window whose loss recovery absorbs
    by re-serving from the journaled prefix).

    ``watched`` is the uid filter: only requests this journal admitted are
    journaled, so foreign ``put()`` traffic sharing the engine can't bloat
    another caller's WAL.
    """

    def __init__(self, path: str, *, fsync_every: int = 1,
                 wall_clock=time.time, seed: int = 0):
        self.path = path
        self.fsync_every = max(int(fsync_every), 0)
        self._wall = wall_clock
        self.seed = int(seed)
        self.watched: set = set()
        self._fh = None
        self._pending: Dict[int, List[int]] = {}
        # throughput mode (fsync_every=0): records buffer here and land in
        # ONE file write per wave boundary — the journal's python cost per
        # serve iteration is one join+write instead of a write per record.
        # Strict mode (fsync_every>=1) writes each record immediately, with
        # admits/terminals fsynced eagerly.
        self._record_buffer: List[Union[Dict[str, Any], bytes]] = []
        self._flushes_since_fsync = 0
        self.bytes_written = 0
        self.records_written = 0
        self.enabled = True
        parent = os.path.dirname(path)
        if parent:
            try:
                os.makedirs(parent, exist_ok=True)
            except OSError as exc:
                # a broken journal dir must degrade durability, never serving
                logger.warning(f"request journal: cannot create {parent!r} "
                               f"({exc}); journaling disabled")
                self.enabled = False

    @property
    def strict(self) -> bool:
        """Per-record durability (fsync_every >= 1) vs buffered throughput
        mode (0): the operator's stated crash-window tradeoff."""
        return self.fsync_every > 0

    # ------------------------------------------------------------------ frames
    def _write_records(self, records: List[Union[Dict[str, Any], bytes]], *,
                       fsync: bool) -> None:
        """Append frames — dict records as JSON, pre-encoded binary payloads
        (token deltas) as-is — in ONE file write."""
        if not records or not self.enabled:
            return
        try:
            if self._fh is None:
                # extend a CLEAN prefix: a torn tail left by a crashed writer
                # would make every frame appended after it unreachable
                tail = truncate_torn_tail(self.path)
                if tail:
                    logger.warning(f"request journal {self.path}: {tail}")
                self._fh = open(self.path, "ab")
            data = b"".join(
                encode_frame(r if isinstance(r, bytes)
                             else json.dumps(r, separators=(",", ":")).encode())
                for r in records)
            self._fh.write(data)
            # always push to the OS: a hard-killed PROCESS then loses
            # nothing (kernel pages survive it) — fsync_every only governs
            # the stronger power-loss barrier.  One syscall per wave-batched
            # write, not per record.
            self._fh.flush()
            self.bytes_written += len(data)
            self.records_written += len(records)
            if fsync:
                os.fsync(self._fh.fileno())
                self._flushes_since_fsync = 0
        except OSError as exc:
            logger.warning(f"request journal {self.path}: append failed ({exc}); "
                           f"journaling disabled — recovery will see state up to "
                           f"the last durable frame")
            self.enabled = False

    def _emit(self, record: Union[Dict[str, Any], bytes], *, durable: bool) -> None:
        """One record: written now (strict mode; ``durable`` also fsyncs) or
        buffered until the next wave-boundary flush (throughput mode)."""
        if self.strict:
            self._write_records([record], fsync=durable)
        else:
            self._record_buffer.append(record)

    def _drain_tokens(self) -> Optional[bytes]:
        if not self._pending:
            return None
        payload = _encode_tok_payload(self._pending)
        self._pending = {}
        return payload

    # ------------------------------------------------------------------- hooks
    def open_generation(self, generation: int = 0) -> None:
        """Stamp a journal lifetime (engine construction / supervised
        restart) — replay counts these, and the wall stamp dates the file."""
        self._emit({"t": "open", "v": JOURNAL_FORMAT_VERSION,
                    "gen": int(generation), "seed": self.seed,
                    "wall": self._wall()}, durable=False)

    def record_admit(self, uid: int, prompt: Iterable[int], *, priority: int = 0,
                     ttl_s: Optional[float] = None, max_new_tokens: int = 0,
                     eos_token_id: Optional[int] = None, greedy: bool = True,
                     prefix_len: int = 0, admit_wall: Optional[float] = None,
                     tenant: str = "default",
                     service_class: str = "interactive") -> None:
        uid = int(uid)
        self.watched.add(uid)
        # ``admit_wall`` transplants an entry between journals (fleet
        # failover migration): the ORIGINAL wall stamp rides along with the
        # original ttl_s so the deadline keeps ticking on the request's own
        # clock.  Fresh admits stamp their own wall
        wall = self._wall() if admit_wall is None else float(admit_wall)
        # strict mode fsyncs admits eagerly: losing one loses the request.
        # The key order is the JAX writer's, so the bytes are too.
        rec = {"t": "admit", "uid": uid, "prompt": [int(t) for t in prompt],
               "priority": int(priority), "ttl_s": ttl_s,
               "wall": wall, "max_new_tokens": int(max_new_tokens),
               "eos": eos_token_id, "greedy": bool(greedy),
               "key": [self.seed, uid], "prefix_len": int(prefix_len)}
        # QoS identity rides the admit record only when it differs from the
        # defaults: a QoS-off engine's journal carries no such keys
        if tenant and tenant != "default":
            rec["tenant"] = str(tenant)
        if service_class and service_class != "interactive":
            rec["cls"] = str(service_class)
        self._emit(rec, durable=True)

    def note_tokens(self, uid: int, tokens) -> None:
        """Buffer emitted tokens (one int or a list) — no IO until flush().
        Values are python ints by the engine's own contract (they come off
        ``materialize()``); the binary encoder's ``array('i', ...)`` is the
        type check, so no per-token coercion burns the hot path."""
        if not self.enabled or uid not in self.watched:
            return
        bucket = self._pending.setdefault(int(uid), [])
        if isinstance(tokens, int):
            bucket.append(tokens)
        else:
            bucket.extend(tokens)

    def note_token_map(self, out: Dict[int, Any]) -> None:
        """Buffer a whole absorb/burst result map ({uid: tok-or-list})."""
        if not self.enabled or not out:
            return
        for uid, toks in out.items():
            self.note_tokens(uid, toks)

    def flush(self) -> bool:
        """Wave boundary: emit buffered token deltas as one ``tok`` frame —
        and in throughput mode land every buffered record in ONE file write.
        Returns True when bytes were actually appended."""
        if not self.enabled:
            return False
        tok = self._drain_tokens()
        if self.strict:
            if tok is None:
                return False
            self._flushes_since_fsync += 1
            self._write_records(
                [tok], fsync=self._flushes_since_fsync >= self.fsync_every)
            return True
        if tok is not None:
            self._record_buffer.append(tok)
        if not self._record_buffer:
            return False
        records, self._record_buffer = self._record_buffer, []
        self._write_records(records, fsync=False)
        return True

    def record_terminal(self, uid: int, status: str, *,
                        finish_reason: Optional[str] = None,
                        reason: Optional[str] = None, retryable: bool = False,
                        n_tokens: int = 0,
                        shed_code: Optional[str] = None) -> None:
        """No uid filtering here — the ENGINE's hooks filter on ``watched``;
        the supervisor writes terminals directly (drain-mode sheds,
        budget-exhaustion finalization) for uids it owns by contract.

        The terminal never outruns its own tokens: pending deltas emit
        first, in order.  Durability: strict mode writes + fsyncs the
        terminal eagerly (losing one means replay re-serves completed
        work).  Throughput mode batches it into the next wave flush like
        everything else — the serve loop flushes every iteration and the
        serve call's ``finally`` always flushes, so the in-memory window is
        ONE loop iteration, and a crash inside it merely re-serves the
        finished request from its journaled prefix (deterministic for
        greedy decode)."""
        tok = self._drain_tokens()
        end = {"t": "end", "uid": int(uid), "status": str(status),
               "finish_reason": finish_reason, "reason": reason,
               "retryable": bool(retryable), "n_tokens": int(n_tokens)}
        if shed_code is not None:
            # machine-readable shed code, written only when the caller has
            # one: a quota shed adopted from this journal after a crash must
            # still read as quota_exceeded to the fleet router (rerouting to
            # a sibling cannot help), and records without codes keep the
            # QoS-off format
            end["code"] = str(shed_code)
        if self.strict:
            self._write_records(([tok] if tok else []) + [end], fsync=True)
        else:
            if tok is not None:
                self._record_buffer.append(tok)
            self._record_buffer.append(end)

    def close(self) -> None:
        """Flush everything buffered and durably close the file handle."""
        self.flush()
        if self._fh is not None:
            try:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._fh.close()
            except OSError as exc:
                logger.warning(f"request journal {self.path}: close failed ({exc})")
            self._fh = None


# ============================================================== replay side
def replay_journal(path: str, *, truncate: bool = True) -> JournalState:
    """Fold a journal file into :class:`JournalState`.

    ``truncate=True`` (the writer-side default) physically truncates a torn
    tail first, so a subsequent append-mode writer extends a clean prefix;
    readers that must not mutate (a live engine's health probe) pass False
    and simply ignore the tail.  Unparseable-but-CRC-valid payloads (foreign
    writer, version skew) are skipped with a warning, never fatal — replay
    exists to save what CAN be saved.
    """
    state = JournalState()
    if truncate:
        state.truncated_tail = truncate_torn_tail(path)
        payloads, _, _ = scan_frames(path)
    else:
        payloads, _, state.truncated_tail = scan_frames(path)
    for payload in payloads:
        if payload[:1] == TOK_BINARY_TAG:
            state.records += 1
            for uid, toks in _decode_tok_payload(payload).items():
                entry = state.entries.get(uid)
                if entry is not None:
                    entry.emitted.extend(toks)
            continue
        try:
            rec = json.loads(payload)
            kind = rec["t"]
        except (ValueError, KeyError, TypeError):
            logger.warning(f"request journal {path}: skipping undecodable "
                           f"(but CRC-valid) record")
            continue
        state.records += 1
        if kind == "open":
            state.generations += 1
        elif kind == "admit":
            uid = int(rec["uid"])
            prefix_len = int(rec.get("prefix_len", 0))
            entry = state.entries.get(uid)
            if entry is None:
                entry = JournalEntry(uid=uid, prompt=[],
                                     admit_wall=float(rec.get("wall", 0.0)))
                state.entries[uid] = entry
            # every admit is authoritative for the request's identity: uids
            # are REUSED across serve calls (generate/serve derive them from
            # batch position), so a fresh admit of a recycled uid must not
            # inherit the previous request's prompt or emitted stream.  The
            # emitted list survives exactly up to the admit's own
            # ``prefix_len`` — a recovery re-admission declares the prefix
            # it continues from (== everything journaled so far), while a
            # fresh admit declares 0 and starts clean.
            entry.prompt = [int(t) for t in rec["prompt"]]
            entry.emitted = entry.emitted[:prefix_len]
            entry.priority = int(rec.get("priority", 0))
            # ttl_s and admit_wall move TOGETHER: a re-admission journals the
            # REMAINING budget as of ITS OWN wall stamp, so pairing the new
            # ttl with the old stamp would double-count the elapsed time on
            # every crash after the first (shrinking the deadline each
            # restart — the opposite of the keep-the-original-clock contract)
            entry.ttl_s = rec.get("ttl_s")
            entry.admit_wall = float(rec.get("wall", entry.admit_wall))
            entry.max_new_tokens = int(rec.get("max_new_tokens", 0))
            entry.eos_token_id = rec.get("eos")
            entry.greedy = bool(rec.get("greedy", True))
            key = rec.get("key") or [0, uid]
            entry.sampling_key = (int(key[0]), int(key[1]))
            entry.prefix_len = prefix_len
            # QoS identity: absent keys (QoS-off records, which omit default
            # values) fold to the defaults
            entry.tenant = str(rec.get("tenant", "default"))
            entry.service_class = str(rec.get("cls", "interactive"))
            entry.admits += 1
            # a re-admission reopens a request a previous generation may have
            # finalized (results adopted then re-served is a logic error the
            # supervisor never commits; stale terminals from a lost race are
            # superseded by the newest admit)
            entry.terminal = None
        elif kind == "tok":
            for uid_s, toks in rec.get("d", {}).items():
                entry = state.entries.get(int(uid_s))
                if entry is not None:
                    entry.emitted.extend(int(t) for t in toks)
        elif kind == "end":
            uid = int(rec["uid"])
            entry = state.entries.get(uid)
            if entry is None:
                # a terminal without an admit: the supervisor finalized a
                # request the engine never admitted (drain-mode shed) — a
                # stub entry keeps the status visible to replay consumers
                entry = JournalEntry(uid=uid, prompt=[])
                state.entries[uid] = entry
            entry.terminal = {"status": rec.get("status"),
                              "finish_reason": rec.get("finish_reason"),
                              "reason": rec.get("reason"),
                              "retryable": bool(rec.get("retryable", False)),
                              "n_tokens": int(rec.get("n_tokens", 0)),
                              "code": rec.get("code")}
        else:
            logger.warning(f"request journal {path}: unknown record type "
                           f"{kind!r} skipped (version skew?)")
    return state


def journal_bytes(path: Optional[str]) -> int:
    """On-disk journal size for health gauges (0 when absent/unset)."""
    if not path:
        return 0
    try:
        return os.path.getsize(path)
    except OSError:
        return 0

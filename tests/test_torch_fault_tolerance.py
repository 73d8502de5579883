"""The port's serving fault tolerance on the CPU against the JAX package's.

``deepspeed_tpu_torch/utils/wal.py``, ``inference/v2/journal.py``,
``runtime/heartbeat.py``, ``inference/v2/supervisor.py`` and the engine's
journal/heartbeat seams, held to their ``deepspeed_tpu`` counterparts:

- units: the same calls into both packages (WAL frames, the journal's
  record/replay cases, ``plan_recovery``, admission provenance, the
  manager's ``prompt_len``, heartbeat stamps, staleness and stragglers)
  must give equal results, and equal journal bytes;
- cross-replay: the two engines' journals of the same ``generate`` under a
  fixed wall clock are byte-identical, and each replays in the other
  package's ``replay_journal`` to the same ``JournalState``;
- engine parity, the JAX engine against the port's on the tiny fp32 Llama
  with the same weights (``params_from_jax``): the journaled lifecycle, a
  shed terminal, ``serve_recovered`` from a prefix, the original TTL, the
  in-process supervisor's crash recovery, budget exhaustion, a foreign
  engine journal refused, env arming;
- port-only: ``ServeCounters`` and tokens identical with journaling and
  heartbeats on and off, the supervisor's ops endpoint served, and subprocess
  supervision of a port worker (this file run as
  ``python tests/test_torch_fault_tolerance.py worker <fault> <out>``)
  through a crash with a torn tail and through a hang found by heartbeat
  staleness.

The JAX engines share one program cache, so their bucket programs are
compiled once for the module."""

import json
import os
import sys
import time


def _worker_main(argv):
    """A supervised serving worker on the CPU: builds the port engine (its
    journal and heartbeat armed by the supervisor's env), serves
    :data:`WORKER_PROMPTS` through ``recover_and_serve`` and exits 0.  In
    generation 0 the fault ``argv[0]`` fires at the journal's second
    writing flush: ``crash`` appends a torn frame and exits the process,
    ``hang`` stops serving (and stamping).  ``argv[1]`` collects one JSON
    line per generation: pid, generation, the torn tail found at startup."""
    import torch

    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, ServeSpec, recover_and_serve
    from deepspeed_tpu_torch.inference.v2.journal import replay_journal
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.runtime.heartbeat import (SERVING_GENERATION_ENV,
                                                       SERVING_JOURNAL_ENV)
    fault, out = argv
    generation = int(os.environ[SERVING_GENERATION_ENV])
    path = os.environ[SERVING_JOURNAL_ENV]
    tail = replay_journal(path, truncate=False).truncated_tail
    with open(out, "a") as fh:
        fh.write(json.dumps({"pid": os.getpid(), "generation": generation, "tail": tail}) + "\n")
    cfg, params = _worker_model(llama, torch)
    engine = InferenceEngineV2(llama, cfg, params, config={"dtype": "float32"}, device="cpu",
                               **KW)
    if generation == 0:
        flush, writes = engine.journal.flush, []

        def faulty_flush():
            wrote = flush()
            if wrote:
                writes.append(1)
                if len(writes) == 2 and fault == "crash":
                    with open(path, "ab") as fh:
                        fh.write(b"DSWL\x09\x00")  # the frame a dying writer never finished
                    os._exit(3)
                if len(writes) == 2 and fault == "hang":
                    time.sleep(600)
            return wrote

        engine.journal.flush = faulty_flush
    specs = [ServeSpec(uid, p) for uid, p in enumerate(WORKER_PROMPTS)]
    results = recover_and_serve(engine, specs, max_new_tokens=8)
    engine.journal.close()
    return 0 if all(r.ok for r in results.values()) else 1


KW = dict(num_blocks=64, block_size=8, max_blocks_per_seq=8, token_budget=32, max_seqs_per_step=8)
# 61 prompt tokens: two prefill steps at a budget of 32, then decode bursts
WORKER_PROMPTS = [list(range(1, 14)), list(range(30, 52)), [11, 4, 8, 30, 2, 6, 19, 1, 7],
                  list(range(60, 43, -1))]


def _worker_model(llama, torch):
    cfg = llama.LlamaConfig.tiny(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, seq=128)
    return cfg, llama.init_params(cfg, torch.Generator().manual_seed(0))


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    # the worker needs neither JAX nor pytest: exit before importing them
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(_worker_main(sys.argv[2:]))

import dataclasses  # noqa: E402
import signal  # noqa: E402
import threading  # noqa: E402
import types  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import deepspeed_tpu.inference.v2.admission as jadmission  # noqa: E402
import deepspeed_tpu.inference.v2.journal as jjournal  # noqa: E402
import deepspeed_tpu.inference.v2.supervisor as jsupervisor  # noqa: E402
import deepspeed_tpu.runtime.heartbeat as jheartbeat  # noqa: E402
import deepspeed_tpu.utils.wal as jwal  # noqa: E402
import deepspeed_tpu_torch.inference.v2.admission as admission  # noqa: E402
import deepspeed_tpu_torch.inference.v2.journal as journal  # noqa: E402
import deepspeed_tpu_torch.inference.v2.supervisor as supervisor  # noqa: E402
import deepspeed_tpu_torch.runtime.heartbeat as heartbeat  # noqa: E402
import deepspeed_tpu_torch.utils.wal as wal  # noqa: E402
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine  # noqa: E402
from deepspeed_tpu.inference.v2.ragged_manager import RaggedStateManager as JaxManager  # noqa: E402
from deepspeed_tpu.models import llama as jllama  # noqa: E402
from deepspeed_tpu.runtime.config import ServingFaultToleranceConfig as JaxFTConfig  # noqa: E402
from deepspeed_tpu.runtime.config import ServingResilienceConfig as JaxResilience  # noqa: E402
from deepspeed_tpu_torch.inference.config import UNPORTED_SECTIONS, load_inference_config  # noqa: E402
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2  # noqa: E402
from deepspeed_tpu_torch.inference.v2.ragged_manager import RaggedStateManager  # noqa: E402
from deepspeed_tpu_torch.models import llama  # noqa: E402
from deepspeed_tpu_torch.runtime.config import (ServingFaultToleranceConfig,  # noqa: E402
                                                ServingResilienceConfig)
from tests.unit.fault_injection_serving import FakeClock  # noqa: E402

SIDES = {
    "jax": types.SimpleNamespace(wal=jwal, journal=jjournal, supervisor=jsupervisor,
                                 admission=jadmission, heartbeat=jheartbeat, Manager=JaxManager,
                                 Resilience=JaxResilience),
    "port": types.SimpleNamespace(wal=wal, journal=journal, supervisor=supervisor,
                                  admission=admission, heartbeat=heartbeat,
                                  Manager=RaggedStateManager, Resilience=ServingResilienceConfig),
}
# the JAX suite's tiny_serving fixture: 4 prompts of 4-15 tokens
_rng = np.random.default_rng(0)
PROMPTS = [_rng.integers(1, 128, int(n)).tolist() for n in _rng.integers(4, 16, 4)]
# fields of the JAX records the port leaves out with multi-tenant QoS
QOS_FIELDS = ("tenant", "service_class")

_CACHE = {}


def plain(obj):
    """A dataclass (or a dict/list of them) as plain data without the QoS
    fields, comparable across the packages."""
    if dataclasses.is_dataclass(obj):
        return {k: plain(v) for k, v in dataclasses.asdict(obj).items() if k not in QOS_FIELDS}
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items() if k not in QOS_FIELDS}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    return obj


def both(case, tmp_path):
    """Run ``case(ns, directory)`` against each package; the results must
    be equal.  Returns the port's."""
    got = {}
    for side, ns in SIDES.items():
        d = tmp_path / side
        d.mkdir()
        got[side] = case(ns, d)
    assert got["port"] == got["jax"]
    return got["port"]


# ===================================================================== WAL
def _wal_roundtrip(ns, d):
    path = str(d / "log.wal")
    payloads = [b'{"a":1}', b"", b"\x00\x01binary\xff", b"x" * 4096]
    with open(path, "ab") as fh:
        for p in payloads:
            ns.wal.append_frame(fh, p)
    got, good, tail = ns.wal.scan_frames(path)
    assert got == payloads and tail is None and good == os.path.getsize(path)
    return got, good, open(path, "rb").read(), ns.wal.scan_frames(str(d / "missing.wal"))


def _wal_torn_tail(ns, d):
    out = []
    for name, torn in (("header", ns.wal.FRAME_MAGIC + b"\x07"),
                       ("payload", ns.wal.encode_frame(b"payload-that-gets-cut")[:-5])):
        path = str(d / f"{name}.wal")
        with open(path, "ab") as fh:
            ns.wal.append_frame(fh, b"one")
            ns.wal.append_frame(fh, b"two")
        clean = os.path.getsize(path)
        with open(path, "ab") as fh:
            fh.write(torn)
        got, good, tail = ns.wal.scan_frames(path)
        assert got == [b"one", b"two"] and good == clean and tail is not None
        truncated = ns.wal.truncate_torn_tail(path)
        assert os.path.getsize(path) == clean and ns.wal.truncate_torn_tail(path) is None
        out.append((tail, truncated))
    return out


def _wal_corrupt_frame(ns, d):
    path = str(d / "log.wal")
    with open(path, "ab") as fh:
        for p in (b"first", b"second", b"third"):
            ns.wal.append_frame(fh, p)
    data = open(path, "rb").read()
    bounds = [end for _, end in ns.wal.iter_frames(data)]
    flip = bounds[0] + ns.wal.HEADER_SIZE  # the second frame's first payload byte
    with open(path, "wb") as fh:
        fh.write(data[:flip] + bytes([data[flip] ^ 0xFF]) + data[flip + 1:])
    got, good, tail = ns.wal.scan_frames(path)
    assert got == [b"first"] and good == bounds[0]  # the third is unreachable
    return got, good, tail, ns.wal.file_crc32(path)


@pytest.mark.parametrize("case", [_wal_roundtrip, _wal_torn_tail, _wal_corrupt_frame],
                         ids=lambda f: f.__name__[5:])
def test_wal_frames_match_jax(case, tmp_path):
    both(case, tmp_path)


# ================================================================= journal
def _replayed(ns, path, **kw):
    """The replayed state as plain data, with the file's bytes."""
    return plain(ns.journal.replay_journal(path, **kw)), open(path, "rb").read()


def _journal_roundtrip(ns, d):
    path = str(d / "j.wal")
    j = ns.journal.RequestJournal(path, fsync_every=1, wall_clock=FakeClock(100.0), seed=7)
    j.open_generation(0)
    j.record_admit(0, [1, 2, 3], priority=2, ttl_s=10.0, max_new_tokens=8, eos_token_id=5,
                   greedy=False)
    j.record_admit(1, [4, 5], max_new_tokens=8)
    j.note_token_map({0: 11, 1: [12, 13]})
    j.flush()
    j.note_tokens(0, [14])
    j.record_terminal(1, admission.OK, finish_reason="eos", n_tokens=2)
    j.close()
    state = ns.journal.replay_journal(path)
    e0, e1 = state.entries[0], state.entries[1]
    assert state.generations == 1 and state.truncated_tail is None
    assert e0.prompt == [1, 2, 3] and e0.emitted == [11, 14] and not e0.done
    assert (e0.priority, e0.ttl_s, e0.admit_wall, e0.max_new_tokens) == (2, 10.0, 100.0, 8)
    assert e0.eos_token_id == 5 and not e0.greedy and e0.sampling_key == (7, 0)
    assert e1.emitted == [12, 13] and e1.terminal["status"] == "ok"
    assert [e.uid for e in state.incomplete()] == [0]
    assert ns.journal.journal_bytes(path) == os.path.getsize(path) > 0
    return _replayed(ns, path)


def _journal_ttl_remaining(ns, d):
    entry = ns.journal.JournalEntry(uid=0, prompt=[1], ttl_s=10.0, admit_wall=100.0)
    got = (entry.ttl_remaining(104.0), entry.ttl_remaining(111.0),
           ns.journal.JournalEntry(uid=1, prompt=[1]).ttl_remaining(999.0))
    assert got == (6.0, -1.0, None)
    return got


def _journal_torn_tail(ns, d):
    path = str(d / "j.wal")
    j = ns.journal.RequestJournal(path, fsync_every=1, wall_clock=FakeClock(5.0))
    j.record_admit(0, [1, 2], max_new_tokens=4)
    j.close()
    with open(path, "ab") as fh:
        fh.write(b"DSWL\x09\x00")  # the frame a dying writer never finished
    state = ns.journal.replay_journal(path, truncate=True)
    assert state.truncated_tail is not None and state.entries[0].prompt == [1, 2]
    j2 = ns.journal.RequestJournal(path, fsync_every=1, wall_clock=FakeClock(6.0))
    j2.record_admit(1, [3], max_new_tokens=4)  # extends the CLEAN prefix
    j2.close()
    assert sorted(ns.journal.replay_journal(path).entries) == [0, 1]
    return plain(state), _replayed(ns, path)


def _journal_corrupt_frame(ns, d):
    path = str(d / "j.wal")
    j = ns.journal.RequestJournal(path, fsync_every=1, wall_clock=FakeClock(5.0))
    j.record_admit(0, [1], max_new_tokens=4)
    j.note_tokens(0, [9])
    j.flush()
    j.record_terminal(0, "ok", n_tokens=1)
    j.close()
    data = open(path, "rb").read()
    flip = [end for _, end in ns.wal.iter_frames(data)][0] + ns.wal.HEADER_SIZE
    with open(path, "wb") as fh:
        fh.write(data[:flip] + bytes([data[flip] ^ 0xFF]) + data[flip + 1:])
    state = ns.journal.replay_journal(path, truncate=True)
    assert state.entries[0].emitted == [] and not state.entries[0].done  # tok + end dropped
    assert state.truncated_tail is not None
    return plain(state)


def _journal_readmit_supersedes_terminal(ns, d):
    path = str(d / "j.wal")
    j = ns.journal.RequestJournal(path, fsync_every=1, wall_clock=FakeClock(5.0))
    j.record_admit(0, [1, 2], max_new_tokens=8)
    j.note_tokens(0, [7, 8])
    j.record_terminal(0, "failed", reason="transient")
    j.record_admit(0, [1, 2], max_new_tokens=8, prefix_len=2)
    j.note_tokens(0, [9])
    j.flush()
    j.close()
    entry = ns.journal.replay_journal(path).entries[0]
    assert not entry.done and entry.emitted == [7, 8, 9]
    assert entry.prefix_len == 2 and entry.admits == 2
    return _replayed(ns, path)


def _journal_ttl_across_two_crashes(ns, d):
    path = str(d / "j.wal")
    j = ns.journal.RequestJournal(path, fsync_every=1, wall_clock=FakeClock(1000.0))
    j.record_admit(0, [1, 2], ttl_s=300.0, max_new_tokens=8)
    j.close()
    j2 = ns.journal.RequestJournal(path, fsync_every=1, wall_clock=FakeClock(1100.0))
    j2.record_admit(0, [1, 2], ttl_s=200.0, max_new_tokens=8, prefix_len=1)
    j2.close()
    entry = ns.journal.replay_journal(path).entries[0]
    assert entry.ttl_remaining(1150.0) == pytest.approx(150.0)
    assert entry.ttl_remaining(1299.0) > 0 > entry.ttl_remaining(1301.0)
    return _replayed(ns, path), entry.ttl_remaining(1150.0)


def _journal_uid_reuse(ns, d):
    path = str(d / "j.wal")
    j = ns.journal.RequestJournal(path, fsync_every=1, wall_clock=FakeClock(5.0))
    j.record_admit(0, [1, 2], max_new_tokens=4)
    j.note_tokens(0, [7, 8])
    j.record_terminal(0, "ok", finish_reason="max_new_tokens", n_tokens=2)
    j.record_admit(0, [9, 9, 9], max_new_tokens=4)  # a later batch reuses uid 0
    j.note_tokens(0, [5])
    j.flush()
    j.close()
    entry = ns.journal.replay_journal(path).entries[0]
    assert entry.prompt == [9, 9, 9] and entry.emitted == [5]
    assert not entry.done and entry.admits == 2
    return _replayed(ns, path)


def _journal_terminal_without_admit(ns, d):
    path = str(d / "j.wal")
    j = ns.journal.RequestJournal(path, fsync_every=1)
    j.record_terminal(3, "shed", reason=ns.supervisor.DRAIN_SHED_REASON, retryable=True)
    j.close()
    entry = ns.journal.replay_journal(path).entries[3]
    result = ns.supervisor.result_from_entry(entry)
    assert entry.done and result.status == "shed" and result.retryable and result.tokens == []
    return _replayed(ns, path), plain(result)


def _journal_broken_dir(ns, d):
    blocker = d / "file"
    blocker.write_text("")
    j = ns.journal.RequestJournal(str(blocker / "sub" / "j.wal"))
    assert not j.enabled
    j.record_admit(0, [1], max_new_tokens=4)  # all no-ops, no raise
    j.note_tokens(0, [2])
    flushed = j.flush()
    j.record_terminal(0, "ok")
    j.close()
    assert flushed is False
    return j.enabled, flushed, j.bytes_written


def _journal_throughput_mode(ns, d):
    path = str(d / "j.wal")
    j = ns.journal.RequestJournal(path, fsync_every=0, wall_clock=FakeClock(5.0))
    j.open_generation(0)
    j.record_admit(0, [1], max_new_tokens=4)
    assert ns.journal.journal_bytes(path) == 0, "throughput mode must not write per record"
    j.note_tokens(0, [5])
    assert j.flush() is True and ns.journal.journal_bytes(path) > 0
    state = ns.journal.replay_journal(path, truncate=False)
    assert state.entries[0].emitted == [5] and state.generations == 1
    j.record_terminal(0, "ok", n_tokens=1)
    buffered = ns.journal.journal_bytes(path)
    j.close()
    assert ns.journal.journal_bytes(path) > buffered
    return plain(state), _replayed(ns, path)


def _journal_binary_tok_payload(ns, d):
    path = str(d / "j.wal")
    j = ns.journal.RequestJournal(path, fsync_every=1, wall_clock=FakeClock(5.0))
    big = 2**30 + 17
    j.record_admit(10**7, [1], max_new_tokens=4)
    j.note_tokens(10**7, [0, big, 3])
    j.flush()
    j.close()
    assert ns.journal.replay_journal(path).entries[10**7].emitted == [0, big, 3]
    payloads, _, _ = ns.wal.scan_frames(path)
    assert payloads[-1][:1] == ns.journal.TOK_BINARY_TAG
    return _replayed(ns, path)


JOURNAL_CASES = [_journal_roundtrip, _journal_ttl_remaining, _journal_torn_tail,
                 _journal_corrupt_frame, _journal_readmit_supersedes_terminal,
                 _journal_ttl_across_two_crashes, _journal_uid_reuse,
                 _journal_terminal_without_admit, _journal_broken_dir, _journal_throughput_mode,
                 _journal_binary_tok_payload]


@pytest.mark.parametrize("case", JOURNAL_CASES, ids=lambda f: f.__name__[9:])
def test_journal_matches_jax(case, tmp_path):
    """The JAX suite's journal cases on both packages: the same asserts
    hold, and the replayed states and the files' bytes are equal."""
    both(case, tmp_path)


def test_journal_format_constants_match_jax():
    assert journal.JOURNAL_FORMAT_VERSION == jjournal.JOURNAL_FORMAT_VERSION == 1
    assert journal.TOK_BINARY_TAG == jjournal.TOK_BINARY_TAG
    assert journal._TOK_GROUP.format == jjournal._TOK_GROUP.format == "<qI"
    assert (wal.FRAME_MAGIC, wal.HEADER_SIZE) == (jwal.FRAME_MAGIC, jwal.HEADER_SIZE)
    for name in ("HEARTBEAT_DIR_ENV", "HEARTBEAT_INTERVAL_ENV", "SERVING_JOURNAL_ENV",
                 "SERVING_FSYNC_ENV", "SERVING_GENERATION_ENV", "SERVING_DRAIN_ENV",
                 "OPS_DIR_ENV", "RESUME_TAG_ENV", "COLLECTIVE_TIMEOUT_ENV"):
        assert getattr(heartbeat, name) == getattr(jheartbeat, name)


# ========================================================== recovery plans
def _entry(ns, uid, prompt, emitted, **kw):
    return ns.journal.JournalEntry(uid=uid, prompt=prompt, emitted=list(emitted), **kw)


def _state(ns, *entries):
    return ns.journal.JournalState(entries={e.uid: e for e in entries})


def _plan_adopt_readmit_new(ns, d):
    done = _entry(ns, 0, [1, 2], [7], max_new_tokens=4)
    done.terminal = {"status": "ok", "finish_reason": "eos"}
    partial = _entry(ns, 1, [3], [8, 9], max_new_tokens=4)
    specs = [ns.supervisor.ServeSpec(0, [1, 2]), ns.supervisor.ServeSpec(1, [3]),
             ns.supervisor.ServeSpec(2, [4, 4])]
    plan = ns.supervisor.plan_recovery(_state(ns, done, partial), specs, max_new_tokens=4)
    by_uid = {r.uid: r for r in plan.entries}
    assert plan.adopted[0].tokens == [1, 2, 7] and by_uid[1].prefix == [8, 9]
    assert by_uid[1].pin_ttl and not by_uid[2].pin_ttl and plan.recovered == 1
    return plain(plan)


def _plan_finalizes_complete_prefixes(ns, d):
    state = _state(ns, _entry(ns, 0, [1], [7, 8, 9]), _entry(ns, 1, [2], [7, 5]),
                   _entry(ns, 2, [3] * 6, [7, 8]))
    specs = [ns.supervisor.ServeSpec(0, [1]), ns.supervisor.ServeSpec(1, [2]),
             ns.supervisor.ServeSpec(2, [3] * 6)]
    plan = ns.supervisor.plan_recovery(state, specs, max_new_tokens=3, eos_token_id=5,
                                       token_cap=8)
    assert not plan.entries
    assert [plan.adopted[u].finish_reason for u in range(3)] == ["max_new_tokens", "eos",
                                                                 "length_capped"]
    return plain(plan)


def _plan_original_ttl(ns, d):
    entry = _entry(ns, 0, [1], [7], max_new_tokens=8, ttl_s=10.0, admit_wall=100.0)
    specs = [ns.supervisor.ServeSpec(0, [1])]
    late = ns.supervisor.plan_recovery(_state(ns, entry), specs, max_new_tokens=8,
                                       now_wall=115.0)
    assert late.adopted[0].status == "deadline_expired" and late.adopted[0].tokens == [1, 7]
    early = ns.supervisor.plan_recovery(_state(ns, entry), specs, max_new_tokens=8,
                                        now_wall=104.0)
    (req, ) = early.entries
    assert req.pin_ttl and req.ttl_s == pytest.approx(6.0)
    return plain(late), plain(early)


def _plan_pins_caller_ttl(ns, d):
    plan = ns.supervisor.plan_recovery(_state(ns), [ns.supervisor.ServeSpec(0, [1], ttl_s=2.0),
                                                    ns.supervisor.ServeSpec(1, [2])],
                                       max_new_tokens=4)
    by_uid = {r.uid: r for r in plan.entries}
    assert by_uid[0].pin_ttl and by_uid[0].ttl_s == 2.0
    assert not by_uid[1].pin_ttl and by_uid[1].ttl_s is None
    return plain(plan)


def _plan_drain_sheds_never_journaled(ns, d):
    plan = ns.supervisor.plan_recovery(
        _state(ns, _entry(ns, 0, [1], [8], max_new_tokens=4)),
        [ns.supervisor.ServeSpec(0, [1]), ns.supervisor.ServeSpec(5, [2])],
        max_new_tokens=4, drain=True)
    assert [r.uid for r in plan.entries] == [0]
    assert plan.adopted[5].status == "shed" and plan.adopted[5].retryable
    return plain(plan)


PLAN_CASES = [_plan_adopt_readmit_new, _plan_finalizes_complete_prefixes, _plan_original_ttl,
              _plan_pins_caller_ttl, _plan_drain_sheds_never_journaled]


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda f: f.__name__[6:])
def test_plan_recovery_matches_jax(case, tmp_path):
    both(case, tmp_path)


# ================================================== admission and manager
def _submit_prefix_pins_ttl(ns, d):
    q = ns.admission.AdmissionQueue(clock=FakeClock(50.0))
    assert q.submit(0, [1, 2], prefix=[7, 8], recovered=True, ttl_s=4.0,
                    apply_default_ttl=False) is None
    ticket, expired = q.pop_ready()
    assert not expired and ticket.prefix == [7, 8] and ticket.recovered
    q2 = ns.admission.AdmissionQueue(ns.Resilience(default_ttl_s=9.0), clock=FakeClock(0.0))
    assert q2.submit(1, [1], apply_default_ttl=False) is None
    assert q2.submit(2, [1, 2, 3], prefix=[4, 5]) is None
    assert q2.queued_stats() == (2, 5)  # prompt + prefix
    (t1, _), (t2, _) = q2.pop_ready(), q2.pop_ready()
    assert t1.deadline is None and t2.deadline == 9.0  # pinned None vs the default
    return ticket.deadline, t1.deadline, t2.deadline


def _shed_sees_full_history(ns, d):
    q = ns.admission.AdmissionQueue()
    shed = q.submit(0, [1] * 5, prefix=[2] * 6, token_cap=10)
    assert shed is not None and shed.code == "prompt_over_cap"
    assert q.submit(1, [1] * 5, prefix=[2] * 4, token_cap=10) is None
    return str(shed), q.shed_total


def _add_sequence_prompt_len(ns, d):
    m = ns.Manager(num_blocks=8, block_size=4, max_blocks_per_seq=4)
    seq = m.add_sequence(0, [1, 2, 3, 7, 8], prompt_len=3)
    assert seq.prompt_len == 3 and seq.generated_tokens == 2 and seq.pending_tokens == 5
    for bad in (5, 0):
        with pytest.raises(ValueError):
            m.add_sequence(1, [1, 2], prompt_len=bad)
    return seq.prompt_len, seq.generated_tokens, seq.pending_tokens


@pytest.mark.parametrize("case", [_submit_prefix_pins_ttl, _shed_sees_full_history,
                                  _add_sequence_prompt_len], ids=lambda f: f.__name__[1:])
def test_admission_and_manager_provenance_match_jax(case, tmp_path):
    both(case, tmp_path)


# =============================================================== heartbeat
class Clocks:
    """Deterministic wall + monotonic clocks advanced by the test."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _heartbeat_stamps(ns, d):
    clock = Clocks()
    w = ns.heartbeat.HeartbeatWriter(str(d), 3, interval_s=1.0, generation=2, clock=clock,
                                     monotonic=clock)
    path = ns.heartbeat.heartbeat_path(str(d), 3)
    wrote = [w.stamp(7, phase="serving")]
    clock.t += 0.3
    wrote.append(w.stamp(8))  # throttled
    w.enter_collective("all_reduce")  # forced despite the interval
    inside = json.load(open(path))
    w.exit_collective()
    clock.t += 1.5
    wrote.append(w.stamp(9))
    w.close()
    closed = json.load(open(path))
    assert wrote == [True, False, True] and inside["collective"] == "all_reduce"
    assert closed["phase"] == "closed" and not w.stamp(10)
    assert not os.path.exists(path + ".tmp")
    return wrote, inside, closed, w.stamps_written


def _heartbeat_readers(ns, d):
    for rank, (step, t, coll) in {0: (40, 990.0, "all_reduce"), 1: (41, 999.0, None),
                                  2: (10, 999.5, None)}.items():
        clock = Clocks(t)
        w = ns.heartbeat.HeartbeatWriter(str(d), rank, clock=clock, monotonic=clock)
        if coll:
            w._last_step = step
            w.enter_collective(coll)
        else:
            w.stamp(step, force=True)
    (d / "hb.rank9.json").write_text("{torn")  # a torn write reads as absent
    beats = ns.heartbeat.read_heartbeats(str(d))
    for b in beats.values():
        b.pop("pid")
    stale = ns.heartbeat.stale_ranks(beats, [0, 1, 2, 3], timeout_s=5.0, now=1000.0)
    assert sorted(beats) == [0, 1, 2] and stale == [0, 3]
    stragglers = ns.heartbeat.straggler_ranks(beats, lag_steps=5)
    assert stragglers == [2]
    report = ns.heartbeat.format_hang_report(beats, [0, 1, 2, 3], 5.0, now=1000.0)
    assert "all_reduce" in report and "NO HEARTBEAT" in report
    return beats, stale, stragglers, report, ns.heartbeat.heartbeat_age(beats[1], now=1000.0)


def _heartbeat_degrades(ns, d):
    blocker = d / "file"
    blocker.write_text("x")
    w = ns.heartbeat.HeartbeatWriter(str(blocker / "sub"), 0)
    assert not w.enabled and not w.stamp(1)
    ns.heartbeat.set_heartbeat(None)
    assert ns.heartbeat.get_heartbeat() is ns.heartbeat.NULL_HEARTBEAT
    null = ns.heartbeat.NULL_HEARTBEAT
    return w.enabled, null.stamp(1), null.enabled, null.rank


@pytest.mark.parametrize("case", [_heartbeat_stamps, _heartbeat_readers, _heartbeat_degrades],
                         ids=lambda f: f.__name__[11:])
def test_heartbeat_matches_jax(case, tmp_path):
    both(case, tmp_path)


def test_build_heartbeat_resolves_env_over_config(tmp_path, monkeypatch):
    cfg = types.SimpleNamespace(heartbeat=True, heartbeat_dir=str(tmp_path / "cfg"),
                                heartbeat_interval_s=0.5)
    got = {}
    for side, ns in SIDES.items():
        monkeypatch.setenv(ns.heartbeat.HEARTBEAT_DIR_ENV, str(tmp_path / side))
        monkeypatch.setenv(ns.heartbeat.HEARTBEAT_INTERVAL_ENV, "2.5")
        w = ns.heartbeat.build_heartbeat(cfg, rank=1)
        got[side] = (w.directory == str(tmp_path / side), w.interval_s, w.rank)
        assert ns.heartbeat.get_heartbeat() is w
        monkeypatch.delenv(ns.heartbeat.HEARTBEAT_DIR_ENV)
        assert ns.heartbeat.build_heartbeat(None) is ns.heartbeat.NULL_HEARTBEAT
    assert got["port"] == got["jax"] == (True, 2.5, 1)


# ================================================================== config
def test_config_section_has_the_jax_fields_defaults_and_errors(tmp_path, monkeypatch):
    for env in (heartbeat.SERVING_JOURNAL_ENV, heartbeat.HEARTBEAT_DIR_ENV):
        monkeypatch.delenv(env, raising=False)
    ours, theirs = load_inference_config(None).serving_fault_tolerance, JaxFTConfig()
    fields = ("enabled", "journal_path", "fsync_every", "heartbeat", "heartbeat_dir",
              "heartbeat_interval_s", "max_restarts", "restart_window_s", "hang_timeout_s",
              "startup_grace_s", "poll_interval_s")
    assert [getattr(ours, f) for f in fields] == [getattr(theirs, f) for f in fields]
    assert "serving_fault_tolerance" not in UNPORTED_SECTIONS
    # serving_spec_decode is ported: it loads with the JAX package's defaults
    from deepspeed_tpu.runtime.config import ServingSpecDecodeConfig as JaxSpecConfig
    spec = load_inference_config({"serving_spec_decode": {}}).serving_spec_decode
    assert ({k: v for k, v in vars(spec).items() if not k.startswith("_")}
            == {k: v for k, v in vars(JaxSpecConfig()).items() if not k.startswith("_")})
    for section in ("serving_perf", "ops_server", "serving_qos", "serving_fleet"):  # ported
        assert not getattr(load_inference_config({section: {}}), section).enabled
    for bad, match in (({"enabled": True}, "needs journal_path"),
                       ({"heartbeat": True}, "needs heartbeat_dir"),
                       ({"fsync_every": -1}, None), ({"restart_window_s": 0.0}, None)):
        for cls in (ServingFaultToleranceConfig, JaxFTConfig):
            with pytest.raises(ValueError, match=match):
                cls(**bad)
    monkeypatch.setenv(heartbeat.SERVING_JOURNAL_ENV, str(tmp_path / "j.wal"))
    assert ServingFaultToleranceConfig(enabled=True).enabled  # the env arms it


def test_supervisor_refuses_the_unported_ops_plane(tmp_path):
    """The ops plane is ported: the supervisor serves its fleet endpoint
    (/metrics with the supervisor families, /healthz with its budget)."""
    from deepspeed_tpu_torch.monitor.exposition import parse_exposition
    from deepspeed_tpu_torch.monitor.ops_server import scrape
    sup = supervisor.ServingSupervisor(journal_path=str(tmp_path / "j.wal"),
                                       ops_server={"enabled": True})
    try:
        fams = parse_exposition(scrape(sup.ops.url("/metrics")))
        assert fams["dstpu_supervisor_restarts_total"]["samples"][0][2] == 0.0
        assert json.loads(scrape(sup.ops.url("/healthz"))) == sup.ops_health()
    finally:
        sup.close_ops()


# ================================================================= engines
def _params():
    if "params" not in _CACHE:
        kw = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, seq=256)
        jcfg, cfg = jllama.LlamaConfig.tiny(**kw), llama.LlamaConfig.tiny(**kw)
        jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
        params = llama.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        _CACHE["params"] = (jcfg, jparams, cfg, params)
    return _CACHE["params"]


def _engine(side, config=None, **kw):
    """An engine of ``side`` over the module's weights, fast path on (the
    default of both), fp32."""
    jcfg, jparams, cfg, params = _params()
    config = {"dtype": "float32", **(config or {})}
    if side == "jax":
        eng = JaxEngine(jllama, jcfg, jparams, config=config, **KW, **kw)
        # bucket programs are functions of (params, pool, batch): engines
        # with one pool size share them
        eng._fwd_cache = _CACHE.setdefault("programs", {})
        return eng
    return InferenceEngineV2(llama, cfg, params, config=config, device="cpu", **KW, **kw)


def _reference():
    """The uninterrupted greedy run of PROMPTS, 8 new tokens, on the port."""
    if "reference" not in _CACHE:
        _CACHE["reference"] = _engine("port").generate(PROMPTS, max_new_tokens=8)
    return _CACHE["reference"]


def _ft(path, **over):
    return {"serving_fault_tolerance": {"enabled": True, "journal_path": path, **over}}


def test_generate_journals_full_lifecycle(tmp_path):
    states, health = {}, {}
    for side, ns in SIDES.items():
        path = str(tmp_path / f"{side}.wal")
        eng = _engine(side, _ft(path))
        assert eng.generate(PROMPTS, max_new_tokens=8) == _reference(), side
        state = ns.journal.replay_journal(path)
        assert not state.incomplete()
        for uid, entry in state.entries.items():
            assert entry.prompt + entry.emitted == _reference()[uid]
            assert entry.terminal["status"] == "ok" and entry.sampling_key == (0, uid)
        ft = eng.health()["fault_tolerance"]
        assert ft["journaling"] and ft["journal_bytes"] == os.path.getsize(path) > 0
        assert "fault_tolerance" in eng.state_snapshot()
        # the admit records' wall stamps are the real clock's: the states
        # differ there and the files in those digits
        states[side] = {u: {k: v for k, v in e.items() if k != "admit_wall"}
                        for u, e in plain(state)["entries"].items()}
        health[side] = {k: v for k, v in ft.items() if k != "journal_bytes"}
    assert states["port"] == states["jax"] and health["port"] == health["jax"]


@pytest.mark.parametrize("fsync_every,config", [(1, {}), (0, {}),
                                                (1, {"serving_fastpath": {"enabled": False}})],
                         ids=["strict", "throughput", "reference_loop"])
def test_engine_journals_byte_identical_and_cross_replay(tmp_path, fsync_every, config):
    """The two engines journal the same generate (one request shed over the
    cap) byte for byte under a fixed wall clock, on the fast path and on the
    reference loop, and each file replays in the other package to the same
    state."""
    prompts = PROMPTS + [list(range(1, 80))]
    paths = {}
    for side, ns in SIDES.items():
        paths[side] = str(tmp_path / f"{side}.wal")
        j = ns.journal.RequestJournal(paths[side], fsync_every=fsync_every,
                                      wall_clock=FakeClock(1000.0), seed=0)
        results = _engine(side, config, journal=j).generate(prompts, max_new_tokens=8,
                                                            strict=False)
        j.close()
        assert [r.status for r in results] == ["ok"] * 4 + ["shed"]
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    for path in paths.values():
        assert plain(journal.replay_journal(path)) == plain(jjournal.replay_journal(path))


def test_put_step_journal_replays_across_packages(tmp_path):
    """The step()-level API journals too (admits with max_new_tokens 0, a
    terminal at flush), and the file replays alike in both packages."""
    paths = {}
    for side, ns in SIDES.items():
        paths[side] = str(tmp_path / f"{side}.wal")
        j = ns.journal.RequestJournal(paths[side], wall_clock=FakeClock(7.0))
        eng = _engine(side, journal=j)
        eng.put([0, 1], PROMPTS[:2])
        for _ in range(6):
            eng.step()
        eng.flush(0)
        j.close()
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    state = journal.replay_journal(paths["port"])
    assert state.entries[0].done and not state.entries[1].done
    assert plain(state) == plain(jjournal.replay_journal(paths["port"]))


def test_shed_terminal_reaches_the_journal(tmp_path):
    for side, ns in SIDES.items():
        path = str(tmp_path / f"{side}.wal")
        results = _engine(side, _ft(path)).generate([PROMPTS[0], list(range(1, 80))],
                                                    max_new_tokens=4, strict=False)
        assert results[1].status == "shed"
        state = ns.journal.replay_journal(path)
        assert not state.incomplete() and state.entries[1].terminal["status"] == "shed"


def test_serve_recovered_continues_from_prefix():
    got = {}
    for side, ns in SIDES.items():
        eng = _engine(side)
        reqs = [ns.admission.RecoveredRequest(uid=u, prompt=p, pin_ttl=True,
                                              prefix=_reference()[u][len(p):len(p) + 3])
                for u, p in enumerate(PROMPTS)]
        results = eng.serve_recovered(reqs, max_new_tokens=8)
        assert [results[u].tokens for u in range(len(PROMPTS))] == _reference(), side
        assert all(results[u].status == "ok" for u in results)
        assert eng.health()["fault_tolerance"]["recovered_requests_total"] == len(PROMPTS)
        recorder = eng.tracer.recorder.tail()
        got[side] = ([(e["uid"], e["prefix"]) for e in recorder if e["event"] == "recovered"],
                     [e["uid"] for e in recorder if e["event"] == "admit" and e.get("recovered")])
    assert got["port"] == got["jax"] and len(got["port"][0]) == len(PROMPTS)


def test_recovered_request_keeps_original_ttl(tmp_path):
    for side, ns in SIDES.items():
        path = str(tmp_path / f"{side}.wal")
        j = ns.journal.RequestJournal(path, fsync_every=1, wall_clock=FakeClock(100.0))
        j.record_admit(0, PROMPTS[0], ttl_s=10.0, max_new_tokens=8)
        j.note_tokens(0, [7])
        j.flush()
        j.close()
        eng = _engine(side)
        eng.journal = ns.journal.RequestJournal(path, fsync_every=1,
                                                wall_clock=FakeClock(120.0))
        results = ns.supervisor.recover_and_serve(eng, [ns.supervisor.ServeSpec(0, PROMPTS[0])],
                                                  max_new_tokens=8, wall_clock=FakeClock(120.0))
        assert results[0].status == "deadline_expired"
        assert results[0].tokens == PROMPTS[0] + [7]
        eng.journal.close()
        assert ns.journal.replay_journal(path).entries[0].terminal["status"] == "deadline_expired"


def crashy(journal_cls):
    """A journal whose second writing flush raises: an engine crash at
    wave 2."""

    class CrashyJournal(journal_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.writes = 0

        def flush(self):
            wrote = super().flush()
            if wrote:
                self.writes += 1
                if self.writes >= 2:
                    raise RuntimeError("injected crash at wave 2")
            return wrote

    return CrashyJournal


def test_supervisor_inprocess_crash_recovery(tmp_path):
    tokens = {}
    for side, ns in SIDES.items():
        path = str(tmp_path / f"{side}.wal")
        builds = []

        def factory():
            eng = _engine(side)
            builds.append(eng)
            if len(builds) == 1:
                eng.journal = crashy(ns.journal.RequestJournal)(path, fsync_every=1)
                eng.journal.open_generation(0)
            return eng

        sup = ns.supervisor.ServingSupervisor(factory, journal_path=path,
                                              config={"max_restarts": 2})
        results = sup.serve(PROMPTS, max_new_tokens=8)
        assert sup.restarts_total == 1 and not sup.degraded, side
        assert all(r.status == "ok" for r in results)
        tokens[side] = [r.tokens for r in results]
        events = [e["event"] for e in sup.recorder.tail()]
        assert events.count("worker_failed") == 1 and "run_complete" in events
        ft = builds[-1].health()["fault_tolerance"]
        assert ft["restarts_total"] == 1 and ft["recovered_requests_total"] > 0
        assert sup.recovered_requests_total == ft["recovered_requests_total"]
        state = ns.journal.replay_journal(path)
        assert state.generations == 2 and not state.incomplete()
    assert tokens["port"] == tokens["jax"] == _reference()


def test_supervisor_budget_exhaustion_drains_and_finalizes(tmp_path):
    got = {}
    for side, ns in SIDES.items():
        path = str(tmp_path / f"{side}.wal")

        def factory():
            eng = _engine(side)

            def boom(manager):
                raise RuntimeError("scheduler wedged")

            eng.scheduler.schedule = boom
            return eng

        sup = ns.supervisor.ServingSupervisor(factory, journal_path=path,
                                              config={"max_restarts": 0})
        results = sup.serve(PROMPTS, max_new_tokens=8)
        assert sup.degraded and all(r.status == "failed" and r.retryable for r in results)
        state = ns.journal.replay_journal(path)
        assert not state.incomplete(), "finalization left journal entries non-terminal"
        events = [e["event"] for e in sup.recorder.tail()]
        assert "degraded" in events and "finalized" in events
        got[side] = ([plain(r) for r in results], events, sup.restarts_total,
                     {u: e.terminal for u, e in state.entries.items()})
    assert got["port"] == got["jax"]


def test_supervisor_refuses_mismatched_engine_journal(tmp_path):
    for side, ns in SIDES.items():

        def factory():
            eng = _engine(side)
            eng.journal = ns.journal.RequestJournal(str(tmp_path / f"other_{side}.wal"))
            return eng

        sup = ns.supervisor.ServingSupervisor(factory, journal_path=str(tmp_path / "mine.wal"))
        with pytest.raises(ValueError, match=f"other_{side}.wal"):
            sup._build_engine(0)


def test_supervise_command_exports_fsync_policy(tmp_path):
    for side, ns in SIDES.items():
        out = str(tmp_path / f"{side}.txt")
        sup = ns.supervisor.ServingSupervisor(
            journal_path=str(tmp_path / f"{side}.wal"),
            config={"fsync_every": 0, "max_restarts": 0, "poll_interval_s": 0.01})
        report = sup.supervise_command(
            [sys.executable, "-c", "import os; open(os.environ['OUT'], 'w').write("
             "os.environ['DSTPU_SERVING_FSYNC_EVERY'] + os.environ['DSTPU_SERVING_GENERATION'])"],
            env={"OUT": out}, heartbeat_base=str(tmp_path / f"hb_{side}"))
        assert report["restarts"] == 0 and report["generations"] == 1
        assert open(out).read() == "00"


def test_engine_env_arming_honors_fsync_policy(tmp_path, monkeypatch):
    monkeypatch.setenv(heartbeat.SERVING_FSYNC_ENV, "0")
    monkeypatch.setenv(heartbeat.SERVING_GENERATION_ENV, "3")
    monkeypatch.setenv(heartbeat.HEARTBEAT_DIR_ENV, str(tmp_path / "hb"))
    for side in SIDES:
        monkeypatch.setenv(heartbeat.SERVING_JOURNAL_ENV, str(tmp_path / f"{side}.wal"))
        eng = _engine(side)
        assert eng.journal is not None and eng.journal.fsync_every == 0, side
        assert eng._heartbeat.enabled and eng._heartbeat.generation == 3
    # the env heartbeat dir counts only under a supervisor (the journal env)
    monkeypatch.delenv(heartbeat.SERVING_JOURNAL_ENV)
    for side in SIDES:
        eng = _engine(side)
        assert eng.journal is None and not eng._heartbeat.enabled


def test_supervisor_budget_window_prunes_old_failures(tmp_path):
    for ns in SIDES.values():
        clock = FakeClock(0.0)
        sup = ns.supervisor.ServingSupervisor(journal_path=str(tmp_path / "j.wal"),
                                              config={"max_restarts": 1,
                                                      "restart_window_s": 100.0},
                                              clock=clock)
        sup._note_failure("first")
        assert not sup._budget_exhausted()
        clock.advance(200.0)  # the first failure ages out of the window
        sup._note_failure("second")
        assert not sup._budget_exhausted()
        clock.advance(1.0)
        sup._note_failure("third")  # two failures inside one window
        assert sup._budget_exhausted()


# =============================================================== port only
def _drive_generate(eng):
    return [r.tokens for r in eng.generate(PROMPTS + [list(range(1, 80))], max_new_tokens=8,
                                           strict=False)]


def _drive_put_step(eng):
    eng.put([0, 1, 2], PROMPTS[:3])
    out = {u: [] for u in range(3)}
    for _ in range(8):
        for uid, tok in eng.step().items():
            out[uid].append(tok)
    for uid in range(3):
        eng.flush(uid)
    return out


def _drive_decode_burst(eng):
    eng.put([0, 1, 2], PROMPTS[:3])
    out = {}
    while len(out) < 3:
        out.update(eng.step())
    out = {uid: [tok] for uid, tok in out.items()}
    for uid, toks in eng.decode_burst(6).items():
        out[uid] += toks
    for uid in range(3):
        eng.flush(uid)
    return out


@pytest.mark.parametrize("drive", [_drive_generate, _drive_put_step, _drive_decode_burst],
                         ids=lambda f: f.__name__[7:])
def test_journal_and_heartbeat_leave_tokens_and_counters(drive, tmp_path):
    """Journaling (strict mode, each record fsynced) and a heartbeat stamped
    every iteration leave the tokens and every ServeCounters field as they
    are with both off: the journal and the stamps read only host ints."""
    on = _engine("port", _ft(str(tmp_path / "j.wal"), heartbeat=True,
                             heartbeat_dir=str(tmp_path / "hb"), heartbeat_interval_s=0.0))
    off = _engine("port")
    assert drive(on) == drive(off)
    assert on.counters.snapshot() == off.counters.snapshot()
    assert on.journal.records_written > 0
    ft = on.health()["fault_tolerance"]
    assert ft["journaling"] and ft["heartbeat"]
    if drive is _drive_generate:
        assert on._heartbeat.stamps_written == on.counters.loop_iterations
        assert heartbeat.read_heartbeats(str(tmp_path / "hb"))[0]["phase"] == "serving"
    on.journal.close()
    state = journal.replay_journal(str(tmp_path / "j.wal"))
    assert state.entries and all(e.done for e in state.entries.values())


def _workers(out):
    """The per-generation records the workers wrote so far."""
    if not os.path.exists(out):
        return []
    return [json.loads(line) for line in open(out) if line.endswith("\n")]


class Deadline:
    """A supervised case's own time limit: past ``seconds`` it kills every
    worker the run has started and keeps killing new ones, so the
    supervisor spends its restart budget and returns; the test then fails
    on ``expired``."""

    def __init__(self, seconds, out):
        self.expired = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(seconds, out), daemon=True)

    def _run(self, seconds, out):
        if self._stop.wait(seconds):
            return
        self.expired = True
        while not self._stop.wait(0.2):
            for w in _workers(out):
                try:
                    os.kill(w["pid"], signal.SIGKILL)
                except ProcessLookupError:
                    pass

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)


def _supervise_worker(tmp_path, fault, seconds, **cfg):
    """Supervise this file's worker with ``fault`` in its first generation,
    within ``seconds``; returns the report, the supervisor and the
    per-generation records."""
    out = str(tmp_path / "workers.jsonl")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sup = supervisor.ServingSupervisor(
        journal_path=str(tmp_path / "j.wal"),
        config={"max_restarts": 2, "heartbeat_interval_s": 0.05, "poll_interval_s": 0.02,
                **cfg})
    env = {"PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    with Deadline(seconds, out) as deadline:
        report = sup.supervise_command(
            [sys.executable, os.path.abspath(__file__), "worker", fault, out], env=env,
            cwd=root, heartbeat_base=str(tmp_path / "hb"))
    assert not deadline.expired, f"the supervised run took more than {seconds} s"
    workers = _workers(out)
    for w in workers:  # every generation's process was reaped: no orphan
        with pytest.raises(ProcessLookupError):
            os.kill(w["pid"], 0)
    return report, sup, workers


def _uninterrupted_worker_run():
    cfg, params = _worker_model(llama, torch)
    eng = InferenceEngineV2(llama, cfg, params, config={"dtype": "float32"}, device="cpu", **KW)
    return eng.generate(WORKER_PROMPTS, max_new_tokens=8)


def test_subprocess_worker_crash_with_torn_tail_recovers(tmp_path):
    report, sup, workers = _supervise_worker(tmp_path, "crash", seconds=90)
    assert (report["generations"], report["restarts"], report["degraded"]) == (2, 1, False)
    assert [w["generation"] for w in workers] == [0, 1]
    assert workers[0]["tail"] is None and "torn" in workers[1]["tail"]
    failed = [e for e in sup.recorder.tail() if e["event"] == "worker_failed"]
    assert len(failed) == 1 and "rc=3" in failed[0]["detail"]
    state = report["state"]
    assert state.generations == 2 and not state.incomplete() and state.truncated_tail is None
    assert sup.recovered_requests_total == sum(e.admits > 1 for e in state.entries.values()) > 0
    assert [report["results"][u].tokens for u in range(len(WORKER_PROMPTS))] \
        == _uninterrupted_worker_run()


def test_subprocess_worker_hang_found_by_heartbeat_staleness(tmp_path):
    report, sup, workers = _supervise_worker(tmp_path, "hang", seconds=90, hang_timeout_s=3.0,
                                             startup_grace_s=60.0)
    assert (report["generations"], report["restarts"], report["degraded"]) == (2, 1, False)
    events = sup.recorder.tail()
    hang = [e for e in events if e["event"] == "hang_detected"]
    failed = [e for e in events if e["event"] == "worker_failed"]
    assert len(hang) == 1 and hang[0]["age_s"] >= 3.0  # rounded to 0.01 s
    assert len(failed) == 1 and "heartbeat stale" in failed[0]["detail"]
    assert not report["state"].incomplete()
    assert [report["results"][u].tokens for u in range(len(WORKER_PROMPTS))] \
        == _uninterrupted_worker_run()

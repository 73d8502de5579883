"""The port's multi-tenant QoS on the CPU against the JAX package's.

``deepspeed_tpu_torch/inference/v2/qos.py`` and the QoS seams of the
admission queue, the ragged manager, the scheduler, the journal, the
supervisor's recovery planner, the tracer and the engine, held to their
``deepspeed_tpu`` counterparts case by case (the cases of the JAX package's
``tests/unit/inference/test_serving_qos.py`` but its router cases, which
``tests/test_torch_fleet.py`` carries):

- units: the same calls into both packages (token-bucket ``(ok,
  retry_after)`` sequences over one schedule, DRR ``select`` sequences over
  synthetic traces, quota verdicts and shed structures, fair dequeue order,
  tenant-seeded hash chains, the census's cross-tenant audit, journal bytes
  and recovery plans) must give equal results, exactly;
- engines, the JAX engine against the port's on the tiny fp32 Llama with the
  same weights (``params_from_jax``) under a FakeClock: QoS on against off
  with one tenant (tokens, ``ServeCounters``, journal bytes), a quota shed
  end to end (results, journal bytes, ``health()["qos"]``), recovery into a
  fresh engine that takes its identity from the journal, the tenant SLO
  families, and the ``qos_smoke`` lane's noisy-neighbour workload under a
  25 % faulty allocator (results, accounting, the ``serving_tenant_*``
  exposition apart from :data:`ENGINE_ONLY`).

Logits are not compared: tokens, host state, journals and exposition text
are, at exact equality.  The JAX engines of one pool size share one program
cache, so their bucket programs are compiled once for the module."""

import dataclasses
import json
import types

import jax
import numpy as np
import pytest

import deepspeed_tpu.inference.v2.admission as jadmission
import deepspeed_tpu.inference.v2.journal as jjournal
import deepspeed_tpu.inference.v2.kv_metrics as jkv
import deepspeed_tpu.inference.v2.qos as jqos
import deepspeed_tpu.inference.v2.ragged_manager as jmanager
import deepspeed_tpu.inference.v2.supervisor as jsupervisor
import deepspeed_tpu.monitor.exposition as jexposition
import deepspeed_tpu.monitor.metrics as jmetrics
import deepspeed_tpu.utils.wal as jwal
import deepspeed_tpu_torch.inference.v2.admission as admission
import deepspeed_tpu_torch.inference.v2.journal as journal
import deepspeed_tpu_torch.inference.v2.kv_metrics as kv
import deepspeed_tpu_torch.inference.v2.qos as qos
import deepspeed_tpu_torch.inference.v2.ragged_manager as manager
import deepspeed_tpu_torch.inference.v2.supervisor as supervisor
import deepspeed_tpu_torch.monitor.exposition as exposition
import deepspeed_tpu_torch.monitor.metrics as metrics
import deepspeed_tpu_torch.utils.wal as wal
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.runtime.config import ServingQosConfig as JaxQosConfig
from deepspeed_tpu_torch.inference.config import load_inference_config
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.runtime.config import ServingQosConfig
from tests.test_torch_fastpath import FaultyBlockedAllocator
from tests.test_torch_ops_plane import ENGINE_ONLY
from tests.unit.fault_injection_serving import FakeClock
from tests.unit.fault_injection_serving import FaultyBlockedAllocator as JaxFaultyAllocator

SIDES = {
    "jax": types.SimpleNamespace(qos=jqos, admission=jadmission, journal=jjournal, kv=jkv,
                                 manager=jmanager, supervisor=jsupervisor, wal=jwal,
                                 metrics=jmetrics, exposition=jexposition, Config=JaxQosConfig),
    "port": types.SimpleNamespace(qos=qos, admission=admission, journal=journal, kv=kv,
                                  manager=manager, supervisor=supervisor, wal=wal,
                                  metrics=metrics, exposition=exposition,
                                  Config=ServingQosConfig),
}
BS = 8
INTERACTIVE, BATCH, BEST_EFFORT = qos.INTERACTIVE, qos.BATCH, qos.BEST_EFFORT
# the JAX suite's tiny_engine: pool, scheduler and block size
KW = dict(num_blocks=64, block_size=BS, max_blocks_per_seq=8, token_budget=32,
          max_seqs_per_step=8)
HEADER = list(range(100, 124))  # 3 full shared blocks

_CACHE = {}


def plain(obj):
    """A dataclass (or a dict/list of them) as plain data, comparable across
    the packages."""
    if dataclasses.is_dataclass(obj):
        return {k: plain(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    return obj


def both(case, tmp_path=None):
    """Run ``case(ns[, directory])`` against each package; the results must
    be equal.  Returns the port's."""
    got = {}
    for side, ns in SIDES.items():
        if tmp_path is None:
            got[side] = case(ns)
        else:
            d = tmp_path / side
            d.mkdir()
            got[side] = case(ns, d)
    assert got["port"] == got["jax"]
    return got["port"]


def _policy(ns, clock, **cfg):
    cfg.setdefault("enabled", True)
    return ns.qos.QosPolicy(ns.Config(**cfg), clock=clock)


# ========================================================= token bucket math
def _bucket_exact_refill(ns):
    b = ns.qos.TokenBucket(rate=10.0, burst=20.0)
    out = [b.try_take(20.0, now=0.0), b.try_take(5.0, now=0.0), b.try_take(5.0, now=0.5),
           b.try_take(3.0, now=0.7)]
    # a fresh bucket holds its full burst; 5 missing tokens at 10 tok/s;
    # waiting EXACTLY the hint admits; 0.2 s banks 2 tokens
    assert out[0] == (True, 0.0) and not out[1][0] and out[1][1] == pytest.approx(0.5)
    assert out[2] == (True, 0.0) and not out[3][0] and out[3][1] == pytest.approx(0.1)
    return out


def _bucket_cost_above_burst(ns):
    b = ns.qos.TokenBucket(rate=4.0, burst=8.0)
    out = [b.try_take(8.0, now=0.0), b.try_take(100.0, now=0.0)]
    # an over-burst cost can never fit: the hint is the time to a full bucket
    assert not out[1][0] and out[1][1] == pytest.approx(2.0)
    return out


def _bucket_never_overfills(ns):
    b = ns.qos.TokenBucket(rate=100.0, burst=10.0)
    out = [b.try_take(10.0, now=0.0), b.try_take(10.0, now=1000.0),
           b.try_take(10.1, now=1000.0)]
    assert out[1][0] and not out[2][0]  # the gap banked one burst, not rate*gap
    return out, b.level, b.last


@pytest.mark.parametrize("case", [_bucket_exact_refill, _bucket_cost_above_burst,
                                  _bucket_never_overfills], ids=lambda f: f.__name__[8:])
def test_token_bucket_matches_jax(case):
    both(case)


# ======================================================= deficit round robin
def _drain(drr, backlogs, rounds):
    """``rounds`` selects against per-class backlogs of (cost, tag): the
    dequeue order as tags."""
    order = []
    for _ in range(rounds):
        head_costs = {c: q[0][0] for c, q in backlogs.items() if q}
        if not head_costs:
            break
        c = drr.select(head_costs)
        if c is None:
            break
        order.append(backlogs[c].pop(0)[1])
    return order


WEIGHTS = {INTERACTIVE: 8.0, BATCH: 2.0, BEST_EFFORT: 1.0}


def _drr_weights(ns):
    drr = ns.qos.DeficitRoundRobin(WEIGHTS, quantum=16)
    backlogs = {c: [(16, c)] * 400 for c in (INTERACTIVE, BATCH, BEST_EFFORT)}
    order = _drain(drr, backlogs, 330)
    share = {c: order.count(c) / len(order) for c in (INTERACTIVE, BATCH, BEST_EFFORT)}
    assert share[INTERACTIVE] == pytest.approx(8 / 11, abs=0.02)
    assert share[BATCH] == pytest.approx(2 / 11, abs=0.02)
    assert share[BEST_EFFORT] == pytest.approx(1 / 11, abs=0.02)
    return order, drr.deficit


def _drr_never_starves(ns):
    drr = ns.qos.DeficitRoundRobin(WEIGHTS, quantum=8)
    order = _drain(drr, {INTERACTIVE: [(8, INTERACTIVE)] * 1000,
                         BEST_EFFORT: [(64, BEST_EFFORT)]}, 200)
    assert BEST_EFFORT in order and order.index(BEST_EFFORT) < 100
    return order


def _drr_rerun_identical(ns):
    trace = {INTERACTIVE: [(7, f"i{k}") for k in range(40)],
             BATCH: [(23, f"b{k}") for k in range(40)],
             BEST_EFFORT: [(11, f"e{k}") for k in range(40)]}
    runs = [_drain(ns.qos.DeficitRoundRobin(WEIGHTS, 16), {c: list(q) for c, q in trace.items()},
                   120) for _ in range(2)]
    assert runs[0] == runs[1]
    return runs[0]


def _drr_empty_forfeits(ns):
    drr = ns.qos.DeficitRoundRobin({INTERACTIVE: 1.0, BATCH: 1.0, BEST_EFFORT: 1.0}, quantum=10)
    picks = [drr.select({INTERACTIVE: 10, BATCH: 10}) for _ in range(5)]
    picks.append(drr.select({INTERACTIVE: 10}))
    assert drr.deficit[BATCH] == 0.0  # the idle class's banked credit is gone
    return picks, drr.deficit


@pytest.mark.parametrize("case", [_drr_weights, _drr_never_starves, _drr_rerun_identical,
                                  _drr_empty_forfeits], ids=lambda f: f.__name__[5:])
def test_drr_matches_jax(case):
    both(case)


# ===================================================== quota policy verdicts
def _rate_quota_shed(ns):
    clock = FakeClock(100.0)
    pol = _policy(ns, clock, tenant_tokens_per_s=10.0, tenant_token_burst=20.0)
    verdicts = [pol.admission_check("alice", INTERACTIVE, 20),
                pol.admission_check("alice", INTERACTIVE, 10),
                pol.admission_check("bob", INTERACTIVE, 20)]
    clock.advance(1.0)
    verdicts.append(pol.admission_check("alice", INTERACTIVE, 10))
    shed = verdicts[1]
    assert verdicts[0] is None and verdicts[2] is None and verdicts[3] is None
    assert shed.code == ns.qos.QUOTA_EXCEEDED and shed.retryable
    assert shed.retry_after_s == pytest.approx(1.0) and "alice" in shed.detail
    return plain(verdicts), str(shed)


def _kv_quota_shed(ns):
    pol = _policy(ns, FakeClock(0.0), tenant_max_kv_blocks=4)
    usage = {"alice": 4}
    pol.kv_blocks_of = lambda t: usage.get(t, 0)
    out = [plain(pol.admission_check("alice", BATCH, 8)), pol.admission_check("bob", BATCH, 8),
           pol.over_kv_quota("alice")]
    usage["alice"] = 5
    out.append(pol.over_kv_quota("alice"))
    assert out[0]["code"] == ns.qos.QUOTA_EXCEEDED and 0.0 < out[0]["retry_after_s"] <= 2.0
    assert out[1:] == [None, False, True]
    return out


def _quota_overrides(ns):
    pol = _policy(ns, FakeClock(0.0), tenant_tokens_per_s=10.0, tenant_max_kv_blocks=4,
                  tenants={"vip": {"tokens_per_s": 1000.0, "max_kv_blocks": 64}})
    vip, std = pol.quota_for("vip"), pol.quota_for("anyone")
    assert (vip.tokens_per_s, vip.max_kv_blocks, vip.token_burst) == (1000.0, 64, 1000.0)
    assert (std.tokens_per_s, std.max_kv_blocks, std.token_burst) == (10.0, 4, 10.0)
    return plain(vip), plain(std)


def _unknown_class(ns):
    pol = _policy(ns, FakeClock(0.0))
    with pytest.raises(ValueError, match="unknown service class") as err:
        pol.service_class("platinum")
    return pol.service_class(None), str(err.value)


def _victim_rank(ns):
    class Seq:
        def __init__(self, tenant, cls, arrival):
            self.tenant, self.service_class, self.arrival = tenant, cls, arrival

    pol = _policy(ns, FakeClock(0.0), tenant_max_kv_blocks=4)
    pol.kv_blocks_of = lambda t: {"hog": 9}.get(t, 0)
    seqs = [Seq("hog", INTERACTIVE, 1.0), Seq("ok", BEST_EFFORT, 5.0), Seq("ok", INTERACTIVE, 9.0)]
    ranked = sorted(seqs, key=lambda s: pol.victim_rank(s) + (s.arrival,))
    # max() picks the end: the over-quota hog first, then best effort
    assert [s.arrival for s in ranked] == [9.0, 5.0, 1.0]
    off = _policy(ns, FakeClock(0.0), preempt_over_quota=False)
    assert off.victim_rank(seqs[0]) == (0, 0) == off.victim_rank(seqs[1])
    return [pol.victim_rank(s) for s in seqs], [s.arrival for s in ranked]


@pytest.mark.parametrize("case", [_rate_quota_shed, _kv_quota_shed, _quota_overrides,
                                  _unknown_class, _victim_rank], ids=lambda f: f.__name__[1:])
def test_policy_matches_jax(case):
    both(case)


def test_config_section_has_the_jax_fields_defaults_and_bounds():
    ours, theirs = load_inference_config(None).serving_qos, JaxQosConfig()
    assert list(type(ours)._fields) == list(type(theirs)._fields)
    for field in type(ours)._fields:
        assert getattr(ours, field) == getattr(theirs, field), field
    for bad in ({"default_class": "platinum"}, {"interactive_weight": 0},
                {"tenant_tokens_per_s": -1.0}, {"drr_quantum_tokens": 0}):
        for cls in (ServingQosConfig, JaxQosConfig):
            with pytest.raises(ValueError):
                cls(**bad)


# ================================================== fair dequeue (the queue)
def _queue(ns, clock, **cfg):
    pol = _policy(ns, clock, **cfg)
    return ns.admission.AdmissionQueue(clock=clock, qos=pol), pol


def _queue_fair_dequeue(ns):
    def run():
        clock = FakeClock(0.0)
        q, _ = _queue(ns, clock, interactive_weight=4, batch_weight=1, best_effort_weight=1,
                      drr_quantum_tokens=8)
        uid = 0
        for _ in range(12):
            for cls in (BATCH, INTERACTIVE, BEST_EFFORT):
                assert q.submit(uid, [1] * 8, service_class=cls) is None
                uid += 1
        order = []
        while len(q):
            ticket, expired = q.pop_ready()
            assert not expired
            order.append((ticket.uid, ticket.service_class))
        return order

    a, b = run(), run()
    assert a == b and [c for _, c in a[:12]].count(INTERACTIVE) >= 7
    inter = [u for u, c in a if c == INTERACTIVE]
    assert inter == sorted(inter)  # FIFO within a class
    return a


def _queue_expired_no_deficit(ns):
    clock = FakeClock(0.0)
    q, _ = _queue(ns, clock, interactive_weight=1, batch_weight=1, best_effort_weight=1,
                  drr_quantum_tokens=64)
    q.submit(0, [1] * 8, service_class=BATCH, ttl_s=5.0)
    q.submit(1, [1] * 8, service_class=INTERACTIVE)
    clock.advance(10.0)  # the batch ticket dies queued
    ticket, expired = q.pop_ready()
    assert [t.uid for t in expired] == [0] and ticket.uid == 1
    assert q._drr.deficit[BATCH] == 0.0 and len(q) == 0
    return plain(ticket), plain(expired), q._drr.deficit


def _queue_quota_shed_counts(ns):
    clock = FakeClock(0.0)
    q, pol = _queue(ns, clock, tenant_tokens_per_s=4.0, tenant_token_burst=4.0)
    out = [q.submit(0, [1] * 4, tenant="noisy"), q.submit(1, [1] * 4, tenant="noisy"),
           # recovered work bypasses the quota: its cost was charged pre-crash
           q.submit(2, [1] * 4, tenant="noisy", recovered=True, apply_default_ttl=False)]
    shed = out[1]
    assert out[0] is None and out[2] is None and shed.code == ns.qos.QUOTA_EXCEEDED
    assert q.shed_by_code[ns.qos.QUOTA_EXCEEDED] == 1
    assert pol.shed_by_tenant[("noisy", ns.qos.QUOTA_EXCEEDED)] == 1
    assert pol.last_retry_after_by_tenant["noisy"] == shed.retry_after_s
    return plain(out), q.shed_by_code, q.last_retry_after, pol.snapshot(), len(q)


def _queue_without_qos(ns):
    q = ns.admission.AdmissionQueue(clock=FakeClock(0.0))
    assert q.submit(0, [1, 2], tenant="anyone", service_class=BATCH) is None
    assert q._drr is None and not q._classes and len(q._heap) == 1
    ticket, _ = q.pop_ready()
    assert ticket.tenant == "anyone" and ticket.service_class == BATCH
    return plain(ticket)


@pytest.mark.parametrize("case", [_queue_fair_dequeue, _queue_expired_no_deficit,
                                  _queue_quota_shed_counts, _queue_without_qos],
                         ids=lambda f: f.__name__[7:])
def test_queue_matches_jax(case):
    both(case)


# ============================================ tenant keying and the census
def _manager(ns, num_blocks=32):
    m = ns.manager.RaggedStateManager(num_blocks, BS, 8, prefix_cache=ns.manager.PrefixCache(BS))
    m.census = ns.kv.BlockCensus(BS, num_blocks, m.trash_block)
    return m


def _prefill(m, seq):
    m.ensure_blocks(seq, len(seq.tokens))
    seq.seen_tokens = len(seq.tokens)
    m.register_prefix_blocks(seq)


def _namespace_seeds_chain(ns):
    tokens = list(range(32))
    default = ns.kv.block_hashes(tokens, BS)
    a = ns.kv.block_hashes(tokens, BS, ns.kv.tenant_namespace("alice"))
    b = ns.kv.block_hashes(tokens, BS, ns.kv.tenant_namespace("bob"))
    assert ns.kv.block_hashes(tokens, BS, ns.kv.tenant_namespace("default")) == default
    assert ns.kv.block_hashes(tokens, BS, ns.kv.tenant_namespace(None)) == default
    assert len(a) == len(b) == len(default) == 4
    assert not set(a) & set(b) and not set(a) & set(default)  # disjoint at every depth
    return default, a, b


def _cross_tenant_sharing_zero(ns):
    m = _manager(ns)
    a1 = m.add_sequence(0, HEADER + [1], tenant="alice")
    _prefill(m, a1)
    hits = m.prefix_cache.hits_total
    b = m.add_sequence(1, HEADER + [1], tenant="bob")
    mapped_b = m.map_prefix(b)
    assert mapped_b == 0 and m.prefix_cache.hits_total == hits
    assert not set(b.blocks) & set(a1.blocks)
    a2 = m.add_sequence(2, HEADER + [2], tenant="alice")
    assert m.map_prefix(a2) == 3 * BS and a2.blocks[:3] == a1.blocks[:3]
    assert m.prefix_cache.hits_total == hits + 3
    m.census.check_against(m.allocator, m.seqs)
    return ({u: list(s.blocks) for u, s in m.seqs.items()}, m.prefix_cache.snapshot(),
            m.tenant_block_usage(), m.tenant_blocks("alice"), m.tenant_blocks("bob"))


def _census_catches_cross_tenant(ns):
    m = _manager(ns)
    a1 = m.add_sequence(0, HEADER + [1], tenant="alice")
    _prefill(m, a1)
    a2 = m.add_sequence(1, HEADER + [2], tenant="alice")
    assert m.map_prefix(a2) == 3 * BS
    m.census.check_against(m.allocator, m.seqs)
    a2.tenant = "mallory"  # a namespace bypass: the audit names the block
    with pytest.raises(ns.kv.CensusInvariantError, match="ACROSS tenants") as err:
        m.census.check_against(m.allocator, m.seqs)
    return str(err.value)


def _default_tenant_hashes(ns):
    m = _manager(ns)
    seq = m.add_sequence(0, HEADER + [1])
    assert seq.tenant == "default" and seq.service_class == INTERACTIVE
    # the default tenant's keying is the policy-free one, byte for byte
    assert seq.prefix_hashes == ns.kv.block_hashes(HEADER, BS)
    return seq.prefix_hashes


@pytest.mark.parametrize("case", [_namespace_seeds_chain, _cross_tenant_sharing_zero,
                                  _census_catches_cross_tenant, _default_tenant_hashes],
                         ids=lambda f: f.__name__[1:])
def test_tenant_keying_matches_jax(case):
    both(case)


# ============================================ journal + recovery identity
def _journal_carries_identity(ns, d):
    path = str(d / "qos.journal")
    j = ns.journal.RequestJournal(path, wall_clock=FakeClock(50.0))
    j.record_admit(1, [1, 2, 3], tenant="alice", service_class=BATCH)
    j.record_admit(2, [4, 5])
    j.record_terminal(1, admission.SHED, reason="quota", retryable=True,
                      shed_code=qos.QUOTA_EXCEEDED)
    j.record_terminal(2, admission.OK, finish_reason="eos")
    j.close()
    state = ns.journal.replay_journal(path)
    e1, e2 = state.entries[1], state.entries[2]
    assert (e1.tenant, e1.service_class, e1.terminal["code"]) == ("alice", BATCH,
                                                                  qos.QUOTA_EXCEEDED)
    assert (e2.tenant, e2.service_class) == ("default", INTERACTIVE)
    with open(path, "rb") as f:
        data = f.read()
    records = [json.loads(payload) for payload, _ in ns.wal.iter_frames(data)]
    admit2 = next(r for r in records if r["t"] == "admit" and r["uid"] == 2)
    end2 = next(r for r in records if r["t"] == "end" and r["uid"] == 2)
    # the default identity writes no tenant/cls/code keys
    assert "tenant" not in admit2 and "cls" not in admit2 and "code" not in end2
    adopted = ns.supervisor.result_from_entry(e1)
    assert adopted.shed_code == qos.QUOTA_EXCEEDED
    return data, plain(state), plain(adopted)


def _recovery_identity_from_journal(ns, d):
    path = str(d / "launder.journal")
    j = ns.journal.RequestJournal(path, wall_clock=FakeClock(50.0))
    j.record_admit(7, [1, 2, 3], tenant="free", service_class=BEST_EFFORT, max_new_tokens=8)
    j.note_tokens(7, [9, 9])
    j.flush()
    j.close()
    state = ns.journal.replay_journal(path)
    spec = ns.supervisor.ServeSpec(uid=7, prompt=[1, 2, 3], tenant="vip",
                                   service_class=INTERACTIVE)
    plan = ns.supervisor.plan_recovery(state, [spec], max_new_tokens=8, now_wall=51.0)
    rec = plan.entries[0]
    assert (rec.tenant, rec.service_class, rec.prefix) == ("free", BEST_EFFORT, [9, 9])
    fresh = ns.supervisor.ServeSpec(uid=8, prompt=[4], tenant="vip", service_class=INTERACTIVE)
    plan2 = ns.supervisor.plan_recovery(state, [fresh], max_new_tokens=8, now_wall=51.0)
    assert (plan2.entries[-1].tenant, plan2.entries[-1].service_class) == ("vip", INTERACTIVE)
    return plain(plan), plain(plan2)


@pytest.mark.parametrize("case", [_journal_carries_identity, _recovery_identity_from_journal],
                         ids=lambda f: f.__name__[1:])
def test_journal_identity_matches_jax(case, tmp_path):
    both(case, tmp_path)


def test_journal_files_replay_across_packages(tmp_path):
    """A journal with tenants written by either package replays in the
    other's ``replay_journal`` to the same state."""
    paths = {}
    for side, ns in SIDES.items():
        paths[side] = str(tmp_path / f"{side}.wal")
        j = ns.journal.RequestJournal(paths[side], fsync_every=1, wall_clock=FakeClock(9.0))
        j.open_generation(0)
        j.record_admit(0, [1, 2], tenant="t1", service_class=BEST_EFFORT, max_new_tokens=4,
                       admit_wall=3.5)
        j.note_tokens(0, [5, 6])
        j.flush()
        j.record_admit(1, [3], service_class=BATCH, max_new_tokens=4)
        j.record_terminal(1, "shed", reason="quota", retryable=True,
                          shed_code=qos.QUOTA_EXCEEDED)
        j.close()
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    for path in paths.values():
        assert plain(journal.replay_journal(path)) == plain(jjournal.replay_journal(path))


# =============================================== engine-level acceptance
def _params():
    if "params" not in _CACHE:
        kw = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, seq=256)
        jcfg, cfg = jllama.LlamaConfig.tiny(**kw), llama.LlamaConfig.tiny(**kw)
        jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
        params = llama.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        _CACHE["params"] = (jcfg, jparams, cfg, params)
    return _CACHE["params"]


def _engine(side, config=None, **kw):
    """An engine of ``side`` over the module's weights, fp32, on the tiny
    pool of the JAX suite."""
    jcfg, jparams, cfg, params = _params()
    config = {"dtype": "float32", **(config or {})}
    kw = {**KW, **kw}
    if side == "jax":
        eng = JaxEngine(jllama, jcfg, jparams, config=config, **kw)
        # bucket programs are functions of (params, pool, batch): engines
        # with one pool size share them
        eng._fwd_cache = _CACHE.setdefault(("programs", kw["num_blocks"]), {})
        return eng
    return InferenceEngineV2(llama, cfg, params, config=config, device="cpu", **kw)


def _render(side, eng):
    reg = SIDES[side].metrics.MetricsRegistry(namespace="dstpu")
    SIDES[side].metrics.populate_from_engine(reg, eng)
    return SIDES[side].exposition.render(reg)


def _drop_engine_only(text):
    return "\n".join(line for line in text.splitlines()
                     if not any(name in line for name in ENGINE_ONLY))


def test_single_tenant_outputs_byte_identical_qos_on_vs_off(tmp_path):
    """One tenant, QoS on against off: tokens, every ServeCounters field and
    the journal's bytes identical on the port, and the tokens equal to the
    JAX engine's."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 128, int(n)).tolist() for n in rng.integers(4, 16, 5)]
    runs = {}
    for on in (False, True):
        path = str(tmp_path / f"qos_{on}.wal")
        j = journal.RequestJournal(path, fsync_every=1, wall_clock=FakeClock(100.0))
        eng = _engine("port", {"serving_qos": {"enabled": on}}, journal=j)
        out = eng.generate(prompts, max_new_tokens=6, strict=True)
        j.close()
        runs[on] = (out, eng.counters.snapshot(), open(path, "rb").read())
        assert (eng.qos is None) == (not on)
        assert (eng.admission.qos is None) == (eng.scheduler.qos is None) == (not on)
    assert runs[False] == runs[True]
    assert _engine("jax", {"serving_qos": {"enabled": True}}).generate(
        prompts, max_new_tokens=6, strict=True) == runs[True][0]


def test_engine_quota_shed_end_to_end_matches_jax(tmp_path):
    """A tenant over its rate quota: the shed result, the journal's bytes
    (its end record carrying the code), ``health()["qos"]`` and the
    adopted terminal equal the JAX engine's."""
    views = {}
    for side, ns in SIDES.items():
        path = str(tmp_path / f"{side}.wal")
        j = ns.journal.RequestJournal(path, fsync_every=1, wall_clock=FakeClock(10.0))
        eng = _engine(side, {"serving_qos": {"enabled": True, "tenant_tokens_per_s": 1.0,
                                             "tenant_token_burst": 6.0}},
                      journal=j, clock=FakeClock(tick=0.01))
        res = eng.generate([[1, 2, 3, 4], [5, 6, 7, 8]], max_new_tokens=2, strict=False,
                           tenants=["noisy", "noisy"])
        j.close()
        assert res[0].status == "ok" and res[1].status == "shed" and res[1].retryable
        assert res[1].shed_code == qos.QUOTA_EXCEEDED and res[1].retry_after_s > 0.0
        adopted = ns.supervisor.result_from_entry(ns.journal.replay_journal(path).entries[1])
        assert adopted.status == "shed" and adopted.shed_code == qos.QUOTA_EXCEEDED
        health = eng.health()["qos"]
        assert health["enabled"] and health["tenants"] == ["noisy"]
        assert health["shed_by_tenant"] == {f"noisy/{qos.QUOTA_EXCEEDED}": 1}
        views[side] = (plain(res), open(path, "rb").read(), health, plain(adopted))
    assert views["port"] == views["jax"]
    assert _engine("port").health()["qos"] == {"enabled": False}


def test_recovered_identity_survives_crash_into_fresh_engine(tmp_path):
    """A journaled in-flight batch request of tenant "free", recovered into a
    fresh QoS-armed engine from a spec that claims another identity: served
    under the journaled identity, past a quota that would shed a fresh
    admit, with results and accounting equal to the JAX engine's."""
    views = {}
    for side, ns in SIDES.items():
        path = str(tmp_path / f"{side}.wal")
        j = ns.journal.RequestJournal(path, wall_clock=FakeClock(50.0))
        j.record_admit(0, [1, 2, 3, 4], tenant="free", service_class=BATCH, max_new_tokens=6)
        j.note_tokens(0, [7, 8])
        j.flush()
        j.close()
        eng = _engine(side, {"serving_qos": {"enabled": True, "tenant_tokens_per_s": 0.5,
                                             "tenant_token_burst": 1.0}},
                      clock=FakeClock(tick=0.01))
        plan = ns.supervisor.plan_recovery(
            ns.journal.replay_journal(path),
            [ns.supervisor.ServeSpec(uid=0, prompt=[1, 2, 3, 4], tenant="vip",
                                     service_class=INTERACTIVE)],
            max_new_tokens=6, now_wall=51.0)
        results = eng.serve_recovered(plan.entries, max_new_tokens=6)
        assert results[0].status == "ok" and results[0].tokens[:6] == [1, 2, 3, 4, 7, 8]
        assert eng.qos.admitted_by_tenant == {("free", BATCH): 1}
        assert eng.qos.shed_by_tenant == {}
        assert {s.tenant for s in eng.manager.seqs.values()} <= {"free"}
        views[side] = (plain(results), eng.qos.snapshot(), plain(plan))
    assert views["port"] == views["jax"]


def test_tenant_slo_families_match_jax():
    """``populate_from_engine`` renders the ``serving_tenant_*`` families of
    a QoS-on traced serve (the per-tenant TTFT and e2e histograms: the
    tracer's ``tenant_histograms``), they strict-parse, and the exposition
    equals the JAX engine's but :data:`ENGINE_ONLY`; QoS off renders no
    tenant family."""
    texts = {}
    for side in SIDES:
        eng = _engine(side, {"serving_qos": {"enabled": True},
                             "serving_tracing": {"enabled": True}}, clock=FakeClock(tick=0.01))
        eng.generate([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], max_new_tokens=3,
                     strict=True, tenants=["alice", "bob", "alice"],
                     service_classes=[INTERACTIVE, BATCH, INTERACTIVE])
        assert sorted(eng.tracer.tenant_histograms()) == [
            ("alice", "e2e"), ("alice", "ttft"), ("bob", "e2e"), ("bob", "ttft")]
        texts[side] = _render(side, eng)
    families = exposition.parse_exposition(texts["port"])  # strict parse
    admitted = {tuple(sorted(labels.items())): value for _, labels, value
                in families["dstpu_serving_tenant_admitted_total"]["samples"]}
    assert admitted == {(("class", INTERACTIVE), ("tenant", "alice")): 2.0,
                        (("class", BATCH), ("tenant", "bob")): 1.0}
    tokens = {labels["tenant"]: value for _, labels, value
              in families["dstpu_serving_tenant_tokens_total"]["samples"]}
    assert tokens == {"alice": 8.0, "bob": 4.0}
    for family in ("dstpu_serving_tenant_ttft_seconds", "dstpu_serving_tenant_e2e_seconds"):
        counts = {labels["tenant"]: value for name, labels, value in families[family]["samples"]
                  if name == f"{family}_count"}
        assert counts == {"alice": 2.0, "bob": 1.0}, family
    assert _drop_engine_only(texts["port"]) == _drop_engine_only(texts["jax"])
    eng_off = _engine("port")
    eng_off.generate([[1, 2, 3]], max_new_tokens=2, strict=True)
    assert not [name for name in exposition.parse_exposition(_render("port", eng_off))
                if "tenant" in name]


# the qos_smoke lane's workload (run_tests.py): an interactive trickle and a
# batch-class flood tenant under a tight per-tenant override
SMOKE_INTERACTIVE = [[5, 9, 2, 14, 3, 8], [21, 4, 17, 6], [33, 7, 12, 25, 9],
                     [41, 2, 19, 30, 5, 11]]
SMOKE_FLOOD = [[(60 + i + j) % 120 + 1 for j in range(20)] for i in range(10)]
SMOKE_QOS = {"serving_tracing": {"enabled": True},
             "serving_qos": {"enabled": True,
                             "tenants": {"flood": {"tokens_per_s": 8.0, "token_burst": 24.0,
                                                   "max_kv_blocks": 16}}}}


def _qos_smoke(side):
    """The lane's three passes (warm-up, the flood-free baseline, the flood
    with the trickle behind it) on one engine under a FakeClock and 25 %
    allocator faults: the results, the ledger, health and the exposition."""
    eng = _engine(side, SMOKE_QOS, clock=FakeClock(tick=0.001))
    eng.manager.allocator = (JaxFaultyAllocator if side == "jax" else FaultyBlockedAllocator)(
        64, fail_rate=0.25, seed=11)
    initial_free = eng.manager.allocator.free_blocks
    inter = [list(p) for p in SMOKE_INTERACTIVE]
    warm = [eng.generate(inter, max_new_tokens=6, strict=False),
            eng.generate(inter + [list(SMOKE_FLOOD[0])], max_new_tokens=6, strict=False)]
    base = eng.generate(inter, max_new_tokens=6, strict=False, tenants=["int_base"] * 4,
                        service_classes=[INTERACTIVE] * 4)
    mixed = eng.generate([list(p) for p in SMOKE_FLOOD] + inter, max_new_tokens=6, strict=False,
                         tenants=["flood"] * 10 + ["int_live"] * 4,
                         service_classes=[BATCH] * 10 + [INTERACTIVE] * 4)
    flood, live = mixed[:10], mixed[10:]
    # the lane's gates but the wall-clock TTFT ratio
    assert all(r.status == "ok" for r in base + live)
    sheds = [r for r in flood if r.status == "shed"]
    quota = [r for r in sheds if r.shed_code == qos.QUOTA_EXCEEDED]
    assert quota and any(r.status == "ok" for r in flood)
    for r in sheds:
        assert r.shed_code in (qos.QUOTA_EXCEEDED, "queue_full") and r.retryable
        assert r.retry_after_s is not None and 0 < r.retry_after_s < 120
    health = eng.health()
    assert health["stalls_total"] == 0 and health["live_seqs"] == 0
    assert health["queue_depth"] == 0
    assert eng.manager.allocator.free_blocks == initial_free
    assert eng.manager.allocator.injected_failures > 0
    assert eng.qos.admitted_by_tenant[("int_live", INTERACTIVE)] == 4
    assert eng.qos.shed_by_tenant[("flood", qos.QUOTA_EXCEEDED)] == len(quota)
    view = {"results": [[(r.uid, r.status, r.shed_code, r.retry_after_s, r.tokens) for r in rs]
                        for rs in warm + [base, mixed]],
            "qos": health["qos"], "ledger": (eng.qos.admitted_by_tenant, eng.qos.shed_by_tenant,
                                             eng.qos.last_retry_after_by_tenant),
            "faults": eng.manager.allocator.injected_failures,
            "ttft": {k: dict(h.counts) for k, h in eng.tracer.tenant_histograms().items()}}
    return view, _render(side, eng)


def test_qos_smoke_workload_matches_jax():
    """The noisy-neighbour workload of the ``qos_smoke`` lane: every result
    (status, shed code, retry hint, tokens), the per-tenant ledger, the
    faults injected, the per-tenant TTFT histograms and the
    ``serving_tenant_*`` exposition equal the JAX engine's."""
    (pv, ptext), (jv, jtext) = _qos_smoke("port"), _qos_smoke("jax")
    assert pv == jv
    fams = exposition.parse_exposition(ptext)
    shed = {tuple(sorted(labels.items())): v for _, labels, v
            in fams["dstpu_serving_tenant_shed_total"]["samples"]}
    assert shed[(("code", qos.QUOTA_EXCEEDED), ("tenant", "flood"))] == float(
        pv["ledger"][1][("flood", qos.QUOTA_EXCEEDED)])
    ttft = {labels.get("tenant"): v for name, labels, v
            in fams["dstpu_serving_tenant_ttft_seconds"]["samples"] if name.endswith("_count")}
    assert ttft["int_live"] == 4.0
    assert "dstpu_serving_tenant_retry_after_seconds" in fams
    tenant_lines = lambda t: [line for line in t.splitlines() if "tenant" in line]
    assert tenant_lines(ptext) == tenant_lines(jtext)
    assert _drop_engine_only(ptext) == _drop_engine_only(jtext)


def test_put_carries_identity_into_the_manager_and_journal(tmp_path):
    """put() stamps the batch's tenant and class on each sequence, charges
    the ledger without a quota check, and journals the identity, as the
    JAX engine does (equal journal bytes and ledgers)."""
    views = {}
    for side, ns in SIDES.items():
        path = str(tmp_path / f"{side}.wal")
        j = ns.journal.RequestJournal(path, wall_clock=FakeClock(3.0))
        eng = _engine(side, {"serving_qos": {"enabled": True, "tenant_tokens_per_s": 1.0,
                                             "tenant_token_burst": 1.0}}, journal=j)
        eng.put([0, 1], [[1, 2, 3, 4], [5, 6, 7]], tenant="t", service_class=BEST_EFFORT)
        seqs = {u: (s.tenant, s.service_class) for u, s in eng.manager.seqs.items()}
        usage = eng.manager.tenant_block_usage()
        for _ in range(3):
            eng.step()
        for uid in (0, 1):
            eng.flush(uid)
        j.close()
        views[side] = (seqs, usage, eng.qos.snapshot(), open(path, "rb").read())
    assert views["port"] == views["jax"]
    assert views["port"][0] == {0: ("t", BEST_EFFORT), 1: ("t", BEST_EFFORT)}

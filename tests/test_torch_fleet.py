"""The port's fleet router on the CPU against the JAX package's.

``deepspeed_tpu_torch/inference/v2/router.py`` (``FleetRouter``) and
``monitor/metrics.populate_from_router``, held to their ``deepspeed_tpu``
counterparts case by case (the cases of the JAX package's
``tests/unit/inference/test_serving_fleet.py`` and the router cases of its
``test_serving_qos.py``):

- routing policy: both routers fed the same ``observe()`` snapshots on a
  FakeClock pick the same replicas, scores, homes and health views;
- structured backpressure, backoff and journal transplant: equal hints,
  delays, journal bytes and migration outcomes;
- shed re-route orchestration against scripted stub supervisors: equal
  results, calls, sleeps, counters and recorder events, a quota shed never
  re-routed;
- fleets of tiny fp32 Llama engines (weights through ``params_from_jax``)
  on one FakeClock: a fleet serve and a failover through the journal give
  the JAX fleet's tokens, counters and health, and the merged ``/metrics``
  equals JAX's but the :data:`ENGINE_ONLY` families;
- ``qos.py`` and ``router.py`` import neither torch nor numpy (AST).

Tokens, host state, journals and exposition text are compared at exact
equality; logits are not."""

import ast
import dataclasses
import os
import types

import jax
import numpy as np
import pytest

import deepspeed_tpu.inference.v2.admission as jadmission
import deepspeed_tpu.inference.v2.journal as jjournal
import deepspeed_tpu.inference.v2.kv_metrics as jkv
import deepspeed_tpu.inference.v2.qos as jqos
import deepspeed_tpu.inference.v2.router as jrouter
import deepspeed_tpu.inference.v2.supervisor as jsupervisor
import deepspeed_tpu.monitor.exposition as jexposition
import deepspeed_tpu.monitor.metrics as jmetrics
import deepspeed_tpu_torch.inference.v2.admission as admission
import deepspeed_tpu_torch.inference.v2.journal as journal
import deepspeed_tpu_torch.inference.v2.kv_metrics as kv
import deepspeed_tpu_torch.inference.v2.qos as qos
import deepspeed_tpu_torch.inference.v2.router as router
import deepspeed_tpu_torch.inference.v2.supervisor as supervisor
import deepspeed_tpu_torch.monitor.exposition as exposition
import deepspeed_tpu_torch.monitor.metrics as metrics
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.runtime.config import ServingFleetConfig as JaxFleetConfig
from deepspeed_tpu.runtime.config import ServingResilienceConfig as JaxResilience
from deepspeed_tpu_torch.inference.config import load_inference_config
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.runtime.config import ServingFleetConfig, ServingResilienceConfig
from tests.test_torch_ops_plane import ENGINE_ONLY
from tests.unit.fault_injection_serving import FakeClock

SIDES = {
    "jax": types.SimpleNamespace(router=jrouter, admission=jadmission, journal=jjournal, kv=jkv,
                                 qos=jqos, supervisor=jsupervisor, metrics=jmetrics,
                                 exposition=jexposition, Resilience=JaxResilience),
    "port": types.SimpleNamespace(router=router, admission=admission, journal=journal, kv=kv,
                                  qos=qos, supervisor=supervisor, metrics=metrics,
                                  exposition=exposition, Resilience=ServingResilienceConfig),
}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CACHE = {}


def plain(obj):
    if dataclasses.is_dataclass(obj):
        return {k: plain(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    return obj


def both(case, tmp_path):
    """Run ``case(ns, directory)`` against each package; the results must be
    equal.  Returns the port's."""
    got = {}
    for side, ns in SIDES.items():
        d = tmp_path / side
        d.mkdir()
        got[side] = case(ns, d)
    assert got["port"] == got["jax"]
    return got["port"]


def _no_engine():
    raise AssertionError("routing-policy tests must not build an engine")


def _router(ns, d, clock, *, replicas=3, sleeps=None, factory=_no_engine, **cfg):
    config = {"replicas": replicas, "affinity_blocks": 0, "health_stale_s": 5.0}
    config.update(cfg)
    return ns.router.FleetRouter(factory, journal_dir=str(d), config=config, block_size=4,
                                 clock=clock, wall_clock=clock,
                                 sleep=(sleeps.append if sleeps is not None else
                                        (lambda s: None)))


def _health(clock, *, queue_depth=0, kv_utilization=0.0, steps=None):
    return {"generated_at": clock.t, "queue_depth": queue_depth,
            "kv_utilization": kv_utilization,
            "kv": {"forecast": {"steps_to_exhaustion": steps}}}


def _view(r):
    """A router's routing state: its health view, affinity counters and load
    scores."""
    return {"health": r.health(), "affinity": (r.affinity_routed_total,
                                               r.affinity_overridden_total),
            "scores": [r._load_score(i) for i in range(len(r.replicas))]}


# ============================================================ routing policy
def _least_loaded(ns, d):
    clock = FakeClock(100.0)
    r = _router(ns, d, clock)
    r.observe(0, _health(clock, queue_depth=6))
    r.observe(1, _health(clock, queue_depth=1))
    r.observe(2, _health(clock, queue_depth=3, kv_utilization=0.9))
    assert r.route([1, 2, 3]) == 1
    assert r._load_score(2) > r._load_score(0)  # kv_weight 8x dominates
    return _view(r)


def _stale_health(ns, d):
    clock = FakeClock(100.0)
    r = _router(ns, d, clock, replicas=2)
    r.observe(0, _health(clock))
    clock.t = 110.0
    r.observe(1, _health(clock))
    picks = [r.route([1, 2, 3]), r.healthy_indices()]
    states = {s["index"]: s for s in r.health()["replicas"]}
    assert picks == [1, [1]] and not states[0]["healthy"] and states[1]["healthy"]
    r.observe(0, _health(clock))
    assert sorted(r.healthy_indices()) == [0, 1]
    return picks, _view(r)


def _never_observed(ns, d):
    r = _router(ns, d, FakeClock(0.0), replicas=2)
    pick = r.route([1])
    assert pick in (0, 1) and sorted(r.healthy_indices()) == [0, 1]
    return pick, _view(r)


def _exhaustion_steers(ns, d):
    clock = FakeClock(100.0)
    r = _router(ns, d, clock, replicas=2)
    r.observe(0, _health(clock, queue_depth=0, steps=4.0))
    r.observe(1, _health(clock, queue_depth=5, steps=None))
    assert r._load_score(0) >= ns.router.EXHAUSTION_PENALTY and r.route([1, 2, 3]) == 1
    return _view(r)


def _all_stale_fallback(ns, d):
    clock = FakeClock(100.0)
    r = _router(ns, d, clock, replicas=2)
    r.observe(0, _health(clock, queue_depth=2))
    r.observe(1, _health(clock, queue_depth=7))
    clock.t = 200.0
    picks = [r.healthy_indices(), r.route([1])]
    for replica in r.replicas:
        replica.drained = True
    picks.append(r.route([1]))
    assert picks == [[], 0, None]
    return picks, _view(r)


def _affinity_shared_prefix(ns, d):
    clock = FakeClock(100.0)
    r = _router(ns, d, clock, replicas=3, affinity_blocks=1)
    shared = [7, 8, 9, 10]
    home = int.from_bytes(ns.kv.block_hashes(shared, 4)[-1][:8], "big") % 3
    picks = [r.route(shared + [1]), r.route(shared + [2, 3])]
    assert picks == [home, home] and r.affinity_routed_total == 2
    r.observe(0, _health(clock, queue_depth=5))
    r.observe(1, _health(clock))
    r.observe(2, _health(clock, queue_depth=5))
    picks.append(r.route([1, 2]))  # no full block: least-loaded
    assert picks[-1] == 1 and r.affinity_routed_total == 2
    return picks, _view(r)


def _affinity_overridden(ns, d):
    clock = FakeClock(100.0)
    r = _router(ns, d, clock, replicas=3, affinity_blocks=1)
    shared = [7, 8, 9, 10]
    home = int.from_bytes(ns.kv.block_hashes(shared, 4)[-1][:8], "big") % 3
    others = [i for i in range(3) if i != home]
    for i in others:
        r.observe(i, _health(clock))
    r.observe(home, dict(_health(clock), generated_at=clock.t - 100.0))
    picks = [r.route(shared)]
    assert picks[0] in others and r.affinity_overridden_total == 1
    r.observe(home, _health(clock, steps=1.0))  # a home under exhaustion pressure
    picks.append(r.route(shared))
    assert picks[1] in others and r.affinity_overridden_total == 2
    return home, picks, _view(r)


def _uid_reuse(ns, d):
    r = _router(ns, d, FakeClock(0.0), replicas=1)
    errors = []
    with pytest.raises(ValueError, match="unique") as err:
        r.serve([[1], [2]], uids=[5, 5])
    errors.append(str(err.value))
    r._served_uids.add(9)
    with pytest.raises(ValueError, match="unique") as err:
        r.serve([[1]], uids=[9])
    errors.append(str(err.value))
    return errors


@pytest.mark.parametrize("case", [_least_loaded, _stale_health, _never_observed,
                                  _exhaustion_steers, _all_stale_fallback,
                                  _affinity_shared_prefix, _affinity_overridden, _uid_reuse],
                         ids=lambda f: f.__name__[1:])
def test_routing_policy_matches_jax(case, tmp_path):
    both(case, tmp_path)


def test_config_section_has_the_jax_fields_defaults_and_bounds():
    ours, theirs = load_inference_config(None).serving_fleet, JaxFleetConfig()
    assert list(type(ours)._fields) == list(type(theirs)._fields)
    for field in type(ours)._fields:
        assert getattr(ours, field) == getattr(theirs, field), field
    for bad in ({"replicas": 0}, {"health_stale_s": 0.0}, {"max_reroutes": -1},
                {"backoff_max_s": 0.0}, {"kv_weight": -1.0}):
        for cls in (ServingFleetConfig, JaxFleetConfig):
            with pytest.raises(ValueError):
                cls(**bad)


# ================================================== structured backpressure
def _shed_hints(ns, d):
    q = ns.admission.AdmissionQueue(ns.Resilience(max_queue_depth=2))
    out = [q.submit(0, [1, 2]), q.submit(1, [1, 2]), q.submit(2, [1, 2])]
    reason = out[2]
    assert reason.code == "queue_full" and reason.retryable
    assert reason.retry_after_s == pytest.approx(0.05) and "retry in ~" in str(reason)
    q2 = ns.admission.AdmissionQueue(ns.Resilience(shed_kv_utilization=0.9))
    mild, saturated = (q2.shed_reason(4, kv_utilization=0.92),
                       q2.shed_reason(4, kv_utilization=1.0))
    assert 0.0 < mild.retry_after_s < saturated.retry_after_s <= 2.0
    assert q2.shed_reason(0).retry_after_s is None
    return (plain(out), str(reason), q.shed_by_code, q.last_retry_after, plain(mild),
            plain(saturated))


def _backoff(ns, d):
    r = _router(ns, d, FakeClock(0.0), replicas=1, backoff_base_s=0.1, backoff_max_s=1.5)
    got = [r._backoff_delay(0, []), r._backoff_delay(2, []), r._backoff_delay(0, [0.7]),
           r._backoff_delay(1, [0.05]), r._backoff_delay(9, [9.9])]
    assert got == pytest.approx([0.1, 0.4, 0.7, 0.2, 1.5])
    return got


@pytest.mark.parametrize("case", [_shed_hints, _backoff], ids=lambda f: f.__name__[1:])
def test_backpressure_matches_jax(case, tmp_path):
    both(case, tmp_path)


# ======================================================== journal transplant
def _transplant_wall(ns, d):
    path = str(d / "j.wal")
    j = ns.journal.RequestJournal(path, fsync_every=1, wall_clock=FakeClock(999.0))
    j.record_admit(0, [1, 2], ttl_s=30.0, max_new_tokens=8, admit_wall=123.0)
    j.record_admit(1, [3], max_new_tokens=8)
    j.close()
    state = ns.journal.replay_journal(path)
    assert (state.entries[0].admit_wall, state.entries[0].ttl_s) == (123.0, 30.0)
    assert state.entries[1].admit_wall == 999.0
    return open(path, "rb").read(), plain(state)


def _migrate_transplants(ns, d):
    clock = FakeClock(200.0)
    r = _router(ns, d, clock, replicas=2)
    dead = ns.journal.RequestJournal(r.replicas[0].journal_path, fsync_every=1,
                                     wall_clock=FakeClock(100.0))
    dead.open_generation(0)
    dead.record_admit(1, [1, 2, 3], ttl_s=30.0, max_new_tokens=8, tenant="t",
                      service_class="batch")
    dead.note_tokens(1, [5, 6])
    dead.flush()
    dead.record_admit(2, [4, 5], max_new_tokens=8)
    dead.record_terminal(2, "ok", finish_reason="eos", n_tokens=0)
    dead.close()
    specs = [ns.supervisor.ServeSpec(uid=1, prompt=[1, 2, 3]),
             ns.supervisor.ServeSpec(uid=2, prompt=[4, 5]),
             ns.supervisor.ServeSpec(uid=3, prompt=[9, 9])]
    adopted, regrouped, lost = r._migrate(0, specs)
    assert list(adopted) == [2] and adopted[2].status == "ok" and lost == {}
    assert sorted(s.uid for s in regrouped[1]) == [1, 3]
    assert (r.migrated_requests_total, r.adopted_from_journal_total) == (2, 1)
    state = ns.journal.replay_journal(r.replicas[1].journal_path)
    entry = state.entries[1]
    assert entry.prompt == [1, 2, 3] and entry.emitted == [5, 6] and not entry.done
    assert (entry.admit_wall, entry.ttl_s, entry.tenant) == (100.0, 30.0, "t")
    assert 3 not in state.entries
    assert not ns.journal.replay_journal(r.replicas[0].journal_path).entries[1].done
    with open(r.replicas[1].journal_path, "rb") as fh:
        target = fh.read()
    return (plain(adopted), {t: plain(v) for t, v in regrouped.items()}, target,
            [e for e in r.recorder.tail()])


def _migrate_no_target(ns, d):
    r = _router(ns, d, FakeClock(0.0), replicas=2)
    ns.journal.RequestJournal(r.replicas[0].journal_path, fsync_every=1).close()
    r.replicas[1].drained = True
    adopted, regrouped, lost = r._migrate(0, [ns.supervisor.ServeSpec(uid=7, prompt=[1])])
    assert adopted == {} and regrouped == {} and r.lost_total == 1
    assert lost[7].status == "failed" and lost[7].retryable
    assert lost[7].reason == ns.router.UNROUTABLE_REASON
    return plain(lost)


@pytest.mark.parametrize("case", [_transplant_wall, _migrate_transplants, _migrate_no_target],
                         ids=lambda f: f.__name__[1:])
def test_journal_transplant_matches_jax(case, tmp_path):
    both(case, tmp_path)


# ============================================== shed re-route orchestration
class StubSupervisor:
    """``serve_specs``-compatible stand-in: scripted per-call outcomes."""

    def __init__(self, ns, script):
        self.ns = ns
        self.script = list(script)  # each item: uid -> RequestResult factory
        self.calls = []
        self.degraded = False
        self.restarts_total = 0
        self.generations = 0
        self.ops = None

    def serve_specs(self, specs, *, max_new_tokens, eos_token_id=None, greedy=True,
                    on_generation=None):
        self.calls.append([s.uid for s in specs])
        behave = self.script.pop(0) if self.script else None
        results = {}
        for spec in specs:
            if behave and spec.uid in behave:
                results[spec.uid] = behave[spec.uid](self.ns, spec.uid)
            else:
                results[spec.uid] = self.ns.admission.RequestResult(uid=spec.uid, status="ok",
                                                                    tokens=list(spec.prompt))
        return results, False

    def close_ops(self):
        pass


def _shed(retry_after_s=None, retryable=True, code=None):
    return lambda ns, uid: ns.admission.RequestResult(
        uid=uid, status="shed", retryable=retryable, reason="stub shed",
        retry_after_s=retry_after_s, shed_code=code)


def _orchestration(r, results, sleeps):
    return {"results": plain(results), "sleeps": sleeps,
            "calls": [rep.supervisor.calls for rep in r.replicas],
            "counters": (list(r.routed_total), r.reroutes_total, r.backoff_seconds_total,
                         r.routed_by_tenant, r.quota_sheds_by_tenant),
            "events": [e["event"] for e in r.recorder.tail()]}


def _reroute_hinted(ns, d):
    sleeps = []
    r = _router(ns, d, FakeClock(0.0), replicas=2, sleeps=sleeps, backoff_base_s=0.05,
                backoff_max_s=2.0)
    r.replicas[0].supervisor = StubSupervisor(ns, [{0: _shed(0.7), 1: _shed(0.7)}])
    r.replicas[1].supervisor = StubSupervisor(ns, [])
    results = r.serve([[1, 2], [3, 4]], uids=[0, 1])
    assert all(x.status == "ok" for x in results) and r.reroutes_total == 2
    assert sleeps == [pytest.approx(0.7)] and r.replicas[1].supervisor.calls == [[0, 1]]
    return _orchestration(r, results, sleeps)


def _non_retryable(ns, d):
    sleeps = []
    r = _router(ns, d, FakeClock(0.0), replicas=2, sleeps=sleeps)
    r.replicas[0].supervisor = StubSupervisor(ns, [{5: _shed(retryable=False)}])
    r.replicas[1].supervisor = StubSupervisor(ns, [])
    results = r.serve([[1, 2]], uids=[5])
    assert results[0].status == "shed" and not results[0].retryable and sleeps == []
    return _orchestration(r, results, sleeps)


def _budget_exhausted(ns, d):
    sleeps = []
    r = _router(ns, d, FakeClock(0.0), replicas=3, sleeps=sleeps, max_reroutes=2)
    for replica in r.replicas:
        replica.supervisor = StubSupervisor(ns, [{0: _shed(0.1)}] * 5)
    results = r.serve([[1, 2]], uids=[0])
    assert results[0].status == "shed" and results[0].retryable
    assert sum(len(rep.supervisor.calls) for rep in r.replicas) == 3  # never revisited
    return _orchestration(r, results, sleeps)


def _quota_shed_not_rerouted(ns, d):
    sleeps = []
    r = _router(ns, d, FakeClock(0.0), replicas=2, sleeps=sleeps, backoff_base_s=0.05)
    r.replicas[0].supervisor = StubSupervisor(ns, [{0: _shed(1.5, code=ns.qos.QUOTA_EXCEEDED)}])
    r.replicas[1].supervisor = StubSupervisor(ns, [])
    results = r.serve([[1, 2]], uids=[0], tenants=["noisy"])
    assert results[0].shed_code == ns.qos.QUOTA_EXCEEDED
    assert results[0].retry_after_s == pytest.approx(1.5)
    assert r.replicas[1].supervisor.calls == [] and r.reroutes_total == 0 and sleeps == []
    assert r.quota_sheds_by_tenant == {"noisy": 1} == r.routed_by_tenant
    view = _orchestration(r, results, sleeps)
    assert "quota_shed" in view["events"] and "reroute" not in view["events"]
    return view


def _ordinary_shed_reroutes(ns, d):
    sleeps = []
    r = _router(ns, d, FakeClock(0.0), replicas=2, sleeps=sleeps, backoff_base_s=0.05)
    r.replicas[0].supervisor = StubSupervisor(ns, [{0: _shed(0.7)}])
    r.replicas[1].supervisor = StubSupervisor(ns, [])
    results = r.serve([[1, 2]], uids=[0], tenants=["noisy"])
    assert results[0].status == "ok" and r.reroutes_total == 1
    assert sleeps == [pytest.approx(0.7)]
    return _orchestration(r, results, sleeps)


@pytest.mark.parametrize("case", [_reroute_hinted, _non_retryable, _budget_exhausted,
                                  _quota_shed_not_rerouted, _ordinary_shed_reroutes],
                         ids=lambda f: f.__name__[1:])
def test_shed_orchestration_matches_jax(case, tmp_path):
    both(case, tmp_path)


def _affinity_tenant_namespaced(ns, d):
    r = _router(ns, d, FakeClock(0.0), replicas=3, affinity_blocks=1)
    prompt = [7, 8, 9, 10, 1]
    homes = {}
    for tenant in ("default", "alice", "bob"):
        homes[tenant] = r._affinity_home(prompt, tenant)
        assert homes[tenant] == int.from_bytes(ns.kv.block_hashes(
            prompt[:4], 4, ns.kv.tenant_namespace(tenant))[-1][:8], "big") % 3
    legacy = int.from_bytes(ns.kv.block_hashes(prompt[:4], 4)[-1][:8], "big") % 3
    assert r._affinity_home(prompt) == legacy
    return homes


def test_affinity_home_is_tenant_namespaced_like_jax(tmp_path):
    both(_affinity_tenant_namespaced, tmp_path)


def _router_families(ns, d):
    r = _router(ns, d, FakeClock(0.0), replicas=2)
    r.replicas[0].supervisor = StubSupervisor(ns, [{0: _shed(1.5, code=ns.qos.QUOTA_EXCEEDED)}])
    r.replicas[1].supervisor = StubSupervisor(ns, [])
    r.serve([[1, 2], [3, 4]], uids=[0, 1], tenants=["noisy", "quiet"])
    reg = ns.metrics.MetricsRegistry(namespace="dstpu")
    ns.metrics.populate_from_router(reg, r)
    text = ns.exposition.render(reg)
    families = exposition.parse_exposition(text)
    routed = families["dstpu_router_tenant_routed_total"]["samples"]
    assert {labels["tenant"]: v for _, labels, v in routed} == {"noisy": 1.0, "quiet": 1.0}
    sheds = families["dstpu_router_tenant_quota_sheds_total"]["samples"]
    assert [(labels, v) for _, labels, v in sheds] == [({"tenant": "noisy"}, 1.0)]
    return text, r.metrics_text()


def test_router_exports_tenant_counter_families_like_jax(tmp_path):
    """``populate_from_router`` renders the same text as JAX's for the same
    router state, and ``metrics_text()`` (the aggregator's registry plus the
    router's families) too."""
    both(_router_families, tmp_path)


# ========================================================= fleet integration
def _params():
    if "params" not in _CACHE:
        kw = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, seq=256)
        jcfg, cfg = jllama.LlamaConfig.tiny(**kw), llama.LlamaConfig.tiny(**kw)
        jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
        params = llama.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        rng = np.random.default_rng(1)
        shared = rng.integers(1, 128, 8).tolist()  # one full affinity block
        prompts = ([shared + rng.integers(1, 128, int(n)).tolist()
                    for n in rng.integers(2, 6, 2)]
                   + [rng.integers(1, 128, int(n)).tolist() for n in rng.integers(4, 12, 2)])
        _CACHE["params"] = (jcfg, jparams, cfg, params, prompts)
    return _CACHE["params"]


FLEET_KW = dict(num_blocks=64, block_size=8, max_blocks_per_seq=8, token_budget=32,
                max_seqs_per_step=8)


def _factory(side, clock, crash_at=None):
    """Builds fresh engines of ``side`` on the shared FakeClock; with
    ``crash_at`` each engine's scheduler raises from its ``crash_at``-th
    schedule on (admit and emit a little, then die)."""
    jcfg, jparams, cfg, params, _ = _params()

    def build():
        if side == "jax":
            eng = JaxEngine(jllama, jcfg, jparams, config={"dtype": "float32"}, clock=clock,
                            **FLEET_KW)
            eng._fwd_cache = _CACHE.setdefault("programs", {})
        else:
            eng = InferenceEngineV2(llama, cfg, params, config={"dtype": "float32"},
                                    clock=clock, device="cpu", **FLEET_KW)
        if crash_at is not None:
            real = eng.scheduler.schedule

            def boom(*args, **kwargs):
                boom.steps += 1
                if boom.steps >= crash_at:
                    raise RuntimeError("injected fleet fault")
                return real(*args, **kwargs)
            boom.steps = 0
            eng.scheduler.schedule = boom
        return eng
    return build


def _reference():
    if "reference" not in _CACHE:
        prompts = _params()[4]
        _CACHE["reference"] = _factory("port", FakeClock(tick=0.001))().generate(
            prompts, max_new_tokens=8)
    return _CACHE["reference"]


def _fleet_view(r, results):
    health = r.health()
    return {"results": [(x.uid, x.status, x.tokens, x.finish_reason) for x in results],
            "health": health, "tenants": (r.routed_by_tenant, r.quota_sheds_by_tenant),
            "events": [{k: v for k, v in e.items() if k != "detail"}
                       for e in r.recorder.tail()],
            "metrics": "\n".join(line for line in r.metrics_text().splitlines()
                                 if not any(name in line for name in ENGINE_ONLY))}


def test_fleet_serve_matches_single_engine_and_jax(tmp_path):
    """Two replicas with prefix affinity serve the tiny workload: every
    token equals one engine's uninterrupted run, the shared-header prompts
    share a home, and results, health, recorder events and the merged
    ``/metrics`` (but :data:`ENGINE_ONLY`) equal the JAX fleet's."""
    prompts = _params()[4]
    views = {}
    for side, ns in SIDES.items():
        clock = FakeClock(1000.0, tick=0.001)
        os.makedirs(tmp_path / side, exist_ok=True)
        r = ns.router.FleetRouter(_factory(side, clock), journal_dir=str(tmp_path / side),
                                  config={"replicas": 2, "affinity_blocks": 1},
                                  ft_config={"enabled": True, "max_restarts": 2},
                                  block_size=8, clock=clock, wall_clock=clock)
        results = r.serve(prompts, max_new_tokens=8)
        assert [x.tokens for x in results] == _reference() and all(x.ok for x in results)
        assert r.affinity_routed_total >= 2 and r.lost_total == r.migrations_total == 0
        families = exposition.parse_exposition(r.metrics_text())
        assert "dstpu_router_routed_total" in families
        assert "dstpu_serving_completed_total" in families
        assert r.health()["healthy_replicas"] == 2
        assert sum(r.health()["routed_total"]) == len(prompts)
        views[side] = _fleet_view(r, results)
    assert views["port"] == views["jax"]


def test_fleet_failover_migrates_journaled_work_like_jax(tmp_path):
    """Replica 0's engines crash mid-serve until its budget (max_restarts 1)
    runs out; the router drains it and moves the journaled work to replica
    1: tokens equal the uninterrupted run, no request lost, and results,
    health, events and the merged ``/metrics`` equal the JAX fleet's; a
    later request routes around the drained replica."""
    prompts = _params()[4]
    views = {}
    for side, ns in SIDES.items():
        clock = FakeClock(1000.0, tick=0.001)
        os.makedirs(tmp_path / side, exist_ok=True)
        r = ns.router.FleetRouter([_factory(side, clock, crash_at=2), _factory(side, clock)],
                                  journal_dir=str(tmp_path / side),
                                  config={"replicas": 2, "affinity_blocks": 0},
                                  ft_config={"enabled": True, "max_restarts": 1},
                                  block_size=8, clock=clock, wall_clock=clock)
        results = r.serve(prompts, max_new_tokens=8)
        assert [x.tokens for x in results] == _reference() and all(x.ok for x in results)
        assert (r.lost_total, r.migrations_total) == (0, 1) and r.migrated_requests_total >= 1
        assert r.replicas[0].drained
        assert [e for e in r.recorder.tail() if e["event"] == "migrate"]
        families = exposition.parse_exposition(r.metrics_text())
        assert families["dstpu_router_migrations_total"]["type"] == "counter"
        assert "dstpu_serving_restarts_total" in families
        more = r.serve([[3, 1, 4, 1, 5]], uids=[100], max_new_tokens=4)
        assert more[0].ok and r.lost_total == 0
        views[side] = (_fleet_view(r, results), [(x.status, x.tokens) for x in more])
    assert views["port"] == views["jax"]


# ========================================================= host-only modules
@pytest.mark.parametrize("module", ["qos", "router"])
def test_host_only_modules_import_neither_torch_nor_numpy(module):
    """The QoS policy and the router read host state only: neither module
    imports torch, numpy or jax (nor the JAX package)."""
    path = os.path.join(ROOT, "deepspeed_tpu_torch", "inference", "v2", f"{module}.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.add(node.module.split(".")[0])
    assert not imported & {"torch", "numpy", "jax", "deepspeed_tpu"}, imported

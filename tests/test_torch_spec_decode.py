"""The port's speculative decoding on the CPU against the JAX package's.

``deepspeed_tpu_torch/inference/v2/spec_decode.py`` and the engine's
draft/verify round held to ``deepspeed_tpu/inference/v2/spec_decode.py``
and its engine on tiny fp32 Llamas with the same weights
(``params_from_jax``): every case of the JAX package's
``tests/unit/inference/test_spec_decode.py``, each also against the JAX
module or engine on the same inputs.  Exact equality for greedy packed rows,
proposals, the controller's walk, tokens, ``ServeCounters`` (but
``compiles``), the tokens-per-verify histogram, ``health()["spec_decode"]``,
journal bytes and the exposition (but the engine-only families); sampled
rounds draw from a torch generator, so their parity is a total-variation band
(0.08) against the filtered target, and the port's ``_filter_logits`` equals
JAX's to 1e-6.  JAX engines share one program cache (their bucket programs
are functions of params, pool and batch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import fastpath as jfastpath
from deepspeed_tpu.inference.v2 import journal as jjournal
from deepspeed_tpu.inference.v2 import spec_decode as jspec
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.monitor import exposition as jexposition
from deepspeed_tpu.monitor import metrics as jmetrics
from deepspeed_tpu.runtime.config import ServingSpecDecodeConfig as JaxSpecConfig
from deepspeed_tpu_torch.inference import engine as pengine
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2 import journal as pjournal
from deepspeed_tpu_torch.inference.v2 import spec_decode as pspec
from deepspeed_tpu_torch.inference.v2.fastpath import DeferredRuns, ServeCounters
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.monitor import exposition as pexposition
from deepspeed_tpu_torch.monitor import metrics as pmetrics
from deepspeed_tpu_torch.runtime.config import ServingSpecDecodeConfig
from tests.test_torch_fastpath import FaultyBlockedAllocator
from tests.test_torch_ops_plane import ENGINE_ONLY
from tests.unit.fault_injection_serving import FakeClock
from tests.unit.fault_injection_serving import FaultyBlockedAllocator as JaxFaultyAllocator

KW = dict(num_blocks=64, block_size=8, max_blocks_per_seq=8, token_budget=32,
          max_seqs_per_step=8)
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14, 15, 16, 17], [20, 21]]
COUNTED = [f for f in ServeCounters.FIELDS if f != "compiles"]
SIDES = {"jax": (jmetrics, jexposition), "port": (pmetrics, pexposition)}
_CACHE = {}


def _params():
    if "params" not in _CACHE:
        kw = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, seq=256)
        jcfg, cfg = jllama.LlamaConfig.tiny(**kw), llama.LlamaConfig.tiny(**kw)
        jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
        params = llama.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        _CACHE["params"] = (jcfg, jparams, cfg, params)
    return _CACHE["params"]


def _engine(side, config=None, **kw):
    """An fp32 engine of ``side`` over the module's weights."""
    jcfg, jparams, cfg, params = _params()
    config = {"dtype": "float32", **(config or {})}
    if side == "jax":
        eng = JaxEngine(jllama, jcfg, jparams, config=config, **{**KW, **kw})
        eng._fwd_cache = _CACHE.setdefault("programs", {})
        return eng
    return InferenceEngineV2(llama, cfg, params, config=config, device="cpu", **{**KW, **kw})


def _spec(extra=None, **spec):
    return {"serving_spec_decode": {"enabled": True, **spec}, **(extra or {})}


def _reference(max_new=9):
    """The port's spec-off greedy run of PROMPTS."""
    if ("reference", max_new) not in _CACHE:
        _CACHE[("reference", max_new)] = _engine("port").generate(PROMPTS, max_new_tokens=max_new)
    return _CACHE[("reference", max_new)]


def _counters(eng):
    return {f: getattr(eng.counters, f) for f in COUNTED}


# ============================================================ kernel-level units
def test_spec_k_ladder_bounded_anchored_and_equal_to_jax():
    assert pspec.spec_k_ladder(1) == (1, )
    assert pspec.spec_k_ladder(4) == (1, 3, 4)
    assert pspec.spec_k_ladder(8) == (1, 3, 7, 8)
    assert pspec.spec_k_ladder(63) == (1, 3, 7, 15, 31, 63)
    for k in range(1, 70):
        ladder = pspec.spec_k_ladder(k)
        assert ladder == jspec.spec_k_ladder(k)
        assert ladder[0] == 1 and ladder[-1] == min(k, 63) and all(r <= k for r in ladder)


@pytest.mark.parametrize("seed,n,k,v", [(0, 3, 3, 16), (1, 8, 7, 128), (2, 5, 1, 32)])
def test_rejection_select_greedy_packs_equal_jax(seed, n, k, v):
    """Greedy verify: accept while the draft matches the target argmax, then
    one corrected token, so every emitted token is the argmax.  The packed
    rows equal the JAX sampler's on the same logits and drafts (some rows
    all accepted, some rejected at a seeded position)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, k + 1, v)).astype(np.float32)
    tgt = np.argmax(logits, axis=-1).astype(np.int32)
    draft = tgt[:, :k].copy()
    for i in range(1, n):  # row 0 all accepted; the others reject somewhere
        at = int(rng.integers(0, k))
        draft[i, at] = (draft[i, at] + 1) % v
    got = pspec.rejection_select(torch.from_numpy(logits), torch.from_numpy(draft), None,
                                 sample_cfg=None).numpy()
    want, _ = jspec.rejection_select(jnp.asarray(logits), jnp.asarray(draft),
                                     jax.random.PRNGKey(0), sample_cfg=None)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.dtype == np.int32 and got.shape == (n, k + 2)
    np.testing.assert_array_equal(got[:, 1:], tgt)
    assert got[0, 0] == k + 1


@pytest.mark.parametrize("cfg", [(0.8, 8, 0.95), (1.0, 0, 1.0), (0.5, 3, 1.0), (1.3, 0, 0.7)])
def test_filter_logits_equals_jax(cfg):
    """The one filtered target distribution both samplers draw from."""
    logits = np.random.default_rng(4).normal(0.0, 2.0, size=(6, 40)).astype(np.float32)
    t, top_k, top_p = cfg
    got = pengine._filter_logits(torch.from_numpy(logits), temperature=t, top_k=top_k,
                                 top_p=top_p).numpy()
    want = np.asarray(jengine._filter_logits(jnp.asarray(logits), temperature=t, top_k=top_k,
                                             top_p=top_p))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("sample_cfg,draft", [((0.8, 8, 0.95), [3, 4, 5]),
                                              ((0.9, 0, 1.0), [1, 2, 3])])
def test_rejection_select_sampled_marginal_matches_filtered_target(sample_cfg, draft):
    """The Leviathan guarantee, measured: over 4,000 draws the FIRST emitted
    token's empirical distribution is within total variation 0.08 of the
    filtered target (the JAX suite's band), on both samplers, and a token
    the filter masks is never emitted."""
    v, k, draws = 24, 3, 4000
    base = np.random.default_rng(5).normal(0.0, 1.5, size=(1, k + 1, v)).astype(np.float32)
    logits = np.tile(base, (draws, 1, 1))
    drafts = np.tile(np.asarray([draft], np.int32), (draws, 1))
    gen = torch.Generator().manual_seed(1)
    first = {"port": pspec.rejection_select(torch.from_numpy(logits), torch.from_numpy(drafts),
                                            gen, sample_cfg=sample_cfg).numpy()[:, 1]}
    packed, _ = jspec.rejection_select(jnp.asarray(logits), jnp.asarray(drafts),
                                       jax.random.PRNGKey(1), sample_cfg=sample_cfg)
    first["jax"] = np.asarray(packed)[:, 1]
    filt = pengine._filter_logits(torch.from_numpy(base[0, :1]), temperature=sample_cfg[0],
                                  top_k=sample_cfg[1], top_p=sample_cfg[2])
    target = torch.softmax(filt[0], dim=-1).numpy()
    for side, toks in first.items():
        freq = np.bincount(toks, minlength=v) / draws
        tv = 0.5 * float(np.abs(freq - target).sum())
        assert tv < 0.08, f"{side}: TV distance {tv:.4f}, the sampler is biased"
        assert float(freq[target < 1e-12].sum()) == 0.0, side


def test_rejection_select_residual_never_reemits_rejected_token():
    """On a rejection at position a the resample draws from the residual
    (the rejected draft token masked out): emitting it again would count
    its probability twice."""
    v, k, draws = 16, 2, 512
    base = np.random.default_rng(2).normal(size=(1, k + 1, v)).astype(np.float32)
    logits = torch.from_numpy(np.tile(base, (draws, 1, 1)))
    filt = pengine._filter_logits(torch.from_numpy(base[0, :1]), temperature=1.0, top_k=0,
                                  top_p=1.0)
    worst = int(torch.argmin(filt[0]))
    draft = torch.tensor([[worst, 1]], dtype=torch.int32).repeat(draws, 1)
    packed = pspec.rejection_select(logits, draft, torch.Generator().manual_seed(3),
                                    sample_cfg=(1.0, 0, 1.0)).numpy()
    rejected_at_0 = packed[:, 0] == 1
    assert rejected_at_0.sum() > draws // 2
    assert not np.any(packed[rejected_at_0, 1] == worst)


class _Seq:

    def __init__(self, uid, toks):
        self.uid = uid
        self.tokens = list(toks)
        self.seen_tokens = len(toks) - 1


def test_ngram_drafter_proposals_equal_jax():
    d, jd = pspec.NgramDrafter(3, 1), jspec.NgramDrafter(3, 1)
    hist = [5, 6, 7, 8, 5, 6, 7, 8, 5, 6]
    assert d.propose(hist, 4) == [7, 8, 5, 6]  # the longest-suffix match continues the cycle
    assert d.propose([1, 2, 9, 9, 1, 2, 3, 3, 1, 2], 2) == [3, 3]  # the rightmost match wins
    assert d.propose([1, 2, 3], 3) == [3, 3, 3]  # no match: repeat the last token
    rng = np.random.default_rng(11)
    for trial in range(60):
        vocab = int(rng.integers(2, 12))
        h = rng.integers(0, vocab, int(rng.integers(1, 400))).tolist()
        k = int(rng.integers(1, 16))
        lo, hi = int(rng.integers(1, 4)), int(rng.integers(1, 5))
        assert (pspec.NgramDrafter(hi, lo).propose(h, k)
                == jspec.NgramDrafter(hi, lo).propose(h, k)), trial
    seqs = [_Seq(0, hist), _Seq(1, [1, 2, 3])]
    batch = d.propose_batch(seqs, 4, pad_to=4)
    assert isinstance(batch, np.ndarray) and batch.shape == (4, 4) and batch.dtype == np.int32
    np.testing.assert_array_equal(batch, jd.propose_batch(seqs, 4, pad_to=4))
    assert list(batch[0]) == [7, 8, 5, 6] and list(batch[1]) == [3, 3, 3, 3]
    assert not batch[2:].any()  # padded rows stay zero


def test_adaptive_k_controller_walk_equals_jax():
    cfg = dict(enabled=True, k=8, ewma_alpha=1.0, raise_threshold=0.7, lower_threshold=0.3,
               probe_every=3)
    c = pspec.AdaptiveKController(ServingSpecDecodeConfig(**cfg))
    assert c.ladder == (1, 3, 7, 8) and c.k == 8  # starts at the top rung
    c.note_round(8, 1)  # acceptance 0.125 < lower: step down
    assert c.k == 7
    c.note_round(7, 0)
    assert c.k == 3
    c.note_round(3, 0)
    assert c.k == 1  # the floor: plain burst territory
    assert [c.next_k() for _ in range(3)][:-1] == [1, 1]
    assert c.k == 3  # probed back up one rung
    for r in (3, 7, 8):
        c.note_round(r, r)
    assert c.k == 8  # climbed, capped at the top
    fixed = pspec.AdaptiveKController(ServingSpecDecodeConfig(enabled=True, k=4,
                                                              adaptive_k=False))
    fixed.note_round(4, 0)
    assert fixed.next_k() == 4  # adaptive off: k is pinned
    # a shared seeded (proposed, accepted) trace walks both controllers alike
    rng = np.random.default_rng(3)
    for over in ({}, {"ewma_alpha": 0.3, "probe_every": 4}, {"k": 15, "ewma_alpha": 0.5}):
        ours = pspec.AdaptiveKController(ServingSpecDecodeConfig(**{**cfg, **over}))
        theirs = jspec.AdaptiveKController(JaxSpecConfig(**{**cfg, **over}))
        for _ in range(80):
            assert ours.next_k() == theirs.next_k()
            proposed = int(rng.integers(0, 40))
            accepted = int(rng.integers(0, proposed + 1))
            ours.note_round(proposed, accepted)
            theirs.note_round(proposed, accepted)
            assert ours.snapshot() == theirs.snapshot()


def test_spec_stats_snapshot_equals_jax():
    ours, theirs = pspec.SpecDecodeStats(), jspec.SpecDecodeStats()
    assert ours.acceptance_rate() == 0.0
    for s in (ours, theirs):
        s.note_round(8, 6, [4, 3])
        s.note_round(8, 2, [2, 1])
        s.fallback_rounds_total += 1
    snap = ours.snapshot()
    assert snap == theirs.snapshot()
    assert snap["rounds_total"] == 2 and snap["emitted_total"] == 10
    assert snap["proposed_total"] == 16 and snap["accepted_total"] == 8
    assert snap["acceptance_rate"] == 0.5
    assert snap["tokens_per_verify"] == {"1": 1, "2": 1, "3": 1, "4": 1}


def test_deferred_runs_one_sync_and_ragged_unpack():
    packed = [[3, 10, 11, 12, 0], [1, 20, 99, 99, 99]]
    runs = {}
    for side, (cls, counters, tensor) in {
            "port": (DeferredRuns, ServeCounters(), torch.tensor(packed, dtype=torch.int32)),
            "jax": (jfastpath.DeferredRuns, jfastpath.ServeCounters(),
                    jnp.asarray(packed, jnp.int32))}.items():
        h = cls(packed_dev=tensor, uids=[7, 9], counters=counters)
        runs[side] = h.runs()
        assert counters.host_syncs == 1
        h.runs()
        assert counters.host_syncs == 1, side  # cached: the round pays one sync
    assert runs["port"] == runs["jax"] == {7: [10, 11, 12], 9: [20]}


def test_serve_counters_fields_spec_tail():
    """The spec counters ride at the TAIL of FIELDS, as in the JAX package."""
    assert ServeCounters.FIELDS == jfastpath.ServeCounters.FIELDS
    assert ServeCounters.FIELDS[-3:] == ("spec_rounds", "spec_proposed", "spec_accepted")
    c = ServeCounters()
    assert c.spec_rounds == 0 and c.spec_proposed == 0 and c.spec_accepted == 0


def test_config_section_has_the_jax_fields_defaults_and_bounds():
    fields = ("enabled", "drafter", "k", "adaptive_k", "ewma_alpha", "raise_threshold",
              "lower_threshold", "probe_every", "ngram_max", "ngram_min")
    ours, theirs = ServingSpecDecodeConfig(), JaxSpecConfig()
    assert [getattr(ours, f) for f in fields] == [getattr(theirs, f) for f in fields]
    for bad in ({"drafter": "oracle"}, {"k": 0}, {"ewma_alpha": 0.0}, {"probe_every": 0},
                {"raise_threshold": 1.5}, {"ngram_min": 0}):
        for cls in (ServingSpecDecodeConfig, JaxSpecConfig):
            with pytest.raises(ValueError):
                cls(**bad)


# ================================================ engine: against the JAX engine
@pytest.mark.parametrize("strict", [True, False], ids=["strict", "nonstrict"])
def test_spec_greedy_identity_fastpath(strict):
    """Greedy spec on equals spec off and the JAX spec engine token for token,
    with the JAX engine's counters, health section and tokens-per-verify
    histogram."""
    engines = {side: _engine(side, _spec()) for side in ("jax", "port")}
    outs = {side: eng.generate(PROMPTS, max_new_tokens=9, strict=strict)
            for side, eng in engines.items()}
    if not strict:
        assert all(r.status == "ok" for r in outs["port"])
        outs = {side: [r.tokens for r in res] for side, res in outs.items()}
    assert outs["port"] == outs["jax"] == _reference()
    port, jx = engines["port"], engines["jax"]
    assert port.counters.spec_rounds > 0
    assert _counters(port) == _counters(jx)
    assert port.health()["spec_decode"] == jx.health()["spec_decode"]
    assert port.scheduler.fused_steps == jx.scheduler.fused_steps
    assert port.scheduler.fused_tokens == jx.scheduler.fused_tokens


def test_spec_greedy_identity_reference_loop():
    """The reference loop (``serving_fastpath.enabled=False``) fuses its
    decode too, so speculation rides it: the output is the plain reference
    loop's, and the rounds and counters are the JAX reference loop's."""
    ref = {"serving_fastpath": {"enabled": False}}
    plain = _engine("port", ref).generate(PROMPTS, max_new_tokens=9)
    engines = {side: _engine(side, _spec(ref)) for side in ("jax", "port")}
    for side, eng in engines.items():
        assert eng.generate(PROMPTS, max_new_tokens=9) == plain, side
    assert _counters(engines["port"]) == _counters(engines["jax"])
    assert engines["port"].health()["spec_decode"] == engines["jax"].health()["spec_decode"]


def test_spec_greedy_identity_with_eos():
    eos = _reference()[0][len(PROMPTS[0]) + 4]
    want = _engine("port").generate(PROMPTS, max_new_tokens=9, eos_token_id=eos)
    engines = {side: _engine(side, _spec()) for side in ("jax", "port")}
    for side, eng in engines.items():
        assert eng.generate(PROMPTS, max_new_tokens=9, eos_token_id=eos) == want, side
    assert _counters(engines["port"]) == _counters(engines["jax"])


def test_spec_model_drafter_identity_and_full_acceptance():
    """The target attached as its own drafter: every greedy proposal matches
    the verify's argmax, so acceptance is exactly 1.0 and the stream is still
    the plain one (the all-accept bonus path), on both sides with equal
    counters; both pools are reclaimed."""
    jcfg, jparams, cfg, params = _params()
    engines = {side: _engine(side, _spec(drafter="model")) for side in ("jax", "port")}
    engines["jax"].attach_draft_model(jllama, jcfg, jparams)
    engines["port"].attach_draft_model(llama, cfg, params)
    for side, eng in engines.items():
        assert eng.generate(PROMPTS, max_new_tokens=12) == _reference(12), side
    port = engines["port"]
    spec = port.health()["spec_decode"]
    assert spec == engines["jax"].health()["spec_decode"]
    assert spec["rounds_total"] > 0 and spec["acceptance_rate"] == 1.0
    assert spec["drafter"] == "model"
    assert _counters(port) == _counters(engines["jax"])
    assert port.manager.allocator.free_blocks == KW["num_blocks"] - 1
    drafter = port._drafter
    drafter._gc(set())
    assert sorted(drafter._free) == list(range(KW["num_blocks"] - 1))
    assert port.ledger.by_site["draft"]["cold"] > 0 and port.ledger.warm_total == 0


def test_model_drafter_starts_a_reused_uid_afresh():
    """A second serve reuses uids 0..3 for other prompts: the port's drafter
    drops a uid's draft state when the uid names a new request, so the
    target drafting for itself still accepts every draft.  The JAX drafter
    keeps the old request's state (ROADMAP Queue 3, F4): its proposals go
    stale and its acceptance drops, its tokens stay exact."""
    jcfg, jparams, cfg, params = _params()
    other = [[p[0] + 40] + p for p in PROMPTS]
    want = _engine("port").generate(other, max_new_tokens=12)
    engines = {side: _engine(side, _spec(drafter="model")) for side in ("jax", "port")}
    engines["jax"].attach_draft_model(jllama, jcfg, jparams)
    engines["port"].attach_draft_model(llama, cfg, params)
    for side, eng in engines.items():
        assert eng.generate(PROMPTS, max_new_tokens=12) == _reference(12), side
        assert eng.generate(other, max_new_tokens=12) == want, side
    assert engines["port"].health()["spec_decode"]["acceptance_rate"] == 1.0
    assert engines["jax"].health()["spec_decode"]["acceptance_rate"] < 1.0


def test_spec_attach_draft_model_guards():
    _, _, cfg, params = _params()
    for config in (None, _spec(drafter="ngram")):
        with pytest.raises(ValueError):
            _engine("port", config).attach_draft_model(llama, cfg, params)


def test_spec_sampled_run_valid_and_seeded_deterministic():
    """T>0 spec serving: tokens are valid vocabulary entries and a fixed
    seed reproduces the run (the engine's generator advances at every
    sampled round: two rounds never repeat a draw)."""
    conf = _spec({"temperature": 0.7, "top_k": 20, "top_p": 0.9})
    a = _engine("port", conf)
    out = a.generate(PROMPTS, max_new_tokens=8, greedy=False)
    assert out == _engine("port", conf).generate(PROMPTS, max_new_tokens=8, greedy=False)
    assert all(0 <= t < 128 for r in out for t in r)
    assert a.counters.spec_rounds > 0
    # the same round twice from the same history draws different numbers
    # unless the generator is reset
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((64, 4, 128), generator=torch.Generator().manual_seed(1))
    draft = torch.zeros((64, 3), dtype=torch.int32)
    cfg = (0.7, 20, 0.9)
    r1 = pspec.rejection_select(logits, draft, gen, sample_cfg=cfg)
    r2 = pspec.rejection_select(logits, draft, gen, sample_cfg=cfg)
    assert not torch.equal(r1, r2)
    gen.manual_seed(0)
    assert torch.equal(pspec.rejection_select(logits, draft, gen, sample_cfg=cfg), r1)


def test_spec_prewarm_covers_ladder_zero_warm_recompiles():
    """The prewarm builds verify buckets of the ladder's rungs; a second
    serve of the same prompts builds nothing."""
    eng = _engine("port", _spec())
    eng.generate(PROMPTS, max_new_tokens=9)
    assert eng.ledger.warm_total == 0
    assert eng.ledger.by_site["spec_verify"].get("prewarmed", 0) > 0
    built = eng.ledger.total
    assert eng.generate(PROMPTS, max_new_tokens=9) == _reference()
    assert eng.ledger.warm_total == 0 and eng.ledger.total == built


def test_spec_declines_when_deadline_armed():
    """Deadline-armed sequences take the plain path, so TTL partials equal
    spec off's and the JAX engine's under the same fake clock."""
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9]]
    results = {}
    for side, config in (("jax", _spec()), ("port", _spec()), ("off", None)):
        eng = _engine("port" if side == "off" else side, config, clock=FakeClock(tick=0.05))
        res = eng.generate(prompts, max_new_tokens=64, strict=False, ttl_s=0.4)
        assert eng.counters.spec_rounds == 0
        results[side] = [(r.uid, r.status, r.tokens) for r in res]
    assert results["port"] == results["jax"] == results["off"]
    assert {s for _, s, _ in results["port"]} == {"deadline_expired"}


# ======================================================== spec OFF byte-identity
def test_spec_off_is_default_and_inert():
    eng = _engine("port")
    assert not eng.spec_cfg.enabled
    assert eng.spec_stats is None and eng._drafter is None and eng._spec_controller is None
    assert eng.generate(PROMPTS, max_new_tokens=9) == _reference()
    assert (eng.counters.spec_rounds, eng.counters.spec_proposed,
            eng.counters.spec_accepted) == (0, 0, 0)
    assert eng.health()["spec_decode"] == {"enabled": False}
    assert "spec_verify" not in eng.ledger.by_site


def test_spec_off_exposition_has_no_spec_families():
    eng = _engine("port")
    eng.generate(PROMPTS, max_new_tokens=6)
    reg = pmetrics.MetricsRegistry()
    pmetrics.populate_from_engine(reg, eng)
    assert not any("spec" in name for name in reg.families)
    assert sorted(n for n in reg.families if n.startswith("dstpu_fastpath_")) == [
        "dstpu_fastpath_burst_tokens_total", "dstpu_fastpath_compiles_total",
        "dstpu_fastpath_dispatches_total", "dstpu_fastpath_flushes_total",
        "dstpu_fastpath_host_syncs_total", "dstpu_fastpath_loop_iterations_total",
        "dstpu_fastpath_step_tokens_total", "dstpu_fastpath_upload_ints_total",
        "dstpu_fastpath_uploads_total"]


# ================================================================ ragged seams
def _crash_mid_stream(side, path):
    """Drive a journal-armed spec engine through draft/verify rounds with
    the step()-level API, then abandon it: no terminal frames, no close."""
    ns = jjournal if side == "jax" else pjournal
    j = ns.RequestJournal(path, fsync_every=1, wall_clock=FakeClock(1000.0), seed=0)
    eng = _engine(side, _spec(), journal=j, clock=FakeClock(tick=0.01))
    eng.put([0, 1], [list(p) for p in PROMPTS[:2]])
    emitted = {0: [], 1: []}
    for _ in range(40):
        out = eng._fused_decode(6, greedy=True, eos_token_id=None)
        if out is None:
            out = {u: [t] for u, t in eng.step().items()}
        for uid, toks in out.items():
            emitted[uid].extend(toks)
        if min(len(v) for v in emitted.values()) >= 10:
            break
    assert eng.counters.spec_rounds > 0, "no draft/verify round ran before the crash"
    return emitted, _counters(eng)


def test_journal_replay_crash_mid_stream_accepted_prefixes_only(tmp_path):
    """The journal of a crashed spec engine holds accepted runs only: each
    request's replayed stream is a prefix of the true greedy stream, and not
    ahead of what the engine handed out.  The port's file equals the JAX
    engine's byte for byte, and each replays alike in the other package."""
    paths, emitted = {}, {}
    counters = {}
    for side in ("jax", "port"):
        paths[side] = str(tmp_path / f"{side}.wal")
        emitted[side], counters[side] = _crash_mid_stream(side, paths[side])
    assert emitted["port"] == emitted["jax"] and counters["port"] == counters["jax"]
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    ref = _engine("port").generate([list(p) for p in PROMPTS[:2]], max_new_tokens=24)
    for path in paths.values():
        states = [pjournal.replay_journal(path), jjournal.replay_journal(path)]
        for uid, p in enumerate(PROMPTS[:2]):
            entries = [s.entries[uid] for s in states]
            assert entries[0].emitted == entries[1].emitted
            entry = entries[0]
            assert entry.prompt == p and not entry.done and len(entry.emitted) >= 10
            assert entry.emitted == ref[uid][len(p):][:len(entry.emitted)]
            assert entry.emitted == emitted["port"][uid][:len(entry.emitted)]


def test_rejected_draft_across_block_boundary_rolls_back_clean():
    """A draft long enough to allocate past a block boundary, wholly
    rejected: the overshoot blocks go back in the same round, the table
    shrinks to the accepted length, the census invariant holds, and the next
    plain burst continues the stream over the kept KV (as on the JAX
    engine)."""
    prompt = list(range(1, 16))  # 15 tokens: 2 blocks of 8
    ref = _engine("port").generate([list(prompt)], max_new_tokens=4)[0]

    class RejectAllDrafter:
        def propose_batch(self, seqs, k, pad_to, counters=None):
            # the first proposal differs from the true continuation: a sure
            # rejection at position 0, so exactly ONE token is emitted
            return np.full((pad_to, k), (ref[16] + 1) % 128, np.int32)

    views = {}
    for side in ("jax", "port"):
        eng = _engine(side, _spec())
        eng.put([0], [list(prompt)])
        while len(eng.manager.seqs[0].tokens) < 16:
            eng.step()  # prefill + the first decode step
        seq = eng.manager.seqs[0]
        assert len(seq.tokens) == 16 and seq.seen_tokens == 15 and len(seq.blocks) == 2
        eng._drafter = RejectAllDrafter()
        free_before = eng.manager.allocator.free_blocks
        # k=15 grows the table into a 4th block (16+1+15 = 32 slots); the
        # accepted run of 1 needs only 3
        out = eng.decode_spec(15, greedy=True, eos_token_id=None)
        assert out is not None and out[0] == [ref[16]]
        assert len(seq.tokens) == 17 and seq.seen_tokens == 16
        assert len(seq.blocks) == 3, f"draft-overshoot blocks survived: {len(seq.blocks)}"
        assert eng.manager.allocator.free_blocks == free_before - 1
        eng.check_kv_invariant()
        nxt = eng.decode_burst(2, greedy=True)
        assert nxt is not None and nxt[0] == list(ref[17:19])
        views[side] = (_counters(eng), eng.health()["spec_decode"], eng.health()["kv"])
    assert views["port"] == views["jax"]


def test_spec_scheduler_fused_accounting():
    eng = _engine("port", _spec())
    eng.generate(PROMPTS, max_new_tokens=9)
    assert eng.counters.spec_rounds > 0
    assert eng.scheduler.fused_tokens > 0 and eng.scheduler.fused_steps > 0
    # steps never advance inside a fused round: the sequential count and the
    # fused count partition the work
    assert eng.scheduler.fused_tokens >= eng.scheduler.fused_steps


def test_spec_health_and_metrics_agree_and_render_as_jax():
    """health()["spec_decode"], the counters and the serving_spec_* families
    agree, and the engine's exposition equals the JAX engine's but the
    engine-only families."""
    texts = {}
    for side in ("jax", "port"):
        eng = _engine(side, _spec(), clock=FakeClock(tick=0.01))
        eng.generate(PROMPTS, max_new_tokens=9)
        metrics, expo = SIDES[side]
        reg = metrics.MetricsRegistry()
        metrics.populate_from_engine(reg, eng)
        texts[side] = expo.render(reg)
        if side == "port":
            port, port_reg = eng, reg
    spec = port.health()["spec_decode"]
    assert spec["enabled"] and spec["drafter"] == "ngram"
    assert spec["proposed_total"] == port.counters.spec_proposed
    assert spec["accepted_total"] == port.counters.spec_accepted
    assert 0.0 <= spec["acceptance_ewma"] <= 1.0 and spec["k"] in spec["ladder"]
    fam = port_reg.families["dstpu_serving_spec_proposed_total"]
    assert list(fam.samples.values()) == [float(port.counters.spec_proposed)]
    hist = list(port_reg.families["dstpu_serving_spec_tokens_per_verify"].samples.values())[0]
    assert hist.count == sum(spec["tokens_per_verify"].values())
    fams = pexposition.parse_exposition(texts["port"])
    val = lambda name: fams[name]["samples"][0][2]  # noqa: E731
    assert val("dstpu_serving_spec_accepted_total") == float(port.counters.spec_accepted)
    assert val("dstpu_serving_spec_rounds_total") == float(spec["rounds_total"])
    drop = lambda t: "\n".join(line for line in t.splitlines()  # noqa: E731
                               if not any(name in line for name in ENGINE_ONLY))
    assert "dstpu_serving_spec_tokens_per_verify" in texts["port"]
    assert drop(texts["port"]) == drop(texts["jax"])


@pytest.mark.parametrize("spec", [True, False], ids=["spec", "off"])
def test_spec_under_allocator_faults_equals_spec_off_and_jax(spec):
    """The spec_decode_smoke lane's (a): 25 % allocator faults on both
    sides' engines (the same seeded schedule); a faulted round falls back to
    the plain burst and the streams still equal the healthy spec-off run,
    with the pool reclaimed and no stall."""
    results, counters = {}, {}
    for side, cls in (("jax", JaxFaultyAllocator), ("port", FaultyBlockedAllocator)):
        eng = _engine(side, _spec() if spec else None)
        eng.manager.allocator = cls(64, fail_rate=0.25, seed=7)
        free0 = eng.manager.allocator.free_blocks
        res = eng.generate(PROMPTS, max_new_tokens=12, strict=False)
        assert eng.manager.allocator.injected_failures > 0
        assert eng.manager.allocator.free_blocks == free0
        assert eng.health()["stalls_total"] == 0
        results[side] = [(r.status, r.tokens) for r in res]
        counters[side] = _counters(eng)
        if spec and side == "port":
            assert eng.health()["spec_decode"]["rounds_total"] > 0
    assert results["port"] == results["jax"] and counters["port"] == counters["jax"]
    assert [t for _, t in results["port"]] == _reference(12)

"""Speculative decoding for the v2 serving engine: draft, verify, accept.

Counterpart of ``deepspeed_tpu/inference/v2/spec_decode.py``.  The fused
decode burst already takes k tokens per host sync, but each of them still
streams the target's weights from device memory once.  Speculative decoding
(Leviathan et al., "Fast Inference from Transformers via Speculative
Decoding") spends that stream on several tokens: a cheap drafter proposes k
tokens a sequence, the target scores all of them in ONE batched forward over
the paged KV pool, and rejection sampling on the device keeps the longest
valid prefix plus one corrected (or bonus) token: 1 to k+1 tokens a sequence
for one pass over the weights, with the target's output distribution.

The pieces that do not depend on the engine's dispatch:

- :func:`rejection_select`: accept/reject on the device.  The drafters
  below are deterministic, so the proposal is a delta and the exact rule
  reduces to: accept ``d_i`` with probability ``p_i(d_i)`` under the
  FILTERED target distribution (the temperature/top-k/top-p masking of the
  plain sampler, shared through ``engine._filter_logits``), and at the first
  rejection resample from ``p_i`` with ``d_i`` masked out.  Greedy decode
  reduces to "accept while the argmax agrees, then emit the argmax", which
  is token-identical to greedy decode without speculation.  The packed
  ``[n, k+2]`` result rides the round's one host sync.
- :class:`NgramDrafter`: prompt lookup on the host, no second model.
- :class:`ModelDrafter`: a draft model, greedy over a paged pool of its
  own; its proposals stay on the device and feed the verify directly.
- :class:`AdaptiveKController`: the draft length on a static ladder, so
  every verify width is a prewarmed bucket; at the k=1 floor the engine
  runs the plain burst and re-probes now and then.
- :class:`SpecDecodeStats`: the counters and the tokens-per-verify
  histogram behind ``serving_spec_*`` and ``health()["spec_decode"]``.

Sampled rounds draw from the engine's ``torch.Generator`` (Philox on the
card), the JAX package from its threefry key: the two never share bits, so
sampled parity between the packages is a matter of distributions.
"""

import collections
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...runtime.tree import tree_map
from ..engine import _filter_logits
from .fastpath import upload


def spec_k_ladder(k_max: int) -> Tuple[int, ...]:
    """The static draft-length ladder: 1 (the degrade-to-burst floor) then
    pow2-1 rungs capped at the configured k, so verify widths k+1 stay powers
    of two as long as the cap itself is one.  A static ladder is what lets
    the prewarm enumerate every verify program ahead of serving."""
    rungs = {min(int(k_max), v) for v in (1, 3, 7, 15, 31, 63)}
    return tuple(sorted(rungs))


def rejection_select(logits, draft, generator: Optional[torch.Generator], *, sample_cfg):
    """Accept/reject on the device for one verify round.

    ``logits``: [n, k+1, V] target logits over (input token + k draft
    tokens); position i is conditioned on the draft prefix d_0..d_{i-1}.
    ``draft``: [n, k] proposed tokens.  ``sample_cfg``: None for greedy,
    else (temperature, top_k, top_p), the engine's sampling knobs.
    ``generator`` draws the sampled round's numbers (unused when greedy).

    Returns packed [n, k+2] int32 rows ``[count, e_0, ..., e_k]``: the row
    emits ``e_0..e_{count-1}`` (1 <= count <= k+1).  Accepted positions
    hold e_i == d_i; the last emitted token is the corrected or bonus one
    and becomes the sequence's next input.

    Exactness (a deterministic drafter gives the delta proposal q = δ(d_i)):
    accept d_i with probability p̃_i(d_i); the residual max(p̃ - q, 0)/Z is
    p̃ with d_i zeroed, so the correction samples p̃_i masked at d_i; if all
    k are accepted, the bonus samples p̃_k unmasked.  Each emitted token's
    marginal is p̃, the distribution ``_sample`` draws from."""
    n, kp1, vocab = logits.shape
    k = kp1 - 1
    if sample_cfg is None or sample_cfg[0] == 0.0:
        tgt = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        acc = (draft == tgt[:, :k]).to(torch.int32)
        count = 1 + torch.cumprod(acc, dim=1).sum(dim=1, dtype=torch.int32)
        return torch.cat([count[:, None], tgt], dim=1)
    temperature, top_k, top_p = sample_cfg
    filt = _filter_logits(logits.reshape(n * kp1, vocab), temperature=temperature,
                          top_k=top_k, top_p=top_p).reshape(n, kp1, vocab)
    logp = torch.log_softmax(filt, dim=-1)
    draft = draft.long()
    lp_draft = torch.gather(logp[:, :k], 2, draft[..., None])[..., 0]
    u = torch.rand((n, k), generator=generator, device=logits.device)
    # log-space compare; the 1e-38 floor keeps a u=0 draw (about 2^-24 a
    # draw, not negligible over a serve) from accepting a top-k/top-p
    # MASKED draft token through log(0) = -inf < -1e30
    acc = (torch.log(torch.clamp(u, min=1e-38)) < lp_draft).to(torch.int32)
    a = torch.cumprod(acc, dim=1).sum(dim=1)  # leading accepts, 0..k
    # correction/bonus sample at position a: the residual of the delta
    # proposal (d_a masked) below k; the bonus position a == k samples p̃_k
    row = torch.gather(filt, 1, a[:, None, None].expand(n, 1, vocab))[:, 0]  # [n, V]
    d_pad = torch.cat([draft, draft[:, :1]], dim=1)  # [n, k+1]; column k unused
    d_at_a = torch.gather(d_pad, 1, a[:, None])[:, 0]
    mask = ((torch.arange(vocab, device=logits.device)[None, :] == d_at_a[:, None])
            & (a < k)[:, None])
    row = torch.where(mask, float("-inf"), row)
    fix = torch.multinomial(torch.softmax(row, dim=-1), 1, generator=generator)[:, 0]
    pos = torch.arange(kp1, device=logits.device)[None, :]
    emitted = torch.where(pos == a[:, None], fix[:, None], d_pad)
    return torch.cat([(a + 1)[:, None], emitted], dim=1).to(torch.int32)


class NgramDrafter:
    """Prompt-lookup drafter, no second model.

    Proposes the continuation of the rightmost earlier occurrence of the
    sequence's longest suffix n-gram: host python over token ids the host
    already owns (spec rounds run at wave boundaries), no device work, the
    proposals ride the verify's upload.  It pays off on repetitive or
    templated continuations, copy spans and the cycles greedy decode falls
    into; elsewhere acceptance collapses and the adaptive-k controller takes
    the engine back to the plain burst."""

    #: bound the suffix-match scan to the most recent history: proposal cost
    #: stays O(window), not O(sequence length)
    WINDOW = 256

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1):
        self.ngram_max = max(int(ngram_max), int(ngram_min))
        self.ngram_min = max(1, int(ngram_min))

    def propose(self, tokens: List[int], k: int) -> List[int]:
        """Exactly k proposed tokens for one sequence's token history."""
        hist = tokens[-self.WINDOW:]
        m_len = len(hist)
        for m in range(self.ngram_max, self.ngram_min - 1, -1):
            if m_len <= m:
                continue
            suffix = hist[m_len - m:]
            for j in range(m_len - m - 1, -1, -1):
                if hist[j:j + m] == suffix:
                    cont = hist[j + m:j + m + k]
                    if cont:
                        out = list(cont)
                        while len(out) < k:
                            out.append(out[-1])
                        return out
        return [hist[-1]] * k  # no match: propose a repeat run

    def propose_batch(self, seqs, k: int, pad_to: int, counters=None):
        """[pad_to, k] int32 host proposals, row i for seqs[i] (padded rows
        zero: they decode into the trash block and are never read)."""
        out = np.zeros((pad_to, k), np.int32)
        for i, seq in enumerate(seqs):
            out[i, :] = self.propose(seq.tokens, k)
        return out


class ModelDrafter:
    """A draft model proposing greedily against a paged KV pool of its own.

    The drafter follows the target's paged contract (``forward_paged`` over
    block tables) on a private pool: each round it catches up on the tokens
    the target accepted since its last draft (their positions overwrite
    whatever rejected-draft KV was left there: paged attention never reads
    past ``start_pos + n_tokens``), then drafts k tokens greedily, one
    catch-up forward at a pow2 width t and k-1 single-token steps over the
    same tables.  The proposals stay on the device: the [n, k] tensor feeds
    the engine's verify directly.

    ``programs`` is the engine's ``BucketPrograms``: on the card the
    catch-up ``(n, t, b)`` and the step ``(n, b)`` are CUDA graphs recorded
    under the site ``"draft"``; elsewhere they run eagerly.
    """

    def __init__(self, model_module, model_config, params, *, num_blocks: int,
                 block_size: int, max_blocks_per_seq: int, dtype, device, programs):
        self.model = model_module
        self.cfg = model_config
        self.block_size = int(block_size)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.device = torch.device(device)
        self.params = tree_map(lambda x: torch.as_tensor(x).to(device=self.device, dtype=dtype),
                               params)
        self.kv = model_module.init_paged_cache(model_config, num_blocks, block_size,
                                                dtype=dtype, device=self.device)
        self._programs = programs
        # trivial private allocator: the last block is the trash slot padded
        # rows decode into (the ragged manager's convention)
        self.trash_block = num_blocks - 1
        self._free: List[int] = list(range(num_blocks - 1))
        # uid -> {"blocks": [...], "seen": int, "seq": the descriptor drafted for}
        self._state: Dict[int, Dict] = {}
        self._inputs: Dict = {}  # program key -> its static input tensors
        # draft forwards run, by padded chunk width (the engine's chunk_widths)
        self.chunk_widths = collections.Counter()

    # ------------------------------------------------------------ bookkeeping
    def _gc(self, live_uids) -> None:
        for uid in [u for u in self._state if u not in live_uids]:
            self._free.extend(self._state.pop(uid)["blocks"])

    def _ensure_blocks(self, st: Dict, upto_tokens: int) -> bool:
        need = min(-(-upto_tokens // self.block_size), self.max_blocks_per_seq)
        grow = need - len(st["blocks"])
        if grow > len(self._free):
            return False
        for _ in range(max(0, grow)):
            st["blocks"].append(self._free.pop())
        return True

    # --------------------------------------------------------------- programs
    def _program(self, key, t: int):
        """The catch-up (``key = ("catchup", n, t, b)``) or step (``("step",
        n, b)``, t = 1) program over static inputs (tokens [n, t], n_tokens,
        start positions, tables [n, b]); its output is each row's greedy
        next token [n] int32."""
        n, b = key[1], key[-1]
        inputs = self._inputs.get(key)
        if inputs is None:
            ints = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=self.device)
            inputs = (ints(n, t), torch.ones(n, dtype=torch.int32, device=self.device), ints(n),
                      torch.full((n, b), self.trash_block, dtype=torch.int32,
                                 device=self.device))
            self._inputs[key] = inputs
        trash = self.trash_block

        def make():
            model, cfg, params, kv, bs = self.model, self.cfg, self.params, self.kv, \
                self.block_size

            def draft():
                logits, _ = model.forward_paged(cfg, params, *inputs, kv, block_size=bs)
                last = torch.clamp(inputs[1].long() - 1, min=0)
                row = logits[torch.arange(n, device=logits.device), last]
                return torch.argmax(row, dim=-1).to(torch.int32)

            def neutralize():
                inputs[1].zero_()
                inputs[2].zero_()
                inputs[3].fill_(trash)

            return draft, inputs, neutralize

        return self._programs.get("draft", key, make), inputs

    # ---------------------------------------------------------------- propose
    def propose_batch(self, seqs, k: int, pad_to: int, counters=None):
        """Draft k tokens per sequence; returns a DEVICE [pad_to, k] int32
        tensor (row i for seqs[i]) or None when the private pool cannot
        cover the round (the engine falls back to the plain burst)."""
        self._gc({s.uid for s in seqs})
        n = pad_to
        rows: List[Tuple[Dict, List[int]]] = []
        t_max = 1
        for s in seqs:
            st = self._state.get(s.uid)
            if st is not None and st["seq"] is not s:
                # a reused uid is a new request: the pool holds another
                # history at its positions (the JAX drafter keeps it: ROADMAP F4)
                self._free.extend(st["blocks"])
                st = None
            if st is None:
                st = self._state[s.uid] = {"blocks": [], "seen": 0, "seq": s}
            pending = s.tokens[st["seen"]:]
            if not pending:  # catch-up must feed >= 1 token; re-feed the last
                st["seen"] -= 1
                pending = s.tokens[-1:]
            if not self._ensure_blocks(st, len(s.tokens) + k):
                return None
            rows.append((st, pending))
            t_max = max(t_max, len(pending))
        t = 1
        while t < t_max:
            t *= 2
        b = 1
        while b < max(len(st["blocks"]) for st, _ in rows):
            b *= 2
        tokens = np.zeros((n, t), np.int32)
        nt = np.zeros((n, ), np.int32)
        start = np.zeros((n, ), np.int32)
        tables = np.full((n, b), self.trash_block, np.int32)
        for i, (st, pending) in enumerate(rows):
            tokens[i, :len(pending)] = pending
            nt[i] = len(pending)
            start[i] = st["seen"]
            tables[i, :len(st["blocks"])] = st["blocks"]
            # positions < len(tokens) now hold real-token KV; drafted
            # positions beyond are junk the NEXT catch-up overwrites
            st["seen"] = st["seen"] + len(pending)
        if counters is not None:
            # counted as the JAX drafter counts its one program: one
            # dispatch, the four batch arrays uploaded
            counters.dispatches += 1
            counters.uploads += 4
            counters.upload_ints += int(tokens.size + nt.size + start.size + tables.size)
        catchup, (c_tok, c_nt, c_start, c_tables) = self._program(("catchup", n, t, b), t)
        for dst, arr in ((c_tok, tokens), (c_nt, nt), (c_start, start), (c_tables, tables)):
            dst.copy_(upload(arr, self.device))
        draft = torch.empty((n, k), dtype=torch.int32, device=self.device)
        draft[:, 0] = catchup()
        self.chunk_widths[t] += 1
        if k > 1:
            step, (tok, _, pos, s_tables) = self._program(("step", n, b), 1)
            s_tables.copy_(c_tables)
            pos.copy_(c_start + c_nt)
            tok[:, 0] = draft[:, 0]
            for j in range(1, k):
                draft[:, j] = step()
                tok[:, 0] = draft[:, j]
                pos += 1
            self.chunk_widths[1] += k - 1
        return draft


class AdaptiveKController:
    """EWMA-of-acceptance draft-length controller over the static ladder.

    ``note_round`` folds one verify round's acceptance into the EWMA; the
    live k steps UP one rung when the EWMA clears ``raise_threshold`` and
    DOWN one rung below ``lower_threshold``, never off the ladder, so every
    verify width the controller can pick is a prewarmed bucket.  At the k=1
    floor :meth:`next_k` returns 1 and the engine runs the plain burst;
    every ``probe_every`` floored rounds the controller re-probes the lowest
    speculative rung, so a regime change can win k back."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.ladder = spec_k_ladder(cfg.k)
        self._idx = len(self.ladder) - 1  # start optimistic, at the cap
        self.ewma: Optional[float] = None
        self._floor_rounds = 0

    @property
    def k(self) -> int:
        return self.ladder[self._idx]

    def next_k(self) -> int:
        """The draft length to use for the NEXT fused round."""
        if not self.cfg.adaptive_k:
            return self.cfg.k
        if self.ladder[self._idx] <= 1:
            self._floor_rounds += 1
            if self._floor_rounds >= self.cfg.probe_every and len(self.ladder) > 1:
                self._floor_rounds = 0
                self._idx = 1  # re-probe the lowest speculative rung
        return self.ladder[self._idx]

    def note_round(self, proposed: int, accepted: int) -> None:
        if not self.cfg.adaptive_k or proposed <= 0:
            return
        rate = accepted / proposed
        a = self.cfg.ewma_alpha
        self.ewma = rate if self.ewma is None else a * rate + (1 - a) * self.ewma
        if self.ewma >= self.cfg.raise_threshold:
            self._idx = min(self._idx + 1, len(self.ladder) - 1)
        elif self.ewma <= self.cfg.lower_threshold:
            self._idx = max(self._idx - 1, 0)

    def snapshot(self) -> Dict[str, object]:
        return {"k": self.k, "ladder": list(self.ladder),
                "acceptance_ewma": (round(self.ewma, 4) if self.ewma is not None else None)}


class SpecDecodeStats:
    """Host-side spec-decode accounting behind ``serving_spec_*`` and
    ``health()["spec_decode"]``: proposed/accepted lifetime counters,
    emitted totals, and the tokens-per-verify histogram (a verify of k emits
    1 to k+1 tokens per sequence)."""

    def __init__(self):
        self.rounds_total = 0
        self.proposed_total = 0
        self.accepted_total = 0
        self.emitted_total = 0
        self.fallback_rounds_total = 0  # fused rounds that ran the plain burst
        self.tokens_per_verify: Dict[int, int] = {}

    def note_round(self, proposed: int, accepted: int, run_lengths: List[int]) -> None:
        self.rounds_total += 1
        self.proposed_total += int(proposed)
        self.accepted_total += int(accepted)
        self.emitted_total += int(sum(run_lengths))
        for r in run_lengths:
            self.tokens_per_verify[int(r)] = self.tokens_per_verify.get(int(r), 0) + 1

    def acceptance_rate(self) -> float:
        return self.accepted_total / max(self.proposed_total, 1)

    def snapshot(self) -> Dict[str, object]:
        return {"rounds_total": self.rounds_total,
                "proposed_total": self.proposed_total,
                "accepted_total": self.accepted_total,
                "emitted_total": self.emitted_total,
                "fallback_rounds_total": self.fallback_rounds_total,
                "acceptance_rate": round(self.acceptance_rate(), 4),
                "tokens_per_verify": {str(c): n for c, n in
                                      sorted(self.tokens_per_verify.items())}}

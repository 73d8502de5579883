"""Tuner strategies over a discrete experiment space (JAX
``deepspeed_tpu/autotuning/tuner.py``): grid, random and a model-based
tuner that fits a ridge regression on the configs' features.  Each tuner
draws from its own ``random.Random(seed)``, so for the same candidates and
metric function the order of trials and the winner equal JAX's.
"""

import random
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

Experiment = Dict[str, Any]
RunFn = Callable[[Experiment], Optional[float]]  # None => failed/OOM


class BaseTuner:
    """Iterates candidate experiments, tracking the best measured metric.

    ``run_fn(exp) -> metric`` (higher is better; callers pre-negate latency).
    Early-stops after ``early_stopping`` consecutive non-improving trials.
    """

    def __init__(self, exps: List[Experiment], run_fn: RunFn, early_stopping: int = 5,
                 seed: int = 1234):
        self.all_exps = list(exps)
        self.run_fn = run_fn
        self.early_stopping = early_stopping
        self.best_exp: Optional[Experiment] = None
        self.best_metric: float = -float("inf")
        self.records: List[Tuple[Experiment, Optional[float]]] = []
        # private seeded stream: exploration order is reproducible across
        # reruns/ranks instead of riding the global `random` module state
        self._rng = random.Random(seed)

    def next_batch(self, remaining: List[Experiment]) -> List[Experiment]:
        raise NotImplementedError

    def tune(self, num_trials: Optional[int] = None) -> Tuple[Optional[Experiment], float]:
        remaining = list(self.all_exps)
        budget = num_trials if num_trials is not None else len(remaining)
        stale = 0
        while remaining and len(self.records) < budget:
            for exp in self.next_batch(remaining):
                remaining.remove(exp)
                metric = self.run_fn(exp)
                self.records.append((exp, metric))
                if metric is not None and metric > self.best_metric:
                    self.best_metric = metric
                    self.best_exp = exp
                    stale = 0
                else:
                    stale += 1
                if stale >= self.early_stopping or len(self.records) >= budget:
                    return self.best_exp, self.best_metric
        return self.best_exp, self.best_metric


class GridSearchTuner(BaseTuner):
    """Exhaustive, in declaration order."""

    def next_batch(self, remaining):
        return [remaining[0]]


class RandomTuner(BaseTuner):
    """Uniform random order."""

    def next_batch(self, remaining):
        return [self._rng.choice(remaining)]


def _featurize(exps: List[Experiment]):
    """Encode configs for the regression: numeric knobs (micro-batch, bucket
    sizes) become normalized linear + quadratic terms so the model can place a
    peak *between* tried values; categorical knobs are one-hot; plus a bias."""
    flat = [_flatten(e) for e in exps]
    numeric_keys, categorical = set(), set()
    for f in flat:
        for k, v in f.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                categorical.add((k, repr(v)))
            else:
                numeric_keys.add(k)
    scales = {k: max(abs(float(f.get(k, 0.0))) for f in flat) or 1.0
              for k in numeric_keys}
    num_idx = {k: i for i, k in enumerate(sorted(numeric_keys))}
    cat_idx = {f: i for i, f in enumerate(sorted(categorical))}
    nnum, ncat = len(num_idx), len(cat_idx)

    def vec(exp):
        x = np.zeros(2 * nnum + ncat + 1, dtype=np.float64)  # host features of the regression
        for k, v in _flatten(exp).items():
            if k in num_idx:
                z = float(v) / scales[k]
                x[2 * num_idx[k]] = z
                x[2 * num_idx[k] + 1] = z * z
            else:
                i = cat_idx.get((k, repr(v)))
                if i is not None:
                    x[2 * nnum + i] = 1.0
        x[-1] = 1.0  # bias
        return x

    return vec


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


class ModelBasedTuner(BaseTuner):
    """Explore-then-exploit with a ridge-regression cost model.

    First ``num_random`` trials are random (exploration), then each batch
    refits the model on measured points and proposes the untried candidate
    with the highest predicted metric.
    """

    def __init__(self, exps, run_fn, early_stopping: int = 5, num_random: int = 3,
                 ridge: float = 1e-3, seed: int = 1234):
        super().__init__(exps, run_fn, early_stopping, seed=seed)
        self.num_random = num_random
        self.ridge = ridge
        self._vec = _featurize(self.all_exps)

    def next_batch(self, remaining):
        measured = [(e, m) for e, m in self.records if m is not None]
        if len(measured) < self.num_random:
            return [self._rng.choice(remaining)]
        X = np.stack([self._vec(e) for e, _ in measured])
        y = np.array([m for _, m in measured])
        n = X.shape[1]
        w = np.linalg.solve(X.T @ X + self.ridge * np.eye(n), X.T @ y)
        preds = [(float(self._vec(e) @ w), e) for e in remaining]
        preds.sort(key=lambda p: p[0], reverse=True)
        return [preds[0][1]]

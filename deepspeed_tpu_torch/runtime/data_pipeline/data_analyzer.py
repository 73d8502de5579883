"""Offline data analysis for curriculum learning (a copy of
``deepspeed_tpu/runtime/data_pipeline/data_analyzer.py`` with this package's
logger; the files it writes are the JAX package's).

Analog of the reference ``DataAnalyzer`` (runtime/data_pipeline/data_sampling/
data_analyzer.py:20): a map/reduce over the corpus that computes per-sample
difficulty metrics (e.g. sequence length, vocabulary rarity) and writes the
index files the curriculum sampler consumes:

* ``<metric>_sample_to_metric`` — metric value per global sample index
  (an MMapIndexedDataset, one scalar per sample);
* ``<metric>_metric_to_sample`` — for each distinct metric value, the sample
  indices holding it (dict in an ``.npz``), enabling difficulty-bucketed
  sampling;
* ``<metric>_sum`` for ``accumulate_value_over_samples`` metrics (corpus-wide
  reductions such as total tokens).

``run_map`` shards the dataset over (num_workers, worker_id) so analysis
parallelizes across hosts exactly like the reference; ``run_reduce`` merges
the per-worker partials.  No torch/mpi — partials are files, the reduce is a
second invocation, matching the reference's file-based merge
(data_analyzer.py:260 ``merge_map_results``).
"""

import json
import logging
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .indexed_dataset import MMapIndexedDataset, MMapIndexedDatasetBuilder

logger = logging.getLogger(__name__)

SINGLE_VALUE = "single_value_per_sample"
ACCUMULATE = "accumulate_value_over_samples"


class DataAnalyzer:

    def __init__(self, dataset, metric_names: Sequence[str],
                 metric_functions: Sequence[Callable], metric_types: Sequence[str],
                 save_path: str, num_workers: int = 1, worker_id: int = 0,
                 batch_size: int = 1024):
        if not (len(metric_names) == len(metric_functions) == len(metric_types)):
            raise ValueError("metric_names/functions/types must align")
        for t in metric_types:
            if t not in (SINGLE_VALUE, ACCUMULATE):
                raise ValueError(f"unknown metric type {t!r}")
        self.dataset = dataset
        self.metric_names = list(metric_names)
        self.metric_functions = list(metric_functions)
        self.metric_types = list(metric_types)
        self.save_path = save_path
        self.num_workers = num_workers
        self.worker_id = worker_id
        self.batch_size = batch_size
        os.makedirs(save_path, exist_ok=True)

    # ----------------------------------------------------------------- map
    def _worker_range(self):
        n = len(self.dataset)
        per = -(-n // self.num_workers)
        lo = self.worker_id * per
        return lo, min(lo + per, n)

    def _partial_prefix(self, name: str, worker: int) -> str:
        return os.path.join(self.save_path, f"{name}.worker{worker}")

    def run_map(self) -> None:
        """Compute this worker's shard of every metric and persist partials."""
        lo, hi = self._worker_range()
        logger.info(f"DataAnalyzer map: worker {self.worker_id}/{self.num_workers} "
                    f"samples [{lo}, {hi})")
        singles: Dict[str, List[float]] = {n: [] for n, t in
                                           zip(self.metric_names, self.metric_types)
                                           if t == SINGLE_VALUE}
        sums: Dict[str, float] = {n: 0.0 for n, t in
                                  zip(self.metric_names, self.metric_types)
                                  if t == ACCUMULATE}
        for i in range(lo, hi):
            sample = self.dataset[i]
            for name, fn, mtype in zip(self.metric_names, self.metric_functions,
                                       self.metric_types):
                val = fn(sample)
                if mtype == SINGLE_VALUE:
                    fv = float(val)
                    if fv != int(fv):
                        # match the reference's guard (data_analyzer.py asserts
                        # float metrics unsupported) — silent int() truncation
                        # would collapse fractional difficulties into one bucket
                        raise ValueError(
                            f"metric {name!r} produced non-integral value {fv}; "
                            f"single_value_per_sample metrics must be integers "
                            f"(quantize the metric, e.g. round(100*x))")
                    singles[name].append(fv)
                else:
                    sums[name] += float(val)
        for name, vals in singles.items():
            b = MMapIndexedDatasetBuilder(self._partial_prefix(name, self.worker_id),
                                          dtype=np.int64)
            for v in vals:
                b.add_item([int(v)])
            b.end_document()
            b.finalize()
        meta = {"range": [lo, hi], "sums": sums}
        with open(os.path.join(self.save_path,
                               f"meta.worker{self.worker_id}.json"), "w") as fh:
            json.dump(meta, fh)

    # -------------------------------------------------------------- reduce
    def _out_prefix(self, name: str, kind: str) -> str:
        return os.path.join(self.save_path, f"{name}_{kind}")

    def run_reduce(self) -> None:
        """Merge all workers' partials into the final index files."""
        metas = []
        for w in range(self.num_workers):
            with open(os.path.join(self.save_path, f"meta.worker{w}.json")) as fh:
                metas.append(json.load(fh))
        for name, mtype in zip(self.metric_names, self.metric_types):
            if mtype == ACCUMULATE:
                total = sum(m["sums"][name] for m in metas)
                with open(self._out_prefix(name, "sum") + ".json", "w") as fh:
                    json.dump({"sum": total}, fh)
                continue
            # chunked byte-level merge (merge_file_), not per-sample python
            out_prefix = self._out_prefix(name, "sample_to_metric")
            builder = MMapIndexedDatasetBuilder(out_prefix, dtype=np.int64)
            for w in range(self.num_workers):
                builder.merge_file_(self._partial_prefix(name, w))
            builder.finalize()
            merged = MMapIndexedDataset(out_prefix)
            # every sample is one scalar -> the .bin IS the flat value array
            flat = np.frombuffer(merged._data, np.int64, count=len(merged))
            # vectorized inverse index: one stable argsort, split at value runs
            order = np.argsort(flat, kind="stable")
            vals, starts = np.unique(flat[order], return_index=True)
            bounds = np.append(starts, len(order))
            np.savez(self._out_prefix(name, "metric_to_sample") + ".npz",
                     **{str(int(v)): order[bounds[i]:bounds[i + 1]].astype(np.int64)
                        for i, v in enumerate(vals)})
        logger.info(f"DataAnalyzer reduce: wrote index files to {self.save_path}")

    # ------------------------------------------------------------- loading
    @staticmethod
    def load_sample_to_metric(save_path: str, metric_name: str) -> np.ndarray:
        ds = MMapIndexedDataset(os.path.join(save_path, f"{metric_name}_sample_to_metric"))
        # one scalar per sample: the data buffer is the value array
        return np.frombuffer(ds._data, np.int64, count=len(ds)).copy()

    @staticmethod
    def load_metric_to_sample(save_path: str, metric_name: str) -> Dict[int, np.ndarray]:
        z = np.load(os.path.join(save_path, f"{metric_name}_metric_to_sample.npz"))
        return {int(k): z[k] for k in z.files}

    @staticmethod
    def get_metric_percentiles(save_path: str, metric_name: str,
                               percentiles: Sequence[float]) -> Dict[float, float]:
        """Difficulty thresholds for curriculum schedules (reference
        get_metric_value_percentiles:199)."""
        vals = DataAnalyzer.load_sample_to_metric(save_path, metric_name)
        return {p: float(np.percentile(vals, p)) for p in percentiles}

"""Data loaders.

Counterpart of ``deepspeed_tpu/runtime/dataloader.py`` (``RepeatingLoader``,
``DeepSpeedDataLoader``, ``CurriculumDataLoader``), copied: each assembles
the global macro-batch [train_batch_size, ...] as numpy arrays, in the JAX
package's order for the same seed, with ``state_dict``/``load_state_dict``
for resume; the engine moves a batch to its device in ``train_batch``.
"""

from typing import Callable, Iterator, Optional, Sequence

import numpy as np


class RepeatingLoader:
    """Wraps an iterator to restart on StopIteration (reference dataloader.py:17)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class DeepSpeedDataLoader:
    """Global-batch loader over an indexable dataset.

    dataset[i] returns a pytree sample (dict/tuple of arrays); batches are
    collated by stacking.  ``state_dict``/``load_state_dict`` support
    curriculum-style resume (reference: curriculum-aware resume in
    runtime/dataloader.py + data_sampler).
    """

    def __init__(self,
                 dataset: Sequence,
                 batch_size: int,
                 shuffle: bool = True,
                 seed: int = 0,
                 drop_last: bool = True,
                 collate_fn: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn or _default_collate
        self.epoch = 0
        self._consumed_in_epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _order(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator:
        order = self._order()
        start = self._consumed_in_epoch * self.batch_size
        for ofs in range(start, len(self.dataset) - (self.batch_size - 1 if self.drop_last else 0), self.batch_size):
            batch_idx = order[ofs:ofs + self.batch_size]
            if len(batch_idx) == 0:
                break
            self._consumed_in_epoch += 1
            yield self.collate_fn([self.dataset[int(i)] for i in batch_idx])
        self.epoch += 1
        self._consumed_in_epoch = 0

    def state_dict(self):
        return {"epoch": self.epoch, "consumed_in_epoch": self._consumed_in_epoch, "seed": self.seed}

    def load_state_dict(self, sd):
        self.epoch = sd["epoch"]
        self._consumed_in_epoch = sd["consumed_in_epoch"]
        self.seed = sd["seed"]


class CurriculumDataLoader:
    """Config-driven curriculum loader — what the reference's engine builds in
    ``deepspeed_io`` when data_efficiency curriculum sampling is on
    (runtime/engine.py:1686 + data_sampling/data_sampler.py:36): batch indices
    come from DeepSpeedDataSampler and every batch's sequence dim is truncated
    to the scheduler's current difficulty (seqlen).

    The loader assembles the global macro-batch, so the sampler runs with
    dp_size=1 and micro_batch = train_batch / gas."""

    def __init__(self, dataset, batch_size: int, gradient_accumulation_steps: int,
                 curriculum: dict, seed: int = 0, drop_last: bool = True,
                 collate_fn: Optional[Callable] = None, seq_axis: int = 1):
        from .data_pipeline.data_sampler import DeepSpeedDataSampler
        if batch_size % gradient_accumulation_steps:
            raise ValueError(f"batch_size={batch_size} not divisible by "
                             f"gas={gradient_accumulation_steps}")
        self.dataset = dataset
        self.collate_fn = collate_fn or _default_collate
        self.seq_axis = seq_axis
        self.batch_size = batch_size
        self.data_sampler = DeepSpeedDataSampler(
            total_samples=len(dataset),
            micro_batch_size=batch_size // gradient_accumulation_steps,
            data_parallel_rank=0, data_parallel_size=1,
            gradient_accumulation_steps=gradient_accumulation_steps,
            curriculum=curriculum, seed=seed, drop_last=drop_last)
        self.current_seqlen: Optional[int] = None

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def _truncate(self, batch, seqlen: int):
        ax = self.seq_axis

        def trim(x):
            x = np.asarray(x)
            if x.ndim > ax and x.shape[ax] > seqlen:
                return np.take(x, np.arange(seqlen), axis=ax)
            return x

        return _tree_map(trim, batch)

    def __iter__(self) -> Iterator:
        # one EPOCH per __iter__ (the contract of the DeepSpeedDataLoader this
        # replaces — `for epoch in ...: for batch in loader:` must terminate);
        # the underlying sampler is an infinite stream, so each pass yields
        # len(self) batches and resumes where the previous epoch stopped
        it = iter(self.data_sampler)
        for _ in range(len(self)):
            # difficulty BEFORE consuming the batch, like the reference's
            # sampler (curriculum difficulty for step N applies to batch N)
            self.current_seqlen = self.data_sampler.get_seqlen()
            idx = next(it)
            batch = self.collate_fn([self.dataset[int(i)] for i in idx])
            if self.current_seqlen is not None:
                batch = self._truncate(batch, self.current_seqlen)
            yield batch

    def state_dict(self):
        return self.data_sampler.state_dict()

    def load_state_dict(self, sd):
        self.data_sampler.load_state_dict(sd)


def _tree_map(fn, tree, *rest):
    """``fn`` leaf-wise over nested dicts, tuples and lists (a sample's
    structure, as JAX's pytrees see it)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, *parts) for parts in zip(tree, *rest))
    return fn(tree, *rest)


def _default_collate(samples):
    return _tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *samples)

"""Block-sparsity layout generators.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``,
copied so that the port imports nothing of the JAX package: the same six
classes, knobs and private seeded ``random.Random`` stream, so that a config
gives a layout bit-identical to the JAX package's.  The layout is host-side
planning data from which ``attention.py`` builds the CUDA kernels' block
tables once, so it lives in numpy, not torch.

A layout is ``uint8 [num_heads, num_blocks, num_blocks]``: ``layout[h, i, j]``
says whether query block ``i`` of head ``h`` may attend to key block ``j``.
Element-level masking inside live blocks (causal diagonal, padding) is applied
by the kernel, matching the reference's softmax-stage attn_mask handling
(sparse_self_attention.py:139-146).
"""

import random

import numpy as np


class SparsityConfig:
    """Base class: block size, head count, and per-head layout policy.

    ``seed`` drives every random-block placement through a private
    ``random.Random`` stream (never the global ``random`` module), so a given
    config produces the SAME layout on every rank and every rerun — the layout
    feeds each rank's kernel block tables, and divergent tables would make
    attention itself rank-dependent."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False, seed=1234):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1
        self.seed = seed

    def layout_rng(self):
        """A fresh seeded stream per make_layout call: layouts are a pure
        function of (config, seq_len), not of how many were built before."""
        return random.Random(self.seed)

    def setup_layout(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(
                f"Sequence length {seq_len} must be divisible by block size {self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), dtype=np.uint8)

    def propagate_first_head(self, layout):
        """If all heads share one layout, copy head 0 everywhere."""
        if not self.different_layout_per_head:
            layout[1:] = layout[0:1]
        return layout

    def make_layout(self, seq_len):
        raise NotImplementedError

    # ---- shared vectorised primitives -------------------------------------
    @staticmethod
    def _block_grid(num_blocks):
        """(row, col) index grids for one head's [NB, NB] layout."""
        r = np.arange(num_blocks)[:, None]
        c = np.arange(num_blocks)[None, :]
        return r, c

    @staticmethod
    def _tril(layout_h):
        return np.tril(layout_h).astype(np.uint8)

    def _set_sliding_band(self, h, layout, num_window_blocks):
        """Symmetric sliding band of ±(num_window_blocks // 2) around the diagonal."""
        nb = layout.shape[1]
        if nb < num_window_blocks:
            raise ValueError(f"num_sliding_window_blocks ({num_window_blocks}) "
                             f"exceeds row width ({nb})")
        w = num_window_blocks // 2
        r, c = self._block_grid(nb)
        layout[h] |= (np.abs(r - c) <= w).astype(np.uint8)
        return layout

    @staticmethod
    def _validate_global_ranges(starts, ends):
        if ends is not None:
            if len(starts) != len(ends):
                raise ValueError("global start/end index lists must have equal length")
            for s, e in zip(starts, ends):
                if e <= s:
                    raise ValueError("global block end must exceed its start")


class DenseSparsityConfig(SparsityConfig):
    """All blocks live — degenerates to (optionally causal) dense attention."""

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformer style fixed pattern: local windows of
    ``num_local_blocks`` plus per-window global representative columns
    (last ``num_global_blocks`` of each window, rotated across heads by
    ``num_different_global_patterns``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1, attention="bidirectional",
                 horizontal_global_attention=False, num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"num_local_blocks ({num_local_blocks}) must be divisible by "
                f"num_global_blocks ({num_global_blocks})")
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError("attention must be uni/bidirectional")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires bidirectional")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("multiple global patterns require different_layout_per_head")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError("num_different_global_patterns cannot exceed "
                             "num_local_blocks // num_global_blocks")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def _local(self, h, layout):
        nb = layout.shape[1]
        r, c = self._block_grid(nb)
        same_window = (r // self.num_local_blocks) == (c // self.num_local_blocks)
        if self.attention == "unidirectional":
            same_window = same_window & (c <= r)
        layout[h] |= same_window.astype(np.uint8)
        return layout

    def _global(self, h, layout):
        nb = layout.shape[1]
        L, G = self.num_local_blocks, self.num_global_blocks
        first = L - (1 + h % self.num_different_global_patterns) * G
        full_end = nb - (nb % L)
        starts = list(range(first, full_end, L))
        if full_end < nb:  # short trailing window: clamp its representative
            starts.append(min(full_end + first, nb - G))
        for g in starts:
            row0 = 0 if self.attention == "bidirectional" else g
            layout[h, row0:, g:g + G] = 1  # vertical stripe
            if self.horizontal_global_attention:
                layout[h, g:g + G, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self._local(h, layout)
            layout = self._global(h, layout)
        return self.propagate_first_head(layout)


class VariableSparsityConfig(SparsityConfig):
    """Random + variable-width local windows + user-chosen global blocks.
    ``local_window_blocks`` lists successive window widths (last one repeats);
    ``global_block_indices``/``global_block_end_indices`` choose global columns
    either as single blocks or [start, end) ranges."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=None,
                 global_block_indices=None, global_block_end_indices=None,
                 attention="bidirectional", horizontal_global_attention=False,
                 seed=1234):
        super().__init__(num_heads, block, different_layout_per_head, seed=seed)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError("attention must be uni/bidirectional")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires bidirectional")
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices if global_block_indices is not None else [0]
        self._validate_global_ranges(self.global_block_indices, global_block_end_indices)
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def _random(self, h, layout, rng):
        nb = layout.shape[1]
        if self.num_random_blocks == 0:
            return layout
        if nb < self.num_random_blocks:
            raise ValueError(f"num_random_blocks ({self.num_random_blocks}) exceeds "
                             f"row width ({nb})")
        for row in range(nb):
            cols = rng.sample(range(nb), self.num_random_blocks)
            layout[h, row, cols] = 1
        return layout

    def _local(self, h, layout):
        nb = layout.shape[1]
        start = 0
        widths = list(self.local_window_blocks)
        # repeat the final width over any remaining rows
        while start < nb:
            w = widths.pop(0) if widths else self.local_window_blocks[-1]
            end = min(start + w, nb)
            r, c = np.meshgrid(np.arange(start, end), np.arange(start, end), indexing="ij")
            if self.attention == "unidirectional":
                keep = c <= r
                layout[h, r[keep], c[keep]] = 1
            else:
                layout[h, start:end, start:end] = 1
            start = end
        return layout

    def _global(self, h, layout):
        nb = layout.shape[1]
        if self.global_block_end_indices is None:
            ranges = [(i, i + 1) for i in self.global_block_indices]
        else:
            ranges = list(zip(self.global_block_indices, self.global_block_end_indices))
        for s, e in ranges:
            if s >= nb:
                continue
            e = min(e, nb)
            if self.horizontal_global_attention:
                layout[h, s:e, :] = 1
            row0 = 0 if self.attention == "bidirectional" else s
            layout[h, row0:, s:e] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        rng = self.layout_rng()
        for h in range(self.num_layout_heads):
            layout = self._random(h, layout, rng)
            layout = self._local(h, layout)
            layout = self._global(h, layout)
        return self.propagate_first_head(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird ITC: random blocks + sliding window + leading global blocks."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3, num_global_blocks=1,
                 attention="bidirectional", seed=1234):
        super().__init__(num_heads, block, different_layout_per_head, seed=seed)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError("attention must be uni/bidirectional")
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention

    def _random(self, h, layout, rng):
        nb = layout.shape[1]
        if nb < self.num_random_blocks:
            raise ValueError(f"num_random_blocks ({self.num_random_blocks}) exceeds "
                             f"row width ({nb})")
        for row in range(nb):
            pool = range(nb) if self.attention == "bidirectional" else range(row + 1)
            k = min(self.num_random_blocks, len(pool))
            layout[h, row, rng.sample(pool, k)] = 1
        return layout

    def _sliding(self, h, layout):
        return self._set_sliding_band(h, layout, self.num_sliding_window_blocks)

    def _global(self, h, layout):
        nb = layout.shape[1]
        if nb < self.num_global_blocks:
            raise ValueError(f"num_global_blocks ({self.num_global_blocks}) exceeds "
                             f"row width ({nb})")
        G = self.num_global_blocks
        layout[h, :G, :] = 1
        layout[h, :, :G] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        rng = self.layout_rng()
        for h in range(self.num_layout_heads):
            layout = self._random(h, layout, rng)
            layout = self._sliding(h, layout)
            layout = self._global(h, layout)
            if self.attention == "unidirectional":
                layout[h] = self._tril(layout[h])
        return self.propagate_first_head(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Blocked Longformer: sliding window + symmetric (row+col) global blocks."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=None,
                 global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices if global_block_indices is not None else [0]
        self._validate_global_ranges(self.global_block_indices, global_block_end_indices)
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def _sliding(self, h, layout):
        return self._set_sliding_band(h, layout, self.num_sliding_window_blocks)

    def _global(self, h, layout):
        nb = layout.shape[1]
        if self.global_block_end_indices is None:
            ranges = [(i, i + 1) for i in self.global_block_indices]
        else:
            ranges = list(zip(self.global_block_indices, self.global_block_end_indices))
        for s, e in ranges:
            if s >= nb:
                continue
            e = min(e, nb)
            layout[h, s:e, :] = 1
            layout[h, :, s:e] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self._sliding(h, layout)
            layout = self._global(h, layout)
            if self.attention == "unidirectional":
                layout[h] = self._tril(layout[h])
        return self.propagate_first_head(layout)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Pure sliding-window attention (the Mistral pattern, block-granular)."""

    def __init__(self, num_heads, block=16, num_sliding_window_blocks=3,
                 attention="unidirectional"):
        super().__init__(num_heads, block)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        if nb < self.num_sliding_window_blocks:
            raise ValueError(f"num_sliding_window_blocks "
                             f"({self.num_sliding_window_blocks}) exceeds row width ({nb})")
        w = self.num_sliding_window_blocks // 2
        r, c = self._block_grid(nb)
        band = (r - c <= w) & (c <= r) if self.attention == "unidirectional" \
            else (np.abs(r - c) <= w)
        layout[0] |= band.astype(np.uint8)
        return self.propagate_first_head(layout)

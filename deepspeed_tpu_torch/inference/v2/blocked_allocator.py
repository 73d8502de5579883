"""Blocked KV allocator — host-side free list over the paged KV pool.

Counterpart of ``deepspeed_tpu/inference/v2/blocked_allocator.py``: fixed
number of KV blocks, O(1) allocate/free via a free list.  The last block id
is reserved as the trash target for padded writes (models.llama.forward_paged).

Block-level ref-counting: a block can be mapped by more than one sequence at
a time (copy-on-write prefix sharing, ``ragged_manager.PrefixCache``).
``allocate`` hands out blocks at refcount 1, ``incref`` adds a mapping, and
``free`` RELEASES ONE MAPPING: the block returns to the free list only when
its refcount reaches zero.  Releasing a block more times than it was mapped is a loud
``ValueError`` (the bug class that silently aliases two sequences' KV).

Failures raise :class:`KVAllocationError` (a RuntimeError) so callers can tell
"the pool is tight, retry later" apart from programming errors — the SplitFuse
scheduler treats it as a failed reservation and retries the chunk on a later
step.
"""

from typing import Dict, List


class KVAllocationError(RuntimeError):
    """The KV pool could not satisfy an allocation (exhausted, or an injected
    transient fault).  Retryable: freed blocks make the same request succeed."""


class BlockedAllocator:

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (1 usable + trash)")
        self.num_blocks = num_blocks
        self.trash_block = num_blocks - 1
        self._free: List[int] = list(range(num_blocks - 1))  # trash never allocated
        # every outstanding block id; a free() of a block not in here is a
        # double free (the bug class that silently aliases two sequences' KV)
        self._in_use: set = set()
        # mappings per outstanding block: 1 at allocation, +1 per incref,
        # -1 per free; the free list gets the block back only at zero
        self._refs: Dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def free_block_set(self) -> frozenset:
        """The free list as a set: the block census checks that its owned set
        partitions the usable pool exactly against this
        (``kv_metrics.BlockCensus.check_against``)."""
        return frozenset(self._free)

    def refcount(self, block: int) -> int:
        """Outstanding mappings of ``block`` (0 for a free/unknown block);
        the census's refcount-agreement check reads this."""
        return self._refs.get(block, 0)

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise KVAllocationError(f"KV pool exhausted: requested {n}, free {len(self._free)}")
        out = self._free[:n]
        self._free = self._free[n:]
        self._in_use.update(out)
        for b in out:
            self._refs[b] = 1
        return out

    def incref(self, block: int) -> None:
        """Add one read-only mapping to an OUTSTANDING block.  Incref of a
        free/unknown block is a programming error — the mapped KV would be
        rewritten by the block's next owner."""
        if block not in self._in_use:
            raise ValueError(f"incref of block {block}: not currently allocated "
                             f"(a free block's KV has no owner to share)")
        self._refs[block] += 1

    def free(self, blocks: List[int]) -> List[int]:
        """Release one mapping per listed block.  Returns the blocks whose
        refcount reached zero and actually went back to the free list: the
        prefix cache drops its entries for exactly these blocks."""
        seen = set()
        for b in blocks:
            if b == self.trash_block or b < 0 or b >= self.num_blocks:
                raise ValueError(f"bad block id {b}")
            if b not in self._in_use or b in seen:
                raise ValueError(f"double free of block {b}: not currently allocated "
                                 f"(would alias two sequences onto one KV block)")
            seen.add(b)
        released: List[int] = []
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] <= 0:
                del self._refs[b]
                self._in_use.discard(b)
                released.append(b)
        self._free.extend(released)
        return released

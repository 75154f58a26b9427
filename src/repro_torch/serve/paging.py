"""Block-paged KV-cache pool for the serve engine (vLLM-style paging), the
PyTorch port of the JAX package's ``serve/paging.py``.

The fixed-row serve cache gives every slot a ``max_seq`` row, so memory —
not compute — caps concurrent slots.  This module replaces those rows
with a physical **block pool** sized by a memory budget
(``ServeConfig(kv_pool_blocks=...)``): each slot owns a growable list of
``block_size``-token blocks, and per-slot **block tables** ride the
engine's compiled prefill / decode / verify entries as device tensors,
where :func:`repro_torch.models.layers.paged_gather` materializes each
row's blocks into the dense fixed-row layout the attention kernels
already consume and :func:`~repro_torch.models.layers.paged_scatter`
persists exactly the freshly written positions, into the pool in place.
Dynamic-shape logic thus stays inside the compiled entries (on the card
each is one CUDA graph, which reads the pool where it lies) and compile
counts stay O(#buckets).

Conventions:

* physical block id **0 is the null block**: allocators hand out ids
  ``1..n_blocks``; null-padded table entries gather garbage that the
  length masks keep out of every real row, and masked scatter writes are
  routed into it.
* ``max_seq % block_size == 0`` is enforced by the engine, so a full
  table covers exactly ``max_seq`` positions and the gathered dense rows
  are shape-identical to the fixed path — with an unconstrained pool the
  paged engine gives the fixed rows' tokens.
* on pool pressure the engine preempts a victim
  (:func:`pick_victim`: lowest priority, then newest admission), releases
  its blocks, and requeues the request with prompt+generated tokens for
  greedy recompute — every already-emitted token is preserved exactly and
  the token budget is unchanged; the continuation is re-derived greedily
  (recompute runs through the prefill kernel, so an argmax near-tie may
  resolve differently than the decode kernel would have).

The allocator is host bookkeeping; :attr:`PagedKVPool.tree` lives on the
engine's device.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ft import faults
from ..models.layers import paged_gather, paged_scatter
from ..models.registry import Model, tree_map

__all__ = ["NULL_BLOCK", "blocks_for", "BlockAllocator", "PagedKVPool",
           "pick_victim"]

#: physical id of the write-absorbing null block (never allocated)
NULL_BLOCK = 0


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` cache positions."""
    return -(-max(int(n_tokens), 0) // block_size)


class BlockAllocator:
    """Free-list allocator mapping slots to owned physical blocks.

    Invariants (see :meth:`assert_consistent`): a block is owned by at
    most one slot, freed blocks return to the free list, and
    ``owned + free == n_blocks`` always; id 0 (the null block) is never
    handed out.
    """

    def __init__(self, n_blocks: int, block_size: int, n_slots: int,
                 max_blocks_per_slot: int):
        if n_blocks < 1:
            raise ValueError(f"need at least 1 block, got {n_blocks}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.n_slots = n_slots
        self.max_blocks_per_slot = max_blocks_per_slot
        # LIFO free list, ids 1..n_blocks (low ids pop first)
        self._free: List[int] = list(range(n_blocks, 0, -1))
        self._owned: List[List[int]] = [[] for _ in range(n_slots)]

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    def owned(self, slot: int) -> List[int]:
        return list(self._owned[slot])

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s allocation to cover ``n_tokens`` positions.
        All-or-nothing: on failure nothing is allocated and the caller
        must free memory (preempt) or shrink the ask."""
        need = blocks_for(n_tokens, self.block_size)
        if need > self.max_blocks_per_slot:
            return False
        missing = need - len(self._owned[slot])
        if missing <= 0:
            return True
        if missing > len(self._free):
            return False
        if faults.ACTIVE is not None and faults.ACTIVE.suppress(
                "pool.alloc", key=f"slot{slot}"):
            return False    # injected pool pressure: allocation denied
        for _ in range(missing):
            self._owned[slot].append(self._free.pop())
        return True

    def release(self, slot: int) -> int:
        """Return every block ``slot`` owns to the free list; the number
        of blocks freed is the eviction count."""
        blks = self._owned[slot]
        self._free.extend(reversed(blks))
        self._owned[slot] = []
        return len(blks)

    def table(self) -> np.ndarray:
        """The (n_slots, max_blocks_per_slot) int32 block-table matrix,
        null-padded — the host-side input the paged artifacts gather
        through."""
        t = np.full((self.n_slots, self.max_blocks_per_slot), NULL_BLOCK,
                    np.int32)
        for i, blks in enumerate(self._owned):
            t[i, :len(blks)] = blks
        return t

    def assert_consistent(self) -> None:
        owned = [b for blks in self._owned for b in blks]
        assert len(set(owned)) == len(owned), "block double-assigned"
        assert set(owned).isdisjoint(self._free), "owned block on free list"
        assert len(owned) + len(self._free) == self.n_blocks
        assert NULL_BLOCK not in owned and NULL_BLOCK not in self._free
        assert all(len(blks) <= self.max_blocks_per_slot
                   for blks in self._owned)


class PagedKVPool:
    """The physical pool tree plus gather / scatter over it.

    ``tree`` leaves come from ``model.init_block_pool(n_blocks + 1,
    block_size, device)`` — the fixed-row cache with the batch axis
    reinterpreted as block ids (axis 1 of the layer-stacked leaves) and
    one extra block, id 0, as the null sink.  The engine's compiled
    entries read and write it in place, so its leaves stay the same
    tensors for the pool's life.
    """

    def __init__(self, model: Model, *, n_blocks: int, block_size: int,
                 device):
        if model.init_block_pool is None:
            raise ValueError(
                f"model family {model.cfg.family!r} has no paged-KV "
                f"support (recurrent state has no sequence axis to "
                f"page); use fixed rows (ServeConfig(kv_block_size=None))")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.seq_axes = model.page_axes()
        self.tree = model.init_block_pool(n_blocks + 1, block_size, device)

    def gather(self, pool: Any, tables: torch.Tensor) -> Any:
        """Dense per-row cache tree for ``tables`` (B, M) — called inside
        the compiled entries."""
        return tree_map(
            lambda leaf, ax: paged_gather(leaf, tables, block_axis=1,
                                          seq_axis=ax),
            pool, self.seq_axes)

    def scatter(self, pool: Any, dense: Any, tables: torch.Tensor,
                keep: torch.Tensor, positions: torch.Tensor) -> Any:
        """Persist the ``keep`` (B, W) positions ``positions`` (B, W) of a
        dense row tree into the pool, in place — the few positions a
        launch wrote — and return ``pool``."""
        return tree_map(
            lambda leaf, d, ax: paged_scatter(leaf, d, tables, keep,
                                              block_axis=1, seq_axis=ax,
                                              positions=positions),
            pool, dense, self.seq_axes)


def pick_victim(
        candidates: Sequence[Tuple[int, int, int]]) -> Optional[int]:
    """Preemption victim among ``(slot, priority, admit_seq)`` tuples:
    lowest priority first, newest admission first within a class (the
    request that has consumed the least service is recomputed)."""
    if not candidates:
        return None
    return min(candidates, key=lambda c: (c[1], -c[2]))[0]

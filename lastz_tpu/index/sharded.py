"""Interval-sharded target index for targets beyond one device's memory.

The reference scales past 4 Gbp targets with wide-index builds
(lastz_32 <= 4.3 Gbp, lastz_40 <= 1.1 Tbp, src/Makefile:19-25) on a
big-memory host.  The device equivalent shards the target by interval
across devices/hosts:

  * shard d owns word END positions in (bounds[d], bounds[d+1]]
    (origin-0 exclusive ends; shard 0 starts at the first full word);
  * each shard builds its own CSR position table from ONLY its target
    slice plus an L-1 left halo, so no device ever materializes the
    whole target — the build is exactly the per-interval builder
    already used for subranges (build_seed_position_table /
    build_seed_position_table_device);
  * the per-word position lists of the shards are disjoint and
    ordered: concatenating shard lists ascending reproduces the
    unsharded CSR EXACTLY, so the reference's observable last/prev
    (descending) enumeration order (pos_table.c:118-470) is preserved
    by probing shards in descending order — or by the merged view.

Memory budget: the CSR costs ~4 bytes/indexed position + 4*(4^W)
bytes of word starts, and the packed target codes 1 byte/bp, so a
4.3 Gbp target needs ~21 GB replicated on every device; N-way
sharding divides that by N.
Downstream stages consume the index shard-locally: seed hits carry
absolute pos1, so the diagonal-hash resolve and extension operate on
the merged hit stream unchanged (extension windows gather from the
shard slices with halo; hits near a border fetch the neighbour's
slice from the neighbour device).

Query sharding (the capsule farm-out, capsule.c:6-15) composes with
this: the mesh gets a (query, target-shard) grid.
"""

from __future__ import annotations

import numpy as np

from ..core.seeds import Seed
from .postable import PositionTable, build_seed_position_table


def shard_bounds(n: int, n_shards: int, length: int) -> list[int]:
    """End-position partition bounds: shard d owns word end positions
    in (bounds[d], bounds[d+1]].  bounds[0] = length - 1 so shard 0
    starts at the first possible word end (= length)."""
    if n_shards < 1:
        raise ValueError("need at least one shard")
    lo, hi = length - 1, n
    if hi <= lo:
        raise ValueError("target shorter than the seed")
    per = (hi - lo + n_shards - 1) // n_shards
    return [min(lo + d * per, hi) for d in range(n_shards + 1)]


class ShardedPositionTable:
    """A list of per-interval PositionTables over disjoint end-position
    ranges, presenting the same probe interface."""

    def __init__(self, shards: list[PositionTable], seed: Seed,
                 step: int, n: int):
        self.shards = shards
        self.seed = seed
        self.step = step
        self.start = 0
        self.end = n
        self.alive = None

    def positions_for(self, word: int) -> np.ndarray:
        """Reference (descending) enumeration order: descending shard
        order, each shard's list already descending."""
        parts = [s.positions_for(word) for s in reversed(self.shards)]
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    def as_merged(self) -> PositionTable:
        """The exact unsharded table, by per-word CSR concatenation —
        what a gather of the shard CSRs onto one device produces.
        Positions are rebased to the global adj_start=0, step basis
        (stored end positions are step-aligned by construction)."""
        num_words = 1 << self.seed.weight
        counts = np.zeros(num_words, np.int64)
        absolutes = []
        for s in self.shards:
            counts += np.diff(s.csr_start).astype(np.int64)
            absolutes.append(
                s.adj_start + s.step * s.csr_pos.astype(np.int64))
        csr_start = np.concatenate(
            [[0], np.cumsum(counts)]).astype(np.int64)
        total = int(csr_start[-1])
        merged = np.empty(total, np.uint32)
        fill = csr_start[:-1].copy()
        for s, ab in zip(self.shards, absolutes):
            cs = s.csr_start
            cnt = np.diff(cs).astype(np.int64)
            nz = np.nonzero(cnt)[0]
            stored = (ab // self.step).astype(np.uint32)
            for w in nz:
                k = int(cnt[w])
                o = int(fill[w])
                merged[o: o + k] = stored[cs[w]: cs[w] + k]
                fill[w] += k
        dt = np.int32 if total < (1 << 31) else np.int64
        return PositionTable(
            seed=self.seed, step=self.step, start=0, end=self.end,
            adj_start=0, csr_start=csr_start.astype(dt),
            csr_pos=merged)


def build_sharded_position_table(
    seq_v: np.ndarray,
    char_to_bits: np.ndarray,
    seed: Seed,
    step: int = 1,
    n_shards: int = 2,
) -> ShardedPositionTable:
    """Build each shard's table from ONLY its slice + L-1 halo (the
    memory contract a per-device build must honor)."""
    n = len(seq_v)
    L = seed.length
    bounds = shard_bounds(n, n_shards, L)
    shards = []
    for d in range(n_shards):
        lo, hi = bounds[d], bounds[d + 1]
        if hi <= lo:
            continue
        # slice start: left halo of L-1 bases, extended down to a
        # step multiple so the slice-local step filter matches the
        # global one ((end % step == 0) must agree in both frames)
        s0 = max(0, lo + 1 - L)
        s0 -= s0 % step
        local = np.ascontiguousarray(seq_v[s0:hi])
        pt = build_seed_position_table(
            local, (lo + 1 - L) - s0, hi - s0, char_to_bits, seed,
            step)
        # rebase the interval bookkeeping to absolute coordinates;
        # stored positions stay slice-relative to adj_start
        pt.start += s0
        pt.end += s0
        pt.adj_start += s0
        shards.append(pt)
    return ShardedPositionTable(shards, seed, step, n)

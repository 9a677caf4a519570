"""Mesh-executed interval-sharded target search: the lastz_32/lastz_40
beyond-HBM tier (reference src/Makefile:19-25, pos_table.c:118) as an
SPMD program over a jax.sharding.Mesh.

The host may hold the whole target (the reference's wide-index builds
run on big-memory hosts too); the DEVICES never do.  Each mesh device
owns one interval shard of index/sharded.py's contract:

  * its CSR position table, built from only its slice + L-1 halo;
  * its compact-alphabet target codes over the slice plus an
    EXT_HALO-wide extension halo on each side.

One shard_map program (probe + expand + gap-free x-drop extension —
the FLOPs) runs shard-locally on every device at once: each shard
probes ITS CSR with the (replicated, small) query words and extends
every candidate against ITS resident slice, clamped to the halo.
Candidates come back as fixed-size per-shard buffers; the host merges
them into the reference's exact enumeration order (query position
ascending, probe order, target position descending = sort by
(pair index, -pos1); shard position sets are disjoint) and replays
the sequential 64K diagonal-hash drop protocol + reporting exactly as
search/batched.py does (process_for_simple_hit,
seed_search.c:1056-1198).

Halo-gather at borders: a candidate whose extension consumed its
whole clamped range while the true range continues past the resident
halo is re-extended against a window GATHERED from the owning shards'
device slices (never from a host copy of the target) — the window
doubles until the scan terminates inside it.  Across cards this
gather is a device-to-device copy; hits needing it are rare (an extension must survive
EXT_HALO bases without dropping).

Exactness: extension is speculative and unconstrained (identical to
the batched host path), the drop protocol runs on the merged stream
in reference order, and the rare left-blocked re-extension falls back
to the scalar engine — so results are hit-for-hit identical to the
scalar oracle (tests/test_sharded_mesh.py proves 2- and 4-shard
equality on the virtual mesh).
"""

from __future__ import annotations

import functools
import os

import numpy as np

from ..config import GFEX_XDROP
from ..core.scoring import entropy
from ..index.postable import _window_words
from ..index.sharded import build_sharded_position_table
from .batched import (DIAG_HASH_SIZE, HASH_INACTIVE, MIN64, _probe_xors,
                      _resolve_chains)

# extension halo (bases) resident beyond each shard's owned interval;
# overridable for tests that force the halo-gather path
EXT_HALO = int(os.environ.get("LASTZ_TPU_SHARD_HALO", "32768"))
OUT_ROWS = 9  # pos1, k, lb, lk, rb, rk, lc, rc, eflag


def _mesh_for(n_shards: int):
    import jax
    from jax.sharding import Mesh
    devs = jax.devices()
    if len(devs) < n_shards:
        raise ValueError(
            f"need {n_shards} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n_shards]), ("shard",))


class MeshShardedIndex:
    """Per-device shard residency: CSR + compact slice codes, placed
    so device d holds only shard d (NamedSharding over axis 'shard')."""

    def __init__(self, seq1_v, char_to_bits, seed, step, n_shards,
                 sub, ext_halo=None, mesh=None):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..ops.hitgen import SEQ_PAD
        from ..ops.ydrop_exact import make_compact_alphabet

        self.halo = EXT_HALO if ext_halo is None else int(ext_halo)
        self.seed = seed
        self.step = step
        self.n = len(seq1_v)
        sh = build_sharded_position_table(
            seq1_v, char_to_bits, seed, step, n_shards)
        self.n_shards = len(sh.shards)
        self.mesh = mesh or _mesh_for(self.n_shards)
        cmap = make_compact_alphabet([seq1_v], sub, max_k=16)
        if cmap is None:
            raise ValueError("alphabet too wide for the device path")
        self.code_map, self.subsmall = cmap
        self.K = self.subsmall.shape[0]

        S = self.n_shards
        nw = 1 << seed.weight
        pmax = max(int(len(p.csr_pos)) for p in sh.shards)
        res_lo = np.zeros(S, np.int64)
        res_hi = np.zeros(S, np.int64)
        for d, pt in enumerate(sh.shards):
            # owned word-end interval (start, end]; resident codes add
            # the extension halo on both sides
            res_lo[d] = max(0, pt.start - self.halo)
            res_hi[d] = min(self.n, pt.end + self.halo)
        cmax = int((res_hi - res_lo).max()) + 2 * SEQ_PAD
        csr_start = np.zeros((S, nw + 1), np.int32)
        csr_pos = np.zeros((S, pmax), np.int32)
        adj = np.zeros(S, np.int32)
        codes = np.zeros((S, cmax), np.int8)
        for d, pt in enumerate(sh.shards):
            csr_start[d] = pt.csr_start
            csr_pos[d, : len(pt.csr_pos)] = pt.csr_pos
            adj[d] = pt.adj_start
            span = res_hi[d] - res_lo[d]
            codes[d, SEQ_PAD: SEQ_PAD + span] = \
                self.code_map[seq1_v[res_lo[d]: res_hi[d]]]
        self.res_lo = res_lo
        self.res_hi = res_hi
        # non-overlapping cover ranges for window gathering
        self.cov = np.zeros(S + 1, np.int64)
        self.cov[1:-1] = [sh.shards[d].end for d in range(S - 1)]
        self.cov[-1] = self.n

        def put(a):
            return jax.device_put(
                a, NamedSharding(self.mesh, P("shard")))

        self.csr_start_d = put(jnp.asarray(csr_start))
        self.csr_pos_d = put(jnp.asarray(csr_pos))
        self.adj_d = put(jnp.asarray(adj))
        self.codes_d = put(jnp.asarray(codes))
        self.res_lo_d = put(jnp.asarray(res_lo.astype(np.int32)))
        self.res_hi_d = put(jnp.asarray(res_hi.astype(np.int32)))
        # the largest target-derived bytes any one device holds (the
        # "no device holds the whole target" budget, asserted in tests)
        self.per_device_target_bytes = int(
            cmax + csr_pos.nbytes // S + csr_start.nbytes // S)

    def gather_codes(self, lo: int, hi: int) -> np.ndarray:
        """Assemble compact codes for absolute range [lo, hi) from the
        owning shards' DEVICE slices (the halo gather; the host
        target array is never consulted)."""
        from ..ops.hitgen import SEQ_PAD
        lo = max(lo, 0)
        hi = min(hi, self.n)
        out = np.zeros(hi - lo, np.int8)
        for d in range(self.n_shards):
            a = max(lo, int(self.cov[d]))
            b = min(hi, int(self.cov[d + 1]))
            if a >= b:
                continue
            o = SEQ_PAD + (a - int(self.res_lo[d]))
            out[a - lo: b - lo] = np.asarray(
                self.codes_d[d, o: o + (b - a)])
        return out


# ---------------------------------------------------------------------------
# the shard-local SPMD program
# ---------------------------------------------------------------------------


def _shard_probe_extend(csr_start, csr_pos, adj, codes, res_lo,
                        res_hi, packed, valid, xors, subflat, qcodes,
                        dyn, *, CAP, K, nprobe, L, step, PCH,
                        self_compare, same_strand):
    """Per-shard body (leading axis 1 from shard_map is squeezed).
    dyn: (chunk_lo, p_lo, p_hi, x_drop, len1, len2, band) int32."""
    import jax
    import jax.numpy as jnp

    from ..ops.hitgen import _xdrop_all, expand_chunk, pair_counts

    csr_start = csr_start[0]
    csr_pos = csr_pos[0]
    adj = adj[0]
    codes = codes[0]
    res_lo = res_lo[0]
    res_hi = res_hi[0]

    chunk_lo, p_lo, p_hi, x_drop, len1, len2, band = (
        dyn[0], dyn[1], dyn[2], dyn[3], dyn[4], dyn[5], dyn[6])
    pk = jax.lax.dynamic_slice_in_dim(packed, chunk_lo, PCH)
    vd = jax.lax.dynamic_slice_in_dim(valid, chunk_lo, PCH)
    widx = jnp.arange(PCH, dtype=jnp.int32)
    vd = vd & (widx >= p_lo) & (widx < p_hi)

    cum, ends, tot = pair_counts(pk, vd, xors, csr_start)
    karr = expand_chunk(cum, CAP)
    i = jnp.arange(CAP, dtype=jnp.int32)
    live = i < jnp.minimum(tot, CAP)
    overflow = tot > CAP

    k = jnp.clip(karr, 0, ends.shape[0] - 1)
    within = i - cum[k]
    pidx = k // nprobe
    csr_idx = jnp.clip(ends[k] - 1 - within, 0,
                       csr_pos.shape[0] - 1)
    pos1 = adj + step * csr_pos[csr_idx]
    pos2 = chunk_lo + L + pidx
    if self_compare:
        if same_strand:
            live = live & (pos1 < pos2)
        else:
            p1s = pos1 - L
            p2s = (len2 - 1) - (pos2 - L)
            live = live & (p1s < p2s)
    if same_strand:
        live = live & ((pos2 - pos1) <= band)

    diag = pos1 - pos2
    n_l_true = jnp.where(live, pos1 - jnp.maximum(diag, 0), 0)
    stop1r = jnp.minimum(len1, len2 + diag)
    n_r_true = jnp.where(live, jnp.maximum(stop1r - pos1, 0), 0)
    p1loc = pos1 - res_lo
    n_l = jnp.minimum(n_l_true, p1loc)
    n_r = jnp.minimum(n_r_true, res_hi - pos1)
    lc, lb, lk = _xdrop_all(codes, qcodes, subflat, K, p1loc - 1,
                            pos2 - 1, n_l, x_drop, -1)
    rc, rb, rk = _xdrop_all(codes, qcodes, subflat, K, p1loc, pos2,
                            n_r, x_drop, +1)
    # halo clamp reached while still consuming: exact result needs the
    # neighbour's bases (conservative: lc==n_l also matches scans that
    # terminated exactly at the clamp — the re-extension is identical)
    edge = (((lc >= n_l) & (n_l < n_l_true)).astype(jnp.int32)
            | (((rc >= n_r) & (n_r < n_r_true)).astype(jnp.int32) << 1))
    edge = jnp.where(live, edge, 0)

    idx = jnp.cumsum(live.astype(jnp.int32)) - 1
    n_keep = jnp.sum(live.astype(jnp.int32))
    dst = jnp.where(live & (idx < CAP), idx, CAP)
    out = jnp.zeros((OUT_ROWS, CAP), jnp.int32)
    rows = (pos1, k, lb, lk, rb, rk, lc, rc, edge)
    for r, v in enumerate(rows):
        out = out.at[r, dst].set(v, mode="drop")
    return (out[None], n_keep[None], overflow[None])


_PROG_CACHE: dict = {}


def _mesh_program(index: MeshShardedIndex, statics: tuple):
    key = (id(index.mesh), statics)
    prog = _PROG_CACHE.get(key)
    if prog is not None:
        return prog
    import jax
    from jax.sharding import PartitionSpec as P

    (CAP, K, nprobe, L, step, PCH, self_compare, same_strand) = statics
    body = functools.partial(
        _shard_probe_extend, CAP=CAP, K=K, nprobe=nprobe, L=L,
        step=step, PCH=PCH, self_compare=self_compare,
        same_strand=same_strand)
    specs = dict(
        mesh=index.mesh,
        in_specs=(P("shard"), P("shard"), P("shard"), P("shard"),
                  P("shard"), P("shard"),
                  P(), P(), P(), P(), P(), P()),
        out_specs=(P("shard"), P("shard"), P("shard")))
    try:
        sm = jax.shard_map(body, check_vma=False, **specs)
    except (AttributeError, TypeError):
        from jax.experimental.shard_map import shard_map
        sm = shard_map(body, check_rep=False, **specs)
    prog = jax.jit(sm)
    if len(_PROG_CACHE) > 8:
        _PROG_CACHE.clear()
    _PROG_CACHE[key] = prog
    return prog


# ---------------------------------------------------------------------------
# halo-gather re-extension (rare border hits)
# ---------------------------------------------------------------------------


def _scan_gathered(index, qcodes_np, subflat, K, p1, p2, n_true,
                   x_drop, step):
    """Sequential x-drop scan for ONE hit against windows gathered
    from the owning shards' device slices; the window doubles until
    the scan terminates inside it or the true bound is reached.
    Returns (consumed, best, kbest) — _xdrop_round's contract."""
    W = 2 * index.halo
    while True:
        n_win = min(n_true, W)
        if step > 0:
            w = index.gather_codes(p1, p1 + n_win).astype(np.int64)
            q = qcodes_np[p2: p2 + n_win].astype(np.int64)
        else:
            w = index.gather_codes(p1 - n_win + 1,
                                   p1 + 1)[::-1].astype(np.int64)
            q = qcodes_np[p2 - n_win + 1: p2 + 1][::-1].astype(np.int64)
        s = subflat[w * K + q]
        c = np.cumsum(s)
        m = np.maximum.accumulate(np.maximum(c, 0))
        bad = c < m - x_drop
        if bad.any():
            stop = int(np.argmax(bad)) + 1
            c = c[:stop]
            consumed = stop
            done = True
        else:
            consumed = n_win
            done = n_win >= n_true
        if done:
            if len(c) == 0:
                return 0, 0, -1
            best = int(c.max())
            kbest = int(np.argmax(c)) if best > 0 else -1
            return consumed, best, kbest
        W *= 2


# ---------------------------------------------------------------------------
# search orchestration
# ---------------------------------------------------------------------------


def supported(engine) -> bool:
    hp = engine.hp
    if engine.hit_mode != "simple" or hp.gf_extend != GFEX_XDROP:
        return False
    if hp.pos_filter or hp.min_matches >= 0:
        return False
    if engine.seed.type == "R" or engine.seed.rev_comp:
        return False
    if engine.pt.alive is not None:
        return False  # dynamic masking mutates the index mid-run
    sub = engine._sub
    if sub is None or sub.dtype != np.int64 \
            or np.abs(sub).max() >= (1 << 30):
        return False
    if max(len(engine.seq1), len(engine.seq2)) >= (1 << 31):
        return False
    return True


_INDEX_CACHE: dict = {}


def mesh_search_via_env(engine, n_shards: int, start: int = 0,
                        end: int = 0):
    """LASTZ_TPU_SHARDS=N routing: build (and cache per target/seed)
    the mesh-sharded index and search through it; returns None when
    the configuration is unsupported (standard tiers take over)."""
    if not supported(engine):
        return None
    import jax
    if len(jax.devices()) < n_shards:
        return None
    seed = engine.seed
    # sample target content into the key: id() alone is unsafe (a
    # multi-target run's next target can reuse a freed array's id and
    # silently serve the previous target's index)
    s1 = engine.seq1
    n2 = len(s1) // 2
    key = (id(s1), s1.tobytes()[:64].__hash__(),
           bytes(s1[n2:n2 + 64]).__hash__(),
           bytes(s1[-64:]).__hash__(), len(s1), seed.weight,
           seed.length, tuple(seed.bit_map), engine.pt.step,
           n_shards)
    index = _INDEX_CACHE.get(key)
    if index is None:
        from .. import stats as st_mod
        with st_mod.current.time("shard index build"):
            index = MeshShardedIndex(
                engine.seq1, engine.char_to_bits, seed,
                engine.pt.step, n_shards, engine._sub)
        if len(_INDEX_CACHE) > 4:
            _INDEX_CACHE.clear()
        _INDEX_CACHE[key] = index
    return sharded_mesh_search(engine, index, start, end)


def sharded_mesh_search(engine, index: MeshShardedIndex,
                        start: int = 0, end: int = 0):
    """Drop-in engine.search replacement over a sharded mesh index;
    returns bases_hit, or None when unsupported (scalar/batched paths
    take over).  Hit-for-hit identical to the scalar oracle."""
    if not supported(engine):
        return None
    import jax
    import jax.numpy as jnp

    from ..ops.hitgen import SEQ_PAD

    if end == 0:
        end = len(engine.seq2)
    seed = engine.seed
    L = seed.length
    if end - start < L:
        return 0
    hp = engine.hp
    x_drop = int(hp.x_drop)

    # query words (host, replicated to the mesh)
    codes2 = engine.char_to_bits[engine.seq2[start:end]]
    words, valid_np = _window_words(codes2, L, seed.bits_per_base)
    packed_np = seed.pack(words).astype(np.uint32)
    xors_np = _probe_xors(seed).astype(np.uint32)
    nprobe = len(xors_np)
    num_w = len(packed_np)

    subflat_np = np.ascontiguousarray(
        index.subsmall.reshape(-1).astype(np.int32))
    qc = np.zeros(len(engine.seq2) + 2 * SEQ_PAD, np.int8)
    qc[SEQ_PAD: SEQ_PAD + len(engine.seq2)] = \
        index.code_map[engine.seq2]

    PCH = 1 << 14
    CAP = int(os.environ.get("LASTZ_TPU_SHARD_CAP", str(1 << 15)))
    n_chunks = (num_w + PCH - 1) // PCH
    pad = n_chunks * PCH - num_w
    packed_j = jnp.asarray(np.concatenate(
        [packed_np, np.zeros(pad, np.uint32)]))
    valid_j = jnp.asarray(np.concatenate(
        [valid_np, np.zeros(pad, bool)]))
    xors_j = jnp.asarray(xors_np)
    subflat_j = jnp.asarray(subflat_np)
    qcodes_j = jnp.asarray(qc)
    qcodes_np_small = qc[SEQ_PAD: SEQ_PAD + len(engine.seq2)]

    statics = (CAP, index.K, nprobe, L, index.step, PCH,
               bool(engine.self_compare), bool(engine.same_strand))
    prog = _mesh_program(index, statics)
    band = engine.band_width if (engine.same_strand
                                 and engine.band_width > 0) else (1 << 30)

    from .. import stats as st_mod
    st = st_mod.current
    st.words_in_queries += int(valid_np.sum())

    de = engine.diag_end
    thresh_is_score = hp.hsp_threshold.t == "S"
    thresh = hp.hsp_threshold.s
    seq1 = engine.seq1
    seq2 = engine.seq2
    from ..core.scoring import SCORE_TYPE
    bases_hit = 0
    trip_pos = -1

    def run_ranges(chunk_lo):
        """Per-shard candidate buffers for window range [p_lo, p_hi)
        of one chunk, splitting on overflow."""
        parts = []
        ranges = [(0, PCH)]
        while ranges:
            p_lo, p_hi = ranges.pop(0)
            dyn = jnp.asarray(np.array(
                [chunk_lo, p_lo, p_hi, x_drop, len(seq1), len(seq2),
                 band], np.int32))
            with st.time("shard search"):
                out, n_keep, ovf = prog(
                    index.csr_start_d, index.csr_pos_d, index.adj_d,
                    index.codes_d, index.res_lo_d, index.res_hi_d,
                    packed_j, valid_j, xors_j, subflat_j, qcodes_j,
                    dyn)
                ovf_np = np.asarray(ovf)
            if ovf_np.any():
                mid = (p_lo + p_hi) // 2
                if mid == p_lo:
                    return None  # one position overflows CAP
                ranges[:0] = [(p_lo, mid), (mid, p_hi)]
                continue
            nk = np.asarray(n_keep)
            o = np.asarray(out)
            parts.append([o[d, :, : nk[d]]
                          for d in range(index.n_shards)])
        return parts

    for c in range(n_chunks):
        parts = run_ranges(c * PCH)
        if parts is None:
            return None
        bufs = [b for pr in parts for b in pr if b.shape[1]]
        if not bufs:
            continue
        cat = np.concatenate(bufs, axis=1)
        (pos1a, ka, lb, lk, rb, rk, lc, rc, edge) = \
            [cat[r].astype(np.int64) for r in range(OUT_ROWS)]
        # reference enumeration order: (pair index asc, pos1 desc);
        # shard position sets are disjoint so this is a total order
        order0 = np.lexsort((-pos1a, ka))
        (pos1a, ka, lb, lk, rb, rk, lc, rc, edge) = \
            [a[order0] for a in (pos1a, ka, lb, lk, rb, rk, lc, rc,
                                 edge)]
        pidx = ka // nprobe
        pos2a = c * PCH + L + pidx + start
        diag_a = pos1a - pos2a

        extent = pos1a + rc - diag_a
        grp = pidx  # window index: monotone with enumeration order

        # drop protocol: the simple-mode replay of
        # search/batched.py:493-625 over the merged stream.  Chains
        # free of border-clamped extents run the vectorized fixpoint;
        # chains containing one are walked sequentially with LAZY
        # halo-gather re-extension — only hits the protocol actually
        # accepts pay for a gathered re-scan, exactly the extensions
        # the scalar engine would have performed (hits dropped by the
        # chain never need their true extent: dropped hits contribute
        # nothing to the running max).
        H = len(pos1a)
        h_a = (diag_a & (DIAG_HASH_SIZE - 1)).astype(np.int64)
        order = np.argsort(h_a, kind="stable")
        hs = h_a[order]
        seg_start = np.ones(H, bool)
        seg_start[1:] = hs[1:] != hs[:-1]
        seg_first = np.nonzero(seg_start)[0]
        touched_h = hs[seg_first]
        seg_id = np.cumsum(seg_start) - 1
        lazy_seg = np.zeros(len(seg_first), bool)
        np.logical_or.at(lazy_seg, seg_id, edge[order] != 0)
        de0 = de[hs]
        de0 = np.where(de0 == HASH_INACTIVE, 0, de0)
        vec = ~lazy_seg[seg_id]
        extent_s = extent[order].copy()
        alive_s = np.zeros(H, bool)
        de_before_s = np.zeros(H, np.int64)
        if vec.any():
            res = _resolve_chains(
                np.where(vec, extent_s, MIN64),
                np.where(vec, (pos2a - L)[order], np.int64(1 << 60)),
                np.where(vec, de0, 0), seg_start)
            if res is None:
                return None
            alive_s[vec], de_before_s[vec] = (res[0][vec],
                                              res[1][vec])
        seg_end = np.concatenate([seg_first[1:], [H]])
        for s in np.nonzero(lazy_seg)[0]:
            cur = int(de0[seg_first[s]])
            for j in range(seg_first[s], seg_end[s]):
                i = int(order[j])
                ok = cur <= int(pos2a[i]) - L
                alive_s[j] = ok
                de_before_s[j] = cur
                if not ok:
                    continue
                p1 = int(pos1a[i])
                p2 = int(pos2a[i])
                d = int(diag_a[i])
                if edge[i] & 1:
                    n_true = p1 - max(d, 0)
                    lc[i], lb[i], lk[i] = _scan_gathered(
                        index, qcodes_np_small, subflat_np, index.K,
                        p1 - 1, p2 - 1, n_true, x_drop, -1)
                if edge[i] & 2:
                    n_true = max(
                        min(len(seq1), len(seq2) + d) - p1, 0)
                    rc[i], rb[i], rk[i] = _scan_gathered(
                        index, qcodes_np_small, subflat_np, index.K,
                        p1, p2, n_true, x_drop, +1)
                if edge[i]:
                    st.extra["shard halo-gathers"] = \
                        st.extra.get("shard halo-gathers", 0) + 1
                    edge[i] = 0
                    extent_s[j] = p1 + int(rc[i]) - d
                cur = max(cur, int(extent_s[j]))

        ext = dict(
            left_consumed=lc,
            left_score=np.where(lb > 0, lb, 0),
            left_start=np.where(lb > 0, pos1a - 1 - lk, pos1a),
            right_consumed=rc,
            right_score=np.where(rb > 0, rb, 0),
            right_stop=np.where(rb > 0, pos1a + rk + 1, pos1a))

        contrib = np.where(alive_s, extent_s, MIN64)
        seg_max = np.maximum.reduceat(
            np.maximum(contrib, de0), seg_first)
        de[touched_h] = np.maximum(de[touched_h], seg_max)
        de[touched_h] = np.where(
            de[touched_h] == HASH_INACTIVE, 0, de[touched_h])
        alive = np.zeros(H, bool)
        alive[order] = alive_s
        de_before = np.zeros(H, np.int64)
        de_before[order] = de_before_s

        stop1_blk = np.maximum(de_before + diag_a, 0)
        bind = alive & (lc > pos1a - stop1_blk)
        sim_raw = ext["left_score"] + ext["right_score"]
        if thresh_is_score and thresh > 0:
            cand_mask = alive & (bind | (sim_raw >= thresh))
        else:
            cand_mask = alive

        st.raw_seed_hits += H
        st.hash_dropped_hits += int((~alive).sum())
        st.ungapped_extensions += int(alive.sum())

        for i in np.nonzero(cand_mask)[0]:
            g = int(grp[i])
            if trip_pos >= 0 and g > trip_pos:
                engine.limit_exceeded = True
                if engine.on_limit_exceeded is not None:
                    engine.on_limit_exceeded()
                return bases_hit
            pos1 = int(pos1a[i])
            pos2 = int(pos2a[i])
            diag = int(diag_a[i])
            if bind[i]:
                hh = int(h_a[i])
                saved = int(de[hh])
                saved_da = int(engine.diag_actual[hh])
                de[hh] = int(de_before[i])
                engine._unblocked_left = False
                r = engine._xdrop_extend(pos1, pos2, L)
                de[hh] = max(saved, int(de[hh]))
                engine.diag_actual[hh] = saved_da
                if r is None:
                    continue
                bases_hit += engine._report(*r)
            else:
                similarity = int(sim_raw[i])
                new_pos1 = int(ext["right_stop"][i])
                new_pos2 = new_pos1 - diag
                new_length = new_pos1 - int(ext["left_start"][i])
                adjust = False
                if hp.entropic_hsp:
                    if thresh_is_score:
                        adjust = (similarity >= hp.hsp_zero_threshold
                                  and similarity <= 3 * thresh)
                    elif similarity > 0:
                        anch = engine.anchors
                        adjust = (anch is not None and len(anch) > 0
                                  and similarity >= anch.low_score)
                if adjust:
                    q = entropy(
                        seq1[new_pos1 - new_length: new_pos1],
                        seq2[new_pos2 - new_length: new_pos2])
                    similarity = (similarity * q if SCORE_TYPE == "D"
                                  else int(similarity * q))
                if thresh_is_score and similarity < thresh:
                    continue
                bases_hit += engine._report(new_pos1, new_pos2,
                                            new_length, similarity)
                st.hsps += 1
            if (engine.search_limit > 0 and engine.search_to_go < 0
                    and trip_pos < 0):
                trip_pos = g
        if trip_pos >= 0 and c < n_chunks - 1:
            engine.limit_exceeded = True
            if engine.on_limit_exceeded is not None:
                engine.on_limit_exceeded()
            return bases_hit

    if trip_pos >= 0:
        engine.limit_exceeded = True
        if engine.on_limit_exceeded is not None:
            engine.on_limit_exceeded()
    return bases_hit

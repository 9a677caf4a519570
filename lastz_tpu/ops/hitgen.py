"""Device-side seed-hit list generation: the full SEED->HSP stage of
the reference (private_hit_search + find_table_matches + the simple
hit processor + x-drop extension, seed_search.c:464-810,1056,2528)
re-expressed as a handful of fixed-shape jitted device programs, so
the raw candidate hit list (millions of (pos1,pos2) pairs on a
chromosome-scale run) NEVER crosses to the host.  Only the compacted,
threshold-surviving HSP candidates (thousands) are fetched.

Program 1 (pack):    query 2-bit codes -> packed seed words + validity
                     (device mirror of index/postable._window_words +
                     Seed.pack).
Program 2 (counts):  CSR probe counts for a query-position chunk,
                     expanded over the transition-probe set, and their
                     exclusive prefix sum.  The host fetches ONE scalar
                     (the chunk's hit total) to plan launch budgets.
Program 3 (hits):    a fixed-budget slice of the candidate hit list:
                     expansion (searchsorted over the pair prefix sum,
                     descending CSR order = the reference's last/prev
                     enumeration), self/band filters, batched
                     two-sided unblocked x-drop along each diagonal,
                     the 64K diagonal-hash drop protocol as a
                     sort-by-hash + segmented-prefix-max Jacobi
                     fixpoint (identical math to the host replay in
                     search/batched.py:143-183), threshold pre-filter,
                     and in-order compaction of the survivors.

The diagonal-extent state (65536 int32) lives on device and chains
through consecutive launches, exactly like the engine's diag_end
array chains through chunks in the host replay.

Everything is int32: the device path is gated (by search/device_hits)
to sequences < 2^31 and |scores| < 2^31, matching the reference's own
32-bit score arithmetic.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

DIAG_HASH_SIZE = 65536
MIN32 = jnp.int32(-(1 << 30))

# default launch geometry (overridable; passed as static jit args)
HIT_BUDGET = 1 << 22      # candidate hits per launch
OUT_CAP = 1 << 18         # max survivors per launch
XD_SLICE = 1 << 15        # hits per x-drop sub-batch
XD_CHUNK = 256            # cells per x-drop continuation round
XD_FIRST = 64             # cells in the universal first pass
# sentinel padding around device sequences (past any x-drop round's
# reach beyond either end, so row slices never clamp)
SEQ_PAD = 20608
MAX_RESOLVE_ROUNDS = 64


# ---------------------------------------------------------------------------
# Program 1: query word packing
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("bit_map", "length",
                                             "bits_per"))
def pack_query_words(codes, bit_map: tuple, length: int, bits_per: int):
    """codes: (n,) int8 2-bit codes (-1 invalid).  Returns
    (packed uint32 (n-L+1,), valid bool (n-L+1,)); window k ENDS at
    base index length-1+k (index/postable._window_words layout)."""
    n = codes.shape[0]
    num = n - length + 1
    c = codes.astype(jnp.int32)
    bad = (c < 0).astype(jnp.int32)
    cb = jnp.cumsum(bad)
    # windows with zero invalid codes
    head = jax.lax.dynamic_slice_in_dim(cb, length - 1, num)
    tail = jnp.concatenate([jnp.zeros(1, cb.dtype), cb[: num - 1]])
    valid = (head - tail) == 0
    packed = jnp.zeros((num,), jnp.uint32)
    for src, dst in bit_map:
        base_ix = length - 1 - src // bits_per
        bit = src % bits_per
        seg = jax.lax.dynamic_slice_in_dim(c, base_ix, num)
        packed = packed | (((seg >> bit) & 1).astype(jnp.uint32)
                           << dst)
    return packed, valid


# ---------------------------------------------------------------------------
# Program 2: per-chunk probe counts + prefix sum
# ---------------------------------------------------------------------------


@jax.jit
def pair_counts(packed, valid, xors, csr_start):
    """packed/valid: (P,) padded query-word chunk; xors: (nprobe,)
    uint32.  Returns (cum (P*nprobe+1,) int32 exclusive prefix sum of
    per-(position,probe)-pair candidate counts, ends (P*nprobe,) CSR
    end offsets per pair, total scalar)."""
    words = (packed[:, None] ^ xors[None, :]).ravel()
    nw = csr_start.shape[0] - 1
    w = jnp.minimum(words, nw - 1).astype(jnp.int32)
    ends = csr_start[w + 1]
    cnt = (ends - csr_start[w]).astype(jnp.int32)
    cnt = jnp.where(jnp.repeat(valid, xors.shape[0]), cnt, 0)
    cum = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(cnt)])
    return cum, ends, cum[-1]


@functools.partial(jax.jit, static_argnames=("total_pad",))
def expand_chunk(cum, total_pad: int):
    """Pair index per hit for a whole chunk, via one scatter-add of
    pair-start markers + a prefix sum (replaces a per-launch
    searchsorted over the 10M+-entry pair prefix array; empty pairs
    collapse onto the next start and the cumsum picks the last pair
    whose start <= the hit index — i.e. the containing pair)."""
    seg = jnp.zeros((total_pad,), jnp.int32).at[cum[:-1]].add(
        1, mode="drop")
    return jnp.cumsum(seg) - 1


# ---------------------------------------------------------------------------
# x-drop scan over all hits (sliced internally; one launch)
# ---------------------------------------------------------------------------


def _rows(seqp, start, step, C):
    """(Hs, C) codes where row[:, j] = seq[start + step*j], gathered
    as per-row contiguous dynamic slices from a SEQ_PAD-padded
    sequence (the padding keeps every slice in bounds, so no clamping
    can shift valid cells; out-of-range cells read sentinel 0 and are
    masked by the caller's validity test)."""
    if step > 0:
        s = start + SEQ_PAD
        rows = jax.vmap(
            lambda i: jax.lax.dynamic_slice(seqp, (i,), (C,)))(s)
    else:
        s = start - (C - 1) + SEQ_PAD
        rows = jax.vmap(
            lambda i: jax.lax.dynamic_slice(seqp, (i,), (C,)))(s)
        rows = rows[:, ::-1]
    return rows.astype(jnp.int32)


def _xdrop_round(seq1p, seq2p, subflat, K, p1, p2, n, x_drop, step,
                 chunk, st):
    """One chunk-sized scan round resuming per-lane carried state
    (identical continuation math to ops/xdrop_batch._jax_fused_impl)."""
    base, cum, runmax, best, kbest, consumed, live = st
    offs = jnp.arange(chunk, dtype=jnp.int32)
    ch1 = _rows(seq1p, p1 + step * base, step, chunk)
    ch2 = _rows(seq2p, p2 + step * base, step, chunk)
    rem = n - base
    valid = (offs[None, :] < rem[:, None]) & live[:, None]
    sc = jnp.where(valid, subflat[ch1 * K + ch2], 0)
    c = cum[:, None] + jnp.cumsum(sc, axis=1)
    m = jnp.maximum(jax.lax.cummax(c, axis=1), runmax[:, None])
    bad = (c < jnp.maximum(m, 0) - x_drop) & valid
    any_bad = jnp.any(bad, axis=1)
    first_bad = jnp.where(
        any_bad, jnp.argmax(bad, axis=1).astype(jnp.int32), chunk)
    take = jnp.minimum(jnp.minimum(first_bad + 1, rem), chunk)
    take = jnp.maximum(take, 0)
    inpref = (offs[None, :] < take[:, None]) & live[:, None]
    cc = jnp.where(inpref, c, MIN32)
    chunk_best = jnp.max(cc, axis=1)
    chunk_arg = jnp.argmax(cc, axis=1).astype(jnp.int32)
    better = live & (chunk_best > best)
    best = jnp.where(better, chunk_best, best)
    kbest = jnp.where(better, base + chunk_arg, kbest)
    consumed = jnp.where(live, base + take, consumed)
    last = jnp.maximum(take - 1, 0)
    cum2 = jnp.take_along_axis(c, last[:, None], axis=1)[:, 0]
    runmax2 = jnp.take_along_axis(m, last[:, None], axis=1)[:, 0]
    cum = jnp.where(live, cum2, cum)
    runmax = jnp.where(live, runmax2, runmax)
    base = jnp.where(live, base + chunk, base)
    live = live & (~any_bad) & (rem > chunk)
    return base, cum, runmax, best, kbest, consumed, live


def _xdrop_all(seq1p, seq2p, subflat, K, p1, p2, n, x_drop, step):
    """Two-phase all-H scan.

    Phase A: ONE fixed XD_FIRST-cell round over every hit (sliced to
    bound memory).  Random background hits — the overwhelming
    majority — die inside it, so the bulk of the work touches
    XD_FIRST cells per hit instead of XD_CHUNK.

    Phase B: survivors are COMPACTED into XD_SLICE-wide waves and
    only those lanes run the multi-round continuation scan; dead
    lanes never occupy gather bandwidth again.
    """
    H = p1.shape[0]
    sl = min(XD_SLICE, H)
    ns = H // sl

    def one(args):
        p1s, p2s, nss = args
        z = jnp.zeros((sl,), jnp.int32)
        st = (z, z, z, z, jnp.full((sl,), -1, jnp.int32), z, nss > 0)
        return _xdrop_round(seq1p, seq2p, subflat, K, p1s, p2s, nss,
                            x_drop, step, XD_FIRST, st)

    sh = (ns, sl)
    stA = jax.lax.map(one, (p1.reshape(sh), p2.reshape(sh),
                            n.reshape(sh)))
    state = tuple(a.reshape(H) for a in stA)
    return _xdrop_waves(seq1p, seq2p, subflat, K, p1, p2, n, x_drop,
                        step, state)


def _xdrop_waves(seq1p, seq2p, subflat, K, p1, p2, n, x_drop, step,
                 state):
    """Wave-compacted continuation of carried scan states: lanes with
    state[-1] (the live/continue mask) set are packed into XD_SLICE
    waves and run the multi-round scan to completion."""
    base, cum, runmax, best, kbest, consumed, live = state
    H = p1.shape[0]
    sl = min(XD_SLICE, H)
    HC = sl
    iota_h = jnp.arange(H, dtype=jnp.int32)

    def wave_cond(st):
        return jnp.any(st[6])

    def wave_body(st):
        base, cum, runmax, best, kbest, consumed, mask = st
        idx = jnp.cumsum(mask.astype(jnp.int32)) - 1
        sel = mask & (idx < HC)
        slot = jnp.where(sel, idx, HC)
        # src[j] = hit index occupying wave lane j; H = empty lane
        src = jnp.full((HC + 1,), H, jnp.int32).at[slot].set(
            iota_h, mode="drop")[:HC]
        vslot = src < H
        srcc = jnp.minimum(src, H - 1)

        def g(a, fill):
            return jnp.where(vslot, a[srcc], fill)

        st_s = (g(base, 0), g(cum, 0), g(runmax, 0), g(best, 0),
                g(kbest, -1), g(consumed, 0), vslot)
        p1s = g(p1, 0)
        p2s = g(p2, 0)
        ns2 = g(n, 0)

        def rcond(s):
            return jnp.any(s[6])

        def rbody(s):
            return _xdrop_round(seq1p, seq2p, subflat, K, p1s, p2s,
                                ns2, x_drop, step, XD_CHUNK, s)

        st_s = jax.lax.while_loop(rcond, rbody, st_s)
        b2, c2, r2, be2, k2, co2, _ = st_s
        # empty lanes carry src == H and fall off the scatter
        upd = lambda full, s: full.at[src].set(s, mode="drop")
        return (upd(base, b2), upd(cum, c2), upd(runmax, r2),
                upd(best, be2), upd(kbest, k2), upd(consumed, co2),
                mask & ~sel)

    st = jax.lax.while_loop(
        wave_cond, wave_body,
        (base, cum, runmax, best, kbest, consumed, live))
    _, _, _, best, kbest, consumed, _ = st
    kbest = jnp.where(best > 0, kbest, -1)
    return consumed, best, kbest


# ---------------------------------------------------------------------------
# diagonal-hash chain resolution (sorted segmented fixpoint)
# ---------------------------------------------------------------------------


def _seg_cummax_exclusive(x, seg_id):
    """Exclusive prefix max within equal-seg_id runs (log-doubling;
    device mirror of search/batched.py:_seg_cummax_exclusive)."""
    n = x.shape[0]
    out = jnp.concatenate([jnp.full(1, MIN32), x[:-1]])
    sid_prev = jnp.concatenate([jnp.full(1, -1, seg_id.dtype),
                                seg_id[:-1]])
    out = jnp.where(sid_prev == seg_id, out, MIN32)
    shift = 1
    while shift < n:
        cand = jnp.concatenate([jnp.full(shift, MIN32), out[:-shift]])
        ok = jnp.concatenate([
            jnp.zeros(shift, bool),
            seg_id[shift:] == seg_id[:-shift]])
        out = jnp.maximum(out, jnp.where(ok, cand, MIN32))
        shift *= 2
    return out


RESOLVE_CHAIN_CAP = 16384  # longest chain walked on device


def _resolve_chains_dev(extent_s, pos2mL_s, de0_s, seg_start, live_s):
    """Exact drop-protocol scan over hash-sorted hits.

    The per-chain recurrence (process_for_simple_hit,
    seed_search.c:1056-1198) starts from a KNOWN de0 — there is no
    cross-chain feedback — so every chain is a plain sequential scan.
    Chains are keyed by the 64K diagonal hash, so there are at most
    65537 of them per launch: all chains advance in LOCKSTEP, one
    chain position per step, over (num-chains,)-sized state.  Work is
    O(max_chain_len * 64K) instead of the Jacobi fixpoint's
    O(depth * H * log H).

    seg_start: bool array marking the first element of each chain.
    Returns (alive_s, de_before_s, converged); converged is False
    only when a chain exceeds RESOLVE_CHAIN_CAP (host replay takes
    over, mirroring the fixpoint-cap semantics)."""
    H = extent_s.shape[0]
    NCH = DIAG_HASH_SIZE + 1
    iota = jnp.arange(H, dtype=jnp.int32)
    seg_id = jnp.cumsum(seg_start.astype(jnp.int32)) - 1
    # chain start offsets and lengths, padded to NCH with empties
    starts = jnp.full((NCH,), H, jnp.int32).at[seg_id].min(
        iota, mode="drop")
    lens = jnp.zeros((NCH,), jnp.int32).at[seg_id].add(
        1, mode="drop")
    # the dead-hit tail sorts into one sentinel chain; skip it
    lens = jnp.where(live_s[jnp.minimum(starts, H - 1)], lens, 0)
    max_len = jnp.max(lens)
    cur0 = de0_s[jnp.minimum(starts, H - 1)]

    def cond(st):
        r, cur, alive, de_before = st
        # past the cap the launch is unconverged and discarded anyway
        # (host replay takes over) — bail instead of walking a
        # 10^4-hit chain to its end on device
        return r < jnp.minimum(max_len, RESOLVE_CHAIN_CAP + 1)

    def body(st):
        r, cur, alive, de_before = st
        idx = starts + r
        act = r < lens
        safe = jnp.minimum(idx, H - 1)
        t = pos2mL_s[safe]
        e = extent_s[safe]
        lv = live_s[safe]
        ok = cur <= t
        de_before = de_before.at[jnp.where(act, idx, H)].set(
            cur, mode="drop")
        alive = alive.at[jnp.where(act, idx, H)].set(
            ok, mode="drop")
        cur = jnp.where(act & lv & ok, jnp.maximum(cur, e), cur)
        return r + 1, cur, alive, de_before

    alive0 = jnp.ones((H,), bool)
    deb0 = jnp.zeros((H,), jnp.int32)
    _, _, alive, de_before = jax.lax.while_loop(
        cond, body, (jnp.int32(0), cur0, alive0, deb0))
    return alive, de_before, max_len <= RESOLVE_CHAIN_CAP


HASH_INACTIVE = jnp.int32(-1)


def _resolve_chains_recover_dev(extent_s, start2_s, diag_s, de0_s,
                                da0_s, seg_start, live_s):
    """Recover-mode chain scan (process_for_recoverable_hit,
    seed_search.c:1221-1420; device mirror of
    search/batched._resolve_chains_recover): a hit whose hashed
    diagonal was extended past it is dropped only when diagActual
    matches its TRUE diagonal; a collision with a different diagonal
    is accepted with an unblocked left extension (de_before = 0).

    de0_s/da0_s: per-sorted-hit raw chain-head states (HASH_INACTIVE
    kept distinct).  Returns (alive_s, de_before_s, fin_de, fin_da,
    chain_valid, chain_hash_pos, converged); fin_*/chain_* are
    per-chain (NCH,) end-of-launch values for the scatter-back."""
    H = extent_s.shape[0]
    NCH = DIAG_HASH_SIZE + 1
    iota = jnp.arange(H, dtype=jnp.int32)
    seg_id = jnp.cumsum(seg_start.astype(jnp.int32)) - 1
    starts = jnp.full((NCH,), H, jnp.int32).at[seg_id].min(
        iota, mode="drop")
    lens = jnp.zeros((NCH,), jnp.int32).at[seg_id].add(
        1, mode="drop")
    safe_start = jnp.minimum(starts, H - 1)
    lens = jnp.where(live_s[safe_start], lens, 0)
    max_len = jnp.max(lens)
    cur0 = de0_s[safe_start]
    curd0 = da0_s[safe_start]

    def cond(st):
        return st[0] < jnp.minimum(max_len, RESOLVE_CHAIN_CAP + 1)

    def body(st):
        r, cur, curd, alive, de_before = st
        idx = starts + r
        act = r < lens
        safe = jnp.minimum(idx, H - 1)
        t = start2_s[safe]
        e = extent_s[safe]
        dg = diag_s[safe]
        lv = live_s[safe]
        inactive = cur == HASH_INACTIVE
        c0 = jnp.where(inactive, 0, cur)
        d0 = jnp.where(inactive, dg, curd)
        covered = (c0 > t) & jnp.logical_not(inactive)
        drop = covered & (d0 == dg)
        unb = covered & (d0 != dg)
        ok = jnp.logical_not(drop)
        w = jnp.where(act, idx, H)
        de_before = de_before.at[w].set(
            jnp.where(unb, 0, c0), mode="drop")
        alive = alive.at[w].set(ok, mode="drop")
        upd = act & lv & ok & (e > c0)
        cur = jnp.where(act & lv, jnp.where(upd, e, c0), cur)
        curd = jnp.where(act & lv, jnp.where(upd, dg, d0), curd)
        return r + 1, cur, curd, alive, de_before

    alive0 = jnp.ones((H,), bool)
    deb0 = jnp.zeros((H,), jnp.int32)
    _, fin_de, fin_da, alive, de_before = jax.lax.while_loop(
        cond, body, (jnp.int32(0), cur0, curd0, alive0, deb0))
    return (alive, de_before, fin_de, fin_da, lens > 0,
            max_len <= RESOLVE_CHAIN_CAP)


# ---------------------------------------------------------------------------
# Program 3: one fixed-budget hit launch
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("no_extend", "self_compare", "same_strand",
                     "use_thresh", "has_alive", "K", "nprobe",
                     "H", "out_cap",
                     "x_drop", "recover", "has_resolve"))
def hit_launch(seq1p, seq2p, subflat, csr_pos, alive_tab,
               cum, ends, karr, de, da,
               hit_base, total, chunk_lo,
               adj_start, step, seed_len, thresh, band,
               len1, len2,
               csr_resolve=None, q_resolve=None, budgets=None,
               *, x_drop: int, no_extend: bool, self_compare: bool,
               same_strand: bool, use_thresh: bool, has_alive: bool,
               K: int, nprobe: int, recover: bool = False,
               has_resolve: bool = False,
               H: int = HIT_BUDGET, out_cap: int = OUT_CAP):
    """One budgeted slice [hit_base, hit_base+H) of the chunk's
    candidate hits.  seq1p/seq2p are SEQ_PAD-padded compact codes;
    karr is this slice's precomputed pair index per hit
    (expand_chunk).  Returns (de', da', out (9, out_cap) int32,
    scalars (6,) int32).  `da` is the diagActual state; it is only
    consulted/advanced when `recover` (--recoverseeds,
    process_for_recoverable_hit semantics).

    out rows: pos1, pos2, qidx (absolute query window index), lscore,
    lstart, rscore, rstop, de_before, bind.
    scalars: n_keep, n_live, n_dropped, n_alive, converged, 0.
    """
    i = jnp.arange(H, dtype=jnp.int32)
    abs_i = hit_base + i
    live = abs_i < total

    # expansion: pair index k, then the (descending) CSR entry
    k = jnp.clip(karr, 0, ends.shape[0] - 1)
    within = abs_i - cum[k]
    pidx = k // nprobe
    csr_idx = jnp.clip(ends[k] - 1 - within, 0, csr_pos.shape[0] - 1)
    pos1 = adj_start + step * csr_pos[csr_idx]
    pos2 = chunk_lo + seed_len + pidx
    if has_resolve:
        # overweight seeds: verify the demoted (resolving) bits of
        # each query window against the index's packed per-entry
        # words, within the probe's leftover transition budget
        # (seed_search.c:878-980; search/batched.py:185-197)
        xor = (csr_resolve[csr_idx]
               ^ q_resolve[jnp.clip(pidx, 0,
                                    q_resolve.shape[0] - 1)])
        x = xor.astype(jnp.uint32)
        x = x - ((x >> 1) & jnp.uint32(0x55555555))
        x = (x & jnp.uint32(0x33333333)) \
            + ((x >> 2) & jnp.uint32(0x33333333))
        mism = ((((x + (x >> 4)) & jnp.uint32(0x0F0F0F0F))
                 * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)
        live = live & (mism <= budgets[k % nprobe])
    if has_alive:
        live = live & (alive_tab[csr_idx] != 0)
    if self_compare:
        if same_strand:
            live = live & (pos1 < pos2)
        else:
            p1s = pos1 - seed_len
            p2s = (len2 - 1) - (pos2 - seed_len)
            live = live & (p1s < p2s)
    if same_strand:
        live = live & ((pos2 - pos1) <= band)
    diag = pos1 - pos2
    h = (diag & (DIAG_HASH_SIZE - 1)).astype(jnp.int32)

    if no_extend:
        extent = pos2
        lscore = jnp.zeros((H,), jnp.int32)
        lstart = pos1
        rscore = jnp.zeros((H,), jnp.int32)
        rstop = pos1
        lc = jnp.zeros((H,), jnp.int32)
    else:
        # left: from pos1-1 down to max(diag, 0)
        n_l = jnp.where(live, pos1 - jnp.maximum(diag, 0), 0)
        # right: from pos1 to min(len1, len2+diag)
        stop1r = jnp.minimum(len1, len2 + diag)
        n_r = jnp.where(live, jnp.maximum(stop1r - pos1, 0), 0)
        lc, lb, lk = _xdrop_all(seq1p, seq2p, subflat, K,
                                pos1 - 1, pos2 - 1, n_l, x_drop, -1)
        rc, rb, rk = _xdrop_all(seq1p, seq2p, subflat, K,
                                pos1, pos2, n_r, x_drop, +1)
        lscore = jnp.maximum(lb, 0)
        lstart = jnp.where(lb > 0, pos1 - 1 - lk, pos1)
        rscore = jnp.maximum(rb, 0)
        rstop = jnp.where(rb > 0, pos1 + rk + 1, pos1)
        extent = pos1 + rc - diag

    # ---- hash-chain resolution over the whole launch ----
    key = jnp.where(live, h, DIAG_HASH_SIZE)  # dead hits: own segment
    order = jnp.argsort(key, stable=True)
    key_s = key[order]
    starts = jnp.concatenate([
        jnp.ones(1, bool), key_s[1:] != key_s[:-1]])
    if recover:
        de0 = de[jnp.clip(key_s, 0, DIAG_HASH_SIZE - 1)]
        da0 = da[jnp.clip(key_s, 0, DIAG_HASH_SIZE - 1)]
        (alive_s, de_before_s, fin_de, fin_da, chain_valid,
         converged) = _resolve_chains_recover_dev(
            extent[order], (pos2 - seed_len)[order], diag[order],
            de0, da0, starts, live[order])
        inv = jnp.zeros((H,), jnp.int32).at[order].set(i)
        alive = alive_s[inv] & live
        de_before = de_before_s[inv]
        # per-chain end-of-launch scatter-back (the sentinel chain
        # and empty chains drop out of range)
        seg_id_all = jnp.cumsum(starts.astype(jnp.int32)) - 1
        chain_hash = jnp.full(
            (DIAG_HASH_SIZE + 1,), DIAG_HASH_SIZE,
            jnp.int32).at[seg_id_all].min(key_s, mode="drop")
        tgt = jnp.where(chain_valid, chain_hash, DIAG_HASH_SIZE)
        de_adv = de.at[tgt].set(fin_de, mode="drop")
        da_adv = da.at[tgt].set(fin_da, mode="drop")
    else:
        de0 = de[jnp.clip(key_s, 0, DIAG_HASH_SIZE - 1)]
        de0 = jnp.maximum(de0, 0)  # HASH_INACTIVE (-1) activates to 0
        alive_s, de_before_s, converged = _resolve_chains_dev(
            extent[order], (pos2 - seed_len)[order], de0, starts,
            live[order])
        inv = jnp.zeros((H,), jnp.int32).at[order].set(i)
        alive = alive_s[inv] & live
        de_before = de_before_s[inv]

        # advance the diagonal-extent state (joined below, only when
        # the output did not overflow — an overflowing launch is
        # discarded and re-run split, so its extents must not leak
        # into `de`)
        de_adv = de.at[jnp.where(live, h, 0)].max(
            jnp.where(alive, extent, jnp.int32(-1)))
        da_adv = da

    # candidate selection (host replay: search/batched.py:304-316)
    if no_extend:
        cand = alive
        bind = jnp.zeros((H,), bool)
    else:
        stop1_blk = jnp.maximum(de_before + diag, 0)
        bind = alive & (lc > pos1 - stop1_blk)
        if use_thresh:
            sim_raw = lscore + rscore
            cand = alive & (bind | (sim_raw >= thresh))
        else:
            cand = alive

    # in-order compaction
    idx = jnp.cumsum(cand.astype(jnp.int32)) - 1
    n_keep = jnp.sum(cand.astype(jnp.int32))
    dst = jnp.where(cand & (idx < out_cap), idx, out_cap)
    out = jnp.zeros((9, out_cap), jnp.int32)
    rows = (pos1, pos2, pidx + chunk_lo, lscore,
            lstart, rscore, rstop, de_before,
            bind.astype(jnp.int32))
    for r, v in enumerate(rows):
        out = out.at[r, dst].set(v, mode="drop")
    # an overflowing OR unconverged launch is discarded and re-run as
    # two half-ranges, so its state advance must not leak
    discard = (n_keep > out_cap) | jnp.logical_not(converged)
    de_new = jnp.where(discard, de, de_adv)
    da_new = jnp.where(discard, da, da_adv)
    n_live = jnp.sum(live.astype(jnp.int32))
    n_alive = jnp.sum(alive.astype(jnp.int32))
    scalars = jnp.stack([
        n_keep, n_live, n_live - n_alive, n_alive,
        converged.astype(jnp.int32), jnp.int32(0)])
    return de_new, da_new, out, scalars

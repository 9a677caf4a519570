"""Exact batched one-sided y-drop DP with traceback (device path).

This is the production gapped-extension kernel: a bit-exact
re-expression of the reference's ydrop_one_sided_align row sweep
(gapped_extend.c:3388-3860) as a fixed-width JAX program that runs
batched on the accelerator (and on CPU for tests).  For every anchor it reproduces
the host engine's (align/ydrop.py one_sided) results EXACTLY for the
unconstrained case (no L/R bounding segments, no active-segment
masking): same scores, same end cells, same per-cell traceback link
bytes, same y-drop band walk (LY/RY), same truncation semantics.

The reference's inner loop is sequential within a row: the insertion
state I is a left-to-right chain, and the y-drop prune threshold
(best_score) can rise mid-row.  Both are recovered with fixed-shape
parallel ops:

  * the I chain is a "decayed prefix max with resets": each unpruned
    substitution cell seeds C-gapOpen, gap cells decay by gapExtend,
    pruned cells reset to -inf.  In a decay-compensated domain this is
    a log-shift scan of the operator
        (s1,r1) x (s2,r2) = (s2 if r2 else max(s1,s2), r1|r2).
  * each row runs TWO passes (docs/two_pass_exact_row.md): pass 1's
    RESET-FREE decayed chain resolves every decision (prune, branch,
    best) exactly — contributions crossing a true reset provably stay
    below the y-drop cut — and pass 2's single reset scan, with the
    now-known pruned set, recovers the exact I values the link bytes'
    open-vs-extend ties need.  No fixpoint iteration, no unconverged
    fallback.

Design decisions:
  * lanes are ABSOLUTE query columns within a per-chunk window (lane l
    <-> column b_off + l), so a DP row is pure elementwise work with
    static single-lane shifts — no per-row rolls, no gathers over the
    band;
  * substitution scores come from a COMPACT ALPHABET (the <=16
    distinct byte codes actually present in the two sequences) via a
    static select chain, not a 256x256 table gather;
  * extensions of unbounded length run as CHUNKS of `rows` DP rows per
    launch over a `lanes`-wide window; a chunk ends when the row
    budget or the window is exhausted and the glue relaunches the
    unfinished lanes with a re-anchored window, collecting one
    traceback-links buffer (plus its column origin) per chunk.  The
    host traceback walks the chunk list backwards.

Per-anchor outputs: best score + end cell (+ boundary variant for
--noytrim), rows used, band extent, status flags, and per-chunk
traceback link bytes from which the host recovers the edit script
with the reference's gap-extension-preferring walk
(gapped_extend.c:3845-3860).  Anchors whose band outgrows the static
window report OVERFLOW and are re-extended by the host engine
(exactness is never sacrificed).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.scoring import NEG_INFINITY_SCORE

C_FROM_C = 0
C_FROM_I = 1
C_FROM_D = 2
I_EXTEND = 4
D_EXTEND = 8
CID_BITS = 3

NEG = np.int32(NEG_INFINITY_SCORE)  # -1932735283, reference negInfinity
SENT32 = np.int32(-(1 << 30))       # "no candidate" sentinel (row maxima)
# i-chain identity: below every reachable value (min real value is
# negInfinity + veryBadScore - gapOE ~ -2.0401e9) yet far enough from
# INT32_MIN that the decay compensation (<= (lanes+1)*gapE, the glue
# caps gapE) never wraps; the reference itself computes 32-bit scores
ISENT = np.int32(-2_080_000_000)
MAX_COMP_GAP_E = 60_000             # glue-enforced cap on gapExtend

# status flags
ST_OK = 0
ST_WIDTH_OVERFLOW = 1   # band wider than the static window
ST_UNCONVERGED = 4      # retired (two-pass rows have no fixpoint);
                        # kept so old status values keep decoding
ST_TRUNCATED = 8        # traceback arena exhausted (reference semantic)

STATE_KEYS = ("CC", "DD", "LY", "RY", "row", "best", "end1", "end2",
              "bscore", "bflag", "tbp", "rows_used", "maxRY",
              "status", "done")


def _shift_right(x, n, fill):
    """x shifted right by n along the last axis, filling with `fill`."""
    pad = jnp.full(x.shape[:-1] + (n,), fill, x.dtype)
    return jnp.concatenate([pad, x[..., :-n]], axis=-1)


def _prefix_max(x, fill):
    """Inclusive prefix max along the last axis (log-shift form)."""
    W = x.shape[-1]
    shift = 1
    while shift < W:
        x = jnp.maximum(x, _shift_right(x, shift, fill))
        shift *= 2
    return x


def _prefix_max_reset(s, r):
    """Inclusive scan of the decayed-max-with-resets operator
    (s1,r1) x (s2,r2) = (s2 if r2 else max(s1,s2), r1|r2) in
    Hillis-Steele log-shift form."""
    W = s.shape[-1]
    shift = 1
    while shift < W:
        s_sh = _shift_right(s, shift, ISENT)
        r_sh = _shift_right(r, shift, False)
        s = jnp.where(r, s, jnp.maximum(s_sh, s))
        r = r | r_sh
        shift *= 2
    return s


def _i_chain(c_sub, reset, is_seed, l_iota, gap_e, gap_oe):
    """Insertion-state chain values entering each lane, plus the
    inclusive scan for the exit value.  Seeds are unpruned
    substitution cells (C-gapOE); gap-branch cells decay the chain by
    gapE without reseeding (no back-to-back gaps); pruned cells (and
    the left edge of the feasible window) reset the chain to
    negInfinity exactly (host ydrop.py:443,469,516-520).  Computed in
    a decay-compensated int32 domain (value + (l+1)*gapE); see the
    ISENT note above for why this cannot wrap."""
    comp = (l_iota + 1) * gap_e
    elem_s = jnp.where(
        reset, NEG + comp,
        jnp.where(is_seed, c_sub - gap_oe + comp, ISENT))
    s_scan = _prefix_max_reset(elem_s, reset)
    s_excl = _shift_right(s_scan, 1, NEG)
    i_vec = s_excl - l_iota * gap_e
    return i_vec, s_scan


def make_compact_alphabet(arrays, sub, max_k=16):
    """Compact alphabet over the byte codes present in `arrays` (plus
    NUL); returns (code_map[256] -> small index, subsmall (K,K) int32)
    or None when more than max_k codes occur."""
    present = np.zeros(256, bool)
    present[0] = True
    for a in arrays:
        present[np.unique(a)] = True
    codes = np.nonzero(present)[0]
    if len(codes) > max_k:
        return None
    code_map = np.zeros(256, np.int32)
    code_map[codes] = np.arange(len(codes), dtype=np.int32)
    subsmall = np.zeros((max_k, max_k), np.int32)
    subsmall[:len(codes), :len(codes)] = \
        sub[np.ix_(codes, codes)].astype(np.int32)
    return code_map, subsmall


def fresh_state_np(N, gap_e, gap_oe, y_drop, lanes, batch):
    """Closed-form first DP row (gapped_extend.c:3550-3582), computed
    host-side: C(0,0)=0, C(0,j)=-gapOE-(j-1)*gapE while the previous
    value stays >= -yDrop.  Returns the resumable state dict (numpy,
    CC/DD with window origin 0) plus the row-0 link bytes (col 0 -> 0,
    others C_FROM_I)."""
    W = lanes
    B = batch
    j = np.arange(W, dtype=np.int64)
    c0 = np.where(j == 0, 0, -gap_oe - (j - 1) * gap_e)
    c0_prev = np.where(j <= 1, 0, -gap_oe - (j - 2) * gap_e)
    writable = ((j >= 1) & (c0_prev >= -y_drop))[None, :] \
        & (j[None, :] <= np.asarray(N)[:, None])
    RY0 = 1 + writable.sum(axis=1).astype(np.int32)
    in0 = j[None, :] < RY0[:, None]
    CC = np.where(in0, c0[None, :], NEG).astype(np.int32)
    DD = np.where(in0, c0[None, :] - gap_oe, NEG).astype(np.int32)
    row0_links = np.where(in0 & (j[None, :] >= 1),
                          np.uint8(C_FROM_I), np.uint8(0))
    init_over = RY0 > W
    st = dict(
        CC=CC, DD=DD,
        LY=np.zeros(B, np.int32), RY=RY0,
        row=np.ones(B, np.int32),
        best=np.zeros(B, np.int32),
        end1=np.zeros(B, np.int32), end2=np.zeros(B, np.int32),
        bscore=np.full(B, NEG, np.int32),
        bflag=np.zeros(B, bool),
        tbp=RY0.copy(),
        rows_used=np.zeros(B, np.int32),
        maxRY=RY0.copy(),
        status=np.where(init_over, ST_WIDTH_OVERFLOW, 0).astype(np.int32),
        done=init_over.copy(),
    )
    return st, row0_links


def _chunk_one(a_small, b_small, b_off, shift, M, N, state, subsmall,
               gap_e, gap_oe, y_drop,
               *, lanes: int, rows: int, alpha: int,
               trim_to_peak: bool, tb_cap: int):
    """Process up to `rows` DP rows for one anchor, resuming from
    `state`.  a_small: (rows,) compact codes for rows row_base+1 ..
    row_base+rows; b_small: (lanes,) compact codes where lane l is
    column b_off + l; state CC/DD arrive with origin b_off - shift and
    are re-anchored on device.  Returns (state', tb) with tb indexed
    by local row (row - row_base); tb lane l is column b_off + l."""
    W = lanes
    l_iota = jax.lax.iota(jnp.int32, W)

    if gap_e != 0:
        y_drop_tail = int(y_drop) // int(gap_e) + 6
    else:
        y_drop_tail = 500 * 1000

    # device-side window re-anchor (state stays on device between
    # chunks; only the tiny scalars travel to the host)
    padW = jnp.full((W,), NEG, jnp.int32)
    CC0 = jax.lax.dynamic_slice(
        jnp.concatenate([state["CC"], padW]), (shift,), (W,))
    DD0 = jax.lax.dynamic_slice(
        jnp.concatenate([state["DD"], padW]), (shift,), (W,))
    state = dict(state)
    state["CC"] = CC0
    state["DD"] = DD0

    def scan_body(st, a_code):
        CC, DD = st["CC"], st["DD"]
        LY, RY, row = st["LY"], st["RY"], st["row"]
        best = st["best"]
        stopped = st["stop"]

        # truncation check (gapped_extend.c:3621-3660): break BEFORE
        # the row when the traceback arena would overflow
        tb_needed = jnp.maximum(RY - LY, 0) + y_drop_tail
        trunc = ~stopped & (st["tbp"] + tb_needed >= tb_cap)

        # substitution scores for this row via the compact alphabet
        srow = subsmall[a_code]
        s_vals = jnp.zeros((W,), jnp.int32)
        for c in range(alpha):
            s_vals = jnp.where(b_small == c, srow[c], s_vals)

        LYr = LY - b_off   # feasible window in lane coordinates
        RYr = RY - b_off
        active = (l_iota >= LYr) & (l_iota < RYr)
        d = jnp.where(active, DD, NEG)
        c_sub = _shift_right(CC, 1, NEG) + s_vals
        c_sub = jnp.where(active & (l_iota > LYr), c_sub, NEG)

        # Two-pass exact row (replaces the earlier Jacobi fixpoint).
        #
        # Pass 1: a RESET-FREE decayed chain i_ff.  Its refresh value
        # at lane l is I-independent (c_sub - gapOE whenever
        # d <= c_sub; the one scalar branch that suppresses the
        # reopen, namely the gap-by-I case, has i - gapE > c_sub -
        # gapOE anyway, so folding the phantom refresh into the max
        # changes nothing).  Skipping the prune resets is sound for
        # every DECISION: a cell is only pruned while its I
        # contribution is below the running y-drop cut, and any
        # contribution crossing a reset point decays from a sub-cut
        # value and stays sub-cut forever, so i_ff agrees with the
        # true chain whenever either side of a comparison reaches the
        # cut.  Hence `gap`, the running best, and `pruned` computed
        # from i_ff equal the sequential fixpoint exactly.
        left_dead = l_iota < LYr
        comp = (l_iota + 1) * gap_e
        elem_ff = jnp.where(active & (d <= c_sub),
                            c_sub - gap_oe + comp, ISENT)
        s_ff = _shift_right(_prefix_max(elem_ff, ISENT), 1, ISENT)
        i_ff = jnp.maximum(s_ff - l_iota * gap_e, NEG)
        gap = active & ((d > c_sub) | (i_ff > c_sub))
        cand = jnp.maximum(jnp.maximum(c_sub, d), i_ff)
        # running best within the row (exclusive prefix max over
        # non-gap substitution cells; sub-cut phantom seeds at cells
        # the true recurrence prunes can never raise the prefix max)
        c_best = jnp.where(active & ~gap, c_sub, SENT32)
        pmax_excl = _shift_right(_prefix_max(c_best, SENT32), 1,
                                 SENT32)
        best_before = jnp.maximum(best, pmax_excl)
        pruned = active & (cand < best_before - y_drop)
        # Pass 2: one reset scan with the (exact) pruned set gives the
        # exact I values — the link bytes encode I-vs-reopen ties
        # bit-for-bit, so the traceback cannot be steered by a
        # phantom-contaminated tie.
        reset = (pruned & active) | left_dead
        is_seed = active & ~pruned & ~gap
        i_vec, s_incl = _i_chain(c_sub, reset, is_seed, l_iota,
                                 gap_e, gap_oe)

        c_val = jnp.where(gap, jnp.maximum(d, i_vec), c_sub)

        # links (gapped_extend.c notes 5-9; host ydrop.py:453-533)
        c_open = c_sub - gap_oe
        d_dec = d - gap_e
        i_dec = i_vec - gap_e
        link_gap = jnp.where(
            d >= i_vec, np.int32(C_FROM_D | I_EXTEND | D_EXTEND),
            np.int32(C_FROM_I | I_EXTEND | D_EXTEND))
        link_sub = (np.int32(C_FROM_C)
                    | jnp.where(c_open > d_dec, 0, np.int32(D_EXTEND))
                    | jnp.where(c_open > i_dec, 0, np.int32(I_EXTEND)))
        link = jnp.where(pruned | ~active, 0,
                         jnp.where(gap, link_gap, link_sub))

        CC_cur = jnp.where(pruned | ~active, NEG, c_val)
        DD_next = jnp.where(
            pruned | ~active, NEG,
            jnp.where(gap, d_dec, jnp.maximum(c_open, d_dec)))

        # best / end / boundary updates: left-to-right replay via
        # last-attaining-cell selection (host ydrop.py:499-507)
        elig = active & ~pruned & ~gap
        c_e = jnp.where(elig, c_sub, SENT32)
        row_max = jnp.max(c_e)
        fires_best = jnp.any(elig) & (row_max >= best)
        k_best = jnp.max(jnp.where(elig & (c_e == row_max), l_iota, -1))

        if not trim_to_peak:
            col_abs = b_off + l_iota
            at_b = elig & ((row == M) | (col_abs == N))
            c_b = jnp.where(at_b, c_sub, SENT32)
            b_max = jnp.max(c_b)
            fires_b = jnp.any(at_b) & (b_max >= st["bscore"])
            k_b = jnp.max(jnp.where(at_b & (c_b == b_max), l_iota, -1))
        else:
            fires_b = jnp.bool_(False)
            b_max = SENT32 * jnp.int32(1)
            k_b = jnp.int32(-1)

        # the later-executed update wins (boundary runs after best
        # within a cell, so >= on the lane index)
        use_b = fires_b & (~fires_best | (k_b >= k_best))
        use_best = fires_best & ~use_b
        end1 = jnp.where(use_b | use_best, row, st["end1"])
        end2 = jnp.where(use_b, b_off + k_b,
                         jnp.where(use_best, b_off + k_best,
                                   st["end2"]))
        bflag = jnp.where(use_b, True,
                          jnp.where(use_best, False, st["bflag"]))
        best = jnp.where(fires_best, row_max, best)
        bscore = jnp.where(fires_b, b_max, st["bscore"])

        # LY advance over the leading pruned run; np_col
        notpr = active & ~pruned
        any_live = jnp.any(notpr)
        first_live = jnp.where(any_live,
                               jnp.argmax(notpr).astype(jnp.int32), RYr)
        LY_new = b_off + first_live
        np_k = jnp.max(jnp.where(notpr, l_iota, -1))
        np_col = b_off + np_k

        dead = LY_new >= RY  # host: if LY >= RY: break

        # RY update: shrink to np_col+1, or prolong with insertions
        # (host ydrop.py:538-559)
        K = RY - LY
        i_exit = (s_incl[jnp.clip(RYr - 1, 0, W - 1)]
                  - RYr * gap_e)
        shrink = RY > np_col + 1
        thresh = best - y_drop
        if gap_e != 0:
            p_raw = (i_exit - thresh) // gap_e + 1
        else:
            p_raw = jnp.int32(1 << 30)
        p = jnp.where(shrink | (i_exit < thresh), 0,
                      jnp.clip(p_raw, 0, jnp.maximum(N + 1 - RY, 0)))
        RY_shrunk = jnp.where(shrink, np_col + 1, RY + p)
        has_sent = RY_shrunk <= N
        RY_final = RY_shrunk + has_sent.astype(jnp.int32)

        # prolongation cells and NEG sentinel (absolute lanes)
        pj = l_iota - RYr  # prolong index j at lane l
        is_prolong = (pj >= 0) & (pj < p)
        pro_val = i_exit - pj * gap_e
        CC_new = jnp.where(is_prolong, pro_val, CC_cur)
        DD_new = jnp.where(is_prolong, pro_val - gap_oe, DD_next)
        sent_l = RY_shrunk - b_off
        is_sent = has_sent & (l_iota == sent_l)
        CC_new = jnp.where(is_sent, NEG, CC_new)
        DD_new = jnp.where(is_sent, NEG, DD_new)

        # tb bytes: scanned cells carry links, prolongation cells
        # carry C_FROM_I (lane <-> column b_off + l, like everything)
        tb_row_vec = jnp.where(is_prolong, np.int32(C_FROM_I),
                               link).astype(jnp.uint8)

        tbp = st["tbp"] + K + p

        # window / width bookkeeping
        window_end = RY_final - b_off > W  # resume with fresh origin
        width_over = (RY_final - LY_new > W) | (K + p > W)

        keep = ~stopped & ~trunc  # truncated/stopped rows never happen

        status = st["status"]
        status = status | jnp.where(trunc, ST_TRUNCATED, 0)
        status = status | jnp.where(
            keep & width_over & ~dead, ST_WIDTH_OVERFLOW, 0)

        done = st["done"] | trunc | (
            keep & (dead | (row >= M) | width_over))
        stop = stopped | done | (keep & window_end)

        out = dict(
            CC=jnp.where(keep, CC_new, CC),
            DD=jnp.where(keep, DD_new, DD),
            LY=jnp.where(keep, LY_new, LY),
            RY=jnp.where(keep, RY_final, RY),
            row=row + keep.astype(jnp.int32),
            best=jnp.where(keep, best, st["best"]),
            end1=jnp.where(keep, end1, st["end1"]),
            end2=jnp.where(keep, end2, st["end2"]),
            bscore=jnp.where(keep, bscore, st["bscore"]),
            bflag=jnp.where(keep, bflag, st["bflag"]),
            tbp=jnp.where(keep, tbp, st["tbp"]),
            rows_used=jnp.where(keep, row, st["rows_used"]),
            maxRY=jnp.maximum(st["maxRY"],
                              jnp.where(keep, RY_final, 0)),
            status=status,
            done=done,
            stop=stop,
        )
        ys = jnp.where(keep, tb_row_vec, jnp.zeros((W,), jnp.uint8))
        return out, ys

    st = {k: state[k] for k in STATE_KEYS}
    st["stop"] = state["done"]
    st, tb_rows = jax.lax.scan(scan_body, st, a_small)

    out_state = {k: st[k] for k in STATE_KEYS}
    tb_buf = jnp.concatenate(
        [jnp.zeros((1, W), jnp.uint8), tb_rows], axis=0)
    return out_state, tb_buf


@functools.partial(
    jax.jit,
    static_argnames=("gap_e", "gap_oe", "y_drop", "lanes", "rows",
                     "alpha", "trim_to_peak", "tb_cap"))
def ydrop_chunk(a_small, b_small, b_off, shift, M, N, state, subsmall,
                gap_e: int, gap_oe: int, y_drop: int,
                lanes: int, rows: int, alpha: int,
                trim_to_peak: bool, tb_cap: int):
    """Batched resumable chunk: all array args carry a leading batch
    dimension; `state` is a dict of batched state arrays whose CC/DD
    lane origin is b_off - shift (re-anchored on device)."""
    fn = functools.partial(
        _chunk_one, gap_e=int(gap_e), gap_oe=int(gap_oe),
        y_drop=int(y_drop), lanes=lanes, rows=rows, alpha=alpha,
        trim_to_peak=trim_to_peak, tb_cap=tb_cap)
    return jax.vmap(
        lambda a, b, bo, sh, m, n, s: fn(a, b, bo, sh, m, n, s,
                                         subsmall),
    )(a_small, b_small, b_off, shift, M, N, state)


def ydrop_exact_batch(a_full, b_full, M, N, sub,
                      gap_e: int, gap_oe: int, y_drop: int,
                      width: int = 768, rows: int = 512,
                      trim_to_peak: bool = True,
                      tb_cap: int = 80 * 1024 * 1024,
                      max_chunks: int = 64):
    """Convenience wrapper: run anchors to completion with chunked
    relaunches, assembling full tb/ly matrices (host side).  a_full /
    b_full are FULL row/col code arrays per anchor (ragged lengths
    padded with 0); used by tests and small drivers.

    Returns dict with score/end1/end2/status plus assembled "tb"
    (B, total_rows+1, lanes) uint8 and "ly" (B, total_rows+1) column
    origins per row.
    """
    B = a_full.shape[0]
    lanes = rows + width
    cmap_sub = make_compact_alphabet(
        [a_full.ravel(), b_full.ravel()], sub, max_k=16)
    assert cmap_sub is not None, "alphabet too large for the kernel"
    code_map, subsmall = cmap_sub
    st_np, row0_links = fresh_state_np(
        np.asarray(N, np.int64), gap_e, gap_oe, y_drop, lanes, B)
    state = {k: jnp.asarray(v) for k, v in st_np.items()}
    tb_parts = [[] for _ in range(B)]  # (row_start, col0, tb_np)
    prev_off = np.zeros(B, np.int64)
    chunk = 0
    while True:
        done = np.asarray(state["done"])
        row_base = np.asarray(state["row"]).astype(np.int64) - 1
        b_off = np.where(done, prev_off,
                         np.asarray(state["LY"]).astype(np.int64))
        shift = (b_off - prev_off).astype(np.int32)
        prev_off = b_off.copy()
        a_win = np.zeros((B, rows), np.int32)
        b_win = np.zeros((B, lanes), np.int32)
        for b in range(B):
            lo = int(row_base[b])
            src = a_full[b, lo: lo + rows]
            a_win[b, : len(src)] = code_map[src]
            # b_full[i] holds the char of DP column i+1; lane l of the
            # kernel window is column b_off + l
            lo2 = int(b_off[b])
            if lo2 == 0:
                src = b_full[b, : lanes - 1]
                b_win[b, 1: 1 + len(src)] = code_map[src]
            else:
                src = b_full[b, lo2 - 1: lo2 - 1 + lanes]
                b_win[b, : len(src)] = code_map[src]
        state, tb = ydrop_chunk(
            jnp.asarray(a_win), jnp.asarray(b_win),
            jnp.asarray(b_off.astype(np.int32)), jnp.asarray(shift),
            jnp.asarray(M, dtype=jnp.int32),
            jnp.asarray(N, dtype=jnp.int32),
            state, jnp.asarray(subsmall),
            gap_e=gap_e, gap_oe=gap_oe, y_drop=y_drop,
            lanes=lanes, rows=rows, alpha=subsmall.shape[0],
            trim_to_peak=trim_to_peak, tb_cap=tb_cap)
        tb_np = np.asarray(tb)
        done = np.asarray(state["done"])
        rows_used = np.asarray(state["rows_used"])
        for b in range(B):
            if chunk == 0 or rows_used[b] > row_base[b]:
                tb_parts[b].append((int(row_base[b]), int(b_off[b]),
                                    tb_np[b]))
        chunk += 1
        if done.all() or chunk >= max_chunks:
            break

    st_np = {k: np.asarray(v) for k, v in state.items()}
    out = {k: st_np[k] for k in STATE_KEYS if k not in ("CC", "DD")}
    out["score"] = np.where(out["bflag"], out["bscore"], out["best"])
    # assemble contiguous tb/ly
    total = int(out["rows_used"].max()) + 1
    tb_all = np.zeros((B, total, lanes), np.uint8)
    ly_all = np.zeros((B, total), np.int32)
    tb_all[:, 0, :row0_links.shape[1]] = row0_links[:, :lanes]
    for b in range(B):
        for (base, col0, tb_np_b) in tb_parts[b]:
            lo = base + 1
            hi = min(int(out["rows_used"][b]) + 1, base + rows + 1)
            if hi <= lo:
                continue
            n = hi - lo
            tb_all[b, lo: hi] = tb_np_b[1: 1 + n]
            ly_all[b, lo: hi] = col0
    out["tb"] = tb_all
    out["ly"] = ly_all
    return out


# ---------------------------------------------------------------------------
# mega-launch: many chunks per device call over RESIDENT sequences
# ---------------------------------------------------------------------------


def _mega_one(v1c, v2c, a1, a2, low1, high1, low2, high2, rev, M, N,
              state, prev_off0, subsmall,
              *, gap_e: int, gap_oe: int, y_drop: int,
              lanes: int, rows: int, max_blocks: int, alpha: int,
              trim_to_peak: bool, tb_cap: int, kernel: str):
    """Run up to `max_blocks` resumable chunks for ONE anchor without
    leaving the device: windows are gathered from the device-resident
    compact-coded sequences (v1c/v2c) with the exact index arithmetic
    of the old host gather (align/ydrop_device._gather_windows), and
    the window re-anchor between chunks happens on device: one host
    round trip per mega-launch instead of one per chunk (reference row
    sweep: gapped_extend.c:3683-3775).

    kernel: "xla" runs each chunk as the lax.scan of _chunk_one;
    "cuda" runs it as the CUDA kernel of ops/ydrop_cuda.py (same
    contract, bit-identical results).

    rev selects the reversed (left-extension) orientation: row r reads
    v1[a1 - row_base - r], column c reads v2[a2 + 1 - c].

    Returns (state', prev_off', nblk, tb_all (max_blocks, rows+1,
    lanes), row_lo/row_hi/col0 (max_blocks,)).
    """
    W = lanes
    R1 = rows + 1
    r_iota = jax.lax.iota(jnp.int32, rows)
    l_iota = jax.lax.iota(jnp.int32, W)
    L1 = v1c.shape[0]
    L2 = v2c.shape[0]

    if kernel == "cuda":
        from .ydrop_cuda import chunk_one
    elif kernel == "xla":
        chunk_one = _chunk_one
    else:
        raise ValueError(f"unknown y-drop kernel {kernel!r}")
    fn = functools.partial(
        chunk_one, gap_e=gap_e, gap_oe=gap_oe, y_drop=y_drop,
        lanes=lanes, rows=rows, alpha=alpha,
        trim_to_peak=trim_to_peak, tb_cap=tb_cap)

    def cond(carry):
        st, _, k, _, _, _, _ = carry
        return (k < max_blocks) & ~st["done"]

    def body(carry):
        st, prev_off, k, tb_all, row_lo, row_hi, col0 = carry
        row_base = st["row"] - 1
        b_off = jnp.where(st["done"], prev_off, st["LY"])
        shift = b_off - prev_off

        a_idx = jnp.where(rev, a1 - row_base - r_iota,
                          a1 + 1 + row_base + r_iota)
        a_ok = jnp.where(rev, a_idx >= low1,
                         (a_idx < high1) & (a_idx >= low1))
        a_win = jnp.where(
            a_ok, v1c[jnp.clip(a_idx, 0, L1 - 1)].astype(jnp.int32), 0)

        c = b_off + l_iota
        b_idx = jnp.where(rev, a2 + 1 - c, a2 + c)
        b_ok = jnp.where(rev, (b_idx >= low2) & (c >= 1),
                         (b_idx < high2) & (b_idx >= low2))
        b_win = jnp.where(
            b_ok, v2c[jnp.clip(b_idx, 0, L2 - 1)].astype(jnp.int32), 0)

        st2, tb = fn(a_win, b_win, b_off, shift, M, N, st, subsmall)
        tb_all = jax.lax.dynamic_update_slice(
            tb_all, tb[None].astype(jnp.uint8), (k, 0, 0))
        row_lo = row_lo.at[k].set(row_base + 1)
        row_hi = row_hi.at[k].set(st2["rows_used"])
        col0 = col0.at[k].set(b_off)
        return st2, b_off, k + 1, tb_all, row_lo, row_hi, col0

    tb0 = jnp.zeros((max_blocks, R1, W), jnp.uint8)
    z = jnp.zeros((max_blocks,), jnp.int32)
    carry = (dict(state), prev_off0, jnp.int32(0), tb0, z, z, z)
    st, prev_off, k, tb_all, row_lo, row_hi, col0 = \
        jax.lax.while_loop(cond, body, carry)
    return st, prev_off, k, tb_all, row_lo, row_hi, col0


@functools.partial(
    jax.jit,
    static_argnames=("gap_e", "gap_oe", "y_drop", "lanes", "rows",
                     "max_blocks", "alpha", "trim_to_peak", "tb_cap",
                     "with_tb", "kernel"))
def ydrop_mega(v1c, v2c, a1, a2, low1, high1, low2, high2, rev, M, N,
               state, prev_off0, subsmall,
               gap_e: int, gap_oe: int, y_drop: int,
               lanes: int, rows: int, max_blocks: int, alpha: int,
               trim_to_peak: bool, tb_cap: int, with_tb: bool = True,
               kernel: str = "xla"):
    """Batched mega-launch (leading batch dim on the per-anchor args
    and on every state array; v1c/v2c/subsmall broadcast).  Also packs
    the post-launch per-lane scalars into one (13, B) array so the
    host fetches loop state in a single transfer."""
    fn = functools.partial(
        _mega_one, gap_e=int(gap_e), gap_oe=int(gap_oe),
        y_drop=int(y_drop), lanes=lanes, rows=rows,
        max_blocks=max_blocks, alpha=alpha,
        trim_to_peak=trim_to_peak, tb_cap=tb_cap, kernel=kernel)
    st, prev_off, nblk, tb_all, row_lo, row_hi, col0 = jax.vmap(
        lambda A1, A2, lo1, hi1, lo2, hi2, rv, m, n, s, po:
        fn(v1c, v2c, A1, A2, lo1, hi1, lo2, hi2, rv, m, n, s, po,
           subsmall),
    )(a1, a2, low1, high1, low2, high2, rev, M, N, state, prev_off0)
    if not with_tb:
        tb_all = jnp.zeros((a1.shape[0], 1, 1, 1), jnp.uint8)
    packed = jnp.stack([
        st["row"], st["LY"], st["rows_used"],
        st["done"].astype(jnp.int32), st["status"], st["best"],
        st["end1"], st["end2"], st["bscore"],
        st["bflag"].astype(jnp.int32), st["tbp"], st["maxRY"],
        nblk])
    return st, prev_off, packed, tb_all, row_lo, row_hi, col0


@functools.partial(jax.jit, static_argnames=("cap",))
def traceback_mega_dev(tb_all, row_lo, row_hi, col0, nblk,
                       end1, end2, want, cap: int):
    """Walk the whole retained multi-block traceback in ONE device
    call (replaces the per-chunk traceback_chunk_dev loop).

    tb_all: (B, K, R+1, W); row_lo/row_hi/col0: (B, K) global row
    ranges and column origins per retained block; want: lanes to walk.
    Returns (ops (B, cap) uint8 walk codes, n (B,), row, col) — a
    finished walk ends with row <= 0 and col <= 0.

    Same gap-extension-preferring link walk as traceback_ops
    (gapped_extend.c:3845-3860).
    """
    B, K, R1, W = tb_all.shape
    biota = jnp.arange(B)
    kiota = jnp.arange(K)

    row0 = jnp.where(want, end1, 0)
    col0_w = jnp.where(want, end2, 0)

    def active(row, col):
        return (row >= 1) | (col > 0)

    def cond(st):
        row, col, prev, n, ops = st
        return jnp.any(active(row, col)) & jnp.all(n < cap)

    def body(st):
        row, col, prev, n, ops = st
        act = active(row, col)
        inblk = (kiota[None, :] < nblk[:, None]) & \
            (row[:, None] >= row_lo)
        blk = jnp.maximum(
            jnp.sum(inblk.astype(jnp.int32), axis=1) - 1, 0)
        lo = row_lo[biota, blk]
        local = jnp.clip(row - (lo - 1), 0, R1 - 1)
        lane = jnp.clip(col - col0[biota, blk], 0, W - 1)
        link = tb_all[biota, blk, local, lane].astype(jnp.int32)
        op = link & CID_BITS
        op = jnp.where((prev == C_FROM_I) & ((link & I_EXTEND) != 0),
                       C_FROM_I, op)
        op = jnp.where((prev == C_FROM_D) & ((link & D_EXTEND) != 0),
                       C_FROM_D, op)
        op = jnp.where(row == 0, C_FROM_I, op)
        code = jnp.where(op == C_FROM_I, OP_I,
                         jnp.where(op == C_FROM_D, OP_D, OP_S))
        ops = ops.at[biota, jnp.minimum(n, cap - 1)].set(
            jnp.where(act, code.astype(jnp.uint8), 0))
        row_n = jnp.where(op == C_FROM_I, row, row - 1)
        col_n = jnp.where(op == C_FROM_D, col, col - 1)
        row = jnp.where(act, row_n, row)
        col = jnp.where(act, col_n, col)
        prev = jnp.where(act, op, prev)
        n = n + act.astype(jnp.int32)
        return row, col, prev, n, ops

    ops0 = jnp.zeros((B, cap), jnp.uint8)
    n0 = jnp.zeros((B,), jnp.int32)
    prev0 = jnp.zeros((B,), jnp.int32)
    row, col, prev, n, ops = jax.lax.while_loop(
        cond, body, (row0, col0_w, prev0, n0, ops0))
    return ops, n, row, col


OP_S = 1
OP_I = 2
OP_D = 3
_OP_CHR = {OP_S: "S", OP_I: "I", OP_D: "D"}


@functools.partial(jax.jit, static_argnames=("cap",))
def traceback_chunk_dev(tb, col0, row_lo, row_hi, row, col, prev_op,
                        cap: int):
    """Walk one chunk's traceback links backward, batched over lanes.

    tb: (B, R+1, W) uint8 link bytes (local row = row - (row_lo-1),
    lane = col - col0); row_lo/row_hi: per-lane global row range this
    chunk actually computed; (row, col, prev_op): per-lane walk state.
    A lane steps while its row is inside the chunk's range (the row-0
    insertion run is synthesized link-free when row_lo <= 1).  Returns
    (ops, n_ops, row, col, prev_op): ops is (B, cap) uint8 of
    OP_S/OP_I/OP_D codes in walk order (alignment end -> start).

    Replicates the reference's gap-extension-preferring walk
    (gapped_extend.c:3845-3860).
    """
    B = tb.shape[0]
    R1 = tb.shape[1]
    W = tb.shape[2]

    def active(row, col):
        live = (row >= 1) | (col > 0)
        in_chunk = (row <= row_hi) & ((row >= row_lo)
                                      | ((row == 0) & (row_lo <= 1)))
        return live & in_chunk

    def cond(st):
        row, col, prev, n, ops = st
        return jnp.any(active(row, col)) & jnp.all(n < cap)

    def body(st):
        row, col, prev, n, ops = st
        act = active(row, col)
        local = jnp.clip(row - (row_lo - 1), 0, R1 - 1)
        lane = jnp.clip(col - col0, 0, W - 1)
        link = tb[jnp.arange(B), local, lane].astype(jnp.int32)
        op = link & CID_BITS
        op = jnp.where((prev == C_FROM_I) & ((link & I_EXTEND) != 0),
                       C_FROM_I, op)
        op = jnp.where((prev == C_FROM_D) & ((link & D_EXTEND) != 0),
                       C_FROM_D, op)
        op = jnp.where(row == 0, C_FROM_I, op)  # row-0 insertion run
        code = jnp.where(op == C_FROM_I, OP_I,
                         jnp.where(op == C_FROM_D, OP_D, OP_S))
        ops = ops.at[jnp.arange(B), jnp.minimum(n, cap - 1)].set(
            jnp.where(act, code.astype(jnp.uint8), 0))
        row_n = jnp.where(op == C_FROM_I, row, row - 1)
        col_n = jnp.where(op == C_FROM_D, col, col - 1)
        row = jnp.where(act, row_n, row)
        col = jnp.where(act, col_n, col)
        prev = jnp.where(act, op, prev)
        n = n + act.astype(jnp.int32)
        return row, col, prev, n, ops

    ops0 = jnp.zeros((B, cap), jnp.uint8)
    n0 = jnp.zeros((B,), jnp.int32)
    row, col, prev, n, ops = jax.lax.while_loop(
        cond, body, (row, col, prev_op, n0, ops0))
    return ops, n, row, col, prev


def traceback_ops(tb: np.ndarray, ly: np.ndarray, end1: int,
                  end2: int) -> list[str]:
    """Host traceback over the kernel's link bytes; replicates the
    reference's gap-extension-preferring walk
    (gapped_extend.c:3845-3860; host ydrop.py:563-584).  ly[row] is
    the column of the row's first tb lane."""
    row, col = int(end1), int(end2)
    ops: list[str] = []
    prev_op = 0
    while row >= 1 or col > 0:
        link = int(tb[row, col - int(ly[row])])
        op = link & CID_BITS
        if prev_op == C_FROM_I and (link & I_EXTEND):
            op = C_FROM_I
        if prev_op == C_FROM_D and (link & D_EXTEND):
            op = C_FROM_D
        if op == C_FROM_I:
            col -= 1
            ops.append("I")
        elif op == C_FROM_D:
            row -= 1
            ops.append("D")
        else:
            row -= 1
            col -= 1
            ops.append("S")
        prev_op = op
    return ops

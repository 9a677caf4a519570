"""Batched gap-free x-drop extension (reference
xdrop_extend_seed_hit, seed_search.c:2528-2801).

Extends many seed hits at once: each hit scans left then right along
its diagonal accumulating substitution scores, stopping when the
running score drops more than xDrop below the running maximum.  The
scans are UNBLOCKED (old diagonal extent = 0); the replay layer
(search/batched.py) detects the rare hits whose left scan would have
been cut by the diagonal-hash block and recomputes those exactly.

Semantics mirror the host engine's vectorized scan
(search/engine.py:_xdrop_extend) cell for cell:
  * consumed = index of the first cell whose cumulative score falls
    below max(runmax, 0) - xDrop, plus one (the failing cell is
    consumed), capped at the scan length;
  * best = max cumulative score over the consumed prefix; the end
    offset is the FIRST cell attaining it; best <= 0 reports a zero
    extension.

Two interchangeable backends: numpy (default host path) and a jitted
JAX version (device path, chunked gathers).  Scans longer than a
chunk carry (cumulative score, running max, best) across chunks.
"""

from __future__ import annotations

import functools

import numpy as np

CHUNK = 1024


def _np_scan(seq1, seq2, sub, p1, p2, n, step):
    """Vectorized chunked scan for a batch of hits (numpy backend).

    p1/p2: (H,) first cell coordinates; n: (H,) scan lengths;
    step: +1 (right) or -1 (left).  seq1/seq2 are COMPACT-alphabet
    codes and sub a (K*K,) flat int32 table when _np_scan.flat is set
    (cache-resident lookups); otherwise raw bytes + (256,256) table.
    Returns consumed, best, kbest (offsets; kbest = -1 if best <= 0).
    """
    H = len(p1)
    flatK = getattr(_np_scan, "flatK", 0)
    cdtype = np.int32 if flatK else sub.dtype
    consumed = np.zeros(H, dtype=np.int64)
    best = np.zeros(H, dtype=cdtype)
    kbest = np.full(H, -1, dtype=np.int64)
    cum = np.zeros(H, dtype=cdtype)
    runmax = np.zeros(H, dtype=cdtype)
    live = n > 0
    base = np.zeros(H, dtype=np.int64)  # cells consumed so far
    x_drop = _np_scan.x_drop
    L1, L2 = len(seq1), len(seq2)
    HBLOCK = 1 << 15  # hits per pass (bounds the (H, chunk) temps)
    FIRST = 96        # first-chunk size; most scans die inside it
    while live.any():
        idx = np.nonzero(live)[0][:HBLOCK]
        chunk = FIRST if base[idx].max() == 0 else CHUNK
        offs = np.arange(chunk, dtype=np.int64)
        i1 = p1[idx, None] + step * (base[idx, None] + offs[None, :])
        i2 = p2[idx, None] + step * (base[idx, None] + offs[None, :])
        rem = n[idx] - base[idx]
        valid = offs[None, :] < rem[:, None]
        if flatK:
            key = seq1[np.clip(i1, 0, L1 - 1)].astype(np.int16)
            key *= flatK
            key += seq2[np.clip(i2, 0, L2 - 1)]
            sc = sub[key]
        else:
            sc = sub[seq1[np.clip(i1, 0, L1 - 1)],
                     seq2[np.clip(i2, 0, L2 - 1)]]
        sc = np.where(valid, sc, 0)
        c = cum[idx, None] + np.cumsum(sc, axis=1)
        m = np.maximum(np.maximum.accumulate(c, axis=1),
                       runmax[idx, None])
        bad = (c < np.maximum(m, 0) - x_drop) & valid
        any_bad = bad.any(axis=1)
        first_bad = np.where(any_bad, bad.argmax(axis=1), chunk)
        take = np.minimum(first_bad + 1, rem)
        take = np.minimum(take, chunk)
        # best over the taken prefix (first occurrence wins, strict >)
        inpref = offs[None, :] < take[:, None]
        cc = np.where(inpref, c, np.iinfo(cdtype).min
                      if np.issubdtype(cdtype, np.integer) else -np.inf)
        chunk_best = cc.max(axis=1)
        chunk_arg = cc.argmax(axis=1)
        better = chunk_best > best[idx]
        best[idx] = np.where(better, chunk_best, best[idx])
        kbest[idx] = np.where(better, base[idx] + chunk_arg, kbest[idx])
        consumed[idx] = base[idx] + take
        # continue hits that neither failed nor exhausted their length
        cont = (~any_bad) & (rem > chunk)
        cum[idx] = c[np.arange(len(idx)), np.maximum(take - 1, 0)]
        runmax[idx] = m[np.arange(len(idx)), np.maximum(take - 1, 0)]
        base[idx] += chunk
        live[idx] = cont
    kbest = np.where(best > 0, kbest, -1)
    return consumed, best, kbest


def batch_xdrop_native(seq1, seq2, sub, pos1, pos2, x_drop, lib):
    """batch_xdrop_np semantics via one native call per hit chunk
    (native/ydrop_row.cpp xdrop_scan_batch) — the per-hit scans die
    after a few dozen bases, which a scalar C loop handles at memory
    speed while the numpy scan pays multi-pass array overheads."""
    import ctypes
    seq1 = np.ascontiguousarray(seq1, dtype=np.uint8)
    seq2 = np.ascontiguousarray(seq2, dtype=np.uint8)
    sub = np.ascontiguousarray(sub, dtype=np.int64)
    pos1 = np.ascontiguousarray(pos1, dtype=np.int64)
    pos2 = np.ascontiguousarray(pos2, dtype=np.int64)
    H = len(pos1)
    out = {k: np.empty(H, np.int64)
           for k in ("left_consumed", "left_score", "left_start",
                     "right_consumed", "right_score", "right_stop")}
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    lib.xdrop_scan_batch(
        seq1.ctypes.data_as(p_u8), seq2.ctypes.data_as(p_u8),
        sub.ctypes.data_as(p_i64),
        ctypes.c_int64(len(seq1)), ctypes.c_int64(len(seq2)),
        ctypes.c_int64(x_drop),
        pos1.ctypes.data_as(p_i64), pos2.ctypes.data_as(p_i64),
        ctypes.c_int64(H),
        out["left_consumed"].ctypes.data_as(p_i64),
        out["left_score"].ctypes.data_as(p_i64),
        out["left_start"].ctypes.data_as(p_i64),
        out["right_consumed"].ctypes.data_as(p_i64),
        out["right_score"].ctypes.data_as(p_i64),
        out["right_stop"].ctypes.data_as(p_i64))
    return out


def batch_xdrop_np(seq1, seq2, sub, pos1, pos2, x_drop,
                   precoded=None):
    """Unblocked two-sided x-drop extension for a hit batch (numpy).

    pos1/pos2: (H,) hit END positions (origin-0 exclusive).
    precoded: optional (s1_small, s2_small, subflat, K) compact-
    alphabet arrays (int8 codes + flat (K*K,) int32 score table) —
    score lookups then hit a cache-resident table and the cumulative
    arithmetic runs in int32 (values are identical: the reference
    computes 32-bit scores).
    Returns dict of per-hit arrays:
      left_consumed, left_score, left_start,
      right_consumed (== right_block - pos1), right_score, right_stop.
    """
    pos1 = np.asarray(pos1, dtype=np.int64)
    pos2 = np.asarray(pos2, dtype=np.int64)
    if precoded is not None:
        seq1, seq2, sub, K = precoded
        _np_scan.flatK = K
    else:
        _np_scan.flatK = 0
    diag = pos1 - pos2
    # left: from pos1-1 down to stop1 = max(diag, 0)
    stop1 = np.maximum(diag, 0)
    n_left = pos1 - stop1
    _np_scan.x_drop = x_drop
    lc, lb, lk = _np_scan(seq1, seq2, sub, pos1 - 1, pos2 - 1,
                          n_left, -1)
    left_score = np.where(lb > 0, lb, 0)
    left_start = np.where(lb > 0, pos1 - 1 - lk, pos1)
    # right: from pos1 to stop1r = min(len1, len2 + diag)
    stop1r = np.minimum(len(seq1), len(seq2) + diag)
    n_right = np.maximum(stop1r - pos1, 0)
    rc, rb, rk = _np_scan(seq1, seq2, sub, pos1, pos2, n_right, +1)
    right_score = np.where(rb > 0, rb, 0)
    right_stop = np.where(rb > 0, pos1 + rk + 1, pos1)
    return dict(
        left_consumed=lc, left_score=left_score, left_start=left_start,
        right_consumed=rc, right_score=right_score,
        right_stop=right_stop)


# ---------------------------------------------------------------------------
# JAX backend: same math, jitted chunks over device-resident sequences
# ---------------------------------------------------------------------------


_JAX_FUSED = {}


def _get_fused(chunk, hslice):
    """Jitted fused scan: the whole multi-round chunked continuation
    runs in ONE device launch (lax.while over rounds), so a hit slice
    costs one upload of (p1, p2, n) and one download of the results —
    no per-round host round trips."""
    key = (chunk, hslice)
    if key not in _JAX_FUSED:
        import jax
        _JAX_FUSED[key] = jax.jit(
            functools.partial(_jax_fused_impl, chunk=chunk))
    return _JAX_FUSED[key]


def _jax_fused_impl(seq1, seq2, sub, p1, p2, n, x_drop, step,
                    chunk: int):
    import jax.lax as lax
    import jax.numpy as jnp

    H = p1.shape[0]
    offs = jnp.arange(chunk, dtype=jnp.int32)
    L1 = seq1.shape[0]
    L2 = seq2.shape[0]

    def round_body(st):
        base, cum, runmax, best, kbest, consumed, live = st
        i1 = p1[:, None] + step * (base[:, None] + offs[None, :])
        i2 = p2[:, None] + step * (base[:, None] + offs[None, :])
        rem = n - base
        valid = (offs[None, :] < rem[:, None]) & live[:, None]
        ch1 = seq1[jnp.clip(i1, 0, L1 - 1)]
        ch2 = seq2[jnp.clip(i2, 0, L2 - 1)]
        sc = jnp.where(valid, sub[ch1, ch2], 0)
        c = cum[:, None] + jnp.cumsum(sc, axis=1)
        m = jnp.maximum(lax.cummax(c, axis=1), runmax[:, None])
        bad = (c < jnp.maximum(m, 0) - x_drop) & valid
        any_bad = jnp.any(bad, axis=1)
        first_bad = jnp.where(any_bad,
                              jnp.argmax(bad, axis=1).astype(jnp.int32),
                              chunk)
        take = jnp.minimum(jnp.minimum(first_bad + 1, rem), chunk)
        take = jnp.maximum(take, 0)
        inpref = (offs[None, :] < take[:, None]) & live[:, None]
        cc = jnp.where(inpref, c, jnp.int32(-(1 << 30)))
        chunk_best = jnp.max(cc, axis=1)
        chunk_arg = jnp.argmax(cc, axis=1).astype(jnp.int32)
        better = live & (chunk_best > best)
        best = jnp.where(better, chunk_best, best)
        kbest = jnp.where(better, base + chunk_arg, kbest)
        consumed = jnp.where(live, base + take, consumed)
        last = jnp.maximum(take - 1, 0)
        cum = jnp.where(live,
                        jnp.take_along_axis(c, last[:, None],
                                            axis=1)[:, 0], cum)
        runmax = jnp.where(live,
                           jnp.take_along_axis(m, last[:, None],
                                               axis=1)[:, 0], runmax)
        base = jnp.where(live, base + chunk, base)
        live = live & (~any_bad) & (rem > chunk)
        return base, cum, runmax, best, kbest, consumed, live

    z = jnp.zeros((H,), jnp.int32)
    st = (z, z, z, z, jnp.full((H,), -1, jnp.int32), z, n > 0)
    st = lax.while_loop(lambda s: jnp.any(s[6]), round_body, st)
    _, _, _, best, kbest, consumed, _ = st
    kbest = jnp.where(best > 0, kbest, -1)
    return consumed, best, kbest


_JAX_SCAN = None


def _get_jax_scan():
    """Lazily build the jitted chunk scan (keeps jax out of the import
    path for host-only runs)."""
    global _JAX_SCAN
    if _JAX_SCAN is None:
        import jax
        _JAX_SCAN = functools.partial(
            jax.jit(_jax_scan_chunk_impl,
                    static_argnames=("step", "chunk")))
    return _JAX_SCAN


def _jax_scan_chunk_impl(seq1, seq2, sub, p1, p2, n, base, cum, runmax,
                         best, kbest, x_drop, step: int, chunk: int):
    import jax.lax as lax
    import jax.numpy as jnp
    offs = jnp.arange(chunk, dtype=jnp.int32)
    i1 = p1[:, None] + step * (base[:, None] + offs[None, :])
    i2 = p2[:, None] + step * (base[:, None] + offs[None, :])
    rem = n - base
    valid = offs[None, :] < rem[:, None]
    L1 = seq1.shape[0]
    L2 = seq2.shape[0]
    ch1 = seq1[jnp.clip(i1, 0, L1 - 1)]
    ch2 = seq2[jnp.clip(i2, 0, L2 - 1)]
    sc = sub[ch1, ch2]
    sc = jnp.where(valid, sc, 0)
    c = cum[:, None] + jnp.cumsum(sc, axis=1)
    m = jnp.maximum(lax.cummax(c, axis=1), runmax[:, None])
    bad = (c < jnp.maximum(m, 0) - x_drop) & valid
    any_bad = jnp.any(bad, axis=1)
    first_bad = jnp.where(any_bad, jnp.argmax(bad, axis=1), chunk)
    take = jnp.minimum(jnp.minimum(first_bad + 1, rem), chunk)
    inpref = offs[None, :] < take[:, None]
    cc = jnp.where(inpref, c, jnp.int32(-(1 << 30)))
    chunk_best = jnp.max(cc, axis=1)
    chunk_arg = jnp.argmax(cc, axis=1).astype(jnp.int32)
    better = chunk_best > best
    best = jnp.where(better, chunk_best, best)
    kbest = jnp.where(better, base + chunk_arg, kbest)
    consumed = base + take
    cont = (~any_bad) & (rem > chunk)
    last = jnp.maximum(take - 1, 0)
    cum = jnp.take_along_axis(c, last[:, None], axis=1)[:, 0]
    runmax = jnp.take_along_axis(m, last[:, None], axis=1)[:, 0]
    return consumed, cum, runmax, best, kbest, cont


HSLICE = 1 << 16   # hits per device call (bounds memory)
FIRST_CHUNK = 128  # most scans die within a few dozen cells


def batch_xdrop_jax(seq1_dev, seq2_dev, sub_dev, pos1, pos2, x_drop,
                    chunk: int = 256):
    """Fused device variant of batch_xdrop_np; sequences and the
    256x256 sub table are device-resident.  Hits are processed in
    fixed HSLICE batches (padded, so jit shapes stay stable); each
    slice is ONE device launch + ONE result fetch."""
    import jax.numpy as jnp
    pos1 = np.asarray(pos1, dtype=np.int64)
    pos2 = np.asarray(pos2, dtype=np.int64)
    H = len(pos1)
    diag = pos1 - pos2
    out = {}
    L1 = int(seq1_dev.shape[0])
    L2 = int(seq2_dev.shape[0])
    fused = _get_fused(chunk, HSLICE)
    for which, step in (("left", -1), ("right", +1)):
        if which == "left":
            stop1 = np.maximum(diag, 0)
            n = pos1 - stop1
            p1 = pos1 - 1
            p2 = pos2 - 1
        else:
            stop1r = np.minimum(L1, L2 + diag)
            n = np.maximum(stop1r - pos1, 0)
            p1 = pos1
            p2 = pos2
        consumed = np.zeros(H, np.int64)
        best = np.zeros(H, np.int64)
        kbest = np.full(H, -1, np.int64)
        for lo in range(0, H, HSLICE):
            hi = min(lo + HSLICE, H)
            k = hi - lo
            pad = HSLICE - k
            p1s = np.concatenate([p1[lo:hi],
                                  np.zeros(pad, np.int64)])
            p2s = np.concatenate([p2[lo:hi],
                                  np.zeros(pad, np.int64)])
            ns = np.concatenate([n[lo:hi], np.zeros(pad, np.int64)])
            cj, bj, kj = fused(
                seq1_dev, seq2_dev, sub_dev,
                jnp.asarray(p1s, jnp.int32),
                jnp.asarray(p2s, jnp.int32),
                jnp.asarray(ns, jnp.int32), jnp.int32(x_drop),
                jnp.int32(step))
            consumed[lo:hi] = np.asarray(cj)[:k]
            best[lo:hi] = np.asarray(bj)[:k]
            kbest[lo:hi] = np.asarray(kj)[:k]
        kbest = np.where(best > 0, kbest, -1)
        if which == "left":
            out["left_consumed"] = consumed
            out["left_score"] = np.where(best > 0, best, 0)
            out["left_start"] = np.where(best > 0, pos1 - 1 - kbest,
                                         pos1)
        else:
            out["right_consumed"] = consumed
            out["right_score"] = np.where(best > 0, best, 0)
            out["right_stop"] = np.where(best > 0, pos1 + kbest + 1,
                                         pos1)
    return out

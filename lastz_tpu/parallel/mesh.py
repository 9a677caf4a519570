"""Multi-chip scaling: query-data-parallel sharding over a device mesh.

The reference's distribution story is "run N processes over query
shards, sharing the target index via a mmapped capsule"
(capsule.c:6-15 + README farm-out recipe).  The device-mesh design:

  * one `jax.sharding.Mesh` with a "dp" axis across all chips;
  * the target's seed index (CSR arrays), packed target codes and the
    score tables are REPLICATED (read-only, small relative to device
    memory —
    the reference reaches the same conclusion via mmap sharing);
  * query blocks (fixed-size padded code arrays) are SHARDED along
    dp, as are the anchor batches derived from them;
  * each chip runs the PRODUCTION kernels on its shard: spaced-seed
    word packing (core/seeds.py bit maps), CSR hit counting, the
    unblocked x-drop diagonal scan (ops/xdrop_batch.py math), and the
    exact chunked y-drop extension (ops/ydrop_exact.ydrop_chunk);
  * the per-target-base census (dynamic masking state, the only
    cross-query coupling in the reference, masking.c:6-25) is
    combined with a `psum`; alignments are gathered to the host(s)
    for the format writers.

Process-level sharding for production runs uses the same math via the
CLI's query subsetting (`--shard=i/n`, mirroring the reference's
capsule farm-out), so per-host outputs concatenate into the
single-run output.  shard_map keeps every collective explicit; across
the cards of one host the psum and all_gather ride NVLink.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def make_dp_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), axis_names=("dp",))


def pack_words_jnp(query_codes, seed):
    """Device-side spaced-seed word packing: the same window/bit-map
    construction as index/postable._window_words + Seed.pack
    (reference apply_seed, seeds.c), traced over a (Q, L) block of
    2-bit codes (-1 = invalid)."""
    Q, L = query_codes.shape
    length = seed.length
    bits_per = seed.bits_per_base
    num = L - length + 1
    w = jnp.zeros((Q, num), dtype=jnp.uint32)
    valid = jnp.ones((Q, num), dtype=bool)
    c = query_codes
    for i in range(length):
        seg = jax.lax.dynamic_slice_in_dim(c, i, num, axis=1)
        valid = valid & (seg >= 0)
        if bits_per == 2:
            w = (w << 2) | jnp.maximum(seg, 0).astype(jnp.uint32)
        else:
            w = (w << 1) | (jnp.maximum(seg, 0).astype(jnp.uint32) & 1)
    packed = jnp.zeros_like(w)
    for src, dst in seed.bit_map:
        packed |= ((w >> src) & 1) << dst
    return packed.astype(jnp.int32), valid


def xdrop_scan_jnp(seq1, seq2, sub4, p1, p2, n, x_drop, step, chunk):
    """One fixed-chunk unblocked x-drop scan (the kernel math of
    ops/xdrop_batch._jax_scan_chunk_impl, single chunk)."""
    offs = jnp.arange(chunk, dtype=jnp.int32)
    i1 = p1[:, None] + step * offs[None, :]
    i2 = p2[:, None] + step * offs[None, :]
    valid = offs[None, :] < n[:, None]
    L1 = seq1.shape[0]
    L2 = seq2.shape[0]
    c1 = seq1[jnp.clip(i1, 0, L1 - 1)]
    c2 = seq2[jnp.clip(i2, 0, L2 - 1)]
    sc = jnp.where((c1 >= 0) & (c2 >= 0),
                   sub4[jnp.maximum(c1, 0), jnp.maximum(c2, 0)],
                   jnp.int32(-(1 << 20)))
    sc = jnp.where(valid, sc, 0)
    c = jnp.cumsum(sc, axis=1)
    m = jax.lax.cummax(c, axis=1)
    bad = (c < jnp.maximum(m, 0) - x_drop) & valid
    any_bad = jnp.any(bad, axis=1)
    first_bad = jnp.where(any_bad, jnp.argmax(bad, axis=1), chunk)
    take = jnp.minimum(first_bad + 1, n)
    inpref = offs[None, :] < take[:, None]
    cc = jnp.where(inpref, c, jnp.int32(-(1 << 30)))
    best = jnp.maximum(jnp.max(cc, axis=1), 0)
    kbest = jnp.argmax(cc, axis=1)
    return best, kbest, take


def make_sharded_pipeline(mesh: Mesh, seed, lanes=256, rows=128,
                          xchunk=128, gap_e=30, gap_oe=430,
                          y_drop=3000, x_drop=910):
    """Build the jitted multi-chip step over the production kernels.

    Inputs (to the returned function):
      query_codes: (n_shards*Qb, L) int32 2-bit codes, sharded on dp
      target_codes: (T,) int32 2-bit target codes, replicated
      csr_start: (4^w + 1,) int32 CSR offsets, replicated
      sub4: (4, 4) int32 substitution scores (2-bit alphabet)
      anchors12: (n_shards*A, 2) int32 (target, query-flat) anchor
                 points, sharded on dp
      subsmall/state...: built internally

    Per shard: count seed-index hits for every query word; x-drop
    extend each anchor's diagonal both ways; run one exact y-drop
    chunk (ops/ydrop_exact._chunk_one) over the anchor batch; census
    via scatter-add, psum'd across dp.
    """
    from ..ops.ydrop_exact import STATE_KEYS, _chunk_one
    import functools

    def step(query_codes, target_codes, csr_start, sub4, subsmall,
             anchors12, state, a_small, b_small):
        # 1. seed stage: word packing + CSR hit counts (per shard)
        words, valid = pack_words_jnp(query_codes, seed)
        counts = (jnp.take(csr_start, words + 1, fill_value=0)
                  - jnp.take(csr_start, words, fill_value=0))
        counts = jnp.where(valid, counts, 0)

        # 2. gap-free x-drop extension along each anchor's diagonal.
        # anchor query coordinates are GLOBAL flat positions; localize
        # them to this shard's block and bound every scan by its own
        # query block so results are invariant to the mesh size
        qflat = query_codes.reshape(-1)
        L = query_codes.shape[1]
        p1 = anchors12[:, 0]
        shard_off = jax.lax.axis_index("dp") * qflat.shape[0]
        p2 = anchors12[:, 1] - shard_off
        q_ix = p2 // L
        blk_lo = q_ix * L
        blk_hi = (q_ix + 1) * L
        n_r = jnp.minimum(target_codes.shape[0] - p1,
                          blk_hi - p2).astype(jnp.int32)
        r_best, r_k, r_take = xdrop_scan_jnp(
            target_codes, qflat, sub4, p1, p2, n_r, x_drop, 1, xchunk)
        n_l = jnp.minimum(p1, p2 - blk_lo).astype(jnp.int32)
        l_best, l_k, l_take = xdrop_scan_jnp(
            target_codes, qflat, sub4, p1 - 1, p2 - 1, n_l, x_drop,
            -1, xchunk)
        hsp_score = r_best + l_best

        # 3. exact y-drop chunk over this shard's anchors (the
        # production kernel, ops/ydrop_exact.py)
        fn = functools.partial(
            _chunk_one, gap_e=gap_e, gap_oe=gap_oe, y_drop=y_drop,
            lanes=lanes, rows=rows, alpha=subsmall.shape[0],
            trim_to_peak=True, tb_cap=80 << 20)
        A = anchors12.shape[0]
        zero = jnp.zeros((A,), jnp.int32)
        M = jnp.minimum(n_r, rows)
        N = jnp.minimum(n_r, lanes - 2)
        out_state, tb = jax.vmap(
            lambda a, b, m, n, s: fn(a, b, jnp.int32(0), jnp.int32(0),
                                     m, n, s, subsmall),
        )(a_small, b_small, M, N, state)

        # 4. census of target coverage, combined across dp: the only
        # cross-query coupling (dynamic masking, masking.c:6-25)
        census_local = jnp.zeros_like(target_codes, dtype=jnp.int32)
        lens = out_state["rows_used"]
        pos = p1[:, None] + jnp.arange(rows)[None, :]
        cover = jnp.arange(rows)[None, :] < lens[:, None]
        census_local = census_local.at[pos.reshape(-1)].add(
            cover.reshape(-1).astype(jnp.int32), mode="drop")
        census = jax.lax.psum(census_local, "dp")
        total_hits = jax.lax.psum(jnp.sum(counts), "dp")
        yscore = jnp.where(out_state["bflag"], out_state["bscore"],
                           out_state["best"])
        return (counts, hsp_score, yscore,
                out_state["end1"], out_state["end2"], census,
                total_hits)

    state_spec = {k: P("dp") for k in
                  ("CC", "DD", "LY", "RY", "row", "best", "end1",
                   "end2", "bscore", "bflag", "tbp", "rows_used",
                   "maxRY", "status", "done")}
    specs = dict(
        mesh=mesh,
        in_specs=(P("dp", None), P(), P(), P(), P(),
                  P("dp", None), state_spec, P("dp", None),
                  P("dp", None)),
        out_specs=(P("dp", None), P("dp"), P("dp"), P("dp"), P("dp"),
                   P(), P()),
    )
    try:
        sharded = jax.shard_map(step, check_vma=False, **specs)
    except (AttributeError, TypeError):
        from jax.experimental.shard_map import shard_map
        sharded = shard_map(step, check_rep=False, **specs)
    return jax.jit(sharded)


def build_mesh_inputs(target_v, queries_v, seed, scoring, n_shards,
                      q_per_shard, qlen, anchors_per_shard,
                      lanes=256, rows=128, y_drop=3000, rng_seed=0):
    """Host-side preparation of the sharded step's inputs from REAL
    sequences: builds the production position table over the target,
    packs query blocks, derives anchor points from actual seed-word
    matches, and builds the y-drop chunk's fresh state + windows."""
    from ..core.encoding import UPPER_NUC_TO_BITS
    from ..index.postable import build_seed_position_table
    from ..ops.ydrop_exact import fresh_state_np, make_compact_alphabet

    pt = build_seed_position_table(
        target_v, 0, 0, UPPER_NUC_TO_BITS, seed, 1)
    t_codes = UPPER_NUC_TO_BITS[target_v].astype(np.int32)

    nq = n_shards * q_per_shard
    q_codes = np.full((nq, qlen), -1, np.int32)
    for i in range(min(nq, len(queries_v))):
        src = UPPER_NUC_TO_BITS[queries_v[i][:qlen]].astype(np.int32)
        q_codes[i, :len(src)] = src

    # anchors: real seed-word matches (first CSR entry per probe),
    # generated per shard from the shard's OWN query block so that a
    # dp-sharded anchor row always references local queries
    rng = np.random.default_rng(rng_seed)
    A = n_shards * anchors_per_shard
    qflat = q_codes.reshape(-1)
    anchors = []
    for s in range(n_shards):
        blk_lo = s * q_per_shard * qlen
        blk_hi = (s + 1) * q_per_shard * qlen
        got = 0
        tries = 0
        while got < anchors_per_shard and tries < 500 * anchors_per_shard:
            tries += 1
            qpos = int(rng.integers(blk_lo + seed.length,
                                    blk_hi - lanes))
            window = qflat[qpos - seed.length: qpos]
            if (window < 0).any():
                continue
            w = 0
            for c in window:
                w = (w << 2) | int(c)
            packed = int(seed.pack(np.array([w], np.uint64))[0])
            lo = int(pt.csr_start[packed])
            hi = int(pt.csr_start[packed + 1])
            if hi <= lo:
                continue
            pos1 = int(pt.adj_start + pt.step * pt.csr_pos[lo])
            if pos1 + rows + 2 >= len(target_v) or pos1 < 2:
                continue
            anchors.append((pos1, qpos))
            got += 1
        while got < anchors_per_shard:
            anchors.append((2, blk_lo + seed.length))
            got += 1
    anchors12 = np.array(anchors[:A], np.int32)

    code_map, subsmall = make_compact_alphabet(
        [target_v, np.concatenate([q[:qlen] for q in queries_v])
         if len(queries_v) else np.zeros(1, np.uint8)],
        scoring.sub, max_k=16)

    N = np.minimum(len(target_v) - anchors12[:, 0], lanes - 2)
    gap_e = int(scoring.gap_extend)
    gap_oe = int(scoring.gap_open + scoring.gap_extend)
    state, _ = fresh_state_np(N.astype(np.int64), gap_e, gap_oe,
                              y_drop, lanes, A)

    # per-anchor kernel windows from the raw characters
    a_small = np.zeros((A, rows), np.int32)
    b_small = np.zeros((A, lanes), np.int32)
    qraw = np.zeros(nq * qlen, np.uint8)
    for i in range(min(nq, len(queries_v))):
        src = queries_v[i][:qlen]
        qraw[i * qlen: i * qlen + len(src)] = src
    for j, (a1, a2) in enumerate(anchors12):
        src = target_v[a1 + 1: a1 + 1 + rows]
        a_small[j, :len(src)] = code_map[src]
        src = qraw[a2: a2 + lanes]
        b_small[j, :len(src)] = code_map[src]

    csr32 = pt.csr_start.astype(np.int32)
    sub4 = scoring.dna4.astype(np.int32)
    return dict(q_codes=q_codes, t_codes=t_codes, csr_start=csr32,
                sub4=sub4, subsmall=subsmall, anchors12=anchors12,
                state=state, a_small=a_small, b_small=b_small,
                gap_e=gap_e, gap_oe=gap_oe)

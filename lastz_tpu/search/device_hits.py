"""Device-resident seed search: orchestrates ops/hitgen.py so that the
candidate hit list never crosses to the host (reference
seed_hit_search, seed_search.c:322-810 + the simple processor
:1056-1198 + xdrop_extend_seed_hit :2528).

This is the production search path on an attached accelerator.  The
host replay (search/batched.py) remains the oracle and the fallback
for anything the device gate declines; both produce hit-for-hit
identical results to the scalar engine.

Residency & caching:
  * the position-table CSR is uploaded once per table build and cached
    on the PositionTable object (keyed by array identity, so dynamic-
    masking rebuilds invalidate it) — the device analogue of the
    capsule mmap share (capsule.c:6-15);
  * the target's compact-alphabet codes are cached per (sequence,
    alphabet); query codes are uploaded per strand;
  * the 64K diagonal-extent state lives on device for the whole
    search and chains through launches.

Launch plan: query windows are processed in fixed-size chunks; each
chunk's candidate total is computed on device (one scalar fetched),
then sliced into fixed HIT_BUDGET launches whose only outputs are the
compacted threshold survivors.  An overflowing launch (more survivors
than OUT_CAP) leaves the diagonal state untouched and is re-run as
two half-budget ranges.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import GFEX_NO_EXTEND, GFEX_XDROP
from ..core.scoring import entropy
from .batched import _probe_xors, supported as _batched_supported

_DEF_PCHUNK = 1 << 20


def _device_search_enabled() -> bool:
    forced = os.environ.get("LASTZ_TPU_HITGEN", "")
    if forced != "":
        return forced != "0"
    from ..accel import device_enabled
    return device_enabled()


def supported(engine) -> bool:
    if not _batched_supported(engine):
        return False
    if engine.hit_mode not in ("simple", "recover"):
        # twins need the 256K seed-hit queue with global aging — the
        # batched host path (search/twins.py) handles them
        return False
    if engine.hit_mode == "recover" \
            and engine.hp.gf_extend != GFEX_XDROP:
        # matches the batched gate: without an extension the scalar
        # processor's diagEnd/diagActual updates differ
        return False
    if engine.seed.rev_comp:
        return False
    if engine.seed.type == "R" and getattr(
            engine.pt, "csr_resolve", None) is None:
        # overweight seeds need the index's packed resolving words
        # (quantum/capsule-loaded tables may lack them)
        return False
    hp = engine.hp
    sub = engine._sub
    if hp.gf_extend == GFEX_XDROP:
        if sub is None or sub.dtype != np.int64:
            return False
        if np.abs(sub).max() >= (1 << 31):
            return False
        if hp.x_drop >= (1 << 30):
            return False
    if max(len(engine.seq1), len(engine.seq2)) >= (1 << 31):
        return False
    t = engine.hp.hsp_threshold
    if t.t == "S" and abs(t.s) >= (1 << 30):
        return False
    return True


def _current_device():
    """The device new arrays land on (honors jax.default_device, the
    farm-out router's per-query pin)."""
    import jax
    d = jax.config.jax_default_device
    return d if d is not None else jax.devices()[0]


def _pt_device_arrays(pt):
    """CSR arrays on the current device.  Device-built tables
    (DevicePositionTable) are used in place (or copied across the
    mesh for farm-out); host tables are uploaded and cached,
    invalidated whenever the arrays are rebuilt (dynamic masking,
    limiting).  Per-device caching replicates the index across the
    mesh, like the reference capsule replicates it across processes."""
    import jax
    import jax.numpy as jnp
    dev = _current_device()
    native = getattr(pt, "dev_csr_start", None)
    if native is not None and pt.alive is None \
            and pt._host_start is None:
        # device-built table, never mutated on host
        if list(native.devices())[0] == dev:
            return native, pt.dev_csr_pos, None
        cached = getattr(pt, "_hitgen_copies", None)
        if cached is None:
            cached = {}
            pt._hitgen_copies = cached
        if dev not in cached:
            cached[dev] = (jax.device_put(native, dev),
                           jax.device_put(pt.dev_csr_pos, dev))
        return cached[dev] + (None,)
    key = (id(pt.csr_start), id(pt.csr_pos),
           id(pt.alive) if pt.alive is not None else None,
           dev)
    cached = getattr(pt, "_hitgen_dev", None)
    if cached is None or cached.get("id") != key[:3]:
        cached = {"id": key[:3]}
        pt._hitgen_dev = cached
    if key in cached:
        return cached[key]
    csr_start = jnp.asarray(pt.csr_start.astype(np.int32))
    csr_pos = jnp.asarray(pt.csr_pos.astype(np.int32))
    alive = (jnp.asarray(pt.alive.astype(np.uint8))
             if pt.alive is not None else None)
    arrs = (csr_start, csr_pos, alive)
    cached[key] = arrs
    return arrs


_seq_cache: dict = {}


def _seq_device(seq, code_map):
    """Compact-alphabet codes of `seq` on device, padded with SEQ_PAD
    sentinel zeros on both sides so x-drop row slices never clamp
    (cached per device)."""
    import jax.numpy as jnp

    from ..ops.hitgen import SEQ_PAD
    # id() alone is unsafe (reuse after GC); sample three 64-byte
    # windows so equal-length look-alike sequences don't collide
    n2 = len(seq) // 2
    key = (id(seq), seq.tobytes()[:64].__hash__(),
           bytes(seq[n2:n2 + 64]).__hash__(),
           bytes(seq[-64:]).__hash__(), len(seq),
           code_map.tobytes().__hash__(), _current_device())
    hit = _seq_cache.get(key)
    if hit is not None:
        return hit
    host = np.zeros(len(seq) + 2 * SEQ_PAD, np.int8)
    host[SEQ_PAD:SEQ_PAD + len(seq)] = code_map[seq]
    dev = jnp.asarray(host)
    if len(_seq_cache) > 16:
        _seq_cache.clear()
    _seq_cache[key] = dev
    return dev


def device_search(engine, start: int = 0, end: int = 0):
    """Drop-in replacement for SeedSearchEngine.search via the device
    hit generator; returns bases_hit, or None when unsupported."""
    if not supported(engine):
        return None
    import jax
    import jax.numpy as jnp

    from ..ops.hitgen import (
        HIT_BUDGET, OUT_CAP, hit_launch, pack_query_words, pair_counts)
    from ..ops.ydrop_exact import make_compact_alphabet

    if end == 0:
        end = len(engine.seq2)
    seed = engine.seed
    L = seed.length
    if end - start < L:
        return 0
    hp = engine.hp
    no_extend = hp.gf_extend == GFEX_NO_EXTEND

    if no_extend:
        # no scoring needed; a trivial 1-symbol alphabet suffices
        code_map = np.zeros(256, np.int32)
        subsmall = np.zeros((1, 1), np.int32)
    else:
        cmap = make_compact_alphabet(
            [engine.seq1, engine.seq2], engine._sub, max_k=16)
        if cmap is None:
            return None
        code_map, subsmall = cmap
    K = subsmall.shape[0]

    from .. import stats as _stats
    st = _stats.current

    with st.time("hitgen setup"):
        csr_start_d, csr_pos_d, alive_d = _pt_device_arrays(engine.pt)
        seq1_d = _seq_device(engine.seq1, code_map)
        q_codes = engine.char_to_bits[
            engine.seq2[start:end]].astype(np.int8)
        seq2_d = _seq_device(engine.seq2, code_map)
        subflat_d = jnp.asarray(
            np.ascontiguousarray(subsmall.reshape(-1)))

        xors_np = _probe_xors(seed).astype(np.uint32)
        nprobe = len(xors_np)
        xors_d = jnp.asarray(xors_np)

        qdev = jnp.asarray(q_codes)
        packed, valid = pack_query_words(
            qdev, seed.bit_map, L, seed.bits_per_base)
        # overweight (resolving) seeds: pack the demoted bits of each
        # query window on device (same packer, resolve bit map) and
        # upload the index's per-entry resolving words + per-probe
        # transition budgets (seeds.c:8-127; batched.py:185-197)
        has_resolve = seed.type == "R"
        qres = csr_resolve_d = budgets_d = None
        if has_resolve:
            from .batched import _probe_budgets
            resolve_map = tuple(
                (int(src), i)
                for i, src in enumerate(seed.resolve_bits))
            qres, _ = pack_query_words(
                qdev, resolve_map, L, seed.bits_per_base)
            qres = qres.astype(jnp.uint32)
            # hold the host array itself in the cache entry so the
            # identity check can't be fooled by id() reuse after GC
            cached = getattr(engine.pt, "_hitgen_res_dev", None)
            if (cached is None
                    or cached[0] is not engine.pt.csr_resolve
                    or cached[1] != _current_device()):
                cached = (engine.pt.csr_resolve, _current_device(),
                          jnp.asarray(
                              engine.pt.csr_resolve.astype(np.uint32)))
                engine.pt._hitgen_res_dev = cached
            csr_resolve_d = cached[2]
            budgets_d = jnp.asarray(
                _probe_budgets(seed).astype(np.int32))
        num_w = end - start - L + 1
        PCHUNK = min(_DEF_PCHUNK, max(1 << 14, (1 << 24) // nprobe),
                     1 << max(8, (num_w - 1).bit_length()))
        n_chunks = (num_w + PCHUNK - 1) // PCHUNK
        pad = n_chunks * PCHUNK - num_w
        if pad:
            packed = jnp.concatenate(
                [packed, jnp.zeros(pad, packed.dtype)])
            valid = jnp.concatenate([valid, jnp.zeros(pad, bool)])
            if has_resolve:
                qres = jnp.concatenate(
                    [qres, jnp.zeros(pad, qres.dtype)])
        st.words_in_queries += int(jnp.sum(valid))

    # phase 1: per-chunk candidate totals (one small fetch; the pair
    # arrays themselves are recomputed per chunk in phase 2 so only
    # one chunk's expansion is ever resident)
    with st.time("hitgen counts"):
        tots = []
        for c in range(n_chunks):
            pk = jax.lax.dynamic_slice_in_dim(
                packed, c * PCHUNK, PCHUNK)
            vd = jax.lax.dynamic_slice_in_dim(
                valid, c * PCHUNK, PCHUNK)
            _, _, tot = pair_counts(pk, vd, xors_d, csr_start_d)
            tots.append(tot)
        totals = [int(t) for t in jax.device_get(tots)]

    de = jnp.full((65536,), -1, jnp.int32)
    da = jnp.zeros((65536,), jnp.int32)  # diagActual (recover mode)
    recover = engine.hit_mode == "recover"

    # launch budgets: env-overridable; modest sizes for small runs so
    # CPU-backend tests don't pay multi-million-lane launches
    H = int(os.environ.get("LASTZ_TPU_HIT_BUDGET", "0")) or HIT_BUDGET
    total_all = sum(totals)
    while H > (1 << 15) and total_all <= H // 4:
        H //= 2
    out_cap = int(os.environ.get("LASTZ_TPU_HIT_OUTCAP", "0")) \
        or min(OUT_CAP, max(1 << 12, H // 8))

    thresh_is_score = hp.hsp_threshold.t == "S"
    thresh = int(hp.hsp_threshold.s) if thresh_is_score else 0
    use_thresh = thresh_is_score and thresh > 0
    band = engine.band_width if (engine.same_strand
                                 and engine.band_width > 0) else (1 << 30)

    static_kw = dict(
        no_extend=no_extend, self_compare=bool(engine.self_compare),
        same_strand=bool(engine.same_strand), use_thresh=use_thresh,
        has_alive=alive_d is not None, K=K, nprobe=nprobe,
        x_drop=int(hp.x_drop) if not no_extend else 0,
        recover=recover, has_resolve=has_resolve)

    alive_arg = alive_d if alive_d is not None else jnp.zeros(
        1, jnp.uint8)

    common = (seq1_d, seq2_d, subflat_d, csr_pos_d, alive_arg)

    sub = engine._sub
    seq1 = engine.seq1
    seq2 = engine.seq2
    diag_end = engine.diag_end
    bases_hit = 0
    trip_pos = -1
    from ..core.scoring import SCORE_TYPE

    def process_candidates(out_np, n):
        """Host replay of the per-candidate reporting sequence
        (search/batched.py:322-378; the engine is the contract)."""
        nonlocal bases_hit, trip_pos
        (pos1a, pos2a, grpa, lsc, lst, rsc, rst, de_b,
         bind) = [out_np[r, :n] for r in range(9)]
        for i in range(n):
            g = int(grpa[i])
            if trip_pos >= 0 and g > trip_pos:
                engine.limit_exceeded = True
                if engine.on_limit_exceeded is not None:
                    engine.on_limit_exceeded()
                return False
            pos1 = int(pos1a[i])
            pos2 = int(pos2a[i])
            diag = pos1 - pos2
            if no_extend:
                bases_hit += engine._report(pos1, pos2, L, 0)
            elif bind[i]:
                hh = diag & 65535
                diag_end[hh] = int(de_b[i])
                engine._unblocked_left = False
                r = engine._xdrop_extend(pos1, pos2, L)
                if r is not None:
                    bases_hit += engine._report(*r)
                    st.hsps += 1
            else:
                similarity = int(lsc[i]) + int(rsc[i])
                new_pos1 = int(rst[i])
                new_pos2 = new_pos1 - diag
                new_length = new_pos1 - int(lst[i])
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
        return True

    from ..ops.hitgen import expand_chunk

    for c in range(n_chunks):
        total = totals[c]
        if total == 0:
            continue
        chunk_lo = start + c * PCHUNK
        t_setup = st.time("hitgen expand")
        t_setup.__enter__()
        pk = jax.lax.dynamic_slice_in_dim(packed, c * PCHUNK, PCHUNK)
        vd = jax.lax.dynamic_slice_in_dim(valid, c * PCHUNK, PCHUNK)
        qres_slice = None
        if has_resolve:
            qres_slice = jax.lax.dynamic_slice_in_dim(
                qres, c * PCHUNK, PCHUNK)
        cum, ends, _ = pair_counts(pk, vd, xors_d, csr_start_d)
        # one extra H of padding so an overflow-split launch at an
        # unaligned offset can still slice a full window
        n_launches = (total + H - 1) // H
        total_pad = (n_launches + 1) * H
        karr = expand_chunk(cum, total_pad)
        t_setup.__exit__()
        ranges = [(b, min(b + H, total))
                  for b in range(0, total, H)]
        while ranges:
            lo, hi = ranges.pop(0)
            t_launch = st.time("hitgen device")
            t_launch.__enter__()
            kslice = jax.lax.dynamic_slice_in_dim(karr, lo, H)
            de2, da2, out, scalars = hit_launch(
                *common, cum, ends, kslice, de, da,
                jnp.int32(lo), jnp.int32(hi),
                jnp.int32(chunk_lo),
                jnp.int32(engine.pt.adj_start),
                jnp.int32(engine.pt.step), jnp.int32(L),
                jnp.int32(thresh),
                jnp.int32(band),
                jnp.int32(len(engine.seq1)),
                jnp.int32(len(engine.seq2)),
                csr_resolve=csr_resolve_d, q_resolve=qres_slice,
                budgets=budgets_d,
                H=H, out_cap=out_cap, **static_kw)
            # one host round trip per launch: scalars + outputs
            # fetched together (out is small, 9 x out_cap int32; the
            # wasted transfer on an overflow is cheaper than a second
            # synchronisation)
            sc, out_np_full = jax.device_get((scalars, out))
            n_keep = int(sc[0])
            if not int(sc[4]) or n_keep > out_cap:
                # output overflow, or a hash chain longer than the
                # lockstep resolver's cap: discard and re-run as two
                # half-ranges (chain pieces shrink with the range and
                # the diagonal state chains through `de`)
                t_launch.__exit__()
                mid = (lo + hi) // 2
                if mid == lo:
                    return None
                ranges[:0] = [(lo, mid), (mid, hi)]
                continue
            de = de2
            da = da2
            st.raw_seed_hits += int(sc[1])
            st.hash_dropped_hits += int(sc[2])
            st.ungapped_extensions += int(sc[3])
            out_np = out_np_full[:, :n_keep] if n_keep else None
            t_launch.__exit__()
            if n_keep:
                with st.time("hitgen report"):
                    if not process_candidates(out_np, n_keep):
                        return bases_hit
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

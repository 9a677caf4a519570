"""Device-batched gapped extension: glue between the exact y-drop
kernel (ops/ydrop_exact.py) and the sequential accept loop of
gapped_extend (align/ydrop.py; reference gapped_extend.c:1012).

Anchors are extended speculatively on device (both directions batched
in one kernel call), UNCONSTRAINED by previous alignments.  The
accept loop then takes each anchor's device result only when it is
provably identical to what the constrained host DP would produce:

  * the anchor has no bounding segments (msp_left_right found nothing
    on either side), AND
  * no previously accepted alignment's bounding box intersects the
    rectangle the device DP actually explored (expanded by 1).

Masking/bounding only ever REMOVES cells, so the constrained DP
explores a subset of the unconstrained region; if nothing the
constrained pass could see lies in that region, the two are
cell-for-cell identical.  Anything else — bounded anchors, window
overflows, unconverged rows, double-typed scores — falls back to the
host engine for that anchor.  Exactness is never sacrificed; the
device simply takes the (dominant) independent share of the work.

Round-3 architecture (replaces the per-chunk host loop):

  * MEGA-LAUNCH: both sequences' compact codes are uploaded once per
    strand; ops/ydrop_exact.ydrop_mega runs up to `max_blocks` DP
    chunks per launch, gathering windows and re-anchoring on device.
    The per-lane loop scalars are fetched ONCE per launch in a single
    packed transfer (one host round trip per launch instead of one
    per 1024 rows).  Each chunk's row loop is the CUDA kernel of
    ops/ydrop_cuda.py on a GPU and the XLA scan elsewhere
    (accel.gapped_kernel).
  * DEVICE TRACEBACK in one call: traceback_mega_dev walks every
    retained block for the whole batch at once.
  * LAZY SCORE-ORDERED BATCHING: batches are assembled from the NEXT
    anchors in accept (decreasing-score) order that still pass a
    cheap msp_left_right precheck against the current alignment list,
    instead of fixed index-aligned blocks.  Anchors already inside an
    accepted alignment (the common case on conserved segments) are
    never extended — msp_left_right(obi, ·) is monotone: once an
    anchor fails it, it fails forever, so skipping is safe.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..core.scoring import NEG_INFINITY_SCORE

DEFAULT_WIDTH = int(os.environ.get("LASTZ_TPU_YDROP_WIDTH", "768"))
DEFAULT_ROWS = int(os.environ.get("LASTZ_TPU_YDROP_ROWS", "1024"))
DEFAULT_LANES = int(os.environ.get("LASTZ_TPU_YDROP_LANES", "0"))
DEFAULT_BATCH = int(os.environ.get("LASTZ_TPU_YDROP_BATCH", "64"))
DEFAULT_BLOCKS = int(os.environ.get("LASTZ_TPU_YDROP_BLOCKS", "8"))


class DeviceYDrop:
    """Per-strand batched extension cache over a sorted anchor list."""

    def __init__(self, v1, v2, scoring, y_drop, trim_to_peak,
                 traceback_mem, seg_infos,
                 width=None, rows=None, batch=None):
        """seg_infos: list of (anchor1, anchor2, low1, high1, low2,
        high2) in accept order (decreasing score)."""
        self.ok = False
        self.v1 = v1
        self.v2 = v2
        self.trim_to_peak = trim_to_peak
        self.width = width or DEFAULT_WIDTH
        self.rows = rows or DEFAULT_ROWS
        self.batch = batch or DEFAULT_BATCH
        self.max_blocks = DEFAULT_BLOCKS
        self.tb_cap = int(traceback_mem)
        self.seg_infos = seg_infos
        self.y_drop = y_drop
        # callback: may anchor index j still produce an alignment?
        # (set by gapped_extend to an msp_left_right precheck)
        self.precheck = None

        from ..ops.ydrop_exact import MAX_COMP_GAP_E
        if scoring.sub.dtype != np.int64:
            return  # double scores: host only
        if not (0 <= scoring.gap_extend <= MAX_COMP_GAP_E):
            return
        sub = scoring.sub
        if sub.shape != (256, 256):
            return
        if np.abs(sub).max() >= (1 << 31):
            return
        self.gap_e = int(scoring.gap_extend)
        self.gap_oe = int(scoring.gap_open + scoring.gap_extend)
        if abs(self.gap_oe) >= (1 << 30) or int(y_drop) >= (1 << 30):
            return
        if self.tb_cap >= (1 << 31):
            return  # the kernels count traceback cells in int32
        from ..ops.ydrop_exact import make_compact_alphabet
        cmap_sub = make_compact_alphabet([v1, v2], sub, max_k=16)
        if cmap_sub is None:
            return  # exotic alphabet: host only
        self.code_map, self.subsmall = cmap_sub
        # window capacity: must exceed the widest possible band (about
        # 2*yDrop/gapE + drift margin); rows-per-launch is independent
        # because a window-end simply re-anchors the next chunk
        self.lanes = DEFAULT_LANES or (self.width * 2)
        self._results: dict[int, dict] = {}
        self._ops: dict[int, tuple] = {}
        self._computed: set[int] = set()
        self._v1c = self._v2c = None
        self.ok = True
        self.stats_device = 0
        self.stats_host = 0

    # -- batched mega-launch invocation ----------------------------------

    def _ensure_seqs(self):
        if self._v1c is None:
            import jax.numpy as jnp
            self._v1c = jnp.asarray(self.code_map[self.v1].astype(np.int8))
            self._v2c = jnp.asarray(self.code_map[self.v2].astype(np.int8))

    _MAX_CHUNKS = 4096

    def _collect_batch(self, ix):
        """Next up-to-batch anchor indices in accept order, starting
        at ix, skipping anchors already computed or provably dead."""
        idxs = [ix]
        j = ix + 1
        n = len(self.seg_infos)
        while len(idxs) < self.batch and j < n:
            if j not in self._computed and (
                    self.precheck is None or self.precheck(j)):
                idxs.append(j)
            j += 1
        self._computed.update(idxs)
        return idxs

    def _target_args(self, A1, LO1, HI1, REV, row0, rows, max_blocks):
        """Target codes + per-lane seq1 coordinates for one mega
        launch whose lanes currently sit at DP row `row0` (the kernel
        reads seq1 only inside rows [row0, row0 + max_blocks*rows)
        relative to each lane's anchor — see ops/ydrop_exact._mega_one
        a_idx).  Base class: the whole-target device array."""
        import jax.numpy as jnp
        return (self._v1c, jnp.asarray(A1), jnp.asarray(LO1),
                jnp.asarray(HI1))

    def _compute_for(self, ix):
        import jax.numpy as jnp

        from ..accel import gapped_kernel
        from ..ops.ydrop_exact import (
            fresh_state_np, traceback_mega_dev, ydrop_mega)

        self._ensure_seqs()
        idxs = self._collect_batch(ix)
        B = self.batch
        lanes = self.lanes
        # lane layout: [fwd x B (padded), rev x B (padded)]
        A1 = np.zeros(2 * B, np.int32)
        A2 = np.zeros(2 * B, np.int32)
        LO1 = np.zeros(2 * B, np.int32)
        HI1 = np.zeros(2 * B, np.int32)
        LO2 = np.zeros(2 * B, np.int32)
        HI2 = np.zeros(2 * B, np.int32)
        REV = np.zeros(2 * B, bool)
        REV[B:] = True
        M = np.zeros(2 * B, np.int32)
        N = np.zeros(2 * B, np.int32)
        for j in range(B):
            if j < len(idxs):
                a1, a2, low1, high1, low2, high2 = \
                    self.seg_infos[idxs[j]]
            else:
                a1 = a2 = low1 = high1 = low2 = high2 = 0
            for lane in (j, B + j):
                A1[lane] = a1
                A2[lane] = a2
                LO1[lane] = low1
                HI1[lane] = high1
                LO2[lane] = low2
                HI2[lane] = high2
            if j < len(idxs):
                M[j] = high1 - (a1 + 1)
                N[j] = high2 - (a2 + 1)
                M[B + j] = (a1 + 1) - low1
                N[B + j] = (a2 + 1) - low2

        st_np, _ = fresh_state_np(
            N.astype(np.int64), self.gap_e, self.gap_oe,
            int(self.y_drop), lanes, 2 * B)
        state = {k: jnp.asarray(v) for k, v in st_np.items()}
        prev_off = jnp.zeros(2 * B, jnp.int32)
        kw = dict(gap_e=self.gap_e, gap_oe=self.gap_oe,
                  y_drop=int(self.y_drop), lanes=lanes, rows=self.rows,
                  max_blocks=self.max_blocks,
                  alpha=self.subsmall.shape[0],
                  trim_to_peak=self.trim_to_peak, tb_cap=self.tb_cap,
                  kernel=gapped_kernel())
        subsmall = jnp.asarray(self.subsmall)

        # target codes + lane coordinates for this launch: the
        # sharded-target subclass (align/ydrop_sharded.py) extracts
        # per-lane read-band windows from the mesh residency and
        # remaps the coordinates onto them; the base class hands the
        # whole-target device array through unchanged
        v1c0, A1j, LO1j, HI1j = self._target_args(
            A1, LO1, HI1, REV, np.zeros(2 * B, np.int64),
            self.rows, self.max_blocks)
        args = (v1c0, self._v2c, A1j, jnp.asarray(A2),
                LO1j, HI1j, jnp.asarray(LO2), jnp.asarray(HI2),
                jnp.asarray(REV), jnp.asarray(M), jnp.asarray(N))

        from .. import stats as _stats
        _x = _stats.current.extra
        t_launch = _stats.current.time("ydrop device")
        t_launch.__enter__()
        state, prev_off, packed, tb_all, row_lo, row_hi, col0 = \
            ydrop_mega(*args, state, prev_off, subsmall,
                       with_tb=True, **kw)
        pk = np.asarray(packed).copy()
        done1 = pk[3].astype(bool)
        nblk1 = pk[12].copy()
        blocks = self.max_blocks
        launches = 1
        cont_lanes = 0
        # score-only continuation for extensions beyond the retained
        # blocks (their traceback falls back to the host, as before).
        # Live lanes are COMPACTED into a fresh small batch so done
        # anchors stop occupying kernel lanes (padded to a lane
        # multiple; the pad lanes are marked done).
        undone = np.nonzero(~pk[3].astype(bool))[0]
        if len(undone):
            import jax.numpy as jnp2
            # bucket to powers of two so compacted batches reuse a
            # handful of jit shapes
            nlive = len(undone)
            padded = 8
            while padded < nlive:
                padded *= 2
            npad = padded - nlive
            sel = np.concatenate(
                [undone, np.zeros(npad, np.int64)]).astype(np.int32)
            selj = jnp2.asarray(sel)
            # lane-invariant args reselected once; target codes and
            # seq1 coordinates are rebuilt per launch (the sharded
            # subclass must re-extract windows as lanes advance)
            c_fixed = tuple(args[i][selj] for i in (3, 6, 7, 8, 9, 10))
            A1s, LO1s = A1[sel], LO1[sel]
            HI1s, REVs = HI1[sel], REV[sel]
            row_c = pk[0][sel].astype(np.int64)
            c_state = {k: v[selj] for k, v in state.items()}
            if npad:
                padmask = np.zeros(len(sel), bool)
                padmask[nlive:] = True
                c_state["done"] = jnp2.asarray(
                    np.asarray(c_state["done"]) | padmask)
            c_prev = prev_off[selj]
            while blocks < self._MAX_CHUNKS:
                v1c_c, A1c, LO1c, HI1c = self._target_args(
                    A1s, LO1s, HI1s, REVs,
                    np.maximum(row_c - 1, 0), self.rows,
                    self.max_blocks)
                c_args = (v1c_c, args[1], A1c, c_fixed[0], LO1c,
                          HI1c, c_fixed[1], c_fixed[2], c_fixed[3],
                          c_fixed[4], c_fixed[5])
                c_state, c_prev, c_packed, _, _, _, _ = ydrop_mega(
                    *c_args, c_state, c_prev, subsmall,
                    with_tb=False, **kw)
                cpk = np.asarray(c_packed)
                row_c = cpk[0].astype(np.int64)
                blocks += self.max_blocks
                launches += 1
                cont_lanes += len(sel)
                if cpk[3].astype(bool).all():
                    break
            # scatter compacted results back into the packed view
            pk[:, sel[:nlive]] = cpk[:, :nlive]
        # utilization / fallback visibility (--stats):
        # rows launched counts every lane of every block swept; rows
        # used counts DP rows the lanes actually consumed
        real = np.zeros(2 * B, bool)
        real[: len(idxs)] = True
        real[B: B + len(idxs)] = True
        _x["ydrop launches"] = _x.get("ydrop launches", 0) + launches
        _x["ydrop rows used"] = (_x.get("ydrop rows used", 0)
                                 + int(pk[2][real].sum()))
        _x["ydrop rows launched"] = (
            _x.get("ydrop rows launched", 0)
            + (2 * B + cont_lanes) * self.max_blocks * self.rows)
        tb_redo = int((real & ~done1).sum())
        if tb_redo:
            # extensions longer than the retained traceback blocks:
            # device score kept, extension redone on host
            _x["ydrop tb host-redo"] = (
                _x.get("ydrop tb host-redo", 0) + tb_redo)

        small = dict(
            row=pk[0], LY=pk[1], rows_used=pk[2], done=pk[3],
            status=pk[4], best=pk[5], end1=pk[6], end2=pk[7],
            bscore=pk[8], bflag=pk[9].astype(bool), tbp=pk[10],
            maxRY=pk[11])
        small["score"] = np.where(small["bflag"], small["bscore"],
                                  small["best"])

        # device traceback over the retained blocks, one call
        want = done1
        cap = self.max_blocks * self.rows + lanes + 512
        ops_d, n_d, row_d, col_d = traceback_mega_dev(
            tb_all, row_lo, row_hi, col0, jnp.asarray(nblk1),
            jnp.asarray(small["end1"].astype(np.int32)),
            jnp.asarray(small["end2"].astype(np.int32)),
            jnp.asarray(want), cap=cap)
        meta = np.asarray(jnp.stack([
            n_d, row_d, col_d]))
        n_np, row_np, col_np = meta[0], meta[1], meta[2]
        t_launch.__exit__()
        ops_ok = want & (n_np < cap) & (row_np <= 0) & (col_np <= 0)
        ops_np = np.asarray(ops_d)

        code = {1: "S", 2: "I", 3: "D"}
        for j, k in enumerate(idxs):
            fwd = {key: small[key][j] for key in small}
            rev = {key: small[key][B + j] for key in small}
            fwd["ops_ok"] = bool(ops_ok[j])
            rev["ops_ok"] = bool(ops_ok[B + j])
            self._results[k] = {"fwd": fwd, "rev": rev}
            of = [code[int(c)] for c in ops_np[j, : n_np[j]]] \
                if ops_ok[j] else []
            orv = [code[int(c)] for c in ops_np[B + j, : n_np[B + j]]] \
                if ops_ok[B + j] else []
            self._ops[k] = (of, orv)

    def result_for(self, ix):
        if ix not in self._results:
            self._compute_for(ix)
        return self._results[ix]

    def release(self, ix):
        """Drop an anchor's cached result/ops (host-side; the device
        traceback buffers are freed at the end of each batch)."""
        self._results.pop(ix, None)
        self._ops.pop(ix, None)

    # -- safety ----------------------------------------------------------

    def explored_rect(self, ix):
        """Sequence-coordinate rectangle the device DP touched, both
        directions, expanded by 1 (for the L/R bound column offsets)."""
        res = self._results[ix]
        a1, a2 = self.seg_infos[ix][0], self.seg_infos[ix][1]
        rf = int(res["fwd"]["rows_used"])
        cf = int(res["fwd"]["maxRY"])
        rr = int(res["rev"]["rows_used"])
        cr = int(res["rev"]["maxRY"])
        return (a1 - rr - 1, a1 + rf + 1, a2 - cr - 1, a2 + cf + 1)

    def statuses_ok(self, ix):
        from ..ops.ydrop_exact import ST_TRUNCATED
        res = self._results[ix]
        for w in ("fwd", "rev"):
            st = int(res[w]["status"])
            if st & ~ST_TRUNCATED:
                return False
            if not res[w]["ops_ok"]:
                return False
        return True

    # -- composing a device alignment ------------------------------------

    def compose(self, aligner, ix, anchor1, anchor2):
        """Replicates YDropAligner.ydrop_align from device results
        (align/ydrop.py:746; gapped_extend.c:2459)."""
        from .edit_script import EditScript

        res = self.result_for(ix)
        rev, fwd = res["rev"], res["fwd"]

        self._maybe_report_truncation(aligner, rev, True,
                                      anchor1, anchor2)
        self._maybe_report_truncation(aligner, fwd, False,
                                      anchor1, anchor2)

        ops_fwd, ops_rev = self._ops[ix]
        ops_left = ops_rev
        start1 = anchor1 + 1 - int(rev["end1"])
        start2 = anchor2 + 1 - int(rev["end2"])

        ops_right = ops_fwd
        stop1 = anchor1 + int(fwd["end1"])
        stop2 = anchor2 + int(fwd["end2"])

        script = EditScript()
        for op in ops_left:
            script.add(op, 1)
        for op in reversed(ops_right):
            script.add(op, 1)

        s = int(rev["score"]) + int(fwd["score"])
        if script.ops:
            if script.ops[0][0] != "S":
                start1, start2, s = aligner._lop_initial(
                    script, start1, start2)
            if script.ops and script.ops[-1][0] != "S":
                stop1, stop2, s = aligner._lop_final(
                    script, start1, start2, stop1, stop2)
        return s, start1, start2, stop1, stop2, script

    def _maybe_report_truncation(self, aligner, res, reversed_,
                                 anchor1, anchor2):
        from ..ops.ydrop_exact import ST_TRUNCATED
        if not (int(res["status"]) & ST_TRUNCATED):
            return
        if not aligner.report_truncations:
            return  # --notruncationreport
        end1, end2 = int(res["end1"]), int(res["end2"])
        if not reversed_:
            sys.stderr.write(
                f"truncating alignment ending at ({end1 + anchor1 + 1}"
                f",{end2 + anchor2 + 1});")
        else:
            sys.stderr.write(
                f"truncating alignment starting at ({anchor1 + 2 - end1}"
                f",{anchor2 + 2 - end2});")
        sys.stderr.write(f"  anchor at ({anchor1},{anchor2})\n")
        if not aligner.truncation_reported:
            aligner.truncation_reported = True
            sys.stderr.write(
                "truncation can be reduced by increasing traceback"
                " memory\n")

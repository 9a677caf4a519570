"""Gapped (y-drop) extension over a MESH-SHARDED target: no device
ever holds the whole target's codes, only its shard plus halo
(search/sharded_mesh.MeshShardedIndex residency).

This is the gapped-stage half of the beyond-HBM story (the reference
handles over-sized targets with wider-address builds, lastz_32/40,
/root/reference/src/Makefile tiers; on an accelerator the equivalent
limit is device memory, and the answer is sharding over the mesh).  The seed/HSP half
already runs shard-locally (search/sharded_mesh.py); here the y-drop
kernel does too, exactly:

  * ops/ydrop_exact._mega_one reads seq1 only inside each lane's
    per-launch READ BAND — rows [row0, row0 + max_blocks*rows)
    relative to the anchor, masked by [low1, high1) — so one launch
    needs one bounded window per lane, never the whole target.
  * extract_target_windows: a shard_map owner-gather pulls each
    lane's window out of the shard-resident code slices (the owner is
    the shard whose owned interval contains the window key; its halo
    must cover the launch reach, asserted below) and psum-merges the
    per-shard contributions into a replicated (B, Wt) batch.
  * ShardedTargetYDrop remaps each lane's (anchor1, low1, high1) onto
    the CONCATENATED windows — a "virtual target" of length B*Wt —
    and runs the unmodified mega kernel on it.  The kernel reads the
    same codes at the same (remapped) indices, so scores, traceback,
    and termination are bit-identical to the whole-target path
    (asserted lane-for-lane in tests/test_ydrop_sharded.py).

Residency sizing rule: index.halo + 1 >= max_blocks*rows + 8 (one
launch's reach).  The defaults satisfy it: LASTZ_TPU_SHARD_HALO=32768
vs 8*1024+8.  Continuation launches re-extract windows at the lanes'
advanced rows, so total extension length is unbounded as before.
"""

from __future__ import annotations

import numpy as np

from .ydrop_device import DeviceYDrop

# jitted extraction programs keyed by (mesh id, Wt, cmax, B)
_PROGS: dict = {}


def _extract_program(mesh, Wt: int, cmax: int):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..ops.hitgen import SEQ_PAD

    def body(codes, res_lo, cov_lo, cov_hi, keys, win_lo):
        codes = codes[0]                       # (cmax,) this shard
        rl = res_lo[0].astype(jnp.int32)
        own = (keys >= cov_lo[0]) & (keys < cov_hi[0])   # (B,)
        rel = jnp.clip(win_lo - (rl - SEQ_PAD),
                       0, cmax - Wt).astype(jnp.int32)
        wins = jax.vmap(
            lambda r: jax.lax.dynamic_slice(codes, (r,), (Wt,)))(rel)
        wins = jnp.where(own[:, None], wins, 0)
        return jax.lax.psum(wins, "shard")

    specs = dict(mesh=mesh,
                 in_specs=(P("shard"), P("shard"), P("shard"),
                           P("shard"), P(None), P(None)),
                 out_specs=P(None))
    try:
        sm = jax.shard_map(body, check_vma=False, **specs)
    except Exception:
        from jax.experimental.shard_map import shard_map
        sm = shard_map(body, check_rep=False, **specs)
    return jax.jit(sm)


def extract_target_windows(index, win_lo: np.ndarray,
                           keys: np.ndarray, Wt: int):
    """(B, Wt) compact codes for absolute windows [win_lo, win_lo+Wt)
    gathered ON THE MESH from the shard-resident slices.  `keys` picks
    each window's owning shard (a point inside the owned cover that
    the window provably stays within halo distance of)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    cmax = int(index.codes_d.shape[1])
    if cmax < Wt:
        raise ValueError("shard residency narrower than the window")
    if getattr(index, "_cov_dev", None) is None:
        import jax
        put = lambda a: jax.device_put(  # noqa: E731
            a, NamedSharding(index.mesh, P("shard")))
        index._cov_dev = (
            put(jnp.asarray(index.cov[:-1].astype(np.int32))),
            put(jnp.asarray(index.cov[1:].astype(np.int32))))
    cov_lo, cov_hi = index._cov_dev
    key = (id(index.mesh), Wt, cmax, len(win_lo))
    prog = _PROGS.get(key)
    if prog is None:
        prog = _PROGS[key] = _extract_program(index.mesh, Wt, cmax)
    return prog(index.codes_d, index.res_lo_d, cov_lo, cov_hi,
                jnp.asarray(keys.astype(np.int32)),
                jnp.asarray(win_lo.astype(np.int32)))


class ShardedTargetYDrop(DeviceYDrop):
    """DeviceYDrop whose kernel target comes from the mesh residency.

    Construction mirrors DeviceYDrop but takes the MeshShardedIndex
    first; the host seq1 bytes are still needed for the base-class
    parameter checks (host RAM, not HBM — the device never sees
    them).  Falls back to ok=False when the residency halo cannot
    cover one launch's read band."""

    def __init__(self, index, v1, v2, scoring, y_drop, trim_to_peak,
                 traceback_mem, seg_infos, **kwargs):
        self.index = index
        super().__init__(v1, v2, scoring, y_drop, trim_to_peak,
                         traceback_mem, seg_infos, **kwargs)
        if not self.ok:
            return
        # the kernel must read the same compact codes the shards hold
        self.code_map = index.code_map
        self.subsmall = index.subsmall
        self._v1c = self._v2c = None
        wt = self.max_blocks * self.rows + 8
        if index.halo + 1 < wt or index.n < wt:
            self.ok = False

    def _ensure_seqs(self):
        if self._v2c is None:
            import jax.numpy as jnp
            self._v2c = jnp.asarray(
                self.code_map[self.v2].astype(np.int8))

    def _target_args(self, A1, LO1, HI1, REV, row0, rows, max_blocks):
        import jax.numpy as jnp
        n = self.index.n
        B = len(A1)
        Wt = max_blocks * rows + 8
        a1 = A1.astype(np.int64)
        row0 = row0.astype(np.int64)
        # per-lane read band start (fwd reads go up from a1+1+row0,
        # rev reads go down from a1-row0); clamping only sheds
        # positions the kernel masks anyway (fwd: < high1; rev: the
        # band never exceeds a1 <= n-1)
        win = np.where(REV, a1 - row0 - (Wt - 1), a1 + 1 + row0)
        win = np.clip(win, 0, max(0, n - Wt))
        keys = np.clip(np.where(REV, win + Wt - 1, win), 0, n - 1)
        wins = extract_target_windows(self.index, win, keys, Wt)
        # virtual target: lane j's window occupies [j*Wt, (j+1)*Wt);
        # the remap is affine, so a_idx = a1' +- (row_base + r) lands
        # on the same code the absolute index would have read
        vbase = np.arange(B, dtype=np.int64) * Wt
        A1v = vbase + (a1 - win)
        LO1v = vbase + np.clip(LO1.astype(np.int64) - win, 0, Wt)
        HI1v = vbase + np.clip(HI1.astype(np.int64) - win, 0, Wt)
        # the mesh-replicated output is re-placed for the (single
        # device) kernel launch; windows are bounded (B*Wt codes), so
        # this hop is small — across cards the launch would instead
        # move the windows by device_put onto the kernel's device
        v1c = jnp.asarray(np.asarray(wins).reshape(B * Wt))
        return (v1c,
                jnp.asarray(A1v.astype(np.int32)),
                jnp.asarray(LO1v.astype(np.int32)),
                jnp.asarray(HI1v.astype(np.int32)))

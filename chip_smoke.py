#!/usr/bin/env python
"""Smoke run of the aligner's device path on NVIDIA GPUs.

    python chip_smoke.py          one card: device, kernel, hits, e2e
    python chip_smoke.py --four   four cards: query farm-out vs one card
    python chip_smoke.py --phases kernel,hits   a subset (one card)

Phases, each printing one line of results (the first failure exits
nonzero and prints no result):

  device  JAX platform, device kind and count; the card's name and
          power limit from nvidia-smi.  Fails unless JAX runs on a GPU.
  kernel  the CUDA y-drop chunk kernel against XLA's ydrop_chunk at the
          production shapes (lanes 1536, rows 1024, 64 anchors x 2
          directions) on anchors from the smoke pair: final state and
          link bytes bit-identical; the `gpu`-marked tests; both
          kernels' ydrop_mega (max_blocks 8) timed, with band cells/s
          with traceback; scores and end cells against the native host
          sweep.
  hits    device hit generation against the native host hit_sweep on
          the pair's first 2 Mbp: hit-for-hit identical.
  e2e     the 12 Mbp pair through parse_options / Pipeline with the
          device stages (the GPU default), cold then warm, and with
          LASTZ_TPU_DEVICE=0: LAV identical; stage timers, device/host
          extension counts, peak device memory, set-up time.
  four    (--four only) the same pipeline farmed over four cards
          (LASTZ_TPU_FARM=1) against one card: byte-identical output.

The pair is generated from seed 42 in the shape of bench.py's
ensure_pair: conserved 2-6 kbp segments, 150 per Mbp, at 72-85%
identity with 1% insertions and 1% deletions, in random background.
The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

SMOKE_BP = 12_000_000
HITS_BP = 2_000_000
Y_DROP = 9400          # LASTZ default: gap open + 300 x gap extend
DEVICE_ENV = {"LASTZ_TPU_DEVICE": ""}   # the platform default


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, text):
    print(f"{phase}: {text}", flush=True)


def peak_bytes():
    import jax
    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def make_pair(bp, seed=42):
    """Target of `bp` random bases; query of 150 conserved segments per
    Mbp, each preceded by 1-5 kbp of unrelated sequence.  Returns
    (target, query, segs) with segs rows (t_start, t_len, q_start)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    t = alpha[rng.integers(0, 4, bp)]
    parts, segs, qpos = [], [], 0
    for _ in range(150 * (bp // 1_000_000)):
        L = int(rng.integers(2000, 6000))
        p = int(rng.integers(0, bp - L))
        f = int(rng.integers(1000, 5000))
        parts.append(alpha[rng.integers(0, 4, f)])
        qpos += f
        ident = 0.72 + 0.13 * rng.random()
        seg = t[p:p + L]
        r = rng.random(L)
        ins = r < 0.01
        keep = r >= 0.02
        base = np.where(rng.random(L) < 1 - ident,
                        alpha[rng.integers(0, 4, L)], seg)
        n_out = keep.astype(np.int64) + ins
        start = np.cumsum(n_out) - n_out
        out = np.empty(int(n_out.sum()), np.uint8)
        out[start[ins]] = alpha[rng.integers(0, 4, int(ins.sum()))]
        out[(start + ins)[keep]] = base[keep]
        parts.append(out)
        segs.append((p, L, qpos))
        qpos += len(out)
    return t, np.concatenate(parts), segs


def write_fasta(path, name, s):
    import numpy as np
    n = len(s)
    pad = (-n) % 80
    rows = np.concatenate([s, np.full(pad, ord("\n"), np.uint8)])
    rows = rows.reshape(-1, 80)
    body = np.concatenate(
        [rows, np.full((len(rows), 1), ord("\n"), np.uint8)], axis=1)
    data = body.tobytes()
    if pad:
        data = data[:len(data) - pad - 1] + b"\n"
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n" + data)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def nvidia_smi():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def phase_device(n_cards):
    import jax
    try:
        devs = jax.devices()
    except Exception as e:  # JAX_PLATFORMS=cuda with no usable GPU
        raise SmokeFailure(f"JAX found no GPU: {type(e).__name__}: {e}")
    d = devs[0]
    check(d.platform == "gpu",
          f"JAX runs on {d.platform!r}, not on a GPU")
    check(len(devs) >= n_cards,
          f"{len(devs)} GPU(s) visible, {n_cards} needed")
    cards = nvidia_smi()
    print(f"card: {cards[0]}", flush=True)
    say("device", f"platform={d.platform} kind={d.device_kind!r} "
        f"count={len(devs)} nvidia-smi={cards}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def _pytest_gpu():
    """Run the `gpu`-marked tests in this process, on the card."""
    import pytest

    class Count:
        passed = failed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1
            elif report.failed:
                Count.failed += 1
            elif report.skipped:
                Count.skipped += 1

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly",
                      os.path.join(HERE, "tests", "test_ydrop_cuda.py")],
                     plugins=[Count()])
    check(rc == 0 and Count.failed == 0 and Count.skipped == 0
          and Count.passed > 0,
          f"gpu tests: rc={rc} passed={Count.passed} "
          f"failed={Count.failed} skipped={Count.skipped}")
    return Count.passed


def _anchor_lanes(t, q, segs, n):
    """(A1, A2, REV, M, N) for n anchors at segment midpoints, forward
    lanes first, then the same anchors reversed."""
    import numpy as np
    a1 = np.array([p + L // 2 for p, L, _ in segs[:n]], np.int64)
    a2 = np.array([qs + L // 2 for _, L, qs in segs[:n]], np.int64)
    A1 = np.concatenate([a1, a1])
    A2 = np.concatenate([a2, a2])
    REV = np.repeat([False, True], n)
    M = np.where(REV, A1 + 1, len(t) - (A1 + 1))
    N = np.where(REV, A2 + 1, len(q) - (A2 + 1))
    return A1, A2, REV, M, N


def _chunk_windows(t, q, code_map, A1, A2, REV, rows, lanes):
    """First-chunk row/column codes (row_base 0, b_off 0), with the
    index arithmetic of ydrop_exact._mega_one."""
    import numpy as np
    r = np.arange(rows)[None, :]
    c = np.arange(lanes)[None, :]
    a_idx = np.where(REV[:, None], A1[:, None] - r, A1[:, None] + 1 + r)
    a_ok = (a_idx >= 0) & (a_idx < len(t))
    a_win = np.where(a_ok, code_map[t[np.clip(a_idx, 0, len(t) - 1)]], 0)
    b_idx = np.where(REV[:, None], A2[:, None] + 1 - c, A2[:, None] + c)
    b_ok = (b_idx >= 0) & (b_idx < len(q)) & ~(REV[:, None] & (c < 1))
    b_win = np.where(b_ok, code_map[q[np.clip(b_idx, 0, len(q) - 1)]], 0)
    return a_win.astype(np.int32), b_win.astype(np.int32)


def phase_kernel(t, q, segs):
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from lastz_tpu.align.ydrop import YDropAligner
    from lastz_tpu.align.ydrop_device import (
        DEFAULT_BATCH, DEFAULT_BLOCKS, DEFAULT_ROWS, DEFAULT_WIDTH)
    from lastz_tpu.core.scoring import new_dna_score_set
    from lastz_tpu.ops import ydrop_cuda
    from lastz_tpu.ops.ydrop_exact import (
        STATE_KEYS, fresh_state_np, make_compact_alphabet, ydrop_chunk,
        ydrop_mega)

    t0 = time.perf_counter()
    ydrop_cuda.build()
    build_s = time.perf_counter() - t0
    n_tests = _pytest_gpu()

    sc = new_dna_score_set()
    code_map, subsmall = make_compact_alphabet([t, q], sc.sub)
    ge, goe = int(sc.gap_extend), int(sc.gap_open + sc.gap_extend)
    lanes, rows, B = 2 * DEFAULT_WIDTH, DEFAULT_ROWS, DEFAULT_BATCH
    A1, A2, REV, M, N = _anchor_lanes(t, q, segs, B)
    st_np, _ = fresh_state_np(N, ge, goe, Y_DROP, lanes, 2 * B)
    tb_cap = 80 * 1024 * 1024
    kw = dict(gap_e=ge, gap_oe=goe, y_drop=Y_DROP, lanes=lanes,
              rows=rows, alpha=subsmall.shape[0], trim_to_peak=True,
              tb_cap=tb_cap)
    sub_d = jnp.asarray(subsmall)

    # one chunk from the fresh state: CUDA kernel vs XLA's ydrop_chunk
    a_win, b_win = _chunk_windows(t, q, code_map, A1, A2, REV, rows,
                                  lanes)
    z = jnp.zeros(2 * B, jnp.int32)
    cargs = (jnp.asarray(a_win), jnp.asarray(b_win), z, z,
             jnp.asarray(M.astype(np.int32)),
             jnp.asarray(N.astype(np.int32)),
             {k: jnp.asarray(v) for k, v in st_np.items()})
    want = ydrop_chunk(*cargs, sub_d, **kw)
    one = functools.partial(ydrop_cuda.chunk_one, **kw)
    got = jax.jit(jax.vmap(
        lambda a, b, bo, sh, m, n, s: one(a, b, bo, sh, m, n, s,
                                          sub_d)))(*cargs)
    for k in STATE_KEYS:
        check(np.array_equal(np.asarray(got[0][k]),
                             np.asarray(want[0][k])),
              f"chunk state {k} differs from XLA's ydrop_chunk")
    check(np.array_equal(np.asarray(got[1]), np.asarray(want[1])),
          "chunk link bytes differ from XLA's ydrop_chunk")
    del got, want

    # mega-launches, both kernels, timed in turns
    v1c = jnp.asarray(code_map[t].astype(np.int8))
    v2c = jnp.asarray(code_map[q].astype(np.int8))
    i32 = lambda x: jnp.asarray(np.asarray(x).astype(np.int32))
    margs = (v1c, v2c, i32(A1), i32(A2), z, jnp.full(2 * B, len(t)),
             z, jnp.full(2 * B, len(q)), jnp.asarray(REV), i32(M),
             i32(N))
    mkw = dict(kw, max_blocks=DEFAULT_BLOCKS)

    def mega(kernel):
        state = {k: jnp.asarray(v) for k, v in st_np.items()}
        t0 = time.perf_counter()
        out = ydrop_mega(*margs, state, z, sub_d, **mkw, kernel=kernel)
        jax.block_until_ready(out)
        return time.perf_counter() - t0, out

    compile_s = {k: mega(k)[0] for k in ("xla", "cuda")}
    secs = {"xla": [], "cuda": []}
    outs = {}
    for kernel in ("xla", "cuda", "cuda", "xla"):
        dt, outs[kernel] = mega(kernel)
        secs[kernel].append(dt)
    x, c = outs["xla"], outs["cuda"]
    for k in STATE_KEYS:
        check(np.array_equal(np.asarray(x[0][k]), np.asarray(c[0][k])),
              f"mega state {k}: CUDA differs from XLA")
    for i, name in enumerate(("prev_off", "packed", "tb_all", "row_lo",
                              "row_hi", "col0"), start=1):
        check(np.array_equal(np.asarray(x[i]), np.asarray(c[i])),
              f"mega {name}: CUDA differs from XLA")
    packed = np.asarray(c[2])
    band = int((packed[10].astype(np.int64) - st_np["tbp"]).sum())
    rate = {k: band / min(v) for k, v in secs.items()}
    del x, c, outs

    # scores and end cells against the native host sweep
    done, status = packed[3].astype(bool), packed[4]
    score = np.where(packed[9].astype(bool), packed[8], packed[5])
    al = YDropAligner(t, q, sc, Y_DROP, True, tb_cap)
    n_cmp = 0
    for j in np.nonzero(done & (status == 0))[0]:
        s, e1, e2, _ = al.one_sided(bool(REV[j]), int(A1[j]), int(A2[j]),
                                    int(M[j]), int(N[j]))
        check((int(score[j]), int(packed[6][j]), int(packed[7][j]))
              == (int(s), int(e1), int(e2)),
              f"lane {j}: device (score, end) differs from host sweep")
        n_cmp += 1
    check(n_cmp >= B, f"only {n_cmp} lanes comparable with the host")
    peak = peak_bytes()
    say("kernel",
        f"build={build_s:.1f}s gpu_tests_passed={n_tests} "
        f"chunk(lanes={lanes},rows={rows},batch={2 * B})=bit-identical "
        f"mega(max_blocks={DEFAULT_BLOCKS}) compile_s="
        f"{json.dumps({k: round(v, 2) for k, v in compile_s.items()})} "
        f"seconds={json.dumps(secs)} band_cells={band} "
        f"Gcells_per_s(with traceback)="
        f"{json.dumps({k: round(v / 1e9, 4) for k, v in rate.items()})} "
        f"host_sweep_match={n_cmp}/{2 * B} peak_bytes_in_use={peak}")


def phase_hits(t, q):
    from lastz_tpu import stats
    from lastz_tpu.config import GFEX_XDROP, ScoreThreshold
    from lastz_tpu.core.encoding import UPPER_NUC_TO_BITS
    from lastz_tpu.core.scoring import new_dna_score_set
    from lastz_tpu.core.seeds import parse_seed
    from lastz_tpu.index.postable import build_seed_position_table
    from lastz_tpu.search.device_hits import device_search
    from lastz_tpu.search.engine import (HitProcessorParams,
                                         SeedSearchEngine)
    from lastz_tpu.search.native_sweep import native_hit_search

    s1, s2 = t[:HITS_BP], q[:HITS_BP]
    seed = parse_seed("1110100110010101111", with_trans=1)
    pt = build_seed_position_table(s1, 0, 0, UPPER_NUC_TO_BITS, seed, 1)
    hp = HitProcessorParams(gf_extend=GFEX_XDROP,
                            scoring=new_dna_score_set(), x_drop=910,
                            hsp_threshold=ScoreThreshold("S", 3000))

    def collect(search):
        hits = []
        eng = SeedSearchEngine(
            s1, pt, s2, seed, UPPER_NUC_TO_BITS, hp,
            lambda p1, p2, ln, s: hits.append((p1, p2, ln, s)) or ln)
        st = stats.reset()
        t0 = time.perf_counter()
        r = search(eng, 0, len(s2))
        dt = time.perf_counter() - t0
        check(r is not None, f"{search.__name__} declined the job")
        return hits, dt, st

    collect(device_search)  # compiles
    dev, dev_s, st = collect(device_search)
    host, host_s, _ = collect(native_hit_search)
    check(len(host) > 0, "no HSPs in the hits pair")
    check(dev == host, f"device hits differ from hit_sweep "
          f"({len(dev)} vs {len(host)})")
    timers = {k: round(v, 3) for k, v in st.timers.items()}
    say("hits", f"pair={HITS_BP}x{HITS_BP} hsps={len(dev)} identical "
        f"device_s={dev_s:.3f} host_hit_sweep_s={host_s:.3f} "
        f"raw_seed_hits={st.raw_seed_hits} timers={json.dumps(timers)}")


def _run_pipeline(args, env):
    from lastz_tpu import stats
    from lastz_tpu.cli import parse_options
    from lastz_tpu.pipeline import Pipeline
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        buf = io.StringIO()
        t0 = time.perf_counter()
        Pipeline(parse_options(list(args)), buf).run()
        dt = time.perf_counter() - t0
        return buf.getvalue(), dt, stats.current
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _lav_body(text):
    """LAV without the command-line stanza."""
    return [ln for ln in text.splitlines() if not ln.startswith("d {")]


def phase_e2e(t, q, tmp, bp):
    from lastz_tpu.ops import ydrop_cuda
    tf, qf = os.path.join(tmp, "t.fa"), os.path.join(tmp, "q.fa")
    write_fasta(tf, "t", t)
    write_fasta(qf, "q", q)
    args = [tf, qf, "--format=lav"]
    build0 = ydrop_cuda.build_seconds
    cold, cold_s, _ = _run_pipeline(args, DEVICE_ENV)
    dev, warm_s, st = _run_pipeline(args, DEVICE_ENV)
    host, host_s, hst = _run_pipeline(args, {"LASTZ_TPU_DEVICE": "0"})
    check(cold == dev, "cold and warm device runs differ")
    check(dev.count("\na {") > 0, "no alignments")
    check(dev == host, "device LAV differs from the host engine's")
    peak = peak_bytes()
    ext = {k: v for k, v in st.extra.items() if k.startswith("dev-skip")
           or k.startswith("ydrop")}
    rnd = lambda d: {k: round(v, 3) for k, v in d.timers.items()}
    say("e2e", f"pair={len(t)}x{len(q)} (rung {bp // 1_000_000} Mbp) "
        f"LAV identical to LASTZ_TPU_DEVICE=0, "
        f"alignments={dev.count(chr(10) + 'a {')} "
        f"cold_s={cold_s:.2f} warm_s={warm_s:.2f} "
        f"setup_s={cold_s - warm_s + ydrop_cuda.build_seconds - build0:.2f} "
        f"host_s={host_s:.2f} stats_device={st.gapped_device} "
        f"stats_host={st.gapped_host} counters={json.dumps(ext)} "
        f"timers={json.dumps(rnd(st))} host_timers={json.dumps(rnd(hst))} "
        f"peak_bytes_in_use={peak}")


def phase_four(t, q, tmp):
    """Farm-out over four cards against the same job on one card."""
    import jax
    tf, qf = os.path.join(tmp, "t.fa"), os.path.join(tmp, "q.fa")
    n_t = 4_000_000
    write_fasta(tf, "t", t[:n_t])
    step = n_t // 16
    with open(qf, "w") as f:
        for i in range(16):
            f.write(f">q{i}\n")
            f.write(bytes(q[i * step:(i + 1) * step]).decode() + "\n")
    args = [tf, qf, "--format=lav"]
    _run_pipeline(args, dict(DEVICE_ENV, LASTZ_TPU_FARM="0"))  # compiles
    one, one_s, _ = _run_pipeline(args, dict(DEVICE_ENV, LASTZ_TPU_FARM="0"))
    farm, farm_s, _ = _run_pipeline(args, dict(DEVICE_ENV, LASTZ_TPU_FARM="1"))
    check(len(one) > 0 and one.count("\na {") > 0, "no alignments")
    check(farm == one, "farm-out output differs from one card")
    say("four", f"target={n_t} queries=16x{step} cards={len(jax.devices())} "
        f"farm-out byte-identical to one card "
        f"one_card_s={one_s:.2f} four_cards_s={farm_s:.2f} "
        f"bytes={len(one)}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="farm-out over four cards (this phase only)")
    ap.add_argument("--phases", default="kernel,hits,e2e",
                    help="one-card phases to run after `device`")
    ap.add_argument("--bp", type=int, default=SMOKE_BP,
                    help="target length of the e2e pair")
    ns = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "lastz_tpu")):
        print("chip_smoke: the lastz_tpu package is not next to this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        dev = phase_device(4 if ns.four else 1)
        t0 = time.perf_counter()
        t, q, segs = make_pair(ns.bp)
        say("data", f"seed=42 target={len(t)} query={len(q)} "
            f"segments={len(segs)} generated_s="
            f"{time.perf_counter() - t0:.2f}")
        if ns.four:
            phase_four(t, q, tmp)
        else:
            phases = [p for p in ns.phases.split(",") if p]
            for p in phases:
                check(p in ("kernel", "hits", "e2e"), f"unknown phase {p}")
            if "kernel" in phases:
                phase_kernel(t, q, segs)
            if "hits" in phases:
                phase_hits(t, q)
            if "e2e" in phases:
                phase_e2e(t, q, tmp, ns.bp)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

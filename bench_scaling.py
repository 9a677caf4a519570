#!/usr/bin/env python
"""Chromosome-scale e2e scaling bench (VERDICT r3 item 2, r4 items 5/6).

The reference's defining workload is a chromosome pair (191 Mbp vs
94 Mbp, ~4.5 h at default sensitivity — README.lastz.html Figure 1(b);
BASELINE.md row 2).  This script benches ours vs the reference C
binary on the same synthetic conserved-segment pairs as bench.py but
at a ladder of sizes, recording e2e wall clock, stage timers, peak
RSS for BOTH binaries, and LAV equivalence at every rung.

Artifact-quality rules (VERDICT r4 weak 1/2):
  * every run is a fresh child process; this orchestrator never
    initialises JAX, so on a GPU only one process holds the card;
  * every binary's RSS is measured in its OWN fresh wrapper process
    (RUSAGE_CHILDREN of a wrapper that ran nothing else), never from
    this orchestrator's cumulative child high-water mark;
  * min-of-N with INTERLEAVED A/B order at every rung (ref, ours,
    ref, ours), so load drift on a shared host hits both binaries.

Usage:
  python bench_scaling.py                    # default ladder 4/12/40 Mbp
  LASTZ_TPU_SCALE_BPS=4000000,40000000 python bench_scaling.py
  LASTZ_TPU_SCALE_CHROM=90000000 python bench_scaling.py   # adds the
      chromosome-shaped low-sensitivity rung (--notransition --step=20
      --nogapped, the README's 2.5-minute recipe)
  python bench_scaling.py worker <t> <q> <out.lav> <flags...>  # internal
  python bench_scaling.py refworker <bin> <t> <q> <out.lav> <flags...>
"""

import json
import os
import resource
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np

OUT = os.path.join(REPO, "SCALING_r05.json")
ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)


def make_pair(n, tpath, qpath, seed=42):
    """Same statistical shape as bench.ensure_pair (conserved 2-6 kbp
    segments at 72-85% identity, ~1% ins, ~1% del, random background)
    but fully vectorized so 40+ Mbp generates in seconds."""
    if os.path.exists(tpath) and os.path.exists(qpath):
        return
    rng = np.random.default_rng(seed)
    t = ALPHA[rng.integers(0, 4, n)]

    def mutate(seg, ident):
        m = len(seg)
        out = seg.copy()
        sub = rng.random(m) < (1 - ident)
        out[sub] = ALPHA[rng.integers(0, 4, int(sub.sum()))]
        del_idx = np.nonzero(rng.random(m) < 0.01)[0]
        out = np.delete(out, del_idx)
        ins_idx = np.nonzero(rng.random(len(out)) < 0.01)[0]
        out = np.insert(out, ins_idx,
                        ALPHA[rng.integers(0, 4, len(ins_idx))])
        return out

    q_parts = []
    for _ in range(150 * (n // 1_000_000)):
        L = int(rng.integers(2000, 6000))
        p = int(rng.integers(0, n - L))
        f = int(rng.integers(1000, 5000))
        q_parts.append(ALPHA[rng.integers(0, 4, f)])
        ident = 0.72 + 0.13 * rng.random()
        q_parts.append(mutate(t[p:p + L], ident))
    q = np.concatenate(q_parts)

    def write(path, name, s):
        with open(path, "w") as f:
            f.write(">" + name + "\n")
            for i in range(0, len(s), 80):
                f.write(bytes(s[i:i + 80]).decode() + "\n")

    write(tpath, "t", t)
    write(qpath, "q", q)


def run_worker(tpath, qpath, outpath, flags=()):
    """Child process: run our pipeline ONCE, report
    wall/timers/RSS as one JSON line on stdout."""
    os.environ["LASTZ_TPU_DEVICE"] = "0"
    import io

    from lastz_tpu import stats as _stats
    from lastz_tpu.cli import parse_options
    from lastz_tpu.pipeline import Pipeline

    _stats.reset()
    t0 = time.time()
    cfg = parse_options([tpath, qpath, *flags])
    buf = io.StringIO()
    Pipeline(cfg, buf).run()
    dt = time.time() - t0
    st = _stats.current
    with open(outpath, "w") as f:
        f.write(buf.getvalue())
    print(json.dumps({
        "seconds": round(dt, 1),
        "timers": {k: round(v, 2) for k, v in st.timers.items()},
        "hsps": int(st.hsps),
        "alignments": int(st.alignments),
        "peak_rss_mb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
            1),
    }))


def run_refworker(binpath, tpath, qpath, outpath, flags=()):
    """Child wrapper: run the reference binary once; our own
    RUSAGE_CHILDREN covers exactly that one child."""
    t0 = time.time()
    with open(outpath, "w") as f:
        subprocess.run([binpath, tpath, qpath, *flags], stdout=f,
                       stderr=subprocess.DEVNULL, check=True)
    dt = time.time() - t0
    rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    print(json.dumps({"seconds": round(dt, 1),
                      "peak_rss_mb": round(rss / 1024.0, 1)}))


def _spawn_json(argv):
    # one JAX process per card: every run is a child, and this
    # orchestrator never initialises a JAX backend itself
    if "jax" in sys.modules:
        from jax._src import xla_bridge
        assert not xla_bridge.backends_are_initialized(), \
            "bench_scaling's parent process must stay off the device"
    r = subprocess.run(argv, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(r.stderr[-1500:])
    return json.loads(r.stdout.strip().splitlines()[-1])


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        run_worker(sys.argv[2], sys.argv[3], sys.argv[4],
                   tuple(sys.argv[5:]))
        return
    if len(sys.argv) > 1 and sys.argv[1] == "refworker":
        run_refworker(sys.argv[2], sys.argv[3], sys.argv[4],
                      sys.argv[5], tuple(sys.argv[6:]))
        return

    import bench
    binpath = bench.ensure_reference()
    sizes = [int(s) for s in os.environ.get(
        "LASTZ_TPU_SCALE_BPS", "4000000,12000000,40000000").split(",")
        if s]
    results = {"generated": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime()),
               "note": ("synthetic conserved-segment pairs "
                        "(bench.py shape); min-of-N wall with "
                        "interleaved ref/ours order; per-run RSS from "
                        "fresh wrapper processes; host path "
                        "(LASTZ_TPU_DEVICE=0)"),
               "rungs": []}
    variants = [("default", ())]
    if os.environ.get("LASTZ_TPU_SCALE_INNER", "1") != "0":
        # interpolation ("tweener") variant at the smallest rung:
        # the full mini-pipeline per inter-alignment window
        # (reference tweener.c:239)
        variants.append(("inner2200", ("--inner=2200",)))
    for size_i, n in enumerate(sizes):
        tag = f"{n // 1_000_000}M"
        tpath = f"/tmp/lastz_scale_{tag}_t.fa"
        qpath = f"/tmp/lastz_scale_{tag}_q.fa"
        sys.stderr.write(f"[scaling] {tag}: generating pair...\n")
        make_pair(n, tpath, qpath)
        runs = int(os.environ.get("LASTZ_TPU_SCALE_RUNS", "2"))

        for vname, flags in (variants if size_i == 0
                             else variants[:1]):
            _run_rung(binpath, results, n, tag, tpath, qpath, runs,
                      vname, flags)

    # chromosome-shaped rung (VERDICT r4 item 6): README's
    # low-sensitivity recipe on a ~90 Mbp pair
    chrom = int(os.environ.get("LASTZ_TPU_SCALE_CHROM", "0"))
    if chrom:
        tag = f"{chrom // 1_000_000}M"
        tpath = f"/tmp/lastz_scale_{tag}_t.fa"
        qpath = f"/tmp/lastz_scale_{tag}_q.fa"
        sys.stderr.write(f"[scaling] {tag}: generating pair...\n")
        make_pair(chrom, tpath, qpath)
        _run_rung(binpath, results, chrom, tag, tpath, qpath,
                  int(os.environ.get("LASTZ_TPU_SCALE_RUNS", "2")),
                  "lowsens",
                  ("--notransition", "--step=20", "--nogapped"))


def _run_rung(binpath, results, n, tag, tpath, qpath, runs,
              vname, flags):
    ref_lav = f"/tmp/lastz_scale_{tag}_{vname}_ref.lav"
    our_lav = f"/tmp/lastz_scale_{tag}_{vname}_ours.lav"
    me = os.path.abspath(__file__)
    ref_runs, our_runs = [], []
    ref_rss = our_rss = 0.0
    ours_best = None
    try:
        for i in range(runs):
            # interleaved A/B: load drift hits both binaries
            sys.stderr.write(
                f"[scaling] {tag}/{vname}: reference run {i + 1}...\n")
            ref = _spawn_json([sys.executable, me, "refworker",
                               binpath, tpath, qpath, ref_lav, *flags])
            ref_runs.append(ref["seconds"])
            ref_rss = max(ref_rss, ref["peak_rss_mb"])
            sys.stderr.write(
                f"[scaling] {tag}/{vname}: ours run {i + 1}...\n")
            ours = _spawn_json([sys.executable, me, "worker",
                                tpath, qpath, our_lav, *flags])
            our_runs.append(ours["seconds"])
            our_rss = max(our_rss, ours["peak_rss_mb"])
            if ours_best is None or ours["seconds"] <= \
                    min(w for w in our_runs):
                ours_best = ours
    except RuntimeError as e:
        results["rungs"].append(
            {"pair_bp": n, "variant": vname, "error": str(e)[-1500:]})
        save(results)
        return

    from lastz_tpu.tools.lav_compare import lav_equivalent
    with open(ref_lav) as f1, open(our_lav) as f2:
        same, why = lav_equivalent(f1.read(), f2.read())

    ref_s = min(ref_runs)
    our_s = min(our_runs)
    rung = {
        "pair_bp": n,
        "variant": vname,
        "ref_seconds": ref_s,
        "ref_runs": ref_runs,
        "ref_peak_rss_mb": ref_rss,
        "ours_seconds": our_s,
        "ours_runs": our_runs,
        "ours_peak_rss_mb": our_rss,
        "ours_timers": ours_best["timers"],
        "hsps": ours_best.get("hsps"),
        "alignments": ours_best.get("alignments"),
        "speedup_vs_c": round(ref_s / our_s, 3),
        "lav_equivalent": bool(same),
    }
    if not same:
        rung["lav_diff"] = why[:400]
    results["rungs"].append(rung)
    sys.stderr.write(
        f"[scaling] {tag}/{vname}: ref {ref_s:.0f}s vs ours "
        f"{our_s:.0f}s ({rung['speedup_vs_c']}x), "
        f"lav_equivalent={same}\n")
    save(results)


def save(results):
    with open(OUT + ".tmp", "w") as f:
        json.dump(results, f, indent=1)
    os.replace(OUT + ".tmp", OUT)


if __name__ == "__main__":
    sys.exit(main())

"""Two-process jax.distributed execution (VERDICT r4 item 7): query
shards per process, census all-reduced across processes, host-0
output merge byte-identical to the single-process run — the DCN form
of the reference's capsule farm-out (capsule.c:6-15; SURVEY.md §2
parallelism rows 2/5/6).

The test spawns two REAL processes (subprocess, not threads) that
form a jax.distributed group over a localhost coordinator on the CPU
backend, runs the same job single-process in-process, and compares
bytes."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2])
coord = sys.argv[3]; outdir = sys.argv[4]
args = sys.argv[5:]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["LASTZ_TPU_DIST"] = "1"
sys.path.insert(0, %(repo)r)
import jax
jax.distributed.initialize(coordinator_address=coord,
                           num_processes=nproc, process_id=pid)
import io
from lastz_tpu.cli import parse_options
from lastz_tpu.pipeline import Pipeline
cfg = parse_options(args)
buf = io.StringIO()
pl = Pipeline(cfg, buf)
pl.run()
if jax.process_index() == 0:
    with open(os.path.join(outdir, "out0.lav"), "w") as f:
        f.write(buf.getvalue())
    import numpy as np
    if pl.targ_census is not None:
        np.save(os.path.join(outdir, "census0.npy"),
                pl.targ_census.count)
print("WORKER_DONE", pid)
"""


def _make_inputs(tmp_path, n=4000, nq=7, seed=11, qlen=900):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    t = alpha[rng.integers(0, 4, n)]
    tf = tmp_path / "t.fa"
    tf.write_text(">t\n" + bytes(t).decode() + "\n")
    lines = []
    for i in range(nq):
        p = int(rng.integers(0, n - qlen - 100))
        q = t[p:p + qlen].copy()
        mut = rng.random(len(q)) < 0.10
        q[mut] = alpha[rng.integers(0, 4, mut.sum())]
        lines.append(f">q{i}\n" + bytes(q).decode())
    qf = tmp_path / "q.fa"
    qf.write_text("\n".join(lines) + "\n")
    return str(tf), str(qf)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _single_process(args):
    import io

    from lastz_tpu.cli import parse_options
    from lastz_tpu.pipeline import Pipeline
    saved = os.environ.pop("LASTZ_TPU_DIST", None)
    try:
        cfg = parse_options(args)
        buf = io.StringIO()
        pl = Pipeline(cfg, buf)
        pl.run()
        return buf.getvalue(), pl
    finally:
        if saved is not None:
            os.environ["LASTZ_TPU_DIST"] = saved


@pytest.mark.parametrize("census", [False, True])
def test_two_process_distributed(tmp_path, census):
    t, q = _make_inputs(tmp_path)
    args = [t, q, "--format=lav", "--ydrop=3000"]
    if census:
        args.append("--census")

    coord = f"127.0.0.1:{_free_port()}"
    outdir = str(tmp_path)
    script = WORKER % {"repo": REPO}
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # no virtual-device split in workers
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(pid), "2", coord,
             outdir, *args],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=REPO)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed: {err[-1500:]}"
        assert "WORKER_DONE" in out

    serial, spl = _single_process(args)
    with open(os.path.join(outdir, "out0.lav")) as f:
        dist_out = f.read()
    # the d-stanza echoes the command line; everything else must be
    # byte-identical
    strip = lambda s: "\n".join(
        ln for ln in s.splitlines() if not ln.startswith('  "'))
    assert strip(dist_out) == strip(serial)

    if census:
        dist_census = np.load(os.path.join(outdir, "census0.npy"))
        assert spl.targ_census is not None
        np.testing.assert_array_equal(dist_census,
                                      spl.targ_census.count)


def test_processes_sharing_a_card_are_refused():
    """Two processes on one GPU cannot both hold it: the group check
    names the shared card; disjoint cards pass."""
    from lastz_tpu.parallel.distributed import shared_cards
    assert shared_cards([[["h", "0"]], [["h", "1"]]]) == []
    assert shared_cards([[["h", "0"]], [["g", "0"]]]) == []
    assert shared_cards([[["h", "0"], ["h", "1"]],
                         [["h", "1"]]]) == [("h", "1")]

"""Exact device y-drop kernel vs the host oracle.

Property tests: for random sequence pairs and anchors the batched
kernel (ops/ydrop_exact.py) must reproduce the host engine's
one_sided results EXACTLY — score, end cell, and the full traceback
op sequence — in the unconstrained case, for both directions and for
--noytrim boundary semantics.
"""

import numpy as np
import pytest

from lastz_tpu.align.ydrop import YDropAligner
from lastz_tpu.core.scoring import new_dna_score_set
from lastz_tpu.ops.ydrop_exact import (
    ST_TRUNCATED, traceback_ops, ydrop_exact_batch)

WIDTH = 256
ROWS = 384


def _random_pair(rng, n, mutate=0.12, gap_rate=0.02):
    """Related sequence pair: seq2 is a mutated copy of seq1 with
    indels, so extensions run long enough to exercise the band walk."""
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    s1 = alpha[rng.integers(0, 4, n)]
    out = []
    i = 0
    while i < n:
        r = rng.random()
        if r < gap_rate / 2:
            out.append(alpha[rng.integers(0, 4)])  # insertion
        elif r < gap_rate:
            i += 1  # deletion
        else:
            if rng.random() < mutate:
                out.append(alpha[rng.integers(0, 4)])
            else:
                out.append(s1[i])
            i += 1
    s2 = np.array(out, dtype=np.uint8)
    return s1, s2


def _as_ops(ops):
    """one_sided returns either a list of 'S'/'I'/'D' chars (per-row
    path) or a uint8 ndarray of their ASCII codes (native sweep)."""
    if isinstance(ops, np.ndarray):
        return [chr(int(c)) for c in ops]
    return list(ops)


def _host_one_sided(v1, v2, scoring, y_drop, trim, reversed_, a1, a2):
    al = YDropAligner(v1, v2, scoring, y_drop, trim)
    if reversed_:
        M, N = a1 + 1, a2 + 1
    else:
        M, N = len(v1) - (a1 + 1), len(v2) - (a2 + 1)
    return al.one_sided(reversed_, a1, a2, M, N)


def _kernel_windows(v1, v2, a1, a2, reversed_, rows=ROWS, width=WIDTH):
    b_cap = rows + width
    a_win = np.zeros(rows, dtype=np.int32)
    b_win = np.zeros(b_cap, dtype=np.int32)
    if reversed_:
        asrc = v1[max(0, a1 + 1 - rows): a1 + 1][::-1]
        bsrc = v2[max(0, a2 + 1 - b_cap): a2 + 1][::-1]
        M, N = a1 + 1, a2 + 1
    else:
        asrc = v1[a1 + 1: a1 + 1 + rows]
        bsrc = v2[a2 + 1: a2 + 1 + b_cap]
        M, N = len(v1) - (a1 + 1), len(v2) - (a2 + 1)
    a_win[: len(asrc)] = asrc
    b_win[: len(bsrc)] = bsrc
    return a_win, b_win, M, N


@pytest.mark.parametrize("trim", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_kernel_matches_host(seed, trim):
    rng = np.random.default_rng(seed)
    v1, v2 = _random_pair(rng, 500)
    scoring = new_dna_score_set()
    y_drop = 3000

    anchors = []
    for _ in range(6):
        a1 = int(rng.integers(50, len(v1) - 50))
        a2 = min(max(a1 + int(rng.integers(-10, 10)), 10),
                 len(v2) - 10)
        anchors.append((a1, a2))

    for reversed_ in (False, True):
        aws, bws, Ms, Ns = [], [], [], []
        for a1, a2 in anchors:
            aw, bw, M, N = _kernel_windows(v1, v2, a1, a2, reversed_)
            aws.append(aw)
            bws.append(bw)
            Ms.append(min(M, ROWS))  # keep inside the static budget
            Ns.append(min(N, ROWS + WIDTH - 2))
        sub = scoring.sub.astype(np.int32)
        # rows=96 << ROWS forces the chunked-continuation path
        out = ydrop_exact_batch(
            np.stack(aws), np.stack(bws),
            np.array(Ms, np.int32), np.array(Ns, np.int32), sub,
            gap_e=int(scoring.gap_extend),
            gap_oe=int(scoring.gap_open + scoring.gap_extend),
            y_drop=y_drop, width=WIDTH, rows=96, trim_to_peak=trim)
        out = {k: np.asarray(v) for k, v in out.items()}

        for b, (a1, a2) in enumerate(anchors):
            # host run on sequences truncated to the same M/N limits
            if reversed_:
                hv1 = v1[a1 + 1 - Ms[b]:]
                hv2 = v2[a2 + 1 - Ns[b]:]
                ha1, ha2 = Ms[b] - 1, Ns[b] - 1
            else:
                hv1 = v1[: a1 + 1 + Ms[b]]
                hv2 = v2[: a2 + 1 + Ns[b]]
                ha1, ha2 = a1, a2
            score, e1, e2, ops = _host_one_sided(
                hv1, hv2, scoring, y_drop, trim, reversed_, ha1, ha2)
            st = int(out["status"][b])
            assert st in (0, ST_TRUNCATED), f"status={st} anchor={b}"
            assert int(out["score"][b]) == score, (
                f"score mismatch anchor={b} rev={reversed_}")
            assert int(out["end1"][b]) == e1
            assert int(out["end2"][b]) == e2
            kops = traceback_ops(out["tb"][b], out["ly"][b],
                                 out["end1"][b], out["end2"][b])
            assert kops == _as_ops(ops), (
                f"ops mismatch anchor={b} rev={reversed_}")


def test_kernel_truncation_matches_host():
    """Tiny traceback arena: both engines must truncate at the same
    row and report the same partial result."""
    rng = np.random.default_rng(7)
    v1, v2 = _random_pair(rng, 400, mutate=0.05)
    scoring = new_dna_score_set()
    y_drop = 3000
    a1 = a2 = 50
    tb_cap = 20_000

    al = YDropAligner(v1, v2, scoring, y_drop, True,
                      traceback_mem=tb_cap)
    import io
    import contextlib
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        score, e1, e2, ops = al.one_sided(
            False, a1, a2, len(v1) - (a1 + 1), len(v2) - (a2 + 1))

    aw, bw, M, N = _kernel_windows(v1, v2, a1, a2, False)
    sub = scoring.sub.astype(np.int32)
    out = ydrop_exact_batch(
        aw[None], bw[None], np.array([min(M, ROWS)], np.int32),
        np.array([min(N, ROWS + WIDTH - 2)], np.int32), sub,
        gap_e=int(scoring.gap_extend),
        gap_oe=int(scoring.gap_open + scoring.gap_extend),
        y_drop=y_drop, width=WIDTH, rows=128, trim_to_peak=True,
        tb_cap=tb_cap)
    out = {k: np.asarray(v) for k, v in out.items()}
    assert int(out["status"][0]) & ST_TRUNCATED
    assert int(out["score"][0]) == score
    assert (int(out["end1"][0]), int(out["end2"][0])) == (e1, e2)
    kops = traceback_ops(out["tb"][0], out["ly"][0],
                         out["end1"][0], out["end2"][0])
    assert kops == _as_ops(ops)

"""End-to-end device gapped-extension path (LASTZ_TPU_DEVICE=1, the
XLA row kernel on the CPU backend).

Runs the full pipeline twice on a synthetic related pair — host-only
and device-batched — and requires byte-identical output with a
non-zero device share (i.e. the kernel really handled anchors, they
didn't all fall back)."""

import io
import os

import numpy as np
import pytest


def _make_pair(tmp_path, n=4000, seed=11):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    s1 = alpha[rng.integers(0, 4, n)]
    out = []
    i = 0
    while i < n:
        r = rng.random()
        if r < 0.01:
            out.append(alpha[rng.integers(0, 4)])
        elif r < 0.02:
            i += 1
        else:
            if rng.random() < 0.1:
                out.append(alpha[rng.integers(0, 4)])
            else:
                out.append(s1[i])
            i += 1
    t = tmp_path / "t.fa"
    q = tmp_path / "q.fa"
    t.write_text(">t\n" + bytes(s1).decode() + "\n")
    q.write_text(">q\n" + bytes(bytearray(out)).decode() + "\n")
    return str(t), str(q)


def _run(args):
    from lastz_tpu.cli import parse_options
    from lastz_tpu.pipeline import Pipeline
    cfg = parse_options(args)
    buf = io.StringIO()
    Pipeline(cfg, buf).run()
    return buf.getvalue()


@pytest.mark.parametrize("fmt", ["lav", "maf"])
def test_device_path_matches_host(tmp_path, monkeypatch, fmt):
    t, q = _make_pair(tmp_path)
    args = [t, q, f"--format={fmt}", "--ydrop=3000"]

    monkeypatch.delenv("LASTZ_TPU_DEVICE", raising=False)
    host_out = _run(args)

    monkeypatch.setenv("LASTZ_TPU_DEVICE", "1")
    monkeypatch.setenv("LASTZ_TPU_YDROP_WIDTH", "256")
    monkeypatch.setenv("LASTZ_TPU_YDROP_ROWS", "256")
    import lastz_tpu.align.ydrop_device as ydd
    monkeypatch.setattr(ydd, "DEFAULT_WIDTH", 256)
    monkeypatch.setattr(ydd, "DEFAULT_ROWS", 256)

    insts = []
    orig_init = ydd.DeviceYDrop.__init__

    def init2(self, *a, **kw):
        orig_init(self, *a, **kw)
        insts.append(self)

    monkeypatch.setattr(ydd.DeviceYDrop, "__init__", init2)
    dev_out = _run(args)

    assert dev_out == host_out
    n_dev = sum(i.stats_device for i in insts if i.ok)
    n_host = sum(i.stats_host for i in insts if i.ok)
    assert n_dev > 0, f"no anchors ran on device (host={n_host})"

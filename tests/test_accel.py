"""Stage selection by platform (accel.py), device failures that end
the run, and the compile-cache rule (lastz_tpu/__init__.py)."""

import os

import jax
import numpy as np
import pytest

import lastz_tpu
from lastz_tpu import accel


def _platform(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)


@pytest.mark.parametrize("platform,expected", [("gpu", True),
                                               ("cpu", False)])
def test_device_stages_default_by_platform(monkeypatch, platform,
                                           expected):
    monkeypatch.delenv("LASTZ_TPU_DEVICE", raising=False)
    _platform(monkeypatch, platform)
    assert accel.device_enabled() is expected


@pytest.mark.parametrize("platform,env,expected", [
    ("gpu", "0", False),    # the host engine, for comparison runs
    ("cpu", "1", True),     # the device programs on the CPU (tests)
])
def test_device_switch_overrides_platform(monkeypatch, platform, env,
                                          expected):
    monkeypatch.setenv("LASTZ_TPU_DEVICE", env)
    _platform(monkeypatch, platform)
    assert accel.device_enabled() is expected


@pytest.mark.parametrize("platform,kernel", [("gpu", "cuda"),
                                             ("cpu", "xla")])
def test_gapped_kernel_by_platform(monkeypatch, platform, kernel):
    _platform(monkeypatch, platform)
    assert accel.gapped_kernel() == kernel


def test_every_stage_follows_the_platform(monkeypatch):
    """Seed search, the JAX x-drop scan and the gapped stage all turn on
    with a GPU backend and stay off on the CPU backend."""
    from lastz_tpu.search import batched, device_hits
    for v in ("LASTZ_TPU_DEVICE", "LASTZ_TPU_HITGEN",
              "LASTZ_TPU_XDROP_JAX"):
        monkeypatch.delenv(v, raising=False)
    _platform(monkeypatch, "gpu")
    assert device_hits._device_search_enabled()
    assert batched._use_jax_backend()
    _platform(monkeypatch, "cpu")
    assert not device_hits._device_search_enabled()
    assert not batched._use_jax_backend()


def test_no_interpret_mode_in_the_package():
    """No kernel selects an interpreter: nothing in the package asks
    for Pallas interpret mode."""
    root = os.path.dirname(lastz_tpu.__file__)
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith((".py", ".cu", ".cpp")):
                with open(os.path.join(dirpath, name)) as f:
                    src = f.read()
                assert "interpret=" not in src, name
                assert "pallas" not in src.lower(), name


def _pair(tmp_path, n=3000, seed=3):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    s1 = alpha[rng.integers(0, 4, n)]
    s2 = s1.copy()
    mut = rng.random(n) < 0.1
    s2[mut] = alpha[rng.integers(0, 4, mut.sum())]
    t, q = tmp_path / "t.fa", tmp_path / "q.fa"
    t.write_text(">t\n" + bytes(s1).decode() + "\n")
    q.write_text(">q\n" + bytes(s2).decode() + "\n")
    return str(t), str(q)


def _boom(*a, **k):
    raise RuntimeError("injected device fault")


@pytest.mark.parametrize("stage", ["seed search", "gapped extension",
                                   "position table build"])
def test_device_failure_ends_the_run(tmp_path, monkeypatch, capsys,
                                     stage):
    """A failing device stage stops the run with a FAILURE line and a
    nonzero exit; nothing is replayed on the host."""
    from lastz_tpu import cli
    from lastz_tpu.align.ydrop_device import DeviceYDrop
    from lastz_tpu.index import postable
    from lastz_tpu.search import device_hits
    t, q = _pair(tmp_path)
    monkeypatch.setenv("LASTZ_TPU_DEVICE", "1")
    if stage == "seed search":
        monkeypatch.setattr(device_hits, "device_search", _boom)
    elif stage == "gapped extension":
        monkeypatch.setattr(DeviceYDrop, "_compute_for", _boom)
    else:
        monkeypatch.setattr(postable, "build_seed_position_table_device",
                            _boom)
    out = tmp_path / "out.lav"
    rc = cli.main([t, q, f"--output={out}"])
    err = capsys.readouterr().err
    assert rc == 1
    assert f"FAILURE: device {stage} failed: RuntimeError" in err
    assert "injected device fault" in err


def test_host_engine_runs_without_the_device(tmp_path, monkeypatch,
                                             capsys):
    """LASTZ_TPU_DEVICE=0 never reaches a device stage."""
    from lastz_tpu import cli
    from lastz_tpu.search import device_hits
    t, q = _pair(tmp_path)
    monkeypatch.setenv("LASTZ_TPU_DEVICE", "0")
    _platform(monkeypatch, "gpu")
    monkeypatch.setattr(device_hits, "device_search", _boom)
    out = tmp_path / "out.lav"
    assert cli.main([t, q, f"--output={out}"]) == 0
    assert "a {" in out.read_text()


def test_compile_cache_honours_env():
    assert lastz_tpu.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/somewhere"}) is None


def test_compile_cache_default_in_checkout():
    path = lastz_tpu.compile_cache_dir({})
    checkout = os.path.dirname(os.path.dirname(lastz_tpu.__file__))
    assert path == os.path.join(checkout, ".jax_cache")
    with open(os.path.join(checkout, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()

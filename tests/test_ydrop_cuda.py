"""The CUDA y-drop chunk kernel (ops/ydrop_chunk.cu) behind its JAX
wrapper (ops/ydrop_cuda.py).

The kernel itself compiles only for a GPU.  On the CPU the wrapper's
packing, shapes, batching under vmap and its place in ydrop_mega are
checked by running the packed operands through the plain XLA chunk
(`_packed_reference`) instead of the FFI call; results must equal
ydrop_exact.ydrop_chunk / ydrop_mega exactly.  Tests marked `gpu` run
the compiled kernel against the XLA chunk on the card (chip_smoke.py
runs them there) and skip elsewhere.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lastz_tpu.core.scoring import new_dna_score_set
from lastz_tpu.ops import ydrop_cuda
from lastz_tpu.ops.ydrop_exact import (
    STATE_KEYS, _chunk_one, fresh_state_np, make_compact_alphabet,
    ydrop_chunk, ydrop_mega)


def _packed_reference(a, b, cc, dd, scal, sub, *, rows, lanes, gap_e,
                      gap_oe, y_drop, y_drop_tail, tb_cap, trim):
    """The kernel's packed contract computed by ydrop_exact._chunk_one
    (one lane; vmap batches it like the FFI call)."""
    assert y_drop_tail == ydrop_cuda.y_drop_tail(y_drop, gap_e)
    cols = {k: scal[..., i] for i, k in enumerate(ydrop_cuda.SCAL_IN)}
    state = ydrop_cuda.unpack(cc, dd, scal[..., 4:])
    st, tb = _chunk_one(a, b, cols["b_off"], cols["shift"], cols["M"],
                        cols["N"], state, sub, gap_e, gap_oe, y_drop,
                        lanes=lanes, rows=rows, alpha=sub.shape[0],
                        trim_to_peak=bool(trim), tb_cap=tb_cap)
    scal2 = jnp.stack([st[k].astype(jnp.int32)
                       for k in ydrop_cuda.SCAL_STATE], axis=-1)
    return st["CC"], st["DD"], scal2, tb


@pytest.fixture
def reference_call(monkeypatch):
    monkeypatch.setattr(ydrop_cuda, "packed_call", _packed_reference)


@pytest.fixture
def gpu_device():
    """The card, or a skip: the CUDA kernel compiles only for a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the CUDA kernel has no CPU build")
    return jax.devices()[0]


def _chunk_case(seed, lanes, rows, B=6, shift_max=0):
    """Random related windows and a mid-extension state (one XLA
    chunk already run from the fresh state)."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTN", dtype=np.uint8)
    n = rows + lanes + 64
    s1 = alpha[rng.integers(0, 4, n)]
    s2 = s1.copy()
    mut = rng.random(n) < 0.15
    s2[mut] = alpha[rng.integers(0, 5, mut.sum())]
    sc = new_dna_score_set()
    code_map, subsmall = make_compact_alphabet([s1, s2], sc.sub)
    a = np.stack([code_map[np.roll(s1, 7 * j)[:rows]]
                  for j in range(B)]).astype(np.int32)
    b = np.stack([code_map[np.roll(s2, 7 * j)[:lanes]]
                  for j in range(B)]).astype(np.int32)
    M = rng.integers(rows // 2, 4 * rows, B).astype(np.int32)
    N = rng.integers(lanes // 2, 4 * lanes, B).astype(np.int32)
    ge = int(sc.gap_extend)
    goe = int(sc.gap_open + sc.gap_extend)
    st, _ = fresh_state_np(N.astype(np.int64), ge, goe, 3000, lanes, B)
    st["done"][-1] = True          # one lane already finished
    shift = rng.integers(0, shift_max + 1, B).astype(np.int32)
    return dict(a=a, b=b, M=M, N=N, st=st, sub=subsmall, ge=ge, goe=goe,
                shift=shift, b_off=shift.copy())


def _run_chunk(fn, case, lanes, rows, trim, tb_cap=80 << 20):
    kw = dict(gap_e=case["ge"], gap_oe=case["goe"], y_drop=3000,
              lanes=lanes, rows=rows, alpha=case["sub"].shape[0],
              trim_to_peak=trim, tb_cap=tb_cap)
    state = {k: jnp.asarray(v) for k, v in case["st"].items()}
    sub = jnp.asarray(case["sub"])
    if fn is None:
        return ydrop_chunk(jnp.asarray(case["a"]), jnp.asarray(case["b"]),
                           jnp.asarray(case["b_off"]),
                           jnp.asarray(case["shift"]),
                           jnp.asarray(case["M"]), jnp.asarray(case["N"]),
                           state, sub, **kw)
    one = functools.partial(fn, **kw)
    return jax.jit(jax.vmap(
        lambda a, b, bo, sh, m, n, s: one(a, b, bo, sh, m, n, s, sub)))(
        jnp.asarray(case["a"]), jnp.asarray(case["b"]),
        jnp.asarray(case["b_off"]), jnp.asarray(case["shift"]),
        jnp.asarray(case["M"]), jnp.asarray(case["N"]), state)


def _assert_same(got, want):
    st_g, tb_g = got
    st_w, tb_w = want
    for k in STATE_KEYS:
        np.testing.assert_array_equal(np.asarray(st_g[k]),
                                      np.asarray(st_w[k]), err_msg=k)
        assert np.asarray(st_g[k]).dtype == np.asarray(st_w[k]).dtype, k
    np.testing.assert_array_equal(np.asarray(tb_g), np.asarray(tb_w))


def test_scalar_columns_match_kernel_source():
    """The packed scalar columns are in the order the kernel reads."""
    with open(ydrop_cuda.SRC) as f:
        src = f.read()
    scal_in = re.search(r"^// SCAL_IN: (.*)$", src, re.M).group(1)
    scal_out = re.search(r"^// SCAL_OUT: (.*)$", src, re.M).group(1)
    assert tuple(scal_in.split()) == ydrop_cuda.SCAL_IN
    assert tuple(scal_out.split()) == ydrop_cuda.SCAL_STATE
    assert set(ydrop_cuda.SCAL_STATE) | {"CC", "DD"} == set(STATE_KEYS)


def test_pack_unpack_round_trip():
    case = _chunk_case(0, lanes=48, rows=8)
    st = {k: jnp.asarray(v) for k, v in case["st"].items()}
    a, b, cc, dd, scal = ydrop_cuda.pack(
        jnp.asarray(case["a"]), jnp.asarray(case["b"]),
        jnp.asarray(case["b_off"]), jnp.asarray(case["shift"]),
        jnp.asarray(case["M"]), jnp.asarray(case["N"]), st)
    assert scal.shape == (6, len(ydrop_cuda.SCAL_IN))
    assert scal.dtype == jnp.int32 and a.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(scal[:, 2]), case["M"])
    back = ydrop_cuda.unpack(cc, dd, scal[:, 4:])
    for k in STATE_KEYS:
        np.testing.assert_array_equal(np.asarray(back[k]),
                                      np.asarray(st[k]), err_msg=k)
        assert back[k].dtype == st[k].dtype, k


@pytest.mark.parametrize("lanes,rows,trim,shift_max", [
    (96, 32, True, 0),      # lanes a multiple of 16
    (100, 24, False, 0),    # ragged lanes, --noytrim boundary path
    (64, 40, True, 80),     # re-anchor shifts past the window
])
def test_wrapper_matches_xla_chunk(reference_call, lanes, rows, trim,
                                   shift_max):
    case = _chunk_case(lanes + rows, lanes, rows, shift_max=shift_max)
    want = _run_chunk(None, case, lanes, rows, trim)
    got = _run_chunk(ydrop_cuda.chunk_one, case, lanes, rows, trim)
    _assert_same(got, want)


def _mega_case(seed=5, B=4):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    v1 = alpha[rng.integers(0, 4, 3000)]
    v2 = v1.copy()
    mut = rng.random(len(v2)) < 0.12
    v2[mut] = alpha[rng.integers(0, 4, mut.sum())]
    sc = new_dna_score_set()
    code_map, subsmall = make_compact_alphabet([v1, v2], sc.sub)
    a1 = rng.integers(800, 2200, B)
    a2 = a1 + rng.integers(-3, 4, B)
    A1 = np.concatenate([a1, a1]).astype(np.int32)
    A2 = np.concatenate([a2, a2]).astype(np.int32)
    REV = np.repeat([False, True], B)
    M = np.where(REV, A1 + 1, len(v1) - (A1 + 1)).astype(np.int32)
    N = np.where(REV, A2 + 1, len(v2) - (A2 + 1)).astype(np.int32)
    ge, goe = int(sc.gap_extend), int(sc.gap_open + sc.gap_extend)
    lanes = 128
    st, _ = fresh_state_np(N.astype(np.int64), ge, goe, 3000, lanes, 2 * B)
    z = np.zeros(2 * B, np.int32)
    args = (jnp.asarray(code_map[v1].astype(np.int8)),
            jnp.asarray(code_map[v2].astype(np.int8)),
            jnp.asarray(A1), jnp.asarray(A2), jnp.asarray(z),
            jnp.full(2 * B, len(v1), jnp.int32), jnp.asarray(z),
            jnp.full(2 * B, len(v2), jnp.int32), jnp.asarray(REV),
            jnp.asarray(M), jnp.asarray(N),
            {k: jnp.asarray(v) for k, v in st.items()},
            jnp.zeros(2 * B, jnp.int32), jnp.asarray(subsmall))
    kw = dict(gap_e=ge, gap_oe=goe, y_drop=3000, lanes=lanes, rows=64,
              max_blocks=3, alpha=subsmall.shape[0], trim_to_peak=True,
              tb_cap=80 << 20)
    return args, kw


def test_mega_launch_with_cuda_chunk_matches_xla(reference_call):
    """ydrop_mega's gather / re-anchor loop around the CUDA chunk
    (vmapped FFI call) gives the XLA mega-launch's results."""
    args, kw = _mega_case()
    want = ydrop_mega(*args, **kw, kernel="xla")
    got = ydrop_mega(*args, **kw, kernel="cuda")
    st_w, st_g = want[0], got[0]
    for k in STATE_KEYS:
        np.testing.assert_array_equal(np.asarray(st_g[k]),
                                      np.asarray(st_w[k]), err_msg=k)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # the launch really ran several chunks
    assert int(np.asarray(want[2])[12].max()) > 1


def test_wrapper_rejects_shapes_the_kernel_cannot_take():
    case = _chunk_case(1, lanes=32, rows=4)
    st = {k: jnp.asarray(v) for k, v in case["st"].items()}
    base = dict(gap_e=case["ge"], gap_oe=case["goe"], y_drop=3000,
                rows=4, trim_to_peak=True, tb_cap=1 << 20)
    args = (jnp.asarray(case["a"][0]), jnp.asarray(case["b"][0]),
            0, 0, 10, 10, {k: v[0] for k, v in st.items()})
    sub = jnp.asarray(case["sub"])
    with pytest.raises(ValueError, match="lanes"):
        ydrop_cuda.chunk_one(*args, sub, lanes=8192, alpha=16, **base)
    with pytest.raises(ValueError, match="alphabet"):
        ydrop_cuda.chunk_one(*args, sub, lanes=32, alpha=8, **base)
    with pytest.raises(ValueError, match="tb_cap"):
        ydrop_cuda.chunk_one(*args, sub, lanes=32, alpha=16,
                             **dict(base, tb_cap=1 << 31))


def test_build_compiles_once_for_sm90a(monkeypatch, tmp_path):
    """First use compiles ydrop_chunk.cu for sm_90a against the FFI
    headers into the build directory; later uses reuse the library."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        open(out, "wb").close()
        return type("R", (), {"returncode": 0, "stderr": ""})()

    monkeypatch.setattr(ydrop_cuda, "BUILD_DIR", str(tmp_path / "cuda"))
    monkeypatch.setattr(ydrop_cuda, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(ydrop_cuda.subprocess, "run", fake_run)
    lib = ydrop_cuda.build()
    assert ydrop_cuda.build() == lib
    assert len(calls) == 1
    cmd = calls[0]
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-I") + 1] == jax.ffi.include_dir()
    assert cmd[-1] == ydrop_cuda.SRC
    assert os.path.dirname(lib) == str(tmp_path / "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("lanes,rows,trim,shift_max", [
    (96, 32, True, 0), (100, 24, False, 0), (64, 40, True, 80),
    (1536, 64, True, 0), (1536, 48, False, 300)])
def test_cuda_kernel_matches_xla_chunk_on_card(gpu_device, lanes, rows,
                                               trim, shift_max):
    case = _chunk_case(lanes + rows + 1, lanes, rows, B=16,
                       shift_max=shift_max)
    want = _run_chunk(None, case, lanes, rows, trim)
    got = _run_chunk(ydrop_cuda.chunk_one, case, lanes, rows, trim)
    _assert_same(got, want)


@pytest.mark.gpu
def test_cuda_kernel_truncates_like_xla_on_card(gpu_device):
    case = _chunk_case(9, 128, 64, B=8)
    want = _run_chunk(None, case, 128, 64, True, tb_cap=3000)
    got = _run_chunk(ydrop_cuda.chunk_one, case, 128, 64, True,
                     tb_cap=3000)
    _assert_same(got, want)
    assert np.asarray(want[0]["status"]).any()


@pytest.mark.gpu
def test_cuda_mega_launch_matches_xla_on_card(gpu_device):
    args, kw = _mega_case(seed=6, B=8)
    want = ydrop_mega(*args, **kw, kernel="xla")
    got = ydrop_mega(*args, **kw, kernel="cuda")
    for k in STATE_KEYS:
        np.testing.assert_array_equal(np.asarray(got[0][k]),
                                      np.asarray(want[0][k]), err_msg=k)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))

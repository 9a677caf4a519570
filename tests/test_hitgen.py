"""Device-resident hit generation (search/device_hits.py +
ops/hitgen.py) must reproduce the scalar engine hit for hit — same
HSPs, same order, same scores — since hit order and the diagonal-hash
drop protocol are observable in golden outputs (SURVEY.md A.2)."""

import io
import os

import numpy as np
import pytest

from lastz_tpu.config import GFEX_NO_EXTEND, GFEX_XDROP, ScoreThreshold
from lastz_tpu.core.encoding import UPPER_NUC_TO_BITS
from lastz_tpu.core.scoring import new_dna_score_set
from lastz_tpu.core.seeds import parse_seed
from lastz_tpu.index.postable import build_seed_position_table
from lastz_tpu.search.engine import HitProcessorParams, SeedSearchEngine


def _related_pair(n, seed=3, ident=0.85, with_n=True):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    s1 = alpha[rng.integers(0, 4, n)]
    s2 = s1.copy()
    mut = rng.random(n) < (1 - ident)
    s2[mut] = alpha[rng.integers(0, 4, mut.sum())]
    # shuffle in an unrelated stretch and an N run (with_n=False keeps
    # a pure-ACGT alphabet)
    s2[n // 3: n // 3 + n // 10] = alpha[rng.integers(0, 4, n // 10)]
    if with_n:
        s2[n // 2: n // 2 + 5] = ord("N")
    return s1, s2


def _collect(s1, s2, seed_str, trans, gf_extend, thresh, x_drop=910,
             env=None, self_compare=False, same_strand=False,
             band=0, hit_mode="simple", twin_spans=None):
    seed = parse_seed(seed_str, with_trans=trans)
    pt = build_seed_position_table(
        s1, 0, 0, UPPER_NUC_TO_BITS, seed, 1)
    sc = new_dna_score_set()
    hp = HitProcessorParams(
        gf_extend=gf_extend, scoring=sc, x_drop=x_drop,
        hsp_threshold=ScoreThreshold("S", thresh))
    hits = []
    kw = {}
    if twin_spans is not None:
        kw = dict(twin_min_span=twin_spans[0],
                  twin_max_span=twin_spans[1])
    eng = SeedSearchEngine(
        s1, pt, s2, seed, UPPER_NUC_TO_BITS, hp,
        lambda p1, p2, ln, s: hits.append((p1, p2, ln, s)) or ln,
        self_compare=self_compare, same_strand=same_strand,
        band_width=band, hit_mode=hit_mode, **kw)
    saved = {}
    env = dict(env or {})
    for k, v in env.items():
        saved[k] = os.environ.get(k)
        os.environ[k] = v
    try:
        eng.search(0, len(s2))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return hits


SCALAR = {"LASTZ_TPU_SCALAR_SEARCH": "1"}
DEVICE = {"LASTZ_TPU_SCALAR_SEARCH": "0", "LASTZ_TPU_HITGEN": "1",
          "LASTZ_TPU_HIT_BUDGET": str(1 << 15)}
BATCHED = {"LASTZ_TPU_SCALAR_SEARCH": "0", "LASTZ_TPU_HITGEN": "0",
           "LASTZ_TPU_NATIVE_SEARCH": "0"}
NATIVE = {"LASTZ_TPU_SCALAR_SEARCH": "0", "LASTZ_TPU_HITGEN": "0",
          "LASTZ_TPU_NATIVE_SEARCH": "1"}


@pytest.mark.parametrize("trans", [0, 1, 2])
def test_device_hits_match_scalar(trans):
    s1, s2 = _related_pair(6000)
    ref = _collect(s1, s2, "1110100110010101111", trans,
                   GFEX_XDROP, 3000, env=SCALAR)
    dev = _collect(s1, s2, "1110100110010101111", trans,
                   GFEX_XDROP, 3000, env=DEVICE)
    assert len(ref) > 0
    assert dev == ref


def test_device_hits_low_threshold_many_chains():
    # low threshold + short seed: dense hits exercise deep hash chains
    s1, s2 = _related_pair(3000, seed=7, ident=0.92)
    ref = _collect(s1, s2, "11111111", 0, GFEX_XDROP, 300, x_drop=300,
                   env=SCALAR)
    dev = _collect(s1, s2, "11111111", 0, GFEX_XDROP, 300, x_drop=300,
                   env=DEVICE)
    assert len(ref) > 50
    assert dev == ref


def test_device_hits_no_extend():
    s1, s2 = _related_pair(2500, seed=5)
    ref = _collect(s1, s2, "111111111111", 0, GFEX_NO_EXTEND, 0,
                   env=SCALAR)
    dev = _collect(s1, s2, "111111111111", 0, GFEX_NO_EXTEND, 0,
                   env=DEVICE)
    assert len(ref) > 0
    assert dev == ref


def test_device_hits_overflow_split():
    # an out-cap small enough to force the overflow/split path
    s1, s2 = _related_pair(2500, seed=5)
    env = dict(DEVICE)
    env["LASTZ_TPU_HIT_OUTCAP"] = "64"
    ref = _collect(s1, s2, "111111111111", 0, GFEX_NO_EXTEND, 0,
                   env=SCALAR)
    dev = _collect(s1, s2, "111111111111", 0, GFEX_NO_EXTEND, 0,
                   env=env)
    assert len(ref) > 64
    assert dev == ref


def test_device_hits_self_same_strand_band():
    s1, _ = _related_pair(3000, seed=9)
    ref = _collect(s1, s1, "1110100110010101111", 1, GFEX_XDROP, 3000,
                   env=SCALAR, self_compare=True, same_strand=True,
                   band=500)
    dev = _collect(s1, s1, "1110100110010101111", 1, GFEX_XDROP, 3000,
                   env=DEVICE, self_compare=True, same_strand=True,
                   band=500)
    assert dev == ref


def test_device_hits_halfweight_seed():
    s1, s2 = _related_pair(4000, seed=13)
    ref = _collect(s1, s2, "TTT0T0TTT0TT0TTTT", 0, GFEX_XDROP, 2000,
                   env=SCALAR)
    dev = _collect(s1, s2, "TTT0T0TTT0TT0TTTT", 0, GFEX_XDROP, 2000,
                   env=DEVICE)
    assert dev == ref


@pytest.mark.parametrize("env", [BATCHED, NATIVE],
                         ids=["batched", "native"])
@pytest.mark.parametrize("trans", [0, 1])
def test_recover_hits_match_scalar(trans, env):
    """--recoverseeds routes through the batched/native paths and
    matches the scalar processor hit for hit
    (seed_search.c:1221-1420)."""
    s1, s2 = _related_pair(6000)
    ref = _collect(s1, s2, "1110100110010101111", trans,
                   GFEX_XDROP, 3000, env=SCALAR, hit_mode="recover")
    bat = _collect(s1, s2, "1110100110010101111", trans,
                   GFEX_XDROP, 3000, env=env, hit_mode="recover")
    assert len(ref) > 0
    assert bat == ref


@pytest.mark.parametrize("env", [BATCHED, NATIVE],
                         ids=["batched", "native"])
@pytest.mark.parametrize("gfex,thresh", [(GFEX_XDROP, 3000),
                                         (GFEX_NO_EXTEND, 0)])
def test_simple_hits_host_paths_match_scalar(gfex, thresh, env):
    """The host numpy and native-sweep paths both reproduce the
    scalar engine for the default simple processor."""
    s1, s2 = _related_pair(6000, seed=8)
    ref = _collect(s1, s2, "1110100110010101111", 1, gfex, thresh,
                   env=SCALAR)
    got = _collect(s1, s2, "1110100110010101111", 1, gfex, thresh,
                   env=env)
    assert len(ref) > 0
    assert got == ref


def test_recover_hits_hash_collisions():
    """Genuine 64K diagonal-hash collisions: a segment duplicated at
    distance exactly DIAG_HASH_SIZE makes every query word hit two
    true diagonals with the same hashed diagonal.  Recover mode must
    accept the colliding hits (diagActual differs) where simple mode
    drops them — and the batched resolver must agree with the scalar
    engine on every hit."""
    from lastz_tpu.search.engine import DIAG_HASH_SIZE
    rng = np.random.default_rng(11)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    core = alpha[rng.integers(0, 4, 3000)]
    fill = alpha[rng.integers(0, 4, DIAG_HASH_SIZE - 3000)]
    s1 = np.concatenate([core, fill, core,
                         alpha[rng.integers(0, 4, 500)]])
    s2 = core.copy()
    mut = rng.random(len(s2)) < 0.10
    s2[mut] = alpha[rng.integers(0, 4, mut.sum())]

    args = (s1, s2, "1110100110010101111", 0, GFEX_XDROP, 2000)
    ref = _collect(*args, env=SCALAR, hit_mode="recover")
    bat = _collect(*args, env=BATCHED, hit_mode="recover")
    nat = _collect(*args, env=NATIVE, hit_mode="recover")
    dev = _collect(*args, env=DEVICE, hit_mode="recover")
    simple = _collect(*args, env=SCALAR, hit_mode="simple")
    assert len(ref) > len(simple)  # collisions actually recovered
    assert bat == ref
    assert nat == ref
    assert dev == ref


@pytest.mark.parametrize("trans", [0, 1])
def test_device_recover_hits_match_scalar(trans):
    """--recoverseeds on the DEVICE hit generator: the on-device
    recover chain resolver (ops/hitgen._resolve_chains_recover_dev)
    must match the scalar processor hit for hit
    (seed_search.c:1221-1420)."""
    s1, s2 = _related_pair(6000)
    ref = _collect(s1, s2, "1110100110010101111", trans,
                   GFEX_XDROP, 3000, env=SCALAR, hit_mode="recover")
    dev = _collect(s1, s2, "1110100110010101111", trans,
                   GFEX_XDROP, 3000, env=DEVICE, hit_mode="recover")
    assert len(ref) > 0
    assert dev == ref


@pytest.mark.parametrize("spans", [(0, 10), (0, 50), (5, 25)])
def test_twin_hits_match_scalar(spans):
    """--twins routes through the batched lockstep queue resolver and
    matches the scalar processor hit for hit (seed_search.c:1526,
    diag_hash.h:106-145)."""
    L = 19
    tw = (2 * L + spans[0], 2 * L + spans[1])
    s1, s2 = _related_pair(6000, seed=4, ident=0.97)
    ref = _collect(s1, s2, "1110100110010101111", 1, GFEX_XDROP,
                   2000, env=SCALAR, hit_mode="twin", twin_spans=tw)
    bat = _collect(s1, s2, "1110100110010101111", 1, GFEX_XDROP,
                   2000, env=BATCHED, hit_mode="twin", twin_spans=tw)
    assert len(ref) > 0
    assert bat == ref


def test_twin_hits_hash_collisions():
    """Colliding hashed diagonals: the twin walk's early break on a
    too-large span is taken on entries of ANY true diagonal, so a
    duplicate segment at distance DIAG_HASH_SIZE exercises it."""
    from lastz_tpu.search.engine import DIAG_HASH_SIZE
    rng = np.random.default_rng(23)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    core = alpha[rng.integers(0, 4, 2500)]
    fill = alpha[rng.integers(0, 4, DIAG_HASH_SIZE - 2500)]
    s1 = np.concatenate([core, fill, core])
    s2 = core.copy()
    mut = rng.random(len(s2)) < 0.06
    s2[mut] = alpha[rng.integers(0, 4, mut.sum())]
    tw = (2 * 19, 2 * 19 + 30)
    args = (s1, s2, "1110100110010101111", 0, GFEX_XDROP, 1500)
    ref = _collect(*args, env=SCALAR, hit_mode="twin", twin_spans=tw)
    bat = _collect(*args, env=BATCHED, hit_mode="twin", twin_spans=tw)
    assert len(ref) > 0
    assert bat == ref


def test_device_position_table_matches_host():
    from lastz_tpu.index.postable import (
        build_seed_position_table, build_seed_position_table_device)
    s1, _ = _related_pair(5000, seed=17)
    seed = parse_seed("1110100110010101111", with_trans=1)
    host = build_seed_position_table(s1, 0, 0, UPPER_NUC_TO_BITS,
                                     seed, 1)
    for step in (1, 3):
        h = build_seed_position_table(s1, 0, 0, UPPER_NUC_TO_BITS,
                                      seed, step)
        d = build_seed_position_table_device(
            s1, 0, 0, UPPER_NUC_TO_BITS, seed, step)
        assert d.n_entries == len(h.csr_pos)
        assert np.array_equal(d.csr_start, h.csr_start)
        assert np.array_equal(d.csr_pos, h.csr_pos)
        assert d.adj_start == h.adj_start


def test_device_search_with_device_pt():
    from lastz_tpu.index.postable import build_seed_position_table_device
    s1, s2 = _related_pair(4000, seed=19)
    seed = parse_seed("1110100110010101111", with_trans=1)
    sc = new_dna_score_set()
    hp = HitProcessorParams(
        gf_extend=GFEX_XDROP, scoring=sc, x_drop=910,
        hsp_threshold=ScoreThreshold("S", 3000))

    def run(pt, env):
        hits = []
        eng = SeedSearchEngine(
            s1, pt, s2, seed, UPPER_NUC_TO_BITS, hp,
            lambda p1, p2, ln, s: hits.append((p1, p2, ln, s)) or ln)
        saved = {}
        for k, v in env.items():
            saved[k] = os.environ.get(k)
            os.environ[k] = v
        try:
            eng.search(0, len(s2))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        return hits

    from lastz_tpu.index.postable import build_seed_position_table
    ref = run(build_seed_position_table(s1, 0, 0, UPPER_NUC_TO_BITS,
                                        seed, 1), SCALAR)
    dev = run(build_seed_position_table_device(
        s1, 0, 0, UPPER_NUC_TO_BITS, seed, 1), DEVICE)
    assert len(ref) > 0
    assert dev == ref


def test_native_xdrop_batch_matches_np():
    """xdrop_scan_batch (native) == batch_xdrop_np on random hits."""
    from lastz_tpu.native import get_lib
    from lastz_tpu.ops.xdrop_batch import (batch_xdrop_native,
                                           batch_xdrop_np)
    lib = get_lib()
    if lib is None or not hasattr(lib, "xdrop_scan_batch"):
        pytest.skip("native library unavailable")
    s1, s2 = _related_pair(8000, seed=31, ident=0.88)
    sub = new_dna_score_set().sub
    rng = np.random.default_rng(2)
    H = 4000
    pos1 = rng.integers(19, len(s1), H)
    pos2 = rng.integers(19, len(s2), H)
    ref = batch_xdrop_np(s1, s2, sub, pos1, pos2, 910)
    got = batch_xdrop_native(s1, s2, sub, pos1, pos2, 910, lib)
    for k in ref:
        np.testing.assert_array_equal(
            np.asarray(ref[k], np.int64), got[k], err_msg=k)


def _collect_seed(s1, s2, seed, env, gf_extend=GFEX_XDROP,
                  thresh=3000, x_drop=910):
    """Like _collect but with a pre-parsed Seed (overweight seeds
    need max_index_bits control)."""
    pt = build_seed_position_table(
        s1, 0, 0, UPPER_NUC_TO_BITS, seed, 1)
    sc = new_dna_score_set()
    hp = HitProcessorParams(
        gf_extend=gf_extend, scoring=sc, x_drop=x_drop,
        hsp_threshold=ScoreThreshold("S", thresh))
    hits = []
    eng = SeedSearchEngine(
        s1, pt, s2, seed, UPPER_NUC_TO_BITS, hp,
        lambda p1, p2, ln, s: hits.append((p1, p2, ln, s)) or ln)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        eng.search(0, len(s2))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return hits


@pytest.mark.parametrize("env", [BATCHED, NATIVE, DEVICE],
                         ids=["batched", "native", "device"])
@pytest.mark.parametrize("trans", [0, 1, 2])
def test_overweight_seed_batched_matches_scalar(trans, env):
    """Overweight (resolving) seeds through the batched path must
    reproduce the scalar _probe_resolve hit for hit, including the
    per-probe transition budget left for the demoted bits
    (seed_search.c:700-980).  VERDICT r3 item 6."""
    from lastz_tpu.core.seeds import parse_seed
    s1, s2 = _related_pair(6000, seed=4, ident=0.97)
    # weight-12 pattern over 8 index bits -> 4 resolving positions
    seed = parse_seed("111011011010111", max_index_bits=16,
                      with_trans=trans)
    assert seed.type == "R" and len(seed.resolve_bits) > 0
    ref = _collect_seed(s1, s2, seed, SCALAR, thresh=1000)
    bat = _collect_seed(s1, s2, seed, env, thresh=1000)
    assert len(ref) >= 10
    assert bat == ref


@pytest.mark.parametrize("env", [BATCHED, NATIVE, DEVICE],
                         ids=["batched", "native", "device"])
def test_overweight_seed_batched_dense_chains(env):
    """Dense-hit regime for resolving seeds: low threshold + short
    seed exercises deep hash chains and many resolve rejections."""
    from lastz_tpu.core.seeds import parse_seed
    s1, s2 = _related_pair(4000, seed=17, ident=0.95)
    seed = parse_seed("1111011111", max_index_bits=12, with_trans=1)
    assert seed.type == "R"
    ref = _collect_seed(s1, s2, seed, SCALAR, thresh=300, x_drop=300)
    bat = _collect_seed(s1, s2, seed, env, thresh=300, x_drop=300)
    assert len(ref) > 100
    assert bat == ref


def test_seq_device_cache_keys_on_content():
    """The device sequence cache must key on sequence CONTENT: a strand
    loop's revcomp array can reuse a freed array's id(), and an
    id-keyed hit then serves the OTHER strand's codes — silently
    losing that strand's HSPs."""
    import gc

    from lastz_tpu.ops.hitgen import SEQ_PAD
    from lastz_tpu.search import device_hits as dh

    code_map = np.zeros(256, np.int32)
    for i, c in enumerate(b"ACGT"):
        code_map[c] = i

    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    # many same-length alloc/free cycles to tickle id() reuse; the
    # content assertion holds regardless of whether a collision
    # happened on this run
    for _ in range(12):
        a = alpha[rng.integers(0, 4, 4096)]
        dev = np.asarray(dh._seq_device(a, code_map))
        np.testing.assert_array_equal(dev[SEQ_PAD:SEQ_PAD + len(a)],
                                      code_map[a])
        assert not dev[:SEQ_PAD].any() and not dev[SEQ_PAD + len(a):].any()
        del a
        gc.collect()

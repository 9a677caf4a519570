"""The exact y-drop chunk as a CUDA kernel for Hopper (ydrop_chunk.cu),
called through the XLA foreign function interface.

`chunk_one` has the signature and the contract of
ops/ydrop_exact._chunk_one (resumable per-lane state in and out, one
row of traceback link bytes per DP row), so ydrop_exact.ydrop_mega
swaps it in for the XLA row scan without any change to its window
gather, its re-anchor loop or the traceback walk.  The state travels
to the kernel packed: CC/DD rows, the compact codes, and the per-lane
scalars as one int32 row (SCAL_IN columns, in the kernel's order).

The shared library is compiled with nvcc from the committed source at
first use on a GPU, into build/cuda/ at the root of the checkout
(listed in .gitignore).  `python -m lastz_tpu.ops.ydrop_cuda` builds
it ahead of time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

SRC = os.path.join(os.path.dirname(__file__), "ydrop_chunk.cu")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "cuda")
TARGET = "lastz_ydrop_chunk"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
MAX_LANES = 4096   # 512 threads x 8 cells per thread
MAX_ALPHA = 16

SCAL_STATE = ("LY", "RY", "row", "best", "end1", "end2", "bscore",
              "bflag", "tbp", "rows_used", "maxRY", "status", "done")
SCAL_IN = ("b_off", "shift", "M", "N") + SCAL_STATE
_BOOL_KEYS = ("bflag", "done")

build_seconds = 0.0   # wall time of the nvcc build in this process
_registered = False


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA y-drop kernel "
                           "needs the CUDA toolkit")
    return path


def build() -> str:
    """Compile ydrop_chunk.cu into BUILD_DIR (once per source and
    flags) and return the library path."""
    global build_seconds
    include = jax.ffi.include_dir()
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    lib = os.path.join(BUILD_DIR, f"libydrop_chunk_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", include, "-o", tmp,
                        SRC], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + r.stderr[-4000:])
    os.replace(tmp, lib)
    build_seconds += time.perf_counter() - t0
    return lib


def _ensure_registered():
    global _registered
    if _registered:
        return
    lib = ctypes.cdll.LoadLibrary(build())
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.YdropChunk), platform="CUDA")
    _registered = True


def pack(a_small, b_small, b_off, shift, M, N, state):
    """Kernel operands for one lane (or a batch: leading dims pass
    through): (a, b, cc, dd, scal) int32, scal in SCAL_IN order."""
    scal = jnp.stack(
        [jnp.asarray(v).astype(jnp.int32)
         for v in (b_off, shift, M, N)]
        + [state[k].astype(jnp.int32) for k in SCAL_STATE], axis=-1)
    return (a_small.astype(jnp.int32), b_small.astype(jnp.int32),
            state["CC"], state["DD"], scal)


def unpack(cc, dd, scal):
    """Kernel results back to the state dict of ydrop_exact."""
    st = {"CC": cc, "DD": dd}
    for i, k in enumerate(SCAL_STATE):
        v = scal[..., i]
        st[k] = v.astype(bool) if k in _BOOL_KEYS else v
    return st


def _ffi_chunk(a, b, cc, dd, scal, sub, *, rows, lanes, gap_e, gap_oe,
               y_drop, y_drop_tail, tb_cap, trim):
    _ensure_registered()
    lead = a.shape[:-1]
    out = (jax.ShapeDtypeStruct(lead + (lanes,), jnp.int32),
           jax.ShapeDtypeStruct(lead + (lanes,), jnp.int32),
           jax.ShapeDtypeStruct(lead + (len(SCAL_STATE),), jnp.int32),
           jax.ShapeDtypeStruct(lead + (rows + 1, lanes), jnp.uint8))
    return jax.ffi.ffi_call(TARGET, out, vmap_method="broadcast_all")(
        a, b, cc, dd, scal, sub,
        gap_e=np.int32(gap_e), gap_oe=np.int32(gap_oe),
        y_drop=np.int32(y_drop), y_drop_tail=np.int32(y_drop_tail),
        tb_cap=np.int32(tb_cap), trim=np.int32(trim))


# the call that runs the packed operands; CPU tests substitute the
# plain XLA reference (ops/ydrop_exact._chunk_one on the same layout)
packed_call = _ffi_chunk


def y_drop_tail(y_drop: int, gap_e: int) -> int:
    """Traceback headroom the truncation check reserves
    (ydrop_exact._chunk_one)."""
    return int(y_drop) // int(gap_e) + 6 if gap_e != 0 else 500 * 1000


def chunk_one(a_small, b_small, b_off, shift, M, N, state, subsmall,
              gap_e, gap_oe, y_drop, *, lanes: int, rows: int,
              alpha: int, trim_to_peak: bool, tb_cap: int):
    """ydrop_exact._chunk_one, computed by the CUDA kernel."""
    if lanes > MAX_LANES:
        raise ValueError(f"CUDA y-drop kernel: lanes {lanes} > "
                         f"{MAX_LANES}")
    if alpha != subsmall.shape[0] or alpha > MAX_ALPHA:
        raise ValueError(f"CUDA y-drop kernel: alphabet {alpha}")
    if not 0 < tb_cap < (1 << 31):
        raise ValueError(f"CUDA y-drop kernel: tb_cap {tb_cap}")
    a, b, cc, dd, scal = pack(a_small, b_small, b_off, shift, M, N,
                              state)
    cc2, dd2, scal2, tb = packed_call(
        a, b, cc, dd, scal, subsmall.astype(jnp.int32),
        rows=rows, lanes=lanes, gap_e=gap_e, gap_oe=gap_oe,
        y_drop=y_drop, y_drop_tail=y_drop_tail(y_drop, gap_e),
        tb_cap=tb_cap, trim=int(bool(trim_to_peak)))
    return unpack(cc2, dd2, scal2), tb


if __name__ == "__main__":
    t0 = time.perf_counter()
    path = build()
    print(f"{path} ({time.perf_counter() - t0:.1f} s)", file=sys.stderr)

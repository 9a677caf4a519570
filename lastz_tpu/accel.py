"""Which engine runs each stage: the accelerator or the host.

The device stages (seed+HSP hit generation, the device-built position
table, the JAX x-drop scan and the batched gapped extension) run by
default when JAX's default backend is a GPU; on the CPU backend the
native host engine runs.  LASTZ_TPU_DEVICE=0 selects the host engine
anywhere, LASTZ_TPU_DEVICE=1 the device stages anywhere (on the CPU
backend that runs the same XLA programs on the CPU, which is how the
tests reach them).

A device stage that fails raises DeviceError; the CLI reports it as a
FAILURE line and exits nonzero.  Nothing falls back to the host after
a device failure.
"""

from __future__ import annotations

import os


class DeviceError(RuntimeError):
    """A device stage failed; the run stops."""


def device_enabled() -> bool:
    forced = os.environ.get("LASTZ_TPU_DEVICE", "")
    if forced != "":
        return forced != "0"
    import jax
    return jax.default_backend() == "gpu"


def gapped_kernel() -> str:
    """Row kernel of the gapped stage: the CUDA kernel on a GPU, the
    XLA scan elsewhere (ops/ydrop_exact.ydrop_mega `kernel`)."""
    import jax
    return "cuda" if jax.default_backend() == "gpu" else "xla"


def run_device_stage(name: str, fn, *args, **kwargs):
    """Call a device stage; any exception ends the run as DeviceError."""
    try:
        return fn(*args, **kwargs)
    except DeviceError:
        raise
    except Exception as e:
        raise DeviceError(
            f"device {name} failed: {type(e).__name__}: {e}") from e

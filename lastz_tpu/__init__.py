"""lastz_tpu — a pairwise DNA local aligner in JAX.

A from-scratch re-design of the capabilities of LASTZ (Harris 2007)
for an accelerator: the seed-and-extend pipeline is expressed as
staged array programs (JAX/XLA) with a CUDA kernel for the gapped
dynamic-programming rows, while an exact host engine provides
bit-identical golden-output parity with the reference for every
supported output format.  accel.py decides which stages run on the
device.

Layers (bottom to top; see SURVEY.md for the reference layer map):
  core/     encodings, score sets, spaced-seed patterns
  io/       sequence file readers (fasta/fastq/nib/2bit/hsx), actions
  index/    seed position index over the target (host + device builds)
  search/   seed-hit search, diagonal filtering, gap-free extension
  align/    segment tables, chaining, y-drop gapped extension, tweener
  ops/      device programs (hit generation, x-drop, exact y-drop) and
            the CUDA y-drop row kernel
  parallel/ device-mesh sharding of the query stream and target index
  out/      output writers (lav/gfa/axt/maf/sam/cigar/general/...)
"""

import os

__version__ = "0.1.0"

# one fixed cache directory inside the checkout (listed in .gitignore)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir(environ=os.environ):
    """The persistent compilation cache this package sets, or None
    where JAX_COMPILATION_CACHE_DIR is set (JAX then reads it itself
    and nothing else is set)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CACHE_DIR


def _setup_jax_cache():
    cache_dir = compile_cache_dir()
    if cache_dir is None:
        return
    import jax
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)


_setup_jax_cache()

"""Multi-process (DCN-style) execution: query sharding across
`jax.distributed` processes with collective census reduction and
host-0 output merge.

The reference's only multi-process facility is the capsule farm-out:
N single-threaded processes over query shards sharing one mmap'd
target index, with per-shard outputs concatenated by the user
(reference capsule.c:6-15 + README farm-out recipe).  The JAX
equivalent (SURVEY.md §2 parallelism rows 2/5/6) runs one process per
host or per card under `jax.distributed`:

  * every process builds (or capsule-loads) the target index and
    takes every n-th query (`--shard=i/n` semantics, pipeline.py);
  * census coverage counts are ALL-REDUCED across processes after the
    query loop (the cross-worker psum SURVEY maps masking.c's census
    to) so process 0 reports global coverage;
  * per-query output chunks are gathered to process 0 over the
    process mesh (process_allgather rides DCN between hosts) and
    stitched in stream order, byte-identical to a single-process run.

Dynamic masking (cross-query coupling through the position table) is
excluded, like the reference, whose farm-out recipe also cannot mask
dynamically across processes.

One process per card: two JAX processes cannot share one GPU (the
first reserves three quarters of the card's memory when it starts),
so on a GPU every process must drive cards of its own, e.g. through
`jax.distributed.initialize(local_device_ids=...)` or disjoint
CUDA_VISIBLE_DEVICES.  run_distributed refuses a group in which two
processes hold the same card.

Activation: LASTZ_TPU_DIST=1 in a process group initialized with
`jax.distributed.initialize` (see tests/test_distributed.py for the
two-process CPU harness).
"""

from __future__ import annotations

import copy
import os

import numpy as np

from .farm import _ChunkWriter


def dist_enabled() -> bool:
    return os.environ.get("LASTZ_TPU_DIST", "") not in ("", "0")


def process_count() -> int:
    import jax
    try:
        return jax.process_count()
    except Exception:
        return 1


def dist_supported(pipeline) -> bool:
    """Whether this job can run query-sharded across processes with
    output byte-identical to the serial run.  Mirrors
    farm.farm_supported but ALLOWS census reporting (reduced
    collectively); dynamic masking stays excluded (cross-query
    coupling through the position table, masking.c:6-25)."""
    cfg = pipeline.cfg
    if cfg.shard_count > 1:
        return False
    if cfg.dynamic_masking > 0:
        return False
    if cfg.chores_filename is not None:
        return False
    if cfg.segments_filename is not None \
            or cfg.anchors_filename is not None:
        return False
    if cfg.search_limit > 0:
        return False
    if cfg.masking_filename is not None \
            or cfg.soft_masked_filename is not None:
        return False
    if cfg.infer_only or getattr(cfg, "inferring", False):
        return False
    if not pipeline.dispatcher.farm_chunkable():
        return False
    if getattr(pipeline.dispatcher, "collector", None) is not None:
        return False
    return True


# -- collectives ------------------------------------------------------------


def allgather_i64(x: np.ndarray) -> np.ndarray:
    """(nproc, *x.shape) int64 gather across the process group."""
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(
        np.asarray(x, np.int64)))


def allreduce_census_counts(count: np.ndarray) -> np.ndarray:
    """Sum per-process census coverage, saturating at the census
    dtype's max (masking.c bumps saturate per process; the global sum
    saturates once, which can only differ when true coverage exceeds
    the dtype ceiling)."""
    total = allgather_i64(count).sum(axis=0)
    maxv = np.iinfo(count.dtype).max
    return np.minimum(total, maxv).astype(count.dtype)


def gather_texts(text: str, to_all: bool = False) -> list[str] | None:
    """Gather one string per process to process 0 (None elsewhere), or
    to every process with to_all."""
    import jax
    data = np.frombuffer(text.encode(), np.uint8)
    lens = allgather_i64(np.int64(len(data)))
    cap = max(int(lens.max()), 1)
    pad = np.zeros(cap, np.uint8)
    pad[: len(data)] = data
    gathered = allgather_i64(pad)
    if jax.process_index() != 0 and not to_all:
        return None
    return [bytes(gathered[i, : int(lens[i])].astype(np.uint8)).decode()
            for i in range(gathered.shape[0])]


def local_cards() -> list[list[str]]:
    """[host, physical card] for each GPU this process drives (the CUDA
    ordinal mapped through CUDA_VISIBLE_DEVICES)."""
    import socket

    import jax
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    order = [v.strip() for v in vis.split(",")] if vis else None
    host = socket.gethostname()
    cards = []
    for d in jax.local_devices():
        hw = int(d.local_hardware_id)
        phys = order[hw] if order is not None and hw < len(order) \
            else str(hw)
        cards.append([host, phys])
    return cards


def shared_cards(per_process) -> list[tuple[str, str]]:
    """Cards that more than one process claims; per_process[i] lists
    process i's [host, card] pairs."""
    owner, shared = {}, set()
    for pid, cards in enumerate(per_process):
        for c in map(tuple, cards):
            if owner.setdefault(c, pid) != pid:
                shared.add(c)
    return sorted(shared)


def check_one_process_per_card() -> None:
    """Refuse (ValueError, on every process) a GPU group in which two
    processes would share a card."""
    import json

    import jax
    if jax.default_backend() != "gpu":
        return
    per_process = [json.loads(t) for t in
                   gather_texts(json.dumps(local_cards()), to_all=True)]
    shared = shared_cards(per_process)
    if shared:
        raise ValueError(
            "distributed run: several processes share GPU(s) "
            f"{shared}; give each process cards of its own "
            "(jax.distributed.initialize(local_device_ids=...))")


# -- the distributed query stage ---------------------------------------------


def run_distributed(pipeline, target, pt, make_worker_pipeline) -> None:
    """Run the query stage sharded across the process group.

    Every process runs a worker pipeline over its query shard into a
    _ChunkWriter; chunks are gathered to process 0, which writes them
    into the real output stream in query order.  Census counts are
    all-reduced into the parent pipeline's census so the report (and
    LAV m-stanza) is global."""
    import jax

    check_one_process_per_card()
    n = jax.process_count()
    pid = jax.process_index()
    cfg = pipeline.cfg

    wcfg = copy.deepcopy(cfg)
    wcfg.shard_count = n
    wcfg.shard_index = pid
    wcfg.stats_filename = None
    wout = _ChunkWriter()
    wpl = make_worker_pipeline(wcfg, wout)
    wpl._farm_worker = True
    wpl.run(target, pt)
    wout.end_queries()
    pipeline.stats.merge(wpl.stats)
    pipeline._search_limit_exceeded += wpl._search_limit_exceeded

    # census psum (SURVEY §2: all-reduce census across workers)
    if pipeline.targ_census is not None \
            and wpl.targ_census is not None:
        pipeline.targ_census.count[:] = allreduce_census_counts(
            wpl.targ_census.count)

    # output merge: JSON-encode this process's chunks, gather to 0
    import json
    mine = json.dumps({str(i): "".join(c)
                       for i, c in wout.chunks.items()})
    texts = gather_texts(mine)
    if texts is not None:
        merged = {}
        for t in texts:
            for k, v in json.loads(t).items():
                merged[int(k)] = v
        for i in sorted(merged):
            pipeline.out.write(merged[i])
    pipeline._farmed = True

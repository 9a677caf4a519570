"""Concurrent multi-device query farm-out.

The reference's scaling story is the target capsule: build the index
once, then run N *processes in parallel* over query shards, each with
the index mmap-shared (reference capsule.c:6-15).  This module is the
device equivalent: N worker threads, one per mesh device, each
running a worker Pipeline over its query shard (every N-th query —
the same interleaving as `--shard=i/n`) with the target and position
table shared read-only and every device launch pinned to the worker's
device.  Device work for different queries overlaps across devices;
host glue interleaves under the GIL.

Output is byte-identical to the serial run for any device count: each
worker captures its queries' output as self-contained chunks (the
dispatcher guarantees chunkability via `farm_chunkable`), and the
parent stitches chunks back in query-stream order.  Job header and
footer are emitted by the parent.

Configurations with cross-query coupling fall back to the serial
round-robin-pinned loop in pipeline.py: dynamic masking / census
(queries couple through the target), chores (one query spans several
loads), segments/anchors input (a sequentially-consumed stream),
search limits (footer summary counts globally), non-chunkable output
formats, and user-level --shard (composes with farm-out awkwardly).
"""

from __future__ import annotations

import copy
import threading

from .. import stats as _stats


class _ChunkWriter:
    """A file-like sink that splits worker output into per-query
    chunks.  Everything before the first begin_query (the worker's
    own job header) and after the last query (the worker's footer)
    is discarded — the parent emits the real header/footer."""

    def __init__(self):
        self.chunks = {}
        self._cur = None

    def begin_query(self, index: int):
        self._cur = []
        self.chunks[index] = self._cur

    def end_queries(self):
        self._cur = None

    def write(self, s: str):
        if self._cur is not None:
            self._cur.append(s)

    def flush(self):
        pass


def farm_supported(pipeline) -> bool:
    """Whether this job can run the concurrent farm-out with output
    byte-identical to the serial run."""
    cfg = pipeline.cfg
    if cfg.shard_count > 1:
        return False
    if cfg.dynamic_masking > 0 or cfg.report_census:
        return False
    if getattr(pipeline, "targ_census", None) is not None:
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


def run_farmed(pipeline, target, pt, devices,
               make_worker_pipeline) -> None:
    """Run the query stage concurrently across `devices`.

    `make_worker_pipeline(cfg, out) -> Pipeline` constructs a worker
    (passed in to avoid a circular import).  Raises whatever the
    first failing worker raised."""
    import jax

    n = len(devices)
    cfg = pipeline.cfg
    writers = []
    workers = []
    errors = []

    def work(k: int):
        wcfg = copy.deepcopy(cfg)
        wcfg.shard_count = n
        wcfg.shard_index = k
        wcfg.stats_filename = None     # parent reports merged stats
        wout = writers[k]
        try:
            with jax.default_device(devices[k]):
                wpl = make_worker_pipeline(wcfg, wout)
                wpl._farm_worker = True
                # pin every per-query device launch to this device
                wpl._farm_cache = [devices[k]]
                wpl.run(target, pt)
            wout.end_queries()
            with _lock:
                pipeline.stats.merge(wpl.stats)
                pipeline._search_limit_exceeded += \
                    wpl._search_limit_exceeded
        except BaseException as e:      # noqa: BLE001 — re-raised
            errors.append(e)

    _lock = threading.Lock()
    for k in range(n):
        writers.append(_ChunkWriter())
        t = threading.Thread(target=work, args=(k,), daemon=True,
                             name=f"lastz-farm-{k}")
        workers.append(t)
        t.start()
    for t in workers:
        t.join()
    if errors:
        raise errors[0]

    # stitch per-query chunks back in stream order; query indices are
    # 1-based stream positions, owner = (index-1) % n
    indices = sorted(i for w in writers for i in w.chunks)
    for i in indices:
        pipeline.out.write("".join(writers[(i - 1) % n].chunks[i]))
    pipeline._farmed = True

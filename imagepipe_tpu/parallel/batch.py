"""Batched multi-device develop engine.

The new capability over the reference (SURVEY.md section 2.5: the reference
is strictly one image per Pipeline, rayon rows as its only parallelism).
Here the batch dimension is first-class: a file list is bucketed by sensor
shape, stacked to [B,H,W] planes, and developed by the fused engine under a
jax.sharding.Mesh:

  * dp ("batch") axis -- images sharded across devices; embarrassingly
    parallel, no collectives.
  * sp ("spatial") axis -- each image's width sharded across devices; the
    demosaic stencil's shifted reads become 1-pixel halo exchanges that
    GSPMD inserts automatically. For frames too large for one device's
    memory, analogous to sequence/context parallelism.

Decode/compute overlap (the pipeline-parallelism analogue, SURVEY.md
section 2.5): develop_files streams decodes through a host thread pool and
dispatches each shape bucket to the device as soon as it fills, while the
pool keeps decoding the remaining files. Device dispatch is asynchronous
(JAX), and host-side result fetches are deferred until every batch is in
flight, so H2D transfer + develop of batch N overlap the decode of N+1.
"""

from __future__ import annotations

import concurrent.futures as cf
from collections import defaultdict

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine import (make_develop_plan, _develop_batch_perimage_jit,
                      normalize_plane_np, planar_to_hwc, stack_params)
from ..pipeline import Pipeline
from ..sources import ImageSource

__all__ = ["BatchEngine", "BatchError", "make_batch_mesh", "shard_batch"]


class BatchError:
    """Marked per-file failure in a batch result list (errors='skip'): the
    slot keeps its input order, carries the path and the decode/plan
    exception, and is falsy so `if result:` skips it naturally."""

    def __init__(self, path: str, error: Exception):
        self.path = path
        self.error = error

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:
        return f"BatchError({self.path!r}, {self.error!r})"


def make_batch_mesh(devices=None, spatial: int = 1) -> Mesh:
    """1-D data-parallel mesh by default; pass spatial>1 for a 2-D
    (batch, spatial) mesh that also shards image width."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    assert n % spatial == 0, (n, spatial)
    arr = np.array(devices).reshape(n // spatial, spatial)
    return Mesh(arr, ("batch", "spatial"))


def shard_batch(mesh: Mesh, planes):
    """Place [B,H,W(,C)] planes with batch over 'batch' and W over 'spatial'."""
    spec = P("batch", None, "spatial") if planes.ndim == 3 else P("batch", None, "spatial", None)
    return jax.device_put(planes, NamedSharding(mesh, spec))


def default_decode_workers() -> int:
    """Host decode is the throughput-limiting stage of a serving job
    (tens of MP/s per core vs thousands on the device), so default to
    one worker per AVAILABLE core (cgroup/affinity-aware, not the bare
    machine count). Capped: fujic/DNG decoders spin their own small
    pools per file."""
    import os as _os

    try:
        ncpu = len(_os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        ncpu = _os.cpu_count() or 4
    return max(1, min(16, ncpu))


class BatchEngine:
    """Develop many RAW files concurrently on a device mesh."""

    def __init__(self, mesh: Mesh | None = None, out_bits: int = 8,
                 max_batch: int = 8, decode_workers: int | None = None,
                 maxwidth: int = 0, maxheight: int = 0,
                 inflight_batches: int = 2):
        self.mesh = mesh if mesh is not None else make_batch_mesh()
        self.out_bits = out_bits
        self.max_batch = max_batch
        if decode_workers is None:
            decode_workers = default_decode_workers()
        self.decode_workers = decode_workers
        self.maxwidth = maxwidth
        self.maxheight = maxheight
        # Bound on dispatched-but-unfetched batches: enough for the device
        # to stay busy under the host fetch, without HBM growing with the
        # input list length (every in-flight batch pins its device output).
        self.inflight_batches = max(1, int(inflight_batches))
        # Test/observability hook: when set to a list, (event, payload)
        # tuples are appended for every decode completion and batch dispatch.
        self._events: list | None = None

    def _note(self, event: str, payload) -> None:
        if self._events is not None:
            self._events.append((event, payload))

    def _plan_for(self, source: ImageSource):
        pipe = Pipeline.new_from_source(source)
        pipe.globals.settings.maxwidth = self.maxwidth
        pipe.globals.settings.maxheight = self.maxheight
        if self.out_bits == 16:
            pipe.globals.settings.linear = True
        return make_develop_plan(pipe, out_bits=self.out_bits)

    def _dispatch_chunk(self, chunk):
        """Stack one shape bucket's chunk, pad to the mesh's batch multiple,
        and dispatch the batched develop. Returns the DEVICE output (async:
        no host sync -- callers fetch later so compute overlaps host work)."""
        plan = chunk[0][2]
        b = len(chunk)
        pad = (-b) % self.mesh.shape["batch"]
        sel = np.arange(b + pad) % b if pad else np.arange(b)

        # Per-image calibration: params (WB, levels, matrices, curves)
        # batch alongside the planes -- images bucket by STATICS only, so
        # their params may differ. Planes are normalized and stacked on the
        # host so the batch crosses to the device in one sharded transfer.
        planes = np.stack([
            normalize_plane_np(p_, src.raw.data)
            for _, src, p_ in chunk])[sel]
        param_dicts = [chunk[i][2].params for i in sel]
        dev = shard_batch(self.mesh, planes)
        out = _develop_batch_perimage_jit(
            dev, stack_params(param_dicts), **plan.statics())
        self._note("dispatch", len(chunk))
        return out

    def _collect(self, inflight, results, keep: int = 0):
        """Fetch device outputs to host (oldest first) and scatter into
        input order, leaving at most `keep` batches in flight."""
        while len(inflight) > keep:
            chunk, out = inflight.pop(0)
            out_np = planar_to_hwc(out)[:len(chunk)]
            for (idx, _, _), img in zip(chunk, out_np):
                results[idx] = img
            self._note("collected", len(chunk))

    def develop_sources(self, sources: list[ImageSource]):
        """Develop a list of RAW sources; returns numpy outputs in input
        order. Sources are bucketed by (shape, plan statics) so each bucket
        compiles once and pads to the batch multiple of the mesh."""
        results: list = [None] * len(sources)
        buckets: dict = defaultdict(list)
        for idx, src in enumerate(sources):
            plan = self._plan_for(src)
            key = tuple(sorted(plan.statics().items()))
            buckets[key].append((idx, src, plan))

        inflight = []
        for _, entries in buckets.items():
            for start in range(0, len(entries), self.max_batch):
                inflight.append((entries[start:start + self.max_batch],
                                 self._dispatch_chunk(entries[start:start + self.max_batch])))
                self._collect(inflight, results, keep=self.inflight_batches)
        self._collect(inflight, results)
        return results

    def develop_files(self, paths: list[str], errors: str = "raise"):
        """Streaming decode -> batched develop with decode/compute overlap:
        every shape bucket is dispatched to the device the moment it reaches
        max_batch, while the thread pool keeps decoding the remaining files;
        leftover partial buckets go out after the last decode. Dispatch is
        async and at most `inflight_batches` device outputs stay unfetched
        (develop of batch N overlaps the decode of batch N+1 without HBM
        growing with the input list).

        errors: 'raise' aborts the job on the first undecodable file;
        'skip' records a BatchError in that file's result slot and the rest
        of the batch completes (the production policy -- one corrupt file
        must not discard a directory's work)."""
        from ..decode import decode_file

        assert errors in ("raise", "skip"), errors
        results: list = [None] * len(paths)
        buckets: dict = defaultdict(list)
        inflight = []
        with cf.ThreadPoolExecutor(self.decode_workers) as pool:
            futs = {pool.submit(decode_file, p): i for i, p in enumerate(paths)}
            for fut in cf.as_completed(futs):
                idx = futs[fut]
                try:
                    src = fut.result()
                    self._note("decoded", idx)
                    plan = self._plan_for(src)
                except Exception as e:
                    if errors == "raise":
                        raise
                    results[idx] = BatchError(paths[idx], e)
                    self._note("error", idx)
                    continue
                key = tuple(sorted(plan.statics().items()))
                buckets[key].append((idx, src, plan))
                if len(buckets[key]) >= self.max_batch:
                    inflight.append((buckets[key], self._dispatch_chunk(buckets[key])))
                    del buckets[key]
                    # Fetch the oldest finished batches while the pool keeps
                    # decoding; bounds HBM to inflight_batches outputs.
                    self._collect(inflight, results, keep=self.inflight_batches)
            for chunk in buckets.values():
                inflight.append((chunk, self._dispatch_chunk(chunk)))
                self._collect(inflight, results, keep=self.inflight_batches)
        self._collect(inflight, results)
        return results

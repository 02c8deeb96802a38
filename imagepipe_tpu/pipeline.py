"""Pipeline orchestrator: size planning, hash chain, stage cache, execution.

Re-design of /root/reference/src/pipeline.rs. The planner is host Python
(pure integer/f32 arithmetic); execution dispatches per-stage jitted device
programs whose outputs stay HBM-resident. The chained hashing protocol is
identical to the reference (settings first, then each op's name+fields,
pipeline.rs:341-361) so editing op k invalidates exactly stages >= k, and a
cache probe resumes from the deepest valid stage.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from contextlib import contextmanager
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from .buffer import OpBuffer
from .cache import MultiCache
from .color import output8bit, output16bit
from .hasher import BufHasher, pack_u64, pack_bool
from .sources import ImageSource, RasterImage
from . import scaling
from .ops import gofloat, demosaic, rotatecrop, colorspaces, curves, gamma, transform

__all__ = [
    "SRGBImage", "SRGBImage16", "PipelineSettings", "PipelineGlobals",
    "PipelineOps", "Pipeline", "PipelineCache", "SERIAL_VERSION",
]

log = logging.getLogger("imagepipe_tpu")

SERIAL_VERSION = 0

# Collapse a cached run's dirty suffix into one device dispatch when every
# remaining op supports it (ImageOp.device_chain). Module flag so tests can
# pin fused-vs-staged bit-equality by toggling it.
FUSE_SUFFIX = True

# Cache the fused suffix's per-stage intermediates (reference parity:
# pipeline.rs:369 caches every stage). When False the fused dispatch
# returns ONLY the final stage (+ fused quantize): a later edit of a
# mid-suffix op resumes from the deepest pre-suffix entry instead — same
# outputs, one fused dispatch either way, but each edit creates one device
# buffer instead of four or five.
CACHE_FUSED_INTERMEDIATES = True

PipelineCache = MultiCache


@contextmanager
def _timing(name: str):
    """Per-stage wall timing like do_timing! (pipeline.rs:68-80). Device
    dispatch is async; timings bracket block_until_ready at stage exits when
    the DEBUG log level is enabled, else they only measure dispatch."""
    start = time.perf_counter()
    yield
    ms = (time.perf_counter() - start) * 1000.0
    log.info("timing: %7.1f ms for |%s", ms, name)


@dataclasses.dataclass
class SRGBImage:
    """Final 8-bit output: [height, width, 3] uint8 (pipeline.rs:25-30)."""
    width: int
    height: int
    data: np.ndarray


@dataclasses.dataclass
class SRGBImage16:
    """Final 16-bit output: [height, width, 3] uint16 (pipeline.rs:36-41)."""
    width: int
    height: int
    data: np.ndarray


@dataclasses.dataclass
class PipelineSettings:
    """Global knobs (pipeline.rs:110-131); all hashed into the op chain."""
    maxwidth: int = 0
    maxheight: int = 0
    demosaic_width: int = 0
    demosaic_height: int = 0
    linear: bool = False
    use_fastpath: bool = True

    def serialize_binary(self) -> bytes:
        return (pack_u64(self.maxwidth) + pack_u64(self.maxheight)
                + pack_u64(self.demosaic_width) + pack_u64(self.demosaic_height)
                + pack_bool(self.linear) + pack_bool(self.use_fastpath))

    def hash(self, hasher: BufHasher) -> None:
        hasher.from_serialize(self)


@dataclasses.dataclass
class PipelineGlobals:
    image: ImageSource
    settings: PipelineSettings

    @staticmethod
    def mock(width: int, height: int) -> "PipelineGlobals":
        img = ImageSource.from_raster(np.zeros((height, width, 3), np.uint8))
        return PipelineGlobals(img, PipelineSettings())


class PipelineOps:
    """The 8 fixed stages in execution order (pipeline.rs:154-164,211-243)."""

    ORDER = ("gofloat", "demosaic", "rotatecrop", "tolab", "basecurve",
             "fromlab", "gamma", "transform")

    def __init__(self, img: ImageSource):
        self.gofloat = gofloat.OpGoFloat(img)
        self.demosaic = demosaic.OpDemosaic(img)
        self.rotatecrop = rotatecrop.OpRotateCrop(img)
        self.tolab = colorspaces.OpToLab(img)
        self.basecurve = curves.OpBaseCurve(img)
        self.fromlab = colorspaces.OpFromLab(img)
        self.gamma = gamma.OpGamma(img)
        self.transform = transform.OpTransform(img)

    def all_ops(self):
        return [getattr(self, name) for name in self.ORDER]

    def content_hash(self) -> bytes:
        h = BufHasher()
        for op in self.all_ops():
            h.from_serialize(op)
        return h.result()

    def __eq__(self, other):
        if not isinstance(other, PipelineOps):
            return NotImplemented
        return self.content_hash() == other.content_hash()

    def __hash__(self):
        return hash(self.content_hash())

    # YAML schema: mapping of stage name -> op settings, stage order
    # preserved (serde field order parity, pipeline.rs:154-164).
    def to_settings_dict(self) -> dict:
        return {name: getattr(self, name).to_settings_dict() for name in self.ORDER}

    def load_settings_dict(self, d: dict) -> None:
        for name in self.ORDER:
            sub = d.get(name)
            if sub is not None:
                getattr(self, name).load_settings_dict(sub)


class Pipeline:
    """Develop one image through the 8-stage chain (pipeline.rs:245-470)."""

    def __init__(self, globals_: PipelineGlobals, ops: PipelineOps):
        self.globals = globals_
        self.ops = ops

    # -- construction ------------------------------------------------------

    @staticmethod
    def new_cache(size: int) -> MultiCache:
        return MultiCache(size)

    @staticmethod
    def new_from_file(path) -> "Pipeline":
        from .decode import decode_file

        with _timing("total new_from_file()"):
            img = decode_file(path)
        return Pipeline.new_from_source(img)

    @staticmethod
    def new_from_source(img: ImageSource) -> "Pipeline":
        return Pipeline(
            PipelineGlobals(img, PipelineSettings()),
            PipelineOps(img),
        )

    def default_ops(self) -> bool:
        return self.ops == PipelineOps(self.globals.image)

    # -- serialization (pipeline.rs:290-309) -------------------------------

    def to_serial(self) -> str:
        import yaml

        doc = [
            {"version": SERIAL_VERSION, "filehash": "0"},
            self.ops.to_settings_dict(),
        ]
        return yaml.safe_dump(doc, sort_keys=False)

    @staticmethod
    def new_from_serial(img: ImageSource, serial: str) -> "Pipeline":
        import yaml

        doc = yaml.safe_load(serial)
        meta, opsdict = doc[0], doc[1]
        if int(meta.get("version", 0)) > SERIAL_VERSION:
            raise ValueError(f"unsupported pipeline file version {meta['version']}")
        pipe = Pipeline.new_from_source(img)
        pipe.ops.load_settings_dict(opsdict)
        return pipe

    # -- the scheduler (pipeline.rs:311-375) -------------------------------

    def run(self, cache: Optional[MultiCache] = None) -> OpBuffer:
        return self._run_impl(cache, final_quant=None)[0]

    def _run_impl(self, cache, final_quant):
        """run() plus an optional fused final quantize: when the dirty
        suffix's last fused segment reaches the end of the chain, the
        output8bit/output16bit quantize joins the SAME device dispatch so
        an interactive edit is one dispatch + one small u8/u16 fetch
        (pipeline.rs:354-372 + :408-414 collapsed). Returns
        (final OpBuffer, quantized device array or None)."""
        with _timing("  total pipeline"):
            ops = self.ops.all_ops()

            # Phase A: reset op memo state.
            for op in ops:
                op.reset()

            # Phase B: 3-pass size planning.
            width, height = self.globals.image.width(), self.globals.image.height()
            for op in ops:
                width, height = op.transform_forward(width, height)
            log.debug("Maximum possible image size is %dx%d", width, height)
            width, height = scaling.scaling_size(
                width, height, self.globals.settings.maxwidth, self.globals.settings.maxheight)
            log.debug("Final image size is %dx%d", width, height)
            for op in reversed(ops):
                width, height = op.transform_reverse(width, height)
            log.debug("Needed image size at demosaic %dx%d", width, height)
            self.globals.settings.demosaic_width = width
            self.globals.settings.demosaic_height = height

            # Phase C: chained hashing + deepest cache hit (latest wins).
            # The chain is salted with the image content hash so a shared
            # multi-image cache cannot collide (see sources.image_content_hash;
            # the reference hashes only settings+ops, pipeline.rs:341-352).
            from .sources import image_content_hash

            hasher = BufHasher()
            hasher.write(image_content_hash(self.globals.image))
            self.globals.settings.hash(hasher)
            ophashes = []
            startpos = 0
            bufin = OpBuffer.default()
            for i, op in enumerate(ops):
                op.hash(hasher)
                result = hasher.copy().result()
                ophashes.append(result)
                if cache is not None:
                    hit = cache.get(result)
                    if hit is not None:
                        bufin = hit
                        startpos = i + 1

            # Phase D: execute the dirty suffix (fused segments where the
            # ops allow; see _execute_suffix).
            return self._execute_suffix(ops, startpos, bufin, ophashes,
                                        cache, final_quant)

    def _execute_suffix(self, ops, startpos, bufin, ophashes, cache,
                        final_quant):
        """Phase D: execute ops[startpos:], collapsing every maximal run of
        chainable ops (ImageOp.device_chain) into ONE device dispatch.

        Why: per-edit host costs (one dispatch and one param transfer per
        stage) outweigh the device work of a preview-sized suffix. Stage
        semantics are preserved exactly — stages are
        barrier-separated inside the jit, every intermediate is returned
        and cached under its chain hash, so cache resume depth is
        unchanged. A declining op (e.g. an active rotatecrop) runs
        per-stage and fusion restarts after it (maximal fusable tail), so
        the tolab→…→transform tail still fuses during a crop drag.

        Returns (final OpBuffer, quantized array or None). The quantize
        only joins when the last fused segment reaches the chain end."""
        i, n = startpos, len(ops)
        quant = None
        fuse_ok = FUSE_SUFFIX
        while i < n:
            if fuse_ok:
                chains = []
                meta = (bufin.width, bufin.height, bufin.colors,
                        bufin.monochrome)
                j = i
                while j < n:
                    c = ops[j].device_chain(self.globals, meta)
                    if c is None:
                        break
                    chains.append(c)
                    meta = c[3]
                    j += 1
                is_tail = j == n
                nfns = sum(1 for c in chains if c[1] is not None)
                # Fuse when it saves a dispatch: >=2 real stages, or a
                # tail with >=1 real stage plus the fused quantize.
                if chains and (nfns >= 2
                               or (is_tail and final_quant and nfns >= 1)):
                    out = self._dispatch_fused(
                        ops, i, chains, bufin, ophashes, cache,
                        final_quant if is_tail else None)
                    if out is not None:
                        bufin, q = out
                        if q is not None:
                            quant = q
                        i = j
                        continue
                    # Compile/dispatch failure: the per-stage path is the
                    # proven fallback; don't re-attempt fusion this run.
                    fuse_ok = False
            op = ops[i]
            with _timing("    " + op.name()):
                bufin = op.run(self.globals, bufin)
            if cache is not None:
                cache.put_arc(ophashes[i], bufin, bufin.nbytes())
            i += 1
        return bufin, quant

    def _dispatch_fused(self, ops, startpos, chains, bufin, ophashes, cache,
                        final_quant):
        """Dispatch one fused segment (ops[startpos:startpos+len(chains)])
        as a single jit. Returns (final OpBuffer, quant or None), or None on
        dispatch failure (caller falls back per-stage). Identity stages pass
        their input through; their cache entry shares the underlying array
        exactly like `op.run` returning `buf` does.

        Each numpy jit argument is a blocking host->device transfer while
        dispatches themselves pipeline, so chain params are device-cached
        keyed by (op name, shash, chain key): an exposure edit re-uploads
        only the edited op's (packed) coefficients."""
        import jax

        from . import color as cc

        seg_ops = ops[startpos:startpos + len(chains)]
        cache_inter = CACHE_FUSED_INTERMEDIATES and cache is not None
        key = (startpos, final_quant, cache_inter, bufin.data.shape,
               str(bufin.data.dtype), cc.get_numerics_mode(),
               tuple(c[0] for c in chains))
        memo = getattr(self, "_suffix_jits", None)
        if memo is None:
            memo = self._suffix_jits = {}
        jitted = memo.get(key)
        if jitted is not None:
            memo[key] = memo.pop(key)  # LRU: a hit must not be evicted next
        else:
            fns = [c[1] for c in chains]
            quant_fn = {8: cc.output8bit, 16: cc.output16bit,
                        None: None}[final_quant]

            def suffix_fn(data, all_params):
                outs = []
                for fn, p in zip(fns, all_params):
                    if fn is not None:
                        # The barrier pins each stage's arithmetic to the
                        # standalone kernel's exact rounding (no cross-stage
                        # FMA contraction/fusion): the win is one dispatch,
                        # not a changed program.
                        data = jax.lax.optimization_barrier(fn(data, *p))
                    outs.append(data)
                q = None
                if quant_fn is not None:
                    q = quant_fn(jax.lax.optimization_barrier(data))
                if not cache_inter:
                    outs = outs[-1:]
                return tuple(outs), q

            if len(memo) >= 16:   # bound retained traces per pipeline
                memo.pop(next(iter(memo)))
            jitted = memo[key] = jax.jit(suffix_fn)

        # Device-resident param cache (LRU by op identity+state).
        pmemo = getattr(self, "_chain_params", None)
        if pmemo is None:
            pmemo = self._chain_params = {}
        dev_params = []
        for op, c in zip(seg_ops, chains):
            if not c[2]:
                dev_params.append(())
                continue
            pkey = (op.name(), op.shash(), c[0])
            cached = pmemo.get(pkey)
            if cached is not None:
                pmemo[pkey] = pmemo.pop(pkey)
            else:
                if len(pmemo) >= 64:
                    pmemo.pop(next(iter(pmemo)))
                cached = pmemo[pkey] = jax.device_put(c[2])
            dev_params.append(cached)

        names = "+".join(op.name() for op in seg_ops)
        try:
            with _timing("    fused-suffix " + names):
                outs, quant = jitted(bufin.data, tuple(dev_params))
        except Exception:   # compile/dispatch failure of the fused form
            log.warning("fused-suffix dispatch failed for %s; "
                        "falling back to per-stage", names, exc_info=True)
            memo.pop(key, None)
            return None
        if cache_inter:
            result = bufin
            for i, (c, out) in enumerate(zip(chains, outs)):
                w, h, colors, mono = c[3]
                result = OpBuffer(w, h, colors, mono, out)
                cache.put_arc(ophashes[startpos + i], result,
                              result.nbytes())
        else:
            w, h, colors, mono = chains[-1][3]
            result = OpBuffer(w, h, colors, mono, outs[-1])
            if cache is not None:
                cache.put_arc(ophashes[startpos + len(chains) - 1], result,
                              result.nbytes())
        return result, quant

    # -- outputs (pipeline.rs:377-469) -------------------------------------

    def _fastpath_applicable(self) -> bool:
        return (not self.globals.image.is_raw
                and self.globals.settings.use_fastpath and self.default_ops())

    def _fused_applicable(self) -> bool:
        """RAW full-size develop with default geometry: use the fused engine
        (one device program) instead of per-stage execution. 8-bit output is
        bit-identical to the staged path; 16-bit within +-1 LSB (engine.py)."""
        s = self.globals.settings
        return (self.globals.image.is_raw
                and s.use_fastpath
                and self.ops.rotatecrop._noop())

    def _fused_plan_cached(self, out_bits: int):
        """make_develop_plan memoized on the current (settings, ops) state:
        interactive render loops call output_8bit repeatedly, and a fresh
        DevelopPlan per call would defeat the per-plan device-table and
        staging caches (each rebuild re-uploads calibration)."""
        from .engine import make_develop_plan

        hasher = BufHasher()
        self.globals.settings.hash(hasher)
        for op in self.ops.all_ops():
            op.hash(hasher)
        key = (out_bits, self.globals.settings.linear, hasher.result())
        cached = getattr(self, "_fused_plan", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        plan = make_develop_plan(self, out_bits=out_bits)
        self._fused_plan = (key, plan)
        return plan

    def _run_fused(self, out_bits: int):
        from .engine import develop_fused, planar_to_hwc
        from .sources import staged_raw_plane

        plan = self._fused_plan_cached(out_bits)
        plane = staged_raw_plane(self.globals.image.raw)
        return planar_to_hwc(develop_fused(plan, plane))

    def output_8bit(self, cache: Optional[MultiCache] = None) -> SRGBImage:
        if self._fastpath_applicable():
            with _timing("total output_8bit_fastpath()"):
                rgb = self.globals.image.other.to_rgb8()
                height, width = rgb.shape[:2]
                nwidth, nheight = scaling.scaling_size(
                    width, height,
                    self.globals.settings.maxwidth, self.globals.settings.maxheight)
                if (nwidth, nheight) != (width, height):
                    data = np.asarray(scaling.scale_down_srgb(rgb, nwidth, nheight))
                    return SRGBImage(nwidth, nheight, data)
                return SRGBImage(width, height, rgb)

        if cache is None and self._fused_applicable():
            with _timing("total output_8bit_fused()"):
                self.globals.settings.linear = False
                data = self._run_fused(8)
                return SRGBImage(data.shape[1], data.shape[0], data)

        with _timing("total output_8bit()"):
            self.globals.settings.linear = False
            buffer, quant = self._run_impl(cache, final_quant=8)
            with _timing("  8 bit conversion"):
                if quant is None:
                    quant = output8bit(buffer.data)
                data = np.moveaxis(np.asarray(quant), 0, -1)
            return SRGBImage(buffer.width, buffer.height, data)

    def output_16bit(self, cache: Optional[MultiCache] = None) -> SRGBImage16:
        if self._fastpath_applicable():
            with _timing("total output_16bit_fastpath()"):
                rgb = self.globals.image.other.to_rgb16()
                height, width = rgb.shape[:2]
                nwidth, nheight = scaling.scaling_size(
                    width, height,
                    self.globals.settings.maxwidth, self.globals.settings.maxheight)
                if (nwidth, nheight) != (width, height):
                    data = np.asarray(scaling.scale_down_srgb16(rgb, nwidth, nheight))
                    return SRGBImage16(nwidth, nheight, data)
                return SRGBImage16(width, height, rgb)

        if cache is None and self._fused_applicable():
            with _timing("total output_16bit_fused()"):
                self.globals.settings.linear = True
                data = self._run_fused(16)
                return SRGBImage16(data.shape[1], data.shape[0], data)

        with _timing("total output_16bit()"):
            self.globals.settings.linear = True
            buffer, quant = self._run_impl(cache, final_quant=16)
            with _timing("  16 bit conversion"):
                if quant is None:
                    quant = output16bit(buffer.data)
                data = np.moveaxis(np.asarray(quant), 0, -1)
            return SRGBImage16(buffer.width, buffer.height, data)

"""imagepipe_tpu: a batched RAW-development engine in JAX.

A ground-up JAX/XLA re-design with the capabilities of the reference
Rust crate `imagepipe` (pedrocr/imagepipe): any camera RAW or raster image ->
8/16-bit sRGB through a fixed 8-stage pipeline with content-addressed stage
caching -- plus a new batch dimension sharded over device meshes.

Public surface parity (reference /root/reference/src/lib.rs:7-26):
Pipeline, ImageSource, OpBuffer, SRGBImage(16), Rotation, SplineFunc,
color_conversions, simple_decode_8bit.
"""

from . import color as color_conversions
from .buffer import OpBuffer, from_rgb_str_vec
from .cache import MultiCache
from .cameras import (
    known_cameras, register_alias, register_camera, register_from_dng,
    register_sidecar_dir,
)
from .ops.transform import Rotation
from .pipeline import (
    Pipeline, PipelineCache, PipelineGlobals, PipelineOps, PipelineSettings,
    SRGBImage, SRGBImage16,
)
from .raw import CFA, Orientation, RawImage
from .sources import ImageSource, RasterImage
from .spline import SplineFunc

__version__ = "0.1.0"

__all__ = [
    "color_conversions", "OpBuffer", "from_rgb_str_vec", "MultiCache",
    "Rotation", "Pipeline", "PipelineCache", "PipelineGlobals", "PipelineOps",
    "PipelineSettings", "SRGBImage", "SRGBImage16", "CFA", "Orientation",
    "RawImage", "ImageSource", "RasterImage", "SplineFunc",
    "simple_decode_8bit", "register_camera", "register_alias",
    "register_from_dng", "register_sidecar_dir", "known_cameras",
]


def simple_decode_8bit(path, maxwidth: int = 0, maxheight: int = 0) -> SRGBImage:
    """One-call decode to 8-bit sRGB (lib.rs:21-26)."""
    pipeline = Pipeline.new_from_file(path)
    pipeline.globals.settings.maxwidth = maxwidth
    pipeline.globals.settings.maxheight = maxheight
    return pipeline.output_8bit(None)

"""Device-resident image buffer.

Re-design of OpBuffer (/root/reference/src/buffer.rs:4-114). The reference is
an interleaved host Vec<f32> with rayon row-parallel mutation helpers; here a
buffer is an immutable `jax.Array` shaped [H, W, C] living in HBM, and the
"parallel map" helpers disappear entirely -- ops are pure jnp functions whose
elementwise work XLA fuses and vectorizes across the VPU lanes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

__all__ = ["OpBuffer", "from_rgb_str_vec"]


@dataclasses.dataclass(frozen=True)
class OpBuffer:
    """width x height x colors f32 image plane(s) plus the monochrome flag.

    colors is in {1, 3, 4} like the reference; data is CHANNEL-PLANAR
    [colors, height, width] float32 on the default device: each stage's
    elementwise kernels then read and write whole contiguous planes. Use
    to_hwc()/from_hwc() at host boundaries.
    """

    width: int
    height: int
    colors: int
    monochrome: bool
    data: jnp.ndarray  # [colors, height, width] f32

    _DEFAULT = None

    @staticmethod
    def default() -> "OpBuffer":
        # Memoized: pipeline.run creates one per render, and even an
        # empty-array device op costs a dispatch.
        if OpBuffer._DEFAULT is None:
            OpBuffer._DEFAULT = OpBuffer(0, 0, 0, False,
                                         jnp.zeros((0, 0, 0), jnp.float32))
        return OpBuffer._DEFAULT

    @staticmethod
    def new(width: int, height: int, colors: int, monochrome: bool) -> "OpBuffer":
        return OpBuffer(width, height, colors, monochrome,
                        jnp.zeros((colors, height, width), jnp.float32))

    @staticmethod
    def from_hwc(arr, monochrome: bool = False) -> "OpBuffer":
        arr = jnp.asarray(arr, jnp.float32)
        h, w, c = arr.shape
        return OpBuffer(w, h, c, monochrome, jnp.moveaxis(arr, -1, 0))

    def to_hwc(self) -> np.ndarray:
        """Host-side [H, W, C] view of the buffer."""
        return np.moveaxis(np.asarray(self.data), 0, -1)

    def with_data(self, data: jnp.ndarray, colors: int | None = None,
                  width: int | None = None, height: int | None = None,
                  monochrome: bool | None = None) -> "OpBuffer":
        c, h, w = data.shape
        return OpBuffer(
            width if width is not None else w,
            height if height is not None else h,
            colors if colors is not None else c,
            self.monochrome if monochrome is None else monochrome,
            data,
        )

    def nbytes(self) -> int:
        return self.width * self.height * self.colors * 4

    def transform(self, topleft, topright, bottomleft, width, height) -> "OpBuffer":
        """Inverse-mapped affine resample (buffer.rs:62-79 parity)."""
        from . import scaling

        data = scaling.transform_buffer_planar(
            self.data, self.width, self.height, topleft, topright, bottomleft,
            width, height, self.colors)
        return OpBuffer(width, height, self.colors, self.monochrome, data)

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.data)

    def __eq__(self, other) -> bool:
        if not isinstance(other, OpBuffer):
            return NotImplemented
        return (
            self.width == other.width
            and self.height == other.height
            and self.colors == other.colors
            and self.monochrome == other.monochrome
            and bool(np.array_equal(self.to_numpy(), other.to_numpy()))
        )


def from_rgb_str_vec(rows: list[str]) -> OpBuffer:
    """ASCII-art test fixture constructor (buffer.rs:82-113): 'R'/'G'/'B'/'O'
    (white) / ' ' (black) characters -> a 3-channel buffer."""
    width = len(rows[0])
    height = len(rows)
    lut = {
        "R": (1.0, 0.0, 0.0),
        "G": (0.0, 1.0, 0.0),
        "B": (0.0, 0.0, 1.0),
        "O": (1.0, 1.0, 1.0),
        " ": (0.0, 0.0, 0.0),
    }
    data = np.zeros((height, width, 3), dtype=np.float32)
    for y, row in enumerate(rows):
        assert len(row) == width, "ragged fixture rows"
        for x, ch in enumerate(row):
            data[y, x] = lut[ch]
    return OpBuffer.from_hwc(data)

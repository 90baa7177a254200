"""Small shared helpers (shape contracts)."""

from __future__ import annotations

from typing import Optional, Sequence


def assert_shape(x, ref_shape: Sequence[Optional[int]]) -> None:
    """Assert `x.shape` matches `ref_shape`; None entries are wildcards.

    Counterpart of `long_video_gan_tpu.utils.misc.assert_shape`.
    """
    if x.ndim != len(ref_shape):
        raise AssertionError(f"Wrong number of dimensions: got {x.ndim}, expected {len(ref_shape)}")
    for idx, (size, ref_size) in enumerate(zip(x.shape, ref_shape)):
        if ref_size is not None and int(size) != int(ref_size):
            raise AssertionError(f"Wrong size for dimension {idx}: got {size}, expected {ref_size}")

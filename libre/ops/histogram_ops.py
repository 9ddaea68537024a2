"""Histogram subsystem: per-brick histograms + merge.

Reference: livre/core/data/Histogram.{h,cpp} (1-D bin vector with a data
range, merged via += which requires compatible ranges, min/max index,
ratio) and livre/lib/cache/HistogramObject.cpp:36-119 (per-brick binning
over interior voxels — padding excluded; integer dtypes use the full dtype
range, float data scans its min/max first; uniform-data fast path).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from libre.core.volume_info import DataType

DEFAULT_BINS = 256


@dataclasses.dataclass
class Histogram:
    """Bins + the data range they span (Histogram.h:34-104)."""

    bins: np.ndarray  # (n_bins,) uint64
    min_value: float
    max_value: float

    def __iadd__(self, other: "Histogram") -> "Histogram":
        if (self.min_value, self.max_value) != (other.min_value, other.max_value):
            raise ValueError(
                f"merging histograms with incompatible ranges "
                f"[{self.min_value}, {self.max_value}] vs "
                f"[{other.min_value}, {other.max_value}]"
            )
        if len(self.bins) != len(other.bins):
            raise ValueError("merging histograms with different bin counts")
        self.bins = self.bins + other.bins
        return self

    def __add__(self, other: "Histogram") -> "Histogram":
        out = Histogram(self.bins.copy(), self.min_value, self.max_value)
        out += other
        return out

    @property
    def sum(self) -> int:
        return int(self.bins.sum())

    def is_empty(self) -> bool:
        return self.sum == 0

    @property
    def min_index(self) -> int:
        nz = np.nonzero(self.bins)[0]
        return int(nz[0]) if len(nz) else 0

    @property
    def max_index(self) -> int:
        nz = np.nonzero(self.bins)[0]
        return int(nz[-1]) if len(nz) else 0

    def get_ratio(self, index: int) -> float:
        s = self.sum
        return float(self.bins[index]) / s if s else 0.0

    def get_range(self) -> Tuple[float, float]:
        return (self.min_value, self.max_value)


@jax.jit
def _bincount_256(values01: jnp.ndarray) -> jnp.ndarray:
    """Count values in [0, 1] into 256 bins (device-side)."""
    idx = jnp.clip((values01 * DEFAULT_BINS).astype(jnp.int32), 0, DEFAULT_BINS - 1)
    return jnp.zeros((DEFAULT_BINS,), jnp.int32).at[idx.reshape(-1)].add(1)


def compute_brick_histogram(
    padded_brick_zyx: np.ndarray,
    overlap: Tuple[int, int, int],
    data_type: DataType,
    data_range: Optional[Tuple[float, float]] = None,
    n_bins: int = DEFAULT_BINS,
) -> Histogram:
    """Per-brick histogram over interior (padding-excluded) voxels
    (HistogramObject.cpp:36-119)."""
    ox, oy, oz = overlap
    interior = padded_brick_zyx
    if oz:
        interior = interior[oz:-oz]
    if oy:
        interior = interior[:, oy:-oy]
    if ox:
        interior = interior[:, :, ox:-ox]

    if data_range is not None:
        lo, hi = data_range
    elif data_type.is_float:
        lo = float(interior.min())
        hi = float(interior.max())
    else:
        lo, hi = data_type.default_range
        hi = hi + 1.0  # integer bins cover [min, max] inclusive

    if hi <= lo:  # uniform data fast path (HistogramObject.cpp:58-66)
        bins = np.zeros(n_bins, np.uint64)
        bins[0] = interior.size
        return Histogram(bins, lo, lo)

    vals = np.asarray(interior, np.float64)
    norm = (vals - lo) / (hi - lo)
    if n_bins == DEFAULT_BINS:
        bins = np.asarray(_bincount_256(jnp.asarray(norm, jnp.float32))).astype(
            np.uint64
        )
    else:
        idx = np.clip((norm * n_bins).astype(np.int64), 0, n_bins - 1)
        bins = np.bincount(idx.reshape(-1), minlength=n_bins).astype(np.uint64)
    return Histogram(bins, lo, hi)

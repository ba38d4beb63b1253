"""Perceptual image comparison compatible with mapbox/pixelmatch.

The reference render tests gate on pixelmatch with per-pixel threshold 0.05
and an aggregate differing-pixel ratio <= 1e-4 (reference
ts/src/test/node-canvas-renderer.spec.ts:182-206).  This module reimplements
the pixelmatch algorithm (YIQ color metric after alpha-blending onto white,
with the default antialiasing detector that excludes AA edge pixels) so the
rebuild is held to the exact same acceptance criterion.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Perceptual color difference upper bound (pixelmatch's 35215).
_MAX_YIQ_DELTA = 35215.0


def _blend_to_white(rgba: np.ndarray) -> np.ndarray:
    """(..., 4) u8 -> (..., 3) float channels blended onto white by alpha."""
    c = rgba.astype(np.float64)
    a = c[..., 3:4] / 255.0
    return 255.0 + (c[..., :3] - 255.0) * a


def _yiq(rgb: np.ndarray):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = r * 0.29889531 + g * 0.58662247 + b * 0.11448223
    i = r * 0.59597799 - g * 0.27417610 - b * 0.32180189
    q = r * 0.21147017 - g * 0.52261711 + b * 0.31114694
    return y, i, q


def color_delta(img1: np.ndarray, img2: np.ndarray) -> np.ndarray:
    """Squared perceptual distance per pixel (pixelmatch colorDelta)."""
    equal = np.all(img1 == img2, axis=-1)
    c1 = _blend_to_white(img1)
    c2 = _blend_to_white(img2)
    y1, i1, q1 = _yiq(c1)
    y2, i2, q2 = _yiq(c2)
    dy, di, dq = y1 - y2, i1 - i2, q1 - q2
    delta = 0.5053 * dy * dy + 0.299 * di * di + 0.1957 * dq * dq
    return np.where(equal, 0.0, delta)


def _luma(rgba: np.ndarray) -> np.ndarray:
    y, _, _ = _yiq(_blend_to_white(rgba))
    return y


def _has_many_siblings(img: np.ndarray, x: int, y: int) -> bool:
    h, w = img.shape[:2]
    x0, y0 = max(x - 1, 0), max(y - 1, 0)
    x2, y2 = min(x + 1, w - 1), min(y + 1, h - 1)
    zeroes = 1 if (x == x0 or x == x2 or y == y0 or y == y2) else 0
    center = img[y, x]
    for yy in range(y0, y2 + 1):
        for xx in range(x0, x2 + 1):
            if xx == x and yy == y:
                continue
            if np.array_equal(img[yy, xx], center):
                zeroes += 1
            if zeroes > 2:
                return True
    return False


def _antialiased(img: np.ndarray, x: int, y: int, other: np.ndarray,
                 luma: np.ndarray) -> bool:
    h, w = img.shape[:2]
    x0, y0 = max(x - 1, 0), max(y - 1, 0)
    x2, y2 = min(x + 1, w - 1), min(y + 1, h - 1)
    zeroes = 1 if (x == x0 or x == x2 or y == y0 or y == y2) else 0
    mn = mx = 0.0
    mn_pos = mx_pos = None
    center_y = luma[y, x]
    for yy in range(y0, y2 + 1):
        for xx in range(x0, x2 + 1):
            if xx == x and yy == y:
                continue
            delta = center_y - luma[yy, xx]
            if delta == 0:
                zeroes += 1
                if zeroes > 2:
                    return False
            elif delta < mn:
                mn = delta
                mn_pos = (xx, yy)
            elif delta > mx:
                mx = delta
                mx_pos = (xx, yy)
    if mn == 0 or mx == 0:
        return False
    for pos in (mn_pos, mx_pos):
        if pos is not None:
            px, py = pos
            if _has_many_siblings(img, px, py) and _has_many_siblings(
                other, px, py
            ):
                return True
    return False


@dataclasses.dataclass
class DiffResult:
    diff_count: int
    diff_ratio: float
    aa_count: int
    max_channel_diff: int
    diff_image: np.ndarray  # (H, W, 4) u8 visualization

    @property
    def total(self) -> int:
        return self.diff_image.shape[0] * self.diff_image.shape[1]


def pixelmatch(img1: np.ndarray, img2: np.ndarray,
               threshold: float = 0.1, include_aa: bool = False) -> DiffResult:
    """Count perceptually-different pixels between two (H, W, 4) u8 images."""
    if img1.shape != img2.shape:
        raise ValueError(f"image sizes differ: {img1.shape} vs {img2.shape}")
    h, w = img1.shape[:2]
    delta = color_delta(img1, img2)
    max_delta = _MAX_YIQ_DELTA * threshold * threshold

    # Diff visualization: grayscale base, red = diff, yellow = AA-excluded.
    gray = (_luma(img1) * 0.1 + 166).astype(np.uint8)
    diff_img = np.stack([gray, gray, gray, np.full((h, w), 255, np.uint8)],
                        axis=-1)

    candidates = np.argwhere(delta > max_delta)
    diff_count = 0
    aa_count = 0
    if len(candidates) and not include_aa:
        luma1 = _luma(img1)
        luma2 = _luma(img2)
    for y, x in candidates:
        if not include_aa and (
            _antialiased(img1, x, y, img2, luma1)
            or _antialiased(img2, x, y, img1, luma2)
        ):
            aa_count += 1
            diff_img[y, x] = (255, 255, 0, 255)
        else:
            diff_count += 1
            diff_img[y, x] = (255, 0, 0, 255)

    max_channel = int(
        np.max(np.abs(img1.astype(np.int32) - img2.astype(np.int32)))
    ) if img1.size else 0
    return DiffResult(
        diff_count=diff_count,
        diff_ratio=diff_count / float(h * w),
        aa_count=aa_count,
        max_channel_diff=max_channel,
        diff_image=diff_img,
    )

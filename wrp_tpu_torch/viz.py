"""PPI rendering of volume-scan products: the visualiser role of the
reference's consumer stub (receive.cpp printed raw frames; the upstream
system it fed was a radar display).  Pure numpy, no image libraries: the
output is binary PPM (P6), readable by any viewer or converter.

The port's own copy of ``wrp_tpu/viz.py`` (the port imports nothing of
the JAX package); `cli volume --render` and `--render-all` write the same
bytes as there.

Geometry: one elevation cut is a polar field value[bin, sector] with
`sector` the azimuth index (num_sectors around a full circle, sector 0 at
north, clockwise) and `bin` the range index.  The PPI maps it onto a
cartesian top-down disc.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

#: reflectivity-style color stops (fraction of [vmin, vmax] -> RGB)
_STOPS = np.array([
    [0.00, 0x10, 0x10, 0x30],   # deep blue
    [0.25, 0x20, 0x60, 0xc0],   # blue
    [0.45, 0x20, 0xa0, 0x40],   # green
    [0.65, 0xe0, 0xd0, 0x20],   # yellow
    [0.82, 0xe0, 0x70, 0x20],   # orange
    [1.00, 0xc0, 0x10, 0x10],   # red
], np.float64)


def colormap(frac: np.ndarray) -> np.ndarray:
    """frac in [0, 1] (NaN allowed) -> uint8 RGB; NaN maps to black."""
    frac = np.asarray(frac, np.float64)
    out = np.zeros((*frac.shape, 3), np.uint8)
    ok = np.isfinite(frac)
    f = np.clip(frac[ok], 0.0, 1.0)
    rgb = np.empty((f.size, 3))
    for c in range(3):
        rgb[:, c] = np.interp(f, _STOPS[:, 0], _STOPS[:, c + 1])
    out[ok] = rgb.astype(np.uint8)
    return out


def render_ppi(field: np.ndarray, size: int = 512,
               vmin: float | None = None,
               vmax: float | None = None) -> np.ndarray:
    """Polar product plane [bins, sectors] -> uint8 RGB [size, size, 3].

    Non-finite values (uncovered sectors are NaN, range bin 0 is -inf by
    construction, zdr can be NaN from 0/0) render black.  vmin/vmax
    default to the finite data's 2nd/98th percentile so one hot cell
    can't wash out the display.
    """
    bins, sectors = field.shape
    finite = field[np.isfinite(field)]
    if finite.size:
        if vmin is None:
            vmin = float(np.percentile(finite, 2))
        if vmax is None:
            vmax = float(np.percentile(finite, 98))
    else:
        vmin, vmax = 0.0, 1.0
    if vmax <= vmin:
        vmax = vmin + 1.0

    half = size / 2.0
    yy, xx = np.mgrid[0:size, 0:size]
    dx = (xx + 0.5) - half
    dy = half - (yy + 0.5)              # +y = north = up
    r = np.hypot(dx, dy) / half         # 0..1 at the disc edge
    az = np.mod(np.arctan2(dx, dy), 2 * np.pi)   # 0 at north, clockwise

    bin_idx = np.minimum((r * bins).astype(np.int64), bins - 1)
    sec_idx = np.minimum((az / (2 * np.pi) * sectors).astype(np.int64),
                         sectors - 1)
    vals = field[bin_idx, sec_idx]
    frac = (vals - vmin) / (vmax - vmin)
    frac = np.where(np.isfinite(vals), frac, np.nan)
    img = colormap(frac)
    img[r > 1.0] = 0                    # outside the scan disc
    return img


def render_volume_mosaic(plane: np.ndarray, coverage: np.ndarray,
                         size: int = 256, cols: int = 3,
                         pad: int = 4) -> np.ndarray:
    """All elevation cuts of one product as a tiled PPI mosaic.

    plane: [bins, sectors, elevations]; coverage: [sectors, elevations]
    (uncovered sectors render black).  One SHARED color scale across all
    cuts, so intensity is comparable between elevations — the full
    result[2, 512, 143, 9] volume (rpv2.cu:292) as one image.
    """
    bins, sectors, elevs = plane.shape
    fields = []
    for e in range(elevs):
        f = np.array(plane[:, :, e], np.float64)
        f[:, ~coverage[:, e]] = np.nan
        fields.append(f)
    finite = np.concatenate(
        [f[np.isfinite(f)] for f in fields] or [np.zeros(1)])
    if finite.size:
        vmin = float(np.percentile(finite, 2))
        vmax = float(np.percentile(finite, 98))
    else:
        vmin, vmax = 0.0, 1.0
    rows = (elevs + cols - 1) // cols
    h = rows * size + (rows + 1) * pad
    w = cols * size + (cols + 1) * pad
    canvas = np.zeros((h, w, 3), np.uint8)
    for e, f in enumerate(fields):
        r, c = divmod(e, cols)
        y = pad + r * (size + pad)
        x = pad + c * (size + pad)
        canvas[y:y + size, x:x + size] = render_ppi(f, size, vmin, vmax)
    return canvas


def write_ppm(path: str | Path, img: np.ndarray) -> Path:
    """Binary PPM (P6) — no imaging dependency needed to view/convert."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    assert c == 3, img.shape
    path = Path(path)
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())
    return path

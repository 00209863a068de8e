"""Volume-scan accumulation + checkpoint/resume.

The reference accumulates every sector's products into a full volume-scan
host buffer result[2, 512, 143, 9] (rpv2.cu:292,606-611) but never persists
it (SURVEY.md section 5: "Checkpoint / resume: None").  This closes that
gap: the same layout, plus atomic .npz checkpointing with coverage masks so
a restarted processor resumes exactly where the scan stopped.

The .npz layout (data, coverage, geometry) is the one ``wrp_tpu.runtime.
volume`` writes, so checkpoints move between the two packages both ways
(tests/test_torch_stream.py).
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from ..config import RadarConfig, DEFAULT_CONFIG


class VolumeScan:
    """In-memory volume products [2(zdb/zdr), m/2, sectors, elevations]
    with per-(sector, elevation) coverage tracking."""

    def __init__(self, cfg: RadarConfig = DEFAULT_CONFIG,
                 path: Optional[str | Path] = None):
        self.cfg = cfg
        self.path = Path(path) if path else None
        shape = (2, cfg.num_output_bins, cfg.num_sectors, cfg.num_elevations)
        self.data = np.full(shape, np.nan, np.float32)
        self.coverage = np.zeros((cfg.num_sectors, cfg.num_elevations), bool)

    def store(self, sector: int, elevation: int,
              zdb: np.ndarray, zdr: np.ndarray) -> None:
        self.data[0, :, sector, elevation] = zdb
        self.data[1, :, sector, elevation] = zdr
        self.coverage[sector, elevation] = True

    def complete(self) -> bool:
        return bool(self.coverage.all())

    def fraction(self) -> float:
        return float(self.coverage.mean())

    # ------------------------------------------------------------------

    def save(self, path: Optional[str | Path] = None) -> Path:
        """Atomic checkpoint (write-temp + rename)."""
        path = path if path is not None else self.path
        if path is None:
            raise ValueError("no checkpoint path configured")
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez_compressed(
                    f, data=self.data, coverage=self.coverage,
                    geometry=np.array([self.cfg.num_output_bins,
                                       self.cfg.num_sectors,
                                       self.cfg.num_elevations]),
                )
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return path

    @classmethod
    def load(cls, path: str | Path,
             cfg: Optional[RadarConfig] = None) -> "VolumeScan":
        """cfg=None reconstructs the geometry from the checkpoint itself
        (it is self-describing); passing a config enforces a match."""
        import dataclasses

        with np.load(path) as z:
            geom = tuple(int(v) for v in z["geometry"])
            if cfg is None:
                cfg = dataclasses.replace(
                    DEFAULT_CONFIG,
                    num_range_cells=2 * geom[0],
                    num_sectors=geom[1],
                    num_elevations=geom[2],
                )
            elif geom != (cfg.num_output_bins, cfg.num_sectors,
                          cfg.num_elevations):
                raise ValueError(
                    f"checkpoint geometry {geom} != config "
                    f"{(cfg.num_output_bins, cfg.num_sectors, cfg.num_elevations)}"
                )
            vs = cls(cfg, path)
            vs.data = z["data"]
            vs.coverage = z["coverage"]
        return vs

"""Uniform ingest statistics across transports.

The reference had no loss accounting at all — dropped/duplicated UDP
datagrams silently corrupted a sector (SURVEY.md section 5).  Every
transport carries the same `stats` object so the executor's summary is
comparable regardless of wire.  Same fields as ``wrp_tpu.io.stats``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class IngestStats:
    sectors: int = 0
    datagrams: int = 0
    dropped_datagrams: int = 0
    duplicate_datagrams: int = 0
    dropped_sectors: int = 0
    timeouts: int = 0

"""Result/ingest frame formats of the reference's v1 UDP wire (the v2 ZMQ
frames of ``wrp_tpu.io.frames`` come with the ZMQ transport, ROADMAP.md).

v1 UDP result frame  (read_single.cc:510-520):
    [sector_id : int16 BE][m/2 x float32 BE]                 (2050 bytes)

Ingest framing:
    v1 UDP: one sector = m datagrams of one pulse-row each
            (read_single.cc:145-148).

The reference has no sequencing or integrity metadata — dropped/reordered
datagrams silently corrupt a sector (SURVEY.md section 5).  We additionally
support an extended ingest header (magic+sector+elevation+row) that enables
drop detection and resequencing; it is off by default for wire parity.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from .codec import encode_be_float32, decode_be_float32


# ---------------------------------------------------------------------------
# Result frames.
# ---------------------------------------------------------------------------


def pack_result_v1(sector: int, values: np.ndarray) -> bytes:
    return struct.pack(">h", sector) + encode_be_float32(values)


def unpack_result_v1(buf: bytes):
    (sector,) = struct.unpack_from(">h", buf, 0)
    return sector, decode_be_float32(buf[2:])


#: Extended ("v1x") UDP result frame — a framework addition mirroring the
#: ingest extension: the v1 result frame carries no elevation
#: (read_single.cc:510-520), so a UDP consumer can never place results
#: into the 143x9 volume the reference accumulates in result[2,512,143,9]
#: (rpv2.cu:292).  Layout: [magic:uint16 BE][sector:uint16 BE]
#: [elevation:uint16 BE][m/2 x float32 BE].  The magic has its high bit
#: set, so it can never collide with a v1 frame's leading sector id
#: (sector ids are small non-negative int16s); plain-v1 consumers keep
#: working when the producer keeps the default (extended off).
RESULT_MAGIC = 0xD752  # "WR" | 0x8000
_V1X_HEADER = struct.Struct(">HHH")


def pack_result_v1x(sector: int, elevation: int,
                    values: np.ndarray) -> bytes:
    return _V1X_HEADER.pack(RESULT_MAGIC, sector,
                            elevation) + encode_be_float32(values)


def unpack_result_udp(buf: bytes):
    """Either UDP result flavour -> (sector, elevation | None, values):
    v1x when the magic matches, bare v1 otherwise."""
    if len(buf) >= _V1X_HEADER.size:
        magic, sector, elevation = _V1X_HEADER.unpack_from(buf, 0)
        if magic == RESULT_MAGIC:
            return (sector, elevation,
                    decode_be_float32(buf[_V1X_HEADER.size:]))
    sector, values = unpack_result_v1(buf)
    return sector, None, values


# ---------------------------------------------------------------------------
# Extended ingest header (framework addition; fixes the reference's silent
# corruption on datagram loss).
# ---------------------------------------------------------------------------

INGEST_MAGIC = 0x5752  # "WR"
_EXT_HEADER = struct.Struct(">HHHH")  # magic, sector, elevation, row


@dataclasses.dataclass(frozen=True)
class IngestHeader:
    sector: int
    elevation: int
    row: int

    SIZE = _EXT_HEADER.size


def pack_ingest_row(header: IngestHeader, payload: bytes) -> bytes:
    return _EXT_HEADER.pack(INGEST_MAGIC, header.sector, header.elevation,
                            header.row) + payload


def try_unpack_ingest_row(buf: bytes):
    """Returns (IngestHeader, payload) if buf carries the extended header,
    else (None, buf) — raw v1 datagrams pass straight through."""
    if len(buf) >= IngestHeader.SIZE:
        magic, sector, elevation, row = _EXT_HEADER.unpack_from(buf, 0)
        if magic == INGEST_MAGIC:
            return (IngestHeader(sector, elevation, row),
                    buf[IngestHeader.SIZE:])
    return None, buf

"""Radar geometry / calibration / runtime configuration.

The reference hardcodes all of this as compile-time constants scattered over
every executable (e.g. rpv2.cu:38-45, read.cc:64-70,
read_single.cc:15,76-82, and ports at read_single.cc:125-127 /
rpv2.cu:217-219).  Here it is one frozen dataclass threaded through the
whole framework, so geometry, calibration, wire ports and mesh shape are all
runtime-configurable (and test configs can shrink the problem).

Pure Python: a copy of ``wrp_tpu.config`` (which cannot be imported
without JAX), held equal to it by tests/test_torch_constants.py.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RadarConfig:
    """Geometry + physics constants of the polarimetric pulse-Doppler chain."""

    # --- geometry (reference: rpv2.cu:38-42, read.cc:64-65) ---
    num_range_cells: int = 1024        # m: fast-time samples per pulse ("cell")
    num_pulses: int = 512              # n: sweeps/pulses per sector ("sweep")
    num_channels: int = 3              # hh, vv, vh  (sector.h:10)
    num_sectors: int = 143             # azimuth sectors per elevation cut
    num_elevations: int = 9            # elevation cuts per volume scan

    # --- physics / calibration (reference: read.cc:26,67-70) ---
    ma_count: int = 7                  # matched-filter (moving-average) taps
    range_resolution: float = 30.0     # k_rangeres, metres per range bin
    calibration: float = 1941.05       # k_calib reflectivity constant
    adc_scale: float = 16383.5         # 14-bit ADC full-scale (read.cc:26)
    impedance: float = 50.0            # power computed w.r.t. 50 ohm

    # --- wire formats (reference: read_single.cc:15,125-127; rpv2.cu:217-219) ---
    udp_ingest_port: int = 19001
    udp_zdb_port: int = 19002
    udp_zdr_port: int = 19003
    zmq_sub_endpoint: str = "tcp://localhost:5563"
    zmq_pub_endpoint: str = "tcp://*:5564"
    zmq_ingest_topic: bytes = b"A"
    zmq_zdb_topic: bytes = b"B"
    zmq_zdr_topic: bytes = b"C"
    tcp_ingest_port: int = 19011       # tcp.{h,cpp} equivalent (io/tcp.py)
    tcp_result_port: int = 19012

    # ------------------------------------------------------------------
    @property
    def bytes_per_sample(self) -> int:
        """Wire bytes per sample: channels x I/Q x int16 BE (12 for the
        reference's 3 channels, read_single.cc:15) — derived so reduced-
        channel configs keep the codec and datagram sizes consistent."""
        return self.num_channels * 4

    @property
    def m(self) -> int:
        return self.num_range_cells

    @property
    def n(self) -> int:
        return self.num_pulses

    @property
    def num_output_bins(self) -> int:
        """Range bins in the final zdb/zdr products (first m/2 rows kept,
        reference read.cc:281, rpv2.cu:502-504)."""
        return self.num_range_cells // 2

    @property
    def sector_shape(self) -> Tuple[int, int, int]:
        """Per-sector IQ tensor shape [channel, range, pulse]."""
        return (self.num_channels, self.num_range_cells, self.num_pulses)

    @property
    def sector_nbytes_wire(self) -> int:
        """Raw wire size of one sector (interleaved BE int16)."""
        return self.bytes_per_sample * self.num_range_cells * self.num_pulses

    @property
    def datagram_nbytes(self) -> int:
        """One UDP datagram = one pulse row of all channels
        (read_single.cc:145-148)."""
        return self.bytes_per_sample * self.num_pulses

    @property
    def sectors_per_volume(self) -> int:
        return self.num_sectors * self.num_elevations

    def validate(self) -> "RadarConfig":
        if self.num_range_cells % 2:
            raise ValueError("num_range_cells must be even (half-spectrum keep)")
        if self.num_pulses % 2:
            raise ValueError("num_pulses must be even (fftshift)")
        if self.ma_count > self.num_pulses:
            raise ValueError("ma_count must be <= num_pulses")
        return self


DEFAULT_CONFIG = RadarConfig().validate()


def tiny_config(m: int = 64, n: int = 32, channels: int = 3) -> RadarConfig:
    """A shrunk geometry for fast tests / multi-chip dry runs."""
    return dataclasses.replace(
        DEFAULT_CONFIG,
        num_range_cells=m,
        num_pulses=n,
        num_channels=channels,
        num_sectors=8,
        num_elevations=2,
        ma_count=min(DEFAULT_CONFIG.ma_count, n),
    ).validate()

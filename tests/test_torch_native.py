"""The port's native host library (wrp_tpu_torch/native/: the wire codec and
the GIL-free UDP reassembly loop) against the port's numpy codec and Python
loop and against wrp_tpu's native codec, bit for bit.

No timing here: the decodes run at tiny_config with at most 2 threads, plus
one full-size sector, so that this file adds little CPU load beside the
suite's CPU-time floor (tests/test_native_codec.py)."""

import dataclasses
import socket
import threading
import time

import numpy as np
import pytest

from wrp_tpu_torch.config import DEFAULT_CONFIG, tiny_config
from wrp_tpu_torch.io import codec, frames
from wrp_tpu_torch.io.udp import UdpIngest
from wrp_tpu_torch.native import build, codec_native, ingest_native

jnative = pytest.importorskip("wrp_tpu.native.codec_native")

TINY = tiny_config(m=64, n=32)
#: (config, decode threads): 3 and 2 channels at tiny_config, an n % 4 != 0
#: tail, and one full-size sector
CASES = [(TINY, 1), (TINY, 2), (tiny_config(m=32, n=16, channels=2), 2),
         (tiny_config(m=16, n=6), 2), (DEFAULT_CONFIG, 2)]
IDS = ["tiny-1t", "tiny-2t", "2ch", "n6", "full"]


def _wire(cfg, seed=0) -> bytes:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, cfg.sector_nbytes_wire, np.uint8).tobytes()


def _dims(cfg):
    return cfg.num_range_cells, cfg.num_pulses, cfg.num_channels


@pytest.mark.parametrize("cfg,threads", CASES, ids=IDS)
def test_decode_is_bit_exact(cfg, threads):
    """decode_iq and decode_iq_i16 (fresh and into planar_out) == the port's
    numpy codec == wrp_tpu's native codec at natural order."""
    wire = _wire(cfg)
    m, n, ch = _dims(cfg)
    for fn, dtype in ((codec_native.decode_iq, np.float32),
                      (codec_native.decode_iq_i16, np.int16)):
        got = fn(wire, m, n, ch, num_threads=threads)
        want = getattr(codec, fn.__name__)(wire, cfg, native=False)
        jwant = getattr(jnative, fn.__name__)(wire, m, n, ch,
                                              num_threads=threads)
        assert got.dtype == want.dtype == jwant.dtype == dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jwant)
        out = np.full((ch, 2, m, n), 7, dtype)
        assert fn(wire, m, n, ch, out=out, num_threads=threads) is out
        np.testing.assert_array_equal(out, want)


def test_codec_module_runs_native_by_default():
    """io/codec's decoders take the native codec unless native=False, and
    write into planar_out either way."""
    wire = _wire(TINY, seed=1)
    for name, dtype in (("decode_iq", np.float32),
                        ("decode_iq_i16", np.int16)):
        fn = getattr(codec, name)
        plain = fn(wire, TINY, native=False)
        np.testing.assert_array_equal(fn(wire, TINY), plain)
        for native in (True, False):
            out = np.zeros_like(plain)
            assert fn(wire, TINY, planar_out=out, native=native) is out
            np.testing.assert_array_equal(out, plain)
            assert out.dtype == dtype


@pytest.mark.parametrize("group,slot", [(1, 0), (2, 1), (3, 2), (4, 1)])
def test_grouped_decode_is_bit_exact(group, slot):
    """decode_iq_i16_grouped: native == numpy == wrp_tpu's native emit;
    rows outside the slot's channel-sectors stay untouched."""
    wire = _wire(TINY, seed=group)
    m, n, ch = _dims(TINY)
    groups = (4 * ch + group - 1) // group       # room for 4 sectors
    stages = [np.full((groups, 2, m, group * n), -5, np.int16)
              for _ in range(3)]
    codec.decode_iq_i16_grouped(wire, stages[0], slot, group, TINY)
    codec.decode_iq_i16_grouped(wire, stages[1], slot, group, TINY,
                                native=False)
    jnative.decode_iq_i16_grouped(wire, m, n, ch, stages[2], slot, group,
                                  num_threads=2)
    np.testing.assert_array_equal(stages[0], stages[1])
    np.testing.assert_array_equal(stages[0], stages[2])
    planar = codec.decode_iq_i16(wire, TINY, native=False)
    for c in range(ch):
        i = slot * ch + c
        lane = (i % group) * n
        np.testing.assert_array_equal(
            stages[0][i // group, :, :, lane:lane + n], planar[c])
    assert (stages[0] == -5).sum() == stages[0].size - planar.size


@pytest.mark.parametrize("cfg", [TINY, tiny_config(m=16, n=6),
                                 tiny_config(m=32, n=16, channels=2)],
                         ids=["tiny", "n6", "2ch"])
def test_encoders_are_bit_exact(cfg):
    """encode_iq (integer-valued, halves rounding to even, the int16 range)
    and encode_be_f32 == the port's numpy encoders == wrp_tpu's natives."""
    m, n, ch = _dims(cfg)
    rng = np.random.default_rng(3)
    planar = rng.integers(-32768, 32768, (ch, 2, m, n)).astype(np.float32)
    planar.flat[:8] = [0.5, 1.5, -0.5, -2.5, 2.5, 32767, -32768, 3.49]
    wire = codec_native.encode_iq(planar)
    assert wire == codec.encode_iq(planar[:, 0] + 1j * planar[:, 1], cfg)
    assert wire == jnative.encode_iq(planar)
    np.testing.assert_array_equal(
        codec.decode_iq(wire, cfg, native=False),
        np.round(planar).astype(np.int16).astype(np.float32))
    vals = np.concatenate([rng.standard_normal(999).astype(np.float32),
                           np.array([np.inf, -0.0, np.nan], np.float32)])
    be = codec_native.encode_be_f32(vals)
    assert be == codec.encode_be_float32(vals) == jnative.encode_be_f32(vals)


def test_out_array_refusals():
    """A wrong dtype, shape, a non-contiguous or read-only out array, a
    short wire buffer or a slot past the stage raises before any pointer
    reaches C++."""
    m, n, ch = 8, 4, 3
    wire = bytes(m * n * ch * 4)
    bad = [np.empty((ch, 2, m, n), np.int16),
           np.empty((ch, 2, m, n + 1), np.float32),
           np.empty((ch, 2, m, 2 * n), np.float32)[..., ::2]]
    ro = np.empty((ch, 2, m, n), np.float32)
    ro.flags.writeable = False
    for out in bad + [ro]:
        with pytest.raises(ValueError, match="out must"):
            codec_native.decode_iq(wire, m, n, ch, out=out)
    with pytest.raises(ValueError, match="out must"):
        codec_native.decode_iq_i16(wire, m, n, ch,
                                   out=np.empty((ch, 2, m, n), np.float32))
    with pytest.raises(ValueError, match="too short"):
        codec_native.decode_iq_i16(wire[:-1], m, n, ch)
    stage = np.zeros((3, 2, m, 2 * n), np.int16)
    with pytest.raises(ValueError, match="beyond"):
        codec_native.decode_iq_i16_grouped(wire, m, n, ch, stage, 2, 2)
    with pytest.raises(ValueError, match="stage must"):
        codec_native.decode_iq_i16_grouped(wire, m, n, ch, stage, 0, 3)
    with pytest.raises(ValueError, match="int16"):
        codec_native.decode_iq_i16_grouped(wire, m, n, ch,
                                           stage.astype(np.int32), 0, 2)
    with pytest.raises(ValueError, match="planar must"):
        codec_native.encode_iq(np.zeros((ch, 3, m, n), np.float32))
    with pytest.raises(ValueError, match="int64"):
        ingest_native.recv_sector(0, 1, bytearray(64), 2, 32,
                                  np.zeros(5, np.int32),
                                  np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="bytes"):
        ingest_native.recv_sector(0, 1, bytearray(63), 2, 32,
                                  np.zeros(5, np.int64),
                                  np.zeros(3, np.int32))


def test_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No quiet fallback: a source g++ refuses raises, naming its error."""
    src = tmp_path / "codec.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(build, "SOURCES", (src,))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*error"):
        build.build()
    assert not list((tmp_path / "_build").glob("*.so"))


def _scenario(native: bool) -> list:
    """Datagrams over loopback into a UdpIngest, and what it returns: a
    whole sector with headers, shuffled, one row twice; a sector whose
    producer moved on mid-way (header resync); a wrong-length datagram; a
    bare v1 sector with one row lost (a stall); an idle timeout."""
    cfg = TINY
    m, rb = cfg.num_range_cells, cfg.datagram_nbytes
    wires = [_wire(cfg, seed=s) for s in (10, 11, 12)]
    rows = [[w[r * rb:(r + 1) * rb] for r in range(m)] for w in wires]
    out = []
    with UdpIngest(cfg, host="127.0.0.1", port=0, timeout_s=0.2,
                   native=native, rcvbuf_bytes=1 << 22) as ingest:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        addr = ("127.0.0.1", ingest.local_port)
        try:
            order = np.random.default_rng(5).permutation(m)
            for r in order[:10]:
                tx.sendto(frames.pack_ingest_row(
                    frames.IngestHeader(3, 1, int(r)), rows[0][r]), addr)
            tx.sendto(frames.pack_ingest_row(
                frames.IngestHeader(3, 1, int(order[0])), rows[0][order[0]]),
                addr)
            for r in order[10:]:
                tx.sendto(frames.pack_ingest_row(
                    frames.IngestHeader(3, 1, int(r)), rows[0][r]), addr)
            buf, hdr = ingest.recv_sector()
            out.append(("whole", bytes(buf) == wires[0],
                        (hdr.sector, hdr.elevation)))
            for r in range(m // 2):                    # sector 4: half
                tx.sendto(frames.pack_ingest_row(
                    frames.IngestHeader(4, 1, r), rows[1][r]), addr)
            tx.sendto(b"\x01" * (rb + 3), addr)       # wrong length
            for r in range(m):                         # sector 5: whole
                tx.sendto(frames.pack_ingest_row(
                    frames.IngestHeader(5, 1, r), rows[2][r]), addr)
            buf, hdr = ingest.recv_sector()
            out.append(("resync", bytes(buf) == wires[2],
                        (hdr.sector, hdr.elevation)))
            for r in range(m):                         # bare v1, row 7 lost
                if r != 7:
                    tx.sendto(rows[1][r], addr)
            with pytest.raises(TimeoutError):
                ingest.recv_sector()
            out.append(("stall",))
            out.append(("idle", ingest.recv_sector()))
        finally:
            tx.close()
        out.append(dataclasses.asdict(ingest.stats))
    return out


def test_udp_ingest_native_matches_python_loop():
    """UdpIngest(native=True) == native=False on loopback, outcome by
    outcome and stat by stat; and the stats are the expected ones."""
    got, want = _scenario(True), _scenario(False)
    assert got == want
    m = TINY.num_range_cells
    assert got[:4] == [("whole", True, (3, 1)), ("resync", True, (5, 1)),
                       ("stall",), ("idle", (None, None))]
    assert got[4] == {"datagrams": (m + 1) + (m // 2 + 1 + m) + (m - 1),
                      "dropped_datagrams": 1 + m // 2 + 1,
                      "dropped_sectors": 2, "timeouts": 2,
                      "duplicate_datagrams": 1, "sectors": 2}


def test_udp_drain_holds_more_than_the_socket():
    """The native drain moves datagrams into its ring while nobody
    receives: 50 sectors sent in three bursts (each within the socket's
    buffer, the drain given time to empty it between them) outnumber both
    the socket's buffer and the ring (1 MiB: 41 sectors), and all 50 are
    received whole afterwards; the last ones waited in the socket while
    the ring was full.  One datagram longer than a ring slot, in the
    first sector, is refused by its length, as from the socket."""
    cfg = TINY
    m, rb = cfg.num_range_cells, cfg.datagram_nbytes
    wires = [_wire(cfg, seed=s) for s in range(4)]
    with UdpIngest(cfg, host="127.0.0.1", port=0, timeout_s=1.0,
                   rcvbuf_bytes=1 << 20) as ingest:
        slots = (1 << 20) // (rb + frames.IngestHeader.SIZE)
        assert 40 * m < slots < 50 * m
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        addr = ("127.0.0.1", ingest.local_port)
        try:
            k = 0
            for burst in (20, 20, 10):
                for _ in range(burst):
                    w = wires[k % 4]
                    for r in range(m):
                        tx.sendto(frames.pack_ingest_row(
                            frames.IngestHeader(k, 0, r),
                            w[r * rb:(r + 1) * rb]), addr)
                        if k == 0 and r == 10:
                            tx.sendto(frames.pack_ingest_row(
                                frames.IngestHeader(0, 0, 11),
                                b"\x01" * (2 * rb)), addr)
                    k += 1
                time.sleep(0.3)
        finally:
            tx.close()
        got = []
        for _ in range(50):
            buf, hdr = ingest.recv_sector()
            got.append((hdr.sector, bytes(buf) == wires[hdr.sector % 4]))
        assert ingest.recv_sector() == (None, None)
    assert got == [(k, True) for k in range(50)]
    assert dataclasses.asdict(ingest.stats) == {
        "datagrams": 50 * m + 1, "dropped_datagrams": 1, "dropped_sectors": 0,
        "timeouts": 1, "duplicate_datagrams": 0, "sectors": 50}


def test_udp_ingest_close_wakes_a_waiting_receive():
    """close() stops the drain under a receive that waits without a
    timeout: the receive raises OSError at once, as one on a closed socket
    does, and so does every receive after it."""
    ingest = UdpIngest(TINY, host="127.0.0.1", port=0, timeout_s=None)
    raised = []

    def receive():
        try:
            ingest.recv_sector()
        except OSError as e:
            raised.append(e)

    t = threading.Thread(target=receive)
    t.start()
    time.sleep(0.2)
    assert t.is_alive()
    t0 = time.perf_counter()
    ingest.close()
    t.join(timeout=5.0)
    assert not t.is_alive() and len(raised) == 1
    assert time.perf_counter() - t0 < 2.0
    with pytest.raises(OSError):
        ingest.recv_sector()
    ingest.close()


def test_udp_drain_ab_tool(capsys):
    """tools/udp_drain_ab.py on a short paced stream without GIL holds:
    both receives get every sector and drop nothing."""
    import json

    from wrp_tpu_torch.tools import udp_drain_ab

    assert udp_drain_ab.main(["--sectors", "3", "--hold-ms", "0",
                              "--rcvbuf", str(1 << 24),
                              "--turns", "drain,socket"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [t["kind"] for t in out["turns"]] == ["drain", "socket"]
    for t in out["turns"]:
        assert (t["received"], t["dropped_datagrams"],
                t["dropped_sectors"]) == (3, 0, 0)
        assert t["receiver_cpu_ms_a_sector"] > 0

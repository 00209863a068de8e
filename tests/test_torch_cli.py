"""The rest of the port's CLI on the CPU, held against wrp_tpu's on the same
seeded inputs: the file readers and writers, viz, `compare`, `volume`,
`process --timings` and `stream --trace`.  Tiny geometry, ephemeral ports."""

import io
import json
import threading
import time

import numpy as np
import pytest
import torch

from wrp_tpu import cli as jcli
from wrp_tpu import config as jconfig
from wrp_tpu import oracle as joracle
from wrp_tpu import viz as jviz
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu.io import files as jfiles
from wrp_tpu_torch import cli, viz
from wrp_tpu_torch import config as tconfig
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.io import files
from wrp_tpu_torch.runtime import VolumeScan

# few CPU threads per worker: the suite runs 6 workers at once
torch.set_num_threads(2)

M, N = 64, 32
STAGES = ["01hamm", "02fft1", "03fft2", "04abs", "07conv", "08pow"]


def _volume(tmp_path, seed=0):
    """A port VolumeScan at tiny geometry: most sectors of elevation 0 and
    a few of elevation 1 covered, zdb bin 0 -inf, one zdr NaN (0/0)."""
    cfg = tiny_config(m=M, n=N)
    rng = np.random.default_rng(seed)
    vs = VolumeScan(cfg, tmp_path / "vol.npz")
    for sec, elev in [(s, 0) for s in range(6)] + [(1, 1), (4, 1)]:
        zdb = rng.normal(20.0, 8.0, M // 2).astype(np.float32)
        zdb[0] = -np.inf
        zdr = rng.normal(0.0, 1.5, M // 2).astype(np.float32)
        zdr[3] = np.nan
        vs.store(sec, elev, zdb, zdr)
    return vs.save()


# ---------------------------------------------------------------- files


def test_read_result_file_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    pair = np.stack([rng.normal(size=M // 2), rng.normal(size=M // 2)], 1)
    pair[0, 0] = -np.inf
    path = tmp_path / "r.out"
    files.write_ascii_matrix(path, pair)
    for got, want in zip(files.read_result_file(path),
                         jfiles.read_result_file(path)):
        np.testing.assert_array_equal(got, want)
    files.write_ascii_matrix(tmp_path / "three.out", np.ones((4, 3)))
    with pytest.raises(ValueError, match="expected 2 columns"):
        files.read_result_file(tmp_path / "three.out")


def test_read_be_float32_bin_matches_jax(tmp_path):
    a = np.random.default_rng(2).normal(size=777).astype(">f4")
    path = tmp_path / "w.bin"
    a.tofile(path)
    got, want = files.read_be_float32_bin(path), jfiles.read_be_float32_bin(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_read_zdb_dump_matches_jax(tmp_path):
    a = np.random.default_rng(3).normal(size=(3, 512)).astype("<f4")
    a[:, 0] = -np.inf
    path = tmp_path / "cpu.bin"
    a.tofile(path)
    got, want = files.read_zdb_dump(path), jfiles.read_zdb_dump(path)
    assert got.shape == want.shape == (3, 512)
    np.testing.assert_array_equal(got, want)
    # a partial sector is refused by both
    np.ones(700, "<f4").tofile(path)
    for mod in (files, jfiles):
        with pytest.raises(ValueError, match="whole number"):
            mod.read_zdb_dump(path)


def test_write_ascii_iq_matches_jax():
    rng = np.random.default_rng(4)
    iq = (rng.integers(-8192, 8192, (2, 4, 3))
          + 1j * rng.integers(-8192, 8192, (2, 4, 3)))
    mine, theirs = io.StringIO(), io.StringIO()
    files.write_ascii_iq(mine, iq)
    jfiles.write_ascii_iq(theirs, iq)
    assert mine.getvalue() == theirs.getvalue()
    back = files.read_ascii_iq(io.StringIO(mine.getvalue()), 4, 3, channels=2)
    np.testing.assert_array_equal(back, iq)


# ---------------------------------------------------------------- viz


@pytest.mark.parametrize("size", [48, 97])
def test_render_ppi_byte_identical(tmp_path, size):
    rng = np.random.default_rng(size)
    field = rng.normal(10.0, 5.0, (M // 2, 8))
    field[0] = -np.inf                     # bin 0
    field[:, 5] = np.nan                   # an uncovered sector
    field[7, 2] = 1e9                      # one hot cell
    img = viz.render_ppi(field, size=size)
    np.testing.assert_array_equal(img, jviz.render_ppi(field, size=size))
    a = viz.write_ppm(tmp_path / "a.ppm", img)
    b = jviz.write_ppm(tmp_path / "b.ppm", img)
    assert a.read_bytes() == b.read_bytes()
    # all non-finite: the default scale, black everywhere
    nan = np.full((M // 2, 8), np.nan)
    np.testing.assert_array_equal(viz.render_ppi(nan, size=16),
                                  jviz.render_ppi(nan, size=16))


def test_render_volume_mosaic_byte_identical():
    rng = np.random.default_rng(6)
    plane = rng.normal(20.0, 6.0, (M // 2, 8, 4)).astype(np.float32)
    plane[0] = -np.inf
    coverage = rng.random((8, 4)) < 0.6
    coverage[:, 3] = False                 # an empty cut
    got = viz.render_volume_mosaic(plane, coverage, size=40, cols=3, pad=2)
    want = jviz.render_volume_mosaic(plane, coverage, size=40, cols=3, pad=2)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- compare


def _compare_inputs(tmp_path, case):
    rng = np.random.default_rng(9)
    if case == "bin":
        a = rng.normal(size=(2, 512)).astype("<f4")
        a[:, 0] = -np.inf
        b = a * (1 + 1e-6 * rng.normal(size=a.shape)).astype("<f4")
        pa, pb = tmp_path / "e.bin", tmp_path / "a.bin"
        a.tofile(pa)
        b.astype("<f4").tofile(pb)
        return pa, pb, []
    a = rng.normal(size=(M // 2, 2))
    a[0, 0] = -np.inf
    b = {"pass": a * (1 + 1e-7), "fail": a * 1.01,
         "shape": a[:-1]}[case]
    pa, pb = tmp_path / "e.out", tmp_path / "a.out"
    files.write_ascii_matrix(pa, a)
    files.write_ascii_matrix(pb, b)
    return pa, pb, (["--threshold", "5e-3"] if case == "fail" else [])


@pytest.mark.parametrize("case,rc", [("pass", 0), ("fail", 1), ("shape", 2),
                                     ("bin", 0)])
def test_compare_matches_jax(tmp_path, capsys, case, rc):
    pa, pb, extra = _compare_inputs(tmp_path, case)
    argv = ["compare", str(pa), str(pb)] + extra
    assert cli.main(argv) == rc
    mine = capsys.readouterr()
    assert jcli.main(argv) == rc
    theirs = capsys.readouterr()
    assert mine.out == theirs.out
    assert mine.err == theirs.err
    if case == "shape":
        assert mine.out == "" and "shape mismatch" in mine.err
    else:
        line = json.loads(mine.out)
        assert set(line) == {"relative_l2", "threshold", "pass"}
        assert line["pass"] is (rc == 0)


# ---------------------------------------------------------------- volume


@pytest.mark.parametrize("product,elevation", [("zdb", 0), ("zdr", 1)])
def test_volume_matches_jax(tmp_path, capsys, product, elevation):
    ckpt = _volume(tmp_path)
    outs = {}
    for tag, main in (("port", cli.main), ("jax", jcli.main)):
        d = tmp_path / tag
        d.mkdir()
        argv = ["volume", str(ckpt), "--export", str(d / "x.npz"),
                "--export-ascii", str(d / "ascii"), "--render",
                str(d / "ppi.ppm"), "--render-all", str(d / "all.ppm"),
                "--product", product, "--elevation", str(elevation),
                "--render-size", "64"]
        assert main(argv) == 0
        outs[tag] = (d, capsys.readouterr().out)
    (dp, out_p), (dj, out_j) = outs["port"], outs["jax"]
    assert out_p == out_j
    info = json.loads(out_p)
    assert info["sectors_covered"] == 8 and info["elevations_touched"] == 2
    assert not info["complete"] and "zdr_mean" in info
    with np.load(dp / "x.npz") as a, np.load(dj / "x.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["coverage", "zdb", "zdr"]
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    names = sorted(p.name for p in (dp / "ascii").iterdir())
    assert names == sorted(p.name for p in (dj / "ascii").iterdir())
    assert len(names) == 8 and "s004e1.out" in names
    for name in names:
        assert (dp / "ascii" / name).read_bytes() == \
            (dj / "ascii" / name).read_bytes()
    for img in ("ppi.ppm", "all.ppm"):
        assert (dp / img).read_bytes() == (dj / img).read_bytes()
    assert (dp / "ppi.ppm").read_bytes().startswith(b"P6\n64 64\n255\n")


def test_volume_empty_checkpoint_matches_jax(tmp_path, capsys):
    ckpt = VolumeScan(tiny_config(m=M, n=N), tmp_path / "empty.npz").save()
    assert cli.main(["volume", str(ckpt)]) == 0
    mine = capsys.readouterr().out
    assert jcli.main(["volume", str(ckpt)]) == 0
    assert mine == capsys.readouterr().out
    assert json.loads(mine) == {"coverage": 0.0, "sectors_covered": 0,
                                "elevations_touched": 0, "complete": False}


# ---------------------------------------------------------------- process


def test_process_timings_matches_jax(tmp_path, capsys, monkeypatch):
    """`process --timings --device cpu`: the six stages in wrp_tpu's order
    and names, one line each, and the products within 1e-5 of wrp_tpu's."""
    monkeypatch.setattr(tconfig, "DEFAULT_CONFIG", tiny_config(m=M, n=N))
    monkeypatch.setattr(jconfig, "DEFAULT_CONFIG", jtiny(m=M, n=N))
    argv = ["process", "--input", "synthetic", "--seed", "3", "--timings",
            "--method", "pallas"]
    assert cli.main(argv + ["--device", "cpu", "--output",
                            str(tmp_path / "port.out")]) == 0
    err_p = capsys.readouterr().err
    assert jcli.main(argv + ["--output", str(tmp_path / "jax.out")]) == 0
    err_j = capsys.readouterr().err

    def stages(err):
        return [ln.split()[1].rstrip(":") for ln in err.splitlines()
                if ln.startswith("stage ")]

    assert stages(err_p) == stages(err_j) == STAGES
    for ln in err_p.splitlines():
        if ln.startswith("stage "):
            assert ln.endswith(" us") and float(ln.split()[2]) >= 0
    got = files.read_ascii_matrix(tmp_path / "port.out")
    want = jfiles.read_ascii_matrix(tmp_path / "jax.out")
    assert got.shape == want.shape == (M // 2, 2)
    assert got[0, 0] == want[0, 0] == -np.inf
    for col in range(2):
        assert joracle.relative_l2(want[:, col], got[:, col]) < 1e-5


# ---------------------------------------------------------------- stream


def _free_port():
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_stream_trace_writes_trace_and_intervals(tmp_path, capsys,
                                                 monkeypatch):
    """`stream --trace DIR --device cpu` over a few tiny UDP sectors: the
    chrome trace holds the executor's stage spans from the ingest thread
    and the compute thread, and DIR/host_intervals.json is [name, thread,
    t0, t1] rows with compute/in_flight among the names."""
    monkeypatch.setattr(tconfig, "DEFAULT_CONFIG", tiny_config(m=M, n=N))
    port = _free_port()
    ready, trace = tmp_path / "ready", tmp_path / "trace"
    rc = {}
    args = ["stream", "--device", "cpu", "--method", "pallas",
            "--ingest-port", str(port), "--batch", "2", "--timeout", "1",
            "--idle-limit", "4", "--max-sectors", "4", "--ready-file",
            str(ready), "--trace", str(trace), "--zdb-port",
            str(_free_port()), "--zdr-port", str(_free_port())]
    runner = threading.Thread(target=lambda: rc.update(s=cli.main(args)),
                              daemon=True)
    runner.start()
    deadline = time.monotonic() + 60
    while not ready.exists():
        assert time.monotonic() < deadline, "stream never became ready"
        time.sleep(0.05)
    assert cli.main(["produce", "--sectors", "4", "--ingest-port", str(port),
                     "--per-sector-seed", "--seed", "8", "--headers"]) == 0
    runner.join(timeout=60)
    assert not runner.is_alive() and rc["s"] == 0
    captured = capsys.readouterr()
    assert json.loads(captured.out)["processed_sectors"] == 4
    assert f"trace written to {trace}" in captured.err

    rows = json.loads((trace / "host_intervals.json").read_text())
    assert rows and all(len(r) == 4 and isinstance(r[0], str)
                        and isinstance(r[1], str) and r[2] <= r[3]
                        for r in rows)
    names = {r[0] for r in rows}
    assert {"compute/in_flight", "ingest/recv", "ingest/decode",
            "compute/dispatch", "compute/fetch"} <= names
    threads = {r[1] for r in rows if r[0].startswith("ingest/")}
    assert threads == {"wrp-ingest-0"}

    doc = json.loads((trace / cli.TRACE_FILE).read_text())
    spans = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], set()).add(e["tid"])
    assert {"ingest/decode", "compute/dispatch", "compute/fetch"} <= set(spans)
    # the ingest thread's spans and the compute thread's both reach it
    assert spans["ingest/decode"].isdisjoint(spans["compute/dispatch"])

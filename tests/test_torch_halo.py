"""The port's halo formulation, [data, seq] mesh, shard_batch and dry run
on the CPU, against wrp_tpu's (JAX on the conftest's 8 virtual devices).

In one process: the overlap-save sum on emulated shards S = 2, 4, 8 against
wrp_tpu's matched_filter_halo under shard_map; build_halo_processor at
world size 1 against wrp_tpu's on a 1 x 1 mesh and the oracle; the overlap
refusal; shard_batch's two layouts against the samples wrp_tpu's shardings
put on each device of a (2, 4) mesh; the dry run's command line (one gloo
rank, and its refusals).  Over real gloo groups, two runs of DRYRUN_WORKER
through the shared rank runner (one rank a process, one torch thread a
rank, a timeout each), each making the dry run's checks and then saving
every formulation's products in the same rendezvous: 2 ranks (a 1 x 2
mesh: halo, mxu, fft and pallas-seq against wrp_tpu's single-device
pipeline and its halo step) and 4 ranks (a 2 x 2 mesh: the row groups, mxu
and halo against wrp_tpu's steps on a (2, 2) mesh)."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conftest import cpu_subprocess_env

from wrp_tpu import oracle
from wrp_tpu import pipeline as jpipe
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu.constants import PipelineConstants as JConsts
from wrp_tpu.parallel import halo as jhalo
from wrp_tpu.parallel import mesh as jmesh
from wrp_tpu.parallel import sharded as jsharded
from wrp_tpu_torch import pipeline as tpipe
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.parallel import build_halo_processor, shard_batch
from wrp_tpu_torch.parallel import dryrun
from wrp_tpu_torch.parallel.dryrun import choose_seq
from wrp_tpu_torch.parallel.halo import halo_conv
from wrp_tpu_torch.parallel.launch import run_ranks
from wrp_tpu_torch.parallel.mesh import Mesh, make_mesh

REPO = Path(__file__).resolve().parent.parent
M, N = 128, 64
RANK_TIMEOUT_S = 240
# the dry run's geometry at seq = 2 (__graft_entry__.py:62)
DM, DN = 32, 16


def _iq(cfg_shape, b, seed):
    rng = np.random.default_rng(seed)
    shape = (b, *cfg_shape)
    return (rng.integers(-2048, 2048, shape)
            + 1j * rng.integers(-2048, 2048, shape)).astype(np.complex64)


def _cpu_mesh(rank, data, seq):
    """Rank `rank`'s place in a data x seq mesh, without a process group
    (what shard_batch and the refusals read)."""
    return Mesh(rank=rank, world=data * seq, data=data, seq=seq,
                device=torch.device("cpu"))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_halo_conv_emulated_shards_match_jax(shards):
    """Shard s gets shard s-1's last taps-1 columns (circularly): the
    port's overlap-save sum on each shard, concatenated, equals wrp_tpu's
    matched_filter_halo under shard_map over `shards` devices (<= 1e-6)
    and the circular filter on the whole row."""
    taps = JConsts.build(jtiny(m=M, n=N)).ma_taps
    h = len(taps) - 1
    rng = np.random.default_rng(shards)
    p = rng.random((2, 3, M // 2, N), dtype=np.float32) * 1e3
    mesh = jmesh.make_mesh(data=1, seq=shards,
                           devices=jax.devices()[:shards])
    spec = P(None, None, None, jmesh.SEQ_AXIS)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda x: jhalo.matched_filter_halo(x, taps), mesh=mesh,
        in_specs=spec, out_specs=spec, check_vma=False))(jnp.asarray(p)))
    parts = np.split(p, shards, axis=-1)
    got = torch.cat([halo_conv(torch.from_numpy(parts[s]),
                               torch.from_numpy(parts[s - 1][..., -h:]), taps)
                     for s in range(shards)], dim=-1).numpy()
    assert got.shape == p.shape
    assert oracle.relative_l2(want, got) <= 1e-6
    direct = tpipe.matched_filter_direct(torch.from_numpy(p), taps).numpy()
    assert oracle.relative_l2(direct, got) <= 1e-6


def test_halo_processor_world_one_matches_jax_and_oracle():
    """build_halo_processor without a process group (1 x 1 mesh) against
    wrp_tpu's on a 1 x 1 mesh and the fp64 oracle (< 1e-4, the bound of
    tests/test_sharding.py's halo test); its step takes the "mesh" layout."""
    cfg, jcfg = tiny_config(m=64, n=32), jtiny(m=64, n=32)
    iq = _iq(cfg.sector_shape, 4, 21)
    step = build_halo_processor(cfg, make_mesh(device="cpu"), device="cpu")
    assert step.layout == "mesh"
    zdb, zdr = (t.numpy() for t in step(shard_batch(iq, make_mesh(
        device="cpu"), step.layout)))
    jm = jmesh.make_mesh(data=1, seq=1, devices=jax.devices()[:1])
    jstep, jin = jhalo.build_halo_processor(jcfg, jm)
    jzdb, jzdr = (np.asarray(t) for t in jstep(
        jsharded.shard_batch(iq, jm, jin)))
    assert zdb.shape == (4, 32)
    assert oracle.relative_l2(jzdb, zdb) < 1e-5
    assert oracle.relative_l2(jzdr, zdr) < 1e-5
    for k in range(4):
        zdb64, _ = oracle.process_sector(iq[k], jcfg)
        assert oracle.relative_l2(zdb64, zdb[k]) < 1e-4


def test_halo_refusals():
    """The overlap case of tests/test_sharding.py:188-201 (n/seq = 4 < 6
    columns of overlap) and an n that seq does not divide, with wrp_tpu's
    messages."""
    with pytest.raises(ValueError, match="overlap"):
        build_halo_processor(tiny_config(m=32, n=32), _cpu_mesh(0, 1, 8),
                             device="cpu")
    with pytest.raises(ValueError, match="must divide by seq"):
        build_halo_processor(tiny_config(m=32, n=36), _cpu_mesh(0, 1, 8),
                             device="cpu")


def test_make_mesh_without_a_group():
    """One rank without a process group is a 1 x 1 mesh; any larger mesh
    needs the group."""
    mesh = make_mesh(data=None, seq=1, device="cpu")
    assert (mesh.shape, mesh.rank, mesh.seq_group) == (
        {"data": 1, "seq": 1}, 0, None)
    for data, seq in ((2, 1), (1, 2), (None, 4)):
        with pytest.raises(ValueError, match="needs an initialised"):
            make_mesh(data=data, seq=seq, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        make_mesh(seq=0, device="cpu")


@pytest.mark.parametrize("layout,jsharding", [
    ("mesh", jmesh.iq_sharding), ("data", jmesh.iq_sharding_flat)])
def test_shard_batch_matches_jax_device_shards(layout, jsharding):
    """Rank r of a (2, 4) mesh gets exactly the samples wrp_tpu's sharding
    puts on device r of the same mesh (iq_sharding: batch over data, pulses
    over seq; iq_sharding_flat: batch over every device), for complex and
    planar int16 input."""
    cfg = tiny_config(m=32, n=16)
    iq = _iq(cfg.sector_shape, 8, 3)
    planar = np.stack([iq.real, iq.imag], axis=2).astype(np.int16)
    jm = jmesh.make_mesh(data=2, seq=4)
    devices = list(jm.devices.flat)
    for x in (iq, planar):
        shards = {s.device: np.asarray(s.data) for s in
                  jsharded.shard_batch(x, jm, jsharding(jm)).addressable_shards}
        for r in range(8):
            got = shard_batch(x, _cpu_mesh(r, 2, 4), layout)
            assert got.dtype == (torch.float32 if x is iq else torch.int16)
            np.testing.assert_array_equal(got.numpy(), shards[devices[r]])
    with pytest.raises(ValueError, match="must divide"):
        shard_batch(iq[:3], _cpu_mesh(0, 2, 4), layout)
    with pytest.raises(ValueError, match="layout"):
        shard_batch(iq, _cpu_mesh(0, 2, 4), "wire")


def test_choose_seq_as_graft_entry():
    assert [choose_seq(n) for n in (1, 2, 3, 4, 6, 8, 16)] == [
        1, 2, 1, 4, 2, 8, 8]


# One rank of a dry run over gloo: the dry run's checks (run_checks, rank 0
# prints its OK line), then the products of every seq-sharded formulation
# on a second batch, with this rank's place in the mesh, into out % rank;
# the rank ends through the port's bounded ending (parallel/launch.end_rank).
DRYRUN_WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from wrp_tpu_torch.parallel import (build_halo_processor,
                                    build_sharded_processor, gather_batch,
                                    shard_batch)
from wrp_tpu_torch.parallel.dryrun import dryrun_config, run_checks
from wrp_tpu_torch.parallel.launch import end_rank
from wrp_tpu_torch.parallel.mesh import init_distributed, make_mesh

rank, world, port, seq, timeout, out = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]),
    float(sys.argv[5]), sys.argv[6])
dev = init_distributed(f"127.0.0.1:{port}", world, rank, "cpu",
                       timeout_s=timeout)
mesh = make_mesh(data=world // seq, seq=seq, device=dev)
line = run_checks(mesh)
cfg = dryrun_config(seq)
rng = np.random.default_rng(5)
shape = (2 * mesh.data, *cfg.sector_shape)
iq = (rng.integers(-2048, 2048, shape)
      + 1j * rng.integers(-2048, 2048, shape)).astype(np.complex64)
res = {"data": mesh.data, "seq": mesh.seq, "iq": iq,
       "seq_group": (dist.get_process_group_ranks(mesh.seq_group)
                     if mesh.seq_group is not None else [rank])}
for name, step in (("mxu", build_sharded_processor(cfg, mesh, "mxu")),
                   ("halo", build_halo_processor(cfg, mesh)),
                   ("fft", build_sharded_processor(cfg, mesh, "fft")),
                   ("pallas-seq",
                    build_sharded_processor(cfg, mesh, "pallas-seq"))):
    zdb, zdr = step(shard_batch(iq, mesh, step.layout))
    res[name + "_zdb"] = gather_batch(zdb, mesh, step.layout).numpy()
    res[name + "_zdr"] = gather_batch(zdr, mesh, step.layout).numpy()
np.savez(out % rank, **res)
if rank == 0:
    print(line, flush=True)
end_rank(0, timeout)
"""


def _dryrun(tmp_path, world, seq):
    """DRYRUN_WORKER on `world` gloo ranks of a (world // seq) x seq mesh:
    (rank 0's stdout, each rank's saved products)."""
    out = str(tmp_path / "rank%d.npz")
    results = run_ranks(
        lambda rank, port: [sys.executable, "-c", DRYRUN_WORKER, str(rank),
                            str(world), str(port), str(seq),
                            str(RANK_TIMEOUT_S), out],
        world, RANK_TIMEOUT_S, env=cpu_subprocess_env(OMP_NUM_THREADS="1"),
        cwd=str(REPO))
    for r in results:
        assert r.rc == 0, (r.rank, r.rc, r.out[-1000:], r.err[-3000:])
    return results[0].out, [dict(np.load(out % k)) for k in range(world)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The one 2-rank run: a 1 x 2 mesh (seq = 2, as the dry run chooses
    for 2 ranks), the dry run's checks and every formulation's products."""
    return _dryrun(tmp_path_factory.mktemp("dryrun2"), 2, choose_seq(2))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The one 4-rank run: a 2 x 2 mesh (two data rows of two seq ranks)."""
    return _dryrun(tmp_path_factory.mktemp("dryrun4"), 4, 2)


def test_dryrun_cli_one_gloo_rank():
    """`python -m wrp_tpu_torch.parallel.dryrun 1 --device cpu`: the
    command line starts its rank, exits 0 and prints the OK line (a 1 x 1
    mesh; the multi-rank meshes run in the two worker runs below)."""
    done = subprocess.run(
        [sys.executable, "-m", "wrp_tpu_torch.parallel.dryrun", "1",
         "--device", "cpu"],
        cwd=REPO, env=cpu_subprocess_env(OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=RANK_TIMEOUT_S + 60)
    assert done.returncode == 0, (done.stdout[-1000:], done.stderr[-3000:])
    line = done.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK: mesh 1x1 (1 devices), "), line
    assert line.endswith("sharded wire decode bit-exact over 1 devices")


def test_dryrun_runs_on_the_gpus_or_refuses(monkeypatch, capsys):
    """The dry run's default is the GPUs: without CUDA it exits 2 (and
    dryrun_multichip raises) instead of running on the CPU, and more ranks
    than GPUs exit 2 instead of running fewer."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="CUDA is not available"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["2"])
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["2"])
    assert e.value.code == 2
    assert "2 ranks need 2 GPUs, this host has 1" in capsys.readouterr().err


def test_dryrun_two_ranks_prints_its_ok_line(two_ranks):
    """Exit 0 and wrp_tpu's OK line, mesh 1x2, every check under its
    bound (the line's numbers are the checked errors)."""
    out, ranks = two_ranks
    line = out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK: mesh 1x2 (2 devices), "
                           "batch (2, 3, 32, 16) -> zdb (2, 16); "), line
    assert line.endswith("sharded wire decode bit-exact over 2 devices")
    assert [(int(r["data"]), int(r["seq"])) for r in ranks] == [(1, 2)] * 2
    assert [list(r["seq_group"]) for r in ranks] == [[0, 1], [0, 1]]


@pytest.mark.parametrize("method,jmethod", [
    ("halo", "mxu"), ("mxu", "mxu"), ("fft", "fft"), ("pallas-seq", "pallas")])
def test_two_ranks_seq_sharded_match_jax(two_ranks, method, jmethod):
    """Each seq-sharded formulation over the 2-rank gloo group: both ranks
    return the whole batch's products, equal to each other and within
    1e-5 of wrp_tpu's single-device pipeline; the halo step also within
    1e-5 of wrp_tpu's halo step on a (1, 2) virtual mesh."""
    _, ranks = two_ranks
    iq = ranks[0]["iq"]
    jcfg = jtiny(m=DM, n=DN)
    jzdb, jzdr = (np.asarray(t) for t in jpipe.SectorProcessor(
        jcfg, method=jmethod)(jnp.asarray(iq)))
    for r in ranks:
        assert r[f"{method}_zdb"].shape == (2, DM // 2)
        assert oracle.relative_l2(jzdb, r[f"{method}_zdb"]) < 1e-5
        assert oracle.relative_l2(jzdr, r[f"{method}_zdr"]) < 1e-5
    np.testing.assert_array_equal(ranks[0][f"{method}_zdb"],
                                  ranks[1][f"{method}_zdb"])
    if method == "halo":
        jm = jmesh.make_mesh(data=1, seq=2, devices=jax.devices()[:2])
        jstep, jin = jhalo.build_halo_processor(jcfg, jm)
        hzdb, hzdr = (np.asarray(t) for t in jstep(
            jsharded.shard_batch(iq, jm, jin)))
        assert oracle.relative_l2(hzdb, ranks[0]["halo_zdb"]) < 1e-5
        assert oracle.relative_l2(hzdr, ranks[0]["halo_zdr"]) < 1e-5


def test_four_ranks_mesh_groups(four_ranks):
    """2 x 2: rank r in data row r // 2 at seq index r % 2, its seq group
    that row's two ranks; the dry run's checks pass on that mesh."""
    out, ranks = four_ranks
    assert "dryrun_multichip OK: mesh 2x2 (4 devices)" in out
    for r, res in enumerate(ranks):
        assert (int(res["data"]), int(res["seq"])) == (2, 2)
        row = r // 2
        assert list(res["seq_group"]) == [2 * row, 2 * row + 1]


@pytest.mark.parametrize("method", ["mxu", "halo"])
def test_four_ranks_match_jax_2x2_mesh(four_ranks, method):
    """The mxu and halo steps on the 2 x 2 gloo mesh against wrp_tpu's on
    a (2, 2) virtual mesh (<= 1e-5), every rank holding the whole batch."""
    _, ranks = four_ranks
    iq = ranks[0]["iq"]
    jcfg = jtiny(m=DM, n=DN)
    jm = jmesh.make_mesh(data=2, seq=2, devices=jax.devices()[:4])
    if method == "halo":
        jstep, jin = jhalo.build_halo_processor(jcfg, jm)
    else:
        jstep, jin = jsharded.build_sharded_processor(jcfg, jm, method="mxu")
    jzdb, jzdr = (np.asarray(t) for t in jstep(
        jsharded.shard_batch(iq, jm, jin)))
    for r in ranks:
        assert r[f"{method}_zdb"].shape == (4, DM // 2)
        assert oracle.relative_l2(jzdb, r[f"{method}_zdb"]) < 1e-5
        assert oracle.relative_l2(jzdr, r[f"{method}_zdr"]) < 1e-5

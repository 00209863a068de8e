"""The in-kernel time breakdown's ablations (`ops.probes.radix_chain_ablation`)
and their entry point, `python -m wrp_tpu_torch.tools.kernel_breakdown`, on
the CPU: the port's kcat operator against wrp_tpu's, the plain versions of
the four modes against restatements built from wrp_tpu's own functions
(`_split_bf16`, `_radix_contract`) and against float64, the kernel's shape
contract, the JSON contract and the refusals.  wrp_tpu's tool
(tools/kernel_breakdown.py) has no CPU mode (no interpret=), so it is not
run; `full` is held against wrp_tpu's radix kernel in interpret mode on
the salted samples, as tests/test_torch_offsets.py does (wrp_tpu ignores
the salt in interpret mode).  The CUDA kernel is checked on the card by
chip_smoke.py (phase_probes)."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrp_tpu import oracle
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu.constants import PipelineConstants as JConsts
from wrp_tpu.ops.pallas import fullchain as jfull
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.constants import PipelineConstants
from wrp_tpu_torch.ops import fullchain, probes
from wrp_tpu_torch.tools import kernel_breakdown

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
M, N = 64, 32          # radix 8, M = 8 sub-DFT rows, tile 8
BC, SLABS = 6, 3       # channel-sectors per slab, staged slabs
#: the JAX tool's attribution keys, in its order
JAX_ATTRIBUTION = ("mxu_dma_cast_floor", "lo_splits", "butterfly_combine",
                   "epilogue")


def _staged(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-8192, 8192, (SLABS * BC, 2, M, N), dtype=np.int16)


def _plan(m=M, n=N):
    return probes.breakdown_plan(PipelineConstants.build(tiny_config(m=m, n=n)),
                                 "cpu")


def _close(want, got):
    """Worst per-unit rel-L2 (oracle.relative_l2) of [units, m/2] outputs."""
    want = np.asarray(want, np.float64).reshape(got.shape)
    return max(oracle.relative_l2(w, g) for w, g in zip(want, got))


def _salted(x, slab, salt):
    return x[slab * BC:(slab + 1) * BC].astype(np.float64) + salt


def _jax_consts(m=M, n=N):
    return JConsts.build(jtiny(m=m, n=n))


@pytest.mark.parametrize("m", [64, 32, 16])
def test_kcat_operator_and_fac_are_bit_equal_to_wrp_tpu(m):
    """The port's own copy of radix_plan_host(layout="kcat"): the same bf16
    bits (torch and JAX both round to nearest even) and the same fac."""
    consts = _jax_consts(m)
    radix = jfull.radix_for(m)
    want, want_fac = jfull.radix_plan_host(consts, radix, layout="kcat")
    got, fac = probes.kcat_operator(
        PipelineConstants.build(tiny_config(m=m, n=N)), radix)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == np.asarray(want).shape == (
        radix, 3, m // radix, 3 * m // radix)
    assert np.array_equal(np.asarray(want).view(np.uint16),
                          got.view(torch.int16).numpy().view(np.uint16))
    assert [list(row) for row in fac] == [list(row) for row in want_fac]


def _jax_branches(x, slab, salt, lo_planes):
    """wrp_tpu's kcat dots in jax.numpy on the slab: per branch p (rows
    p::R) and Gauss product, _split_bf16 of the salted f32 plane stacked
    [xh; xl; xh] ([xh; xh; xh] without lo planes) against
    radix_plan_host's kcat operator -> [(gr, gi)] per branch, [BC, M, N]."""
    consts = _jax_consts()
    a, _ = jfull.radix_plan_host(consts, 8, layout="kcat")
    a = jnp.asarray(a)
    v = jnp.asarray(x[slab * BC:(slab + 1) * BC].astype(np.float32)) + jnp.float32(salt)
    G = []
    for p in range(8):
        vr, vi = v[:, 0, p::8], v[:, 1, p::8]
        prods = []
        for g, plane in enumerate((vr, vi, vr + vi)):
            hi, lo = jfull._split_bf16(plane)
            stack = jnp.concatenate([hi, lo if lo_planes else hi, hi], axis=1)
            prods.append(jnp.einsum("tk,ukj->utj", a[p, g], stack,
                                    preferred_element_type=jnp.float32))
        m1, m2, m3 = prods
        G.append((m1 - m2, m3 - m1 - m2))
    return G


@pytest.mark.parametrize("mode", ["dots", "splits"])
@pytest.mark.parametrize("slab,salt", [(0, 0), (1, 7), (2, 95)])
def test_dots_and_splits_match_wrp_tpus_split_and_kcat_operator(mode, slab, salt):
    """dots/splits: row s M + t holds sum_j (Re + Im)(g_s + g_{s+S})[t, j],
    the JAX tool's row sum, with g_p from wrp_tpu's _split_bf16 and kcat
    operator (no lo planes in dots).  The products are exact in f32 on
    both sides; only the order of the f32 sums differs."""
    x = _staged(seed=3)
    got = probes.radix_chain_ablation(torch.from_numpy(x), _plan(), mode,
                                      slab * BC, BC, salt).numpy()
    G = _jax_branches(x, slab, salt, lo_planes=mode == "splits")
    want = np.concatenate([np.asarray(G[s][0] + G[s + 4][0] + G[s][1]
                                      + G[s + 4][1]).sum(-1) for s in range(4)],
                          axis=-1)
    assert got.shape == (BC, M // 2)
    assert _close(want, got) < 1e-6


@pytest.mark.parametrize("slab,salt", [(0, 0), (1, 7), (2, 95), (1, -3)])
def test_combine_matches_wrp_tpus_radix_contract(slab, salt):
    """combine: the row sums of Yr + Yi, held against wrp_tpu's
    _radix_contract (strided rows, the salt, its kcat dots and split-radix
    combine) on each unit; the port's direct combine rounds in another
    order."""
    x = _staged(seed=4)
    got = probes.radix_chain_ablation(torch.from_numpy(x), _plan(), "combine",
                                      slab * BC, BC, salt).numpy()
    consts = _jax_consts()
    a, fac = jfull.radix_plan_host(consts, 8, layout="kcat")
    want = []
    for u in x[slab * BC:(slab + 1) * BC].astype(np.float32):
        yr, yi = jfull._radix_contract(jnp.asarray(u[0]), jnp.asarray(u[1]),
                                       jnp.asarray(a), 8, fac,
                                       salt=jnp.float32(salt), strided_rows=True)
        want.append(np.asarray(yr).sum(-1) + np.asarray(yi).sum(-1))
    assert _close(want, got) < 1e-6


@pytest.mark.parametrize("slab,salt", [(0, 0), (1, 7), (2, 95), (1, -3)])
def test_full_is_the_salted_radix_entry_and_matches_jax(slab, salt):
    x = _staged()
    bp = _plan()
    before = (probes.BREAKDOWN_LAUNCHES, fullchain.RADIX_OFFSET_LAUNCHES)
    got = probes.radix_chain_ablation(torch.from_numpy(x), bp, "full",
                                      slab * BC, BC, salt).numpy()
    assert (probes.BREAKDOWN_LAUNCHES,
            fullchain.RADIX_OFFSET_LAUNCHES) == before   # the CPU launches nothing
    assert got.shape == (BC, M // 2)
    # the salted radix entry's chain in fp32 (the matrix form): the bf16
    # operands drop the al * xl term, ~2^-17 of each product
    assert _close(fullchain.fused_chain_power_reference(
        torch.from_numpy(x[slab * BC:(slab + 1) * BC]), bp.plan, salt).numpy(),
        got) < 2e-5
    consts = _jax_consts()
    radix = jfull.radix_for(M)
    a_np, fac = jfull.radix_plan_host(consts, radix)
    order = jfull.radix_row_order(M, radix)
    planar = _salted(x, slab, salt).astype(np.float32)[:, :, order, :]
    want = np.asarray(jfull.fused_chain_power_radix(
        jnp.asarray(planar), jnp.asarray(a_np), fac, jnp.asarray(consts.wd),
        jnp.asarray(consts.clip_phasors), interpret=True))
    # both drop the same lo*lo term of the same split; what differs is the
    # order of the f32 sums, the split-radix combine and wrp_tpu's clip-bin
    # projections on bf16x3 operands (4e-7 measured)
    assert _close(want, got) < 1e-6


@pytest.mark.parametrize("slab,salt", [(0, 0), (1, 7), (2, 95)])
def test_combine_is_the_row_sum_of_jax_half_spectrum_dft(slab, salt):
    """combine: sum_j (Yr + Yi) of Y = op_a_half @ (x + salt), wrp_tpu's
    half-spectrum range DFT (window folded in), in float64."""
    x = _staged(seed=1)
    got = probes.radix_chain_ablation(torch.from_numpy(x), _plan(), "combine",
                                      slab * BC, BC, salt).numpy()
    a_half = JConsts.build(jtiny(m=M, n=N), dtype=np.float64).op_a_half
    xs = _salted(x, slab, salt)
    y = np.einsum("km,umj->ukj", a_half, xs[:, 0] + 1j * xs[:, 1])
    want = y.real.sum(-1) + y.imag.sum(-1)
    assert got.shape == (BC, M // 2)
    assert _close(want, got) < 1e-5


@pytest.mark.parametrize("m,salt", [(64, 0), (64, 7), (32, 5), (16, 2)])
def test_dots_matches_a_float64_restatement(m, salt):
    """dots: row s M + t holds sum_j (Re + Im)(g_s + g_{s+S})[t, j], g_p the
    branch contractions of the kcat operator (held bit-equal to wrp_tpu's
    above) on [xh; xh; xh], xh = bf16(x + salt), no combine; restated in
    float64 at radix 8, 4 and 2."""
    x = _staged(seed=2)[:, :, :m]
    bp = _plan(m=m)
    R, S, Mr = bp.plan.radix, bp.plan.radix // 2, m // bp.plan.radix
    got = probes.radix_chain_ablation(torch.from_numpy(np.ascontiguousarray(x)),
                                      bp, "dots", BC, BC, salt).numpy()
    a = bp.a_kcat.double().numpy()                  # [R, 3, M, 3M]
    xs = _salted(x, 1, salt).astype(np.float32)
    xh = torch.from_numpy(xs).to(torch.bfloat16).double().numpy()
    want = np.zeros((BC, S, Mr))
    for p in range(R):
        vr, vi = xh[:, 0, p::R], xh[:, 1, p::R]
        vs = torch.from_numpy(xs[:, 0, p::R] + xs[:, 1, p::R]).to(
            torch.bfloat16).double().numpy()
        m1, m2, m3 = (np.einsum("tk,ukj->utj", a[p, g], np.concatenate([v] * 3, 1))
                      for g, v in enumerate((vr, vi, vs)))
        want[:, p % S] += (m1 - m2 + m3 - m1 - m2).sum(-1)
    assert R == {64: 8, 32: 4, 16: 2}[m]
    assert _close(want.reshape(BC, -1), got) < 1e-5


@pytest.mark.parametrize("m,n,radix,ok", [
    (1024, 512, 8, True), (512, 512, 8, True), (1024, 64, 8, True),
    (1024, 256, 8, True), (1024, 576, 8, False), (1024, 480, 8, False),
    (2048, 512, 8, False), (256, 512, 8, False), (1024, 512, 4, False),
    (64, 32, 8, False), (1024, 192, 8, True), (512, 384, 8, True),
    (1024, 320, 8, True), (1024, 448, 8, True)])
def test_kernel_shape_contract(m, n, radix, ok):
    """csrc/kernel_breakdown.cu takes radix 8 with M = 64 or 128 and n a
    multiple of 64 up to 512 (a cluster of at most 8 pulse tiles, 3, 5, 6
    and 7 included: the merge's last block takes fewer rows); the plain
    versions take the rest."""
    why = probes.breakdown_refusal(m, n, radix)
    assert (why is None) == ok, why


def test_fused_smem_bytes_is_one_body_for_every_mode():
    """One dynamic shared memory for the four modes, under a block's 227 KB
    at m = 1024 (the stats of the cluster merge reuse the x planes)."""
    big = dataclasses.replace(_plan().plan, m=1024, n=512)
    assert probes.fused_smem_bytes(big) == 231936 <= 227 * 1024
    # the merge's stats, [2 tiles][4 S x 64 rows][BD_STAT] f32, fit the x
    # planes at M = 64, the smallest
    assert probes.BD_STAT == 12
    assert 2 * 256 * probes.BD_STAT * 4 <= 6 * 64 * probes.BD_TILE * 2


def test_ablation_refusals():
    x = torch.from_numpy(_staged())
    plan = _plan()
    out = probes.radix_chain_ablation(x, plan, "splits", 0, BC, 0)
    assert out.shape == (BC, M // 2) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="unknown ablation mode"):
        probes.radix_chain_ablation(x, plan, "epilogue", 0, BC, 0)
    with pytest.raises(ValueError, match="outside"):
        probes.radix_chain_ablation(x, plan, "dots", SLABS * BC - 1, BC, 0)
    with pytest.raises(ValueError, match="int32"):
        probes.radix_chain_ablation(x, plan, "combine", 0, BC, 2 ** 31)
    with pytest.raises(ValueError, match="radix plan"):
        probes.breakdown_plan(PipelineConstants.build(tiny_config(m=40)), "cpu")


@pytest.mark.parametrize("demangled,key", [
    ("void wrp::radix_chain_kernel<wrp::Salted<wrp::PlanarSource<short>>, "
     "(int)4, (int)8, (wrp::Body)2>(wrp::Salted<wrp::PlanarSource<short>>, "
     "float const*, float*, int, int)",
     "void wrp::radix_chain_kernel<wrp::Salted<wrp::PlanarSource<short>>, "
     "4, 8, body2>"),
    ("void wrp::radix_chain_kernel<wrp::PlanarSource<short>, (int)4, (int)8, "
     "false>(wrp::PlanarSource<short>, float const*)",
     "void wrp::radix_chain_kernel<wrp::PlanarSource<short>, 4, 8, body0>"),
    ("void wrp::radix_chain_kernel<wrp::WireSource, (int)2, (int)4, (bool)1>"
     "(wrp::WireSource)",
     "void wrp::radix_chain_kernel<wrp::WireSource, 2, 4>"),
    ("void wrp::radix_chain_kernel<wrp::PlanarSource<short>, (int)4, (int)8, "
     "(wrp::Body)1>(wrp::PlanarSource<short>, float const*, float const*, "
     "float const*, float const*, float*, int, int)",
     "void wrp::radix_chain_kernel<wrp::PlanarSource<short>, 4, 8>"),
    ("void wrp::radix_chain_kernel<wrp::PlanarSource<short>, (int)4, (int)8>"
     "(wrp::PlanarSource<short>, float const*, float const*, float*, int, int)",
     "void wrp::radix_chain_kernel<wrp::PlanarSource<short>, 4, 8>"),
    ("void <unnamed>::int_split_kernel<(int)8, (bool)1>(short const*, float*)",
     "void <unnamed>::int_split_kernel<8, 1>"),
    # the dense matrix kernel's unsalted instantiation keys as the earlier
    # trees' kernel, which had no salt argument; the salted one apart
    ("void <unnamed>::fused_chain_dense_kernel<short, (int)10, (bool)0>"
     "(short const*, float const*, float const*, float const*, float*, int, "
     "int, float)",
     "void <unnamed>::fused_chain_dense_kernel<short, 10>"),
    ("void <unnamed>::fused_chain_dense_kernel<float, 4, true>(float const*)",
     "void <unnamed>::fused_chain_dense_kernel<float, 4, true>"),
])
def test_kernel_key_names_a_body_alike_across_trees(demangled, key):
    """The SASS and ptxas reports key kernels by name: the radix body's
    bool flag and Body enum (earlier trees) compare equal, and their
    A-stage (flag or body 1) keys as this tree's A-stage, whose template
    has no body argument."""
    from wrp_tpu_torch.tools.kernel_ab import kernel_key

    assert kernel_key(demangled) == key


def _cli(*flags, device_cpu=True):
    from conftest import cpu_subprocess_env

    env = cpu_subprocess_env(OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    argv = [sys.executable, "-m", "wrp_tpu_torch.tools.kernel_breakdown",
            *flags] + (["--device", "cpu"] if device_cpu else [])
    return subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=env)


def test_cli_smoke_prints_the_json_contract():
    out = _cli("--smoke")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["device"] == "cpu" and r["geometry"] == "3x64x32"
    assert r["steps"] == 2 and r["batch"] == 16
    for mode in ("dots", "splits", "combine", "full", "astage",
                 "astage_at_fused_smem"):
        assert set(r[mode]) == {"us_per_channel_step", "ms_per_launch",
                                "sectors_per_second", "runs_s",
                                "blocks_per_sm"}
        assert r[mode]["us_per_channel_step"] > 0
        assert len(r[mode]["runs_s"]) == 3
        assert r[mode]["blocks_per_sm"] is None       # a card's number
    assert set(r["attribution_us"]) == set(JAX_ATTRIBUTION)
    assert (r["attribution_us"]["mxu_dma_cast_floor"]
            == r["dots"]["us_per_channel_step"])
    assert r["fused_smem_bytes"] == probes.fused_smem_bytes(_plan().plan)
    assert r["sass"] is None                          # a card's build


def test_modes_subset_has_no_attribution():
    r = kernel_breakdown.run(["--smoke", "--device", "cpu", "--modes", "dots"])
    assert "dots" in r and "combine" not in r and "attribution_us" not in r


def test_splits_mode_runs_with_the_jax_attribution():
    """The JAX tool's four keys (tools/kernel_breakdown.py:201-208), each
    the difference of two modes' times as it computes them."""
    r = kernel_breakdown.run(["--smoke", "--device", "cpu", "--modes",
                              "dots,splits,combine,full"])
    att, t = r["attribution_us"], {m: r[m]["us_per_channel_step"]
                                   for m in probes.ABLATION_MODES}
    assert list(att) == list(JAX_ATTRIBUTION)
    assert att["mxu_dma_cast_floor"] == t["dots"]
    assert att["lo_splits"] == round(t["splits"] - t["dots"], 3)
    assert att["butterfly_combine"] == round(t["combine"] - t["splits"], 3)
    assert att["epilogue"] == round(t["full"] - t["combine"], 3)


def test_no_cuda_without_device_cpu_exits_2():
    out = _cli("--smoke", device_cpu=False)
    assert out.returncode == 2, (out.stdout[-500:], out.stderr[-1000:])
    assert "CUDA is not available" in out.stderr and out.stdout == ""

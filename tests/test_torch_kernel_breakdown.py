"""The in-kernel time breakdown's ablations (`ops.probes.radix_chain_ablation`)
and their entry point, `python -m wrp_tpu_torch.tools.kernel_breakdown`, on
the CPU: the plain versions of the modes against wrp_tpu and a float64
restatement, the JSON contract and the refusals.  wrp_tpu's tool
(tools/kernel_breakdown.py) has no CPU mode (no interpret=), so it is not
run; `full` is held against wrp_tpu's radix kernel in interpret mode on
the salted samples, as tests/test_torch_offsets.py does (wrp_tpu ignores
the salt in interpret mode).  The CUDA kernels are checked on the card by
chip_smoke.py (phase_probes)."""

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


def _staged(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-8192, 8192, (SLABS * BC, 2, M, N), dtype=np.int16)


def _plan(m=M, n=N):
    return fullchain.build_plan(PipelineConstants.build(tiny_config(m=m, n=n)),
                                "cpu")


def _close(want, got):
    """Worst per-unit rel-L2 (oracle.relative_l2) of [units, m/2] outputs."""
    want = np.asarray(want, np.float64).reshape(got.shape)
    return max(oracle.relative_l2(w, g) for w, g in zip(want, got))


def _salted(x, slab, salt):
    return x[slab * BC:(slab + 1) * BC].astype(np.float64) + salt


@pytest.mark.parametrize("slab,salt", [(0, 0), (1, 7), (2, 95), (1, -3)])
def test_full_is_the_salted_radix_entry_and_matches_jax(slab, salt):
    x = _staged()
    plan = _plan()
    before = (probes.BREAKDOWN_LAUNCHES, fullchain.RADIX_OFFSET_LAUNCHES)
    got = probes.radix_chain_ablation(torch.from_numpy(x), plan, "full",
                                      slab * BC, BC, salt).numpy()
    assert (probes.BREAKDOWN_LAUNCHES,
            fullchain.RADIX_OFFSET_LAUNCHES) == before   # the CPU launches nothing
    assert got.shape == (BC, M // 2)
    # the matrix-form chain of the salted radix entry (the port's first
    # production body, which the breakdown ablates)
    assert np.array_equal(got, fullchain.fused_chain_power_reference(
        torch.from_numpy(x[slab * BC:(slab + 1) * BC]), plan, salt).numpy())
    consts = JConsts.build(jtiny(m=M, n=N))
    radix = jfull.radix_for(M)
    a_np, fac = jfull.radix_plan_host(consts, radix)
    order = jfull.radix_row_order(M, radix)
    planar = _salted(x, slab, salt).astype(np.float32)[:, :, order, :]
    want = np.asarray(jfull.fused_chain_power_radix(
        jnp.asarray(planar), jnp.asarray(a_np), fac, jnp.asarray(consts.wd),
        jnp.asarray(consts.clip_phasors), interpret=True))
    assert _close(want, got) < 2e-5    # wrp_tpu drops the bf16 lo*lo term


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
    """dots: row s M + t holds sum_j (Re + Im)(g_s + g_{s+S})[t, j], g_p =
    A_p x[p::R] the branch contractions of the port's plan (held equal to
    wrp_tpu's operators by tests/test_torch_constants.py), no combine; at
    radix 8, 4 and 2."""
    x = _staged(seed=2)[:, :, :m]
    plan = _plan(m=m)
    R, S, Mr = plan.radix, plan.radix // 2, m // plan.radix
    got = probes.radix_chain_ablation(torch.from_numpy(np.ascontiguousarray(x)),
                                      plan, "dots", BC, BC, salt).numpy()
    a = plan.a.double().numpy()
    ac = a[:, 0] + 1j * a[:, 1]                     # [R, M, M] A_p[t, q]
    xs = _salted(x, 1, salt)
    xc = xs[:, 0] + 1j * xs[:, 1]                   # [BC, m, n]
    want = np.zeros((BC, S, Mr))
    for p in range(R):
        g = np.einsum("tq,uqj->utj", ac[p], xc[:, p::R])
        want[:, p % S] += g.real.sum(-1) + g.imag.sum(-1)
    assert R == {64: 8, 32: 4, 16: 2}[m]
    assert _close(want.reshape(BC, -1), got) < 1e-5


def test_ablation_refusals():
    x = torch.from_numpy(_staged())
    plan = _plan()
    with pytest.raises(ValueError, match="no counterpart"):
        probes.radix_chain_ablation(x, plan, "splits", 0, BC, 0)
    with pytest.raises(ValueError, match="unknown ablation mode"):
        probes.radix_chain_ablation(x, plan, "epilogue", 0, BC, 0)
    with pytest.raises(ValueError, match="outside"):
        probes.radix_chain_ablation(x, plan, "dots", SLABS * BC - 1, BC, 0)
    with pytest.raises(ValueError, match="int32"):
        probes.radix_chain_ablation(x, plan, "combine", 0, BC, 2 ** 31)
    dense = fullchain.build_plan(PipelineConstants.build(tiny_config(m=40)),
                                 "cpu")
    with pytest.raises(ValueError, match="radix plan"):
        probes.radix_chain_ablation(x, dense, "dots", 0, BC, 0)


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
     "void wrp::radix_chain_kernel<wrp::WireSource, 2, 4, body1>"),
    ("void <unnamed>::int_split_kernel<(int)8, (bool)1>(short const*, float*)",
     "void <unnamed>::int_split_kernel<8, 1>"),
])
def test_kernel_key_names_a_body_alike_across_trees(demangled, key):
    """The SASS and ptxas reports key kernels by name: the radix body's
    bool flag (earlier trees) and Body enum (this one) compare equal."""
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
    for mode in ("dots", "combine", "full", "astage", "astage_at_fused_smem"):
        assert set(r[mode]) == {"us_per_channel_step", "ms_per_launch",
                                "sectors_per_second", "runs_s",
                                "blocks_per_sm"}
        assert r[mode]["us_per_channel_step"] > 0
        assert len(r[mode]["runs_s"]) == 3
        assert r[mode]["blocks_per_sm"] is None       # a card's number
    assert set(r["attribution_us"]) == {"dots_floor", "butterfly_combine",
                                        "epilogue"}
    assert r["attribution_us"]["dots_floor"] == r["dots"]["us_per_channel_step"]
    assert r["fused_smem_bytes"] == (2 * 4 * 8 * 32 + 2 * 8 * 8) * 4
    assert r["sass"] is None                          # a card's build


def test_modes_subset_has_no_attribution():
    r = kernel_breakdown.run(["--smoke", "--device", "cpu", "--modes", "dots"])
    assert "dots" in r and "combine" not in r and "attribution_us" not in r


def test_splits_mode_exits_2():
    out = _cli("--smoke", "--modes", "dots,splits")
    assert out.returncode == 2 and out.stdout == ""
    assert "no counterpart" in out.stderr


def test_no_cuda_without_device_cpu_exits_2():
    out = _cli("--smoke", device_cpu=False)
    assert out.returncode == 2, (out.stdout[-500:], out.stderr[-1000:])
    assert "CUDA is not available" in out.stderr and out.stdout == ""

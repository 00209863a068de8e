"""The tensor-core occupancy probe (`ops.probes.tc_dot_probe`) and its entry
point, `python -m wrp_tpu_torch.tools.mxu_occupancy`, on the CPU: the plain
version against the JAX tool's kernel body (tools/mxu_occupancy.py:96-106)
restated in jax.numpy (also at the kernel's edge shapes), the JSON line
beside the JAX tool's (interpret mode on the CPU), the refusals and the
kernel's shape contract, the persistent grid's plan and the second
library yardstick's operands.  The CUDA kernel is checked on the card by
chip_smoke.py (phase_probes)."""

import functools
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from wrp_tpu_torch.ops import probes
from wrp_tpu_torch.tools import mxu_occupancy

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = ["--m", "8", "--k", "16", "--widths", "16,32", "--lanes-total", "64",
        "--steps", "2", "--distinct", "2"]


def _operands(ndots, m, k, cols, seed=0):
    """bf16 A [ndots, m, k] and X [k, cols] as numpy (ml_dtypes) arrays."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((ndots, m, k), dtype=np.float32)
    x = rng.standard_normal((k, cols), dtype=np.float32)
    return a.astype(ml_dtypes.bfloat16), x.astype(ml_dtypes.bfloat16)


def _jax_body(a, x, width, steps, distinct, lanes_total):
    """The JAX kernel's body per grid step b: acc = sum_d dot(A_d, X block)
    in f32 from bf16 operands, out[b] = sum(acc, axis=1)."""
    dot = functools.partial(jnp.dot, preferred_element_type=jnp.float32)
    wmax = x.shape[1] // distinct
    out = []
    for b in range(steps):
        c0 = (b % distinct) * wmax
        xb = jnp.asarray(x[:, c0:c0 + width])
        acc = None
        for d in range(lanes_total // width):
            y = dot(jnp.asarray(a[d]), xb)
            acc = y if acc is None else acc + y
        out.append(jnp.sum(acc, axis=1))
    return np.asarray(jnp.stack(out))


def _torch_bf16(v):
    return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("m,k,width,lanes,steps,distinct", [
    (8, 16, 16, 64, 3, 2),
    (8, 16, 32, 64, 3, 2),
    (16, 32, 8, 32, 5, 3),
    (32, 48, 64, 128, 2, 1),
])
def test_plain_probe_matches_the_jax_kernel_body(m, k, width, lanes, steps,
                                                 distinct):
    wmax = 64
    a, x = _operands(lanes // 8, m, k, distinct * wmax)
    before = probes.TC_PROBE_LAUNCHES
    got = probes.tc_dot_probe(_torch_bf16(a), _torch_bf16(x), width, steps,
                              distinct, lanes).numpy()
    assert probes.TC_PROBE_LAUNCHES == before     # the CPU launches nothing
    want = _jax_body(a, x, width, steps, distinct, lanes)
    assert got.shape == (steps, m)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6


def test_probe_refusals():
    a, x = (_torch_bf16(v) for v in _operands(4, 8, 16, 64))
    with pytest.raises(ValueError, match="must divide"):
        probes.tc_dot_probe(a, x, 24, 1, 2, 64)
    with pytest.raises(ValueError, match="needs 8 dots"):
        probes.tc_dot_probe(a, x, 8, 1, 2, 64)
    with pytest.raises(ValueError, match="slabs"):
        probes.tc_dot_probe(a, x, 16, 1, 3, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        probes.tc_dot_probe(a.float(), x, 16, 1, 2, 64)


@pytest.mark.parametrize("m", [16, 64, 192])
@pytest.mark.parametrize("width", [8, 136])
def test_plain_probe_at_the_kernels_edge_shapes(m, width):
    """M below, at and past one warpgroup's 64 rows, widths under and off
    the kernel's 128-column tile: the plain version against the JAX body."""
    k, ndots, steps, distinct = 32, 2, 3, 2
    a, x = _operands(ndots, m, k, distinct * 136, seed=m + width)
    got = probes.tc_dot_probe(_torch_bf16(a), _torch_bf16(x), width, steps,
                              distinct, ndots * width).numpy()
    want = _jax_body(a, x, width, steps, distinct, ndots * width)
    assert got.shape == (steps, m)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6


def _kernel_takes(m, k, width, wmax):
    """csrc/tc_occupancy.cu's wrp_tc_dot_probe conditions on a shape."""
    return (m >= 1 and 16 <= k <= 384 and k % 16 == 0 and width % 8 == 0
            and wmax % 8 == 0 and width <= wmax)


@pytest.mark.parametrize("m,k,width,wmax", [
    (1, 16, 8, 8), (300, 384, 136, 136), (128, 384, 512, 2048),
    (8, 8, 16, 32), (8, 24, 16, 32), (8, 400, 16, 32), (8, 16, 12, 24),
    (8, 16, 16, 20),
])
def test_wrapper_refuses_what_the_kernel_refuses(m, k, width, wmax):
    """The wrapper's checks mirror the C entry's, on the CPU too: a shape
    the kernel takes runs the plain version, one it refuses raises the
    ValueError a CUDA tensor would."""
    a = torch.zeros((1, m, k), dtype=torch.bfloat16)
    x = torch.zeros((k, wmax), dtype=torch.bfloat16)
    if _kernel_takes(m, k, width, wmax):
        assert probes.tc_dot_probe(a, x, width, 2, 1, width).shape == (2, m)
    else:
        with pytest.raises(ValueError, match="the kernel takes"):
            probes.tc_dot_probe(a, x, width, 2, 1, width)


@pytest.mark.parametrize("m,width,ndots,steps,sms", [
    (128, 512, 24, 512, 132), (128, 2048, 6, 64, 132), (16, 8, 1, 1, 132),
    (192, 136, 3, 7, 5), (300, 72, 2, 5, 13), (8, 16, 4, 3, 132),
])
def test_persistent_grid_covers_every_unit_once(m, width, ndots, steps, sms):
    """Every (step, dot, row, column tile) of a call falls in exactly one
    block's units, with no block idle (blocks <= units <= the SMs' share)."""
    plan = probes.tc_probe_plan(m, width, ndots, steps, sms)
    assert plan.blocks == min(sms, plan.units)
    seen = np.zeros((steps, ndots * m, plan.col_tiles), dtype=np.int32)
    for i in range(plan.blocks):
        units = plan.block_units(i)
        assert len(units) >= 1
        for u in units:
            rb, b, ct = plan.unit(u)
            seen[b, rb * probes.TC_ROWS:(rb + 1) * probes.TC_ROWS, ct] += 1
    assert (seen == 1).all()
    cols = probes.TC_COLS
    assert plan.col_tiles * cols >= width > (plan.col_tiles - 1) * cols


def test_kcat_yardstick_is_the_sum_over_dots():
    """The second yardstick's one GEMM a step, a_cat @ x_rep[:, slab],
    equals sum_d A_d @ X[:, slab] (fp32)."""
    rng = np.random.default_rng(3)
    ndots, m, k, distinct, wmax, width = 3, 8, 16, 2, 24, 16
    a = torch.from_numpy(rng.standard_normal((ndots + 1, m, k), dtype=np.float32))
    x = torch.from_numpy(rng.standard_normal((k, distinct * wmax), dtype=np.float32))
    a_cat, x_rep = mxu_occupancy.kcat_operands(a, x, ndots)
    assert a_cat.shape == (m, ndots * k) and x_rep.shape == (ndots * k, distinct * wmax)
    for b in range(distinct):
        c0 = b * wmax
        got = a_cat @ x_rep[:, c0:c0 + width]
        want = sum(a[d] @ x[:, c0:c0 + width] for d in range(ndots))
        assert torch.linalg.norm(got - want) / torch.linalg.norm(want) < 1e-6


def _run(argv, env_extra=None):
    from conftest import cpu_subprocess_env

    env = cpu_subprocess_env(OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="",
                             **(env_extra or {}))
    return subprocess.run([sys.executable, *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=300, env=env)


def test_json_line_beside_the_jax_tools():
    """The same keys as tools/mxu_occupancy.py's line, apart from the rename
    mxu_utilisation -> tensor_core_utilisation and the additions (`device`;
    per width `library_us_per_step`, `library_kcat_us_per_step`)."""
    ours = _run(["-m", "wrp_tpu_torch.tools.mxu_occupancy", *TINY,
                 "--device", "cpu"])
    assert ours.returncode == 0, ours.stderr[-2000:]
    theirs = _run(["tools/mxu_occupancy.py", *TINY])
    assert theirs.returncode == 0, theirs.stderr[-2000:]
    r = json.loads(ours.stdout.strip().splitlines()[-1])
    j = json.loads(theirs.stdout.strip().splitlines()[-1])
    assert set(r) - {"device"} == set(j)
    assert r["device"] == "cpu"
    for key in ("m", "k", "lanes_total", "steps"):
        assert r[key] == j[key]
    for w in ("n16", "n32"):
        assert (set(r[w]) - {"library_us_per_step", "library_kcat_us_per_step"}
                == set(j[w]) - {"mxu_utilisation"} | {"tensor_core_utilisation"})
        assert r[w]["us_per_step"] > 0 and r[w]["library_us_per_step"] > 0
        assert r[w]["library_kcat_us_per_step"] > 0
        assert len(r[w]["runs_s"]) == 3
        assert r[w]["tensor_core_utilisation"] is None   # a card's number


def test_no_cuda_without_device_cpu_exits_2():
    out = _run(["-m", "wrp_tpu_torch.tools.mxu_occupancy", *TINY])
    assert out.returncode == 2, (out.stdout[-500:], out.stderr[-1000:])
    assert "CUDA is not available" in out.stderr and out.stdout == ""

"""The int16 -> bf16 hi/lo split (`ops.probes.split_planes`,
`int_split_dot`) and its entry point, `python -m
wrp_tpu_torch.tools.int_split_repro`, on the CPU: the split's exactness over
every int16 value, the plain dot against the JAX tool's kernel body
(tools/int_split_repro.py:64-79) restated in jax.numpy (also at the
kernel's edge shapes), the kernel's shape contract and grid of tiles, and
the JSON line beside the JAX tool's `--smoke` line.  The CUDA kernel is checked on the
card by chip_smoke.py (phase_probes)."""

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

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ALL_INT16 = np.arange(-32768, 32768).astype(np.int16)      # 65,536 values
ADC14 = (ALL_INT16 >= -8192) & (ALL_INT16 < 8192)


def _jax_split(v, variant):
    """The JAX kernel's split of an int16 block, in jax.numpy."""
    if variant == "int":
        lo = jnp.bitwise_and(v, 63)
        hi = v - lo
        return hi.astype(jnp.bfloat16), lo.astype(jnp.bfloat16)
    f = v.astype(jnp.float32)
    h = f.astype(jnp.bfloat16)
    return h, (f - h.astype(jnp.float32)).astype(jnp.bfloat16)


def _jax_body(x, a, variant):
    dot = functools.partial(jnp.dot, preferred_element_type=jnp.float32)
    h, l = _jax_split(jnp.asarray(x), variant)
    a = jnp.asarray(a)
    return np.asarray(dot(a, h) + dot(a, l))


@pytest.mark.parametrize("variant", ["int", "f32"])
def test_split_planes_over_every_int16_value(variant):
    """Exact on the 14-bit ADC range for both splits; over the whole int16
    range the cast split stays exact and the mask split misses 16,384
    values (its hi needs 9 significant bits where bf16 has 8).  The planes
    equal the JAX kernel's bit for bit."""
    x = torch.from_numpy(ALL_INT16)
    hi, lo = probes.split_planes(x, variant)
    assert hi.dtype == lo.dtype == torch.bfloat16
    inexact = (hi.double() + lo.double() != x.double()).numpy()
    assert not inexact[ADC14].any()
    assert int(inexact.sum()) == {"int": 16384, "f32": 0}[variant]
    assert probes.split_inexact_count(x, variant) == int(inexact.sum())
    assert probes.split_inexact_count(x[torch.from_numpy(ADC14)], variant) == 0
    jh, jl = (np.asarray(v).astype(np.float32)
              for v in _jax_split(jnp.asarray(ALL_INT16), variant))
    assert np.array_equal(hi.float().numpy(), jh)
    assert np.array_equal(lo.float().numpy(), jl)


@pytest.mark.parametrize("variant", ["int", "f32"])
@pytest.mark.parametrize("full_range", [False, True])
def test_plain_dot_matches_the_jax_kernel_body(variant, full_range):
    rng = np.random.default_rng(0)
    m, n = 32, 64
    lo, hi = (-32768, 32768) if full_range else (-8192, 8192)
    x = rng.integers(lo, hi, (m, n), dtype=np.int16)
    a = rng.standard_normal((m, m)).astype(ml_dtypes.bfloat16)
    at = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    before = probes.INT_SPLIT_LAUNCHES
    got = probes.int_split_dot(torch.from_numpy(x), at, variant).numpy()
    assert probes.INT_SPLIT_LAUNCHES == before    # the CPU launches nothing
    want = _jax_body(x, a, variant)
    assert got.shape == (m, n) and got.dtype == np.float32
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6


@pytest.mark.parametrize("variant", ["int", "f32"])
@pytest.mark.parametrize("m,n", [(64, 8), (64, 72), (256, 8), (256, 72)])
def test_plain_dot_at_the_kernels_edge_shapes(m, n, variant):
    """m at 2 and 8 row tiles of 32, n under and off the 32-column tile."""
    rng = np.random.default_rng(m + n)
    x = rng.integers(-32768, 32768, (m, n), dtype=np.int16)
    a = rng.standard_normal((m, m)).astype(ml_dtypes.bfloat16)
    at = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    got = probes.int_split_dot(torch.from_numpy(x), at, variant).numpy()
    want = _jax_body(x, a, variant)
    assert got.shape == (m, n)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6


@pytest.mark.parametrize("m,n,takes", [
    (16, 8, True), (1024, 8, True), (48, 40, True), (8, 8, False),
    (24, 8, False), (1040, 8, False), (16, 4, False), (16, 12, False),
])
def test_wrapper_refuses_what_the_kernel_refuses(m, n, takes):
    """csrc/int_split.cu takes m % 16 == 0, 16 <= m <= 1024, n % 8 == 0;
    the wrapper holds a CPU tensor to the same, so a shape the kernel
    refuses raises here as it would on the card."""
    x = torch.zeros((m, n), dtype=torch.int16)
    a = torch.zeros((m, m), dtype=torch.bfloat16)
    if takes:
        assert probes.int_split_dot(x, a, "int").shape == (m, n)
    else:
        with pytest.raises(ValueError, match="the kernel takes"):
            probes.int_split_dot(x, a, "int")


@pytest.mark.parametrize("m,n", [(128, 512), (64, 8), (256, 72), (48, 40)])
def test_tiles_cover_out_once(m, n):
    """Every element of out lies in exactly one block's tile; 64 blocks at
    the tool's [128, 512]."""
    seen = np.zeros((m, n), dtype=np.int32)
    tiles = probes.int_split_tiles(m, n)
    for r, c in tiles:
        seen[r:r + probes.SPLIT_TILE, c:c + probes.SPLIT_TILE] += 1
    assert (seen == 1).all()
    if (m, n) == (128, 512):
        assert len(tiles) == 64


def test_dot_refusals():
    x = torch.zeros((16, 8), dtype=torch.int16)
    a = torch.zeros((16, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="variant"):
        probes.int_split_dot(x, a, "mask")
    with pytest.raises(TypeError, match="int16"):
        probes.int_split_dot(x.int(), a, "int")
    with pytest.raises(ValueError, match=r"\[m, m\]"):
        probes.int_split_dot(x, a[:8], "f32")
    with pytest.raises(TypeError, match="int16"):
        probes.split_planes(x.float(), "f32")


def _run(argv):
    from conftest import cpu_subprocess_env

    env = cpu_subprocess_env(OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=300, env=env)


@pytest.mark.parametrize("variant", ["int", "f32"])
def test_smoke_json_beside_the_jax_tools(variant):
    """The JAX tool's keys and `ok`, plus `us_per_call` and `split_exact`."""
    ours = _run(["-m", "wrp_tpu_torch.tools.int_split_repro", "--smoke",
                 "--variant", variant])
    assert ours.returncode == 0, ours.stderr[-2000:]
    theirs = _run(["tools/int_split_repro.py", "--smoke", "--variant",
                   variant])
    assert theirs.returncode == 0, theirs.stderr[-2000:]
    r = json.loads(ours.stdout.strip().splitlines()[-1])
    j = json.loads(theirs.stdout.strip().splitlines()[-1])
    assert set(r) == set(j) | {"us_per_call", "split_exact"}
    assert r["ok"] is j["ok"] is True
    assert r["variant"] == j["variant"] == variant
    assert r["repro"] is False and r["backend"] == "cpu"
    assert r["rel_l2_vs_f32_matmul"] < 1e-6 and r["us_per_call"] > 0
    assert r["split_exact"] is True


def test_no_cuda_without_smoke_exits_2():
    out = _run(["-m", "wrp_tpu_torch.tools.int_split_repro"])
    assert out.returncode == 2, (out.stdout[-500:], out.stderr[-1000:])
    assert "CUDA is not available" in out.stderr and out.stdout == ""

"""The cluster body (csrc/cluster_chain.cuh) on the CPU: the route the
planar chain (#3, and #4 with offset and salt), the A-stage (#5) and the
wire chain (#7, and #8 with offset and salt) take for 1024 < m <= 8192,
each ray split across a cluster of 8 blocks.

At m = 1536, 1840, 2048, 4096, 4112, 4128, 4160 and 8192 (n = 16, two
noise sectors) the wrappers' plain versions (`cluster_stage_reference`,
`cluster_chain_power_reference`) are held against wrp_tpu's kernels in
interpret mode and the fp64 oracle: the A-stage's Y on natural rows vs
wrp_tpu's on radix rows, the planar chain (int16 and f32) vs wrp_tpu's
radix kernel on radix rows, the wire chain vs wrp_tpu's wire kernel, the
offset/salt entries vs wrp_tpu's radix kernel on the salted samples
(wrp_tpu ignores the salt in interpret mode).  The CUDA kernels themselves
are checked on the card by chip_smoke.py."""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrp_tpu import oracle
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu.constants import PipelineConstants as JConsts
from wrp_tpu.ops import device_codec as jdc
from wrp_tpu.ops.pallas import fullchain as jfull
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.constants import PipelineConstants
from wrp_tpu_torch.io import codec
from wrp_tpu_torch.ops import device_codec as tdc
from wrp_tpu_torch.ops import fullchain as tfull

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)

N = 16
CH = 3
MS = (1536, 1840, 2048, 4096, 4112, 4128, 4160, 8192)
JAX_TOL = 1e-5        # Y and power vs wrp_tpu's kernels
POWER_TOL = 1e-5      # power vs the fp64 oracle
SALT = 7


@functools.lru_cache(maxsize=1)
def _case(m):
    """m's plan, wrp_tpu's constants and two noise sectors as complex iq,
    planar int16 and wire bytes (the one geometry in memory at a time: the
    constants hold A_half, 268 MB at m = 8192)."""
    jcfg = jtiny(m=m, n=N)
    jconsts = JConsts.build(jcfg)
    radix = jfull.radix_for(m)
    a_np, fac = jfull.radix_plan_host(jconsts, radix)
    iqs = [oracle.synthetic_iq(jcfg, kind="noise", seed=m + s) for s in (0, 1)]
    cfg = tiny_config(m=m, n=N)
    return types.SimpleNamespace(
        m=m, jcfg=jcfg, jconsts=jconsts, radix=radix, a_np=a_np, fac=fac,
        order=jfull.radix_row_order(m, radix),
        plan=tfull.build_plan(PipelineConstants.build(cfg), "cpu"),
        iqs=iqs, planar=np.stack([np.stack([iq.real, iq.imag], 1)
                                  .astype(np.int16) for iq in iqs]),
        wires=np.stack([np.frombuffer(codec.encode_iq(iq, cfg), np.uint8)
                        for iq in iqs]),
        pow64=[oracle.channel_power(iq, jcfg) for iq in iqs])


def _rel(want, got):
    want = np.asarray(want).reshape(-1, got.shape[-1])
    got = np.asarray(got).reshape(-1, got.shape[-1])
    return max(oracle.relative_l2(w, g) for w, g in zip(want, got))


def _counts():
    return (tfull.ASTAGE_LAUNCHES, tfull.ASTAGE_CLUSTER_LAUNCHES,
            tfull.WIRE_LAUNCHES, tfull.WIRE_OFFSET_LAUNCHES,
            tfull.WIRE_CLUSTER_LAUNCHES, tfull.LAUNCHES,
            tfull.RADIX_OFFSET_LAUNCHES, tfull.RADIX_CLUSTER_LAUNCHES,
            tfull.DENSE_MATRIX_LAUNCHES)


def _astage(c):
    """#5 at w = n and n/2: the plain version (equal to
    cluster_stage_reference) vs wrp_tpu's A-stage on the same slab in
    radix row order."""
    x = c.planar.reshape(-1, 2, c.m, N)
    for w in (N, N // 2):
        slab = torch.from_numpy(np.ascontiguousarray(x[..., :w]))
        got = tfull.fused_chain_astage(slab, c.plan)
        assert got.shape == (x.shape[0], 2, c.m // 2, w)
        assert torch.equal(got, torch.stack(
            tfull.cluster_stage_reference(slab, c.plan), 1))
        want = np.asarray(jfull.fused_chain_astage(
            jnp.asarray(slab.numpy()[:, :, c.order, :]),
            jnp.asarray(c.a_np), c.fac, interpret=True))
        assert oracle.relative_l2(want, got.numpy()) <= JAX_TOL, w


def _wire(c):
    """#7: the plain version vs wrp_tpu's wire kernel (interpret mode) and
    the oracle, and equal to cluster_chain_power_reference on the decoded
    planar samples."""
    w32 = tdc.wire_words_i32(torch.from_numpy(c.wires), tiny_config(m=c.m,
                                                                    n=N))
    got = tfull.fused_chain_power_wire(w32, c.plan, CH)
    assert got.shape == (2, CH, c.m // 2)
    planar = torch.from_numpy(c.planar.reshape(-1, 2, c.m, N)).float()
    assert torch.equal(got.reshape(-1, c.m // 2),
                       tfull.cluster_chain_power_reference(planar, c.plan))
    wd_il, ph_il = jfull.wire_lane_consts(c.jconsts, CH)
    want = np.asarray(jfull.fused_chain_power_wire(
        jdc.wire_words_i32(jnp.asarray(c.wires), c.jcfg, radix=c.radix),
        jnp.asarray(c.a_np), c.fac, jnp.asarray(wd_il), jnp.asarray(ph_il),
        CH, interpret=True))
    assert _rel(want, got.numpy()) <= JAX_TOL
    for s in range(2):
        assert _rel(c.pow64[s], got[s].numpy()) <= POWER_TOL, s


def _offset_salt(c):
    """#8: sector 1 of the two-sector staging at salt 7 vs wrp_tpu's radix
    kernel on the salted samples and the plain version on the slab; salt 0
    equals the unsalted entry, which equals #7 on the slab alone."""
    w32 = tdc.wire_words_i32(torch.from_numpy(c.wires), tiny_config(m=c.m,
                                                                    n=N))
    got = tfull.fused_chain_power_wire(w32, c.plan, CH, offset=1, bs=1,
                                       salt=SALT)
    assert got.shape == (1, CH, c.m // 2)
    slab = torch.from_numpy(c.planar[1]).float()
    assert torch.equal(got[0], tfull.cluster_chain_power_reference(
        slab, c.plan, SALT))
    unsalted = tfull.fused_chain_power_wire(w32, c.plan, CH, offset=1, bs=1)
    assert torch.equal(unsalted, tfull.fused_chain_power_wire(
        w32, c.plan, CH, offset=1, bs=1, salt=0))
    assert torch.equal(unsalted, tfull.fused_chain_power_wire(
        w32[1:].contiguous(), c.plan, CH))
    salted = c.planar[1].astype(np.float32) + np.float32(SALT)
    want = np.asarray(jfull.fused_chain_power_radix(
        jnp.asarray(salted[:, :, c.order, :]), jnp.asarray(c.a_np), c.fac,
        jnp.asarray(c.jconsts.wd), jnp.asarray(c.jconsts.clip_phasors),
        interpret=True))
    assert _rel(want, got[0].numpy()) <= JAX_TOL


def _radix(c):
    """#3 on both sectors, int16 and f32: the plain version (equal to
    cluster_chain_power_reference) vs wrp_tpu's radix kernel (interpret
    mode) on the same samples in radix row order and the oracle; #4 on the
    second sector of the staging at salt 7: equal to
    cluster_chain_power_reference on the slab, vs wrp_tpu's radix kernel
    on the salted samples; salt 0 equal to the unsalted entry on the slab
    alone."""
    x = torch.from_numpy(c.planar.reshape(-1, 2, c.m, N))
    consts = (jnp.asarray(c.a_np), c.fac, jnp.asarray(c.jconsts.wd),
              jnp.asarray(c.jconsts.clip_phasors))
    for xs in (x, x.float()):
        got = tfull.fused_chain_power_radix(xs, c.plan)
        assert got.shape == (2 * CH, c.m // 2)
        assert torch.equal(got, tfull.cluster_chain_power_reference(xs, c.plan))
        want = np.asarray(jfull.fused_chain_power_radix(
            jnp.asarray(xs.numpy()[:, :, c.order, :]), *consts,
            interpret=True))
        assert _rel(want, got.numpy()) <= JAX_TOL, xs.dtype
        for s in range(2):
            assert _rel(c.pow64[s], got[s * CH:(s + 1) * CH].numpy()) <= POWER_TOL
    got = tfull.fused_chain_power_radix(x, c.plan, offset=CH, bc=CH, salt=SALT)
    assert got.shape == (CH, c.m // 2)
    assert torch.equal(got, tfull.cluster_chain_power_reference(
        x[CH:], c.plan, SALT))
    assert torch.equal(
        tfull.fused_chain_power_radix(x, c.plan, offset=CH, bc=CH, salt=0),
        tfull.fused_chain_power_radix(x[CH:].contiguous(), c.plan))
    salted = c.planar[1].astype(np.float32) + np.float32(SALT)
    want = np.asarray(jfull.fused_chain_power_radix(
        jnp.asarray(salted[:, :, c.order, :]), *consts, interpret=True))
    assert _rel(want, got.numpy()) <= JAX_TOL


@pytest.mark.parametrize("m,kind", [(m, k) for m in MS
                                    for k in ("astage", "wire", "offset_salt",
                                              "radix")])
def test_cluster_route_vs_jax(m, kind):
    """Each m takes the cluster route for #3/#4, #5 and #7/#8; the CPU runs
    the plain version and counts no launch."""
    assert tfull.chain_route(m) == "cluster"
    c = _case(m)
    before = _counts()
    {"astage": _astage, "wire": _wire, "offset_salt": _offset_salt,
     "radix": _radix}[kind](c)
    assert _counts() == before

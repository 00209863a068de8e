"""The row epilogue (#6, csrc/parseval_rows.cu) on the CPU: its plain
version against wrp_tpu's row-epilogue kernel in interpret mode, on noise
and on strong-DC rows; the wrapper's choice of form (`parseval_rows_form`,
the C entry's rule) and its plain version at every n, either form's; and
the register form's arithmetic restated in numpy (lanes holding float4s
of a row, the transposing butterfly of its sums) against the plain
version."""

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
from wrp_tpu_torch.ops import fullchain as tfull

torch.set_num_threads(2)


def _plan(m, n):
    return tfull.build_plan(PipelineConstants.build(tiny_config(m=m, n=n)),
                            "cpu")


def _rows(bc, rows, n, seed, dc=0.0):
    """Y [bc, 2, rows, n] f32 of noise; `dc` adds a clutter line that
    q = Y w_d makes nearly constant along the pulses."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((bc, 2, rows, n)) * 40.0
    if dc:
        wd = _plan(64, n).wd.numpy()
        y[:, :, 1] += dc * (wd.min() / wd)
    return y.astype(np.float32)


@pytest.mark.parametrize("m,n,rows,dc", [(64, 32, 32, 0.0), (64, 32, 8, 0.0),
                                         (128, 64, 16, 0.0),
                                         (64, 32, 32, 3.0e4)],
                         ids=["full-rows", "row-shard", "128x64", "strong-dc"])
def test_plain_matches_jax_kernel(m, n, rows, dc):
    """The plain version == wrp_tpu's parseval_rows_power (interpret mode)
    to <= 1e-5 rel-L2, and to the float64 restatement; on strong DC rows
    too (the explicit mean subtraction)."""
    plan = _plan(m, n)
    y = _rows(6, rows, n, seed=m + rows, dc=dc)
    got = tfull.parseval_rows_power(torch.from_numpy(y), plan).numpy()
    consts = JConsts.build(jtiny(m=m, n=n))
    want = np.asarray(jfull.parseval_rows_power(
        jnp.asarray(y), jnp.asarray(consts.wd),
        jnp.asarray(consts.clip_phasors), interpret=True))
    assert got.shape == want.shape == (6, rows)
    assert oracle.relative_l2(want, got) <= 1e-5
    assert oracle.relative_l2(_power64(y, plan), got) <= 1e-5


def _power64(y, plan):
    """pow = n sum|q - mean q|^2 - |q.f_k1|^2 - |q.f_k2|^2 in float64."""
    wd = plan.wd.double().numpy()
    ph = plan.phasors.double().numpy()
    q = (y[:, 0] + 1j * y[:, 1]).astype(np.complex128) * wd
    q = q - q.mean(axis=-1, keepdims=True)
    p = y.shape[-1] * (np.abs(q) ** 2).sum(-1)
    for c, s in ((0, 1), (2, 3)):
        p -= np.abs(q @ (ph[c] + 1j * ph[s])) ** 2
    return p


@pytest.mark.parametrize("n,ok", [(4, True), (8, True), (32, True),
                                  (100, True), (512, True), (516, True),
                                  (1024, True), (2, False), (6, False),
                                  (130, False), (514, False), (1028, False),
                                  (1030, False), (2048, False)])
def test_shape_contract(n, ok):
    """parseval_rows_form is the C entry's rule (`lanes_v`, `aligned`): the
    register form takes n % 4 == 0, 4 <= n <= 1024 at 16-byte aligned
    pointers, the two-pass form every other row; the wrapper runs every
    such row on the CPU (any rows)."""
    aligned = (0x1000, 0x2000, 0x3000)
    assert (tfull.parseval_rows_form(n, *aligned) == "registers") == ok
    for bad in ((0x1004, 0x2000, 0x3000), (0x1000, 0x2008, 0x3000),
                (0x1000, 0x2000, 0x300c)):
        assert tfull.parseval_rows_form(n, *bad) == "two-pass"
    if n < 8 or n % 2:      # tiny_config needs even n >= 8: the rule alone
        return
    plan = _plan(16, n)
    y = _rows(2, 3, n, seed=n)
    got = tfull.parseval_rows_power(torch.from_numpy(y), plan).numpy()
    assert got.shape == (2, 3)
    assert oracle.relative_l2(_power64(y, plan), got) <= 1e-5


def test_wrapper_refusals_and_launches():
    plan = _plan(64, 32)
    y = torch.zeros(2, 2, 5, 32)
    before = (tfull.PARSEVAL_ROWS_LAUNCHES,
              tfull.PARSEVAL_ROWS_TWO_PASS_LAUNCHES)
    assert tfull.parseval_rows_power(y, plan).shape == (2, 5)
    assert (tfull.PARSEVAL_ROWS_LAUNCHES,
            tfull.PARSEVAL_ROWS_TWO_PASS_LAUNCHES) == before  # the CPU: none
    with pytest.raises(TypeError, match="float32"):
        tfull.parseval_rows_power(y.double(), plan)
    with pytest.raises(ValueError, match=r"\[bc, 2, rows, 32\]"):
        tfull.parseval_rows_power(torch.zeros(2, 2, 5, 16), plan)
    with pytest.raises(ValueError, match=r"\[bc, 2, rows, 32\]"):
        tfull.parseval_rows_power(torch.zeros(2, 5, 32), plan)


def _lane_sums(v):
    """The kernel's `lane_sums` on v [32 lanes, K values]: at offset O a
    lane keeps one half of its values and adds its partner's part of it."""
    v = v.copy()
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        k = v.shape[1]
        if k == 1:
            v[:, 0] += v[lanes ^ o, 0]
            continue
        h = k // 2
        up = (lanes & o) != 0
        send = np.where(up[:, None], v[:, :h], v[:, h:])
        keep = np.where(up[:, None], v[:, h:], v[:, :h])
        v = keep + send[lanes ^ o]
    return v[:, 0]


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_lane_sums_leave_value_lane_over_32_by_k(k):
    """Every lane ends with the warp's total of value lane / (32 / K)."""
    v = np.random.default_rng(k).standard_normal((32, k))
    got = _lane_sums(v)
    want = v.sum(axis=0)[np.arange(32) // (32 // k)]
    np.testing.assert_allclose(got, want, rtol=1e-12)


def _kernel_numpy(y, plan):
    """The register form's arithmetic in float32 numpy: lane l of a warp
    holds float4s l, l + 32, ... of a row; q = Y wd, lane sums and the
    means; the centred energy and the four clip projections combined in
    the lanes; the butterfly; lane 0 writes the row."""
    bc, _, rows, n = y.shape
    n4 = n // 4
    v = -(-n4 // 32)
    v = 1 if v <= 1 else 2 if v <= 2 else 4 if v <= 4 else 8
    wd = plan.wd.numpy()
    ph = plan.phasors.numpy()
    flat = y.transpose(0, 2, 1, 3).reshape(bc * rows, 2, n)
    out = np.zeros(bc * rows, np.float32)
    f32 = np.float32
    # pos[lane, j, t]: the element of lane's float4 j, lane t
    pos = (4 * (np.arange(32)[:, None, None] + 32 * np.arange(v)[None, :, None])
           + np.arange(4)[None, None, :])
    ok = pos < n
    pc = np.minimum(pos, n - 1)
    w = np.where(ok, wd[pc], 0).astype(f32)
    fc1, fs1, fc2, fs2 = (np.where(ok, ph[i][pc], 0) for i in range(4))
    lanes = np.arange(32)
    for row, x in enumerate(flat):
        qr = np.where(ok, x[0][pc], 0).astype(f32) * w
        qi = np.where(ok, x[1][pc], 0).astype(f32) * w
        s = _lane_sums(np.stack([qr.sum(axis=(1, 2), dtype=f32),
                                 qi.sum(axis=(1, 2), dtype=f32)],
                                axis=1).astype(f32))
        mr, mi = s[0] / f32(n), s[16] / f32(n)
        ar = np.where(ok, qr - mr, 0).astype(f32)
        ai = np.where(ok, qi - mi, 0).astype(f32)
        e = (ar * ar + ai * ai).sum(axis=(1, 2), dtype=f32)
        c = [(ar * fc1 - ai * fs1).sum(axis=(1, 2), dtype=f32),
             (ar * fs1 + ai * fc1).sum(axis=(1, 2), dtype=f32),
             (ar * fc2 - ai * fs2).sum(axis=(1, 2), dtype=f32),
             (ar * fs2 + ai * fc2).sum(axis=(1, 2), dtype=f32)]
        t = _lane_sums(np.stack(c, axis=1).astype(f32)) ** 2
        t = t + t[lanes ^ 8]
        t = t + t[lanes ^ 16]
        ee = _lane_sums(e[:, None].astype(f32))
        out[row] = f32(n) * ee[0] - t[0]
    return out.reshape(bc, rows)


@pytest.mark.parametrize("n,rows", [(32, 7), (32, 2), (64, 4), (136, 3),
                                    (520, 5)])
def test_kernel_arithmetic_matches_plain(n, rows):
    """The register form's arithmetic restated in numpy == the plain
    version to <= 1e-6 rel-L2, a partly filled float4 column included
    (n = 136: V = 2, lanes 2.. of the second idle; n = 520: V = 8); on
    strong DC rows too."""
    plan = _plan(64, n)
    for dc in (0.0, 3.0e4):
        y = _rows(3, rows, n, seed=n + rows, dc=dc)
        want = tfull.parseval_rows_power_reference(torch.from_numpy(y),
                                                   plan).numpy()
        got = _kernel_numpy(y, plan)
        assert oracle.relative_l2(want, got) <= 1e-6

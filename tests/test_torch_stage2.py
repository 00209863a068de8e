"""ops/postprocess.fused_stage2 on the CPU: its plain version against
wrp_tpu's fused_stage2 (Pallas interpret mode) and the mxu method, the row
blocking and the wrapper's contract.  The CUDA kernel (csrc/fused_stage2.cu)
is checked on the card by chip_smoke.py (phase_stage2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrp_tpu import oracle
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu.constants import PipelineConstants as JConsts
from wrp_tpu.ops.pallas.postprocess import fused_stage2 as jfused_stage2
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.constants import PipelineConstants
from wrp_tpu_torch.ops import postprocess
from wrp_tpu_torch.pipeline import (_DeviceConstants, _rmatmul,
                                    channel_power_planar, matched_filter_direct)

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)


def _operands(m, n, bc=3, seed=0):
    consts = PipelineConstants.build(tiny_config(m=m, n=n))
    rng = np.random.default_rng(seed)
    yr, yi = ((rng.standard_normal((bc, m // 2, n)) * 1e-3).astype(np.float32)
              for _ in range(2))
    br = np.ascontiguousarray(consts.op_b.real)
    bi = np.ascontiguousarray(consts.op_b.imag)
    return consts, yr, yi, br, bi


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("m,n,row_block", [(64, 64, 16), (256, 128, 128),
                                           (128, 32, 64)])
def test_plain_version_matches_jax_kernel(m, n, row_block):
    """< 1e-5 rel-L2, tests/test_pallas.py:44's bound for wrp_tpu's kernel
    against its XLA chain."""
    consts, yr, yi, br, bi = _operands(m, n)
    got = postprocess.fused_stage2(*_t(yr, yi, br, bi), consts.ma_taps,
                                   row_block=row_block).numpy()
    jconsts = JConsts.build(jtiny(m=m, n=n))
    assert np.array_equal(jconsts.op_b, consts.op_b)
    want = np.asarray(jfused_stage2(
        jnp.asarray(yr), jnp.asarray(yi), jnp.asarray(br), jnp.asarray(bi),
        jconsts.ma_taps, row_block=row_block, interpret=True))
    assert got.shape == want.shape == (3, m // 2)
    assert oracle.relative_l2(want, got) < 1e-5


def test_row_blocks_are_bit_identical():
    consts, yr, yi, br, bi = _operands(128, 64)
    outs = [postprocess.fused_stage2(*_t(yr, yi, br, bi), consts.ma_taps,
                                     row_block=rb) for rb in (16, 32, 64)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("row_block", [100, 0, -32])
def test_bad_blocking_raises(row_block):
    consts, yr, yi, br, bi = _operands(128, 64)
    with pytest.raises(ValueError, match="row_block"):
        postprocess.fused_stage2(*_t(yr, yi, br, bi), consts.ma_taps,
                                 row_block=row_block)


def test_folded_filter_equals_the_literal_one():
    """The CUDA kernel folds the circular filter and the pulse sum into one
    factor, sum(taps) * sum_j |Z|^2; the plain version runs the literal
    filter.  The two agree to fp32 rounding."""
    consts, yr, yi, br, bi = _operands(128, 64, seed=4)
    zr, zi = _rmatmul(*_t(yr, yi, br, bi))
    p = zr * zr + zi * zi
    folded = float(np.sum(consts.ma_taps.astype(np.float64))) * p.sum(dim=-1)
    literal = matched_filter_direct(p, consts.ma_taps).sum(dim=-1)
    assert oracle.relative_l2(literal.numpy(), folded.numpy()) < 1e-6
    assert torch.equal(literal, postprocess.fused_stage2_reference(
        *_t(yr, yi, br, bi), consts.ma_taps))


def test_on_the_mxu_methods_range_stage():
    """Fed the mxu method's Y = A_half @ X of real sectors, fused_stage2
    gives that method's matched-filter power, and the oracle's."""
    cfg = tiny_config(m=64, n=32)
    jcfg = jtiny(m=64, n=32)
    iqs = [oracle.synthetic_iq(jcfg, kind="noise", seed=s) for s in (1, 2)]
    x = torch.from_numpy(np.stack([np.stack([iq.real, iq.imag], 1)
                                   for iq in iqs]).astype(np.float32))
    consts = PipelineConstants.build(cfg)
    dc = _DeviceConstants(consts, torch.device("cpu"))
    xr, xi = x[:, :, 0], x[:, :, 1]
    yr, yi = _rmatmul(dc.ar, dc.ai, xr, xi)
    got = postprocess.fused_stage2(yr.reshape(-1, 32, 32), yi.reshape(-1, 32, 32),
                                   dc.br, dc.bi, consts.ma_taps, row_block=32)
    want = channel_power_planar(xr, xi, dc, "mxu").reshape(-1, 32)
    assert oracle.relative_l2(want.numpy(), got.numpy()) < 1e-6
    for s, iq in enumerate(iqs):
        pow64 = oracle.channel_power(iq, jcfg)
        for c in range(3):
            assert oracle.relative_l2(pow64[c], got[3 * s + c].numpy()) < 1e-5


def test_wrapper_contract():
    """A CPU tensor takes the plain version and launches nothing; another
    non-CUDA device, a wrong dtype or shape raises."""
    consts, yr, yi, br, bi = _operands(64, 32)
    ops = _t(yr, yi, br, bi)
    before = postprocess.STAGE2_LAUNCHES
    assert torch.equal(postprocess.fused_stage2(*ops, consts.ma_taps, 32),
                       postprocess.fused_stage2_reference(*ops, consts.ma_taps))
    assert postprocess.STAGE2_LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        postprocess.fused_stage2(*(t.to("meta") for t in ops), consts.ma_taps,
                                 32)
    with pytest.raises(TypeError, match="float32"):
        postprocess.fused_stage2(ops[0].double(), *ops[1:], consts.ma_taps, 32)
    with pytest.raises(ValueError, match="op_br"):
        postprocess.fused_stage2(*ops[:2], ops[2][:16], ops[3], consts.ma_taps,
                                 32)
    with pytest.raises(ValueError, match="one \\[BC, rows, n\\]"):
        postprocess.fused_stage2(ops[0], ops[1][:2], *ops[2:], consts.ma_taps,
                                 32)

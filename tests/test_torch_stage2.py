"""ops/postprocess.fused_stage2 on the CPU: its plain version against
wrp_tpu's fused_stage2 (Pallas interpret mode) and the mxu method, the row
blocking and the wrapper's contract; the CUDA kernel's split-TF32
arithmetic emulated in torch (`tf32_round`, `split_tf32`,
`tf32x3_power_reference`) against fp64 and wrp_tpu's kernel, so the
precision it gives is held before it reaches the card.  The CUDA kernel
(csrc/fused_stage2.cu) is checked on the card by chip_smoke.py
(phase_stage2)."""

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
    before = (postprocess.STAGE2_LAUNCHES, postprocess.STAGE2_OPERATOR_LAUNCHES)
    assert torch.equal(postprocess.fused_stage2(*ops, consts.ma_taps, 32),
                       postprocess.fused_stage2_reference(*ops, consts.ma_taps))
    assert (postprocess.STAGE2_LAUNCHES,
            postprocess.STAGE2_OPERATOR_LAUNCHES) == before
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


def _edge_values() -> torch.Tensor:
    """fp32 values across the normal range: random magnitudes and signs,
    powers of two, their neighbours, and exact TF32 ties (x = 1 + (2k + 1)
    2^-11 scaled)."""
    rng = np.random.default_rng(7)
    mags = np.exp2(rng.uniform(-100, 100, 4096)) * rng.choice([-1, 1], 4096)
    pow2 = np.exp2(np.arange(-120, 120, dtype=np.float64))
    ties = (1 + (2 * np.arange(64) + 1) * 2.0 ** -11) * 2.0 ** rng.integers(
        -60, 60, 64)
    x = np.concatenate([mags, pow2, -pow2, np.nextafter(pow2, 0),
                        np.nextafter(pow2, np.inf), ties, -ties])
    return torch.from_numpy(x.astype(np.float32))


def test_tf32_round_is_nearest_ties_away():
    """tf32_round keeps 11 significant bits (the low 13 of the fp32 word
    zero), lands within half a TF32 ulp (2^-11 |x|), and rounds an exact
    tie away from zero, as cvt.rna.tf32.f32 does."""
    x = _edge_values()
    r = postprocess.tf32_round(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    err = (x.double() - r.double()).abs()
    assert bool((err <= 2.0 ** -11 * x.double().abs()).all())
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                        1 + 2 ** -11 - 2 ** -23], dtype=torch.float32)
    assert postprocess.tf32_round(tie).tolist() == [
        1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 * 2 ** -10, 1.0]


@pytest.mark.parametrize("truncate,bound", [(False, 2.0 ** -22),
                                            (True, 2.0 ** -21)])
def test_split_bound(truncate, bound):
    """x = hi + lo, both TF32 values: |x - hi - lo| <= 2^-22 |x| with hi
    rounded (the kernel's split of Y: hi within 2^-11 |x|, lo within 2^-11
    of the rest) and 2^-21 |x| with hi truncated (its split of B, whose
    fp32 words the tensor cores read truncated: hi within 2^-10 |x|)."""
    x = _edge_values()
    hi, lo = postprocess.split_tf32(x, truncate)
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= bound * x.double().abs()).all())


#: the 3 x TF32 emulation vs fp64: the split leaves 2^-21 of an operand and
#: fp32 sums a few 2^-24 (measured ~1e-7 at these shapes): 1e-6, the
#: kernel's own bound vs its plain version (chip_smoke.STAGE2_TOL)
EMU_TOL = 1e-6


@pytest.mark.parametrize("m,n", [(64, 64), (128, 32), (256, 128)])
def test_tf32x3_emulation_vs_fp64_and_jax_kernel(m, n):
    """The kernel's arithmetic in torch (real form, Y rounded and B
    truncated to TF32 hi + lo, three products, fp32 sums) against the
    power in fp64 < EMU_TOL and against wrp_tpu's bf16 x 3 kernel in
    interpret mode < 1e-5 (tests/test_pallas.py:44's bound for that
    kernel)."""
    consts, yr, yi, br, bi = _operands(m, n, seed=m + n)
    emu = postprocess.tf32x3_power_reference(*_t(yr, yi, br, bi),
                                             consts.ma_taps).numpy()
    z = ((yr.astype(np.float64) + 1j * yi.astype(np.float64))
         @ (br.astype(np.float64) + 1j * bi.astype(np.float64)))
    want = np.sum(consts.ma_taps.astype(np.float64)) * (np.abs(z) ** 2).sum(-1)
    assert oracle.relative_l2(want, emu) < EMU_TOL
    jconsts = JConsts.build(jtiny(m=m, n=n))
    jax_pow = np.asarray(jfused_stage2(
        jnp.asarray(yr), jnp.asarray(yi), jnp.asarray(br), jnp.asarray(bi),
        jconsts.ma_taps, row_block=m // 2, interpret=True))
    assert oracle.relative_l2(jax_pow, emu) < 1e-5


def _truncating_power(a, b, chain: int, taps) -> np.ndarray:
    """The kernel's GEMM with the tensor cores' accumulation emulated: each
    k8 step's three TF32 products (exact: summed in fp64) join the
    accumulator rounded toward zero to fp32; every `chain` steps the
    accumulator joins the running sum in an IEEE fp32 add and restarts from
    zero.  a [rows, K], b [K, N] fp32 (the real form) -> the power."""
    ah, al = (t.double() for t in postprocess.split_tf32(a))
    bh, bl = (t.double() for t in postprocess.split_tf32(b, truncate=True))

    def toward_zero(x):
        f = x.float()
        over = f.double().abs() > x.abs()
        return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f).double()

    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    d = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
    for s in range(a.shape[1] // 8):
        k = slice(8 * s, 8 * s + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            d = toward_zero(d + x[:, k] @ y[k])
        if (s + 1) % chain == 0:
            acc, d = acc + d.float(), torch.zeros_like(d)
    z = acc.double()
    return (np.sum(taps.astype(np.float64)) * (z * z).sum(-1)).numpy()


def test_truncating_accumulation_needs_short_chains():
    """Why the kernel adds every two k8 steps' products into its running
    sum in fp32 instead of chaining all of K in one tensor-core
    accumulator: truncation at each add biases a long chain toward zero.
    At n = 512 (K = 1024) a chain over all of K misses EMU_TOL against
    fp64, a chain of two k8 steps (the kernel's) holds it."""
    consts = PipelineConstants.build(tiny_config(m=32, n=512))
    rng = np.random.default_rng(5)
    yr, yi = (torch.from_numpy((rng.standard_normal((16, 512)) * 1e-3)
                               .astype(np.float32)) for _ in range(2))
    br, bi = _t(np.ascontiguousarray(consts.op_b.real),
                np.ascontiguousarray(consts.op_b.imag))
    a = torch.cat([yr, yi], dim=-1)
    b = torch.cat([torch.cat([br, bi], dim=1), torch.cat([-bi, br], dim=1)])
    want = np.sum(consts.ma_taps.astype(np.float64)) * (
        (a.double() @ b.double()) ** 2).sum(-1).numpy()
    whole = _truncating_power(a, b, 128, consts.ma_taps)
    kernel = _truncating_power(a, b, 2, consts.ma_taps)
    assert oracle.relative_l2(want, whole) > EMU_TOL
    assert oracle.relative_l2(want, kernel) < EMU_TOL

"""The fused gate→conv's two routes on the card, and route T's arithmetic
against the JAX package's kernels, on the CPU.

(a) ``kernels.masked_act.conv_route`` is the one rule that sends a call on a
CUDA tensor to route T (``"tf32x3"``, float32 on the tensor cores, each
operand split into a big and a small TF32 part) or route F (``"fma"``,
float32 FMA): the kernel library launches the route it is given or refuses,
and nothing falls back.  The rule is plain Python, so it is tested here,
where there is no card.

(b) ``ref.round_tf32`` / ``ref.split_tf32`` on chosen bit patterns, and
``ref.masked_act_conv3x3_tf32x3_ref``, a plain emulation of route T's
arithmetic (pixel by pixel, padding taps skipped, three split products per
tap), against the reference's Pallas kernels in interpret mode on the same
numpy inputs.  Tolerance 2e-4 + 2e-4·|ref|, the float32 conv tolerance of
the card's checks; and its error against a float64 convolution stays within
4× that of the float32 plain version, the contract the card holds route T
to.  On the CPU ``ops`` still take the plain version.
"""
import numpy as np
import pytest
import torch

from test_torch_helpers import reference

KINDS = ["relu", "gelu", "silu", "sqrelu"]
CONV_TOL = dict(rtol=2e-4, atol=2e-4)
ERR_RATIO = 4.0
BF, F32 = torch.bfloat16, torch.float32
ALIGNED = (0x1000, 0x2000, 0x3000, 0x4000)
# reduced ResNet stages at B = 64: (H = W, Cin = Cout)
STAGES = [(8, 32), (4, 64)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- route rule


@pytest.mark.parametrize("dtype, b, cin, cout, ptrs, hw, n_cand, route", [
    # ResNet18's and WRN-22-8's conv2 at the eval batch: Cin = Cout
    (F32, 128, 64, 64, ALIGNED, 32, 8, "tf32x3"),
    (F32, 128, 128, 128, ALIGNED, 16, 1, "tf32x3"),
    (F32, 128, 256, 256, ALIGNED, 8, 8, "tf32x3"),
    (F32, 128, 512, 512, ALIGNED, 4, 8, "tf32x3"),
    (F32, 128, 128, 128, ALIGNED, 32, 8, "tf32x3"),
    (F32, 64, 40, 72, ALIGNED, 7, 1, "tf32x3"),
    (F32, 192, 8, 8, ALIGNED, 1, 3, "tf32x3"),
    # bfloat16 stays on route F
    (BF, 128, 64, 64, ALIGNED, 32, 8, "fma"),
    # a batch that is not a multiple of 64 (the card-vs-CPU check's 8)
    (F32, 8, 64, 64, ALIGNED, 32, 1, "fma"),
    (F32, 96, 64, 64, ALIGNED, 32, 1, "fma"),
    # Cin or Cout not a multiple of 8
    (F32, 64, 6, 64, ALIGNED, 8, 1, "fma"),
    (F32, 64, 64, 10, ALIGNED, 8, 1, "fma"),
    # an operand 4 bytes off a 16-byte boundary (x, then out)
    (F32, 64, 64, 64, (0x1004,) + ALIGNED[1:], 8, 1, "fma"),
    (F32, 64, 64, 64, ALIGNED[:3] + (0x4008,), 8, 1, "fma"),
    # a missing pointer is not checked
    (F32, 64, 64, 64, ALIGNED[:3] + (None,), 8, 1, "tf32x3"),
    # TMA coordinates: a row of x (H*W*Cin) and the stacked images (N*B)
    (F32, 64, 2 ** 17, 64, ALIGNED, 128, 1, "fma"),
    (F32, 64, 2 ** 16, 64, ALIGNED, 128, 1, "tf32x3"),
    (F32, 2 ** 25, 8, 8, ALIGNED, 1, 64, "fma"),
    (F32, 2 ** 25, 8, 8, ALIGNED, 1, 63, "tf32x3"),
])
def test_conv_route_rule(dtype, b, cin, cout, ptrs, hw, n_cand, route):
    from repro_torch.kernels import masked_act as K
    assert K.conv_route(dtype, b, cin, cout, ptrs, hw, hw, n_cand) == route
    assert route in K.CONV_ROUTES


@pytest.mark.parametrize("dtype, b, cin, cout, h, w, n_cand, err", [
    (torch.float16, 64, 64, 64, 8, 8, 1, TypeError),
    (torch.float64, 64, 64, 64, 8, 8, 1, TypeError),
    (F32, 0, 64, 64, 8, 8, 1, ValueError),
    (F32, 64, 0, 64, 8, 8, 1, ValueError),
    (F32, 64, 64, 0, 8, 8, 1, ValueError),
    (F32, 64, 64, 64, 0, 8, 1, ValueError),
    (F32, 64, 64, 64, 8, 0, 1, ValueError),
    (BF, 64, 64, 64, 8, 8, 0, ValueError),
])
def test_conv_route_rule_refuses(dtype, b, cin, cout, h, w, n_cand, err):
    from repro_torch.kernels import masked_act as K
    with pytest.raises(err):
        K.conv_route(dtype, b, cin, cout, ALIGNED, h, w, n_cand)


# ------------------------------------------------------------ TF32 split


def _f(bits):
    return np.array([bits], dtype=np.uint32).view(np.float32)[0]


@pytest.mark.parametrize("x, want", [
    (1.0, 1.0),
    # halfway between 1 and 1 + 2^-10: ties away from zero (not to even)
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),
    (1.0 + 2.0 ** -10 + 2.0 ** -11, 1.0 + 2.0 ** -9),
    (0.0, 0.0),
    (float("inf"), float("inf")),
    # the largest float32 rounds past the largest TF32 to infinity
    (float(_f(0x7F7FFFFF)), float("inf")),
    # a subnormal keeps its top 10 mantissa bits
    (float(_f(0x00001FFF)), float(_f(0x00002000))),
    (float(_f(0x00000FFF)), 0.0),
])
def test_round_tf32_bit_patterns(x, want):
    from repro_torch.kernels import ref
    got = ref.round_tf32(torch.tensor([x], dtype=F32))
    assert got.item() == want
    assert int(got.view(torch.int32).item()) & 0x1FFF == 0


def test_split_tf32_keeps_22_bits():
    from repro_torch.kernels import ref
    rng = np.random.default_rng(0)
    x = _t((rng.normal(size=4096) * np.exp(rng.normal(size=4096) * 10))
           .astype(np.float32))
    hi, lo = ref.split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    # TF32 alone keeps 11 bits: the split is what makes it float32-level
    assert float(((x - hi).double().abs() / x.double().abs()).max()) > 2e-4


# ------------------------------------------------- route T's arithmetic


def _inputs(seed, lead, hw, c):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (hw, hw, c)).astype(np.float32)
    w = (rng.normal(size=(3, 3, c, c)) * (2.0 / (9 * c)) ** 0.5
         ).astype(np.float32)
    return rng, x, w


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw, c", STAGES)
def test_tf32x3_emulation_matches_pallas_interpret(hw, c, stride, kind):
    """Kernel 5's route T arithmetic at reduced stage shapes, B = 64."""
    from repro_torch.kernels import ref as tref
    ref = reference()
    rng, x, w = _inputs(hw + c, (64,), hw, c)
    m = (rng.random((hw, hw, c)) < 0.6).astype(np.float32)
    want = ref.masked_act.masked_act_conv3x3(
        ref.jnp.asarray(x), ref.jnp.asarray(m), ref.jnp.asarray(w),
        stride=stride, kind=kind, interpret=True)
    got = tref.masked_act_conv3x3_tf32x3_ref(_t(x), _t(m), _t(w),
                                             stride=stride, kind=kind)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("shared_x", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw, c", STAGES)
def test_tf32x3_emulation_batched_matches_pallas_interpret(hw, c, stride,
                                                           shared_x):
    """Kernel 6's route T arithmetic, three candidates; ``shared_x`` gives x
    as a stride-0 view of one tensor, against the reference's broadcast."""
    from repro_torch.kernels import ref as tref
    ref = reference()
    n = 3
    rng, x, w = _inputs(2 * hw + c, (1 if shared_x else n, 64), hw, c)
    ms = (rng.random((n, hw, hw, c)) < 0.6).astype(np.float32)
    tx = _t(x).expand((n,) + x.shape[1:])
    want = ref.masked_act.masked_act_conv3x3_batched(
        ref.jnp.asarray(tx.numpy()), ref.jnp.asarray(ms), ref.jnp.asarray(w),
        stride=stride, interpret=True)
    got = tref.masked_act_conv3x3_tf32x3_ref(tx, _t(ms), _t(w),
                                             stride=stride)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw, c", STAGES)
def test_tf32x3_error_against_float64(hw, c, stride):
    """The emulation's error against a float64 convolution is within 4×
    the float32 plain version's — and TF32 products alone would not be."""
    from repro_torch.kernels import ref as tref
    rng, x, w = _inputs(3 * hw + c, (2, 64), hw, c)
    ms = (rng.random((2, hw, hw, c)) < 0.6).astype(np.float32)
    exact = tref.masked_act_conv3x3_ref(_t(x).double(), _t(ms).double(),
                                        _t(w).double(), stride=stride)

    def err(y):
        return float((y.double() - exact).abs().max())
    plain = err(tref.masked_act_conv3x3_ref(_t(x), _t(ms), _t(w),
                                            stride=stride))
    split = err(tref.masked_act_conv3x3_tf32x3_ref(_t(x), _t(ms), _t(w),
                                                   stride=stride))
    m = _t(ms)[:, None]
    g = m * torch.clamp_min(_t(x), 0.0) + (1.0 - m) * _t(x)
    tf32 = err(tref.masked_act_conv3x3_ref(tref.round_tf32(g), torch.ones(
        (2,) + ms.shape[1:]), tref.round_tf32(_t(w)), stride=stride))
    assert split <= ERR_RATIO * plain, (split, plain)
    assert tf32 > 50 * plain, (tf32, plain)


def test_cpu_ops_take_the_plain_version():
    """On CPU tensors ``ops`` dispatch to the plain version, bit for bit,
    whatever route the card would take."""
    from repro_torch.kernels import ops, ref as tref
    rng, x, w = _inputs(7, (2, 64), 4, 64)
    ms = (rng.random((2, 4, 4, 64)) < 0.6).astype(np.float32)
    got = ops.masked_act_conv3x3_batched(_t(x), _t(ms), _t(w))
    assert torch.equal(got, tref.masked_act_conv3x3_ref(_t(x), _t(ms),
                                                        _t(w)))
    got = ops.masked_act_conv3x3(_t(x[0]), _t(ms[0]), _t(w), stride=2)
    assert torch.equal(got, tref.masked_act_conv3x3_ref(
        _t(x[0]), _t(ms[0]), _t(w), stride=2))

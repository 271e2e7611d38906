"""The port's CNN training step, its loss and accuracy closure, and the
hard gate's gradient, against the JAX package on the CPU.

Parameters are the reference's ``CNN.init`` converted with
``repro_torch.convert`` (never re-initialised); images, labels, masks and
gradients are made with numpy from a seed.  The mini CNN is
``CNNConfig("r18-mini", 4, 8, ((8, 2, 1), (16, 2, 2)), stem_channels=8)``.

Tolerances:
  * gate gradients (dx): 1e-6 + 1e-6·|ref|, the gate kernel's own — the
    same float32 products, only tanh / exp and the order of two additions
    differ; dpoly, a sum over r rows in another order:
    1e-7 + 2·(r − 1)·2⁻²⁴·Σ|terms|, the bound of two float32 sums of r
    terms;
  * one step's gradients: 1e-4 of each leaf's largest |gradient| — the
    convolutions and BatchNorm statistics are summed in other orders
    (~1e-6 relative per layer) and every BatchNorm's rsqrt rescales that
    rounding, as for the logits in ``test_torch_resnet.py`` (observed
    ≤ 1.1e-5);
  * five steps: each step's loss within 1e-6 relative, and the parameters
    within 2e-3 of each leaf's largest |value|.  A ReLU whose
    pre-activation lies within rounding of 0 can take the other side in
    the other package — the gradient is discontinuous there.  This is seen
    once, at the fifth step with full masks (g0b1.relu1: 3.3e-7 in the
    reference, −7.0e-7 here), moving g0b1's and the stem's parameters by
    up to 1.0e-3 of their largest value; every other difference is below
    4e-6 of it.
"""
import numpy as np
import pytest
import torch

from test_torch_helpers import random_masks, reference, to_numpy_tree

GATE_TOL = dict(rtol=1e-6, atol=1e-6)
KINDS = ("relu", "gelu", "silu", "sqrelu")
STAGES = ((8, 2, 1), (16, 2, 2))


@pytest.fixture(scope="module")
def mini():
    from repro_torch import convert
    from repro_torch.data import ImageDatasetCfg, SyntheticImages
    from repro_torch.models.resnet import CNN, CNNConfig
    ref = reference()
    import repro.training.optimizer as ropt
    import repro.training.train as rtrain
    rmodel = ref.resnet.CNN(ref.resnet.CNNConfig("r18-mini", 4, 8, STAGES,
                                                 stem_channels=8))
    tmodel = CNN(CNNConfig("r18-mini", 4, 8, STAGES, stem_channels=8))
    rparams = rmodel.init(ref.jax.random.PRNGKey(0))
    tparams = convert.params_from_reference(to_numpy_tree(rparams), "cpu")
    data = SyntheticImages(ImageDatasetCfg(n_classes=4, image_size=8,
                                           n_train=256, n_test=64))
    return dict(ref=ref, ropt=ropt, rtrain=rtrain, rmodel=rmodel,
                tmodel=tmodel, rparams=rparams, tparams=tparams,
                batches=data.batches("train", 32), data=data)


def _j(ref, tree):
    return {k: ref.jnp.asarray(v) for k, v in tree.items()}


def _rel_err(got, want):
    """max |got − want| / max |want|, leaf by leaf, worst leaf."""
    return max(float(np.abs(g.detach().numpy() - w).max() /
                     max(np.abs(w).max(), 1e-30)) for g, w in zip(got, want))


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("with_valid", [False, True])
def test_cross_entropy_and_its_gradient_match_reference(with_valid):
    from repro_torch.training import train
    ref = reference()
    import repro.training.train as rtrain
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(5, 7, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, size=(5, 7)).astype(np.int32)
    valid = (rng.random((5, 7)) < 0.7).astype(np.float32) \
        if with_valid else None

    def rl(lg):
        return rtrain.cross_entropy(lg, ref.jnp.asarray(labels),
                                    None if valid is None
                                    else ref.jnp.asarray(valid))
    want, want_g = ref.jax.value_and_grad(rl)(ref.jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = train.cross_entropy(lt, torch.from_numpy(labels),
                              None if valid is None
                              else torch.from_numpy(valid))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- train step


@pytest.mark.parametrize("density", [1.0, 0.6])
def test_train_step_gradients_match_reference(mini, density):
    from repro_torch import convert
    from repro_torch.core import masks as M
    from repro_torch.training import optimizer as opt, train
    ref, rtrain, ropt = mini["ref"], mini["rtrain"], mini["ropt"]
    masks = random_masks(mini["tmodel"].mask_sites(), 5, density)
    _, rloss = rtrain.make_cnn_train_step(mini["rmodel"], ropt.sgd(5e-2))
    _, tloss = train.make_cnn_train_step(mini["tmodel"], opt.sgd(5e-2))
    for i in range(3):
        b = mini["batches"](i)
        (rl, ra), rg = ref.jax.value_and_grad(
            lambda p: rloss(p, _j(ref, masks), _j(ref, b)),
            has_aux=True)(mini["rparams"])
        (tl, ta), tg = train.loss_and_grads(
            tloss, mini["tparams"], M.as_device(masks, "cpu"),
            convert.to_device(b, "cpu"))
        assert float(tl) == pytest.approx(float(rl), rel=1e-6)
        assert float(ta) == float(ra)
        leaves = opt.tree_leaves(tg)
        assert len(leaves) == len(ref.jax.tree.leaves(rg)) == 30
        assert all(bool(g.abs().max() > 0) for g in leaves)
        assert _rel_err(leaves, ref.jax.tree.leaves(to_numpy_tree(rg))) \
            <= 1e-4


@pytest.mark.parametrize("density", [1.0, 0.6])
def test_five_train_steps_match_reference(mini, density):
    from repro_torch import convert
    from repro_torch.core import masks as M
    from repro_torch.training import optimizer as opt, train
    ref, rtrain, ropt = mini["ref"], mini["rtrain"], mini["ropt"]
    masks = random_masks(mini["tmodel"].mask_sites(), 5, density)
    r_opt, t_opt = ropt.sgd(5e-2, momentum=0.9), opt.sgd(5e-2, momentum=0.9)
    rstep, _ = rtrain.make_cnn_train_step(mini["rmodel"], r_opt)
    tstep, _ = train.make_cnn_train_step(mini["tmodel"], t_opt)
    rp, tp = mini["rparams"], mini["tparams"]
    rs, ts = r_opt.init(rp), t_opt.init(tp)
    before = [t.clone() for t in opt.tree_leaves(tp)]
    for i in range(5):
        b = mini["batches"](i)
        rp, rs, rl, ra = rstep(rp, rs, _j(ref, masks), _j(ref, b))
        tp, ts, tl, ta = tstep(tp, ts, M.as_device(masks, "cpu"),
                               convert.to_device(b, "cpu"))
        assert float(tl) == pytest.approx(float(rl), rel=1e-6), i
        assert float(ta) == float(ra), i
    assert ts.step == 5
    assert _rel_err(opt.tree_leaves(tp),
                    ref.jax.tree.leaves(to_numpy_tree(rp))) <= 2e-3
    # new trees: the inputs were not updated in place
    for t, b in zip(opt.tree_leaves(mini["tparams"]), before):
        assert torch.equal(t, b)


def test_make_eval_acc_matches_reference(mini):
    from repro_torch import convert
    from repro_torch.core import masks as M
    from repro_torch.training import train
    ref, rtrain = mini["ref"], mini["rtrain"]
    eval_b = mini["data"].train_eval_set(64)
    rb, tb = _j(ref, eval_b), convert.to_device(eval_b, "cpu")
    racc = rtrain.make_eval_acc(
        lambda p, m: mini["rmodel"].forward(p, m, rb["images"]), rb)
    tacc = train.make_eval_acc(
        lambda p, m: mini["tmodel"].forward(p, m, tb["images"]), tb)
    for seed in (1, 2):
        masks = random_masks(mini["tmodel"].mask_sites(), seed)
        want = float(racc(mini["rparams"], _j(ref, masks)))
        got = tacc(mini["tparams"], M.as_device(masks, "cpu"))
        assert got.dim() == 0 and float(got) == want


# ------------------------------------------------------ the gate's gradient


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("replacement", ["identity", "poly2"])
def test_masked_act_fn_gradients_match_jax_grad(kind, replacement):
    """dx (and dpoly for poly2) of the hard gate through ``MaskedActFn``,
    against ``jax.grad`` through the reference's hard gate, with exact
    zeros in x (relu′(0) = 1/2, sqrelu′(0) = 0)."""
    from repro_torch.core import linearize
    from repro_torch.kernels import ops
    ref = reference()
    jnp = ref.jnp
    rng = np.random.default_rng(17)
    shape = (3, 4, 5)
    b = 6
    x = rng.normal(size=(b,) + shape).astype(np.float32)
    x.reshape(-1)[rng.choice(x.size, 20, replace=False)] = 0.0
    m = (rng.random(shape) < 0.5).astype(np.float32)
    p = (rng.normal(size=(3,) + shape) * 0.3).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    poly = replacement == "poly2"
    rsite = ref.linearize.MaskSite(shape, kind, replacement)
    tsite = linearize.MaskSite(shape, kind, replacement)

    def rf(xx, pp):
        y = ref.linearize.apply_masked_act(xx, jnp.asarray(m), rsite,
                                           poly=pp if poly else None)
        return jnp.sum(y * jnp.asarray(g))
    want_dx, want_dp = ref.jax.grad(rf, argnums=(0, 1))(jnp.asarray(x),
                                                         jnp.asarray(p))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    pt = torch.from_numpy(p.copy()).requires_grad_()
    y = linearize.apply_masked_act(xt, torch.from_numpy(m), tsite,
                                   poly=pt if poly else None)
    names = set()
    stack = [y.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is not None:
            names.add(type(fn).__name__)
            stack.extend(f for f, _ in fn.next_functions)
    assert any(n.startswith("MaskedActFn") for n in names), names
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               **GATE_TOL)
    if not poly:
        assert pt.grad is None
        return
    terms = np.abs(g * (1 - m) * np.stack([x * x, x, np.ones_like(x)], 1)
                   .transpose(1, 0, 2, 3, 4)).sum(1)
    bound = 1e-7 + 2 * (b - 1) * 2.0 ** -24 * terms
    assert np.all(np.abs(pt.grad.numpy() - np.asarray(want_dp)) <= bound)


def test_plain_backward_writes_out_the_rule():
    """``ref.masked_act_bwd_ref`` (what a CPU tensor's backward and the
    card's yardstick use) against autograd through the plain forward,
    and dpoly is None unless asked for."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(9, 13)).astype(np.float32))
    x[0, :4] = 0.0
    m = torch.from_numpy((rng.random(13) < 0.5).astype(np.float32))
    p = torch.from_numpy(rng.normal(size=(3, 13)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(9, 13)).astype(np.float32))
    for kind in KINDS:
        xa, pa = x.clone().requires_grad_(), p.clone().requires_grad_()
        ref.masked_act_ref(xa, m, kind=kind, poly=pa).backward(g)
        dx, dp = ref.masked_act_bwd_ref(x, m, g, kind, p, need_dpoly=True)
        np.testing.assert_allclose(dx.numpy(), xa.grad.numpy(), **GATE_TOL)
        np.testing.assert_allclose(dp.numpy(), pa.grad.numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert ref.masked_act_bwd_ref(x, m, g, kind, p)[1] is None


def test_tie_conventions_match_jax_grad():
    """JAX's derivatives at ties, where PyTorch's own differ: the soft
    gate's clip at 0 and 1 (1/2, torch.clamp 1), |·| at ±0 (1, torch.abs
    0), relu at 0 (1/2, torch.relu 0, torch.clamp_min 1), sqrelu at 0."""
    from repro_torch.core import linearize
    from repro_torch.kernels import ref as tref
    ref = reference()
    jax, jnp = ref.jax, ref.jnp
    v = np.array([0.0, -0.0, 1.0, -1.0, 0.5, 1.5, -0.25], np.float32)

    def tgrad(fn, arr):
        t = torch.from_numpy(arr.copy()).requires_grad_()
        fn(t).sum().backward()
        return t.grad.numpy()
    np.testing.assert_array_equal(
        tgrad(tref.abs_tie, v), np.asarray(jax.grad(
            lambda a: jnp.sum(jnp.abs(a)))(jnp.asarray(v))))
    np.testing.assert_array_equal(
        tgrad(lambda t: tref.tie_clamp(t, 0.0, 1.0), v),
        np.asarray(jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 1.0)))(
            jnp.asarray(v))))
    for kind in ("relu", "sqrelu"):
        np.testing.assert_array_equal(
            tgrad(lambda t: tref._act(t, kind), v),
            np.asarray(jax.grad(lambda a: jnp.sum(ref.ref._act(a, kind)))(
                jnp.asarray(v))))
    assert tgrad(lambda t: tref._act(t, "relu"), v)[0] == 0.5
    # the soft gate: mask weights on the clip's bounds, x with zeros
    rng = np.random.default_rng(4)
    shape = (2, 7)
    x = rng.normal(size=(3,) + shape).astype(np.float32)
    x[:, 0, :] = 0.0
    a = np.tile(v, (2, 1)).astype(np.float32)
    for kind in KINDS:
        rsite = ref.linearize.MaskSite(shape, kind)
        tsite = linearize.MaskSite(shape, kind)
        want_a, want_x = jax.grad(
            lambda aa, xx: jnp.sum(ref.linearize.apply_masked_act(
                xx, aa, rsite, soft=True)), argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(x))
        at = torch.from_numpy(a.copy()).requires_grad_()
        xt = torch.from_numpy(x.copy()).requires_grad_()
        linearize.apply_masked_act(xt, at, tsite, soft=True).sum().backward()
        np.testing.assert_allclose(at.grad.numpy(), np.asarray(want_a),
                                   **GATE_TOL)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x),
                                   **GATE_TOL)


# ------------------------------------------------------------ the repair


def test_raw_kernel_wrappers_refuse_grad_before_anything_else():
    """Every raw wrapper raises when a gradient would be recorded through
    it, before the CUDA-only checks and the launch: a CUDA result would
    carry no grad_fn and cut every parameter upstream off."""
    from repro_torch.kernels import build, masked_act as K, ops
    from repro_torch.kernels import rwkv6_scan as RS
    counts = dict(build.launch_counts)
    x = torch.zeros(4, 8, requires_grad=True)
    m = torch.ones(8)
    w3 = torch.zeros(3, 3, 2, 2)
    img = torch.zeros(1, 4, 4, 2, requires_grad=True)
    calls = [
        lambda: K.masked_act_2d(x, m),
        lambda: K.masked_act_2d_bwd(x, m, torch.zeros(4, 8)),
        lambda: K.masked_act_2d_batched(x[None], m[None]),
        lambda: K.masked_act_conv3x3(img, torch.ones(4, 4, 2), w3),
        lambda: K.masked_act_conv3x3_batched(img[None],
                                             torch.ones(1, 4, 4, 2), w3),
        lambda: K.masked_act_matmul_2d(x, m, torch.zeros(8, 3)),
        lambda: K.masked_act_matmul_2d_batched(x[None], m[None],
                                               torch.zeros(8, 3)),
        lambda: RS.rwkv6_scan(*(torch.zeros(2, 4, 3, requires_grad=True),)
                              * 4, torch.zeros(2, 3),
                              torch.zeros(2, 3, 3), chunk=4),
        # the ops entries of the same kernels, on the CPU as well
        lambda: ops.masked_act_batched(x[None], m[None]),
        lambda: ops.masked_act_sited_batched(img, torch.ones(2, 4, 4, 2)),
        lambda: ops.masked_act_conv3x3(img, torch.ones(4, 4, 2), w3),
        lambda: ops.masked_act_conv3x3_batched(img, torch.ones(1, 4, 4, 2),
                                               w3),
        lambda: ops.masked_act_matmul(x, m, torch.zeros(8, 3)),
        lambda: ops.masked_act_matmul_batched(x[None], m[None],
                                              torch.zeros(8, 3)),
        lambda: RS.rwkv6_scan_bwd(
            *(torch.zeros(2, 4, 3, requires_grad=True),) * 4,
            torch.zeros(2, 3), torch.zeros(2, 3, 3), torch.zeros(2, 4, 3)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
    # without a gradient being recorded the same CPU calls run
    with torch.no_grad():
        ops.masked_act_batched(x[None], m[None])
        ops.masked_act_conv3x3(img, torch.ones(4, 4, 2), w3)
    # the scan's ops entry has a gradient (kernels.ops.RWKV6ScanFn)
    y, _ = ops.rwkv6(*(torch.ones(2, 4, 3, requires_grad=True),) * 4,
                     torch.zeros(2, 3), torch.zeros(2, 3, 3), chunk=4)
    assert type(y.grad_fn).__name__ == "RWKV6ScanFnBackward"
    with pytest.raises(RuntimeError, match="requires grad"):
        K.refuse_grad("k", None, torch.zeros(1, requires_grad=True))
    K.refuse_grad("k", None, torch.zeros(1))
    assert dict(build.launch_counts) == counts


def test_masked_act_fn_refuses_what_it_has_no_gradient_for():
    from repro_torch.kernels import ops
    xb = torch.zeros(4, 8, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(TypeError, match="float32"):
        ops.masked_act(xb, torch.ones(8))
    mg = torch.ones(8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.masked_act(torch.zeros(4, 8), mg)
    # with nothing requiring grad the gate is the plain forward, no graph
    y = ops.masked_act(torch.zeros(4, 8), torch.ones(8))
    assert y.grad_fn is None


@pytest.mark.parametrize("rows", [1, 3, 32, 4096, 10 ** 6, 10 ** 7])
def test_backward_stripes_depend_on_rows_alone(rows):
    from repro_torch.kernels import masked_act as K
    stripes, per = K.bwd_stripes(rows)
    assert per >= 4 and stripes <= 65535
    assert (stripes - 1) * per < rows <= stripes * per
    if rows == 32:
        assert (stripes, per) == (8, 4)

"""The port's masked-ReLU CNN against the JAX package's, on the CPU.

Parameters come from the reference's ``CNN.init`` and are converted with
``repro_torch.convert`` — never re-initialised — and images and masks are
made with numpy from a seed, so both packages compute the same function of
the same numbers.

Tolerance: 1e-4 absolute on logits (and on prefix activations).  The two
packages sum convolutions and BatchNorm statistics in different orders
(~1e-6 relative per layer), and every BatchNorm's ``rsqrt(var + eps)``
rescales that rounding; through up to 22 layers at these widths the observed
differences stay near 1e-5, so 1e-4 leaves a margin without hiding a wrong
padding, a mixed-up candidate axis or a missing gate (those show at 1e-1).
"""
import numpy as np
import pytest
import torch

from test_torch_helpers import random_masks, reference, to_numpy_tree

TOL = dict(rtol=0.0, atol=1e-4)

PLANS = {
    # name: (stages, stem, wide, image_size)
    "mini": (((8, 2, 1), (16, 2, 2)), 8, False, 8),
    "resnet18": (((8, 2, 1), (16, 2, 2), (32, 2, 2), (64, 2, 2)), 8, False,
                 16),
    "wrn22_8": (((16, 3, 1), (32, 3, 2), (64, 3, 2)), 4, True, 8),
}


def _build(plan, batch=4, seed=0):
    """(reference model, params) and (port model, converted params), plus
    images and two random binary mask trees."""
    from repro_torch import convert
    from repro_torch.models.resnet import CNN, CNNConfig
    ref = reference()
    stages, stem, wide, size = PLANS[plan]
    rcfg = ref.resnet.CNNConfig(plan, 10, size, stages, stem_channels=stem,
                                wide=wide)
    tcfg = CNNConfig(plan, 10, size, stages, stem_channels=stem, wide=wide)
    rmodel, tmodel = ref.resnet.CNN(rcfg), CNN(tcfg)
    rparams = rmodel.init(ref.jax.random.PRNGKey(seed))
    tparams = convert.params_from_reference(to_numpy_tree(rparams), "cpu")
    rng = np.random.default_rng(seed + 1)
    images = rng.normal(size=(batch, size, size, 3)).astype(np.float32)
    trees = [random_masks(tmodel.mask_sites(), seed + 2 + i)
             for i in range(2)]
    return ref, rmodel, rparams, tmodel, tparams, images, trees


def _dev(tree):
    from repro_torch.core import masks as M
    return M.as_device(tree, "cpu")


@pytest.mark.parametrize("plan", list(PLANS))
def test_structure_matches_reference(plan):
    ref, rmodel, rparams, tmodel, tparams, _, _ = _build(plan)
    rs, ts = rmodel.mask_sites(), tmodel.mask_sites()
    assert list(rs) == list(ts)
    for k in rs:
        assert (rs[k].shape, rs[k].kind, rs[k].replacement) == \
            (ts[k].shape, ts[k].kind, ts[k].replacement)
    assert rmodel.relu_count() == tmodel.relu_count()
    assert rmodel.site_order() == tmodel.site_order()
    assert rmodel.site_segments() == tmodel.site_segments()
    assert rmodel._segment_flops() == tmodel._segment_flops()
    assert rmodel.site_prefix_fractions() == tmodel.site_prefix_fractions()
    for s in tmodel.site_order():
        assert rmodel.suffix_sites(s) == tmodel.suffix_sites(s)
    # the port's own init makes the same tree (keys, shapes), on request
    own = tmodel.init(torch.Generator().manual_seed(0), "cpu")

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}
    assert shapes(own) == shapes(tparams)


def test_full_size_configs_match_reference():
    from repro_torch.models.resnet import CNN, CNNConfig
    ref = reference()
    for name in ("resnet18", "wrn22_8"):
        tcfg = getattr(CNNConfig, name)(10, 32)
        rcfg = getattr(ref.resnet.CNNConfig, name)(10, 32)
        assert (tcfg.stages, tcfg.stem_channels, tcfg.wide) == \
            (rcfg.stages, rcfg.stem_channels, rcfg.wide)
    m = CNN(CNNConfig.resnet18(10, 32))
    assert len(m.mask_sites()) == 17 and m.relu_count() == 557056


@pytest.mark.parametrize("plan", list(PLANS))
def test_forward_logits_match_reference(plan):
    ref, rmodel, rparams, tmodel, tparams, images, trees = _build(plan)
    x = torch.from_numpy(images)
    for tree in trees:
        want = np.asarray(rmodel.forward(rparams, ref.masks.as_device(tree),
                                         ref.jnp.asarray(images)))
        got = tmodel.forward(tparams, _dev(tree), x)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        # ties=False only skips the (inert, for binary masks) tie override
        np.testing.assert_array_equal(
            tmodel.forward(tparams, _dev(tree), x, ties=False).numpy(),
            got.numpy())
        # resuming from the cached stem fold
        rpre = rmodel.forward_pre(rparams, ref.jnp.asarray(images))
        tpre = tmodel.forward_pre(tparams, x)
        np.testing.assert_allclose(tpre.numpy(), np.asarray(rpre), **TOL)
        want_pre = np.asarray(rmodel.forward(
            rparams, ref.masks.as_device(tree), None, pre=rpre))
        got_pre = tmodel.forward(tparams, _dev(tree), None, pre=tpre)
        np.testing.assert_allclose(got_pre.numpy(), want_pre, **TOL)
        np.testing.assert_array_equal(got_pre.numpy(), got.numpy())


@pytest.mark.parametrize("plan", list(PLANS))
def test_fused_forward_matches_reference_fused_route(plan):
    """fused=True against the reference's forward traced under
    ``fused_suffix_route(interpret=True)`` (its Pallas gate→conv kernels in
    interpret mode), and against the port's own unfused forward."""
    ref, rmodel, rparams, tmodel, tparams, images, trees = _build(plan)
    x = torch.from_numpy(images)
    tree = trees[0]
    with ref.linearize.fused_suffix_route(interpret=True):
        want = np.asarray(rmodel.forward(
            rparams, ref.masks.as_device(tree), ref.jnp.asarray(images)))
    got = tmodel.forward(tparams, _dev(tree), x, fused=True, ties=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = tmodel.forward(tparams, _dev(tree), x)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("fused", [False, True])
def test_stacked_forward_matches_vmapped_reference(plan, fused):
    """Stacked masks (the explicit candidate axis) against ``jax.vmap`` of
    the reference's forward, from images and from the shared stem fold."""
    from repro_torch.core import masks as M
    ref, rmodel, rparams, tmodel, tparams, images, trees = _build(plan)
    x = torch.from_numpy(images)
    trees = trees + [trees[0]]
    stacked = M.stack_trees(trees)
    ximg = ref.jnp.asarray(images)
    want = np.asarray(ref.jax.vmap(
        lambda m: rmodel.forward(rparams, m, ximg))(
            ref.masks.as_device(stacked)))
    got = tmodel.forward(tparams, _dev(stacked), x, fused=fused,
                         ties=not fused)
    assert got.shape == (3,) + want.shape[1:]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    pre = tmodel.forward_pre(tparams, x)
    got_pre = tmodel.forward(tparams, _dev(stacked), None, pre=pre,
                             fused=fused, ties=not fused)
    np.testing.assert_allclose(got_pre.numpy(), want, **TOL)
    # per candidate BatchNorm: candidate i of the stack equals the
    # un-stacked forward of tree i (mixing candidates would break this)
    for i, tree in enumerate(trees):
        one = tmodel.forward(tparams, _dev(tree), x, fused=fused,
                             ties=not fused)
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("plan", list(PLANS))
def test_prefix_suffix_and_extension_at_every_site(plan):
    """prefix ∘ suffix == forward, and prefix_ext(a → b) == prefix(b), at
    every site; prefixes are held against the reference's."""
    from repro_torch.core import masks as M
    ref, rmodel, rparams, tmodel, tparams, images, trees = _build(plan)
    x = torch.from_numpy(images)
    tree = trees[0]
    md, rmd = _dev(tree), ref.masks.as_device(tree)
    full = tmodel.forward(tparams, md, x)
    order = tmodel.site_order()
    stacked = _dev(M.stack_trees(trees))
    full_st = tmodel.forward(tparams, stacked, x)
    prev_site, prev_cached = None, None
    for site in order:
        cached = tmodel.forward_prefix(tparams, md, x, site)
        want = rmodel.forward_prefix(rparams, rmd, ref.jnp.asarray(images),
                                     site)
        np.testing.assert_allclose(cached.numpy(), np.asarray(want), **TOL)
        out = tmodel.forward_suffix(tparams, md, cached, site)
        np.testing.assert_array_equal(out.numpy(), full.numpy())
        if prev_site is not None:
            ext = tmodel.forward_prefix(tparams, md, x, site,
                                        from_site=prev_site,
                                        cached=prev_cached)
            np.testing.assert_array_equal(ext.numpy(), cached.numpy())
        prev_site, prev_cached = site, cached
        # stacked suffix over the shared cached prefix: only candidates whose
        # masks agree with the base above the cut are valid, so splice
        sub = {k: (stacked[k] if k in tmodel.suffix_sites(site)
                   else md[k]) for k in md}
        sub_full = {k: (v if v.dim() == 4 else
                        v.unsqueeze(0).expand((2,) + tuple(v.shape)))
                    for k, v in sub.items()}
        want_st = tmodel.forward(tparams, sub_full, x)
        got_st = tmodel.forward_suffix(
            tparams, {k: stacked[k] for k in tmodel.suffix_sites(site)},
            cached, site)
        np.testing.assert_allclose(got_st.numpy(), want_st.numpy(), rtol=0,
                                   atol=1e-5)
    assert full_st.shape == (2,) + tuple(full.shape)


def test_eval_closures_match_reference_accuracy():
    """make_eval_acc / make_param_eval_fn / make_joint_eval_fn /
    make_suffix_eval_fns: accuracies equal the reference's on a batch where
    the top-2 logit margin exceeds the tolerance (asserted)."""
    from repro_torch import convert
    from repro_torch.core import masks as M
    from repro_torch.data import ImageDatasetCfg, SyntheticImages
    ref, rmodel, rparams, tmodel, tparams, _, trees = _build("mini")
    cfg = dict(n_classes=10, image_size=8, n_train=64, n_test=16)
    batch = SyntheticImages(ImageDatasetCfg(**cfg)).train_eval_set(32)
    rbatch = ref.data.SyntheticImages(
        ref.data.ImageDatasetCfg(**cfg)).train_eval_set(32)
    np.testing.assert_array_equal(batch["images"], rbatch["images"])
    np.testing.assert_array_equal(batch["labels"], rbatch["labels"])
    racc = rmodel.make_eval_acc(rparams, rbatch)
    tacc = tmodel.make_eval_acc(tparams, batch, "cpu")
    fn = tmodel.make_param_eval_fn(batch, "cpu")
    joint = tmodel.make_joint_eval_fn()
    split = tmodel.make_suffix_eval_fns()
    ctx = {"params": tparams, "batch": convert.to_device(batch, "cpu")}
    for tree in trees:
        logits = tmodel.forward(tparams, _dev(tree),
                                torch.from_numpy(batch["images"]))
        top2 = logits.topk(2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-4
        want = racc(tree)
        assert tacc(tree) == want
        assert float(fn(_dev(tree), tparams)) == want
        assert float(joint(_dev(tree), ctx)) == want
        site = tmodel.site_order()[3]
        cached = split.prefix(site, _dev(tree), ctx)
        assert float(split.suffix(site, _dev(tree), cached, ctx)) == want
        ctx_pre = {**ctx, "pre": split.pre(ctx)}
        assert float(split.full(_dev(tree), ctx_pre)) == want
    st = _dev(M.stack_trees(trees))
    accs = fn(st, tparams)
    assert accs.shape == (2,)
    assert [float(a) for a in accs] == [racc(t) for t in trees]

"""SNL, AutoReP, the shared finetune and the pipeline example of the port,
against the JAX package on the CPU.

The mini CNN ``CNNConfig("r18-mini", 4, 8, ((8, 2, 1), (16, 2, 2)),
stem_channels=8)`` (3584 ReLUs) with the reference's ``CNN.init``
converted; batches from ``data.SyntheticImages`` (the same numpy arrays go
to both packages).

What must be equal: SNL's per-epoch budgets, λs and binarised snapshots,
and its final hard masks, exactly; AutoReP's per-epoch budgets exactly.
Parameters after training: within 2e-3 of each leaf's largest |value|
(see ``test_torch_train.py``: a ReLU whose pre-activation is within
rounding of 0 may switch sides between the packages); a finetune that
meets no such ReLU stays within 1e-5.

AutoReP's free run diverges from the reference (``ROADMAP.md`` Queue C),
and :func:`test_autorep_first_divergence_is_the_indicator_rounding`
shows where: its straight-through indicator is ``(m + α) − α``, which
rounds to m itself — on a bound of the soft gate's clip, derivative 1/2 —
or to a neighbour of m inside the clip — derivative 1 — by the last bit of
α.  The packages' α differ in that bit after a step (their convolutions
sum in other orders), so from the third step on a few α get twice or half
the reference's gradient.  Re-synchronised every step, the port's step
agrees with the reference's to 1e-5.
"""
import importlib.util
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_torch_helpers import reference, to_numpy_tree

STAGES = ((8, 2, 1), (16, 2, 2))
TOTAL = 3584
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "torch_resnet18_bcd_pipeline.py")


@pytest.fixture(scope="module")
def mini():
    from repro_torch import convert
    from repro_torch.data import ImageDatasetCfg, SyntheticImages
    from repro_torch.models.resnet import CNN, CNNConfig
    from repro_torch.training import train as ttrain
    ref = reference()
    import repro.training.train as rtrain
    jnp = ref.jnp
    rmodel = ref.resnet.CNN(ref.resnet.CNNConfig("r18-mini", 4, 8, STAGES,
                                                 stem_channels=8))
    tmodel = CNN(CNNConfig("r18-mini", 4, 8, STAGES, stem_channels=8))
    rparams = rmodel.init(ref.jax.random.PRNGKey(0))
    data = SyntheticImages(ImageDatasetCfg(n_classes=4, image_size=8,
                                           n_train=256, n_test=64))
    bn = data.batches("train", 32)

    def rloss(p, a, batch, soft):
        logits = rmodel.forward(p, a, batch["images"], soft=soft)
        return rtrain.cross_entropy(logits, batch["labels"]), 0.0

    def tloss(p, a, batch, soft):
        logits = tmodel.forward(p, a, batch["images"], soft=soft)
        return ttrain.cross_entropy(logits, batch["labels"]), 0.0

    def rloss3(p, m, q, batch, soft):
        logits = rmodel.forward(p, m, batch["images"], poly=q, soft=soft)
        return rtrain.cross_entropy(logits, batch["labels"]), 0.0

    def tloss3(p, m, q, batch, soft):
        logits = tmodel.forward(p, m, batch["images"], poly=q, soft=soft)
        return ttrain.cross_entropy(logits, batch["labels"]), 0.0

    return dict(
        ref=ref, rmodel=rmodel, tmodel=tmodel, rparams=rparams,
        tparams=convert.params_from_reference(to_numpy_tree(rparams),
                                              "cpu"),
        sites=tmodel.mask_sites(), bn=bn,
        rb=lambda i: {k: jnp.asarray(v) for k, v in bn(i).items()},
        rloss=rloss, tloss=tloss, rloss3=rloss3, tloss3=tloss3)


def _leaf_rel(got_tree, want_tree, ref):
    from repro_torch.training.optimizer import tree_leaves
    got = tree_leaves(got_tree)
    want = ref.jax.tree.leaves(to_numpy_tree(want_tree))
    assert len(got) == len(want)
    return max(float(np.abs(g.numpy() - w).max() /
                     max(np.abs(w).max(), 1e-30)) for g, w in zip(got, want))


def _same_masks(a, b):
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


# -------------------------------------------------------------------- SNL

SNL_CASES = {
    # the example's SNL schedule: λ grows by κ each stalled epoch, the
    # weights stay near 1, the final threshold ranks distinct values
    "example": dict(b_target=int(TOTAL * 0.6), lam0=5e-4, kappa=1.5,
                    epochs=6, steps_per_epoch=5, lr=3e-2, finetune_steps=15),
    # a strong lasso: the budget falls to 0 in the fourth epoch and the
    # loop stops early; the threshold then ranks weights tied at 0
    "strong": dict(b_target=int(TOTAL * 0.5), lam0=0.2, kappa=1.5,
                   epochs=8, steps_per_epoch=5, lr=5e-2, finetune_steps=5),
}


@pytest.mark.parametrize("case", list(SNL_CASES))
def test_run_snl_matches_reference(mini, case):
    from repro_torch.core import masks as M, snl
    ref = mini["ref"]
    import repro.core.snl as rsnl
    cfg = SNL_CASES[case]
    sites = mini["sites"]
    want = rsnl.run_snl(mini["rparams"],
                        {k: ref.jnp.ones(s.shape) for k, s in sites.items()},
                        mini["rloss"], mini["rb"], rsnl.SNLConfig(**cfg))
    got = snl.run_snl(mini["tparams"],
                      {k: np.ones(s.shape, np.float32)
                       for k, s in sites.items()},
                      mini["tloss"], mini["bn"], snl.SNLConfig(**cfg),
                      device="cpu")
    assert got.budget_per_epoch == want.budget_per_epoch
    assert got.lam_per_epoch == want.lam_per_epoch
    assert len(got.snapshots) == len(want.snapshots)
    for a, b in zip(got.snapshots, want.snapshots):
        assert _same_masks(a, b)
    assert _same_masks(got.masks, want.masks)
    assert M.count(got.masks) == cfg["b_target"]
    for k in want.alphas:
        np.testing.assert_allclose(got.alphas[k], want.alphas[k], rtol=0,
                                   atol=1e-6)
    assert _leaf_rel(got.params, want.params, ref) <= 2e-3
    init = got.stage_init()
    assert init["kind"] == "snl" and init["masks"] is got.masks
    assert set(init["aux"]["alphas"]) == set(sites)
    if case == "example":
        assert got.lam_per_epoch[-1] > got.lam_per_epoch[0]
    else:
        assert got.budget_per_epoch[-1] == 0 < got.budget_per_epoch[0]
        assert len(got.budget_per_epoch) < cfg["epochs"]


@pytest.mark.parametrize("use_adam", [False, True])
def test_finetune_matches_reference(mini, use_adam):
    from repro_torch.core import masks as M, snl
    from repro_torch.training.optimizer import tree_leaves
    ref = mini["ref"]
    import repro.core.snl as rsnl
    rng = np.random.default_rng(0)
    soft = {k: rng.random(s.shape).astype(np.float32)
            for k, s in mini["sites"].items()}
    hard = M.threshold(soft, TOTAL // 3)
    lr = 1e-3 if use_adam else 3e-2
    want = rsnl.finetune(mini["rparams"], hard, mini["rloss"], mini["rb"],
                         steps=10, lr=lr, use_adam=use_adam)
    before = [t.clone() for t in tree_leaves(mini["tparams"])]
    got = snl.finetune(mini["tparams"], hard, mini["tloss"], mini["bn"],
                       steps=10, lr=lr, use_adam=use_adam, device="cpu")
    assert _leaf_rel(got, want, ref) <= 1e-5
    moved = max(float((a - b).abs().max())
                for a, b in zip(tree_leaves(got), before))
    assert moved > 1e-4
    # deterministic, and the input tree is left as it was
    again = snl.finetune(mini["tparams"], hard, mini["tloss"], mini["bn"],
                         steps=10, lr=lr, use_adam=use_adam, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                  tree_leaves(again)))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(
        mini["tparams"]), before))


# ---------------------------------------------------------------- AutoReP

AUTOREP_CFG = dict(b_target=TOTAL // 2, epochs=4, steps_per_epoch=5,
                   lr=5e-2, finetune_steps=8)


def _poly_sites(mini):
    ref = mini["ref"]
    from repro_torch.core import linearize
    rsites = {k: ref.linearize.MaskSite(s.shape, "relu", "poly2")
              for k, s in mini["sites"].items()}
    tsites = {k: linearize.MaskSite(s.shape, "relu", "poly2")
              for k, s in mini["sites"].items()}
    return rsites, tsites


def test_run_autorep_budgets_match_and_masks_differ_only_by_the_divergence(
        mini):
    from repro_torch.core import autorep, linearize
    ref = mini["ref"]
    import repro.core.autorep as rauto
    rsites, tsites = _poly_sites(mini)
    rpoly = ref.linearize.init_poly(rsites)
    tpoly = linearize.init_poly(tsites, device="cpu")
    for k in rpoly:
        np.testing.assert_array_equal(tpoly[k].numpy(), np.asarray(rpoly[k]))
    sites = mini["sites"]
    want = rauto.run_autorep(
        mini["rparams"], {k: ref.jnp.full(s.shape, 0.5)
                          for k, s in sites.items()},
        rpoly, mini["rloss3"], mini["rb"],
        rauto.AutoRepConfig(**AUTOREP_CFG))
    got = autorep.run_autorep(
        mini["tparams"], {k: np.full(s.shape, 0.5, np.float32)
                          for k, s in sites.items()},
        tpoly, mini["tloss3"], mini["bn"],
        autorep.AutoRepConfig(**AUTOREP_CFG), device="cpu")
    assert got.budget_per_epoch == want.budget_per_epoch
    assert sum(int(v.sum()) for v in got.masks.values()) == \
        AUTOREP_CFG["b_target"]
    # the hard masks are the top b_target of α; the packages' α differ by
    # at most delta (the divergence), so they may rank differently only
    # where the reference's α lies within 2·delta of its cut
    delta = max(float(np.abs(got.alphas[k] - want.alphas[k]).max())
                for k in want.alphas)
    assert delta <= 5e-3                       # measured: 9.4e-4
    flat = np.concatenate([want.alphas[k].ravel() for k in want.alphas])
    cut = np.sort(flat)[-AUTOREP_CFG["b_target"]]
    for k in want.masks:
        differ = got.masks[k] != want.masks[k]
        assert np.all(np.abs(want.alphas[k][differ] - cut) <= 2 * delta), k
    # the parameters are held to the reference step by step in the next
    # test: after the divergence the free runs' differ by more than
    # rounding (6.5e-3 of a leaf's largest value here)
    from repro_torch.training.optimizer import tree_leaves
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(
        (got.params, got.poly)))
    assert set(got.stage_init()["aux"]["poly"]) == set(rpoly)


def test_autorep_first_divergence_is_the_indicator_rounding(mini):
    """Re-synchronised to the reference's state before every step, the
    port's soft AutoReP step (``autorep.soft_step``) gives the reference's
    next state within 1e-5 and the same hard indicator; the indicator's
    forward values and the clip's derivative through it are bit-identical
    for the same α; and in the free run a 1-ulp change of α is enough to
    halve or double a clip derivative."""
    from repro_torch import convert
    from repro_torch.core import autorep
    from repro_torch.kernels import ref as tref
    from repro_torch.training import optimizer as topt
    ref = mini["ref"]
    jax, jnp = ref.jax, ref.jnp
    import repro.core.autorep as rauto
    import repro.training.optimizer as ropt
    rsites, _ = _poly_sites(mini)
    cfg = AUTOREP_CFG
    h = 0.05
    total = TOTAL
    ropt_ = ropt.sgd(lr=cfg["lr"], momentum=0.9, schedule=ropt.cosine(
        cfg["lr"], cfg["epochs"] * cfg["steps_per_epoch"]))

    def r_loss(tr, m_prev, batch):            # the reference's train_loss
        p, a, q = tr
        m = {k: rauto._ste_indicator(a[k], m_prev[k], h) for k in a}
        loss, _ = mini["rloss3"](p, m, q, batch, True)
        frac = sum(jnp.sum(v) for v in m.values()) / total
        return loss + 1.0 * jnp.abs(frac - cfg["b_target"] / total), m

    _, tstep = autorep.soft_step(mini["tloss3"],
                                 autorep.AutoRepConfig(**cfg), total)
    rt = (mini["rparams"], {k: jnp.full(s.shape, 0.5)
                            for k, s in mini["sites"].items()},
          ref.linearize.init_poly(rsites))
    rmp = {k: jnp.ones(s.shape) for k, s in mini["sites"].items()}
    rs = ropt_.init(rt)
    for i in range(8):
        t_state = topt.OptState(int(rs.step), convert.to_device(
            to_numpy_tree(rs.mu), "cpu"), None)
        t_tr = convert.to_device(to_numpy_tree(rt), "cpu")
        t_tr, t_mp, t_state = tstep(t_tr, convert.to_device(
            to_numpy_tree(rmp), "cpu"), t_state,
            convert.to_device(mini["bn"](i), "cpu"))
        (_, rm), rg = jax.value_and_grad(r_loss, has_aux=True)(
            rt, rmp, mini["rb"](i))
        ru, rs = ropt_.update(rg, rs, rt)
        rt = ropt.apply_updates(rt, ru)
        rmp = {k: (v > 0.5).astype(jnp.float32) for k, v in rm.items()}
        assert _leaf_rel(t_tr, rt, ref) <= 1e-5, i
        for k in rmp:
            np.testing.assert_array_equal(t_mp[k].numpy(),
                                          np.asarray(rmp[k]))
    # the indicator and the clip's derivative through it, bit for bit
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, 20000).astype(np.float32)
    mp = (rng.random(20000) < 0.5).astype(np.float32)

    def rclip(aa):
        return jnp.sum(jnp.clip(rauto._ste_indicator(aa, jnp.asarray(mp),
                                                     h), 0.0, 1.0))
    want = np.asarray(jax.grad(rclip)(jnp.asarray(a)))
    at = torch.from_numpy(a.copy()).requires_grad_()
    m_t = autorep._ste_indicator(at, torch.from_numpy(mp), h)
    np.testing.assert_array_equal(m_t.detach().numpy(), np.asarray(
        rauto._ste_indicator(jnp.asarray(a), jnp.asarray(mp), h)))
    tref.tie_clamp(m_t, 0.0, 1.0).sum().backward()
    np.testing.assert_array_equal(at.grad.numpy(), want)
    # one ulp of α moves the derivative between 1/2 and 1 somewhere
    a2 = np.nextafter(a, np.float32(2.0))
    want2 = np.asarray(jax.grad(rclip)(jnp.asarray(a2)))
    flipped = want2 != want
    assert flipped.any()
    assert set(np.unique(np.abs(want2[flipped] / want[flipped]))) <= \
        {0.5, 2.0}


def test_hysteresis_indicator_matches_reference():
    from repro_torch.core import autorep
    ref = reference()
    import repro.core.autorep as rauto
    a = np.array([0.2, -0.2, 0.01, -0.01, 0.05, -0.05], np.float32)
    m_prev = np.array([1.0, 1.0, 0.0, 1.0, 0.0, 1.0], np.float32)
    want = np.asarray(rauto._ste_indicator(ref.jnp.asarray(a),
                                           ref.jnp.asarray(m_prev), 0.05))
    got = autorep._ste_indicator(torch.from_numpy(a),
                                 torch.from_numpy(m_prev), 0.05)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:4], [1.0, 0.0, 0.0, 1.0])


# ---------------------------------------------------------------- example


def _load_example():
    spec = importlib.util.spec_from_file_location("torch_pipeline_example",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_head_to_head_on_cpu_ends_budget_exact(capsys):
    ex = _load_example()
    assert ex.main(["--device", "cpu", "--image-size", "8"]) == 0
    out = capsys.readouterr().out
    assert "budget exact: True" in out
    assert "== train_base: 80 steps" in out and "[bcd] t=0" in out


def test_example_refuses_what_is_not_ported(capsys):
    """The sweep mode is ported (``tests/test_torch_sweep.py``), and so is
    the ``sharded`` engine (``tests/test_torch_sharded.py``); what is still
    JAX-only — ``--compile-cache`` — sweep flags without ``--sweep``, and
    ``--drc``, which the reference's example does not have either, are
    refused by the parser (status 2)."""
    ex = _load_example()
    assert ex.parse_args(["--engine", "sharded"]).engine == "sharded"
    for argv in (["--compile-cache", "x"],
                 ["--overlap"], ["--drc", "4"], ["--sweep", "0.5"],
                 ["--prefetch", "auto"]):
        with pytest.raises(SystemExit) as e:
            ex.parse_args(["--device", "cpu"] + argv)
        assert e.value.code == 2, argv
    capsys.readouterr()
    args = ex.parse_args([])
    assert args.device == "cuda" and args.engine == "batched"
    assert args.sweep is None and args.prefetch == 2
    args = ex.parse_args(["--sweep", "0.5,0.4", "--out-dir", "x",
                          "--engine", "suffix", "--prefetch", "auto"])
    assert args.sweep == [0.5, 0.4] and args.prefetch == "auto"


def test_example_imports_neither_jax_nor_reference_package():
    code = textwrap.dedent(f"""
        import importlib.util, sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        spec = importlib.util.spec_from_file_location("ex", {EXAMPLE!r})
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        import repro_torch.core.snl, repro_torch.core.autorep
        import repro_torch.training.train, repro_torch.training.optimizer
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro")
               and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(ROOT, "src")),
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert "ok" in out.stdout


def test_training_entry_points_default_to_the_card():
    import inspect
    from repro_torch.core import autorep, snl
    for fn in (snl.run_snl, snl.finetune, autorep.run_autorep):
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn

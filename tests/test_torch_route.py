"""One gate route per run, on the CPU.

Every eval closure of both models takes ``fused=`` and every engine passes
its run's ``fused_kernels`` to every call it makes: the batched and
pipelined forwards, the suffix engine's prefixes, suffixes and full-forward
fallbacks, and the sequential engine through ``make_eval_acc(fused=)``.  A
chunk that carries share ties runs unfused in every engine.

On the CPU the fused entries of ``kernels.ops`` are the unfused pair, equal
to the bit, so a run that mixed the routes would read no differently.  The
engine tests therefore mark the fused route: its plain versions are patched
to scale their output by a fixed pattern, a different function whose
accuracies part from the unfused route's.  Under the mark, engines that run
one route read every trial alike; an engine that mixed them would not.

The forward tests are the port's counterparts of the reference's
``test_cnn_forward_fused_route_bitwise`` and
``test_lm_forward_fused_route_bitwise`` (``tests/test_fused_kernels.py``):
the port's fused forward equal to its plain one to the bit, and to the
reference's forward under ``linearize.fused_suffix_route(interpret=True)``
(its Pallas kernels in interpret mode) within 1e-4.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from test_torch_helpers import reference, to_numpy_tree

STAGES = ((8, 2, 1), (16, 2, 2))
SIZE, BATCH, CLASSES = 8, 64, 4
TOL = dict(rtol=0.0, atol=1e-4)
ENGINES = ("sequential", "batched", "pipelined", "suffix")
_CACHE = {}


def _cnn():
    if "cnn" not in _CACHE:
        from repro_torch import convert
        from repro_torch.data import ImageDatasetCfg, SyntheticImages
        from repro_torch.models.resnet import CNN, CNNConfig
        ref = reference()
        rmodel = ref.resnet.CNN(ref.resnet.CNNConfig(
            "mini", CLASSES, SIZE, STAGES, stem_channels=8))
        rparams = rmodel.init(ref.jax.random.PRNGKey(0))
        tmodel = CNN(CNNConfig("mini", CLASSES, SIZE, STAGES,
                               stem_channels=8))
        tparams = convert.params_from_reference(to_numpy_tree(rparams),
                                                "cpu")
        batch = SyntheticImages(ImageDatasetCfg(
            n_classes=CLASSES, image_size=SIZE, n_train=256, n_test=64)
        ).train_eval_set(BATCH)
        _CACHE["cnn"] = rmodel, rparams, tmodel, tparams, batch
    return _CACHE["cnn"]


def _trained_cnn():
    """The mini CNN after 8 SGD steps on the synthetic images: at its init
    it reads one class for every image, and after 12 steps every image
    right, so every trial ties either way."""
    if "trained" not in _CACHE:
        from repro_torch.convert import to_device
        from repro_torch.core import linearize, masks as M
        from repro_torch.data import ImageDatasetCfg, SyntheticImages
        from repro_torch.training import optimizer as opt_lib, \
            train as train_lib
        _, _, tmodel, params, batch = _cnn()
        data = SyntheticImages(ImageDatasetCfg(
            n_classes=CLASSES, image_size=SIZE, n_train=256, n_test=64))
        opt = opt_lib.sgd(lr=5e-2, momentum=0.9)
        step, _ = train_lib.make_cnn_train_step(tmodel, opt)
        ostate = opt.init(params)
        mdev = M.as_device(linearize.init_masks(tmodel.mask_sites()), "cpu")
        batches = data.batches("train", 32)
        for i in range(8):
            params, ostate, _, _ = step(params, ostate, mdev,
                                        to_device(batches(i), "cpu"))
        _CACHE["trained"] = tmodel, params, batch
    return _CACHE["trained"]


def _tiny_lm_cfg(blocks):
    return dict(name="tiny-fused", family="dense", n_layers=6, d_model=32,
                n_heads=2, n_kv_heads=2, d_ff=48, vocab=64, head_dim=16,
                pattern=(blocks.Block("dense"), blocks.Block("dense")),
                head_blocks=(blocks.Block("dense"),), dtype="float32")


def _lm():
    """The reference's ``_tiny_lm`` of ``tests/test_fused_kernels.py``."""
    if "lm" not in _CACHE:
        from repro_torch import convert
        from repro_torch.configs import base
        from repro_torch.models.lm import LM
        ref = reference()
        import repro.configs.base as rbase
        rmodel = ref.lm.LM(rbase.ArchConfig(**_tiny_lm_cfg(rbase)))
        rparams = rmodel.init(ref.jax.random.PRNGKey(0))
        tmodel = LM(base.ArchConfig(**_tiny_lm_cfg(base)))
        tparams = convert.params_from_reference(to_numpy_tree(rparams),
                                                "cpu")
        rng = np.random.default_rng(3)
        batch = {"tokens": rng.integers(0, 64, (4, 17)).astype(np.int32)}
        _CACHE["lm"] = rmodel, rparams, tmodel, tparams, batch
    return _CACHE["lm"]


def _masked(model, n_zero, seed=0):
    from repro_torch.core import linearize, masks as M
    masks = linearize.init_masks(model.mask_sites())
    return M.sample_removal_block(np.random.default_rng(seed), masks, n_zero)


# ----------------------------------------------------------- the closures


@pytest.mark.parametrize("family", ["cnn", "lm"])
def test_every_closure_takes_fused(family):
    _, _, tmodel, tparams, batch = _cnn() if family == "cnn" else _lm()
    split = tmodel.make_suffix_eval_fns()
    closures = {
        "make_param_eval_fn": tmodel.make_param_eval_fn(batch, "cpu"),
        "make_eval_fn": tmodel.make_eval_fn(tparams, batch, "cpu"),
        "make_joint_eval_fn": tmodel.make_joint_eval_fn(),
        "SplitEval.prefix": split.prefix,
        "SplitEval.prefix_ext": split.prefix_ext,
        "SplitEval.suffix": split.suffix,
        "SplitEval.full": split.full,
        "SplitEval.pre": split.pre,
    }
    for name, fn in closures.items():
        assert "fused" in inspect.signature(fn).parameters, name
    assert "fused" in inspect.signature(tmodel.make_eval_acc).parameters


# ----------------------------------------------------------- the forwards


def test_cnn_forward_fused_route_bitwise():
    from repro_torch.core import masks as M
    rmodel, rparams, tmodel, tparams, _ = _cnn()
    ref = reference()
    masks = _masked(tmodel, 64)
    x = np.random.default_rng(1).normal(size=(2, SIZE, SIZE, 3)) \
        .astype(np.float32)
    xt = torch.from_numpy(x)
    md = M.as_device(masks, "cpu")
    plain = tmodel.forward(tparams, md, xt, ties=False)
    fused = tmodel.forward(tparams, md, xt, ties=False, fused=True)
    assert torch.equal(fused, plain)
    rmd = ref.masks.as_device(masks)
    with ref.linearize.fused_suffix_route(interpret=True):
        want = np.asarray(ref.jax.jit(rmodel.forward)(rparams, rmd, x))
    np.testing.assert_allclose(fused.numpy(), want, **TOL)


def test_lm_forward_fused_route_bitwise():
    from repro_torch.core import masks as M
    rmodel, rparams, tmodel, tparams, _ = _lm()
    ref = reference()
    masks = _masked(tmodel, 16)
    tokens = np.asarray(np.random.default_rng(0).integers(
        0, tmodel.cfg.vocab, (2, 9)), np.int32)
    tt = torch.from_numpy(tokens).long()
    md = M.as_device(masks, "cpu")
    plain = tmodel.forward(tparams, md, tt, ties=False)
    fused = tmodel.forward(tparams, md, tt, ties=False, fused=True)
    assert torch.equal(fused, plain)
    rmd = ref.masks.as_device(masks)
    with ref.linearize.fused_suffix_route(interpret=True):
        want = np.asarray(ref.jax.jit(
            lambda p, m, t: rmodel.forward(p, m, t)[0])(rparams, rmd,
                                                         tokens))
    np.testing.assert_allclose(fused.numpy(), want, **TOL)


# ------------------------------------------------------------- the engines


@pytest.fixture
def marked_route(monkeypatch):
    """Scale the fused route's plain versions by a fixed pattern over
    their output's trailing axes, and count their calls."""
    from repro_torch.kernels import ref as R
    calls = {"fused": 0}

    def mark(fn, trailing):
        def marked(*args, **kw):
            calls["fused"] += 1
            out = fn(*args, **kw)
            shape = out.shape[-trailing:]
            n = int(np.prod(shape))
            pattern = torch.cos(torch.arange(n, dtype=out.dtype) * 0.7)
            return out * (1.0 + 0.5 * pattern.reshape(shape))
        return marked
    # the stacked product's plain version calls the un-stacked one
    for name, trailing in (("masked_act_conv3x3_ref", 3),
                           ("masked_act_matmul_ref", 1)):
        monkeypatch.setattr(R, name, mark(getattr(R, name), trailing))
    return calls


def _recorded_run(backend, model, params, batch, masks0, cfg, fused,
                  chunk):
    """``run_bcd`` through one engine, every trial's reading kept."""
    from repro_torch.core import bcd as B
    from repro_torch.launch.sweep import make_bcd_evaluator
    ev, eval_acc, _ = make_bcd_evaluator(
        backend, model, batch, {"params": params}, chunk_size=chunk,
        rt=cfg.rt, prefetch=2, fused_kernels=fused, device="cpu")
    trials = []
    if backend == "sequential":
        inner_acc = ev._eval_acc

        def acc(m):
            trials.append(inner_acc(m))
            return trials[-1]
        ev._eval_acc = acc
    else:
        inner = ev.evaluate_staged

        def staged(st):
            out = inner(st)
            trials.extend(out.tolist())
            return out
        ev.evaluate_staged = staged
    res = B.run_bcd(masks0, cfg, eval_acc, evaluator=ev)
    # the suffix engine evaluates site-major: compare each step's readings
    # as a sorted list (adt below every drop: all rt trials evaluated)
    steps = [sorted(trials[i:i + cfg.rt])
             for i in range(0, len(trials), cfg.rt)]
    return res, steps, ev


def _engines_agree(model, params, batch, masks0, cfg, fused, calls,
                   chunk=3, backends=ENGINES):
    from repro_torch.core import masks as M
    runs = {}
    for backend in backends:
        before = calls["fused"]
        res, steps, ev = _recorded_run(backend, model, params, batch, masks0,
                                       cfg, fused, chunk)
        ran = calls["fused"] - before
        assert (ran > 0) == fused, (backend, fused, ran)
        runs[backend] = (M.fingerprint(res.masks), steps,
                         [(h.trials, h.best_drop, h.acc_before)
                          for h in res.history], ev)
    first = runs[backends[0]]
    for backend, run in runs.items():
        assert run[0] == first[0], backend
        assert run[1] == first[1], backend
        assert run[2] == first[2], backend
    return runs


@pytest.mark.parametrize("family", ["cnn", "lm"])
def test_four_engines_read_every_trial_alike_under_each_route(
        family, marked_route):
    from repro_torch.core import bcd as B, linearize, masks as M
    if family == "cnn":
        tmodel, tparams, batch = _trained_cnn()
    else:
        _, _, tmodel, tparams, batch = _lm()
    masks0 = linearize.init_masks(tmodel.mask_sites())
    drc = 16 if family == "cnn" else 8
    cfg = B.BCDConfig(b_target=M.count(masks0) - 2 * drc, drc=drc, rt=8,
                      adt=-100.0, finetune_every_step=False, seed=3,
                      chunk_size=3)
    readings = {}
    for fused in (False, True):
        runs = _engines_agree(tmodel, tparams, batch, masks0, cfg, fused,
                              marked_route)
        readings[fused] = runs["batched"][1]
    # the mark shows: the two routes read some trial apart
    assert readings[True] != readings[False]


def test_late_sweep_ties_and_fallbacks_read_alike(marked_route):
    """ROADMAP Queue C 3: late in a sweep, remove candidates from a sparse
    mask tree read many accuracies alike, and the suffix engine sends the
    shallow ones down its full-forward fallback and the deep ones down the
    sited path, both on the marked fused route.  Every engine reads every
    trial alike and breaks the ties to the same blocks."""
    from repro_torch.core import bcd as B, engine as E, linearize, \
        masks as M
    tmodel, tparams, batch = _trained_cnn()
    dense = linearize.init_masks(tmodel.mask_sites())
    late = M.remove_random(np.random.default_rng(5), dense,
                           int(0.8 * M.count(dense)))
    cfg = B.BCDConfig(b_target=M.count(late) - 3 * 2, drc=2, rt=16,
                      adt=-100.0, finetune_every_step=False, seed=11,
                      chunk_size=3)
    stats = {"sited": 0, "fallback": 0}
    stage = E.SuffixEvaluator.stage

    def counting(self, item):
        if isinstance(item, E.SitedChunk):
            stats["fallback" if item.site is None else "sited"] += 1
        return stage(self, item)
    E.SuffixEvaluator.stage = counting
    try:
        runs = _engines_agree(tmodel, tparams, batch, late, cfg, True,
                              marked_route)
    finally:
        E.SuffixEvaluator.stage = stage
    assert stats["sited"] > 0 and stats["fallback"] > 0, stats
    steps = runs["batched"][1]
    assert any(len(set(step)) < len(step) for step in steps), steps

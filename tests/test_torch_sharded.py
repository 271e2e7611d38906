"""Candidate-parallel BCD over a device mesh, on the CPU with ``gloo``.

Counterparts of the reference's ``tests/test_bcd_parallel.py``
(``test_sharded_matches_sequential_bitwise``,
``test_pipelined_on_mesh_matches_sequential_bitwise``,
``test_sharded_on_forced_multi_device_mesh``,
``test_joint_cand_batch_sharding_on_forced_multi_device_mesh`` and
``test_make_evaluator_factory_validates``).  The reference lays its meshes
over four forced host devices in one process; here four ranks of one
``gloo`` process group run SPMD, each the same ``run_bcd``.

The reference's tiny CNN, from its init trained 5 steps, and the
reference sequential engine's run on it: every rank of every sharded
engine is held to it by the reference's standard (``_assert_same_result``: masks, trials and early
exits equal, ``best_drop`` within 1e-4).  The batch-split BatchNorm is held
to one rank's forward within 1e-5.
"""
import numpy as np
import pytest
import torch

from test_torch_helpers import reference, run_ranks, to_numpy_tree

CFG = ("tiny", 4, 16, ((8, 1, 1), (16, 1, 2)))
BCD = dict(b_target=8192 - 3 * 64, drc=64, rt=8, adt=0.5,
           finetune_every_step=False, seed=3, chunk_size=4)
_CACHE = {}


def _port_cfg():
    from repro_torch.models.resnet import CNNConfig
    return CNNConfig(*CFG, stem_channels=8)


def _reference_setup():
    """The reference's tiny CNN of ``tests/test_bcd_parallel.py``, its
    parameters from its init trained 5 SGD steps (by the port, converted
    back), and the reference sequential engine's run on them.  After 40
    steps, the reference fixture's count, every candidate reads 100 % and
    every trial ties; after 5 the blocks of 64 read 56–65 %."""
    if "setup" in _CACHE:
        return _CACHE["setup"]
    from repro_torch import convert
    from repro_torch.convert import to_device
    from repro_torch.core import masks as M
    from repro_torch.data import ImageDatasetCfg, SyntheticImages
    from repro_torch.models.resnet import CNN
    from repro_torch.training import optimizer as opt_lib, \
        train as train_lib
    ref = reference()
    rmodel = ref.resnet.CNN(ref.resnet.CNNConfig(*CFG, stem_channels=8))
    tparams = convert.params_from_reference(
        to_numpy_tree(rmodel.init(ref.jax.random.PRNGKey(0))), "cpu")
    tmodel = CNN(_port_cfg())
    data = SyntheticImages(ImageDatasetCfg(
        n_classes=4, image_size=16, n_train=256, n_test=64))
    opt = opt_lib.sgd(lr=5e-2, momentum=0.9)
    step, _ = train_lib.make_cnn_train_step(tmodel, opt)
    ostate = opt.init(tparams)
    masks0 = ref.linearize.init_masks(rmodel.mask_sites())
    mdev = M.as_device(masks0, "cpu")
    batches = data.batches("train", 32)
    for i in range(5):
        tparams, ostate, _, _ = step(tparams, ostate, mdev,
                                     to_device(batches(i), "cpu"))
    params = {k: {kk: vv.numpy() if hasattr(vv, "numpy") else
                  {k3: v3.numpy() for k3, v3 in vv.items()}
                  for kk, vv in v.items()} for k, v in tparams.items()}
    rparams = ref.jax.tree.map(ref.jnp.asarray, params)
    batch = data.train_eval_set(128)
    # the reference's make_eval_acc, with params and batch as jit inputs
    # (as closure constants XLA folds them for seconds)
    fn = ref.jax.jit(rmodel.make_joint_eval_fn())
    ctx = {"params": rparams, "batch": {k: ref.jnp.asarray(v)
                                        for k, v in batch.items()}}

    def eval_acc(m):
        return float(fn(ref.masks.as_device(m), ctx))
    seq = ref.engine.SequentialEvaluator(eval_acc)
    res = ref.bcd.run_bcd(masks0, ref.bcd.BCDConfig(**BCD), eval_acc,
                          evaluator=seq)
    stacked = ref.masks.sample_removal_blocks(np.random.default_rng(0),
                                              masks0, 8, 6)
    _CACHE["setup"] = dict(
        params=params,
        batch={k: np.asarray(v) for k, v in batch.items()},
        masks0={k: np.asarray(v) for k, v in masks0.items()},
        want=_summary(res.masks, res.history, ref.masks.fingerprint),
        stacked=stacked, want_accs=np.asarray(seq.evaluate(stacked)))
    return _CACHE["setup"]


def _summary(masks, history, fingerprint):
    return dict(fingerprint=fingerprint(masks),
                steps=[(h.trials, h.found_early, h.best_drop,
                        h.budget_before, h.budget_after) for h in history])


def _assert_same_result(got, want, what):
    """The reference's ``_assert_same_result``."""
    assert got["fingerprint"] == want["fingerprint"], what
    assert len(got["steps"]) == len(want["steps"]), what
    for g, w in zip(got["steps"], want["steps"]):
        assert (g[0], g[1]) == (w[0], w[1]), what
        assert g[2] == pytest.approx(w[2], abs=1e-4), what
        assert (g[3], g[4]) == (w[3], w[4]), what


def _on_ranks(rank, world, setup):
    """Every sharded engine of the port on this rank: BCD runs, per-call
    layouts, chunk accuracies and the batch-split forward."""
    from repro_torch import convert
    from repro_torch.core import bcd, engine, masks as M, spmd
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.resnet import CNN, accuracy
    model = CNN(_port_cfg())
    params = convert.params_from_reference(setup["params"], "cpu")
    batch, masks0 = setup["batch"], setup["masks0"]
    assert M.count(masks0) == 8192
    cand = mesh_lib.make_candidate_mesh(device="cpu")
    joint = mesh_lib.make_cand_batch_mesh(cand=2, batch=2, device="cpu")
    eval_acc = model.make_eval_acc(params, batch, "cpu")
    ctx = {"params": params, "batch": batch}
    specs = engine.context_batch_specs(ctx)

    def run(ev, chunk):
        cfg = bcd.BCDConfig(**{**BCD, "chunk_size": chunk})
        res = bcd.run_bcd(masks0, cfg, eval_acc, evaluator=ev)
        return _summary(res.masks, res.history, M.fingerprint)

    layouts = []
    sharded = engine.ShardedEvaluator(model.make_joint_eval_fn(), joint,
                                      context=ctx, context_specs=specs,
                                      device="cpu")
    choose = sharded._chunk_sharding

    def logged(n):
        layouts.append(choose(n))
        return layouts[-1]
    sharded._chunk_sharding = logged
    out = {
        "sharded": run(engine.ShardedEvaluator(
            model.make_eval_fn(params, batch, "cpu"), cand, pad_to=4,
            device="cpu"), 4),
        "pipelined_on_mesh": run(engine.PipelinedEvaluator(
            model.make_eval_fn(params, batch, "cpu"), pad_to=4, prefetch=2,
            mesh=cand, device="cpu"), 4),
        # chunks of 3, 3 and 2 of rt 8: joint, joint, candidate-only
        "joint": run(sharded, 3),
        "suffix_on_mesh": run(engine.SuffixEvaluator(
            model.make_suffix_eval_fns(), context=ctx, mesh=joint,
            context_specs=specs, pad_to=3, device="cpu"), 3),
    }
    # the reference's forced-mesh scripts: 6 candidates padded to 8 on the
    # 1-D mesh; 2 (candidate-only) and 6 (joint) on the (2, 2) mesh, and a
    # pipelined evaluator there through a context swap
    stacked = setup["stacked"]
    shd = engine.ShardedEvaluator(model.make_eval_fn(params, batch, "cpu"),
                                  cand, device="cpu")
    out["cand_accs"] = shd.evaluate(stacked)
    out["joint_layouts"] = [sharded._chunk_sharding(n) for n in (2, 8)]
    small = M.slice_stacked(stacked, 0, 2)
    out["joint_accs"] = (sharded.evaluate(small), sharded.evaluate(stacked))
    out["layouts"] = sorted(set(layouts))
    pip = engine.PipelinedEvaluator(model.make_joint_eval_fn(), mesh=joint,
                                    prefetch=2, context=ctx,
                                    context_specs=specs, device="cpu")
    first = pip.evaluate(small)
    pip.set_context(ctx)
    out["pipelined_accs"] = (first, pip.evaluate(stacked))
    # the batch-split forward against one rank's, on this rank's half
    c, b = joint.get_coordinate()
    group = joint.get_group("batch")
    images = torch.from_numpy(batch["images"])
    labels = torch.from_numpy(batch["labels"])
    m1 = M.as_device(M.index_stacked(stacked, 1), "cpu")
    half = slice(64 * b, 64 * (b + 1))
    with torch.no_grad():
        full = model.forward(params, m1, images)
        with spmd.batch_split(group, 2):
            part = model.forward(params, m1, images[half])
            acc = accuracy(part, labels[half])
    out["bn_split_err"] = float((part - full[half]).abs().max())
    out["split_acc"] = (float(acc), float(accuracy(full, labels)))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    setup = _reference_setup()
    outs = run_ranks(_on_ranks, 4, tmp_path_factory.mktemp("ranks"), setup,
                     timeout=180)
    return setup, outs


@pytest.mark.parametrize("engine_name", ["sharded", "pipelined_on_mesh",
                                         "joint", "suffix_on_mesh"])
def test_engines_on_a_mesh_select_the_reference_sequential_blocks(
        ranks, engine_name):
    setup, outs = ranks
    for rank, out in enumerate(outs):
        _assert_same_result(out[engine_name], setup["want"],
                            (engine_name, rank))


def test_joint_mesh_took_both_layouts(ranks):
    _, outs = ranks
    for out in outs:
        assert {layout for _, layout in out["layouts"]} == {"joint", "cand"}
        assert out["joint_layouts"] == [(2, "cand"), (8, "joint")]


def test_chunk_accuracies_on_four_ranks_match_reference(ranks):
    setup, outs = ranks
    want = setup["want_accs"]
    small = want[:2]
    for out in outs:
        np.testing.assert_allclose(out["cand_accs"], want, atol=1e-4)
        np.testing.assert_allclose(out["joint_accs"][0], small, atol=1e-4)
        np.testing.assert_allclose(out["joint_accs"][1], want, atol=1e-4)
        np.testing.assert_allclose(out["pipelined_accs"][0], small,
                                   atol=1e-4)
        np.testing.assert_allclose(out["pipelined_accs"][1], want,
                                   atol=1e-4)


def test_batch_split_batchnorm_within_1e5_of_one_rank(ranks):
    _, outs = ranks
    for out in outs:
        assert out["bn_split_err"] <= 1e-5
        assert out["split_acc"][0] == out["split_acc"][1]


def test_batch_split_keeps_moe_routing():
    """A MoE's capacity is per sequence, so each rank's slice of the eval
    batch routes as the whole batch does: a reduced DeepSeek-MoE's logits
    on each half equal the whole batch's rows."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import linearize, masks as M
    from repro_torch.models.lm import LM
    tcfg = dataclasses.replace(get_config("deepseek_moe_16b").reduced(),
                               n_layers=3)
    params = LM(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    model = LM(tcfg)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab, (4, 16))).long()
    masks = M.as_device(linearize.init_masks(model.mask_sites()), "cpu")
    with torch.no_grad():
        full = model.forward(params, masks, tokens)
        for half in (slice(0, 2), slice(2, 4)):
            part = model.forward(params, masks, tokens[half])
            np.testing.assert_allclose(part.numpy(), full[half].numpy(),
                                       rtol=0, atol=1e-5)


def test_make_evaluator_factory_validates():
    from repro_torch.core import engine
    with pytest.raises(ValueError):
        engine.make_evaluator("sequential")
    for backend in ("batched", "sharded", "pipelined"):
        with pytest.raises(ValueError):
            engine.make_evaluator(backend)
    with pytest.raises(ValueError):
        engine.make_evaluator("nope", eval_acc=lambda m: 0.0)
    with pytest.raises(ValueError):        # negative prefetch
        engine.make_evaluator("pipelined", eval_fn=lambda m: 0.0,
                              prefetch=-1)
    with pytest.raises(ValueError):        # context_specs needs a mesh
        engine.PipelinedEvaluator(lambda m: 0.0, context={"batch": {}},
                                  context_specs={"batch": {}}, device="cpu")
    with pytest.raises(ValueError, match="pipelined"):
        engine.make_evaluator("sharded", eval_fn=lambda m: 0.0,
                              prefetch="auto")

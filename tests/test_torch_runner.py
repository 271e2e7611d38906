"""The port's resumable runs (``repro_torch.core.runner``), on the CPU.

The contract, as the reference's ``tests/test_runner.py`` states it: a BCD
run checkpointed after every accepted block and resumed — after a clean
stop, a corrupted newest checkpoint, or an all-corrupt directory — replays
bit-identically against an uninterrupted run: same masks, same step logs
(``wall_s`` excepted), same finetuned params.  Each of the reference's
runner tests has its counterpart here, on all four engines of the port.

Across packages: the port's ``BCDConfig`` serialises to the reference's
``_cfg_meta``, a run the reference stopped is finished by the port (and
the other way round) with the reference's masks and histories, and stage
inits load in either package.  The toy accuracy is numpy (or torch on the
CPU for the stacked engines): coordinate-sensitive, deterministic.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from test_torch_helpers import reference, to_numpy_tree

TINY = ("tiny", 4, 8, ((4, 1, 1),))


# ------------------------------------------------------------ helpers


def _hist_identity(history):
    out = []
    for h in history:
        d = dataclasses.asdict(h)
        d.pop("wall_s")
        out.append(d)
    return out


def _assert_same_run(a_masks, a_hist, b_masks, b_hist):
    assert set(a_masks) == set(b_masks)
    for k in a_masks:
        np.testing.assert_array_equal(a_masks[k], b_masks[k])
    assert _hist_identity(a_hist) == _hist_identity(b_hist)


def _toy_masks(n=48):
    return {"a": np.ones((n // 2,), np.float32),
            "b": np.ones((n // 2,), np.float32)}


def _toy_eval_np(m):
    """numpy-only accuracy surrogate (float64), the same in both
    packages."""
    wa = np.arange(m["a"].shape[-1], dtype=np.float64)
    return float(95.0 - 0.02 * (np.sum((1 - m["a"]) * wa) +
                                np.sum((1 - m["b"]) * wa[::-1])))


def _toy_eval_fn(m, ties=True):
    """The same surrogate on (stacked) CPU tensors, float32."""
    wa = torch.arange(m["a"].shape[-1], dtype=torch.float32)
    return 95.0 - 0.02 * (torch.sum((1 - m["a"]) * wa, -1) +
                          torch.sum((1 - m["b"]) * wa.flip(0), -1))


def _toy_eval_acc(m):
    from repro_torch.core import masks as M
    return float(_toy_eval_fn(M.as_device(m, "cpu")))


def _toy_cfg(masks, steps=4, bcd=None, **kw):
    from repro_torch.core import bcd as port_bcd, masks as M
    total = M.count(masks)
    kw.setdefault("b_target", total - 4 * steps)
    kw.setdefault("drc", 4)
    kw.setdefault("rt", 6)
    kw.setdefault("adt", -1.0)       # no early exit: every trial evaluated
    kw.setdefault("chunk_size", 2)
    kw.setdefault("seed", 0)
    return (bcd or port_bcd).BCDConfig(**kw)


def _cnn(seed=0):
    from repro_torch.data import ImageDatasetCfg, SyntheticImages
    from repro_torch.models.resnet import CNN, CNNConfig
    model = CNN(CNNConfig(*TINY, stem_channels=4))
    data = SyntheticImages(ImageDatasetCfg(n_classes=4, image_size=8,
                                           n_train=64, n_test=32))
    params = model.init(torch.Generator().manual_seed(seed), "cpu")
    return model, data, params


# ------------------------------------------------------------ rng round-trip


def test_rng_state_roundtrip_through_json():
    from repro_torch.core import runner
    rng = np.random.default_rng(123)
    rng.random(37)
    blob = json.dumps(runner.rng_state_to_jsonable(rng))
    rng2 = runner.rng_from_state(json.loads(blob))
    np.testing.assert_array_equal(rng.random(100), rng2.random(100))
    np.testing.assert_array_equal(rng.integers(0, 1 << 62, 10),
                                  rng2.integers(0, 1 << 62, 10))


def test_rng_restore_rejects_foreign_bit_generator():
    from repro_torch.core import runner
    state = runner.rng_state_to_jsonable(np.random.default_rng(0))
    state = dict(state, bit_generator="MT19937")
    with pytest.raises(runner.CheckpointError, match="MT19937"):
        runner.rng_from_state(state)


# ------------------------------------------------------- resume equivalence


def _backend_ctx(backend):
    """(masks, cfg, eval_acc, make_evaluator) for one engine: the toy for
    the first three, the tiny CNN for the suffix engine (it needs a
    model's split forward)."""
    from repro_torch.core import engine, linearize, masks as M
    if backend != "suffix":
        masks = _toy_masks()

        def make():
            if backend == "sequential":
                return engine.SequentialEvaluator(_toy_eval_acc)
            if backend == "batched":
                return engine.BatchedEvaluator(_toy_eval_fn, pad_to=2,
                                               device="cpu")
            return engine.PipelinedEvaluator(_toy_eval_fn, pad_to=2,
                                             prefetch=2, device="cpu")
        return masks, _toy_cfg(masks, steps=5), _toy_eval_acc, make
    from repro_torch.launch.sweep import make_bcd_evaluator
    model, data, params = _cnn()
    eval_b = data.train_eval_set(32)
    masks = linearize.init_masks(model.mask_sites())
    _, eval_acc, _ = make_bcd_evaluator("sequential", model, eval_b,
                                        {"params": params}, chunk_size=2,
                                        rt=6, device="cpu")

    def make():
        return make_bcd_evaluator("suffix", model, eval_b,
                                  {"params": params}, chunk_size=2, rt=6,
                                  prefetch=1, device="cpu")[0]
    cfg = _toy_cfg(masks, steps=4, drc=2, b_target=M.count(masks) - 8)
    return masks, cfg, eval_acc, make


@pytest.mark.parametrize("backend",
                         ["sequential", "batched", "pipelined", "suffix"])
def test_resume_matches_uninterrupted_across_backends(backend, tmp_path):
    from repro_torch.core import bcd, masks as M, runner
    masks, cfg, eval_acc, make = _backend_ctx(backend)
    ref = bcd.run_bcd(masks, cfg, eval_acc, evaluator=make())

    d = str(tmp_path / backend)
    part = runner.BCDRunner(cfg, runner.RunnerConfig(ckpt_dir=d, max_steps=2),
                            eval_acc, evaluator=make(), device="cpu")
    pres = part.run(masks)
    assert part.stopped_early and M.count(pres.masks) > cfg.b_target

    cont = runner.BCDRunner(cfg, runner.RunnerConfig(ckpt_dir=d), eval_acc,
                            evaluator=make(), device="cpu")
    res = cont.run(masks)
    assert cont.resumed_from == 2 and not cont.stopped_early
    _assert_same_run(ref.masks, ref.history, res.masks, res.history)


def test_typed_move_state_roundtrips_through_resume(tmp_path):
    """The sensitivity proposal reads ``move_stats``: bit-identical resume
    needs the counters and the per-step ``move_kind`` to round-trip."""
    from repro_torch.core import bcd, masks as M, runner
    masks = _toy_masks()
    cfg = _toy_cfg(masks, steps=5, moves=M.MOVE_KINDS,
                   proposal="sensitivity")
    ref = bcd.run_bcd(masks, cfg, _toy_eval_acc)
    assert any(h.move_kind != "remove" for h in ref.history)

    d = str(tmp_path / "moves")
    part = runner.BCDRunner(cfg, runner.RunnerConfig(ckpt_dir=d, max_steps=2),
                            _toy_eval_acc, device="cpu")
    pres = part.run(masks)
    assert part.stopped_early
    assert sum(v["proposed"] for v in
               pres.move_stats["kinds"].values()) == 2 * cfg.rt
    cont = runner.BCDRunner(cfg, runner.RunnerConfig(ckpt_dir=d),
                            _toy_eval_acc, device="cpu")
    res = cont.run(masks)
    assert cont.resumed_from == 2 and not cont.stopped_early
    _assert_same_run(ref.masks, ref.history, res.masks, res.history)
    assert res.move_stats == ref.move_stats
    assert [h.move_kind for h in res.history] == \
        [h.move_kind for h in ref.history]


def test_resume_with_finetuned_params_roundtrip(tmp_path):
    """Params change between outer steps (finetune): they are part of the
    resume state and come back bit-exactly, as tensors, with masks as host
    float32 arrays."""
    from repro_torch.core import bcd, linearize, masks as M, runner
    from repro_torch.core.snl import finetune
    from repro_torch.training import optimizer as opt_lib, train
    model, data, params0 = _cnn()
    _, loss_fn = train.make_cnn_train_step(model, opt_lib.sgd(lr=1e-2))
    batches = data.batches("train", 16)
    eval_fn = model.make_param_eval_fn(data.train_eval_set(32), "cpu")
    masks0 = linearize.init_masks(model.mask_sites())
    cfg = _toy_cfg(masks0, drc=16, b_target=M.count(masks0) - 3 * 16,
                   adt=0.5)

    def fresh_ctx():
        holder = {"params": params0}

        def eval_acc(m):
            return float(eval_fn(M.as_device(m, "cpu"), holder["params"]))

        def ft(m):
            holder["params"] = finetune(holder["params"], m, loss_fn,
                                        batches, steps=4, lr=1e-2,
                                        device="cpu")
        pio = (lambda: holder["params"],
               lambda p: holder.__setitem__("params", p))
        return holder, eval_acc, ft, pio

    holder, eval_acc, ft, _ = fresh_ctx()
    ref = bcd.run_bcd(masks0, cfg, eval_acc, finetune=ft)
    ref_params = holder["params"]

    d = str(tmp_path / "ckpt")
    holder, eval_acc, ft, pio = fresh_ctx()
    part = runner.BCDRunner(cfg, runner.RunnerConfig(ckpt_dir=d, max_steps=1),
                            eval_acc, ft, params_io=pio, device="cpu")
    part.run(masks0)
    assert part.stopped_early

    # params reset to params0: the restore must overwrite them
    holder, eval_acc, ft, pio = fresh_ctx()
    cont = runner.BCDRunner(cfg, runner.RunnerConfig(ckpt_dir=d),
                            eval_acc, ft, params_io=pio, device="cpu")
    state, _ = runner.restore_run_state(d, cfg, masks0,
                                        params_template=params0,
                                        device="cpu")
    assert all(type(v) is np.ndarray and v.dtype == np.float32
               for v in state.masks.values())
    res = cont.run(masks0)
    assert cont.resumed_from == 1
    _assert_same_run(ref.masks, ref.history, res.masks, res.history)
    got = opt_lib.tree_leaves(holder["params"])
    want = opt_lib.tree_leaves(ref_params)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_resume_refuses_changed_config(tmp_path):
    from repro_torch.core import runner
    masks = _toy_masks()
    cfg = _toy_cfg(masks)
    d = str(tmp_path / "ckpt")
    runner.BCDRunner(cfg, runner.RunnerConfig(ckpt_dir=d, max_steps=1),
                     _toy_eval_acc, device="cpu").run(masks)
    changed = dataclasses.replace(cfg, seed=cfg.seed + 1)
    with pytest.raises(runner.CheckpointError, match="seed"):
        runner.BCDRunner(changed, runner.RunnerConfig(ckpt_dir=d),
                         _toy_eval_acc, device="cpu").run(masks)


# --------------------------------------------- corrupted checkpoint handling


def _run_two_checkpoints(tmp_path):
    from repro_torch.core import runner
    from repro_torch.training import checkpoint
    masks = _toy_masks()
    cfg = _toy_cfg(masks, steps=4)
    d = str(tmp_path / "ckpt")
    runner.BCDRunner(cfg, runner.RunnerConfig(ckpt_dir=d, max_steps=2,
                                              keep=10),
                     _toy_eval_acc, device="cpu").run(masks)
    assert checkpoint.latest_valid_step(d) == 2
    return masks, cfg, d


def test_corrupted_leaf_falls_back_to_previous_checkpoint(tmp_path):
    from repro_torch.core import bcd, runner
    from repro_torch.training import checkpoint
    masks, cfg, d = _run_two_checkpoints(tmp_path)
    leaf = os.path.join(d, "step_00000002", "leaf_00000.npy")
    blob = bytearray(open(leaf, "rb").read())
    blob[-1] ^= 0xFF
    open(leaf, "wb").write(bytes(blob))
    assert checkpoint.latest_valid_step(d) == 1
    ref = bcd.run_bcd(masks, cfg, _toy_eval_acc)
    cont = runner.BCDRunner(cfg, runner.RunnerConfig(ckpt_dir=d),
                            _toy_eval_acc, device="cpu")
    res = cont.run(masks)
    assert cont.resumed_from == 1
    _assert_same_run(ref.masks, ref.history, res.masks, res.history)


def test_all_checkpoints_corrupt_is_fresh_start(tmp_path):
    from repro_torch.core import bcd, runner
    from repro_torch.training import checkpoint
    masks, cfg, d = _run_two_checkpoints(tmp_path)
    for s in (1, 2):
        os.remove(os.path.join(d, f"step_{s:08d}", "manifest.json"))
    assert checkpoint.latest_valid_step(d) is None
    with pytest.raises(FileNotFoundError):
        runner.restore_run_state(d, cfg, masks, device="cpu")
    cont = runner.BCDRunner(cfg, runner.RunnerConfig(ckpt_dir=d),
                            _toy_eval_acc, device="cpu")
    res = cont.run(masks)
    assert cont.resumed_from is None
    ref = bcd.run_bcd(masks, cfg, _toy_eval_acc)
    _assert_same_run(ref.masks, ref.history, res.masks, res.history)


def test_restore_refuses_a_checkpoint_that_is_not_a_run_state(tmp_path):
    from repro_torch.core import runner
    masks = _toy_masks()
    runner.save_stage_init(str(tmp_path / "si"), {"masks": masks})
    with pytest.raises(runner.CheckpointError, match="not a BCD run state"):
        runner.restore_run_state(str(tmp_path / "si"), _toy_cfg(masks),
                                 masks, step=0, device="cpu")


# ------------------------------------------------------------ stage init


def test_stage_init_roundtrip(tmp_path):
    from repro_torch.core import masks as M, runner
    masks = M.threshold({k: np.random.default_rng(0)
                         .random(v.shape).astype(np.float32)
                         for k, v in _toy_masks().items()}, 20)
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "b": torch.zeros(3)}
    aux = {"alphas": {"a": np.full((24,), 0.25, np.float32)}}
    path = str(tmp_path / "init")
    runner.save_stage_init(path, {"kind": "snl", "masks": masks,
                                  "params": params, "aux": aux})
    assert runner.stage_init_exists(path)
    got = runner.load_stage_init(path, masks, params_template=params,
                                 aux_template=aux, device="cpu")
    assert got["kind"] == "snl"
    for k in masks:
        assert got["masks"][k].dtype == np.float32
        np.testing.assert_array_equal(got["masks"][k], masks[k])
    assert torch.equal(got["params"]["w"], params["w"])
    np.testing.assert_array_equal(got["aux"]["alphas"]["a"].numpy(),
                                  aux["alphas"]["a"])
    assert got["meta"]["budget"] == 20
    assert got["meta"]["mask_fingerprint"] == M.fingerprint(masks)
    lean = runner.load_stage_init(path, masks, params_template=params,
                                  device="cpu")
    assert lean["aux"] is None
    only = runner.load_stage_init(path, masks, masks_only=True, device="cpu")
    assert only["params"] is None
    with pytest.raises(runner.CheckpointError, match="params_template"):
        runner.load_stage_init(path, masks, device="cpu")
    with pytest.raises(runner.CheckpointError):
        runner.load_stage_init(str(tmp_path / "nope"), masks, device="cpu")


def test_snl_and_autorep_results_share_stage_init_shape(tmp_path):
    """Both warm starts have the layout ``{kind, masks, params, aux}`` and
    go through ``save_stage_init`` / ``load_stage_init`` whole: AutoReP's
    poly tensors ride in ``aux``."""
    from repro_torch.core import runner
    from repro_torch.core.autorep import AutoRepResult
    from repro_torch.core.snl import SNLResult
    masks = _toy_masks()
    params = {"w": torch.ones(2)}
    s = SNLResult(params=params, masks=masks, alphas={"a": np.ones(24)},
                  snapshots=[], budget_per_epoch=[], lam_per_epoch=[])
    a = AutoRepResult(params=params, poly={"p": torch.ones(3)},
                      masks=masks, alphas={}, budget_per_epoch=[])
    si, ai = s.stage_init(), a.stage_init()
    assert set(si) == set(ai) == {"kind", "masks", "params", "aux"}
    assert (si["kind"], ai["kind"]) == ("snl", "autorep")
    for init in (si, ai):
        path = str(tmp_path / init["kind"])
        runner.save_stage_init(path, init)
        got = runner.load_stage_init(path, masks, params_template=params,
                                     aux_template=init["aux"], device="cpu")
        assert got["kind"] == init["kind"]
        assert torch.equal(got["params"]["w"], params["w"])
    assert torch.equal(got["aux"]["poly"]["p"], torch.ones(3))


# ---------------------------------------------------------- across packages


def test_bcd_config_meta_is_the_reference_s():
    """A checkpoint's ``cfg`` must compare equal in both packages, or a
    reference checkpoint is refused on resume as 'a different
    BCDConfig'."""
    from repro_torch.core import bcd, runner
    ref = reference()
    kw = dict(b_target=100, drc=7, rt=9, adt=0.25, chunk_size=3, seed=4,
              moves=("remove", "swap"), proposal="sensitivity",
              finetune_every_step=False)
    assert runner._cfg_meta(bcd.BCDConfig(**kw)) == \
        ref.runner._cfg_meta(ref.bcd.BCDConfig(**kw))
    assert runner._cfg_meta(bcd.BCDConfig(b_target=1)) == \
        ref.runner._cfg_meta(ref.bcd.BCDConfig(b_target=1))


@pytest.mark.parametrize("first", ["reference", "port"])
def test_cross_package_resume_matches_uninterrupted(first, tmp_path):
    """One package stops a run at ``max_steps``, the other resumes it from
    the same directory and finishes: the reference's uninterrupted masks and
    histories (numpy accuracy, so both packages score alike)."""
    from repro_torch.core import runner
    ref = reference()
    masks = _toy_masks()
    cfg_r = _toy_cfg(masks, steps=5, bcd=ref.bcd,
                     moves=("remove", "add_back", "swap"),
                     proposal="sensitivity")
    cfg_t = _toy_cfg(masks, steps=5, moves=("remove", "add_back", "swap"),
                     proposal="sensitivity")
    want = ref.bcd.run_bcd(masks, cfg_r, _toy_eval_np)

    d = str(tmp_path / "ckpt")
    if first == "reference":
        part = ref.runner.BCDRunner(
            cfg_r, ref.runner.RunnerConfig(ckpt_dir=d, max_steps=2),
            _toy_eval_np)
        cont = runner.BCDRunner(cfg_t, runner.RunnerConfig(ckpt_dir=d),
                                _toy_eval_np, device="cpu")
    else:
        part = runner.BCDRunner(
            cfg_t, runner.RunnerConfig(ckpt_dir=d, max_steps=2),
            _toy_eval_np, device="cpu")
        cont = ref.runner.BCDRunner(
            cfg_r, ref.runner.RunnerConfig(ckpt_dir=d), _toy_eval_np)
    part.run(masks)
    assert part.stopped_early
    res = cont.run(masks)
    assert cont.resumed_from == 2 and not cont.stopped_early
    _assert_same_run(want.masks, want.history, res.masks, res.history)
    assert res.move_stats == want.move_stats


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cross_package_stage_init(writer, tmp_path):
    """A stage init (masks + CNN params + aux) written by one package loads
    in the other: same masks, same parameter bits, same meta."""
    from repro_torch import convert
    from repro_torch.core import runner
    ref = reference()
    model = ref.resnet.CNN(ref.resnet.CNNConfig(*TINY, stem_channels=4))
    rparams = model.init(ref.jax.random.PRNGKey(1))
    nparams = to_numpy_tree(rparams)
    tparams = convert.params_from_reference(nparams, "cpu")
    masks = {k: (np.random.default_rng(2).random(s.shape) < 0.5)
             .astype(np.float32) for k, s in model.mask_sites().items()}
    aux = {"alphas": {k: v * 0.5 for k, v in masks.items()}}
    path = str(tmp_path / "init")
    if writer == "reference":
        ref.runner.save_stage_init(path, {"kind": "snl", "masks": masks,
                                          "params": rparams, "aux": aux})
        got = runner.load_stage_init(path, masks, params_template=tparams,
                                     aux_template=aux, device="cpu")
        got_params = _tensors_to_numpy(got["params"])
    else:
        runner.save_stage_init(path, {"kind": "snl", "masks": masks,
                                      "params": tparams, "aux": aux})
        got = ref.runner.load_stage_init(
            path, masks, params_template=rparams, aux_template=aux)
        got_params = to_numpy_tree(got["params"])
    for k in masks:
        np.testing.assert_array_equal(got["masks"][k], masks[k])
    for a, b in zip(_leaf_list(got_params), _leaf_list(nparams)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert got["meta"]["mask_fingerprint"] == ref.masks.fingerprint(masks)


def _tensors_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tensors_to_numpy(v) for k, v in tree.items()}
    return tree.numpy()


def _leaf_list(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_list(tree[k])]
    return [np.asarray(tree)]

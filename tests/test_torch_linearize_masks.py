"""``linearize``, ``masks`` and ``bcd`` of the port against the JAX package.

``masks.py`` and ``bcd.py`` are numpy code copied from the reference, so they
are held *bit-identical*: same rng stream, same candidate trees, same
selection under the same deterministic evaluator.  ``apply_masked_act`` is
held to 1e-6 (the gate's tolerance) for hard, soft, poly and tied masks.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_helpers import reference

SHAPES = {"stem.relu": (4, 4, 3), "g0b0.relu1": (4, 4, 5),
          "g0b0.relu2": (4, 4, 5), "g1b0.relu1": (2, 2, 7),
          "g1b0.relu2": (2, 2, 7)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _trees_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


def _moves_equal(ma, mb):
    assert len(ma) == len(mb)
    for x, y in zip(ma, mb):
        assert x.kind == y.kind
        for f in ("off", "on", "tie"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def _start_masks(M, seed=0, with_ties=False):
    rng = np.random.default_rng(seed)
    masks = M.full_masks(SHAPES)
    masks = M.remove_random(rng, masks, 60)
    if with_ties:
        flat, layout = M._flatten(masks)
        el = M.share_eligible(flat, layout)
        flat = flat.copy()
        flat[el[::7]] = M.TIE
        masks = M._unflatten(flat, layout)
    return masks


# ------------------------------------------------------------- linearize


@pytest.mark.parametrize("kind", ["relu", "gelu", "silu", "sqrelu"])
@pytest.mark.parametrize("mode", ["hard", "soft", "poly", "soft_poly",
                                  "tied"])
def test_apply_masked_act_matches_reference(kind, mode):
    from repro_torch.core import linearize as L
    ref = reference()
    rng = np.random.default_rng(3)
    shape = (5, 6, 8)
    x = rng.normal(size=(4,) + shape).astype(np.float32)
    m = (rng.random(shape) > 0.5).astype(np.float32)
    poly = None
    soft = mode.startswith("soft")
    repl = "poly2" if "poly" in mode else "identity"
    if soft:
        m = (rng.random(shape) * 1.4 - 0.2).astype(np.float32)  # clipped
    if "poly" in mode:
        poly = rng.normal(size=(3,) + shape).astype(np.float32) * 0.3
    if mode == "tied":
        m[rng.random(shape) > 0.8] = 0.75
    want = ref.linearize.apply_masked_act(
        ref.jnp.asarray(x), ref.jnp.asarray(m),
        ref.linearize.MaskSite(shape, kind, repl),
        poly=None if poly is None else ref.jnp.asarray(poly), soft=soft)
    site = L.MaskSite(shape, kind, repl)
    got = L.apply_masked_act(_t(x), _t(m), site,
                             poly=None if poly is None else _t(poly),
                             soft=soft)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # stacked masks over a shared x: candidate i equals the single-tree call
    ms = np.stack([m, 1.0 - np.round(m), m]).astype(np.float32)
    if mode == "tied":
        ms[1] = m
    st = L.apply_masked_act(_t(x), _t(ms), site,
                            poly=None if poly is None else _t(poly),
                            soft=soft)
    assert st.shape == (3, 4) + shape
    np.testing.assert_array_equal(st[0].numpy(), got.numpy())
    np.testing.assert_array_equal(st[2].numpy(), got.numpy())
    # and over per-candidate activations
    xs = np.stack([x, -x, x])
    st2 = L.apply_masked_act(_t(xs), _t(ms), site,
                             poly=None if poly is None else _t(poly),
                             soft=soft)
    np.testing.assert_array_equal(st2[0].numpy(), got.numpy())


def test_ties_flag_only_skips_the_override():
    """ties=False on a tie-free mask equals ties=True; has_share_ties is the
    host test evaluators use to decide."""
    from repro_torch.core import linearize as L
    rng = np.random.default_rng(5)
    shape = (3, 4, 6)
    site = L.MaskSite(shape, "relu")
    x = _t(rng.normal(size=(2,) + shape).astype(np.float32))
    m = (rng.random(shape) > 0.5).astype(np.float32)
    a = L.apply_masked_act(x, _t(m), site, ties=True)
    b = L.apply_masked_act(x, _t(m), site, ties=False)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not L.has_share_ties({"s": m})
    m2 = m.copy()
    m2[0, 0, 1] = 0.75
    assert L.has_share_ties({"s": m2})
    assert L.has_share_ties({"s": np.stack([m, m2])})
    c = L.apply_masked_act(x, _t(m2), site, ties=True)
    want = (x[:, 0, 0, 1] * (x[:, 0, 0, 0] > 0)).numpy()
    np.testing.assert_array_equal(c[:, 0, 0, 1].numpy(), want)


def test_mask_site_validation_and_init_trees():
    from repro_torch.core import linearize as L
    ref = reference()
    with pytest.raises(ValueError):
        L.MaskSite((2, 2), "tanh")
    with pytest.raises(ValueError):
        L.MaskSite((2, 2), "relu", "cubic")
    with pytest.raises(ValueError):
        L.MaskSite((0, 2))
    assert L.KINDS == ref.linearize.KINDS
    sites = {"a": L.MaskSite((2, 3), "relu", "poly2"),
             "b": L.MaskSite((4,), "gelu")}
    rsites = {"a": ref.linearize.MaskSite((2, 3), "relu", "poly2"),
              "b": ref.linearize.MaskSite((4,), "gelu")}
    _trees_equal(L.init_masks(sites), ref.linearize.init_masks(rsites))
    p, rp = L.init_poly(sites, "cpu"), ref.linearize.init_poly(rsites)
    assert set(p) == set(rp) == {"a"}
    np.testing.assert_array_equal(p["a"].numpy(), np.asarray(rp["a"]))
    with pytest.raises(ValueError, match="does not fit site"):
        L.apply_masked_act(torch.zeros(1, 2, 3), torch.ones(3, 2),
                           sites["a"])


# ----------------------------------------------------------------- masks


def test_masks_module_is_the_reference_apart_from_as_device():
    """Every public name of the reference's masks module exists in the port
    with the same signature (``as_device`` gains ``device``)."""
    import inspect
    from repro_torch.core import masks as M
    ref = reference()
    for name, obj in vars(ref.masks).items():
        if name.startswith("__") or inspect.ismodule(obj):
            continue
        if getattr(obj, "__module__", None) != ref.masks.__name__:
            continue
        assert hasattr(M, name), name
        if inspect.isfunction(obj) and name != "as_device":
            assert str(inspect.signature(obj)) == \
                str(inspect.signature(getattr(M, name))), name
    out = M.as_device({"s": np.array([[0, 1]], np.float64)}, "cpu")
    assert out["s"].dtype == torch.float32 and out["s"].shape == (1, 2)


@pytest.mark.parametrize("kinds,proposal", [
    (("remove",), "uniform"),
    (("remove", "swap", "add_back"), "uniform"),
    (("remove", "share", "stage_drop"), "sensitivity"),
])
def test_sampling_and_materialization_bit_identical(kinds, proposal):
    from repro_torch.core import masks as M
    ref = reference()
    R = ref.masks
    masks = _start_masks(R, 1, with_ties="share" in kinds)
    _trees_equal(masks, _start_masks(M, 1, with_ties="share" in kinds))
    stats = {"kinds": {"remove": {"proposed": 9, "accepted": 2},
                       "share": {"proposed": 4, "accepted": 3}},
             "sites": {"g0b0.relu1": {"proposed": 7, "accepted": 5}}}
    kw = dict(kinds=kinds, proposal=proposal, move_stats=stats,
              max_remove=40)
    mv_r = R.sample_moves(np.random.default_rng(9), masks, 6, 11, **kw)
    mv_t = M.sample_moves(np.random.default_rng(9), masks, 6, 11, **kw)
    _moves_equal(mv_r, mv_t)
    flat_r, layout_r = R._flatten(masks)
    flat_t, layout_t = M._flatten(masks)
    np.testing.assert_array_equal(flat_r, flat_t)
    assert layout_r == layout_t
    _trees_equal(R.materialize_moves_from_flat(flat_r, layout_r, mv_r),
                 M.materialize_moves_from_flat(flat_t, layout_t, mv_t))
    for cr, ct in zip(R.materialize_move_chunks(flat_r, layout_r, mv_r, 4),
                      M.materialize_move_chunks(flat_t, layout_t, mv_t, 4)):
        _trees_equal(cr, ct)
    seg = {k: i for i, k in enumerate(SHAPES)}
    or_, gr = R.group_moves_by_site(mv_r, layout_r, seg)
    ot, gt = M.group_moves_by_site(mv_t, layout_t, seg)
    np.testing.assert_array_equal(or_, ot)
    assert gr == gt
    for a, b in zip(mv_r, mv_t):
        assert R.move_sites(a, layout_r) == M.move_sites(b, layout_t)
        _trees_equal(R.apply_move(masks, a), M.apply_move(masks, b))


def test_index_sampling_grouping_and_fingerprint_bit_identical():
    from repro_torch.core import masks as M
    ref = reference()
    R = ref.masks
    masks = _start_masks(R, 2)
    idx_r = R.sample_removal_indices(np.random.default_rng(4), masks, 5, 9)
    idx_t = M.sample_removal_indices(np.random.default_rng(4), masks, 5, 9)
    np.testing.assert_array_equal(idx_r, idx_t)
    _trees_equal(R.materialize_candidates(masks, idx_r),
                 M.materialize_candidates(masks, idx_t))
    flat, layout = M._flatten(masks)
    for cr, ct in zip(R.materialize_chunks(flat, layout, idx_r, 4),
                      M.materialize_chunks(flat, layout, idx_t, 4)):
        _trees_equal(cr, ct)
    seg = {k: i // 2 for i, k in enumerate(SHAPES)}
    or_, gr = R.group_blocks_by_site(idx_r, layout, seg)
    ot, gt = M.group_blocks_by_site(idx_t, layout, seg)
    np.testing.assert_array_equal(or_, ot)
    assert gr == gt
    within_r = R.sample_removal_indices_within(
        np.random.default_rng(6), masks, 4, 5, ["g1b0.relu1"])
    within_t = M.sample_removal_indices_within(
        np.random.default_rng(6), masks, 4, 5, ["g1b0.relu1"])
    np.testing.assert_array_equal(within_r, within_t)
    assert R.fingerprint(masks) == M.fingerprint(masks)
    assert R.chunk_bounds(11, 4) == M.chunk_bounds(11, 4)
    raw = [(None, 0, 2), (None, 2, 3), ("a", 3, 7), (None, 7, 8),
           (None, 8, 12)]
    assert R.coalesce_fallback_chunks(raw, 4) == \
        M.coalesce_fallback_chunks(raw, 4)
    st = M.materialize_candidates(masks, idx_t)
    _trees_equal(R.pad_stacked(st, 12), M.pad_stacked(st, 12))
    np.testing.assert_array_equal(R.stacked_relu_costs(st),
                                  M.stacked_relu_costs(st))
    assert (R.count(masks), R.relu_cost(masks), R.tied_count(masks)) == \
        (M.count(masks), M.relu_cost(masks), M.tied_count(masks))
    soft = {k: np.random.default_rng(1).random(v.shape).astype(np.float32)
            for k, v in masks.items()}
    _trees_equal(R.threshold(soft, 50), M.threshold(soft, 50))


# ------------------------------------------------------------------- bcd


class _FakeEvaluator:
    """Deterministic numpy evaluator: accuracy is a fixed random linear
    functional of the mask values, quantised to multiples of 100/64 so that
    ties occur and first-occurrence tie-breaking is exercised."""

    prefetch_depth = 0

    def __init__(self, masks, name="fake", preferred_chunk=None, seed=0):
        rng = np.random.default_rng(seed)
        self.w = {k: rng.normal(size=v.shape) for k, v in masks.items()}
        self.name = name
        self.preferred_chunk = preferred_chunk
        self.calls = []

    def acc_one(self, tree):
        s = sum(float((self.w[k] * tree[k]).sum()) for k in self.w)
        return float(np.round((50.0 + 3.0 * s) * 0.64) / 0.64)

    def evaluate(self, stacked):
        n = len(next(iter(stacked.values())))
        self.calls.append(n)
        return np.array([self.acc_one({k: v[i] for k, v in stacked.items()})
                         for i in range(n)], dtype=np.float64)


def _logs(history):
    return [{k: v for k, v in dataclasses.asdict(h).items()
             if k != "wall_s"} for h in history]


@pytest.mark.parametrize("adt", [0.3, -100.0, 5.0])
@pytest.mark.parametrize("moves", [("remove",),
                                   ("remove", "swap", "add_back", "share",
                                    "stage_drop")])
def test_run_bcd_bit_identical_under_fake_evaluator(adt, moves):
    from repro_torch.core import bcd as B, masks as M
    ref = reference()
    masks = M.full_masks(SHAPES)
    kw = dict(b_target=M.count(masks) - 45, drc=10, rt=7, adt=adt,
              finetune_every_step=False, seed=5, chunk_size=3, moves=moves,
              proposal="sensitivity" if len(moves) > 1 else "uniform")
    ev_r, ev_t = _FakeEvaluator(masks), _FakeEvaluator(masks)
    res_r = ref.bcd.run_bcd(masks, ref.bcd.BCDConfig(**kw), ev_r.acc_one,
                            evaluator=ev_r, keep_snapshots=True)
    res_t = B.run_bcd(masks, B.BCDConfig(**kw), ev_t.acc_one,
                      evaluator=ev_t, keep_snapshots=True)
    _trees_equal(res_r.masks, res_t.masks)
    assert _logs(res_r.history) == _logs(res_t.history)
    assert len(res_t.history) >= 1
    assert ev_r.calls == ev_t.calls
    assert res_r.move_stats == res_t.move_stats
    for a, b in zip(res_r.mask_snapshots, res_t.mask_snapshots):
        _trees_equal(a, b)
    assert M.relu_cost(res_t.masks) == kw["b_target"]


def test_select_block_and_state_helpers_bit_identical():
    from repro_torch.core import bcd as B, masks as M
    ref = reference()
    masks = _start_masks(M, 3)
    cfg_kw = dict(b_target=10, drc=8, rt=9, adt=-1.0, seed=2, chunk_size=4)
    ev_r = _FakeEvaluator(masks, preferred_chunk=1)
    ev_t = _FakeEvaluator(masks, preferred_chunk=1)
    out_r = ref.bcd._select_block(
        masks, ref.bcd.BCDConfig(**cfg_kw), np.random.default_rng(1), ev_r,
        8, 40.0)
    out_t = B._select_block(
        masks, B.BCDConfig(**cfg_kw), np.random.default_rng(1), ev_t,
        8, 40.0)
    _trees_equal(out_r[0], out_t[0])
    assert out_r[1:5] == out_t[1:5]
    _moves_equal(out_r[5], out_t[5])
    assert ev_r.calls == ev_t.calls == [1] * 9
    assert B.total_steps(100, B.BCDConfig(b_target=13, drc=10)) == \
        ref.bcd.total_steps(100, ref.bcd.BCDConfig(b_target=13, drc=10))
    for bad in (dict(drc=0), dict(rt=0), dict(chunk_size=0),
                dict(adt=float("nan")), dict(moves=()),
                dict(moves=("jump",)), dict(proposal="greedy")):
        with pytest.raises(ValueError):
            B.BCDConfig(b_target=1, **bad).validate()
    st = B.init_state(masks, B.BCDConfig(b_target=1))
    assert st.b_ref == M.relu_cost(masks) and st.step == 0

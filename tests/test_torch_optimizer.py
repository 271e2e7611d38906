"""The port's optimizers and schedules against the JAX package's, on the
CPU.

Same parameters and gradients (made with numpy from a seed) through both,
several steps, compared leaf by leaf within 1e-6 relative: the update
rules are the same float32 operations in the same order, and only the
float32 ``cos`` and ``pow`` of the schedule and the bias correction (XLA's
against numpy's, an ulp apart at most) and the order of the gradient-norm
sum differ.
"""
import numpy as np
import pytest
import torch

from test_torch_helpers import reference, to_numpy_tree

RTOL, ATOL = 1e-6, 1e-7


def _opt_module():
    ref = reference()
    import repro.training.optimizer as ropt
    return ref, ropt


def _tree(rng, scale=1.0):
    return {"conv": {"w": (rng.normal(size=(3, 3, 4, 5)) * scale)
                     .astype(np.float32)},
            "bn": {"scale": (rng.normal(size=(5,)) * scale)
                   .astype(np.float32),
                   "bias": (rng.normal(size=(5,)) * scale)
                   .astype(np.float32)},
            "fc": [(rng.normal(size=(5, 3)) * scale).astype(np.float32)]}


CASES = {
    # name: (kind, kwargs for both packages' constructors)
    "sgd": ("sgd", dict(lr=5e-2, momentum=0.9)),
    "sgd_wd_clip": ("sgd", dict(lr=5e-2, momentum=0.9, weight_decay=5e-4,
                                grad_clip=0.5)),
    "sgd_cosine": ("sgd", dict(lr=3e-2, momentum=0.9, cosine=7)),
    "adamw": ("adamw", dict(lr=1e-3)),
    "adamw_wd_clip": ("adamw", dict(lr=1e-3, weight_decay=1e-2,
                                    grad_clip=0.5)),
    "adamw_cosine": ("adamw", dict(lr=3.5e-5, cosine=5)),
}


def _make(mod, kind, kw):
    kw = dict(kw)
    total = kw.pop("cosine", None)
    if total is not None:
        kw["schedule"] = mod.cosine(kw["lr"], total)
    return getattr(mod, kind)(**kw)


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_steps_match_reference(case):
    from repro_torch import convert
    from repro_torch.training import optimizer as topt
    ref, ropt = _opt_module()
    jnp = ref.jnp
    kind, kw = CASES[case]
    rng = np.random.default_rng(3)
    params_np = _tree(rng)
    r_opt, t_opt = _make(ropt, kind, kw), _make(topt, kind, kw)
    r_params = ref.jax.tree.map(jnp.asarray, params_np)
    t_params = convert.params_from_reference(params_np, "cpu")
    r_state, t_state = r_opt.init(r_params), t_opt.init(t_params)
    for i in range(6):
        grads_np = _tree(np.random.default_rng(100 + i), scale=0.7)
        r_up, r_state = r_opt.update(
            ref.jax.tree.map(jnp.asarray, grads_np), r_state, r_params)
        r_params = ropt.apply_updates(r_params, r_up)
        t_up, t_state = t_opt.update(
            convert.params_from_reference(grads_np, "cpu"), t_state,
            t_params)
        t_params = topt.apply_updates(t_params, t_up)
        want = to_numpy_tree(r_params)
        got = topt.tree_leaves(t_params)
        for w, g in zip(ref.jax.tree.leaves(want), got):
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)
    assert t_state.step == int(r_state.step) == 6
    for w, g in zip(ref.jax.tree.leaves(to_numpy_tree(r_state.mu)),
                    topt.tree_leaves(t_state.mu)):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("sched", ["cosine", "cosine_min", "constant"])
def test_schedules_match_reference(sched):
    from repro_torch.training import optimizer as topt
    ref, ropt = _opt_module()
    make = {"cosine": lambda m: m.cosine(3e-2, 30),
            "cosine_min": lambda m: m.cosine(1e-2, 12, min_lr=1e-4),
            "constant": lambda m: m.constant(5e-2)}[sched]
    r, t = make(ropt), make(topt)
    for step in range(0, 35):
        want = float(r(ref.jnp.asarray(step, ref.jnp.int32)))
        got = t(step)
        assert isinstance(got, float)
        assert got == pytest.approx(want, rel=RTOL, abs=1e-12), step
        assert np.float32(got) == got           # a float32 value


def test_tree_helpers_keep_structure_and_sorted_leaf_order():
    from repro_torch.training import optimizer as topt
    tree = {"b": torch.ones(2), "a": [torch.zeros(1), torch.full((3,), 2.)],
            "c": None}
    leaves = topt.tree_leaves(tree)
    assert [t.shape[0] for t in leaves] == [1, 3, 2]     # a[0], a[1], b
    out = topt.tree_map(lambda t: t + 1, tree)
    assert list(out) == ["b", "a", "c"] and out["c"] is None
    assert isinstance(out["a"], list)
    np.testing.assert_array_equal(out["a"][1].numpy(), [3., 3., 3.])
    assert tree["b"][0] == 1.0                     # nothing in place


@pytest.mark.parametrize("case", list(CASES))
def test_leaf_by_leaf_step_equals_update_and_apply_bitwise(case):
    """``step_leaves`` — the in-place, leaf-by-leaf step the training loops
    take so that a model's parameters, gradients and moments fit the card —
    gives the bits of ``opt.update`` + ``apply_updates`` over whole trees,
    step after step, moments included; each gradient entry is dropped."""
    from repro_torch.training import optimizer as topt
    kind, kw = CASES[case]
    opt = _make(topt, kind, kw)
    rng = np.random.default_rng(11)
    params = topt.tree_map(torch.from_numpy, _tree(rng))
    state = opt.init(params)
    leaves = topt.tree_leaves(params)
    lstate = opt.init(leaves)
    for _ in range(6):
        grads = topt.tree_map(torch.from_numpy, _tree(rng, scale=3.0))
        updates, state = opt.update(grads, state, params)
        params = topt.apply_updates(params, updates)
        glist = topt.tree_leaves(grads)
        same_list = leaves
        leaves, lstate = topt.step_leaves(opt, glist, lstate, leaves)
        assert leaves is same_list and glist == [None] * len(glist)
        assert lstate.step == state.step
        for want, got in zip(topt.tree_leaves(params), leaves):
            assert torch.equal(want, got)
        for mine, theirs in ((lstate.mu, state.mu), (lstate.nu, state.nu)):
            if theirs is None:
                assert mine is None
                continue
            for want, got in zip(topt.tree_leaves(theirs), mine):
                assert torch.equal(want, got)

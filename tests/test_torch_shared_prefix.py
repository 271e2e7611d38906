"""The candidate axis begins where the candidates differ, on the CPU.

The batched, pipelined and suffix engines hand a stacked chunk's forward
the host decision ``linearize.first_differences`` (``differ=``): per mask
key, None where the chunk's candidates all share the mask, else the first
index (the first stack repeat, for a key with a repeat axis) at which they
differ.  The models gate a site or repeat that every candidate shares with
its one mask while the activation is still shared, so every layer before
the chunk's first differing gate runs at B rows in every engine, as the
suffix engine's cached prefix does.  On the card a product may round a row
otherwise at another row count; here the products do not depend on it, so
every engine's accuracies are equal to the bit with and without the
decision.

Reduced DeepSeek-MoE-16B (cut to 5 layers, so that repeats follow the
site), StableLM-2-1.6B and the mini ResNet, parameters from the reference's
init, converted.  Masks and tokens from numpy seeds.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_helpers import reference, to_numpy_tree

B, S, N = 2, 12, 4
_CACHE = {}


def _lm(arch, n_layers):
    """(port model, converted params, eval batch) of the reference's reduced
    config at ``n_layers``, cached per process."""
    key = (arch, n_layers)
    if key not in _CACHE:
        from repro_torch import convert
        from repro_torch.configs import get_config
        from repro_torch.models.lm import LM
        ref = reference()
        rcfg = dataclasses.replace(ref.configs.get_config(arch).reduced(),
                                   n_layers=n_layers)
        tcfg = dataclasses.replace(get_config(arch).reduced(),
                                   n_layers=n_layers)
        rparams = ref.lm.LM(rcfg).init(ref.jax.random.PRNGKey(0))
        tparams = convert.params_from_reference(to_numpy_tree(rparams), "cpu",
                                                dtype=None)
        rng = np.random.default_rng(7)
        batch = {"tokens": rng.integers(0, tcfg.vocab, size=(B, S + 1))
                 .astype(np.int32)}
        _CACHE[key] = LM(tcfg), tparams, batch
    return _CACHE[key]


def _cnn():
    if "cnn" not in _CACHE:
        from repro_torch import convert
        from repro_torch.data import ImageDatasetCfg, SyntheticImages
        from repro_torch.models.resnet import CNN, CNNConfig
        ref = reference()
        stages = ((8, 2, 1), (16, 2, 2))
        rmodel = ref.resnet.CNN(ref.resnet.CNNConfig("mini", 4, 8, stages,
                                                     stem_channels=8))
        tparams = convert.params_from_reference(
            to_numpy_tree(rmodel.init(ref.jax.random.PRNGKey(0))), "cpu")
        tmodel = CNN(CNNConfig("mini", 4, 8, stages, stem_channels=8))
        batch = SyntheticImages(ImageDatasetCfg(
            n_classes=4, image_size=8, n_train=64, n_test=32)
        ).train_eval_set(32)
        _CACHE["cnn"] = tmodel, tparams, batch
    return _CACHE["cnn"]


# the models under test: (name, builder, the site the sited candidates cut
# at, a deeper site)
MODELS = {
    "deepseek": (lambda: _lm("deepseek_moe_16b", 5), "s0.moe@2", "s0.moe@3"),
    "stablelm": (lambda: _lm("stablelm_1p6b", 4), "s0.ffn@1", "s0.ffn@3"),
    "resnet": (_cnn, "g1b0.relu1", "g1b1.relu2"),
}


def _sited(model, site, n, drc, seed):
    """n candidates, each removing drc coordinates of ``site`` alone."""
    from repro_torch.core import linearize, masks as M
    masks0 = linearize.init_masks(model.mask_sites())
    reps = getattr(model, "site_repeats", lambda: None)()
    idx = M.sample_removal_indices_within(
        np.random.default_rng(seed), masks0, drc, n, [site],
        repeat_sites=reps)
    return masks0, M.materialize_candidates(masks0, idx)


# --------------------------------------------------------- the decision


def test_first_differences_on_the_host():
    from repro_torch.core import linearize, masks as M
    rng = np.random.default_rng(0)
    base = {"s0.ffn": np.ones((4, 6), np.float32),     # (R, F)
            "h0.ffn": np.ones((5,), np.float32),
            "g0.relu": np.ones((3, 3, 2), np.float32)}
    trees = [dict((k, v.copy()) for k, v in base.items()) for _ in range(3)]
    trees[1]["s0.ffn"][2, rng.integers(6)] = 0.0
    trees[2]["s0.ffn"][3, 0] = 0.0
    trees[2]["g0.relu"][1, 2, 0] = 0.0
    got = linearize.first_differences(M.stack_trees(trees))
    assert got == {"s0.ffn": 2, "h0.ffn": None, "g0.relu": 1}
    # a ragged chunk of one candidate, padded: nothing differs
    one = M.pad_stacked(M.stack_trees(trees[1:2]), 4)
    assert set(linearize.first_differences(one).values()) == {None}


def test_shared_mask_and_per_candidate():
    from repro_torch.core import linearize
    m = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    differ = {"a": 2, "b": None}
    assert torch.equal(linearize.shared_mask(m, differ, "a", 1), m[0])
    assert linearize.shared_mask(m, differ, "a", 2) is m
    assert linearize.shared_mask(m, differ, "a") is m
    assert torch.equal(linearize.shared_mask(m, differ, "b"), m[0])
    assert linearize.shared_mask(m, None, "b") is m
    assert linearize.shared_mask(m, differ, "c") is m
    acc = torch.tensor(37.5)
    out = linearize.per_candidate(acc, {"a": m}, differ)
    assert out.shape == (2,) and bool((out == 37.5).all())
    assert linearize.per_candidate(acc, {"a": m}, None) is acc
    vec = torch.tensor([1.0, 2.0])
    assert linearize.per_candidate(vec, {"a": m}, differ) is vec


# ------------------------------------------------- rows before the site


def test_moe_router_rows_before_and_after_the_site(monkeypatch):
    """Candidates sited at ``s0.moe@2`` on a reduced DeepSeek-MoE of four
    MoE repeats: the batched engine's chunk routes B rows in repeats 0–2
    (the router reads the block's input, which the candidates still share
    at the site's own repeat) and N·B rows in repeat 3; without the host
    decision every repeat routes N·B."""
    from repro_torch.launch.sweep import make_bcd_evaluator
    from repro_torch.models import moe
    model, params, batch = _lm("deepseek_moe_16b", 5)
    _, chunk = _sited(model, "s0.moe@2", N, 24, 1)
    rows = []
    top_k = moe._top_k

    def spy(logits, c):
        rows.append(int(logits.shape[0]))
        return top_k(logits, c)
    monkeypatch.setattr(moe, "_top_k", spy)
    ev, _, _ = make_bcd_evaluator("batched", model, batch,
                                  {"params": params}, chunk_size=N, rt=N,
                                  device="cpu")
    ev.evaluate(chunk)
    assert rows == [B, B, B, N * B]
    rows.clear()
    ev._with_differ = False
    ev.evaluate(chunk)
    assert rows == [N * B] * 4


def test_dense_ffn_rows_before_and_after_the_site(monkeypatch):
    """The same on a reduced StableLM sited at ``s0.ffn@1``: attention runs
    on B rows in repeats 0 and 1 and on N·B from repeat 2 on."""
    from repro_torch.launch.sweep import make_bcd_evaluator
    from repro_torch.models import layers
    model, params, batch = _lm("stablelm_1p6b", 4)
    _, chunk = _sited(model, "s0.ffn@1", N, 16, 2)
    rows = []
    attention = layers.attention

    def spy(p, c, x, positions, **kw):
        rows.append(int(np.prod(x.shape[:-2])))
        return attention(p, c, x, positions, **kw)
    monkeypatch.setattr(layers, "attention", spy)
    ev, _, _ = make_bcd_evaluator("batched", model, batch,
                                  {"params": params}, chunk_size=N, rt=N,
                                  device="cpu")
    ev.evaluate(chunk)
    assert rows == [B, B, N * B, N * B]


# ------------------------------------------ engines with and without it


def _evaluate_all(model, params, batch, site, chunks):
    """Each engine's accuracies of the chunks: the sequential engine one
    by one, the batched and pipelined engines whole, the suffix engine at
    the chunk's site (fused and unfused) and down its full-forward
    fallback."""
    from repro_torch.core import engine as E
    from repro_torch.launch.sweep import make_bcd_evaluator
    from repro_torch.core import linearize
    masks0 = linearize.init_masks(model.mask_sites())
    out = {}
    for backend, fused in (("sequential", False), ("batched", False),
                           ("pipelined", False), ("suffix", False),
                           ("suffix", True)):
        ev, _, _ = make_bcd_evaluator(backend, model, batch,
                                      {"params": params}, chunk_size=N,
                                      rt=N, prefetch=0, fused_kernels=fused,
                                      device="cpu")
        label = backend + ("_fused" if fused else "")
        if backend == "suffix":
            ev.begin_step(masks0)
            out[label] = [ev.evaluate(E.SitedChunk(site, c)) for c in chunks]
            out[label + "_fallback"] = [ev.evaluate(E.SitedChunk(None, c))
                                        for c in chunks]
        else:
            out[label] = [ev.evaluate(c) for c in chunks]
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_engines_equal_with_and_without_the_decision(name, monkeypatch):
    """Sited candidates in a full chunk and a ragged one (padded by
    ``pad_stacked``), and random candidates across the sites: each engine
    returns the same bits with the host decision as without it, and the
    engines agree with each other."""
    from repro_torch.core import engine as E, masks as M
    build, site, deep = MODELS[name]
    model, params, batch = build()
    masks0, sited = _sited(model, site, N + 3, 8, 3)
    _, deeper = _sited(model, deep, N, 8, 4)
    spread = M.materialize_candidates(masks0, M.sample_removal_indices(
        np.random.default_rng(5), masks0, 16, N))
    first = {k: v[:N] for k, v in sited.items()}
    ragged = {k: v[N:] for k, v in sited.items()}
    with_decision = _evaluate_all(model, params, batch, site,
                                  [first, ragged])
    with_decision.update({f"{k}@deep": v for k, v in _evaluate_all(
        model, params, batch, deep, [deeper]).items()})
    spread_with = E.BatchedEvaluator(
        model.make_param_eval_fn(batch, "cpu"), pad_to=N,
        context=params, device="cpu").evaluate(spread)
    monkeypatch.setattr(E, "takes_differ", lambda fn: False)
    without = _evaluate_all(model, params, batch, site, [first, ragged])
    without.update({f"{k}@deep": v for k, v in _evaluate_all(
        model, params, batch, deep, [deeper]).items()})
    spread_without = E.BatchedEvaluator(
        model.make_param_eval_fn(batch, "cpu"), pad_to=N,
        context=params, device="cpu").evaluate(spread)
    assert np.array_equal(spread_with, spread_without)
    for label, accs in with_decision.items():
        for a, b in zip(accs, without[label]):
            assert a.dtype == np.float64 and a.shape == b.shape, label
            assert np.array_equal(a, b), (label, a, b)
    for suffix in ("", "@deep"):
        want = with_decision["sequential" + suffix]
        for label, accs in with_decision.items():
            if label.endswith("@deep") == bool(suffix):
                for a, b in zip(accs, want):
                    assert np.array_equal(a, b), (label, a, b)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_a_chunk_of_equal_candidates_returns_n(name):
    """A chunk of one candidate padded to N: no gate differs, the forward
    runs once, un-stacked, and each of the N candidates gets its
    accuracy — the one-tree forward's, to the bit."""
    from repro_torch.core import engine as E, linearize, masks as M
    build, site, _ = MODELS[name]
    model, params, batch = build()
    _, one = _sited(model, site, 1, 8, 6)
    padded = M.pad_stacked(one, N)
    differ = linearize.first_differences(padded)
    assert set(differ.values()) == {None}
    fn = model.make_param_eval_fn(batch, "cpu")
    with torch.no_grad():
        got = fn(M.as_device(padded, "cpu"), params, ties=False,
                 differ=differ)
        alone = fn(M.as_device(M.index_stacked(one, 0), "cpu"), params,
                   ties=False)
    assert got.shape == (N,) and bool((got == alone).all())
    ev = E.BatchedEvaluator(fn, pad_to=N, context=params, device="cpu")
    accs = ev.evaluate(one)
    assert accs.shape == (1,) and accs[0] == float(alone)

"""The port end to end: BCD candidate evaluation through the port's engines
against the JAX package's, on the CPU, at a small size.

Both packages get the same parameters (the reference's ``CNN.init``,
converted), the same synthetic images (numpy, from a seed) and the same BCD
config and seed.  ``bcd.py`` and ``masks.py`` are bit-identical copies (held
so in ``test_torch_linearize_masks.py``), so both sample the same candidates;
what is tested here is that the port's four backends — sequential, batched,
pipelined, suffix — rank them alike and like the reference does.

Accuracies are multiples of 100/B (B = 64, a power of two, so they are exact
in float32 in both packages).  A logit that differs in the sixth digit could
still flip an argmax at a near-tie, so the tests assert that the top-2 logit
margin of every evaluated candidate exceeds 1e-4 — ten times the tolerance
the forwards are held to — and a failure says which of the two it is.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_helpers import reference, to_numpy_tree

STAGES = ((8, 2, 1), (16, 2, 2))       # the r18-mini plan
SIZE, BATCH, CLASSES = 8, 64, 4
MARGIN = 1e-4


@pytest.fixture(scope="module")
def setup():
    from repro_torch import convert
    from repro_torch.core import linearize
    from repro_torch.data import ImageDatasetCfg, SyntheticImages
    from repro_torch.models.resnet import CNN, CNNConfig
    ref = reference()
    rmodel = ref.resnet.CNN(ref.resnet.CNNConfig(
        "mini", CLASSES, SIZE, STAGES, stem_channels=8))
    tmodel = CNN(CNNConfig("mini", CLASSES, SIZE, STAGES, stem_channels=8))
    rparams = rmodel.init(ref.jax.random.PRNGKey(0))
    tparams = convert.params_from_reference(to_numpy_tree(rparams), "cpu")
    batch = SyntheticImages(ImageDatasetCfg(
        n_classes=CLASSES, image_size=SIZE, n_train=256, n_test=64)
    ).train_eval_set(BATCH)
    masks0 = linearize.init_masks(tmodel.mask_sites())
    return ref, rmodel, rparams, tmodel, tparams, batch, masks0


def _port_evaluator(backend, tmodel, tparams, batch, chunk, rt, **kw):
    from repro_torch.launch.sweep import make_bcd_evaluator
    holder = {"params": tparams}
    ev, eval_acc, set_ctx = make_bcd_evaluator(
        backend, tmodel, batch, holder, chunk_size=chunk, rt=rt,
        device="cpu", **kw)
    return ev, eval_acc, set_ctx


def _ref_evaluator(ref, backend, rmodel, rparams, batch, pad_to, **kw):
    if backend == "suffix":
        ctx = {"params": rparams,
               "batch": {k: np.asarray(v) for k, v in batch.items()}}
        return ref.engine.make_evaluator(
            "suffix", split=rmodel.make_suffix_eval_fns(), context=ctx,
            pad_to=pad_to, **kw)
    return ref.engine.make_evaluator(
        backend, eval_fn=rmodel.make_eval_fn(rparams, batch), pad_to=pad_to)


def _logs(history):
    return [{k: v for k, v in dataclasses.asdict(h).items()
             if k != "wall_s"} for h in history]


def _assert_margins(tmodel, tparams, batch, trees):
    """Every tree's logits on the eval batch are at least MARGIN away from
    an argmax tie — otherwise equal accuracies would be luck."""
    from repro_torch.core import masks as M
    x = torch.from_numpy(batch["images"])
    for tree in trees:
        logits = tmodel.forward(tparams, M.as_device(tree, "cpu"), x)
        top2 = logits.topk(2, dim=-1).values
        margin = float((top2[..., 0] - top2[..., 1]).min())
        assert margin > MARGIN, f"top-2 logit margin {margin} too small"


@pytest.mark.parametrize("adt", [0.5, -1.0])
@pytest.mark.parametrize("moves", [("remove",), ("remove", "stage_drop")])
def test_run_bcd_all_backends_select_the_references_blocks(setup, adt,
                                                           moves):
    from repro_torch.core import bcd as B, masks as M
    ref, rmodel, rparams, tmodel, tparams, batch, masks0 = setup
    total = M.count(masks0)
    kw = dict(b_target=total - 3 * 16, drc=16, rt=8, adt=adt,
              finetune_every_step=False, seed=3, chunk_size=3, moves=moves)
    want = ref.bcd.run_bcd(
        masks0, ref.bcd.BCDConfig(**kw), rmodel.make_eval_acc(rparams, batch),
        evaluator=_ref_evaluator(ref, "batched", rmodel, rparams, batch, 3),
        keep_snapshots=True)
    _assert_margins(tmodel, tparams, batch, [masks0] + want.mask_snapshots)
    results = {}
    for backend in ("sequential", "batched", "pipelined", "suffix"):
        ev, eval_acc, _ = _port_evaluator(backend, tmodel, tparams, batch,
                                          3, 8, prefetch=2)
        assert ev.name == backend
        results[backend] = B.run_bcd(masks0, B.BCDConfig(**kw), eval_acc,
                                     evaluator=ev)
    want_logs = _logs(want.history)
    for backend, got in results.items():
        assert M.fingerprint(got.masks) == ref.masks.fingerprint(want.masks),\
            backend
        got_logs = _logs(got.history)
        assert len(got_logs) == len(want_logs)
        for g, w in zip(got_logs, want_logs):
            for key in ("step", "budget_before", "budget_after", "trials",
                        "found_early", "move_kind"):
                assert g[key] == w[key], (backend, key)
            # multiples of 100/64, exact in float32: equal, not just close
            assert g["acc_before"] == w["acc_before"], backend
            assert g["best_drop"] == w["best_drop"], backend
    assert M.relu_cost(results["suffix"].masks) == kw["b_target"]


def test_candidate_accuracies_match_reference_per_candidate(setup):
    """One chunk of candidates through every backend of both packages:
    identical accuracy vectors (ragged chunk: 5 candidates, pad_to 8)."""
    from repro_torch.core import engine as E, masks as M
    ref, rmodel, rparams, tmodel, tparams, batch, masks0 = setup
    idx = M.sample_removal_indices(np.random.default_rng(1), masks0, 200, 5)
    stacked = M.materialize_candidates(masks0, idx)
    _assert_margins(tmodel, tparams, batch,
                    [M.index_stacked(stacked, i) for i in range(5)])
    want = _ref_evaluator(ref, "batched", rmodel, rparams, batch, 8
                          ).evaluate(stacked)
    assert want.shape == (5,) and want.dtype == np.float64
    for backend in ("sequential", "batched", "pipelined", "suffix"):
        ev, _, _ = _port_evaluator(backend, tmodel, tparams, batch, 8, 8)
        got = ev.evaluate(stacked)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want, err_msg=backend)
    # the sited path, fused and unfused, at a deep and a shallow cut
    for fused in (False, True):
        ev, _, _ = _port_evaluator("suffix", tmodel, tparams, batch, 8, 8,
                                   fused_kernels=fused)
        for site in (tmodel.site_order()[-1], tmodel.site_order()[2]):
            idx = M.sample_removal_indices_within(
                np.random.default_rng(2), masks0, 60, 5, [site])
            st = M.materialize_candidates(masks0, idx)
            ev.begin_step(masks0)
            got = ev.evaluate(E.SitedChunk(site, st))
            want = _ref_evaluator(ref, "batched", rmodel, rparams, batch, 8
                                  ).evaluate(st)
            np.testing.assert_array_equal(got, want)


def test_share_ties_run_unfused_and_match_reference(setup):
    """A chunk whose masks carry share ties: the host flag routes it through
    the tie override (and off the fused kernels) and the accuracies equal the
    reference's."""
    from repro_torch.core import engine as E, masks as M
    ref, rmodel, rparams, tmodel, tparams, batch, masks0 = setup
    rng = np.random.default_rng(4)
    moves = M.sample_moves(rng, masks0, 300, 4, kinds=("share",))
    flat, layout = M._flatten(masks0)
    stacked = M.materialize_moves_from_flat(flat, layout, moves)
    assert any(M.tied_count(M.index_stacked(stacked, i)) for i in range(4))
    want = _ref_evaluator(ref, "batched", rmodel, rparams, batch, 4
                          ).evaluate(stacked)
    for backend in ("sequential", "batched", "suffix"):
        ev, _, _ = _port_evaluator(backend, tmodel, tparams, batch, 4, 4)
        np.testing.assert_array_equal(ev.evaluate(stacked), want)
    ev, _, _ = _port_evaluator("suffix", tmodel, tparams, batch, 4, 4)
    ev.begin_step(masks0)
    site = tmodel.site_order()[0]
    np.testing.assert_array_equal(
        ev.evaluate(E.SitedChunk(site, stacked)), want)


def test_trie_counters_match_reference_on_the_same_plan(setup):
    """The same sequence of sited chunks and base-mask edits through both
    suffix engines: hits / extensions / misses / evictions and the resident
    depths agree step by step."""
    from repro_torch.core import engine as E, masks as M
    ref, rmodel, rparams, tmodel, tparams, batch, masks0 = setup
    order, segs = tmodel.site_order(), tmodel.site_segments()
    deep = order[-1]
    mid = max((s for s in order if segs[s] < segs[deep]),
              key=lambda s: segs[s])
    shallow = order[1]
    one = E.tree_nbytes(tmodel.forward_prefix(
        tparams, M.as_device(masks0, "cpu"),
        torch.from_numpy(batch["images"]), mid))
    for budget in (None, one):
        tev, _, _ = _port_evaluator("suffix", tmodel, tparams, batch, 4, 4,
                                    prefetch=0)
        tev.trie.budget_bytes = budget
        rev = _ref_evaluator(ref, "suffix", rmodel, rparams, batch, 4,
                             trie_budget_bytes=budget)
        edited = {k: np.array(v) for k, v in masks0.items()}
        edited[mid].flat[0] = 0.0
        rng = np.random.default_rng(0)
        plan = [("begin", masks0), ("chunk", shallow), ("chunk", mid),
                ("chunk", deep), ("chunk", mid), ("begin", masks0),
                ("chunk", deep), ("begin", edited), ("chunk", deep),
                ("chunk", mid)]
        base = masks0
        for op, arg in plan:
            if op == "begin":
                base = arg
                tev.begin_step(arg)
                rev.begin_step(arg)
            else:
                idx = M.sample_removal_indices_within(rng, base, 16, 4, [arg])
                st = M.materialize_candidates(base, idx)
                got = tev.evaluate(E.SitedChunk(arg, st))
                want = rev.evaluate(ref.engine.SitedChunk(arg, st))
                np.testing.assert_array_equal(got, want)
            t, r = tev.trie, rev.trie
            assert (t.hits, t.extensions, t.misses, t.evictions) == \
                (r.hits, r.extensions, r.misses, r.evictions), (op, arg)
            assert t.depths() == r.depths()
            assert tev.covered_fraction(deep) == rev.covered_fraction(deep)
        assert tev.trie.misses >= 1 and tev.trie.extensions >= 1
        assert (tev.trie.hits >= 1) == (budget is None)
        assert (tev.trie.evictions > 0) == (budget is not None)


def test_plan_sited_chunks_matches_reference(setup):
    from repro_torch.core import engine as E, masks as M
    ref, rmodel, rparams, tmodel, tparams, batch, masks0 = setup
    tev, _, _ = _port_evaluator("suffix", tmodel, tparams, batch, 3, 12)
    rev = _ref_evaluator(ref, "suffix", rmodel, rparams, batch, 3)
    tev.begin_step(masks0)
    rev.begin_step(masks0)
    moves = M.sample_moves(np.random.default_rng(8), masks0, 20, 12,
                           kinds=("remove", "stage_drop"), max_remove=60)
    rmoves = ref.masks.sample_moves(np.random.default_rng(8), masks0, 20, 12,
                                    kinds=("remove", "stage_drop"),
                                    max_remove=60)
    _, layout = M._flatten(masks0)
    order_t, chunks_t = E.plan_sited_chunks(tev, moves, layout, 3)
    order_r, chunks_r = ref.engine.plan_sited_chunks(rev, rmoves, layout, 3)
    np.testing.assert_array_equal(order_t, order_r)
    assert chunks_t == chunks_r
    assert any(site is not None for site, _, _ in chunks_t)
    idx = M.sample_removal_indices(np.random.default_rng(8), masks0, 5, 7)
    order_t, chunks_t = E.plan_sited_chunks(tev, idx, layout, 3)
    order_r, chunks_r = ref.engine.plan_sited_chunks(rev, idx, layout, 3)
    np.testing.assert_array_equal(order_t, order_r)
    assert chunks_t == chunks_r
    flat, _ = M._flatten(masks0)
    for (site, s, e), ch in zip(chunks_t, E.materialize_sited(
            flat, layout, idx, order_t, chunks_t)):
        assert ch.site == site and M.stacked_len(ch.stacked) == e - s


@pytest.mark.parametrize("adt", [0.5, -1.0])
def test_scan_sited_matches_reference(setup, adt):
    """``bcd._scan_sited`` (site-major evaluation, sampling-order selection
    replay) through each package's own suffix engine: same winner, drop,
    trial count and early-exit flag for the same pre-sampled moves."""
    from repro_torch.core import bcd as B, masks as M
    ref, rmodel, rparams, tmodel, tparams, batch, masks0 = setup
    kw = dict(b_target=0, drc=16, rt=12, adt=adt, seed=0, chunk_size=3,
              moves=("remove", "stage_drop"))
    moves = M.sample_moves(np.random.default_rng(5), masks0, 16, 12,
                           kinds=kw["moves"], max_remove=48)
    rmoves = ref.masks.sample_moves(np.random.default_rng(5), masks0, 16, 12,
                                    kinds=kw["moves"], max_remove=48)
    flat, layout = M._flatten(masks0)
    tev, eval_acc, _ = _port_evaluator("suffix", tmodel, tparams, batch,
                                       3, 12, prefetch=1)
    rev = _ref_evaluator(ref, "suffix", rmodel, rparams, batch, 3,
                         prefetch=1)
    base = eval_acc(masks0)
    assert base == rmodel.make_eval_acc(rparams, batch)(masks0)
    got = B._scan_sited(masks0, B.BCDConfig(**kw), tev, flat, layout, moves,
                        3, base)
    want = ref.bcd._scan_sited(masks0, ref.bcd.BCDConfig(**kw), rev, flat,
                               layout, rmoves, 3, base)
    assert got == want
    assert tev.trie.misses + tev.trie.extensions >= 1
    t, r = tev.trie, rev.trie
    assert (t.hits, t.extensions, t.misses) == \
        (r.hits, r.extensions, r.misses)


def test_set_context_swaps_params_and_clears_the_trie(setup):
    from repro_torch.core import engine as E, masks as M
    ref, rmodel, rparams, tmodel, tparams, batch, masks0 = setup
    deep = tmodel.site_order()[-1]
    idx = M.sample_removal_indices_within(
        np.random.default_rng(0), masks0, 16, 4, [deep])
    st = M.materialize_candidates(masks0, idx)
    for backend in ("batched", "pipelined", "suffix"):
        ev, eval_acc, set_ctx = _port_evaluator(backend, tmodel, tparams,
                                                batch, 4, 4)
        if backend == "suffix":
            ev.begin_step(masks0)
            a = ev.evaluate(E.SitedChunk(deep, st))
            assert len(ev.trie) and "pre" in ev.context
        else:
            a = ev.evaluate(st)
        flipped = {k: ({kk: -vv for kk, vv in v.items()} if k == "fc"
                       else v) for k, v in tparams.items()}
        set_ctx(flipped)
        if backend == "suffix":
            assert len(ev.trie) == 0
            b = ev.evaluate(E.SitedChunk(deep, st))
        else:
            b = ev.evaluate(st)
        assert not np.array_equal(a, b), backend
    with pytest.raises(ValueError, match="without a context"):
        E.BatchedEvaluator(lambda m, ties=True: None, device="cpu"
                           ).set_context({})


def test_evaluator_validation_and_protocol(setup):
    from repro_torch.core import engine as E
    ref, rmodel, rparams, tmodel, tparams, batch, masks0 = setup
    split = tmodel.make_suffix_eval_fns()
    with pytest.raises(ValueError, match="needs context"):
        E.make_evaluator("suffix", split=split, context=None, device="cpu")
    with pytest.raises(ValueError, match="needs split"):
        E.make_evaluator("suffix", context={}, device="cpu")
    with pytest.raises(ValueError, match="needs eval_acc"):
        E.make_evaluator("sequential")
    with pytest.raises(ValueError, match="needs a device eval_fn"):
        E.make_evaluator("batched", device="cpu")
    with pytest.raises(ValueError, match="prefetch='auto'"):
        E.make_evaluator("batched", eval_fn=lambda m: m, prefetch="auto")
    with pytest.raises(ValueError, match="prefetch must be"):
        E.PipelinedEvaluator(lambda m: m, prefetch=-1, device="cpu")
    with pytest.raises(ValueError, match="prefetch must be"):
        E.PipelinedEvaluator(lambda m: m, prefetch="fast", device="cpu")
    ev, _, _ = _port_evaluator("suffix", tmodel, tparams, batch, 4, 4)
    with pytest.raises(RuntimeError, match="begin_step"):
        ev.evaluate(E.SitedChunk(tmodel.site_order()[-1],
                                 {k: v[None] for k, v in masks0.items()}))
    for backend in ("sequential", "batched", "pipelined", "suffix"):
        ev, _, _ = _port_evaluator(backend, tmodel, tparams, batch, 4, 4)
        assert isinstance(ev, E.CandidateEvaluator)
    seq, _, _ = _port_evaluator("sequential", tmodel, tparams, batch, 4, 4)
    assert E.effective_chunk(seq, 8) == 1
    assert E.effective_chunk(ev, 8) == 8
    assert E.tree_nbytes({"a": torch.zeros(3, 2), "b": [np.zeros(5)]}) == \
        24 + 40


def test_prefetch_auto_tunes_and_matches_sequential(setup):
    from repro_torch.core import bcd as B, engine as E, masks as M
    ref, rmodel, rparams, tmodel, tparams, batch, masks0 = setup
    kw = dict(b_target=M.count(masks0) - 32, drc=16, rt=10, adt=-1.0,
              finetune_every_step=False, seed=1, chunk_size=2)
    seq, eval_acc, _ = _port_evaluator("sequential", tmodel, tparams, batch,
                                       2, 10)
    want = B.run_bcd(masks0, B.BCDConfig(**kw), eval_acc, evaluator=seq)
    for backend in ("pipelined", "suffix"):
        ev, eval_acc, _ = _port_evaluator(backend, tmodel, tparams, batch,
                                          2, 10, prefetch="auto")
        assert ev.auto_tuner is not None and ev.prefetch_depth == 0
        got = B.run_bcd(masks0, B.BCDConfig(**kw), eval_acc, evaluator=ev)
        assert M.fingerprint(got.masks) == M.fingerprint(want.masks)
        assert ev.auto_tuner.done and 1 <= ev.prefetch_depth <= 4
        assert ev.auto_report["prefetch"] == ev.prefetch_depth
    # the tuner's arithmetic is the reference's
    tt, rt_ = E.PrefetchAutoTuner(2, 4), ref.engine.PrefetchAutoTuner(2, 4)
    for p, c in [(9.0, 9.0), (0.010, 0.035), (0.012, 0.031), (1.0, 1.0)]:
        tt.add_sample(p, c)
        rt_.add_sample(p, c)
    assert tt.done and tt.depth() == rt_.depth() == 3
    assert tt.report() == rt_.report()


@pytest.mark.parametrize("budget", [None, 0, 100, 250])
def test_prefix_trie_matches_reference_under_random_ops(budget):
    from repro_torch.core.engine import PrefixTrie
    ref = reference()
    rng = np.random.default_rng(0 if budget is None else budget)
    t, r = PrefixTrie(budget), ref.engine.PrefixTrie(budget)
    for _ in range(300):
        op = rng.integers(0, 4)
        d = int(rng.integers(0, 8))
        if op == 0:
            nb = int(rng.integers(10, 120))
            t.insert(d, ("x", d), nbytes=nb)
            r.insert(d, ("x", d), nbytes=nb)
        elif op == 1:
            assert t.lookup(d) == r.lookup(d)
        elif op == 2:
            t.keep_where(lambda k: k <= d)
            r.keep_where(lambda k: k <= d)
        elif rng.random() < 0.1:
            t.clear()
            r.clear()
        assert t.depths() == r.depths()
        assert t.total_bytes() == r.total_bytes()
        assert t.evictions == r.evictions and len(t) == len(r)
        assert (d in t) == (d in r)
        if budget is not None:
            assert t.total_bytes() <= budget
    with pytest.raises(ValueError):
        PrefixTrie(-1)


def test_suffix_cost_model_matches_reference():
    from repro_torch.analysis.roofline import SuffixCostModel
    ref = reference()
    R = ref.roofline.SuffixCostModel
    measured = ((0.2, 1.1, 4), (0.6, 2.0, 8))
    for kw in (dict(), dict(min_prefix_fraction=0.3, min_chunk=3),
               dict(measured=measured), dict(measured=measured,
                                             min_speedup=1.5)):
        t, r = SuffixCostModel(**kw), R(**kw)
        for f in (0.0, 0.04, 0.05, 0.3, 0.61, 0.95, 1.0):
            for n in (1, 2, 3, 8):
                for c in (0.0, 0.2, 0.9):
                    assert t.speedup(f, n, c) == r.speedup(f, n, c)
                    assert t.predicted_speedup(f, n, c) == \
                        r.predicted_speedup(f, n, c)
                    assert t.use_suffix(f, n, c) == r.use_suffix(f, n, c)

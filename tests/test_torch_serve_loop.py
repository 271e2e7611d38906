"""The port's continuous-batching scheduler (``repro_torch.launch.serve_loop``)
on the CPU: the reference's ``tests/test_serve_loop.py`` cases on the
port's ``ServeLoop``, and the port's loop against the reference's.

The cases of the reference run on a reduced StableLM with the port's own
random weights.  The parity cases convert the reference's parameters
(``repro_torch.convert.params_from_reference``) and drive both packages'
loops with the same prompts under ``VirtualClock`` + ``default_chaos_plan``
+ ``queue_cap`` + a degradation ladder + deadlines: the decision logs (and
their ``decisions_fingerprint``), every request's state, tokens and bill
must be equal.  Decisions under a virtual clock depend on the mask sets' PI
costs, the fault plan's draws and the requests' lengths, never on the host
clock or the token values, so they must match exactly; the tokens are
greedy argmaxes of logits that agree to ~1e-6.
"""
import numpy as np
import pytest
import torch

from test_torch_helpers import reference, to_numpy_tree, tree_leaves


@pytest.fixture(scope="module")
def served():
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_loop
    from repro_torch.models.lm import LM
    cfg = get_config("stablelm_1p6b").reduced()
    model = LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    store = serve_loop.threshold_mask_sets(model, [1.0, 0.25], seed=0,
                                           device="cpu")
    return cfg, model, params, store


def _loop(served, max_new=3, slots=2, max_len=32, bucket=8, classes=None):
    from repro_torch.launch import serve_loop
    cfg, model, params, store = served
    classes = classes or [
        serve_loop.SLOClass("premium", store.names[0], max_new),
        serve_loop.SLOClass("economy", store.names[1], max_new)]
    return serve_loop.ServeLoop(model, params, store, classes,
                                slots=slots, max_len=max_len,
                                prompt_bucket=bucket, device="cpu")


def _submit_n(loop, cfg, n, seed=0, classes=("premium", "economy")):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(2, 12))
        reqs.append(loop.submit(rng.integers(0, cfg.vocab, plen),
                                classes[i % len(classes)]))
    return reqs


# ------------------------------------------- the reference's cases

def test_drains_and_measures_two_classes(served):
    cfg = served[0]
    loop = _loop(served)
    reqs = _submit_n(loop, cfg, 6)
    loop.shutdown(drain=True)
    assert loop.pending() == 0
    assert len(loop.completed) == 6
    for r in reqs:
        assert not r.cancelled
        assert len(r.tokens) == 3
        assert r.t_arrival <= r.t_admit <= r.t_first <= r.t_done
        assert r.queue_s >= 0 and r.prefill_s > 0 and r.decode_s > 0
    stats = loop.stats()
    for name in ("premium", "economy"):
        c = stats["classes"][name]
        assert c["requests"] == 3
        assert c["decode_tok_s"] > 0
        for key in ("queue", "prefill", "decode", "total"):
            assert c[f"{key}_ms_p50"] <= c[f"{key}_ms_p95"]
    assert stats["classes"]["premium"]["relu_cost"] > \
        stats["classes"]["economy"]["relu_cost"]


def test_fifo_admission_per_class(served):
    cfg = served[0]
    loop = _loop(served, slots=1)          # force queueing
    reqs = _submit_n(loop, cfg, 4, classes=("premium",))
    loop.shutdown(drain=True)
    admits = [r.t_admit for r in reqs]
    assert admits == sorted(admits)
    assert reqs[-1].queue_s > reqs[0].queue_s


def test_billing_is_pi_cost_of_served_mask_set(served):
    from repro_torch.core import pi_cost
    cfg, model, params, store = served
    loop = _loop(served, max_new=4)
    reqs = _submit_n(loop, cfg, 4)
    loop.shutdown(drain=True)
    n_sites = len(store.site_shapes)
    for r in reqs:
        info = store.info(loop.lanes[r.slo].slo.mask_set)
        assert r.mask_set == info.name
        assert r.mask_fingerprint == info.fingerprint
        tokens = len(r.prompt) + len(r.tokens)
        want = pi_cost.bill_request(info.relu_cost, n_sites, tokens=tokens,
                                    mask_set=info.name,
                                    fingerprint=info.fingerprint)
        assert r.bill == want
        per_tok = pi_cost.cost_of_masks(store.host(r.mask_set), n_sites)
        assert r.bill["relus_billed"] == info.relu_cost * tokens
        assert r.bill["pi_online_s"] == pytest.approx(
            per_tok.online_latency_s * tokens)


def test_stream_invariant_to_neighbors(served):
    """The same prompt yields bitwise the same tokens whether it shares
    the lane with other requests or runs alone."""
    cfg = served[0]
    prompt = np.arange(1, 8) % cfg.vocab
    solo = _loop(served, max_new=4)
    r_solo = solo.submit(prompt, "premium")
    solo.shutdown(drain=True)
    busy = _loop(served, max_new=4)
    rng = np.random.default_rng(7)
    busy.submit(rng.integers(0, cfg.vocab, 5), "premium")
    r_busy = busy.submit(prompt, "premium")
    busy.submit(rng.integers(0, cfg.vocab, 9), "economy")
    busy.shutdown(drain=True)
    assert r_busy.tokens == r_solo.tokens


def test_shutdown_without_drain_cancels(served):
    cfg = served[0]
    loop = _loop(served, slots=1)
    reqs = _submit_n(loop, cfg, 3, classes=("premium",))
    loop.step()                            # admit one, leave two queued
    done = loop.shutdown(drain=False)
    assert loop.pending() == 0
    cancelled = [r for r in reqs if r.cancelled]
    assert cancelled and all(r.bill is None for r in cancelled)
    assert all(not r.cancelled and r.bill for r in done)
    with pytest.raises(RuntimeError, match="shut down"):
        loop.submit(np.array([1, 2]), "premium")


def test_validation_errors_are_loud(served):
    from repro_torch.launch import serve_loop
    from repro_torch.training import serve as serve_lib
    cfg, model, params, store = served
    with pytest.raises(serve_lib.MaskSetError, match="routes to mask set"):
        serve_loop.ServeLoop(model, params, store,
                             [serve_loop.SLOClass("x", "nope", 2)],
                             device="cpu")
    with pytest.raises(ValueError, match="at least one SLO"):
        serve_loop.ServeLoop(model, params, store, [], device="cpu")
    with pytest.raises(ValueError, match="queue_cap"):
        serve_loop.ServeLoop(model, params, store,
                             serve_loop.default_classes(store),
                             queue_cap=0, device="cpu")
    loop = _loop(served)
    with pytest.raises(KeyError, match="unknown SLO"):
        loop.submit(np.array([1]), "gold")
    with pytest.raises(ValueError, match="prompt length"):
        loop.submit(np.zeros(100, np.int32), "premium")
    with pytest.raises(ValueError, match="prompt length"):
        loop.submit(np.zeros(0, np.int32), "premium")


def _wan():
    """Bandwidth-bound protocol: per-token cost scales with ReLU count, so
    the kf100/kf025 latency spread is ~4x and deadlines discriminate."""
    from repro_torch.core import pi_cost
    return pi_cost.PIProtocol(bandwidth_bytes_per_s=12.5e6, rtt_s=0.0)


def _deadline_loop(served, deadline_ms, *, ladder=False, queue_cap=None,
                   max_new=3):
    from repro_torch.launch import faults, serve_loop
    cfg, model, params, store = served
    classes = [
        serve_loop.SLOClass("premium", store.names[0], max_new,
                            deadline_ms=deadline_ms, priority=1),
        serve_loop.SLOClass("economy", store.names[1], max_new,
                            deadline_ms=None)]
    lad = serve_loop.DegradationLadder.from_store(store) if ladder else None
    clock = faults.VirtualClock()
    loop = serve_loop.ServeLoop(model, params, store, classes, slots=2,
                                max_len=32, prompt_bucket=8, ladder=lad,
                                queue_cap=queue_cap, clock=clock,
                                proto=_wan(), device="cpu")
    return loop, clock


def test_generous_deadline_is_served_and_hit(served):
    loop, _ = _deadline_loop(served, deadline_ms=5000.0)
    req = loop.submit(np.arange(1, 6), "premium")
    loop.shutdown(drain=True)
    assert req.state == "served" and req.deadline_hit
    stats = loop.stats()
    assert stats["classes"]["premium"]["deadline_hit_rate"] == 1.0
    assert stats["deadline_hit_rate"] == 1.0
    assert stats["goodput_tok_s"] > 0


def test_unmeetable_deadline_sheds_before_prefill(served):
    loop, _ = _deadline_loop(served, deadline_ms=150.0)
    est = loop.latency.estimate_s(loop.store.names[0], 5, 3)
    assert est > 0.150                       # premise of the test
    req = loop.submit(np.arange(1, 6), "premium")
    loop.shutdown(drain=True)
    assert req.state == "shed"
    assert req.shed_reason == "deadline_unmeetable"
    assert req.bill is None and req.tokens == []
    assert loop.decision_log[-1]["decision"] == "shed"


def test_degradation_ladder_reroutes_and_bills_cheaper_set(served):
    from repro_torch.core import pi_cost
    cfg, model, params, store = served
    loop, _ = _deadline_loop(served, deadline_ms=150.0, ladder=True)
    req = loop.submit(np.arange(1, 6), "premium")
    loop.shutdown(drain=True)
    assert req.state == "degraded" and req.deadline_hit
    assert req.degraded_from == store.names[0]
    assert req.mask_set == store.names[1]
    info = store.info(store.names[1])
    tokens = len(req.prompt) + len(req.tokens)
    assert req.bill == pi_cost.bill_request(
        info.relu_cost, len(store.site_shapes), tokens=tokens,
        proto=_wan(), mask_set=info.name, fingerprint=info.fingerprint,
        degraded_from=store.names[0])
    assert loop.stats()["degrade_rate"] == 1.0
    decisions = [d["decision"] for d in loop.decision_log
                 if d["rid"] == req.rid]
    assert decisions == ["degrade", "admit"]


def test_expired_request_cancelled_unbilled(served):
    loop, clock = _deadline_loop(served, deadline_ms=100.0)
    req = loop.submit(np.arange(1, 6), "premium")
    clock.advance(1.0)                       # deadline passes in the queue
    loop.shutdown(drain=True)
    assert req.state == "shed" and req.cancelled
    assert req.shed_reason == "deadline_expired"
    assert req.bill is None and req.tokens == []


def test_bounded_queue_sheds_overflow(served):
    loop, _ = _deadline_loop(served, deadline_ms=None, queue_cap=2)
    reqs = [loop.submit(np.arange(1, 6), "premium") for _ in range(4)]
    assert [r.state for r in reqs] == ["queued", "queued", "shed", "shed"]
    assert all(r.shed_reason == "queue_full" for r in reqs[2:])
    loop.shutdown(drain=True)
    assert loop.stats()["terminal"] == 4
    assert loop.stats()["classes"]["premium"]["shed_reasons"] == \
        {"queue_full": 2}


def test_edf_orders_admission_by_deadline_then_priority(served):
    from repro_torch.launch import faults, serve_loop
    cfg, model, params, store = served
    classes = [
        serve_loop.SLOClass("premium", store.names[0], 2,
                            deadline_ms=60000.0),
        serve_loop.SLOClass("rush", store.names[0], 2, deadline_ms=500.0)]
    loop = serve_loop.ServeLoop(model, params, store, classes, slots=1,
                                max_len=32, prompt_bucket=8,
                                clock=faults.VirtualClock(), proto=_wan(),
                                device="cpu")
    relaxed = loop.submit(np.arange(1, 6), "premium")
    rush = loop.submit(np.arange(1, 6), "rush")
    lane = loop.lanes["premium"]
    later_tight = serve_loop.Request(rid=99, slo="premium",
                                     prompt=np.arange(1, 4), max_new=2,
                                     deadline_s=0.1)
    lane.push(later_tight)
    assert lane.pop() is later_tight         # EDF beats FIFO order
    assert lane.pop() is relaxed
    assert rush.state == "queued"


def test_ladder_validation_is_loud(served):
    from repro_torch.launch import serve_loop
    cfg, model, params, store = served
    with pytest.raises(ValueError, match="not in the mask-set store"):
        serve_loop.DegradationLadder(("nope",)).validate(store)
    with pytest.raises(ValueError, match="strictly descending"):
        serve_loop.DegradationLadder(
            (store.names[1], store.names[0])).validate(store)
    lad = serve_loop.DegradationLadder.from_store(store)
    assert lad.rungs == (store.names[0], store.names[1])
    assert lad.below(store, store.names[0]) == (store.names[1],)
    assert lad.below(store, store.names[1]) == ()


def test_recurrent_family_requires_exact_prefill():
    """Bucketed prefill is refused for RWKV-6 (its state would run through
    the pad positions); exact-length prefill serves."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_loop
    from repro_torch.models.lm import LM
    cfg = get_config("rwkv6_3b").reduced()
    model = LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    store = serve_loop.threshold_mask_sets(model, [1.0], seed=0,
                                           device="cpu")
    classes = [serve_loop.SLOClass("only", store.names[0], 2)]
    with pytest.raises(ValueError, match=r"prompt_bucket=None"):
        serve_loop.ServeLoop(model, params, store, classes, slots=1,
                             max_len=24, prompt_bucket=16, device="cpu")
    loop = serve_loop.ServeLoop(model, params, store, classes, slots=1,
                                max_len=24, prompt_bucket=None, device="cpu")
    req = loop.submit(np.arange(1, 7) % cfg.vocab, "only")
    loop.shutdown(drain=True)
    assert req.state == "served" and len(req.tokens) == 2


def test_no_drain_leaves_no_poisoned_state(served):
    cfg = served[0]
    prompt = np.arange(1, 8) % cfg.vocab
    before = _loop(served, max_new=4)
    want = before.submit(prompt, "premium")
    before.shutdown(drain=True)
    victim = _loop(served, max_new=4, slots=1)
    reqs = _submit_n(victim, cfg, 3, classes=("premium",))
    victim.step()                            # one live, two queued
    victim.shutdown(drain=False)
    assert all(r.state == "cancelled" for r in reqs)
    assert all(r.bill is None for r in reqs)
    for lane in victim.lanes.values():       # lanes fully released
        assert not lane.live.any()
        assert all(r is None for r in lane.reqs)
        assert not lane.heap and not lane.cache_len.any()
    after = _loop(served, max_new=4)
    got = after.submit(prompt, "premium")
    after.shutdown(drain=True)
    assert got.tokens == want.tokens


# ------------------------------------------- the port's own properties

def test_lanes_never_share_a_cache_tensor(served):
    loop = _loop(served)
    ptrs = {}
    for name, lane in loop.lanes.items():
        for t in tree_leaves(lane.cache):
            ptrs.setdefault(t.data_ptr(), []).append(name)
    for t in tree_leaves(loop._small):
        ptrs.setdefault(t.data_ptr(), []).append("prefill")
    assert all(len(v) == 1 for v in ptrs.values())


def test_kept_logits_agree_with_the_uncached_forward(served):
    """``keep_logits``: each served token is the argmax of the logits the
    loop kept, and those logits are the uncached forward's of the prompt
    plus the tokens before it."""
    cfg, model, params, store = served
    from repro_torch.launch import serve_loop
    classes = [serve_loop.SLOClass("premium", store.names[0], 5),
               serve_loop.SLOClass("economy", store.names[1], 5)]
    loop = serve_loop.ServeLoop(model, params, store, classes, slots=2,
                                max_len=32, prompt_bucket=8, device="cpu",
                                keep_logits=True)
    reqs = _submit_n(loop, cfg, 6, seed=3)
    loop.shutdown(drain=True)
    for r in reqs:
        masks = store.select(r.mask_set)
        seq = torch.from_numpy(np.concatenate([r.prompt, r.tokens[:-1]])
                               .astype(np.int64))[None]
        full = model.forward(params, masks, seq)[0, len(r.prompt) - 1:]
        kept = torch.stack(r.logits)
        assert kept.shape == full.shape
        np.testing.assert_allclose(kept.numpy(), full.numpy(), rtol=0,
                                   atol=1e-4)
        assert kept.argmax(-1).tolist() == r.tokens


def test_host_clock_is_read_only_without_a_virtual_clock(served,
                                                         monkeypatch):
    """Under a VirtualClock nothing on the serving path reads the host's
    clock."""
    import time
    from repro_torch.launch import faults

    def boom():
        raise AssertionError("host clock read under a virtual clock")
    monkeypatch.setattr(time, "perf_counter", boom)
    monkeypatch.setattr(time, "time", boom)
    monkeypatch.setattr(time, "monotonic", boom)
    loop, _ = _deadline_loop(served, deadline_ms=900.0, ladder=True,
                             queue_cap=2)
    loop.fault_plan = faults.default_chaos_plan(5)
    _submit_n(loop, served[0], 6)
    loop.shutdown(drain=True)
    assert loop.stats()["terminal"] == 6


# ------------------------------------------- against the reference's loop

def _parity_loops(arch, bucket, classes_of, submit, **kw):
    """The reference's loop and the port's over the same converted
    parameters and synthetic budgets; ``submit(loop, step)`` feeds both."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch import faults, serve_loop
    from repro_torch.models.lm import LM
    ref = reference()
    rmodel = ref.lm.LM(ref.configs.get_config(arch).reduced())
    tmodel = LM(get_config(arch).reduced())
    rparams = rmodel.init(ref.jax.random.PRNGKey(0))
    tparams = convert.params_from_reference(to_numpy_tree(rparams), "cpu")
    out = []
    for sl, fl, model, params, dev in (
            (ref.serve_loop, ref.faults, rmodel, rparams, {}),
            (serve_loop, faults, tmodel, tparams, {"device": "cpu"})):
        store = sl.threshold_mask_sets(model, [1.0, 0.25], seed=0, **dev)
        loop = sl.ServeLoop(
            model, params, store, classes_of(sl, store), prompt_bucket=bucket,
            ladder=sl.DegradationLadder.from_store(store),
            clock=fl.VirtualClock(), fault_plan=fl.default_chaos_plan(5),
            **kw, **dev)
        reqs = submit(loop)
        loop.shutdown(drain=True)
        out.append((loop, reqs))
    return out


def _assert_same_service(a, b):
    (rloop, rreqs), (tloop, treqs) = a, b
    assert tloop.decision_log == rloop.decision_log
    from repro_torch.launch import serve_loop
    assert serve_loop.decisions_fingerprint(tloop.decision_log) == \
        reference().serve_loop.decisions_fingerprint(rloop.decision_log)
    assert tloop.stats()["decisions_sha256"] == \
        rloop.stats()["decisions_sha256"]
    assert [r.state for r in treqs] == [r.state for r in rreqs]
    assert [r.shed_reason for r in treqs] == [r.shed_reason for r in rreqs]
    assert [r.tokens for r in treqs] == [r.tokens for r in rreqs]
    assert [r.bill for r in treqs] == [r.bill for r in rreqs]
    for key in ("t_arrival", "t_admit", "t_first", "t_done"):
        assert [getattr(r, key) for r in treqs] == \
            [getattr(r, key) for r in rreqs]
    assert tloop.fault_stats == rloop.fault_stats
    assert tloop.fault_plan.stats() == rloop.fault_plan.stats()


def test_chaos_drill_equals_reference_stablelm():
    """Reduced StableLM under the chaos plan, a queue bound of 4, the
    ladder and deadlines on both classes: admit, degrade and shed all
    occur, and both packages decide, serve and bill alike."""
    def classes(sl, store):
        return [sl.SLOClass("premium", store.names[0], 4, deadline_ms=900.0,
                            priority=1),
                sl.SLOClass("economy", store.names[1], 4,
                            deadline_ms=2500.0)]

    def submit(loop):
        rng = np.random.default_rng(9)
        reqs = []
        for i in range(16):
            reqs.append(loop.submit(
                rng.integers(0, 128, int(rng.integers(2, 20))),
                ("premium", "economy")[i % 2]))
            if i % 3 == 2:
                loop.step()
        return reqs
    a, b = _parity_loops("stablelm_1p6b", 8, classes, submit, slots=2,
                         max_len=32, queue_cap=4)
    _assert_same_service(a, b)
    seen = {d["decision"] for d in b[0].decision_log}
    assert seen == {"admit", "degrade", "shed"}
    reasons = {d.get("reason") for d in b[0].decision_log} - {None}
    assert {"queue_full", "deadline_unmeetable"} <= reasons
    assert set(b[0].fault_stats) == {"prefill", "decode", "fingerprint"}


def test_exact_length_serving_equals_reference_rwkv():
    """Reduced RWKV-6 with exact-length prefill (``prompt_bucket=None``),
    prompts of 3 to 20 tokens, under the same chaos plan."""
    def classes(sl, store):
        return [sl.SLOClass("premium", store.names[0], 3),
                sl.SLOClass("economy", store.names[1], 3)]

    def submit(loop):
        rng = np.random.default_rng(4)
        return [loop.submit(rng.integers(0, 128, int(rng.integers(3, 21))),
                            ("premium", "economy")[i % 2])
                for i in range(6)]
    a, b = _parity_loops("rwkv6_3b", None, classes, submit, slots=2,
                         max_len=32)
    _assert_same_service(a, b)
    assert all(r.state in ("served", "degraded") for r in b[1])

"""The port's fault injection (``repro_torch.launch.faults``) against the
JAX package's, on the CPU.

The module is a copy of pure numpy code, so its pure cases are held to the
reference bit for bit: the same ``(specs, seed)`` draws the same faults in
both packages, and the corrupted fingerprint is the same string.  The
reference's loop-integration cases (``tests/test_faults.py``) run on the
port's ``ServeLoop`` over a reduced StableLM with the port's own random
weights: every injected fault terminates (retried, degraded or shed), shed
requests are never billed, and one seed and plan replay one decision log.
"""
import json

import numpy as np
import pytest
import torch

from test_torch_helpers import reference, tree_leaves


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


def _loop(served, *, plan=None, retries=None, ladder=False, max_new=3):
    from repro_torch.launch import faults, serve_loop
    cfg, model, params, store = served
    classes = [serve_loop.SLOClass("premium", store.names[0], max_new),
               serve_loop.SLOClass("economy", store.names[1], max_new)]
    lad = serve_loop.DegradationLadder.from_store(store) if ladder else None
    return serve_loop.ServeLoop(
        model, params, store, classes, slots=2, max_len=32, prompt_bucket=8,
        clock=faults.VirtualClock(), fault_plan=plan, retries=retries,
        ladder=lad, device="cpu")


# ------------------------------------------------- pure, against the ref

def test_spec_validation():
    from repro_torch.launch import faults
    with pytest.raises(ValueError, match="unknown crosspoint"):
        faults.FaultSpec("warp", "fail", 0.5)
    with pytest.raises(ValueError, match="outside"):
        faults.FaultSpec("prefill", "fail", 1.5)


def test_constants_equal_reference():
    from repro_torch.launch import faults
    R = reference().faults
    assert faults.CROSSPOINTS == R.CROSSPOINTS
    assert {k: vars(v) for k, v in faults.DEFAULT_RETRIES.items()} == \
        {k: vars(v) for k, v in R.DEFAULT_RETRIES.items()}
    assert vars(faults.RetryPolicy()) == vars(R.RetryPolicy())
    for c in faults.CROSSPOINTS:
        assert faults._stable_id(c) == R._stable_id(c)


@pytest.mark.parametrize("seed", [0, 11, 42])
def test_plan_draws_equal_reference(seed):
    """Same specs and seed: the same fault at every one of 200 draws per
    crosspoint, interleaved, in both packages; equal injected counts."""
    from repro_torch.launch import faults
    R = reference().faults
    specs = [("prefill", "fail", 0.3, 0.0, 0),
             ("prefill", "slow", 0.3, 0.1, 0),
             ("decode", "stall", 0.2, 0.05, 0),
             ("fingerprint", "corrupt", 0.1, 0.0, 0),
             ("burst", "burst", 0.12, 0.0, 3)]
    a = faults.FaultPlan(tuple(faults.FaultSpec(*s) for s in specs), seed)
    b = R.FaultPlan(tuple(R.FaultSpec(*s) for s in specs), seed)
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        c = faults.CROSSPOINTS[int(rng.integers(0, 4))]
        x, y = a.draw(c), b.draw(c)
        assert (x is None) == (y is None)
        if x is not None:
            assert vars(x) == vars(y)
    assert a.stats() == b.stats()
    assert a.describe() == b.describe()


def test_default_chaos_plan_equals_reference():
    from repro_torch.launch import faults
    R = reference().faults
    a, b = faults.default_chaos_plan(5), R.default_chaos_plan(5)
    assert a.describe() == b.describe()
    seq_a = [a.draw(c) for c in faults.CROSSPOINTS * 100]
    seq_b = [b.draw(c) for c in R.CROSSPOINTS * 100]
    assert [None if s is None else vars(s) for s in seq_a] == \
        [None if s is None else vars(s) for s in seq_b]


def test_corrupt_fingerprint_equals_reference():
    from repro_torch.launch import faults
    R = reference().faults
    for fp in ("a" * 64, "0123456789abcdef" * 4):
        bad = faults.corrupt_fingerprint(fp)
        assert bad == R.corrupt_fingerprint(fp)
        assert bad != fp and bad == faults.corrupt_fingerprint(fp)


def test_plan_draws_are_reproducible():
    from repro_torch.launch import faults
    specs = (faults.FaultSpec("prefill", "fail", 0.3),
             faults.FaultSpec("prefill", "slow", 0.3, delay_s=0.1),
             faults.FaultSpec("decode", "stall", 0.2, delay_s=0.05))
    a = faults.FaultPlan(specs, seed=11)
    b = faults.FaultPlan(specs, seed=11)
    seq_a = [a.draw("prefill") for _ in range(64)]
    assert seq_a == [b.draw("prefill") for _ in range(64)]
    assert any(s is not None for s in seq_a)
    c = faults.FaultPlan(specs, seed=12)
    assert [c.draw("prefill") for _ in range(64)] != seq_a


def test_crosspoint_streams_are_independent():
    from repro_torch.launch import faults
    specs = (faults.FaultSpec("prefill", "fail", 0.3),
             faults.FaultSpec("decode", "stall", 0.3, delay_s=0.01))
    a = faults.FaultPlan(specs, seed=3)
    b = faults.FaultPlan(specs, seed=3)
    for _ in range(50):                       # extra decode traffic on b
        b.draw("decode")
    assert [a.draw("prefill") for _ in range(32)] == \
        [b.draw("prefill") for _ in range(32)]


def test_rate_edges():
    from repro_torch.launch import faults
    always = faults.FaultPlan((faults.FaultSpec("prefill", "fail", 1.0),),
                              seed=0)
    never = faults.FaultPlan((faults.FaultSpec("prefill", "fail", 0.0),),
                             seed=0)
    assert all(always.draw("prefill") is not None for _ in range(16))
    assert all(never.draw("prefill") is None for _ in range(16))
    assert never.stats() == {}
    assert always.stats() == {"prefill": {"fail": 16}}


def test_plan_describe_is_json_ready():
    from repro_torch.launch import faults
    plan = faults.default_chaos_plan(seed=7)
    desc = json.loads(json.dumps(plan.describe()))
    assert desc["seed"] == 7
    assert {s["crosspoint"] for s in desc["specs"]} == set(faults.CROSSPOINTS)


def test_fault_error_names_the_crosspoint():
    from repro_torch.launch import faults
    R = reference().faults
    spec = faults.FaultSpec("prefill", "fail", 0.5)
    err = faults.FaultError(spec, 2)
    assert str(err) == str(R.FaultError(R.FaultSpec("prefill", "fail", 0.5),
                                        2))
    assert err.spec is spec and err.attempt == 2


def test_virtual_clock():
    from repro_torch.launch import faults
    clk = faults.VirtualClock(start=1.0)
    assert clk.now() == 1.0
    clk.advance(0.25)
    assert clk.now() == 1.25
    with pytest.raises(ValueError, match="advance"):
        clk.advance(-0.1)


# ------------------------------------------------------- loop integration

def test_prefill_faults_retry_to_success(served):
    from repro_torch.launch import faults
    plan = faults.FaultPlan((faults.FaultSpec("prefill", "fail", 0.4),),
                            seed=5)
    loop = _loop(served, plan=plan)
    rng = np.random.default_rng(0)
    for i in range(8):
        loop.submit(rng.integers(0, served[0].vocab, 6),
                    ("premium", "economy")[i % 2])
    loop.shutdown(drain=True)
    stats = loop.stats()
    assert stats["terminal"] == 8 and stats["pending"] == 0
    assert plan.stats().get("prefill", {}).get("fail", 0) > 0
    assert all(r.bill is not None for r in loop.completed)
    assert all(r.bill is None for r in loop.shed)


def test_certain_prefill_failure_sheds_with_reason(served):
    """Every attempt fails before its prefill runs: the request is shed and
    the lane's cache is untouched."""
    from repro_torch.launch import faults
    plan = faults.FaultPlan((faults.FaultSpec("prefill", "fail", 1.0),),
                            seed=0)
    loop = _loop(served, plan=plan)
    before = [t.clone() for t in tree_leaves(loop.lanes["premium"].cache)]
    req = loop.submit(np.arange(1, 6), "premium")
    loop.shutdown(drain=True)
    assert req.state == "shed" and req.shed_reason == "prefill_failed"
    assert req.bill is None
    pol = loop.retries["prefill"]
    assert loop.fault_stats["prefill"]["injected"] == pol.max_attempts
    assert loop.fault_stats["prefill"]["gave_up"] == 1
    for a, b in zip(before, tree_leaves(loop.lanes["premium"].cache)):
        assert torch.equal(a, b)


def test_slow_prefill_absorbed_within_timeout(served):
    from repro_torch.launch import faults
    plan = faults.FaultPlan(
        (faults.FaultSpec("prefill", "slow", 1.0, delay_s=0.05),), seed=0)
    loop = _loop(served, plan=plan)
    req = loop.submit(np.arange(1, 6), "premium")
    loop.shutdown(drain=True)
    assert req.state == "served"                 # delay absorbed as latency
    assert loop.fault_stats["prefill"]["injected"] > 0
    assert loop.fault_stats["prefill"]["gave_up"] == 0


def test_slow_prefill_beyond_timeout_is_a_failure(served):
    from repro_torch.launch import faults
    plan = faults.FaultPlan(
        (faults.FaultSpec("prefill", "slow", 1.0, delay_s=0.5),), seed=0)
    retries = {"prefill": faults.RetryPolicy(max_attempts=2, backoff_s=0.0,
                                             timeout_s=0.1)}
    loop = _loop(served, plan=plan, retries=retries)
    req = loop.submit(np.arange(1, 6), "premium")
    loop.shutdown(drain=True)
    assert req.state == "shed" and req.shed_reason == "prefill_failed"


def test_decode_stall_is_retried_in_place(served):
    from repro_torch.launch import faults
    plan = faults.FaultPlan(
        (faults.FaultSpec("decode", "stall", 1.0, delay_s=0.02),), seed=0)
    loop = _loop(served, plan=plan)
    req = loop.submit(np.arange(1, 6), "premium")
    loop.shutdown(drain=True)
    assert req.state == "served" and len(req.tokens) == 3
    assert loop.fault_stats["decode"]["injected"] > 0


def test_corrupt_fingerprint_sheds_without_ladder(served):
    from repro_torch.launch import faults
    plan = faults.FaultPlan(
        (faults.FaultSpec("fingerprint", "corrupt", 1.0),), seed=0)
    loop = _loop(served, plan=plan)
    req = loop.submit(np.arange(1, 6), "premium")
    loop.shutdown(drain=True)
    assert req.state == "shed" and req.shed_reason == "mask_corrupt"
    assert req.bill is None and loop.fault_stats["fingerprint"]["gave_up"] > 0


def test_corrupt_fingerprint_recovers_via_retry(served):
    from repro_torch.launch import faults
    plan = faults.FaultPlan(
        (faults.FaultSpec("fingerprint", "corrupt", 0.5),), seed=1)
    loop = _loop(served, plan=plan, ladder=True)
    rng = np.random.default_rng(0)
    for i in range(8):
        loop.submit(rng.integers(0, served[0].vocab, 6),
                    ("premium", "economy")[i % 2])
    loop.shutdown(drain=True)
    stats = loop.stats()
    assert stats["terminal"] == 8 and stats["pending"] == 0
    for r in loop.completed:       # billed set is always the verified one
        assert r.bill["fingerprint"] == \
            loop.store.info(r.mask_set).fingerprint


def test_same_seed_replays_decisions_bitwise(served):
    from repro_torch.launch import faults

    def run():
        plan = faults.default_chaos_plan(seed=42)
        loop = _loop(served, plan=plan, ladder=True)
        rng = np.random.default_rng(9)
        for i in range(10):
            loop.submit(rng.integers(0, served[0].vocab,
                                     int(rng.integers(2, 12))),
                        ("premium", "economy")[i % 2])
        loop.shutdown(drain=True)
        return loop
    a, b = run(), run()
    assert a.decision_log == b.decision_log
    assert a.stats()["decisions_sha256"] == b.stats()["decisions_sha256"]
    assert [r.state for r in a.completed] == [r.state for r in b.completed]
    assert [r.tokens for r in a.completed] == [r.tokens for r in b.completed]

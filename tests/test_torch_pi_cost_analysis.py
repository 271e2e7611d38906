"""The port's PI cost model (``repro_torch.core.pi_cost``) and mask
analytics (``repro_torch.core.analysis``) against the reference's, on seeded
masks: the same numbers, to the bit (both are host numpy / Python)."""
import dataclasses

import numpy as np
import pytest

from test_torch_helpers import reference


def _masks(seed, density, tie=False):
    rng = np.random.default_rng(seed)
    out = {"s0": (rng.random((4, 4, 8)) < density).astype(np.float32),
           "s1": (rng.random((2, 16)) < density).astype(np.float32)}
    if tie:
        out["s1"][0, 1::4] = 0.75          # share-tied coordinates
    return out


def _trajectory(seed):
    """Nested masks of falling budget, as a descent records them."""
    rng = np.random.default_rng(seed)
    m = _masks(seed, 0.9)
    snaps = [m]
    for _ in range(4):
        m = {k: v * (rng.random(v.shape) > 0.2).astype(np.float32)
             for k, v in m.items()}
        snaps.append(m)
    return snaps


@pytest.mark.parametrize("relus,layers,params", [
    (0, 1, 0), (557_056, 17, 0), (12_345, 4, 1_000_000)])
def test_cost_and_saving_match_reference(relus, layers, params):
    from repro_torch.core import pi_cost
    ref = reference().pi_cost
    for proto in (None, dict(bandwidth_bytes_per_s=1e8, rtt_s=0.05,
                             linear_online_bytes_per_param=0.5)):
        pt = pi_cost.PIProtocol(**proto) if proto else pi_cost.PIProtocol()
        pr = ref.PIProtocol(**proto) if proto else ref.PIProtocol()
        assert dataclasses.asdict(pi_cost.cost(relus, layers, pt, params)) \
            == dataclasses.asdict(ref.cost(relus, layers, pr, params))
        assert pi_cost.saving(relus + 10, relus, layers, pt) == \
            ref.saving(relus + 10, relus, layers, pr)
        assert pi_cost.estimate_request_s(relus, layers, 7, 9, pt) == \
            ref.estimate_request_s(relus, layers, 7, 9, pr)


def test_bills_match_reference():
    from repro_torch.core import pi_cost
    ref = reference().pi_cost
    kw = dict(mask_set="b50", fingerprint="abc", degraded_from="b80")
    assert pi_cost.bill_request(1000, 12, 33, **kw) == \
        ref.bill_request(1000, 12, 33, **kw)


@pytest.mark.parametrize("tie", [False, True])
def test_cost_of_masks_bills_driver_relus(tie):
    from repro_torch.core import masks as M, pi_cost
    ref = reference().pi_cost
    m = _masks(1, 0.6, tie=tie)
    got = pi_cost.cost_of_masks(m, 2)
    assert dataclasses.asdict(got) == \
        dataclasses.asdict(ref.cost_of_masks(m, 2))
    assert got.relus == M.relu_cost(m)
    assert (got.relus < M.count(m)) == tie


@pytest.mark.parametrize("seed", [0, 7])
def test_analysis_matches_reference(seed):
    from repro_torch.core import analysis
    ref = reference().analysis
    snaps = _trajectory(seed)
    np.testing.assert_array_equal(analysis.iou_matrix(snaps),
                                  ref.iou_matrix(snaps))
    assert analysis.consecutive_iou(snaps) == ref.consecutive_iou(snaps)
    assert analysis.golden_set_fraction(snaps) == \
        ref.golden_set_fraction(snaps)
    assert analysis.layer_distribution(snaps[-1]) == \
        ref.layer_distribution(snaps[-1])
    # nested trajectories: every later mask is a subset, IoU exactly 1
    assert analysis.consecutive_iou(snaps) == [1.0] * 4
    assert analysis.golden_set_fraction([snaps[0]]) == 1.0

"""``training.pp``: the GPipe schedule equals the stages applied in turn.

Counterparts of the reference's ``tests/test_pp.py``, with its five cases
and tolerances, held against the reference's ``gpipe_forward`` on the same
numpy parameters and microbatches as well.
"""
import numpy as np
import pytest
import torch

from test_torch_helpers import reference


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _ref_stage(p, x):
    import jax.numpy as jnp
    return jnp.tanh(x @ p["w"] + p["b"])


@pytest.mark.parametrize("S,M", [(2, 4), (4, 8), (3, 1)])
def test_gpipe_matches_sequential(S, M):
    from repro_torch.training.pp import gpipe_forward
    rng = np.random.default_rng(0)
    D, mb = 16, 4
    w = (rng.normal(size=(S, D, D)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(S, D)) * 0.1).astype(np.float32)
    micro = rng.normal(size=(M, mb, D)).astype(np.float32)
    params = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    got = gpipe_forward(_stage, params, torch.from_numpy(micro))
    want = torch.from_numpy(micro)
    for s in range(S):
        want = torch.stack([_stage({"w": params["w"][s],
                                    "b": params["b"][s]}, x) for x in want])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    ref = reference()
    from repro.training.pp import gpipe_forward as ref_gpipe
    theirs = ref_gpipe(_ref_stage, {"w": ref.jnp.asarray(w),
                                    "b": ref.jnp.asarray(b)},
                       ref.jnp.asarray(micro))
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs), rtol=1e-5,
                               atol=1e-6)


def test_gpipe_differentiable():
    from repro_torch.training.pp import gpipe_forward
    rng = np.random.default_rng(1)
    S, M, D, mb = 3, 4, 8, 2
    params = {"w": torch.tensor(rng.normal(size=(S, D, D)) * 0.3,
                                dtype=torch.float32, requires_grad=True),
              "b": torch.zeros((S, D), requires_grad=True)}
    micro = torch.tensor(rng.normal(size=(M, mb, D)), dtype=torch.float32)
    (gpipe_forward(_stage, params, micro) ** 2).sum().backward()
    assert all(bool(torch.isfinite(p.grad).all()) for p in params.values())
    assert float(torch.linalg.norm(params["w"].grad)) > 0


def test_bubble_fraction():
    from repro_torch.training.pp import bubble_fraction
    assert bubble_fraction(1, 8) == 0.0
    assert bubble_fraction(4, 12) == pytest.approx(3 / 15)
    # more microbatches -> smaller bubble
    assert bubble_fraction(4, 64) < bubble_fraction(4, 8)

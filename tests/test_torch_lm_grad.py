"""The LM families' gradients in the port against ``jax.grad`` of the
reference's loss, on the CPU.

One reduced config of each family — dense (StableLM-2-1.6B), RWKV-6 3B,
DeepSeek-MoE-16B (a dense head block, MoE blocks with a shared expert) and
Zamba2-2.7B (Mamba2 blocks and a shared attention block) — in float32 with
parameters converted from the reference's ``init(PRNGKey(0))``, and the
loss ``cross_entropy(LM.forward(...))`` of the family sweep
(``examples/family_bcd_sweep.py``).  Hard masks: the θ gradients, every
hard gate through ``kernels.ops.MaskedActFn`` (and RWKV-6's scan through
``kernels.ops.RWKV6ScanFn``).  Soft masks (SNL's relaxation, with weights
on the clip's bounds): the θ and α gradients.

Tolerance: each leaf's max |Δ| ≤ 1e-4 × that leaf's max |∇| (float32 sums
in other orders; the reference's chunked scans divide by in-chunk decay
products, the port's scan backward does not).
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_helpers import random_masks, reference, to_numpy_tree

FAMILIES = ["stablelm_1p6b", "rwkv6_3b", "deepseek_moe_16b", "zamba2_2p7b"]
B, S = 2, 32
REL = 1e-4
_CACHE = {}


def _build(arch):
    if arch in _CACHE:
        return _CACHE[arch]
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    ref = reference()
    rcfg = dataclasses.replace(ref.configs.get_config(arch).reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    rmodel, tmodel = ref.lm.LM(rcfg), LM(tcfg)
    rparams = rmodel.init(ref.jax.random.PRNGKey(0))
    tparams = convert.params_from_reference(to_numpy_tree(rparams), "cpu")
    _CACHE[arch] = ref, rmodel, rparams, tmodel, tparams
    return _CACHE[arch]


def _soft_alphas(sites, seed):
    """SNL's weights: uniform in [0, 1), a fifth of them on the clip's upper
    bound and a tenth on its lower one (where the derivative is 1/2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in sites.items():
        a = rng.random(s.shape)
        u = rng.random(s.shape)
        a[u < 0.2] = 1.0
        a[(u >= 0.2) & (u < 0.3)] = 0.0
        out[k] = a.astype(np.float32)
    return out


class _count_calls:
    """Counts ``cls.apply`` calls within the block."""

    def __init__(self, cls):
        self.cls, self.n = cls, 0

    def __enter__(self):
        self.orig = self.cls.apply

        def apply(*args):
            self.n += 1
            return self.orig(*args)
        self.cls.apply = apply
        return self

    def __exit__(self, *exc):
        self.cls.apply = self.orig


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_gradients_match_jax_grad(arch, soft):
    from repro_torch.core import masks as M
    from repro_torch.kernels import ops
    from repro_torch.training import optimizer as opt, train
    ref, rmodel, rparams, tmodel, tparams = _build(arch)
    import repro.training.train as rtrain
    jnp = ref.jnp
    sites = tmodel.mask_sites()
    masks = _soft_alphas(sites, 3) if soft else random_masks(sites, 3)
    toks = np.random.default_rng(4).integers(
        0, tmodel.cfg.vocab, size=(B, S + 1)).astype(np.int32)

    def rloss(p, a):
        logits, _ = rmodel.forward(p, a, jnp.asarray(toks[:, :-1]),
                                   soft=soft)
        return rtrain.cross_entropy(logits, jnp.asarray(toks[:, 1:]))
    jm = {k: jnp.asarray(v) for k, v in masks.items()}
    rg = ref.jax.grad(rloss, argnums=(0, 1) if soft else 0)(rparams, jm)
    want = ref.jax.tree.leaves(to_numpy_tree(rg))

    tm = M.as_device(masks, "cpu")
    labels = torch.from_numpy(toks[:, 1:]).long()
    inputs = torch.from_numpy(toks[:, :-1])

    def tloss(tree):
        p, a = tree if soft else (tree, tm)
        return train.cross_entropy(tmodel.forward(p, a, inputs, soft=soft),
                                   labels)
    with _count_calls(ops.MaskedActFn) as gates, \
            _count_calls(ops.RWKV6ScanFn) as scans:
        _, tg = train.loss_and_grads(tloss, (tparams, tm) if soft
                                     else tparams)
    got = opt.tree_leaves(tg)
    assert len(got) == len(want)
    # hard gates reach the differentiable gate, soft ones the plain ops
    assert (gates.n > 0) != soft
    assert (scans.n > 0) == (arch == "rwkv6_3b")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= REL * scale, (arch, soft, g.shape, err, scale)
    assert all(bool(torch.isfinite(g).all()) for g in got)

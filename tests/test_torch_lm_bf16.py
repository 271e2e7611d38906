"""The LM families in their configs' own bfloat16: the port's logits against
the reference's on the CPU.

One reduced config of each family — dense (StableLM-2-1.6B), RWKV-6 3B,
DeepSeek-MoE-16B (a dense head block, MoE blocks with a shared expert) and
Zamba2-2.7B (Mamba2 blocks and a shared attention block) — with
``dtype="bfloat16"`` set by ``dataclasses.replace`` (``reduced()`` sets
float32).  Parameters come from the reference's ``init(PRNGKey(0))`` and
are converted with ``convert.params_from_reference(dtype=None)``, so the
bfloat16 leaves stay bfloat16 beside the inits' float32 ones; partial
masks (density 0.6) and tokens come from numpy seeds.  The port's
unfused and fused forwards (``fused=True``: the dense FFNs' and the MoE
shared experts' gate fused into the down-projection; RWKV-6 and Mamba2
blocks have no fused route and run as unfused) are held to the
reference's bfloat16 forward.

Tolerance, stated before the first run: both packages' bfloat16 logits
are measured against the reference's float32 forward of the same
parameters, upcast.  The port's largest error must be at most twice the
reference's, plus 1e-3; and the port's argmax must agree with the
reference's bfloat16 argmax at ≥ 0.95 of the positions.  An elementwise
bound between the two bfloat16 forwards would measure where each framework
rounds (XLA once per fusion, eager PyTorch once per operation), not a
fault; the float32 forward is the yardstick both are held to.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_helpers import random_masks, reference, to_numpy_tree

FAMILIES = ["stablelm_1p6b", "rwkv6_3b", "deepseek_moe_16b", "zamba2_2p7b"]
B, S = 2, 32
RATIO, ABS = 2.0, 1e-3
ARGMAX = 0.95


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The reduced models gain nothing from intra-op threads.  Put back
    afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", FAMILIES)
def test_bfloat16_logits_match_the_reference(arch):
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import masks as M
    from repro_torch.models.lm import LM
    ref = reference()
    jnp = ref.jnp
    rcfg = dataclasses.replace(ref.configs.get_config(arch).reduced(),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    rmodel, tmodel = ref.lm.LM(rcfg), LM(tcfg)
    rmodel32 = ref.lm.LM(dataclasses.replace(rcfg, dtype="float32"))
    rparams = rmodel.init(ref.jax.random.PRNGKey(0))
    rparams32 = ref.jax.tree.map(lambda a: a.astype(jnp.float32), rparams)
    tparams = convert.params_from_reference(to_numpy_tree(rparams), "cpu",
                                            dtype=None)
    assert tparams["embed"].dtype == torch.bfloat16
    assert tparams["final_norm"]["scale"].dtype == torch.float32

    masks = random_masks(tmodel.mask_sites(), seed=3)
    assert 0 < np.mean([m.mean() for m in masks.values()]) < 1
    toks = np.random.default_rng(4).integers(
        0, tcfg.vocab, size=(B, S)).astype(np.int32)
    jm = {k: jnp.asarray(v) for k, v in masks.items()}
    want, _ = rmodel.forward(rparams, jm, jnp.asarray(toks))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    exact, _ = rmodel32.forward(rparams32, jm, jnp.asarray(toks))
    exact = np.asarray(exact)
    ref_err = float(np.abs(want - exact).max())
    assert ref_err > 0

    tm = M.as_device(masks, "cpu")
    with torch.no_grad():
        for fused in (False, True):
            got = tmodel.forward(tparams, tm, torch.from_numpy(toks),
                                 fused=fused)
            assert got.dtype == torch.bfloat16
            assert tuple(got.shape) == (B, S, tcfg.vocab)
            got = got.float().numpy()
            assert np.isfinite(got).all()
            err = float(np.abs(got - exact).max())
            assert err <= RATIO * ref_err + ABS, (arch, fused, err, ref_err)
            agree = float((got.argmax(-1) == want.argmax(-1)).mean())
            assert agree >= ARGMAX, (arch, fused, agree)

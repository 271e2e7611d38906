"""The port's Mamba2 block (``repro_torch.models.ssm``) against the JAX
package's, on the CPU.

Activations, states and masks are made with numpy from a seed; parameters
come from the reference's ``mamba_init`` and are converted with
``repro_torch.convert.params_from_reference``.  Under test: the causal
convolution with and without a carried state, the block's eval path
within 1e-5 of the reference, the chunked scan against the single-token
recurrence over a whole sequence, stacked candidates against one at a
time, the cache tuple, and the chunk rule that both packages share.

Tolerance: 1e-5 absolute (observed a few 1e-7: the two packages sum the
chunked scan's products in other orders).
"""
import numpy as np
import pytest
import torch

from test_torch_helpers import reference, to_numpy_tree

TOL = dict(rtol=0.0, atol=1e-5)


def _setup(d=16, di=32, hd=8, N=4, dtype="float32"):
    from repro_torch import convert
    from repro_torch.models import ssm
    ref = reference()
    kw = dict(d_model=d, d_inner=di, n_heads=di // hd, head_dim=hd,
              d_state=N)
    rc, tc = ref.ssm.MambaCfg(**kw), ssm.MambaCfg(**kw)
    rp = ref.ssm.mamba_init(ref.jax.random.PRNGKey(0), rc,
                            dtype=getattr(ref.jnp, dtype))
    tp = convert.params_from_reference(to_numpy_tree(rp), "cpu", dtype=None)
    return ref, rc, tc, rp, tp


def _site(ref, di):
    from repro_torch.core import linearize as TL
    return ref.linearize.MaskSite((di,), "silu"), TL.MaskSite((di,), "silu")


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    from repro_torch.models import ssm
    ref = reference()
    rng = np.random.default_rng(0)
    xin = rng.normal(size=(2, 7, 5)).astype(np.float32)
    conv = rng.normal(size=(4, 5)).astype(np.float32)
    state = rng.normal(size=(2, 3, 5)).astype(np.float32) if with_state \
        else None
    j = ref.jnp.asarray
    want, wstate = ref.ssm._causal_conv(j(xin), j(conv),
                                        None if state is None else j(state))
    got, gstate = ssm._causal_conv(torch.from_numpy(xin),
                                   torch.from_numpy(conv),
                                   None if state is None
                                   else torch.from_numpy(state))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(gstate.numpy(), np.asarray(wstate))
    # one step at a time from the carried state is the whole sequence (a
    # step without a state would pad with S zeros, not dc - 1, in both
    # packages: decode always carries one)
    st = torch.zeros((2, 3, 5)) if state is None else torch.from_numpy(state)
    steps = []
    for t in range(xin.shape[1]):
        y, st = ssm._causal_conv(torch.from_numpy(xin[:, t:t + 1]),
                                 torch.from_numpy(conv), st)
        steps.append(y)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), got.numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("S", [5, 16, 32])
def test_block_eval_matches_reference(S):
    """S = 5 is one chunk of 5, S = 16 one of 16; with chunk 8, S = 32 is
    four chunks."""
    import dataclasses
    from repro_torch.models import ssm
    ref, rc, tc, rp, tp = _setup()
    if S == 32:
        rc = dataclasses.replace(rc, chunk=8)
        tc = dataclasses.replace(tc, chunk=8)
    rsite, tsite = _site(ref, 32)
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, 16)).astype(np.float32)
    mask = (rng.random((32,)) < 0.5).astype(np.float32)
    j = ref.jnp.asarray
    want, _ = ref.ssm.mamba_block(rp, rc, j(x), j(mask), rsite)
    got = ssm.mamba_block(tp, tc, torch.from_numpy(x),
                          torch.from_numpy(mask), tsite)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_chunked_path_equals_the_single_token_step():
    """A prefill of 16 tokens from a random state against 16 decode steps
    from the same state: the chunked scan and the exact recurrence give
    the same outputs and the same final cache."""
    from repro_torch.models import ssm
    ref, rc, tc, rp, tp = _setup()
    _, tsite = _site(ref, 32)
    rng = np.random.default_rng(3)
    B, S = 2, 16
    x = torch.from_numpy(rng.normal(size=(B, S, 16)).astype(np.float32))
    mask = torch.from_numpy((rng.random((32,)) < 0.5).astype(np.float32))
    s0 = torch.from_numpy(rng.normal(size=(B, 4, 4, 8)).astype(np.float32)
                          * 0.1)
    c0 = torch.from_numpy(rng.normal(size=(B, 3, 32)).astype(np.float32))
    full, (s_full, c_full) = ssm.mamba_block(tp, tc, x, mask, tsite,
                                             cache=(s0, c0))
    state, conv, outs = s0, c0, []
    for t in range(S):
        y, (state, conv) = ssm.mamba_block(tp, tc, x[:, t:t + 1], mask,
                                           tsite, cache=(state, conv))
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **TOL)
    np.testing.assert_allclose(state.numpy(), s_full.numpy(), **TOL)
    # the convolution's state is the last inputs, x·w_x, whose product
    # rounds by its row count
    np.testing.assert_allclose(conv.numpy(), c_full.numpy(), **TOL)
    # and both against the reference's cached block
    j = ref.jnp.asarray
    want, (ws, wc) = ref.ssm.mamba_block(
        rp, rc, j(x.numpy()), j(mask.numpy()), _site(ref, 32)[0],
        cache=(j(s0.numpy()), j(c0.numpy())))
    np.testing.assert_allclose(full.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(s_full.numpy(), np.asarray(ws), **TOL)
    np.testing.assert_allclose(c_full.numpy(), np.asarray(wc), **TOL)


def test_stacked_masks_equal_one_at_a_time():
    """Three stacked masks on a shared x (the gate's stride-0 view) and on
    one x per candidate, against one call per candidate."""
    from repro_torch.models import ssm
    ref, rc, tc, rp, tp = _setup()
    _, tsite = _site(ref, 32)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
    masks = torch.from_numpy((rng.random((3, 32)) < 0.5).astype(np.float32))
    st = ssm.mamba_block(tp, tc, x, masks, tsite)
    assert st.shape == (3, 2, 8, 16)
    for i in range(3):
        one = ssm.mamba_block(tp, tc, x, masks[i], tsite)
        np.testing.assert_allclose(st[i].numpy(), one.numpy(), rtol=0,
                                   atol=1e-6)
    xs = x + 0.1 * torch.arange(3.0)[:, None, None, None]
    st = ssm.mamba_block(tp, tc, xs, masks, tsite)
    for i in range(3):
        one = ssm.mamba_block(tp, tc, xs[i], masks[i], tsite)
        np.testing.assert_allclose(st[i].numpy(), one.numpy(), rtol=0,
                                   atol=1e-6)


def test_lm_cache_is_written_in_place():
    """Through the LM (reduced Zamba2): a prefill and a decode step write
    each Mamba2 block's ``ssm`` and ``conv`` leaves in place, with the
    reference's values."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import linearize, masks as M
    from repro_torch.models.lm import LM
    ref = reference()
    rcfg = ref.configs.get_config("zamba2_2p7b").reduced()
    rmodel, tmodel = ref.lm.LM(rcfg), LM(get_config("zamba2_2p7b").reduced())
    rparams = rmodel.init(ref.jax.random.PRNGKey(0))
    tparams = convert.params_from_reference(to_numpy_tree(rparams), "cpu")
    tree = linearize.init_masks(tmodel.mask_sites())
    toks = np.random.default_rng(5).integers(0, 128, (2, 6)).astype(np.int32)
    cache = tmodel.init_cache(2, 8, "cpu")
    leaves = {k: (v["ssm"], v["conv"]) for k, v in cache["stack"].items()
              if "ssm" in v}
    assert len(leaves) == 5
    _, out = tmodel.forward(tparams, M.as_device(tree, "cpu"),
                            torch.from_numpy(toks[:, :5]), cache=cache)
    _, out = tmodel.forward(tparams, M.as_device(tree, "cpu"),
                            torch.from_numpy(toks[:, 5:]), cache=cache,
                            cache_len=5)
    assert out is cache
    j = ref.jnp.asarray
    rm = ref.masks.as_device(tree)
    rc = rmodel.init_cache(2, 8)
    _, rc = rmodel.forward(rparams, rm, j(toks[:, :5]), cache=rc,
                           cache_len=0)
    _, rc = rmodel.forward(rparams, rm, j(toks[:, 5:]), cache=rc,
                           cache_len=5)
    for k, (s, c) in leaves.items():
        assert out["stack"][k]["ssm"] is s and out["stack"][k]["conv"] is c
        assert float(s.abs().sum()) > 0
        np.testing.assert_allclose(s.numpy(), np.asarray(rc["stack"][k]["ssm"]),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(c.numpy(),
                                   np.asarray(rc["stack"][k]["conv"]),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("S", [65, 96, 127])
def test_chunk_rule_both_packages_refuse(S):
    """Above 64 tokens the chunk is 64 and S must be a multiple of it: the
    reference's reshape fails, the port raises."""
    from repro_torch.models import ssm
    ref, _, _, _, _ = _setup()
    kw = dict(d_model=16, d_inner=32, n_heads=4, head_dim=8, d_state=4)
    rc, tc = ref.ssm.MambaCfg(**kw), ssm.MambaCfg(**kw)
    rp = ref.ssm.mamba_init(ref.jax.random.PRNGKey(0), rc,
                            dtype=ref.jnp.float32)
    from repro_torch import convert
    tp = convert.params_from_reference(to_numpy_tree(rp), "cpu")
    rsite, tsite = _site(ref, 32)
    x = np.zeros((1, S, 16), np.float32)
    m = np.ones((32,), np.float32)
    with pytest.raises((TypeError, ValueError)):
        ref.ssm.mamba_block(rp, rc, ref.jnp.asarray(x), ref.jnp.asarray(m),
                            rsite)
    with pytest.raises(ValueError, match="not a multiple of the scan"):
        ssm.mamba_block(tp, tc, torch.from_numpy(x), torch.from_numpy(m),
                        tsite)
    # 128 is two chunks: accepted by both
    x = np.random.default_rng(0).normal(size=(1, 128, 16)).astype(np.float32)
    want, _ = ref.ssm.mamba_block(rp, rc, ref.jnp.asarray(x),
                                  ref.jnp.asarray(m), rsite)
    got = ssm.mamba_block(tp, tc, torch.from_numpy(x), torch.from_numpy(m),
                          tsite)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_init_keeps_the_reference_tree():
    from repro_torch.models import ssm
    ref, rc, tc, _, _ = _setup()
    rp = to_numpy_tree(ref.ssm.mamba_init(ref.jax.random.PRNGKey(0), rc))
    tp = ssm.mamba_init(torch.Generator().manual_seed(0), tc, device="cpu")
    assert list(tp) == list(rp)
    for k in rp:
        assert tuple(tp[k].shape) == rp[k].shape, k
        assert str(tp[k].dtype).replace("torch.", "") == str(rp[k].dtype), k
    assert float(tp["A_log"][0]) == -4.0 and float(tp["D"][0]) == 1.0

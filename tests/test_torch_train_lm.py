"""The port's LM train step (``repro_torch.training.train``) and
``LM.forward(remat=, return_hidden=)`` against the JAX package on the CPU.

Reduced configs in float32, parameters and optimizer moments converted
from the reference's ``make_state`` (never re-initialised), batches from
``MarkovTokens``; AdamW on a cosine schedule with a gradient clip of 1.0,
as the launcher trains.

Tolerances, stated before the first run:
  * ``quantize_grads_int8``: equal to the bit — a max, a division, a
    rounding half to even and a product, each one IEEE operation;
  * each step's loss and ``grad_norm``: 1e-5 relative — float32 sums in
    other orders (the reference's own test holds a chunked loss to an
    unchunked one at 1e-5); ``grad_norm`` also to its float64 value at
    the same state, which decides where the reference's own is off;
  * each leaf's update (after minus before) over 3 steps: relative L2
    error ≤ 1e-3 against the reference's jitted step, each step from the
    reference's state — AdamW divides each moment by the root of the
    second, so a gradient entry's rounding moves its update by the same
    relative amount;
  * remat on vs off, ``remat_group`` 1 vs 2: equal to the bit, logits and
    gradients — the recomputation runs the same operations on the same
    inputs;
  * ``return_hidden``: 1e-5 absolute on the final-norm hidden state, the
    LM tests' tolerance for O(1) values;
  * ``loss_chunk`` vs the whole sequence: loss 1e-5 and ``grad_norm`` 1e-3
    relative, the reference's own test's bounds
    (``tests/test_perf_variants.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_helpers import reference, to_numpy_tree as _np

B, S = 2, 32
LR = 1e-3
STEPS = 3
UPDATE_REL = 1e-3
METRIC_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The reduced models gain nothing from intra-op threads, and a step
    takes tens of times longer on eight contending ones than on one.  Put
    back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_state(rstate):
    """The reference's train state as the port's: parameters and moments
    converted, counters as 0-d int32 tensors."""
    from repro_torch import convert
    from repro_torch.training import optimizer as opt_lib
    o = rstate["opt"]
    return {"params": convert.params_from_reference(_np(rstate["params"]),
                                                    "cpu"),
            "opt": opt_lib.OptState(
                torch.tensor(int(o.step), dtype=torch.int32),
                convert.params_from_reference(_np(o.mu), "cpu"),
                convert.params_from_reference(_np(o.nu), "cpu")),
            "step": torch.tensor(int(rstate["step"]), dtype=torch.int32)}


def _configs(arch):
    from repro_torch.configs import get_config
    ref = reference()
    return ref.configs.get_config(arch).reduced(), get_config(arch).reduced()


def _batch(cfg, step):
    """Markov tokens of the text length; with a ``prefix_len``, seeded
    prefix embeddings too (numpy)."""
    from repro_torch.data import MarkovTokens
    b = MarkovTokens(cfg.vocab, seed=0).batch(B, S - cfg.prefix_len, step)
    if cfg.prefix_len:
        rng = np.random.default_rng(100 + step)
        b["prefix_embeds"] = (rng.normal(size=(B, cfg.prefix_len,
                                               cfg.d_model)) * 0.02
                              ).astype(np.float32)
    return b


def _opts(steps=STEPS):
    import repro.training.optimizer as ropt
    from repro_torch.training import optimizer as opt_lib
    return (ropt.adamw(lr=LR, grad_clip=1.0, schedule=ropt.cosine(LR, steps)),
            opt_lib.adamw(lr=LR, grad_clip=1.0,
                          schedule=opt_lib.cosine(LR, steps)))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / den if den else \
        np.linalg.norm(got)


# ------------------------------------------------------- quantize_grads


def test_quantize_grads_int8_matches_reference_bitwise():
    from repro_torch.training import train
    ref = reference()
    import repro.training.train as rtrain
    rng = np.random.default_rng(0)
    ties = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5] * 160,
                    np.float32)               # scale 1.0: halves round even
    tree = {"scalar": np.full((), 3.7, np.float32),
            "small": rng.normal(size=(31, 32)).astype(np.float32),
            "zeros": np.zeros((2048,), np.float32),
            "ties": ties,
            "w": [rng.normal(size=(64, 48)).astype(np.float32) * 1e-3,
                  (rng.standard_cauchy(size=(4096,)) * 10).astype(
                      np.float32)]}
    want = _np(rtrain.quantize_grads_int8(
        ref.jax.tree.map(ref.jnp.asarray, tree)))
    got = train.quantize_grads_int8(
        {k: (torch.from_numpy(v) if not isinstance(v, list) else
             [torch.from_numpy(x) for x in v]) for k, v in tree.items()})
    pairs = [(got["scalar"], want["scalar"]), (got["small"], want["small"]),
             (got["zeros"], want["zeros"]), (got["ties"], want["ties"]),
             (got["w"][0], want["w"][0]), (got["w"][1], want["w"][1])]
    for g, w in pairs:
        assert g.numpy().dtype == w.dtype
        assert g.numpy().tobytes() == w.tobytes()
    # pass-through leaves are the same tensors, quantized ones are not
    assert np.array_equal(got["small"].numpy(), tree["small"])
    assert len(np.unique(got["w"][0].numpy())) <= 255
    assert got["ties"][1:5].tolist() == [2.0, -4.0, 0.0, -0.0]


# ------------------------------------------------------- the train step


def _serial_scan64(r, k, v, w, u, s, chunk):
    """The RWKV-6 recurrence token by token in float64, differentiated by
    autograd: the oracle of both packages' chunked scans."""
    r, k, v, w, u, s = (t.double() for t in (r, k, v, w, u, s))
    if u.shape[0] != r.shape[0]:
        u = u.repeat(r.shape[0] // u.shape[0], 1)
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        ys.append(torch.einsum("bk,bkv->bv", rt, s)
                  + (rt * u * kt).sum(-1, keepdim=True) * vt)
        s = wt[:, :, None] * s + kt[:, :, None] * vt[:, None, :]
    return torch.stack(ys, 1), s


def _grad_norm64(monkeypatch, loss_fn, params, masks, batch):
    """``grad_norm`` of ``loss_fn`` in float64: parameters and masks cast,
    the gates' plain versions and the scan's token loop differentiated by
    autograd."""
    from repro_torch.kernels import ops, ref as kref
    from repro_torch.training import optimizer as opt_lib, train
    with monkeypatch.context() as mp:
        mp.setattr(ops.MaskedActFn, "apply", staticmethod(
            lambda x, m, p, kind: kref.masked_act_ref(x, m, kind=kind,
                                                      poly=p)))
        mp.setattr(ops.RWKV6ScanFn, "apply", staticmethod(_serial_scan64))
        b = {k: (v.double() if v.is_floating_point() else v)
             for k, v in batch.items()}
        _, g = train.loss_and_grads(
            loss_fn, opt_lib.tree_map(lambda t: t.double(), params),
            {k: v.double() for k, v in masks.items()}, b)
    return float(torch.sqrt(sum(torch.sum(x * x)
                                for x in opt_lib.tree_leaves(g))))


def _run_both(arch, tcfg_kw, monkeypatch, steps=STEPS):
    """``steps`` steps of the reference's jitted step and, from the
    reference's state before each (converted), of the port's; per step
    both packages' metrics, ``grad_norm`` in float64 at that state, and
    each leaf's update (numpy)."""
    from repro_torch.models.lm import LM
    from repro_torch.core import linearize, masks as TM
    from repro_torch.training import optimizer as opt_lib, train
    ref = reference()
    import repro.training.train as rtrain
    rcfg, tcfg = _configs(arch)
    rmodel, tmodel = ref.lm.LM(rcfg), LM(tcfg)
    ropt, topt = _opts(steps)
    rstate = rtrain.make_state(rmodel, ropt, ref.jax.random.PRNGKey(0))
    rstep = ref.jax.jit(rtrain.make_train_step(
        rmodel, ropt, rtrain.TrainStepCfg(dp_axes=(), **tcfg_kw)))
    tstep = train.make_train_step(tmodel, topt,
                                  train.TrainStepCfg(dp_axes=(), **tcfg_kw))
    loss_fn = train.make_loss_fn(tmodel, train.TrainStepCfg(**tcfg_kw))
    rmasks = ref.masks.as_device(ref.linearize.init_masks(
        rmodel.mask_sites()))
    tmasks = TM.as_device(linearize.init_masks(tmodel.mask_sites()), "cpu")
    out = []
    for i in range(steps):
        b = _batch(tcfg, i)
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        tstate = _port_state(rstate)
        before = [np.asarray(x) for x in
                  ref.jax.tree.leaves(rstate["params"])]
        norm64 = _grad_norm64(monkeypatch, loss_fn, tstate["params"],
                              tmasks, tb)
        rstate, rm = rstep(rstate, {k: ref.jnp.asarray(v)
                                    for k, v in b.items()}, rmasks)
        tstate, tm = tstep(tstate, tb, tmasks)
        out.append(dict(
            rm={k: float(v) for k, v in rm.items()},
            tm={k: float(v) for k, v in tm.items()}, norm64=norm64,
            rdelta=[np.asarray(a) - b0 for a, b0 in zip(
                ref.jax.tree.leaves(rstate["params"]), before)],
            tdelta=[a.numpy() - b0 for a, b0 in zip(
                opt_lib.tree_leaves(tstate["params"]), before)]))
    return out, rstate, tstate


@pytest.mark.parametrize("arch,kw", [
    ("stablelm_1p6b", dict(remat=True)),
    ("rwkv6_3b", dict(remat=True)),
    ("paligemma_3b", dict(remat=True)),       # prefix_embeds
])
def test_train_steps_match_reference(arch, kw, monkeypatch):
    """Three steps, each from the reference's state before it.  The loss
    and each leaf's update are held to the reference's; ``grad_norm`` to
    the float64 value at that state, and to the reference's wherever the
    reference's own is within the tolerance of it.  (The reference's
    chunked RWKV-6 scan divides by in-chunk decay products: after one
    step its ``grad_norm`` is 3.1e-5 off the float64 value, the port's
    8e-9.)"""
    steps, rstate, tstate = _run_both(arch, kw, monkeypatch)
    for i, st in enumerate(steps):
        assert st["tm"]["loss"] == pytest.approx(st["rm"]["loss"],
                                                 rel=METRIC_REL), i
        g, r, o = st["tm"]["grad_norm"], st["rm"]["grad_norm"], st["norm64"]
        assert g == pytest.approx(o, rel=METRIC_REL), (i, g, o)
        if abs(r - o) <= METRIC_REL * o:
            assert g == pytest.approx(r, rel=METRIC_REL), (i, g, r)
        else:
            assert abs(g - o) < abs(r - o), (i, g, r, o)
        for j, (d, w) in enumerate(zip(st["tdelta"], st["rdelta"])):
            assert _rel_l2(d, w) <= UPDATE_REL, (i, j, _rel_l2(d, w))
    assert int(tstate["step"]) == int(rstate["step"]) == STEPS
    assert int(tstate["opt"].step) == int(rstate["opt"].step) == STEPS
    assert tstate["step"].dtype == torch.int32


def test_step_consumes_the_state_and_keeps_the_moments():
    """The caller's state dict is emptied (the reference donates it); the
    new state's moments are the old tensors, updated in place."""
    from repro_torch.configs import get_config
    from repro_torch.core import linearize, masks as TM
    from repro_torch.models.lm import LM
    from repro_torch.training import optimizer as opt_lib, train
    cfg = get_config("stablelm_1p6b").reduced()
    model = LM(cfg)
    opt = opt_lib.adamw(lr=LR)
    state = train.make_state(model, opt, torch.Generator().manual_seed(0),
                             "cpu")
    mu0 = opt_lib.tree_leaves(state["opt"].mu)
    step = train.make_train_step(model, opt)
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 0).items()}
    new, m = step(state, b, TM.as_device(
        linearize.init_masks(model.mask_sites()), "cpu"))
    assert state == {}
    assert all(a is b for a, b in zip(opt_lib.tree_leaves(new["opt"].mu),
                                      mu0))
    assert any(bool(t.abs().sum() > 0) for t in mu0)
    assert set(m) == {"loss", "grad_norm"}


def test_sharded_factories_name_the_queue():
    """``state_specs`` and ``jit_train_step`` are ported (Queue A11,
    ``tests/test_torch_specs.py``, ``tests/test_torch_sharded_train.py``):
    on no mesh the sharded step is ``make_train_step``, bit for bit, and a
    state's placements are the parameters' for every moment."""
    from repro_torch.configs import get_config
    from repro_torch.core import linearize, masks as M
    from repro_torch.models import lm
    from repro_torch.training import optimizer as opt_lib, train
    model = lm.LM(get_config("stablelm_1p6b").reduced())
    opt = opt_lib.adamw(lr=1e-2, grad_clip=0.5)
    sp = train.state_specs(model, opt, 2, 2)
    assert sp["opt"].mu is sp["params"] is sp["opt"].nu
    assert sp["step"] == () == sp["opt"].step
    masks = M.as_device(linearize.init_masks(model.mask_sites()), "cpu")
    t = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 9)))
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    out = []
    for make in (lambda: train.make_train_step(model, opt),
                 lambda: train.jit_train_step(model, opt, None)):
        state = train.make_state(model, opt,
                                 torch.Generator().manual_seed(0), "cpu")
        state, m = make()(state, batch, masks)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    [x.clone() for x in opt_lib.tree_leaves(state)]))
    assert out[0][:2] == out[1][:2]
    assert all(torch.equal(a, b) for a, b in zip(out[0][2], out[1][2]))


# ------------------------------------------------------ remat, hidden


_CACHE = {}


def _port_model(arch, **replace):
    """(ref, reference model, its ``init(PRNGKey(0))``, the port's model
    with ``replace`` on its reduced config, the parameters converted)."""
    from repro_torch import convert
    from repro_torch.models.lm import LM
    ref = reference()
    if arch not in _CACHE:
        rcfg, tcfg = _configs(arch)
        rmodel = ref.lm.LM(rcfg)
        rparams = rmodel.init(ref.jax.random.PRNGKey(0))
        _CACHE[arch] = (rmodel, rparams, tcfg, convert.params_from_reference(
            _np(rparams), "cpu"))
    rmodel, rparams, tcfg, tparams = _CACHE[arch]
    return ref, rmodel, rparams, LM(dataclasses.replace(tcfg, **replace)), \
        tparams


def _logits_and_grads(model, params, masks, tokens, remat):
    from repro_torch.training import train

    def fn(p):
        lg = model.forward(p, masks, tokens, remat=remat)
        return (lg.square().sum() * 1e-6, lg)
    (_, logits), grads = train.loss_and_grads(fn, params)
    from repro_torch.training import optimizer as opt_lib
    return logits, opt_lib.tree_leaves(grads)


@pytest.mark.parametrize("arch", ["stablelm_1p6b", "rwkv6_3b",
                                  "deepseek_moe_16b", "zamba2_2p7b"])
def test_remat_leaves_the_bits_alone(arch):
    """remat off, on, and in groups of 2 repeats: the same logits and
    gradients to the bit — RWKV-6's scan (``RWKV6ScanFn``) and the MoE
    dispatch recomputed under the checkpoint included."""
    from test_torch_helpers import random_masks
    from repro_torch.core import masks as TM
    from repro_torch.data import MarkovTokens
    _, _, _, model, params = _port_model(arch)
    _, _, _, model2, _ = _port_model(arch, remat_group=2)
    assert model.cfg.n_repeats % 2 == 0
    masks = TM.as_device(random_masks(model.mask_sites(), seed=1), "cpu")
    tokens = torch.from_numpy(MarkovTokens(model.cfg.vocab).batch(
        B, S, 0)["tokens"])
    l0, g0 = _logits_and_grads(model, params, masks, tokens, False)
    for m in (model, model2):
        l1, g1 = _logits_and_grads(m, params, masks, tokens, True)
        assert torch.equal(l0, l1)
        assert len(g0) == len(g1)
        for a, b in zip(g0, g1):
            assert torch.equal(a, b)


def test_remat_recomputes_each_repeat():
    """Under remat, the backward runs each stack repeat's gates again: the
    gate's autograd function is applied once more per repeat; in groups
    of 2, more than that (the group, then within it each repeat)."""
    from repro_torch.core import linearize, masks as TM
    from repro_torch.kernels import ops
    from repro_torch.data import MarkovTokens
    _, _, _, model, params = _port_model("stablelm_1p6b")
    _, _, _, model2, _ = _port_model("stablelm_1p6b", remat_group=2)
    masks = TM.as_device(linearize.init_masks(model.mask_sites()), "cpu")
    tokens = torch.from_numpy(MarkovTokens(model.cfg.vocab).batch(
        B, S, 0)["tokens"])
    R = model.cfg.n_repeats
    applied = {}
    orig = ops.MaskedActFn.apply
    for tag, m, remat in (("off", model, False), ("on", model, True),
                          ("group", model2, True)):
        n = [0]

        def counting(*a):
            n[0] += 1
            return orig(*a)
        ops.MaskedActFn.apply = counting
        try:
            _logits_and_grads(m, params, masks, tokens, remat)
        finally:
            ops.MaskedActFn.apply = orig
        applied[tag] = n[0]
    assert applied["off"] == R
    assert applied["on"] == 2 * R
    # the group is recomputed, then each repeat's checkpoint recomputes
    # what the backward still needs of it
    assert applied["group"] > 2 * R


def test_return_hidden_matches_reference():
    from repro_torch.core import linearize, masks as TM
    from repro_torch.data import MarkovTokens
    ref, rmodel, rparams, model, params = _port_model("stablelm_1p6b")
    tokens = MarkovTokens(model.cfg.vocab).batch(B, S, 0)["tokens"]
    hid_r, _ = rmodel.forward(
        rparams, ref.masks.as_device(ref.linearize.init_masks(
            rmodel.mask_sites())), ref.jnp.asarray(tokens), remat=True,
        return_hidden=True)
    masks = TM.as_device(linearize.init_masks(model.mask_sites()), "cpu")
    with torch.no_grad():
        hid = model.forward(params, masks, torch.from_numpy(tokens),
                            remat=True, return_hidden=True)
        logits = model.forward(params, masks, torch.from_numpy(tokens))
    assert hid.shape == (B, S, model.cfg.d_model)
    np.testing.assert_allclose(hid.numpy(), np.asarray(hid_r), rtol=0,
                               atol=1e-5)
    assert torch.equal(hid @ params["embed"].T, logits)


def test_loss_chunk_equals_whole_sequence():
    """The reference's own case on the port: ``loss_chunk=8`` against the
    whole sequence from one state."""
    from repro_torch.configs import get_config
    from repro_torch.core import linearize, masks as TM
    from repro_torch.models.lm import LM
    from repro_torch.training import optimizer as opt_lib, train
    cfg = get_config("stablelm_1p6b").reduced()
    model = LM(cfg)
    opt = opt_lib.adamw(lr=1e-3)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    masks = TM.as_device(linearize.init_masks(model.mask_sites()), "cpu")

    def fresh():
        return train.make_state(model, opt, torch.Generator().manual_seed(2),
                                "cpu")
    _, m0 = train.make_train_step(model, opt, train.TrainStepCfg(
        remat=True, dp_axes=()))(fresh(), batch, masks)
    _, m1 = train.make_train_step(model, opt, train.TrainStepCfg(
        remat=True, dp_axes=(), loss_chunk=8))(fresh(), batch, masks)
    assert float(m0["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(m0["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-3)


# ------------------------------------------------------------ every arch


def _arch_ids():
    from repro_torch.configs import ARCH_IDS
    return ARCH_IDS


@pytest.mark.parametrize("arch_id", _arch_ids())
def test_every_reduced_config_steps(arch_id):
    """The reference's ``test_arch_smoke_forward_and_train_step`` on the
    port: one step, finite loss and gradient norm, the counter at 1, and
    the parameters changed."""
    from repro_torch.configs import get_config
    from repro_torch.core import linearize, masks as TM
    from repro_torch.models.lm import LM
    from repro_torch.training import optimizer as opt_lib, train
    cfg = get_config(arch_id).reduced()
    model = LM(cfg)
    rng = np.random.default_rng(0)
    text = S - cfg.prefix_len
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, text),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    if cfg.prefix_len:
        batch["prefix_embeds"] = torch.from_numpy(
            (rng.normal(size=(B, cfg.prefix_len, cfg.d_model)) * 0.02
             ).astype(np.float32))
    masks = TM.as_device(linearize.init_masks(model.mask_sites()), "cpu")
    opt = opt_lib.adamw(lr=1e-3, grad_clip=1.0)
    step = train.make_train_step(model, opt,
                                 train.TrainStepCfg(remat=False, dp_axes=()))
    state = train.make_state(model, opt, torch.Generator().manual_seed(1),
                             "cpu")
    before = [t.clone() for t in opt_lib.tree_leaves(state["params"])]
    state, metrics = step(state, batch, masks)
    assert bool(torch.isfinite(metrics["loss"])), arch_id
    assert bool(torch.isfinite(metrics["grad_norm"])), arch_id
    assert int(state["step"]) == 1
    delta = sum(float((a - b).abs().sum()) for a, b in
                zip(opt_lib.tree_leaves(state["params"]), before))
    assert delta > 0

"""Training in the configs' own bfloat16: the port against the JAX package
on the CPU.

* **The train step.**  Three steps of each family's reduced config at
  ``dtype="bfloat16"`` (StableLM-2-1.6B, RWKV-6 3B, DeepSeek-MoE-16B,
  Zamba2-2.7B): the port's ``make_train_step`` and the reference's jitted
  one, each step from the reference's state before it (parameters and
  AdamW moments converted, bfloat16 kept), AdamW on a cosine schedule
  with a gradient clip of 1.0, as the launcher trains.
* **The optimizer.**  One AdamW and one SGD step on bfloat16 and float32
  leaves from equal gradients, moments and parameters, against the
  reference's jitted ``update`` + ``apply_updates``.
* **The gate's gradient.**  The plain bfloat16 backward
  (``ref.masked_act_bwd_ref``, what ``gate_bwd_kernel`` computes) against
  ``jax.vjp`` of the reference's plain gate, every activation kind, with
  and without a poly replacement.
* **Checkpoints.**  A bfloat16 train state written by the reference's
  ``checkpoint.save`` and by the port's.
* **Gradient compression** on bfloat16 gradients.

Tolerances, stated before the first run of these tests:
  * the train step: both packages' bfloat16 step is measured against the
    reference's float32 step from the same state, upcast.  Loss and
    ``grad_norm``: the port's error at most twice the reference's plus
    2⁻⁸ (one bfloat16 unit roundoff) of the value.  (Amended after the
    first run, where this term was 1e-3 of the value and DeepSeek's
    ``grad_norm`` at the third step missed it: the port 2.6e-3 off, the
    reference 4.1e-4.  The whole gradient at that state is as far from
    the float32 one in both packages — relative L2 6.97 % in the port,
    7.07 % in the reference — and the reference's own ``grad_norm`` there
    is 2.6e-3 off when taken without ``jit`` and remat: the norm of a
    bfloat16 gradient is off by about a unit roundoff, and which package
    lands nearer is chance.)  Each leaf of the new parameters, first
    and second moments: the port's relative L2 error at most twice the
    reference's plus 2⁻⁵.  The ratio, as for the logits (``test_torch_lm_bf16.py``):
    the two frameworks round at other places, and the float32 step is the
    yardstick.  The 2⁻⁵ (eight bfloat16 unit roundoffs) is for discrete
    events on one side only, whose share of a leaf's norm is not
    proportional to rounding: a MoE route that flips, or a gradient entry
    near 0 whose sign flips (Adam's first update of an entry is
    ±lr).  It was set after probe runs of the step in both packages on
    the CPU, which also showed how the reference rounds bfloat16 (below).
    Every leaf keeps the reference's dtype.
  * the optimizer: ``jnp`` rounds a Python constant to a bfloat16 array's
    type and every bfloat16 moment operation once; the port does the same
    (``training.optimizer``), so the bfloat16 moments are **equal to the
    bit**.  Parameters: at most one bfloat16 ulp apart, in at most 1 % of
    the entries, and float32 leaves within 2⁻²² of their largest entry:
    XLA contracts a float32 product and sum into one fused multiply-add
    (as in ``b1·m + (1−b1)·g``), eager PyTorch does not.  (Amended after
    the first run, where the float32 bound was 2 ulps of each entry: the
    FMA's difference is a rounding of the terms, 117 ulps of one first
    moment whose terms cancel.)
  * the gate's gradient: the port's bfloat16 dx and dpoly within 2⁻⁸
    relative of the float32 gradient (float32 arithmetic rounded once:
    half a bfloat16 ulp) plus 1e-5 of its largest entry (float32
    operations in another order: tanh and exp where they saturate, sums
    over rows), and no further from it in sum than the reference's
    bfloat16 ``jax.vjp``.  (Amended after the first run, where dx had no
    1e-5 term: at x = −4.9375 gelu's float32 derivative is 0 in JAX and
    −2.4e-6 in the port's expression, both float32 roundings of a
    derivative whose terms cancel.)
  * checkpoints: byte-identical leaf files and manifests, equal
    ``manifest_fingerprint``, restores equal to the bit.
  * ``quantize_grads_int8`` on bfloat16: equal to the bit.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from test_torch_helpers import reference, to_numpy_tree as _np

FAMILIES = ["stablelm_1p6b", "rwkv6_3b", "deepseek_moe_16b", "zamba2_2p7b"]
B, S = 2, 32
LR = 1e-3
STEPS = 3
RATIO = 2.0
METRIC_ABS = 2.0 ** -8
LEAF_ABS = 2.0 ** -5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The reduced models gain nothing from intra-op threads, and a step
    takes tens of times longer on eight contending ones than on one.  Put
    back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_tensor(a):
    """A numpy array (``ml_dtypes`` bfloat16 or another dtype) as a CPU
    tensor, bfloat16 payloads copied bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(t):
    """A tensor's or array's payload as bytes (bfloat16 as its 16 bits)."""
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.asarray(t).tobytes()


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / den if den else np.linalg.norm(got)


def _port_state(rstate):
    """The reference's train state as the port's, each leaf in its own
    dtype."""
    from repro_torch import convert
    from repro_torch.training import optimizer as opt_lib
    o = rstate["opt"]

    def cv(t):
        return convert.params_from_reference(_np(t), "cpu", dtype=None)
    return {"params": cv(rstate["params"]),
            "opt": opt_lib.OptState(
                torch.tensor(int(o.step), dtype=torch.int32), cv(o.mu),
                cv(o.nu)),
            "step": torch.tensor(int(rstate["step"]), dtype=torch.int32)}


def _parts(state, leaves):
    return {"params": leaves(state["params"]),
            "mu": leaves(state["opt"].mu), "nu": leaves(state["opt"].nu)}


# ------------------------------------------------------- the train step


@pytest.mark.parametrize("arch", FAMILIES)
def test_bfloat16_train_steps_match_the_reference(arch):
    from repro_torch.configs import get_config
    from repro_torch.core import linearize, masks as TM
    from repro_torch.data import MarkovTokens
    from repro_torch.models.lm import LM
    from repro_torch.training import optimizer as opt_lib, train
    ref = reference()
    jax, jnp = ref.jax, ref.jnp
    import repro.training.optimizer as ropt
    import repro.training.train as rtrain
    rcfg = dataclasses.replace(ref.configs.get_config(arch).reduced(),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    rmodel, tmodel = ref.lm.LM(rcfg), LM(tcfg)
    rmodel32 = ref.lm.LM(dataclasses.replace(rcfg, dtype="float32"))
    ropt_ = ropt.adamw(lr=LR, grad_clip=1.0,
                       schedule=ropt.cosine(LR, STEPS))
    topt = opt_lib.adamw(lr=LR, grad_clip=1.0,
                         schedule=opt_lib.cosine(LR, STEPS))
    kw = dict(dp_axes=(), remat=True)
    rstep = jax.jit(rtrain.make_train_step(rmodel, ropt_,
                                           rtrain.TrainStepCfg(**kw)))
    rstep32 = jax.jit(rtrain.make_train_step(rmodel32, ropt_,
                                             rtrain.TrainStepCfg(**kw)))
    tstep = train.make_train_step(tmodel, topt, train.TrainStepCfg(**kw))
    rstate = rtrain.make_state(rmodel, ropt_, jax.random.PRNGKey(0))
    rmasks = ref.masks.as_device(ref.linearize.init_masks(
        rmodel.mask_sites()))
    tmasks = TM.as_device(linearize.init_masks(tmodel.mask_sites()), "cpu")

    def upcast(t):
        return jax.tree.map(lambda a: a.astype(jnp.float32), t)

    def rleaves(t):
        return [np.asarray(a.astype(jnp.float32))
                for a in jax.tree.leaves(t)]

    def tleaves(t):
        return [a.float().numpy() for a in opt_lib.tree_leaves(t)]
    for i in range(STEPS):
        b = MarkovTokens(tcfg.vocab, seed=0).batch(B, S, i)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tstate = _port_state(rstate)
        exact, em = rstep32(upcast(rstate), jb, rmasks)
        rstate, rm = rstep(rstate, jb, rmasks)
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()}, tmasks)
        for k in ("loss", "grad_norm"):
            e, r, t = float(em[k]), float(rm[k]), float(tm[k])
            assert np.isfinite(t), (arch, i, k)
            assert abs(t - e) <= RATIO * abs(r - e) + METRIC_ABS * abs(e), \
                (arch, i, k, t, r, e)
        want_dt = _parts(rstate, lambda t: [str(a.dtype)
                                            for a in jax.tree.leaves(t)])
        got_dt = _parts(tstate, lambda t: [str(a.dtype).split(".")[-1]
                                           for a in opt_lib.tree_leaves(t)])
        assert got_dt == want_dt, (arch, i)
        assert "bfloat16" in want_dt["params"]
        e_p, r_p, t_p = (_parts(exact, rleaves), _parts(rstate, rleaves),
                         _parts(tstate, tleaves))
        for part in ("params", "mu", "nu"):
            for j, (e, r, t) in enumerate(zip(e_p[part], r_p[part],
                                              t_p[part])):
                re, te = _rel_l2(r, e), _rel_l2(t, e)
                assert te <= RATIO * re + LEAF_ABS, (arch, i, part, j, te,
                                                     re)
    assert int(tstate["step"]) == int(rstate["step"]) == STEPS


# ---------------------------------------------------------- optimizer


def _near_f32(got, want):
    """Within 2⁻²² of the leaf's largest entry: a fused multiply-add and
    a product and sum differ by a float32 rounding of the terms, which
    can be many ulps of a sum that cancels."""
    assert np.abs(got - want).max() <= 2.0 ** -22 * np.abs(want).max()


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_bfloat16_optimizer_step_matches_the_reference(name):
    import ml_dtypes
    from repro_torch.training import optimizer as opt_lib
    ref = reference()
    jax, jnp = ref.jax, ref.jnp
    import repro.training.optimizer as ropt
    bf = ml_dtypes.bfloat16
    rng = np.random.default_rng(0)

    def draw(scale, shape, dtype):
        return (rng.normal(size=shape) * scale).astype(dtype)
    shapes = {"w": ((64, 48), bf), "b": ((48,), bf),
              "s": ((48,), np.float32)}
    params = {k: draw(0.1, s, d) + (d == np.float32)
              for k, (s, d) in shapes.items()}
    grads = {k: draw(0.01, s, d) for k, (s, d) in shapes.items()}
    mu = {k: draw(1e-3, s, d) for k, (s, d) in shapes.items()}
    nu = {k: np.abs(draw(1e-4, s, np.float32)).astype(d)
          for k, (s, d) in shapes.items()}
    if name == "adamw":
        kw = dict(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
        ro = ropt.adamw(schedule=ropt.cosine(1e-3, 10), **kw)
        to = opt_lib.adamw(schedule=opt_lib.cosine(1e-3, 10), **kw)
    else:
        kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
        ro, to = ropt.sgd(**kw), opt_lib.sgd(**kw)
    adam = name == "adamw"

    def jt(t):
        return jax.tree.map(jnp.asarray, t)

    @jax.jit
    def rupdate(g, st, p):
        u, st = ro.update(g, st, p)
        return ropt.apply_updates(p, u), st
    rp, rst = rupdate(jt(grads), ropt.OptState(
        jnp.asarray(3, jnp.int32), jt(mu), jt(nu) if adam else jnp.zeros(
            ())), jt(params))

    def tl(t):
        return opt_lib.tree_leaves({k: _bf16_tensor(v) for k, v in t.items()})
    tp, tst = opt_lib.step_leaves(to, tl(grads), opt_lib.OptState(
        3, tl(mu), tl(nu) if adam else None), tl(params))
    moments = [(rst.mu, tst.mu)] + ([(rst.nu, tst.nu)] if adam else [])
    for rtree, tlist in moments:
        for r, t in zip(jax.tree.leaves(rtree), tlist):
            if t.dtype == torch.bfloat16:
                assert _bits(t) == _bits(r), name
            else:
                _near_f32(t.numpy(), np.asarray(r))
    for r, t in zip(jax.tree.leaves(rp), tp):
        r = np.asarray(r)
        if t.dtype == torch.float32:
            _near_f32(t.numpy(), r)
            continue
        a, w = t.float().numpy(), r.astype(np.float32)
        ulp = np.spacing(np.abs(w)) * 2.0 ** 16    # float32's, 16 bits on
        assert np.all(np.abs(a - w) <= ulp), name
        assert np.mean(a != w) <= 0.01, (name, np.mean(a != w))


# ------------------------------------------------------ gate backward


@pytest.mark.parametrize("with_poly", [False, True], ids=["identity",
                                                          "poly"])
@pytest.mark.parametrize("kind", ["relu", "gelu", "silu", "sqrelu"])
def test_bfloat16_gate_backward_matches_jax_grad(kind, with_poly):
    import ml_dtypes
    from repro_torch.kernels import ref as kref
    R = reference()
    jax, jnp = R.jax, R.jnp
    bf = ml_dtypes.bfloat16
    rng = np.random.default_rng(11)
    rows, cols = 96, 40
    x = (rng.normal(size=(rows, cols)) * 2).astype(bf)
    x[0, :8] = 0                                    # ties: relu'(0) = 1/2
    m = (rng.random(cols) < 0.5).astype(np.float32)
    g = rng.normal(size=(rows, cols)).astype(bf)
    p = (rng.normal(size=(3, cols)) * 0.3).astype(bf) if with_poly else None

    def vjp(dtype):
        cast = (lambda a: jnp.asarray(a, dtype))
        args = (cast(x),) + ((cast(p),) if with_poly else ())
        f = (lambda xx, *pp: R.ref.masked_act_ref(
            xx, jnp.asarray(m), kind=kind, poly=pp[0] if pp else None))
        _, back = jax.vjp(f, *args)
        return [np.asarray(a.astype(jnp.float32))
                for a in back(cast(g))]
    exact, rbf = vjp(jnp.float32), vjp(jnp.bfloat16)
    dx, dpoly = kref.masked_act_bwd_ref(
        _bf16_tensor(x), torch.from_numpy(m), _bf16_tensor(g), kind,
        None if p is None else _bf16_tensor(p), need_dpoly=with_poly)
    assert dx.dtype == torch.bfloat16
    got = [dx.float().numpy()] + ([dpoly.float().numpy()] if with_poly
                                  else [])
    if with_poly:
        assert dpoly.dtype == torch.bfloat16
    for n, (t, r, e) in enumerate(zip(got, rbf, exact)):
        slack = 1e-5 * float(np.abs(e).max())
        assert np.all(np.abs(t - e) <= 2.0 ** -8 * np.abs(e) + slack), \
            (kind, n, float(np.abs(t - e).max()))
        assert np.abs(t - e).sum() <= np.abs(r - e).sum() + slack, \
            (kind, n)


# -------------------------------------------------------- checkpoints


def test_bfloat16_checkpoints_are_byte_identical_across_packages(
        tmp_path, monkeypatch):
    """The reference's ``restore`` cannot read a bfloat16 leaf of its own
    files (``np.load`` gives ``'|V2'``, which ``jnp.asarray`` refuses);
    it refuses the port's files alike.  With ``np.load`` in the
    reference's module reading such a leaf as ``ml_dtypes``' bfloat16, as
    its manifest names it, it restores the port's checkpoint to the
    bit."""
    import ml_dtypes
    from repro_torch.training import checkpoint, optimizer as opt_lib
    ref = reference()
    jax = ref.jax
    import repro.training.optimizer as ropt
    import repro.training.train as rtrain
    rcfg = dataclasses.replace(
        ref.configs.get_config("stablelm_1p6b").reduced(), dtype="bfloat16")
    rstate = rtrain.make_state(ref.lm.LM(rcfg), ropt.adamw(lr=LR),
                               jax.random.PRNGKey(0))
    rd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    meta = {"arch": "stablelm_1p6b", "dtype": "bfloat16"}
    ref.checkpoint.save(rstate, rd, 3, meta=meta)
    tstate = _port_state(rstate)
    checkpoint.save(tstate, td, 3, meta=meta)
    files = sorted(os.listdir(os.path.join(rd, "step_00000003")))
    assert files == sorted(os.listdir(os.path.join(td, "step_00000003")))
    for f in files:
        a = open(os.path.join(rd, "step_00000003", f), "rb").read()
        b = open(os.path.join(td, "step_00000003", f), "rb").read()
        assert a == b, f
    assert ref.checkpoint.manifest_fingerprint(rd, 3) == \
        checkpoint.manifest_fingerprint(td, 3)
    dtypes = {v["dtype"] for v in
              checkpoint.read_manifest(td, 3)["leaves"].values()}
    assert dtypes == {"bfloat16", "float32", "int32"}

    # the port restores the reference's files, bit for bit
    got, step = checkpoint.restore(tstate, rd, device="cpu")
    assert step == 3
    want = jax.tree.leaves(rstate)
    leaves = opt_lib.tree_leaves(got)
    assert len(leaves) == len(want)
    for t, r in zip(leaves, want):
        assert str(t.dtype).split(".")[-1] == str(r.dtype)
        assert _bits(t) == _bits(r)

    # the reference's own restore, on either package's files
    for d in (rd, td):
        with pytest.raises(TypeError, match="V2"):
            ref.checkpoint.restore(rstate, d, 3)
    np_load = np.load

    def load(path, *a, **k):
        arr = np_load(path, *a, **k)
        return arr.view(ml_dtypes.bfloat16) if arr.dtype.str == "|V2" \
            else arr
    monkeypatch.setattr(ref.checkpoint.np, "load", load)
    back, step = ref.checkpoint.restore(rstate, td, 3)
    assert step == 3
    for r, w in zip(jax.tree.leaves(back), want):
        assert r.dtype == w.dtype and _bits(r) == _bits(w)


# ---------------------------------------------------- gradient compression


def test_quantize_grads_int8_on_bfloat16_matches_the_reference():
    import ml_dtypes
    from repro_torch.training import train
    ref = reference()
    import repro.training.train as rtrain
    bf = ml_dtypes.bfloat16
    rng = np.random.default_rng(5)
    tree = {"w": (rng.normal(size=(64, 48)) * 1e-3).astype(bf),
            "cauchy": (rng.standard_cauchy(size=(4096,)) * 10).astype(bf),
            "ties": np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5,
                              -126.5] * 160, bf),
            "zeros": np.zeros((2048,), bf),
            "small": rng.normal(size=(31, 32)).astype(bf)}
    want = ref.jax.tree.map(
        np.asarray, rtrain.quantize_grads_int8(
            ref.jax.tree.map(ref.jnp.asarray, tree)))
    got = train.quantize_grads_int8({k: _bf16_tensor(v)
                                     for k, v in tree.items()})
    for k in tree:
        assert got[k].dtype == torch.bfloat16
        assert _bits(got[k]) == _bits(want[k]), k
    assert len(np.unique(want["w"])) <= 255

"""Sharded serving over a ``("data", "model")`` mesh, on 4 CPU ranks.

The port's counterpart of the reference's
``test_sharded_decode_matches_single_device_forced_multi_device``
(``tests/test_serve.py``): reduced StableLM-2-1.6B and RWKV-6 3B on the
meshes ``(4, 1)``, ``(2, 2)`` and ``(1, 4)``, reduced DeepSeek-MoE-16B and
Zamba2-2.7B on ``(2, 2)`` and ``(1, 4)`` (``CASES``): the reference's
parameters and random binary masks, a ``(4, 6)`` prompt batch, a prefill
and four decode steps at a per-row ``(B,)`` ``cache_len``.  On each mesh of
4 ``gloo`` ranks (a ``FileStore`` in ``tmp_path``) the port's
``jit_prefill`` / ``jit_decode_step`` give the reference's single-device
tokens (``make_prefill`` / ``make_decode_step``), with logits within 1e-5
(Zamba2's within 1e-5 more than the one-process port's,
``VS_ONE_PROCESS``), and a MoE routes every token to the reference's
experts on every rank; reduced Mixtral-8x22B's prefill on ``(1, 4)``
likewise.  A ``ServeLoop(mesh=)`` makes the one-process loop's decisions
(equal ``decisions_sha256``) and serves its tokens, for every family that
decodes; ``launch/serve.py --mesh 2,2`` runs a dense, a MoE and a hybrid
config; a config whose expert columns or Mamba2 heads do not split over
the ranks is refused.  All four ranks run in one spawn for the module.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_helpers import (random_masks, reference, run_ranks,
                                to_numpy_tree)

ARCHS = ("stablelm_1p6b", "rwkv6_3b")
MESHES = ((4, 1), (2, 2), (1, 4))
TP_MESHES = ((2, 2), (1, 4))
# (arch, mesh, decode steps): the dense and RWKV-6 families on every mesh,
# the MoE and hybrid families where "model" splits, Mixtral's prefill alone
CASES = tuple((a, m, 4) for a in ARCHS for m in MESHES) + tuple(
    (a, m, 4) for a in ("deepseek_moe_16b", "zamba2_2p7b")
    for m in TP_MESHES) + (("mixtral_8x22b", (1, 4), 0),)
# ServeLoop(mesh=) and launch/serve.py run every family that decodes
LOOP_CASES = tuple(c[:2] for c in CASES if c[2])
LAUNCH_ARCHS = ("stablelm_1p6b", "deepseek_moe_16b", "zamba2_2p7b")
B, P = 4, 6
TOL = 1e-5
# Zamba2: the one-process port's cached logits are already 3.1e-5 from the
# reference's at this size (12 layers of rounding in another order;
# tests/test_torch_serve.py holds them within 1e-4), so its sharded logits
# may be no further from the reference's than the one-process port's are,
# plus TOL; and the one-process port's within ONE_PROCESS_TOL.  Traced
# (ROADMAP Queue C 9, closed): no fault — each block adds ~1e-6 in either
# package, and on these inputs the reference's own logits sit 1.9e-5 from
# a float64 evaluation, the port's 3.0e-5
# (tests/torch_zamba2_float64_trace.py), so neither bound can be tightened
ONE_PROCESS_TOL = 1e-4
VS_ONE_PROCESS = ("zamba2_2p7b",)
_CACHE = {}


def _route_spy(ref, routes):
    """The reference's ``moe_ffn`` wrapped so that each call (each MoE
    layer of a forward, in order, under ``jit`` too) appends its tokens'
    experts ``(B, S, k)``, top-k of the router's softmax as ``moe_ffn``
    takes them, to ``routes``.  Returns the original."""
    jax, jnp = ref.jax, ref.jnp
    orig = ref.moe.moe_ffn

    def spy(p, c, x, *a, **kw):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
        eidx = jax.lax.top_k(probs, c.top_k)[1]
        jax.debug.callback(lambda e: routes.append(np.asarray(e)), eidx,
                           ordered=True)
        return orig(p, c, x, *a, **kw)
    ref.moe.moe_ffn = spy
    return orig


def _reference_run(arch, gen):
    """The reference's single-device serving on reduced ``arch``: its
    parameters, masks, prompt, tokens ``(B, 1 + gen)`` (prefill's then
    decode's, as ``make_decode_step`` gives them), the logits each was
    taken from and, for a MoE, each forward's routes (a list a forward,
    one ``(B, S, k)`` array a MoE layer)."""
    ref = reference()
    jax, jnp = ref.jax, ref.jnp
    cfg = ref.configs.get_config(arch).reduced()
    model = ref.lm.LM(cfg)
    params = model.init(jax.random.PRNGKey(0))
    masks = random_masks(model.mask_sites(), 3)
    mdev = ref.masks.as_device(masks)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)
    max_len = P + gen + 1
    routes, calls = [], []
    orig = _route_spy(ref, routes) if cfg.n_experts else None
    try:
        prefill = jax.jit(ref.serve.make_prefill(model))
        last, cache = prefill(params, mdev, jnp.asarray(prompt),
                              model.init_cache(B, max_len))
        jax.effects_barrier()
        calls.append(list(routes))
        tok = jnp.argmax(last, -1)[:, None].astype(jnp.int32)
        step = ref.serve.make_decode_step(model)

        def decode(p, m, t, c, cl):
            # the reference's decode step, and the logits it took its
            # argmax of (one compilation; XLA computes the shared forward
            # once, but its routes are reported twice)
            return step(p, m, t, c, cl), model.forward(p, m, t, cache=c,
                                                       cache_len=cl)[0]
        decode = jax.jit(decode)
        toks, logits = [np.asarray(tok)], [np.asarray(last)]
        for t in range(gen):
            cl = jnp.asarray(np.full((B,), P + t, np.int32))
            del routes[:]
            (nxt, cache), lg = decode(params, mdev, tok, cache, cl)
            jax.effects_barrier()
            n = len(routes) // 2
            assert all(np.array_equal(a, b)
                       for a, b in zip(routes[:n], routes[n:]))
            calls.append(list(routes[:n]))
            assert np.array_equal(np.asarray(nxt)[:, 0],
                                  np.asarray(jnp.argmax(lg[:, -1], -1)))
            tok = nxt
            toks.append(np.asarray(tok))
            logits.append(np.asarray(lg[:, -1]))
    finally:
        if orig is not None:
            ref.moe.moe_ffn = orig
    return dict(params=to_numpy_tree(params), masks=masks, prompt=prompt,
                tokens=np.concatenate(toks, 1), logits=np.stack(logits),
                routes=calls if cfg.n_experts else None)


def _serve_loop(model, params, mesh):
    """A ``ServeLoop`` under a virtual clock: two budgets, four slots,
    exact-length prompts; returns its decisions' sha256 and every
    request's tokens."""
    from repro_torch.launch import faults, serve_loop
    store = serve_loop.threshold_mask_sets(model, [1.0, 0.5], seed=1,
                                           device="cpu")
    loop = serve_loop.ServeLoop(
        model, params, store, serve_loop.default_classes(store, 5),
        slots=4, max_len=32, prompt_bucket=None, mesh=mesh, device="cpu",
        clock=faults.VirtualClock(), queue_cap=4)
    rng = np.random.default_rng(2)
    reqs = [loop.submit(rng.integers(0, model.cfg.vocab,
                                     int(rng.integers(3, 20))),
                        store.names[i % 2]) for i in range(10)]
    loop.shutdown(drain=True)
    return loop.stats()["decisions_sha256"], [list(r.tokens) for r in reqs]


def _spy_routes(routes):
    """The port's ``moe._top_k`` wrapped so that each call (each MoE layer
    of a forward) appends its experts to ``routes``; returns the
    original."""
    from repro_torch.models import moe
    orig = moe._top_k

    def spy(logits, c):
        gates, eidx = orig(logits, c)
        routes.append(eidx.numpy().astype(np.int32))
        return gates, eidx
    moe._top_k = spy
    return orig


def _serve_case(run, arch, shape, gen):
    """Prefill and ``gen`` decode steps of reduced ``arch`` on ``shape``,
    this rank's tokens, whole logits and each forward's routes."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import masks as M
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe
    from repro_torch.models.lm import LM
    from repro_torch.training import serve as serve_lib
    model = LM(get_config(arch).reduced())
    masks = M.as_device(run["masks"], "cpu")
    prompt = torch.from_numpy(run["prompt"])
    mesh = mesh_lib.make_host_mesh(*shape, device="cpu")
    scfg = serve_lib.ServeCfg(max_len=P + gen + 1, batch=B)
    held = serve_lib.serve_shardings(model, mesh, scfg).held_params
    params = convert.params_from_reference(run["params"], "cpu",
                                           specs=held, mesh=mesh)
    tpm = model.on_mesh(mesh)
    prefill = serve_lib.jit_prefill(model, mesh, scfg)
    decode = serve_lib.jit_decode_step(model, mesh, scfg)
    routes, calls = [], []
    orig = _spy_routes(routes)
    try:
        with torch.no_grad():
            cache = tpm.init_cache(B, P + gen + 1, "cpu")
            last, cache = prefill(params, masks, prompt, cache)
            calls.append(list(routes))
            tok = serve_lib.greedy_tokens(last, tpm, B)
            toks = [tok]
            logits = [serve_lib.gather_logits(last, tpm, B)]
            for t in range(gen):
                cl = np.full((B,), P + t, np.int64)
                del routes[:]
                tok, cache, last = decode(params, masks, tok, cache, cl)
                calls.append(list(routes))
                toks.append(tok)
                logits.append(serve_lib.gather_logits(last, tpm, B))
    finally:
        moe._top_k = orig
    return dict(tokens=torch.cat(toks, 1).numpy(),
                logits=torch.stack(logits).numpy(),
                routes=calls if model.cfg.n_experts else None,
                rows=serve_lib.local_rows(np.arange(B), tpm, B),
                params=params)


def _one_process_logits(run, arch, gen):
    """The one-process port's prefill and decode logits ``(1 + gen, B,
    V)`` of the reference's parameters, fed the reference's tokens."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import masks as M
    from repro_torch.models.lm import LM
    from repro_torch.training import serve as serve_lib
    model = LM(get_config(arch).reduced())
    params = convert.params_from_reference(run["params"], "cpu")
    masks = M.as_device(run["masks"], "cpu")
    decode = serve_lib.make_decode_step(model)
    with torch.no_grad():
        cache = model.init_cache(B, P + gen + 1, "cpu")
        last, cache = serve_lib.make_prefill(model)(
            params, masks, torch.from_numpy(run["prompt"]), cache)
        out = [last]
        for t in range(gen):
            tok = torch.from_numpy(run["tokens"][:, t:t + 1])
            _, cache, last = decode(params, masks, tok, cache,
                                    np.full((B,), P + t, np.int64))
            out.append(last)
    return torch.stack(out).numpy()


def _on_ranks(rank, world, runs):
    """Every case of the module on this rank."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib, serve as serve_launch
    from repro_torch.models.lm import LM
    out = {}
    for arch, shape, gen in CASES:
        case = _serve_case(runs[arch], arch, shape, gen)
        params = case.pop("params")
        if (arch, shape) in LOOP_CASES:
            model = LM(get_config(arch).reduced())
            mesh = mesh_lib.make_host_mesh(*shape, device="cpu")
            case["fingerprint"], case["loop_tokens"] = _serve_loop(
                model, params, mesh)
        out[(arch, shape)] = case
    # expert columns and Mamba2 heads that do not split over 4 ranks
    refused = {}
    for arch, change in (("deepseek_moe_16b", dict(d_ff_expert=30)),
                         ("zamba2_2p7b", dict(mamba_head_dim=64))):
        try:
            LM(dataclasses.replace(get_config(arch).reduced(), **change),
               mesh_lib.make_host_mesh(1, 4, device="cpu"))
            refused[arch] = None
        except NotImplementedError as e:
            refused[arch] = str(e)
    out["refused"] = refused
    out["launch"] = [serve_launch.main(
        ["--arch", arch, "--reduced", "--batch", "4", "--prompt-len", "8",
         "--gen", "3", "--mesh", "2,2", "--device", "cpu"])
        for arch in LAUNCH_ARCHS]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if "runs" not in _CACHE:
        gens = {a: g for a, _, g in CASES}
        ref_runs = {arch: _reference_run(arch, g)
                    for arch, g in gens.items()}
        ranks = run_ranks(_on_ranks, 4, tmp_path_factory.mktemp("ranks"),
                          ref_runs, timeout=150)
        for arch in VS_ONE_PROCESS:
            ref_runs[arch]["one_process"] = _one_process_logits(
                ref_runs[arch], arch, gens[arch])
        _CACHE["runs"] = (ref_runs, ranks)
    return _CACHE["runs"]


@pytest.mark.parametrize(
    "arch,shape", [c[:2] for c in CASES],
    ids=[f"{a}-{m[0]}x{m[1]}" for a, m, _ in CASES])
def test_sharded_prefill_and_decode_give_the_reference_tokens(runs, arch,
                                                              shape):
    """Tokens equal, logits within 1e-5 of the reference's (Zamba2: within
    1e-5 more than the one-process port's, which are within 1e-4) and, for
    a MoE, every forward's routes of the rank's rows equal to the
    reference's, on every rank."""
    ref_runs, ranks = runs
    want = ref_runs[arch]
    tol = TOL
    if arch in VS_ONE_PROCESS:
        one = float(np.abs(want["one_process"] - want["logits"]).max())
        assert one <= ONE_PROCESS_TOL
        tol = TOL + one
    for rank, got in enumerate(ranks):
        case = got[(arch, shape)]
        assert np.array_equal(case["tokens"], want["tokens"]), rank
        err = float(np.abs(case["logits"] - want["logits"]).max())
        assert err <= tol, (rank, err, tol)
        if want["routes"] is not None:
            assert len(case["routes"]) == len(want["routes"])
            for a, b in zip(case["routes"], want["routes"]):
                assert len(a) == len(b) == 2, rank     # two MoE layers
                assert all(np.array_equal(x, y[case["rows"]])
                           for x, y in zip(a, b)), rank


@pytest.mark.parametrize(
    "arch,shape", LOOP_CASES,
    ids=[f"{a}-{m[0]}x{m[1]}" for a, m in LOOP_CASES])
def test_sharded_serve_loop_makes_the_one_process_decisions(runs, arch,
                                                            shape):
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    ref_runs, ranks = runs
    model = LM(get_config(arch).reduced())
    key = ("one", arch)
    if key not in _CACHE:
        params = convert.params_from_reference(ref_runs[arch]["params"],
                                               "cpu")
        _CACHE[key] = _serve_loop(model, params, None)
    fp, toks = _CACHE[key]
    for got in ranks:
        case = got[(arch, shape)]
        assert case["fingerprint"] == fp
        assert case["loop_tokens"] == toks


def test_moe_and_mamba2_refuse_a_model_split_naming_the_queue(runs):
    """The MoE and Mamba2 blocks split over "model" (the cases above):
    the model ranks of one batch slice route its tokens alike, and only a
    config whose expert columns or Mamba2 heads do not split over the
    ranks is refused, naming them."""
    ranks = runs[1]
    for arch, shape, _ in CASES:
        if runs[0][arch]["routes"] is None:
            continue
        by_rows = {}
        for got in ranks:
            case = got[(arch, shape)]
            by_rows.setdefault(tuple(case["rows"]), []).append(
                case["routes"])
        assert len(by_rows) == shape[0]
        for same in by_rows.values():
            assert len(same) == shape[1]
            for other in same[1:]:
                for a, b in zip(other, same[0]):
                    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for got in ranks:
        refused = got["refused"]
        assert "30 expert columns" in refused["deepseek_moe_16b"]
        assert "2 Mamba2 heads" in refused["zamba2_2p7b"]
        assert all("do not split" in m for m in refused.values())


def test_launch_serve_runs_on_a_mesh(runs):
    """``launch/serve.py --mesh 2,2`` of a dense, a MoE and a hybrid
    config exits 0 on every rank."""
    assert [got["launch"] for got in runs[1]] == \
        [[0] * len(LAUNCH_ARCHS)] * 4


def test_collectives_of_one_rank_are_the_identity():
    """On an axis of one rank every collective returns its input, bit for
    bit; the vocabulary-split argmax is ``argmax``'s first largest."""
    from repro_torch.core import spmd
    one = spmd.Axis("model", None, 1, 0)
    t = torch.randn(3, 5)
    for fn in (lambda x: spmd.all_reduce_sum(x, one),
               lambda x: spmd.all_reduce_max(x, one),
               lambda x: spmd.enter(x, one),
               lambda x: spmd.all_gather_dim(x, 1, one),
               lambda x: spmd.reduce_scatter_dim(x, 0, one)):
        assert fn(t) is t
    tied = torch.tensor([[1.0, 3.0, 3.0, 2.0]])
    assert spmd.argmax(tied, one).tolist() == [1]
    assert spmd.argmax(tied, None).tolist() == [1]


def test_moe_and_mamba2_on_a_model_axis_of_one_rank_are_bitwise():
    """``moe_ffn(tp=)`` and ``mamba_block(tp=)`` on a ``"model"`` axis of
    one rank equal their calls without ``tp``, bit for bit: one mask and
    stacked masks, both MoE dispatch modes with a shared expert, the
    Mamba2 block with and without a cache."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.core import linearize, spmd
    from repro_torch.models import lm, moe, ssm
    one = spmd.Axis("model", None, 1, 0)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    x = torch.randn(2, 8, 64, generator=gen)
    cfg = get_config("deepseek_moe_16b").reduced()
    sites = lm._sites_for(cfg, cfg.pattern[0])
    for dispatch in ("scatter", "gather"):
        mc = dc.replace(lm._moe_cfg(cfg), dispatch=dispatch)
        p = moe.moe_init(gen, mc, torch.float32, "cpu")
        for n in (None, 3):
            lead = () if n is None else (n,)
            m = torch.from_numpy((rng.random(lead + (4, 32)) < 0.6)
                                 .astype(np.float32))
            ms = torch.from_numpy((rng.random(lead + (32,)) < 0.6)
                                  .astype(np.float32))
            args = (p, mc, x, m, sites["moe"], ms, sites["moe_shared"])
            assert torch.equal(moe.moe_ffn(*args, tp=one),
                               moe.moe_ffn(*args))
    zb = get_config("zamba2_2p7b").reduced()
    mc = lm._mamba_cfg(zb)
    p = ssm.mamba_init(gen, mc, torch.float32, "cpu")
    site = linearize.MaskSite((mc.d_inner,), "silu", zb.act_when_masked)
    m = torch.from_numpy((rng.random(mc.d_inner) < 0.6).astype(np.float32))
    assert torch.equal(ssm.mamba_block(p, mc, x, m, site, tp=one),
                       ssm.mamba_block(p, mc, x, m, site))
    stacked = torch.stack([m, 1 - m])
    assert torch.equal(ssm.mamba_block(p, mc, x, stacked, site, tp=one),
                       ssm.mamba_block(p, mc, x, stacked, site))
    for S in (8, 1):
        got, want = [], []
        for out, kw in ((got, dict(tp=one)), (want, {})):
            cache = (torch.zeros(2, mc.n_heads, mc.d_state, mc.head_dim),
                     torch.zeros(2, mc.d_conv - 1, mc.d_inner))
            y, (s, c) = ssm.mamba_block(p, mc, x[:, :S], m, site,
                                        cache=cache, **kw)
            out += [y, s, c]
        assert all(torch.equal(a, b) for a, b in zip(got, want))

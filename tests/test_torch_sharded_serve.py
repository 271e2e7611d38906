"""Sharded serving over a ``("data", "model")`` mesh, on 4 CPU ranks.

The port's counterpart of the reference's
``test_sharded_decode_matches_single_device_forced_multi_device``
(``tests/test_serve.py``): reduced StableLM-2-1.6B and RWKV-6 3B, the
reference's parameters and random binary masks, a ``(4, 6)`` prompt batch,
a prefill and four decode steps at a per-row ``(B,)`` ``cache_len``.  On
each mesh ``(4, 1)``, ``(2, 2)`` and ``(1, 4)`` of 4 ``gloo`` ranks (a
``FileStore`` in ``tmp_path``) the port's ``jit_prefill`` /
``jit_decode_step`` give the reference's single-device tokens
(``make_prefill`` / ``make_decode_step``), with logits within 1e-5; a
``ServeLoop(mesh=)`` makes the one-process loop's decisions (equal
``decisions_sha256``) and serves its tokens; ``launch/serve.py --mesh 2,2``
runs; MoE and Mamba2 refuse a model split, naming ``ROADMAP.md`` Queue
A13.  All four ranks run in one spawn for the module.
"""
import numpy as np
import pytest
import torch

from test_torch_helpers import (random_masks, reference, run_ranks,
                                to_numpy_tree)

ARCHS = ("stablelm_1p6b", "rwkv6_3b")
MESHES = ((4, 1), (2, 2), (1, 4))
B, P, G = 4, 6, 4
TOL = 1e-5
_CACHE = {}


def _reference_run(arch):
    """The reference's single-device serving on reduced ``arch``: its
    parameters, masks, prompt, tokens ``(B, 1 + G)`` (prefill's then
    decode's, as ``make_decode_step`` gives them) and the logits each was
    taken from."""
    ref = reference()
    jax, jnp = ref.jax, ref.jnp
    cfg = ref.configs.get_config(arch).reduced()
    model = ref.lm.LM(cfg)
    params = model.init(jax.random.PRNGKey(0))
    masks = random_masks(model.mask_sites(), 3)
    mdev = ref.masks.as_device(masks)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)
    max_len = P + G + 1
    prefill = jax.jit(ref.serve.make_prefill(model))
    last, cache = prefill(params, mdev, jnp.asarray(prompt),
                          model.init_cache(B, max_len))
    tok = jnp.argmax(last, -1)[:, None].astype(jnp.int32)
    step = ref.serve.make_decode_step(model)

    def decode(p, m, t, c, cl):
        # the reference's decode step, and the logits it took its argmax
        # of (one compilation; XLA computes the shared forward once)
        return step(p, m, t, c, cl), model.forward(p, m, t, cache=c,
                                                   cache_len=cl)[0]
    decode = jax.jit(decode)
    toks, logits = [np.asarray(tok)], [np.asarray(last)]
    for t in range(G):
        cl = jnp.asarray(np.full((B,), P + t, np.int32))
        (nxt, cache), lg = decode(params, mdev, tok, cache, cl)
        assert np.array_equal(np.asarray(nxt)[:, 0],
                              np.asarray(jnp.argmax(lg[:, -1], -1)))
        tok = nxt
        toks.append(np.asarray(tok))
        logits.append(np.asarray(lg[:, -1]))
    return dict(params=to_numpy_tree(params), masks=masks, prompt=prompt,
                tokens=np.concatenate(toks, 1), logits=np.stack(logits))


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


def _on_ranks(rank, world, runs):
    """Every case of the module on this rank."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import masks as M
    from repro_torch.launch import mesh as mesh_lib, serve as serve_launch
    from repro_torch.models.lm import LM
    from repro_torch.training import serve as serve_lib
    out = {}
    for arch, run in runs.items():
        model = LM(get_config(arch).reduced())
        masks = M.as_device(run["masks"], "cpu")
        prompt = torch.from_numpy(run["prompt"])
        for shape in MESHES:
            mesh = mesh_lib.make_host_mesh(*shape, device="cpu")
            scfg = serve_lib.ServeCfg(max_len=P + G + 1, batch=B)
            held = serve_lib.serve_shardings(model, mesh, scfg).held_params
            params = convert.params_from_reference(run["params"], "cpu",
                                                   specs=held, mesh=mesh)
            tpm = model.on_mesh(mesh)
            prefill = serve_lib.jit_prefill(model, mesh, scfg)
            decode = serve_lib.jit_decode_step(model, mesh, scfg)
            with torch.no_grad():
                cache = tpm.init_cache(B, P + G + 1, "cpu")
                last, cache = prefill(params, masks, prompt, cache)
                tok = serve_lib.greedy_tokens(last, tpm, B)
                toks = [tok]
                logits = [serve_lib.gather_logits(last, tpm, B)]
                for t in range(G):
                    cl = np.full((B,), P + t, np.int64)
                    tok, cache, last = decode(params, masks, tok, cache, cl)
                    toks.append(tok)
                    logits.append(serve_lib.gather_logits(last, tpm, B))
            fp, loop_tokens = _serve_loop(model, params, mesh)
            out[(arch, shape)] = dict(
                tokens=torch.cat(toks, 1).numpy(),
                logits=torch.stack(logits).numpy(), fingerprint=fp,
                loop_tokens=loop_tokens)
    refused = {}
    for arch in ("deepseek_moe_16b", "zamba2_2p7b"):
        try:
            LM(get_config(arch).reduced(),
               mesh_lib.make_host_mesh(1, 4, device="cpu"))
            refused[arch] = None
        except NotImplementedError as e:
            refused[arch] = str(e)
    out["refused"] = refused
    out["launch"] = serve_launch.main(
        ["--arch", "stablelm_1p6b", "--reduced", "--batch", "4",
         "--prompt-len", "8", "--gen", "3", "--mesh", "2,2",
         "--device", "cpu"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if "runs" not in _CACHE:
        ref_runs = {arch: _reference_run(arch) for arch in ARCHS}
        ranks = run_ranks(_on_ranks, 4, tmp_path_factory.mktemp("ranks"),
                          ref_runs, timeout=150)
        _CACHE["runs"] = (ref_runs, ranks)
    return _CACHE["runs"]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_give_the_reference_tokens(runs, arch,
                                                              shape):
    ref_runs, ranks = runs
    want = ref_runs[arch]
    for rank, got in enumerate(ranks):
        case = got[(arch, shape)]
        assert np.array_equal(case["tokens"], want["tokens"]), rank
        err = float(np.abs(case["logits"] - want["logits"]).max())
        assert err <= TOL, (rank, err)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
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
    for got in runs[1]:
        for arch, msg in got["refused"].items():
            assert msg is not None and "A13" in msg, arch


def test_launch_serve_runs_on_a_mesh(runs):
    assert [got["launch"] for got in runs[1]] == [0, 0, 0, 0]


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

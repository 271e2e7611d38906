"""Reduced Zamba2's cached serving, block by block, in three evaluations:
the reference (float32, its jitted cached forward), the port (float32) and
a float64 evaluation of the same function (the port's plain path with its
parameters, cache and upcasts in float64).

For the prefill and each decode step, and each of the 12 blocks, prints
the residual stream's distance between each pair along the trajectory
(``traj_*``) and each block's local error (``local_*``): the block alone,
fed the float64 run's input and cache, in each package against float64
(the float64 evaluation: ``test_torch_helpers.float64_torch``).
Then the logits' distances over all steps.  One JSON object a line.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_zamba2_float64_trace.py

The defaults are ``tests/test_torch_sharded_serve.py``'s inputs (batch 4,
a 6-token prompt from seed 0, masks from seed 3, 4 greedy decode steps);
``--batch 2 --prompt 8 --mask-seed 2 --prompt-seed 1 --max-len 24`` are
``tests/test_torch_serve.py``'s.  CPU only, about 40 s.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

ARCH = "zamba2_2p7b"


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(v, fn) for v in tree)
    return fn(tree) if torch.is_tensor(tree) else tree


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=6)
    ap.add_argument("--mask-seed", type=int, default=3)
    ap.add_argument("--prompt-seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    from test_torch_helpers import (cast_floats, float64_torch,
                                    random_masks, reference, to_numpy_tree)
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import masks as M
    from repro_torch.models import lm as tlm
    ref = reference()
    jax, jnp = ref.jax, ref.jnp
    B, P, steps = args.batch, args.prompt, args.steps
    max_len = args.max_len or P + steps + 1

    # the reference: each block's output recorded from inside its jit
    cfg = ref.configs.get_config(ARCH).reduced()
    rmodel = ref.lm.LM(cfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    masks = random_masks(rmodel.mask_sites(), args.mask_seed)
    rm = ref.masks.as_device(masks)
    prompt = np.random.default_rng(args.prompt_seed).integers(
        0, cfg.vocab, size=(B, P)).astype(np.int32)
    seen = []
    apply = ref.lm.LM._layer_apply

    def recorded(self, blk, p, x, *a, **kw):
        y, nc = apply(self, blk, p, x, *a, **kw)
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), y,
                           ordered=True)
        return y, nc
    ref.lm.LM._layer_apply = recorded
    try:
        fwd = jax.jit(lambda p, m, t, c, cl: rmodel.forward(
            p, m, t, cache=c, cache_len=cl))
        cache = rmodel.init_cache(B, max_len)
        tok, feed = jnp.asarray(prompt), []
        ref_blocks, ref_logits = [], []
        for s in range(1 + steps):
            del seen[:]
            cl = 0 if s == 0 else jnp.asarray(np.full((B,), P + s - 1,
                                                      np.int32))
            lg, cache = fwd(rparams, rm, tok, cache, cl)
            jax.effects_barrier()
            ref_blocks.append(list(seen))
            ref_logits.append(np.asarray(lg)[:, -1].astype(np.float64))
            nxt = np.asarray(lg)[:, -1].argmax(-1)[:, None].astype(np.int32)
            feed.append(nxt)
            tok = jnp.asarray(nxt)
    finally:
        ref.lm.LM._layer_apply = apply

    # the port, float32 and float64: each block's input, cache and output
    np_params = to_numpy_tree(rparams)
    tmodel = tlm.LM(get_config(ARCH).reduced())
    tmask = M.as_device(masks, "cpu")
    modules, f64 = float64_torch()

    def port(dtype):
        calls = []
        inner = tlm.LM._layer_apply

        def spy(self, blk, p, x, masks_, prefix, opt, positions, repeat=None,
                cache=None, cache_len=0):
            call = dict(blk=blk, p=p, x=x.clone(), prefix=prefix, opt=opt,
                        positions=positions, repeat=repeat,
                        cache=_tree(cache, torch.clone), cache_len=cache_len)
            y = inner(self, blk, p, x, masks_, prefix, opt, positions,
                      repeat=repeat, cache=cache, cache_len=cache_len)
            call["y"] = y.clone()
            calls.append(call)
            return y
        saved = {m: m.torch for m in modules}
        tlm.LM._layer_apply = spy
        if dtype == torch.float64:
            for m in modules:
                m.torch = f64
        try:
            params = cast_floats(
                convert.params_from_reference(np_params, "cpu"), dtype)
            cache = cast_floats(tmodel.init_cache(B, max_len, "cpu"), dtype)
            blocks, logits = [], []
            tok = torch.from_numpy(prompt)
            with torch.no_grad():
                for s in range(1 + steps):
                    del calls[:]
                    cl = 0 if s == 0 else np.full((B,), P + s - 1, np.int64)
                    lg, cache = tmodel.forward(params, tmask, tok,
                                               cache=cache, cache_len=cl)
                    blocks.append(list(calls))
                    logits.append(lg[:, -1].to(torch.float64).numpy())
                    tok = torch.from_numpy(feed[s])
            return blocks, logits
        finally:
            tlm.LM._layer_apply = inner
            for m, t in saved.items():
                m.torch = t
    p32, l32 = port(torch.float32)
    p64, l64 = port(torch.float64)

    def ref_block(call):
        blk, prefix, rep = call["blk"], call["prefix"], call["repeat"]
        pos = prefix[1:]
        lp = rparams["stack"][pos] if blk.shared else jax.tree.map(
            lambda a: a[rep], rparams["stack"][pos])
        sub = {k.split(".", 1)[1]: v[rep] for k, v in rm.items()
               if k.startswith(prefix + ".")}
        x = jnp.asarray(call["x"].to(torch.float32).numpy())
        cl = call["cache_len"]
        cl = jnp.asarray(cl.numpy().astype(np.int32)) \
            if torch.is_tensor(cl) else cl
        rc = _tree(call["cache"], lambda t: jnp.asarray(
            t.to(torch.float32).numpy()))
        if "kv" in rc:
            rc["kv"] = tuple(rc["kv"])
        S = x.shape[1]
        f = jax.jit(lambda lp, x, sub, rc, cl: rmodel._layer_apply(
            blk, lp, x, sub, {}, False, ref.lm._positions(B, S, cl), rc,
            cl)[0])
        return np.asarray(f(lp, x, sub, rc, cl)).astype(np.float64)

    def port_block(call):
        cl = call["cache_len"]
        with torch.no_grad():
            return tmodel._layer_apply(
                call["blk"], cast_floats(call["p"], torch.float32),
                call["x"].to(torch.float32), tmask, call["prefix"],
                call["opt"], call["positions"], repeat=call["repeat"],
                cache=cast_floats(call["cache"], torch.float32),
                cache_len=cl.clone() if torch.is_tensor(cl) else cl
            ).to(torch.float64).numpy()

    def dist(a, b):
        return float(np.abs(np.asarray(a, np.float64) - b).max())
    for s in range(1 + steps):
        for i, (r, a, e) in enumerate(zip(ref_blocks[s], p32[s], p64[s])):
            y64 = e["y"].numpy()
            print(json.dumps(dict(
                step=s, block=i, kind=e["blk"].kind,
                x_max=float(np.abs(y64).max()),
                traj_ref_port=dist(r, a["y"].numpy()),
                traj_ref_f64=dist(r, y64),
                traj_port_f64=dist(a["y"].numpy(), y64),
                local_ref_f64=dist(ref_block(e), y64),
                local_port_f64=dist(port_block(e), y64))))
    print(json.dumps(dict(
        logits_ref_port=max(dist(a, b) for a, b in zip(ref_logits, l32)),
        logits_ref_f64=max(dist(a, b) for a, b in zip(ref_logits, l64)),
        logits_port_f64=max(dist(a, b) for a, b in zip(l32, l64)),
        batch=B, prompt=P, mask_seed=args.mask_seed,
        prompt_seed=args.prompt_seed, steps=steps, max_len=max_len)))


if __name__ == "__main__":
    main()

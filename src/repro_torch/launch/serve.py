"""Serving launcher: batched prefill + greedy decode, on one device or
over a ``("data", "model")`` mesh of ranks.

Counterpart of ``repro/launch/serve.py``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_3b \
        --reduced --batch 4 --prompt-len 16 --gen 8 --device cpu

``--mesh d,m`` other than ``1,1`` serves sharded
(``training.serve.jit_prefill`` / ``jit_decode_step``) on the first d·m
ranks of the process group (``python -m torch.distributed.run
--nproc_per_node d·m``, or a group the caller brought up); every rank runs
this with the same flags and rank 0 prints.  ``--device`` defaults to the
card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import linearize, masks as M
from repro_torch.models.lm import LM
from repro_torch.training import serve as serve_lib


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: LM, params, masks, prompts: torch.Tensor, gen: int, *,
             ties: bool = True, keep_logits: bool = False,
             mesh=None) -> dict:
    """Greedy continuation of a (B, P) prompt batch by ``gen`` tokens: one
    batched prefill into a fresh (B, P + gen) cache, then ``gen - 1``
    single-token decode steps at a shared ``cache_len``.

    Returns ``tokens`` (B, gen) int32, ``prefill_ms`` and ``decode_ms`` (a
    list, one wall-clock time per step, the device synchronised around
    each), and with ``keep_logits`` the last-position logits of the prefill
    and of every step (``logits``, gen tensors of (B, V)).

    ``mesh``: every rank of it calls this with the same prompts and its
    held ``params`` (``training.serve.shard_params``); the tokens (and
    kept logits) are the whole batch's on every rank."""
    device = prompts.device
    B, P = prompts.shape
    tpm = model.on_mesh(mesh)
    scfg = serve_lib.ServeCfg(max_len=P + gen, batch=B)
    prefill = serve_lib.jit_prefill(model, mesh, scfg)
    decode = serve_lib.jit_decode_step(model, mesh, scfg)

    out = {"logits": [] if keep_logits else None, "decode_ms": []}
    with torch.no_grad():
        cache = tpm.init_cache(B, P + gen, device)
        _sync(device)
        t0 = time.perf_counter()
        last, cache = prefill(params, masks, prompts, cache, ties=ties)
        tok = serve_lib.greedy_tokens(last, tpm, B)
        _sync(device)
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        toks = [tok]
        if keep_logits:
            out["logits"].append(serve_lib.gather_logits(last, tpm, B))
        for t in range(gen - 1):
            t0 = time.perf_counter()
            tok, cache, logits = decode(params, masks, tok, cache, P + t,
                                        ties=ties)
            _sync(device)
            out["decode_ms"].append((time.perf_counter() - t0) * 1e3)
            toks.append(tok)
            if keep_logits:
                out["logits"].append(serve_lib.gather_logits(logits, tpm, B))
    out["tokens"] = torch.cat(toks, dim=1)
    return out


def main(argv=None):
    """CLI entry: batched prefill + decode of random prompts."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_1p6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--mesh", default="1,1", help="data,model mesh shape")
    ap.add_argument("--keep-frac", type=float, default=1.0,
                    help="fraction of nonlinearities kept (random "
                         "thresholding — synthetic; prefer --masks-from)")
    ap.add_argument("--masks-from", default=None, metavar="RUN_DIR",
                    help="serve checkpointed masks from a sweep run dir "
                         "(fingerprint-validated) instead of random "
                         "thresholding")
    ap.add_argument("--mask-set", default=None, metavar="NAME",
                    help="which set from --masks-from to serve (e.g. b1024; "
                         "default: the first/highest budget)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    d, m = (int(x) for x in args.mesh.split(","))
    mesh = None
    if (d, m) != (1, 1):
        from repro_torch.launch import mesh as mesh_lib
        mesh = mesh_lib.make_host_mesh(d, m, args.device)
    loud = mesh is None or mesh.get_rank() == 0

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = LM(cfg)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = model.init(gen, args.device)
    if mesh is not None:
        params = serve_lib.shard_params(params, model, mesh)
    if loud:
        print(f"model {cfg.name}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, dtype={cfg.dtype}, device={args.device}, "
              f"mesh={d},{m}")
    if args.masks_from:
        shapes = {k: s.shape for k, s in model.mask_sites().items()}
        try:
            store = serve_lib.MaskSetStore.from_run_dir(
                args.masks_from, shapes,
                names=[args.mask_set] if args.mask_set else None,
                device=args.device)
            name = args.mask_set or store.names[0]
            store.verify(name)       # refuse to serve a corrupted set
        except serve_lib.MaskSetError as e:
            raise SystemExit(f"error: {e}")
        info = store.info(name)
        if loud:
            print(f"serving mask set {name!r} from {info.source} "
                  f"(relu_cost={info.relu_cost}, "
                  f"fingerprint={info.fingerprint[:12]})")
        masks0 = store.host(name)
    else:
        masks0 = linearize.init_masks(model.mask_sites())
        if args.keep_frac < 1.0:
            rng = np.random.default_rng(0)
            masks0 = M.threshold(
                {k: rng.random(v.shape).astype(np.float32)
                 for k, v in masks0.items()},
                int(M.count(masks0) * args.keep_frac))
    mdev = M.as_device(masks0, args.device)

    B, P, G = args.batch, args.prompt_len, args.gen
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (B, P))
                               .astype(np.int32)).to(args.device)
    t0 = time.perf_counter()
    out = generate(model, params, mdev, prompts, G,
                   ties=linearize.has_share_ties(masks0), mesh=mesh)
    dt = time.perf_counter() - t0
    if loud:
        print("generated:", out["tokens"].cpu().numpy()[:, :12])
        print(f"{B} seqs x ({P} prefill + {G} decode) in {dt:.2f}s "
              f"({B * G / dt:.1f} tok/s decode-equivalent)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

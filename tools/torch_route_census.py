"""How often the fused gate route reads a BCD trial apart from the unfused
one, on a 14-layer DeepSeek-MoE-16B on the card.

For each seed (weights, eval batch and candidates) and each site, 16
site-local candidates (``LM_SITED_DRC`` nonlinearities each, chunks of
``LM_CHUNK``) go through the batched and the suffix engine of
``launch.sweep.make_bcd_evaluator`` with ``fused_kernels`` False and True,
as ``chip_smoke.py``'s sited rows do.  One JSON line per (seed, site):

- ``apart``: trials read apart, to the bit, between pairs of engines and
  routes — ``suffix_fused`` against ``batched_unfused`` is the comparison
  of a tree in which only the suffix engine fuses;
- ``max_logit_diff``: the largest difference between the fused and the
  unfused full forwards of the 16 candidates (``LM.forward(fused=)``);
- ``selection``: the trial each engine would select (the first of the
  largest accuracies, as ``run_bcd`` breaks ties), and whether they part.

    python3 tools/torch_route_census.py [--src OTHER/src] [--seeds 0,1,2,3]

``--src`` imports ``repro_torch`` from another checkout's ``src/`` (a tree
in which the batched engine takes no ``fused=`` reads its fused engine as
unfused).  Runs on the card (the model is 32 GB of float32 weights);
``--reduced --device cpu`` rehearses it at the config's reduced widths.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=None)
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--sites", default="s0.moe@4,s0.moe@10")
    ap.add_argument("--layers", type=int, default=14)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device
    sys.path.insert(0, HERE)
    import torch
    if dev == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import chip_smoke as cs          # puts this checkout's src/ first
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
        # chip_smoke took the card's rates from this checkout's package
        for name in [m for m in sys.modules
                     if m.split(".")[0] == "repro_torch"]:
            del sys.modules[name]
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.core import engine as E, linearize, masks as M
    from repro_torch.launch.sweep import make_bcd_evaluator
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() if dev == "cuda" \
        else "cpu"
    print(json.dumps({"repro_torch": os.path.dirname(repro_torch.__file__),
                      "card": smi}), flush=True)
    spec = dataclasses.replace(cs.FAMILY_PATHS[0], layers=args.layers)
    cfg = get_config(spec.arch)
    cfg = dataclasses.replace(cfg.reduced() if args.reduced else cfg,
                              n_layers=args.layers)
    engines = [(f"{b}_{'fused' if f else 'unfused'}", b, f)
               for f in (False, True) for b in ("batched", "suffix")]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        model, params = cs.make_lm(seed, spec, dev, cfg=cfg)
        batch, _ = cs.make_lm_batch(model, params, seed, spec, dev)
        masks0 = linearize.init_masks(model.mask_sites())
        tokens = torch.from_numpy(batch["tokens"]).to(dev).long()
        rng = np.random.default_rng(seed)
        for site in args.sites.split(","):
            idx = M.sample_removal_indices_within(
                rng, masks0, cs.LM_SITED_DRC, 16, [site],
                repeat_sites=model.site_repeats())
            chunks = [M.materialize_candidates(masks0, idx[i:i + cs.LM_CHUNK])
                      for i in range(0, 16, cs.LM_CHUNK)]
            accs = {}
            for label, backend, fused in engines:
                ev, _, _ = make_bcd_evaluator(
                    backend, model, batch, {"params": params},
                    chunk_size=cs.LM_CHUNK, rt=16, prefetch=0,
                    fused_kernels=fused, device=dev)
                items = chunks
                if backend == "suffix":
                    ev.begin_step(masks0)
                    items = [E.SitedChunk(site, c) for c in chunks]
                accs[label] = np.concatenate([ev.evaluate(it)
                                              for it in items])
                del ev
            diff = 0.0
            with torch.no_grad():
                for c in chunks:
                    for i in range(M.stacked_len(c)):
                        m = M.as_device(M.index_stacked(c, i), dev)
                        a = model.forward(params, m, tokens[:, :-1],
                                          ties=False)
                        b = model.forward(params, m, tokens[:, :-1],
                                          ties=False, fused=True)
                        diff = max(diff, float((a - b).abs().max()))
            pick = {k: int(np.argmax(v)) for k, v in accs.items()}

            def apart(a, b):
                return [int(i) for i in np.flatnonzero(accs[a] != accs[b])]
            print(json.dumps({
                "seed": seed, "site": site, "layers": args.layers,
                "apart": {
                    "suffix_fused_vs_batched_unfused":
                        apart("suffix_fused", "batched_unfused"),
                    "suffix_fused_vs_batched_fused":
                        apart("suffix_fused", "batched_fused"),
                    "suffix_unfused_vs_batched_unfused":
                        apart("suffix_unfused", "batched_unfused"),
                    "batched_fused_vs_batched_unfused":
                        apart("batched_fused", "batched_unfused")},
                "readings_apart": {
                    str(i): {k: float(v[i]) for k, v in accs.items()}
                    for i in apart("suffix_fused", "batched_unfused")},
                "max_logit_diff": diff,
                "selection": pick,
                "selection_parts": len(set(pick.values())) > 1,
                "seconds": time.perf_counter() - t0}), flush=True)
        del model, params
        import gc
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

"""Batched serving demo on the PyTorch port: prefill a batch of prompts,
decode greedily with a KV cache (or RWKV-6's recurrent state), with
linearized (masked) FFN activations.

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch rwkv6_3b] \
        [--device cpu]

The counterpart of ``examples/serve_lm.py``, on the reduced config as
there; ``python3 -m repro_torch.launch.serve`` serves the published widths.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import linearize, masks as M
from repro_torch.launch import serve
from repro_torch.models.lm import LM


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_1p6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mask-frac", type=float, default=0.5,
                    help="fraction of nonlinearities to keep")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    model = LM(cfg)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = model.init(gen, args.device)

    # linearize a share of the activation channels (random budget for the
    # demo)
    masks0 = linearize.init_masks(model.mask_sites())
    total = M.count(masks0)
    rng = np.random.default_rng(0)
    masks = M.threshold({k: rng.random(v.shape).astype(np.float32)
                         for k, v in masks0.items()},
                        int(total * args.mask_frac))
    print(f"serving with {M.count(masks)}/{total} nonlinearities kept")

    B, P, G = args.batch, args.prompt_len, args.gen
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (B, P))
                               .astype(np.int32)).to(args.device)
    out = serve.generate(model, params, M.as_device(masks, args.device),
                         prompts, G, ties=False)
    print("prompts :", prompts.cpu().numpy()[:, :8], "...")
    print("generated:", out["tokens"].cpu().numpy())
    print(f"batch={B}, prefill={P} tok in {out['prefill_ms']:.1f} ms, "
          f"{G} tokens: the prefill's and {G - 1} decode steps at "
          f"{np.mean(out['decode_ms'] or [0]):.1f} ms a step (greedy, cache "
          f"length {P + G})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

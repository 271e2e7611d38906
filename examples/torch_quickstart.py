"""Quickstart on the PyTorch port: Network Linearization by Block Coordinate
Descent in 2 minutes.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

``examples/quickstart.py`` on ``repro_torch``.  Trains a small masked CNN
on synthetic CIFAR, runs the paper's BCD algorithm (Alg. 2) to halve the
ReLU budget, and reports accuracy + the private-inference latency this
saves under the DELPHI cost model.  ``--device`` defaults to the card.
"""
import argparse

import torch

from repro_torch.convert import to_device
from repro_torch.core import bcd, linearize, masks as M, pi_cost
from repro_torch.core.snl import finetune
from repro_torch.data import ImageDatasetCfg, SyntheticImages
from repro_torch.models.resnet import CNN, CNNConfig
from repro_torch.training import optimizer as opt_lib, train as train_lib


def build():
    """The demo CNN and its synthetic data."""
    cfg = CNNConfig("demo", 4, 16, ((8, 1, 1), (16, 1, 2)), stem_channels=8)
    data = SyntheticImages(ImageDatasetCfg(n_classes=4, image_size=16,
                                           n_train=256, n_test=64))
    return CNN(cfg), data


def bcd_config(total: int) -> bcd.BCDConfig:
    """Half the ReLUs, the quickstart's block size, trials and ADT."""
    return bcd.BCDConfig(b_target=total // 2, drc=max(1, total // 16), rt=5,
                         adt=0.3)


def main(argv=None, device=None):
    """Run the quickstart; ``device`` overrides ``--device``.  Returns what
    it printed: ``total``, ``sites``, ``b_target``, ``budget`` (reached),
    ``accuracy``, ``saving`` (``pi_cost.saving``'s three numbers), and the
    trained ``params``, the BCD ``result``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = device or ap.parse_args(argv).device

    # --- model + data -------------------------------------------------
    model, data = build()
    params = model.init(torch.Generator().manual_seed(0), device)
    opt = opt_lib.sgd(lr=5e-2, momentum=0.9)
    step, loss_fn = train_lib.make_cnn_train_step(model, opt)
    batches_np = data.batches("train", 32)

    def batches(i):
        return to_device(batches_np(i), device)

    masks = linearize.init_masks(model.mask_sites())
    total = M.count(masks)
    print(f"model has {total} ReLUs at {len(masks)} sites")

    ostate = opt.init(params)
    mdev = M.as_device(masks, device)
    for i in range(80):
        params, ostate, loss, acc = step(params, ostate, mdev, batches(i))
    print(f"trained dense model: train-batch acc {float(acc):.1f}%")
    trained = params

    # --- the paper's algorithm ----------------------------------------
    eval_b = to_device(data.train_eval_set(128), device)
    acc_fn = train_lib.make_eval_acc(
        lambda p, m: model.forward(p, m, eval_b["images"]), eval_b)

    holder = {"params": params}

    def eval_acc(m):
        return float(acc_fn(holder["params"], M.as_device(m, device)))

    def ft(m):
        holder["params"] = finetune(
            holder["params"], m,
            lambda p, mm, b, soft: loss_fn(p, mm, b, soft),
            batches, steps=10, lr=1e-2, device=device)

    cfg = bcd_config(total)
    res = bcd.run_bcd(masks, cfg, eval_acc, finetune=ft, verbose=True)

    budget = M.count(res.masks)
    print(f"\nBCD done: ||m||_0 = {budget} (target {cfg.b_target}) — "
          f"sparse by design, no thresholding step")
    accuracy = eval_acc(res.masks)
    print(f"accuracy with half the ReLUs: {accuracy:.1f}%")

    saving = pi_cost.saving(total, cfg.b_target, len(model.mask_sites()))
    l_ref, l_tgt, speedup = saving
    print(f"PI online latency (DELPHI model): {l_ref:.3f}s -> {l_tgt:.3f}s "
          f"({speedup:.2f}x faster)")
    return {"total": total, "sites": len(masks), "b_target": cfg.b_target,
            "budget": budget, "accuracy": accuracy, "saving": saving,
            "params": trained, "result": res}


if __name__ == "__main__":
    main()

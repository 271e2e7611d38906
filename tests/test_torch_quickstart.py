"""``examples/torch_quickstart.py`` on the CPU against the reference's
``examples/quickstart.py``.

The quickstart's host arithmetic — the ReLU count, the site count, the
budget BCD reaches and the DELPHI cost model's three numbers — equals the
reference's to the bit.  From the parameters the port's quickstart
trained (handed to the reference as numpy), without finetuning between
steps, the port's ``run_bcd`` selects the reference's blocks for seed 0:
the same step logs and the same final masks.
"""
import dataclasses
import importlib.util
import os

import pytest
import torch

from test_torch_helpers import reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The demo CNN gains nothing from intra-op threads.  Put back
    afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def quickstart():
    path = os.path.join(ROOT, "examples", "torch_quickstart.py")
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.main(device="cpu")


def _logs(history):
    return [{k: v for k, v in dataclasses.asdict(h).items()
             if k != "wall_s"} for h in history]


def test_quickstart_runs_and_its_arithmetic_is_the_references(quickstart):
    ref = reference()
    from repro.core import pi_cost as rpi
    mod, out = quickstart
    rmodel = ref.resnet.CNN(ref.resnet.CNNConfig(
        "demo", 4, 16, ((8, 1, 1), (16, 1, 2)), stem_channels=8))
    rmasks = ref.linearize.init_masks(rmodel.mask_sites())
    total = ref.masks.count(rmasks)
    b_target = total // 2
    assert (out["total"], out["sites"], out["b_target"]) == \
        (total, len(rmasks), b_target)
    assert out["budget"] == b_target
    assert out["saving"] == rpi.saving(total, b_target,
                                       len(rmodel.mask_sites()))
    assert 0.0 <= out["accuracy"] <= 100.0


def test_bcd_selects_the_references_blocks(quickstart):
    """The quickstart's BCD configuration, ``finetune=None``, from the
    trained parameters, on the quickstart's evaluation set."""
    ref = reference()
    from repro_torch.convert import to_device
    from repro_torch.core import bcd, linearize, masks as M
    from repro_torch.training import optimizer as opt_lib, train
    mod, out = quickstart
    model, data = mod.build()
    params = out["params"]
    rmodel = ref.resnet.CNN(ref.resnet.CNNConfig(
        "demo", 4, 16, ((8, 1, 1), (16, 1, 2)), stem_channels=8))
    rparams = ref.jax.tree.map(
        ref.jnp.asarray, opt_lib.tree_map(lambda t: t.numpy(), params))
    eval_np = data.train_eval_set(128)
    masks = linearize.init_masks(model.mask_sites())
    cfg = mod.bcd_config(M.count(masks))

    eval_b = to_device(eval_np, "cpu")
    acc_fn = train.make_eval_acc(
        lambda p, m: model.forward(p, m, eval_b["images"]), eval_b)
    got = bcd.run_bcd(masks, cfg, lambda m: float(acc_fn(
        params, M.as_device(m, "cpu"))))

    jnp = ref.jnp
    rimages, rlabels = jnp.asarray(eval_np["images"]), \
        jnp.asarray(eval_np["labels"])

    @ref.jax.jit
    def racc(p, m):
        logits = rmodel.forward(p, m, rimages)
        return jnp.mean((jnp.argmax(logits, -1) == rlabels)
                        .astype(jnp.float32)) * 100
    rcfg = ref.bcd.BCDConfig(**dataclasses.asdict(cfg))
    want = ref.bcd.run_bcd(masks, rcfg, lambda m: float(racc(
        rparams, ref.masks.as_device(m))))
    assert _logs(got.history) == _logs(want.history)
    assert M.fingerprint(got.masks) == ref.masks.fingerprint(want.masks)
    assert len(got.history) > 1

"""The port's family budget sweep (``examples/torch_family_bcd_sweep.py``)
in the configs' own bfloat16, at reduced size on the CPU.

Reduced RWKV-6 3B, DeepSeek-MoE-16B and Zamba2-2.7B with
``dtype="bfloat16"`` (``reduced()`` sets float32), parameters converted
from the reference's ``init(PRNGKey(0))`` with
``convert.params_from_reference(dtype=None)``, each swept ``--sweep
0.6,0.45 --train-steps 10`` through the example's ``main(cfg=,
device="cpu")`` on the batched engine and, from the persisted warm start,
on the suffix engine.  Compared, exactly: the two engines' stages
(fingerprints, step logs, move statistics, budgets) and the held-out loss
of each stage's finetuned parameters.

The warm start of RWKV-6 and DeepSeek-MoE (the families
``tests/test_torch_family_sweep.py`` holds in float32; the reference's
SNL compiles for ~40 s a family on the CPU) against the reference's
example functions (``examples/family_bcd_sweep.py``), from the same
bfloat16 parameters and batches, with the tolerances stated before the
first run.  The two
frameworks round bfloat16 in other places (XLA rounds every bfloat16
operation, eager PyTorch each of its own), so nothing that passes through
a bfloat16 training step can be compared to the bit:

* the schedule's budgets and the stage count: exact;
* ``train_base`` (10 AdamW steps): the held-out loss of the port's trained
  parameters within 2^-5 of the reference's, relative — bfloat16 keeps
  8 bits (2^-8) and the ten steps' updates compound it;
* SNL to B_ref: the warm start's budget is B_ref exactly in both; each
  epoch's budget (``[snl] epoch=N budget=M``) within 1 % of the total
  nonlinearity count of the reference's;
* the first BCD step from the port's persisted warm start, loaded into
  both packages: the step's budget exact, and its accuracy before the step
  (token counts over the eval batch) within one token of the reference's.
"""
import dataclasses
import importlib.util
import os
import re
import shutil

import numpy as np
import pytest
import torch

from test_torch_helpers import reference, to_jax_tree, to_numpy_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--sweep", "0.6,0.45", "--train-steps", "10", "--bench-history",
         "none"]
LOSS_REL = 2.0 ** -5
SNL_BUDGET_FRAC = 0.01
REFERENCE_WARM_START = {"rwkv6_3b", "deepseek_moe_16b"}


@pytest.fixture(autouse=True)
def _one_thread():
    """The reduced models gain nothing from intra-op threads.  Put back
    afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _log(h):
    return {k: v for k, v in h.items() if k not in ("wall_s",
                                                    "acc_after_finetune")}


class _held_out_losses:
    """Within the block, the example's stage scoring also records the
    held-out loss of the parameters it scores (each stage's, after its
    finetune), and ``train_base``'s result its own."""

    def __init__(self, ex):
        self.ex, self.losses, self.trained = ex, [], []

    def __enter__(self):
        from repro_torch.core import masks as M
        ex, self.orig = self.ex, (self.ex.make_closures, self.ex.train_base)
        orig_closures, orig_train = self.orig
        held = {}

        def make_closures(model, mt, args, device="cuda"):
            batches, sloss, test_acc = orig_closures(model, mt, args, device)
            held["b"] = {k: torch.from_numpy(v) for k, v in
                         mt.batch(args.eval_batch, args.seq, 10**6).items()}
            held["sloss"] = sloss

            def scored(m, p):
                with torch.no_grad():
                    self.losses.append(float(sloss(
                        p, M.as_device(m, "cpu"), held["b"], False)[0]))
                return test_acc(m, p)
            return batches, sloss, scored

        def train_base(args, params, masks0, sloss, batches, device="cuda"):
            out = orig_train(args, params, masks0, sloss, batches, device)
            with torch.no_grad():
                self.trained.append(float(sloss(
                    out, M.as_device(masks0, "cpu"), held["b"], False)[0]))
            return out
        ex.make_closures, ex.train_base = make_closures, train_base
        return self

    def __exit__(self, *exc):
        self.ex.make_closures, self.ex.train_base = self.orig


@pytest.mark.parametrize("arch", ["rwkv6_3b", "deepseek_moe_16b",
                                  "zamba2_2p7b"])
def test_bfloat16_family_sweep_engines_agree(arch, tmp_path, capsys):
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import bcd as B, linearize, masks as M, runner
    from repro_torch.launch import sweep as sweep_lib
    from repro_torch.models.lm import LM
    ref = reference()
    jnp = ref.jnp
    ex = _example("torch_family_bcd_sweep")
    rcfg = dataclasses.replace(ref.configs.get_config(arch).reduced(),
                               dtype="bfloat16")
    rmodel = ref.lm.LM(rcfg)
    rparams = rmodel.init(ref.jax.random.PRNGKey(0))
    params = convert.params_from_reference(to_numpy_tree(rparams), "cpu",
                                           dtype=None)
    assert params["embed"].dtype == torch.bfloat16
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")

    # ---- the port: batched, then suffix from the persisted warm start
    out, losses = {}, {}
    for engine in ("batched", "suffix"):
        d = str(tmp_path / engine)
        if engine == "suffix":
            shutil.copytree(os.path.join(str(tmp_path / "batched"), "init"),
                            os.path.join(d, "init"))
        with _held_out_losses(ex) as held:
            out[engine] = ex.main(["--arch", arch, "--engine", engine,
                                   "--out-dir", d] + FLAGS,
                                  cfg=cfg, params=params, device="cpu")
        losses[engine] = held.losses
        if engine == "batched":
            trained_loss, = held.trained
    printed = capsys.readouterr().out
    assert "reusing persisted warm start" in printed
    bat, suf = out["batched"]["stages"], out["suffix"]["stages"]
    assert out["batched"]["complete"] and out["suffix"]["complete"]
    assert [s["mask_fingerprint"] for s in bat] == \
        [s["mask_fingerprint"] for s in suf]
    for a, b in zip(bat, suf):
        for k in ("history", "move_stats", "steps", "trials_total",
                  "budget", "test_acc"):
            assert a[k] == b[k], k
    assert len(losses["batched"]) == len(bat)
    assert all(np.isfinite(losses["batched"]))
    assert losses["batched"] == losses["suffix"]
    if arch not in REFERENCE_WARM_START:
        return

    # ---- the warm start against the reference's example functions
    import repro.core.snl as rsnl
    rex = _example("family_bcd_sweep")
    args = ex.parse_args(["--arch", arch, "--out-dir", str(tmp_path)] +
                         FLAGS)
    rmasks0 = ref.linearize.init_masks(rmodel.mask_sites())
    total = int(ref.masks.count(rmasks0))
    b_ref = int(total * args.ref_frac)
    assert [s["budget"] for s in bat] == \
        [int(total * f) for f in args.sweep]
    assert len(bat) == len(args.sweep) == 2
    mt = ref.data.MarkovTokens(rcfg.vocab, seed=0)
    rbatches, rsloss, _ = rex.make_closures(rmodel, mt, args)
    trained = rsnl.finetune(rparams, rmasks0, rsloss, rbatches,
                            steps=args.train_steps, lr=ex.TRAIN_LR,
                            use_adam=True)
    held_b = {k: jnp.asarray(v) for k, v in
              mt.batch(args.eval_batch, args.seq, 10**6).items()}
    ref_trained_loss = float(rsloss(trained, rmasks0, held_b, False)[0])
    assert abs(trained_loss - ref_trained_loss) <= \
        LOSS_REL * abs(ref_trained_loss), (trained_loss, ref_trained_loss)
    alphas = {k: jnp.ones(v.shape) for k, v in rmasks0.items()}
    res = rsnl.run_snl(trained, alphas, rsloss, rbatches,
                       rsnl.SNLConfig(b_target=b_ref, **ex.SNL_CFG))
    snl_budgets = [int(b) for b in re.findall(r"\[snl\] epoch=\d+ "
                                              r"budget=(\d+)", printed)]
    want = list(res.budget_per_epoch)
    assert len(snl_budgets) == len(want)
    assert max(abs(a - b) for a, b in zip(snl_budgets, want)) <= \
        SNL_BUDGET_FRAC * total, (snl_budgets, want)
    assert int(ref.masks.count(res.stage_init()["masks"])) == b_ref

    init_dir = os.path.join(str(tmp_path / "batched"), "init")
    tmodel = LM(cfg)
    masks0 = linearize.init_masks(tmodel.mask_sites())
    start = runner.load_stage_init(init_dir, masks0, params_template=params,
                                   device="cpu")
    assert M.count(start["masks"]) == b_ref
    assert start["params"]["embed"].dtype == torch.bfloat16
    # the reference's own restore refuses the bfloat16 leaves it writes
    # itself (``np.load`` gives ``'|V2'``, which ``jnp.asarray`` rejects):
    # the port's restored warm start goes to the reference leaf by leaf,
    # bits kept
    rstart = {"masks": start["masks"],
              "params": to_jax_tree(ref, start["params"])}
    drc = max(1, (b_ref - int(total * args.sweep[-1])) // 10)
    kw = dict(b_target=b_ref - drc, drc=drc, rt=ex.RT, adt=0.3,
              chunk_size=args.chunk_size, moves=args.moves,
              proposal=args.proposal)
    eval_b = {"tokens": mt.batch(args.eval_batch, args.seq,
                                 10**6 + 1)["tokens"]}
    ev, eval_acc, _ = sweep_lib.make_bcd_evaluator(
        "batched", tmodel, eval_b, {"params": start["params"]},
        chunk_size=args.chunk_size, rt=ex.RT, device="cpu")
    got = B.run_bcd(start["masks"], B.BCDConfig(**kw), eval_acc,
                    evaluator=ev)
    rev, racc, _ = ref.sweep.make_bcd_evaluator(
        "batched", rmodel, {"tokens": jnp.asarray(eval_b["tokens"])},
        {"params": rstart["params"]}, chunk_size=args.chunk_size, rt=ex.RT)
    want = ref.bcd.run_bcd(rstart["masks"], ref.bcd.BCDConfig(**kw), racc,
                           evaluator=rev)
    assert M.count(got.masks) == int(ref.masks.count(want.masks)) == \
        b_ref - drc
    one_token = 100.0 / (args.eval_batch * args.seq)
    assert abs(got.history[0].acc_before - want.history[0].acc_before) <= \
        one_token + 1e-9, (got.history[0], want.history[0])
    assert _log(dataclasses.asdict(got.history[0]))["acc_before"] == \
        bat[0]["history"][0]["acc_before"]

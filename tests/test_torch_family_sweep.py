"""The port's family budget sweep (``examples/torch_family_bcd_sweep.py``)
at reduced size on the CPU, against the reference's
(``examples/family_bcd_sweep.py``).

Reduced RWKV-6 3B and DeepSeek-MoE-16B, with parameters converted from the
reference's ``init(PRNGKey(0))``, each swept ``--sweep 0.6,0.45
--train-steps 10`` on the batched engine and, from the persisted warm
start, on the suffix engine, as the reference's CI runs them
(``.github/workflows/ci.yml`` ``family-smoke``).  Compared, exactly:

* the two engines' stages: fingerprints, step logs, move statistics (the
  CI's gate);
* against the reference: the schedule's budgets, the stage count, SNL's
  budget per epoch (the reference's own train + SNL from the same initial
  parameters), and the first BCD step from the port's persisted warm
  start (loaded into both packages): the selected block (mask
  fingerprint) and its step log, which must also be the port's first
  logged step but for its finetuned accuracy.

Nothing is compared within a tolerance: budgets, fingerprints and step logs
are exact (the accuracies in a log are token counts over the eval batch).
"""
import dataclasses
import importlib.util
import os
import re
import shutil

import pytest
import torch

from test_torch_helpers import reference, to_numpy_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--sweep", "0.6,0.45", "--train-steps", "10", "--bench-history",
         "none"]


@pytest.fixture(autouse=True)
def _one_thread():
    """The reduced models gain nothing from intra-op threads: on one the
    file takes the same wall-clock and half the CPU time, which the other
    workers of a parallel run get back.  Put back afterwards."""
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


@pytest.mark.parametrize("arch", ["rwkv6_3b", "deepseek_moe_16b"])
def test_family_sweep_engines_agree_and_follow_the_reference(arch, tmp_path,
                                                             capsys):
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import bcd as B, linearize, masks as M, runner
    from repro_torch.launch import sweep as sweep_lib
    from repro_torch.models.lm import LM
    ref = reference()
    import repro.core.snl as rsnl
    rex = _example("family_bcd_sweep")
    ex = _example("torch_family_bcd_sweep")
    rcfg = ref.configs.get_config(arch).reduced()
    rmodel = ref.lm.LM(rcfg)
    rparams = rmodel.init(ref.jax.random.PRNGKey(0))
    params = convert.params_from_reference(to_numpy_tree(rparams), "cpu")
    cfg = get_config(arch).reduced()

    # ---- the port: batched, then suffix from the persisted warm start
    out = {}
    for engine in ("batched", "suffix"):
        d = str(tmp_path / engine)
        if engine == "suffix":
            shutil.copytree(os.path.join(str(tmp_path / "batched"), "init"),
                            os.path.join(d, "init"))
        out[engine] = ex.main(["--arch", arch, "--engine", engine,
                               "--out-dir", d] + FLAGS,
                              cfg=cfg, params=params, device="cpu")
    printed = capsys.readouterr().out
    snl_budgets = [int(b) for b in re.findall(r"\[snl\] epoch=\d+ "
                                              r"budget=(\d+)", printed)]
    assert "reusing persisted warm start" in printed
    bat, suf = out["batched"]["stages"], out["suffix"]["stages"]
    assert out["batched"]["complete"] and out["suffix"]["complete"]
    assert [s["mask_fingerprint"] for s in bat] == \
        [s["mask_fingerprint"] for s in suf]
    for a, b in zip(bat, suf):
        for k in ("history", "move_stats", "steps", "trials_total",
                  "budget"):
            assert a[k] == b[k], k

    # ---- the reference: schedule, SNL's budgets per epoch
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
    alphas = {k: ref.jnp.ones(v.shape) for k, v in rmasks0.items()}
    res = rsnl.run_snl(trained, alphas, rsloss, rbatches,
                       rsnl.SNLConfig(b_target=b_ref, **ex.SNL_CFG))
    assert snl_budgets and snl_budgets == list(res.budget_per_epoch)

    # ---- the first BCD step from the port's warm start, in both packages
    init_dir = os.path.join(str(tmp_path / "batched"), "init")
    tmodel = LM(cfg)
    masks0 = linearize.init_masks(tmodel.mask_sites())
    start = runner.load_stage_init(init_dir, masks0, params_template=params,
                                   device="cpu")
    rstart = ref.runner.load_stage_init(init_dir, rmasks0,
                                        params_template=rparams)
    b_init = M.count(start["masks"])
    drc = max(1, (b_ref - int(total * args.sweep[-1])) // 10)
    kw = dict(b_target=b_init - drc, drc=drc, rt=ex.RT, adt=0.3,
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
        "batched", rmodel, {"tokens": ref.jnp.asarray(eval_b["tokens"])},
        {"params": rstart["params"]}, chunk_size=args.chunk_size, rt=ex.RT)
    want = ref.bcd.run_bcd(rstart["masks"], ref.bcd.BCDConfig(**kw), racc,
                           evaluator=rev)
    assert M.fingerprint(got.masks) == ref.masks.fingerprint(want.masks)
    logs = [_log(dataclasses.asdict(h)) for h in got.history]
    assert logs == [_log(dataclasses.asdict(h)) for h in want.history]
    assert logs[0] == _log(bat[0]["history"][0])

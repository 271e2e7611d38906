"""The port's budget sweeps (``repro_torch.launch.sweep.run_sweep``), on the
CPU.

The reference's sweep tests (``tests/test_runner.py``), each with its
counterpart: a schedule descends warm-started and a rerun skips every
completed stage; a stage interrupted mid-way resumes to the uninterrupted
result; overlapped reporting is bit-identical to serial (and runs under
the one setting of cuDNN's switches that the sweep holds, and the launch
counts lose no update across threads); an impure
``eval_test`` is refused with ``overlap``; a resume scores an unscored stage
without truncating the artifact; bad schedules are refused; a real SIGKILL
mid-stage resumes bit-identically.  Across packages: the same toy sweep
gives the reference's stages and artifact keys.  End to end: the example's
``--sweep`` mode at mini size, serial, overlapped, and killed + resumed.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_helpers import reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "torch_resnet18_bcd_pipeline.py")


def _toy_masks():
    return {"a": np.ones((24,), np.float32), "b": np.ones((24,), np.float32)}


def _toy_eval_acc(m):
    wa = np.arange(24, dtype=np.float64)
    return float(95.0 - 0.02 * (np.sum((1 - m["a"]) * wa) +
                                np.sum((1 - m["b"]) * wa[::-1])))


def _sweep_ctx(tmp_path, name="toy", bcd=None, **cfg_kw):
    from repro_torch.core import bcd as port_bcd
    from repro_torch.launch import sweep as sweep_lib
    bcd = bcd or port_bcd
    masks = _toy_masks()
    params = {"w": np.arange(4, dtype=np.float32)}
    holder = {"params": params}
    pio = (lambda: holder["params"],
           lambda p: holder.__setitem__("params", p))
    cfg = sweep_lib.SweepConfig(budgets=[36, 28],
                                out_dir=str(tmp_path / name), name=name,
                                **cfg_kw)

    def mk(b):
        return bcd.BCDConfig(b_target=b, drc=4, rt=6, adt=-1.0,
                             chunk_size=2, seed=0)
    init = {"kind": "snl", "masks": masks, "params": params}
    return holder, pio, cfg, mk, init


def _run(cfg, mk, init, pio, **kw):
    from repro_torch.launch import sweep as sweep_lib
    return sweep_lib.run_sweep(cfg, mk, _toy_eval_acc, init=init,
                               params_io=pio, device="cpu", **kw)


def test_sweep_descends_warm_started_and_resumes(tmp_path):
    from repro_torch.core import masks as M
    from repro_torch.launch import sweep as sweep_lib
    holder, pio, cfg, mk, init = _sweep_ctx(tmp_path)
    res = _run(cfg, mk, init, pio, eval_test=_toy_eval_acc)
    assert res["complete"] and [s["budget"] for s in res["stages"]] == \
        [36, 28]
    assert M.count(res["final_masks"]) == 28
    assert M.is_subset(res["final_masks"], _toy_masks())
    assert res["stages"][0]["mask_fingerprint"] != \
        res["stages"][1]["mask_fingerprint"]
    art = json.load(open(res["artifact"]))
    assert art["complete"] and len(art["stages"]) == 2
    assert all("wall_s" not in h for s in art["stages"]
               for h in s["history"])

    # re-run: both stages skip (their warm starts restored as tensors),
    # notes merged out of band survive
    sweep_lib.update_notes(cfg, {"auto_prefetch": {"prefetch": 2}})
    res2 = _run(cfg, mk, init, pio, eval_test=_toy_eval_acc)
    assert [s["mask_fingerprint"] for s in res2["stages"]] == \
        [s["mask_fingerprint"] for s in res["stages"]]
    assert res2["notes"]["auto_prefetch"] == {"prefetch": 2}
    assert isinstance(holder["params"]["w"], torch.Tensor)


def test_sweep_interrupted_mid_stage_matches_uninterrupted(tmp_path):
    from repro_torch.core import runner
    from repro_torch.launch import sweep as sweep_lib
    _, pio, cfg_a, mk, init = _sweep_ctx(tmp_path, "ref")
    ref = _run(cfg_a, mk, init, pio)

    _, pio, cut, mk, init = _sweep_ctx(tmp_path, "cut")
    runner.save_stage_init(sweep_lib.init_dir(cut), init)
    part = runner.BCDRunner(
        mk(cut.budgets[0]),
        runner.RunnerConfig(
            ckpt_dir=os.path.join(sweep_lib._stage_dir(cut, 0), "ckpt"),
            max_steps=1),
        _toy_eval_acc, params_io=pio, device="cpu")
    part.run(init["masks"])
    assert part.stopped_early
    res = _run(cut, mk, init, pio)
    assert [s["mask_fingerprint"] for s in res["stages"]] == \
        [s["mask_fingerprint"] for s in ref["stages"]]
    assert [s["history"] for s in res["stages"]] == \
        [s["history"] for s in ref["stages"]]
    assert res["stages"][0]["resumed_from"] == 1


def test_overlap_sweep_bit_identical_to_serial(tmp_path):
    """Masks, step histories and scores of the overlapped sweep are the
    serial sweep's; every evaluation, in the descent and in the reporting
    thread, saw the one setting of cuDNN's switches ``run_sweep`` holds
    (a finetune's own ``deterministic()`` restores what was in force)."""
    from repro_torch.core import masks as M
    from repro_torch.training.train import deterministic
    cudnn = torch.backends.cudnn
    seen = set()

    def watched_eval(m):
        seen.add((cudnn.deterministic, cudnn.benchmark))
        return _toy_eval_acc(m)

    def sft(p, m):                 # a reporting finetune, pure in (p, m)
        with deterministic():
            seen.add((cudnn.deterministic, cudnn.benchmark))
            return {"w": p["w"] + np.float32(M.count(m))}

    def sev(m, p):
        seen.add((cudnn.deterministic, cudnn.benchmark))
        return _toy_eval_acc(m) + float(np.sum(np.asarray(p["w"])))

    def run(name, overlap):
        from repro_torch.launch import sweep as sweep_lib
        _, pio, cfg, mk, init = _sweep_ctx(tmp_path, name, overlap=overlap)
        return sweep_lib.run_sweep(cfg, mk, watched_eval, init=init,
                                   params_io=pio, stage_finetune=sft,
                                   stage_eval=sev, device="cpu")

    before = (cudnn.deterministic, cudnn.benchmark)
    serial = run("serial", overlap=False)
    over = run("over", overlap=True)
    assert (cudnn.deterministic, cudnn.benchmark) == before
    assert seen == {(True, False)}
    assert serial["complete"] and over["complete"]
    for a, b in zip(serial["stages"], over["stages"]):
        assert a["mask_fingerprint"] == b["mask_fingerprint"]
        assert a["history"] == b["history"]
        assert a["test_acc"] == b["test_acc"]
    art = json.load(open(over["artifact"]))
    assert art["complete"]
    assert [s.get("test_acc") for s in art["stages"]] == \
        [s["test_acc"] for s in serial["stages"]]


def test_launch_counts_lose_no_update_across_threads():
    """Overlapped reporting launches kernels from a second thread; the
    counts the smoke run reads must not lose an increment (more threads
    than cores, a short switch interval)."""
    import threading
    from repro_torch.kernels import build
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        build.reset_launch_counts()

        def work():
            for _ in range(2000):
                build.count_launch("masked_act_conv3x3_batched", "tf32x3")
        threads = [threading.Thread(target=work)
                   for _ in range(2 * (os.cpu_count() or 1) + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        n = 2000 * len(threads)
        assert build.launch_counts["masked_act_conv3x3_batched"] == n
        assert build.route_counts["masked_act_conv3x3_batched:tf32x3"] == n
    finally:
        sys.setswitchinterval(saved)
        build.reset_launch_counts()


def test_overlap_rejects_impure_eval_test(tmp_path):
    _, pio, cfg, mk, init = _sweep_ctx(tmp_path, overlap=True)
    with pytest.raises(ValueError, match="stage_eval"):
        _run(cfg, mk, init, pio, eval_test=_toy_eval_acc)


def test_resumed_sweep_scores_unscored_stages(tmp_path):
    from repro_torch.launch import sweep as sweep_lib
    _, pio, cfg, mk, init = _sweep_ctx(tmp_path)
    sev = lambda m, p: _toy_eval_acc(m)              # noqa: E731
    res = _run(cfg, mk, init, pio, stage_eval=sev)
    rp = os.path.join(sweep_lib._stage_dir(cfg, 0), "result.json")
    stage = json.load(open(rp))
    want = stage.pop("test_acc")
    json.dump(stage, open(rp, "w"))
    res2 = _run(cfg, mk, init, pio, stage_eval=sev)
    assert res2["stages"][0]["test_acc"] == want
    assert json.load(open(rp))["test_acc"] == want
    assert [s["mask_fingerprint"] for s in res2["stages"]] == \
        [s["mask_fingerprint"] for s in res["stages"]]


def test_rescore_does_not_truncate_artifact(tmp_path):
    from repro_torch.launch import sweep as sweep_lib
    cfg = sweep_lib.SweepConfig(budgets=[36, 28],
                                out_dir=str(tmp_path / "t"), name="t")
    s0 = {"stage": 0, "budget": 36, "mask_fingerprint": "aaa"}
    s1 = {"stage": 1, "budget": 28, "mask_fingerprint": "bbb",
          "test_acc": 9.0}
    os.makedirs(sweep_lib._stage_dir(cfg, 0), exist_ok=True)
    sweep_lib._write_artifact(cfg, [s0, s1], True)
    reporter = sweep_lib._StageReporter(cfg, [s0], None,
                                        lambda m, p: 5.0, None, None)
    reporter.submit(0, s0, _toy_masks(), None)
    reporter.join()
    art = json.load(open(sweep_lib.artifact_path(cfg)))
    assert len(art["stages"]) == 2 and art["complete"]
    assert art["stages"][0]["test_acc"] == 5.0
    assert art["stages"][1] == s1


def test_sweep_validates_schedule(tmp_path):
    from repro_torch.core import masks as M
    from repro_torch.launch import sweep as sweep_lib
    _, pio, cfg, mk, init = _sweep_ctx(tmp_path)
    n = M.count(_toy_masks())
    for bad in ([], [28, 36], [36, 36], [-1], [n]):
        c = sweep_lib.SweepConfig(budgets=bad, out_dir=str(tmp_path / "bad"))
        with pytest.raises(ValueError):
            c.validate(n)
    with pytest.raises(ValueError, match="init"):
        sweep_lib.run_sweep(
            sweep_lib.SweepConfig(budgets=[8], out_dir=str(tmp_path / "x")),
            mk, _toy_eval_acc, device="cpu")


def test_sweep_matches_the_reference_s(tmp_path):
    """The same toy sweep in both packages: equal stage fingerprints,
    histories, move stats and the reference's artifact and stage keys."""
    ref = reference()
    _, pio, cfg, mk, init = _sweep_ctx(tmp_path, "port")
    mine = _run(cfg, mk, init, pio, stage_eval=lambda m, p: 1.0)
    _, rpio, rcfg, rmk, rinit = _sweep_ctx(tmp_path, "ref", bcd=ref.bcd)
    rcfg = ref.sweep.SweepConfig(budgets=rcfg.budgets, out_dir=rcfg.out_dir,
                                 name=rcfg.name)
    theirs = ref.sweep.run_sweep(rcfg, rmk, _toy_eval_acc, init=rinit,
                                 params_io=rpio,
                                 stage_eval=lambda m, p: 1.0)
    assert set(mine) == set(theirs)
    for a, b in zip(mine["stages"], theirs["stages"]):
        assert set(a) == set(b)
        for k in ("mask_fingerprint", "history", "move_stats", "steps",
                  "trials_total", "budget", "test_acc"):
            assert a[k] == b[k], k
    art_m = json.load(open(mine["artifact"]))
    art_r = json.load(open(theirs["artifact"]))
    assert set(art_m) == set(art_r)


# ------------------------------------------------- SIGKILL (the real thing)


_KILL_SCRIPT = r"""
import json, sys
import numpy as np
from repro_torch.core import bcd
from repro_torch.launch import sweep as sweep_lib

out_dir = sys.argv[1]
masks = {"a": np.ones((24,), np.float32), "b": np.ones((24,), np.float32)}
wa = np.arange(24, dtype=np.float64)
eval_acc = lambda m: float(95.0 - 0.02 * (np.sum((1 - m["a"]) * wa) +
                                          np.sum((1 - m["b"]) * wa[::-1])))
holder = {"params": {"w": np.arange(4, dtype=np.float32)}}
pio = (lambda: holder["params"], lambda p: holder.__setitem__("params", p))
cfg = sweep_lib.SweepConfig(budgets=[36, 28], out_dir=out_dir, name="kill")
mk = lambda b: bcd.BCDConfig(b_target=b, drc=4, rt=6, adt=-1.0,
                             chunk_size=2, seed=0)
init = {"kind": "snl", "masks": masks, "params": holder["params"]}
res = sweep_lib.run_sweep(cfg, mk, eval_acc, init=init, params_io=pio,
                          device="cpu")
print("FPS=" + json.dumps([s["mask_fingerprint"] for s in res["stages"]]))
print("HIST=" + json.dumps([s["history"] for s in res["stages"]]))
"""


def _env(kill_after=None):
    """A child's environment: this checkout's ``src``, no kill switch or
    coordinator unless asked, and one CPU thread (the test suite runs
    several workers; a child of eight threads each oversubscribes the
    cores many times over)."""
    from repro_torch.core import runner
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env.pop(runner.KILL_ENV, None)
    for var in [v for v in env if v.startswith("REPRO_COORD_")]:
        env.pop(var)
    if kill_after is not None:
        env[runner.KILL_ENV] = str(kill_after)
    return env


def _run_kill_script(out_dir, kill_after=None):
    return subprocess.run([sys.executable, "-c", _KILL_SCRIPT, out_dir],
                          env=_env(kill_after), capture_output=True,
                          text=True, timeout=120)


def _lines(out):
    return {ln.split("=", 1)[0]: json.loads(ln.split("=", 1)[1])
            for ln in out.stdout.splitlines()
            if ln.startswith(("FPS=", "HIST="))}


def test_sweep_survives_sigkill_mid_stage(tmp_path):
    """SIGKILL after 4 accepted blocks (stage 0 has 3: stage 1's first
    block), restart: the final masks and step logs are the never-killed
    run's."""
    ref = _run_kill_script(str(tmp_path / "ref"))
    assert ref.returncode == 0, ref.stderr[-2000:]
    killed = _run_kill_script(str(tmp_path / "res"), kill_after=4)
    assert killed.returncode == -9, killed.stderr[-2000:]
    resumed = _run_kill_script(str(tmp_path / "res"))
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    a, b = _lines(ref), _lines(resumed)
    assert a["FPS"] == b["FPS"] and a["HIST"] == b["HIST"]


# ------------------------------------------------ the example, end to end


def _load_example():
    import importlib.util
    spec = importlib.util.spec_from_file_location("torch_pipeline_example",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _identity(art):
    """A sweep artifact's stages without wall-clock and resume point."""
    return [{k: v for k, v in s.items() if k not in ("wall_s",
                                                    "resumed_from")}
            for s in art["stages"]]


@pytest.fixture
def one_cpu_thread():
    """This process on one CPU thread, as its children run (``_env``): the
    same summation order in both, and no oversubscribed cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_example_sweep_mode_serial_overlap_and_sigkill(tmp_path, capsys,
                                                       one_cpu_thread):
    """``--sweep`` at mini size on the CPU: trains, persists the warm start,
    descends two stages.  The same sweep overlapped, and killed mid-stage-1
    (``REPRO_KILL_AFTER_STEPS``) then rerun, give the same stages (scores
    included) and the same final parameters."""
    from repro_torch.core import linearize, runner
    from repro_torch.training import checkpoint, optimizer as opt_lib
    ex = _load_example()
    flags = ["--device", "cpu", "--image-size", "8", "--engine", "suffix",
             "--sweep", "0.5994,0.599"]
    dirs = {k: str(tmp_path / k) for k in ("serial", "over", "killed")}
    assert ex.main(flags + ["--out-dir", dirs["serial"]]) == 0
    out = capsys.readouterr().out
    assert "== train + SNL" in out and "sweep curve" in out
    for k in ("over", "killed"):           # no run trains again
        shutil.copytree(os.path.join(dirs["serial"], "init"),
                        os.path.join(dirs[k], "init"))
    assert ex.main(flags + ["--out-dir", dirs["over"], "--overlap"]) == 0
    assert "reusing persisted warm start" in capsys.readouterr().out

    cmd = [sys.executable, EXAMPLE] + flags + ["--out-dir", dirs["killed"]]
    # B_ref 2150, then 2148 and 2146: the example's drc is 1, stage 0 is
    # 2 blocks, and 3 dies in stage 1
    killed = subprocess.run(cmd, env=_env(kill_after=3), capture_output=True,
                            text=True, timeout=300)
    assert killed.returncode == -9, killed.stderr[-2000:]
    resumed = subprocess.run(cmd, env=_env(), capture_output=True,
                             text=True, timeout=300)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "already complete" in resumed.stdout

    arts = {k: json.load(open(os.path.join(d, "SWEEP_r18-mini.json")))
            for k, d in dirs.items()}
    assert all(a["complete"] for a in arts.values())
    assert [s["steps"] for s in arts["serial"]["stages"]] == [2, 2]
    assert _identity(arts["over"]) == _identity(arts["serial"])
    assert _identity(arts["killed"]) == _identity(arts["serial"])
    assert arts["killed"]["stages"][1]["resumed_from"] == 1
    assert arts["serial"]["stages"][1]["resumed_from"] is None

    # the descent's final parameters, persisted as stage 1's warm start
    # for a successor: equal manifests, equal tensors
    finals = {k: os.path.join(d, "stage_01_b2146", "final")
              for k, d in dirs.items()}
    fps = {k: checkpoint.manifest_fingerprint(f, 0)
           for k, f in finals.items()}
    assert len(set(fps.values())) == 1, fps
    model, _ = ex.build_model_data(ex.parse_args(flags + ["--out-dir", "x"]))
    tmpl = model.init(torch.Generator().manual_seed(0), "cpu")
    masks0 = linearize.init_masks(model.mask_sites())
    leaves = {k: opt_lib.tree_leaves(runner.load_stage_init(
        f, masks0, params_template=tmpl, device="cpu")["params"])
        for k, f in finals.items()}
    for k in ("over", "killed"):
        assert all(torch.equal(x, y)
                   for x, y in zip(leaves[k], leaves["serial"]))

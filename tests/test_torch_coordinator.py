"""Multi-host coordination in the port (``repro_torch.launch.coordinator``
and the coordinated runner and sweep), on the CPU.

The reference's ``tests/test_coordinator.py``, case by case: N ranks run the
same deterministic BCD loop against ONE checkpoint directory; only rank 0
commits, readers block on each commit, and every restore is rank-agreed
(barrier + broadcast of the resume step and its manifest fingerprint).
SIGKILL any rank — reader or writer — relaunch all ranks with a fresh
session, and the job resumes from a single lineage, bit-identically.

Each worker is a subprocess that imports the port only (no jax); every
subprocess and every wait has a bound of seconds, so a hang fails fast.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120


def _coord():
    from repro_torch.launch import coordinator
    return coordinator


# ------------------------------------------------------------ primitives


def test_local_coordinator_is_trivial():
    c = _coord().LocalCoordinator()
    assert (c.rank, c.world_size, c.is_writer) == (0, 1, True)
    c.barrier("anything")
    assert c.broadcast("x", {"a": 1}) == {"a": 1}
    assert c.describe()["backend"] == "local"
    c.close()


def test_file_coordinator_barrier_and_broadcast_across_threads(tmp_path):
    coord_lib = _coord()
    root = str(tmp_path / "coord")
    got = {}

    def rank_main(r):
        c = coord_lib.FileCoordinator(root, r, 2, session="s0",
                                      poll_s=0.005, timeout_s=30)
        c.barrier("start")
        for round_i in range(3):                # tag reuse
            payload = c.broadcast(
                "step", {"round": round_i} if c.is_writer else None)
            got.setdefault(r, []).append(payload)
            c.barrier("round")

    ts = [threading.Thread(target=rank_main, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    assert got[0] == got[1] == [{"round": 0}, {"round": 1}, {"round": 2}]


def test_file_coordinator_barrier_timeout_names_missing_rank(tmp_path):
    coord_lib = _coord()
    c = coord_lib.FileCoordinator(str(tmp_path), 0, 2, timeout_s=0.2,
                                  poll_s=0.01)
    with pytest.raises(coord_lib.CoordinatorError, match=r"rank\(s\) \[1\]"):
        c.barrier("lonely")


def test_file_coordinator_broadcast_timeout_on_dead_writer(tmp_path):
    coord_lib = _coord()
    c = coord_lib.FileCoordinator(str(tmp_path), 1, 2, timeout_s=0.2,
                                  poll_s=0.01)
    with pytest.raises(coord_lib.CoordinatorError, match="writer"):
        c.broadcast("nothing")


def test_sessions_are_isolated(tmp_path):
    coord_lib = _coord()
    root = str(tmp_path)
    a = coord_lib.FileCoordinator(root, 0, 2, session="a", timeout_s=0.2)
    with pytest.raises(coord_lib.CoordinatorError):
        a.barrier("x")
    b0 = coord_lib.FileCoordinator(root, 0, 2, session="b", timeout_s=0.2)
    with pytest.raises(coord_lib.CoordinatorError):
        b0.barrier("x")


def test_from_env(tmp_path, monkeypatch):
    coord_lib = _coord()
    monkeypatch.delenv(coord_lib.ENV_WORLD, raising=False)
    assert isinstance(coord_lib.from_env(), coord_lib.LocalCoordinator)
    monkeypatch.setenv(coord_lib.ENV_WORLD, "1")
    assert isinstance(coord_lib.from_env(), coord_lib.LocalCoordinator)

    monkeypatch.setenv(coord_lib.ENV_WORLD, "2")
    for var in (coord_lib.ENV_RANK, coord_lib.ENV_DIR,
                coord_lib.ENV_SESSION, coord_lib.ENV_TIMEOUT):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(coord_lib.CoordinatorError, match=coord_lib.ENV_RANK):
        coord_lib.from_env()
    monkeypatch.setenv(coord_lib.ENV_RANK, "1")
    with pytest.raises(coord_lib.CoordinatorError, match=coord_lib.ENV_DIR):
        coord_lib.from_env()
    with pytest.raises(coord_lib.CoordinatorError,
                       match=coord_lib.ENV_SESSION):
        coord_lib.from_env(default_root=str(tmp_path))
    monkeypatch.setenv(coord_lib.ENV_SESSION, "s7")
    c = coord_lib.from_env(default_root=str(tmp_path))
    assert isinstance(c, coord_lib.FileCoordinator)
    assert (c.rank, c.world_size, c.is_writer) == (1, 2, False)
    assert c.session == "s7"
    monkeypatch.setenv(coord_lib.ENV_DIR, str(tmp_path / "explicit"))
    monkeypatch.setenv(coord_lib.ENV_TIMEOUT, "nope")
    with pytest.raises(coord_lib.CoordinatorError, match="not a number"):
        coord_lib.from_env()
    monkeypatch.setenv(coord_lib.ENV_TIMEOUT, "7")
    c = coord_lib.from_env()
    assert c.session == "s7" and c._timeout_s == 7.0


def test_rank_bounds_rejected(tmp_path):
    coord_lib = _coord()
    with pytest.raises(coord_lib.CoordinatorError):
        coord_lib.FileCoordinator(str(tmp_path), 2, 2)


# ------------------------------------------------ writer-exclusive commits


def test_checkpoint_save_refuses_non_writer(tmp_path):
    from repro_torch.training import checkpoint
    reader = _coord().FileCoordinator(str(tmp_path / "c"), 1, 2)
    with pytest.raises(checkpoint.CheckpointError, match="writer"):
        checkpoint.save({"x": np.ones(3)}, str(tmp_path / "ck"), 0,
                        coordinator=reader)
    assert not os.path.exists(str(tmp_path / "ck"))


def test_wait_for_step(tmp_path):
    from repro_torch.training import checkpoint
    d = str(tmp_path / "ck")
    with pytest.raises(checkpoint.CheckpointError, match="timed out"):
        checkpoint.wait_for_step(d, 1, timeout_s=0.2, poll_s=0.01)
    checkpoint.save({"x": np.ones(3)}, d, 2)
    assert checkpoint.wait_for_step(d, 1, timeout_s=0.2) == 2


def test_manifest_fingerprint_tracks_content(tmp_path):
    from repro_torch.training import checkpoint
    d = str(tmp_path / "ck")
    checkpoint.save({"x": np.ones(3)}, d, 0, meta={"tag": "a"})
    fp_a = checkpoint.manifest_fingerprint(d, 0)
    assert fp_a == checkpoint.manifest_fingerprint(d, 0)
    checkpoint.save({"x": np.zeros(3)}, d, 0, meta={"tag": "a"})
    assert checkpoint.manifest_fingerprint(d, 0) != fp_a


# --------------------------------------------- coordinated restore checks


def _toy_masks(n=48):
    return {"a": np.ones((n // 2,), np.float32),
            "b": np.ones((n // 2,), np.float32)}


def _toy_eval_acc(m):
    wa = np.arange(m["a"].shape[-1], dtype=np.float64)
    return float(95.0 - 0.02 * (np.sum((1 - m["a"]) * wa) +
                                np.sum((1 - m["b"]) * wa[::-1])))


def _toy_cfg(masks, steps=4):
    from repro_torch.core import bcd, masks as M
    return bcd.BCDConfig(b_target=M.count(masks) - 4 * steps, drc=4, rt=6,
                         adt=-1.0, chunk_size=2, seed=0)


class _StubCoordinator:
    """Writer rank of a fake 2-rank world whose broadcast replays a
    scripted resume point (as if agreed with a peer)."""

    def __init__(self, point):
        self.rank, self.world_size, self._point = 0, 2, point

    @property
    def is_writer(self):
        return True

    def barrier(self, tag, timeout_s=None):
        pass

    def broadcast(self, tag, payload=None):
        return self._point

    def describe(self):
        return {"backend": "stub", "rank": 0, "world_size": 2}


def test_restore_verifies_broadcast_fingerprint(tmp_path):
    from repro_torch.core import masks as M, runner
    from repro_torch.training import checkpoint
    masks = _toy_masks()
    cfg = _toy_cfg(masks)
    d = str(tmp_path / "ck")
    runner.BCDRunner(cfg, runner.RunnerConfig(ckpt_dir=d, max_steps=2),
                     _toy_eval_acc, device="cpu").run(masks)
    step = checkpoint.latest_valid_step(d)
    good_fp = checkpoint.manifest_fingerprint(d, step)

    ok = runner.BCDRunner(
        cfg, runner.RunnerConfig(ckpt_dir=d), _toy_eval_acc,
        coordinator=_StubCoordinator({"step": step, "fingerprint": good_fp}),
        device="cpu")
    res = ok.run(masks)
    assert ok.resumed_from == step and M.count(res.masks) == cfg.b_target
    assert checkpoint.read_manifest(d, checkpoint.latest_step(d))[
        "meta"]["writer"]["backend"] == "stub"

    bad = runner.BCDRunner(
        cfg, runner.RunnerConfig(ckpt_dir=d), _toy_eval_acc,
        coordinator=_StubCoordinator({"step": step, "fingerprint": "0" * 64}),
        device="cpu")
    with pytest.raises(runner.CheckpointError, match="divergent"):
        bad.run(masks)


# ------------------------------------- the drills (acceptance criterion)
#
# 2 ranks over a FileCoordinator against one checkpoint directory, each a
# port-only subprocess.  SIGKILL a rank mid-run, relaunch all ranks under a
# fresh session, and the final masks and logs must be an uninterrupted
# single-process run's, with every committed checkpoint from rank 0.

_PRELUDE = r"""
import dataclasses, json, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # the workers run the port alone
import numpy as np
from repro_torch.core import bcd, masks as M, runner
from repro_torch.launch import coordinator as coord_lib

out_dir, coord_dir, session, rank, world = sys.argv[1:6]
coord = coord_lib.FileCoordinator(coord_dir, int(rank), int(world),
                                  session=session, poll_s=0.01, timeout_s=60)
masks = {"a": np.ones((24,), np.float32), "b": np.ones((24,), np.float32)}
wa = np.arange(24, dtype=np.float64)
eval_acc = lambda m: float(95.0 - 0.02 * (np.sum((1 - m["a"]) * wa) +
                                          np.sum((1 - m["b"]) * wa[::-1])))
"""

_DRILL = _PRELUDE + r"""
cfg = bcd.BCDConfig(b_target=28, drc=4, rt=6, adt=-1.0, chunk_size=2, seed=0)
run = runner.BCDRunner(
    cfg, runner.RunnerConfig(ckpt_dir=out_dir, wait_timeout_s=3.0),
    eval_acc, coordinator=coord, device="cpu")
res = run.run(masks)
hist = []
for h in res.history:
    d = dataclasses.asdict(h); d.pop("wall_s"); hist.append(d)
print(f"R{coord.rank}_FP=" + M.fingerprint(res.masks))
print(f"R{coord.rank}_HIST=" + json.dumps(hist))
"""

_SWEEP_DRILL = _PRELUDE + r"""
from repro_torch.launch import sweep as sweep_lib
holder = {"params": {"w": np.arange(4, dtype=np.float32)}}
pio = (lambda: holder["params"], lambda p: holder.__setitem__("params", p))
cfg = sweep_lib.SweepConfig(budgets=[36, 28], out_dir=out_dir, name="mh",
                            wait_timeout_s=3.0)
mk = lambda b: bcd.BCDConfig(b_target=b, drc=4, rt=6, adt=-1.0,
                             chunk_size=2, seed=0)
init = {"kind": "snl", "masks": masks, "params": holder["params"]}
res = sweep_lib.run_sweep(cfg, mk, eval_acc, init=init, params_io=pio,
                          stage_eval=lambda m, p: eval_acc(m),
                          coordinator=coord, device="cpu")
print(f"R{coord.rank}_SWEEPFPS="
      + json.dumps([s["mask_fingerprint"] for s in res["stages"]]))
"""


def _launch(script, out_dir, coord_dir, session, world=2, kill_rank=None,
            kill_after=2):
    from repro_torch.core import runner
    procs = []
    for r in range(world):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
            env.get("PYTHONPATH", "")
        env.pop(runner.KILL_ENV, None)
        if kill_rank is not None and r == kill_rank:
            env[runner.KILL_ENV] = str(kill_after)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, out_dir, coord_dir, session,
             str(r), str(world)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        done = [p.communicate(timeout=CHILD_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, done)]


def _parse(out):
    got = {}
    for ln in out.splitlines():
        if "_FP=" in ln or "_HIST=" in ln:
            k, v = ln.split("=", 1)
            got[k.split("_", 1)[1]] = json.loads(v) if "HIST" in k else v
    return got


def _assert_single_lineage(ckpt_dir):
    from repro_torch.training import checkpoint
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    assert steps, "no checkpoints committed"
    for s in steps:
        meta = checkpoint.read_manifest(ckpt_dir, s).get("meta", {})
        assert meta.get("writer", {}).get("rank") == 0, \
            (s, meta.get("writer"))


@pytest.fixture(scope="module")
def drill_reference():
    """The uninterrupted single-process run (masks + logs)."""
    from repro_torch.core import bcd, masks as M
    ref = bcd.run_bcd(_toy_masks(48), bcd.BCDConfig(
        b_target=28, drc=4, rt=6, adt=-1.0, chunk_size=2, seed=0),
        _toy_eval_acc)
    hist = []
    for h in ref.history:
        d = dataclasses.asdict(h)
        d.pop("wall_s")
        hist.append(d)
    return M.fingerprint(ref.masks), hist


def test_multihost_sweep_drill(tmp_path):
    """2 ranks descend a 2-stage schedule; the WRITER is SIGKILLed
    mid-stage-1; the relaunch (fresh session) broadcast-skips stage 0,
    resumes stage 1 from rank 0's lineage, and both ranks end with a
    single-process sweep's stage fingerprints."""
    from repro_torch.core import bcd
    from repro_torch.launch import sweep as sweep_lib
    holder = {"params": {"w": np.arange(4, dtype=np.float32)}}
    pio = (lambda: holder["params"],
           lambda p: holder.__setitem__("params", p))
    ref = sweep_lib.run_sweep(
        sweep_lib.SweepConfig(budgets=[36, 28],
                              out_dir=str(tmp_path / "ref"), name="mh"),
        lambda b: bcd.BCDConfig(b_target=b, drc=4, rt=6, adt=-1.0,
                                chunk_size=2, seed=0),
        _toy_eval_acc, init={"kind": "snl", "masks": _toy_masks(),
                             "params": holder["params"]},
        params_io=pio, stage_eval=lambda m, p: _toy_eval_acc(m),
        device="cpu")
    ref_fps = [s["mask_fingerprint"] for s in ref["stages"]]

    out, coord = str(tmp_path / "mh"), str(tmp_path / "coord")
    # stage 0 is 3 accepted blocks; kill the writer after 4: mid-stage-1
    res = _launch(_SWEEP_DRILL, out, coord, "a1", kill_rank=0, kill_after=4)
    assert res[0][0] == -9, res[0][2][-2000:]
    assert res[1][0] not in (0, -9), res[1][2][-2000:]

    res = _launch(_SWEEP_DRILL, out, coord, "a2")
    assert all(rc == 0 for rc, _, _ in res), [e[-1500:] for _, _, e in res]
    for _, stdout, _ in res:
        assert json.loads(stdout.split("_SWEEPFPS=", 1)[1]) == ref_fps
    art = json.load(open(os.path.join(out, "SWEEP_mh.json")))
    assert art["complete"]
    assert [s["mask_fingerprint"] for s in art["stages"]] == ref_fps
    assert all("test_acc" in s for s in art["stages"])


def test_multihost_drill_sigkill_non_writer(tmp_path, drill_reference):
    """SIGKILL a reader mid-run: the writer never waits on readers and
    finishes; a full relaunch restores the completed lineage on both
    ranks, fingerprint-verified and bit-identical to the reference."""
    ref_fp, ref_hist = drill_reference
    ckpt, coord = str(tmp_path / "ckpt"), str(tmp_path / "coord")
    res = _launch(_DRILL, ckpt, coord, "attempt1", kill_rank=1)
    assert res[1][0] == -9, res[1][2][-2000:]
    assert res[0][0] == 0, res[0][2][-2000:]
    assert _parse(res[0][1])["FP"] == ref_fp
    _assert_single_lineage(ckpt)

    res = _launch(_DRILL, ckpt, coord, "attempt2")
    assert all(rc == 0 for rc, _, _ in res), [e[-1000:] for _, _, e in res]
    got0, got1 = _parse(res[0][1]), _parse(res[1][1])
    assert got0["FP"] == got1["FP"] == ref_fp
    assert got0["HIST"] == got1["HIST"] == ref_hist
    _assert_single_lineage(ckpt)


def test_multihost_drill_sigkill_writer(tmp_path, drill_reference):
    """SIGKILL the WRITER mid-run: the reader's ``wait_for_step`` times
    out and it exits with a CheckpointError (no hang, no takeover);
    relaunching all ranks resumes rank 0's lineage bit-identically."""
    from repro_torch.training import checkpoint
    ref_fp, ref_hist = drill_reference
    ckpt, coord = str(tmp_path / "ckpt"), str(tmp_path / "coord")
    res = _launch(_DRILL, ckpt, coord, "attempt1", kill_rank=0)
    assert res[0][0] == -9, res[0][2][-2000:]
    assert res[1][0] not in (0, -9), res[1][2][-2000:]
    assert "CheckpointError" in res[1][2] or "timed out" in res[1][2]
    _assert_single_lineage(ckpt)
    resumed_at = checkpoint.latest_valid_step(ckpt)
    assert resumed_at is not None and resumed_at < 5

    res = _launch(_DRILL, ckpt, coord, "attempt2")
    assert all(rc == 0 for rc, _, _ in res), [e[-1000:] for _, _, e in res]
    got0, got1 = _parse(res[0][1]), _parse(res[1][1])
    assert got0["FP"] == got1["FP"] == ref_fp
    assert got0["HIST"] == got1["HIST"] == ref_hist
    _assert_single_lineage(ckpt)


# ------------------------------------------------------------- liveness


_CHILD = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("coord", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
c = mod.FileCoordinator(sys.argv[2], 1, 2, session="liv", poll_s=0.01,
                        timeout_s=60, lease_interval_s=0.05,
                        lease_ttl_s=0.5)
c.barrier("start")
c.broadcast("never")          # parent never publishes: wait + heartbeat
"""


def test_sigkilled_rank_is_reported_dead_by_lease(tmp_path):
    coord_lib = _coord()
    root = str(tmp_path / "coord")
    child = subprocess.Popen([sys.executable, "-c", _CHILD,
                              coord_lib.__file__, root])
    try:
        parent = coord_lib.FileCoordinator(root, 0, 2, session="liv",
                                           poll_s=0.01, timeout_s=60,
                                           lease_interval_s=0.05,
                                           lease_ttl_s=0.5)
        parent.barrier("start", timeout_s=30)
        child.kill()
        child.wait(timeout=10)
        time.sleep(0.8)                         # let the lease expire
        with pytest.raises(coord_lib.CoordinatorError,
                           match=r"rank 1 dead \(lease expired"):
            parent.barrier("probe", timeout_s=0.3)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=10)


def test_never_started_rank_has_no_lease(tmp_path):
    coord_lib = _coord()
    c = coord_lib.FileCoordinator(str(tmp_path), 0, 2, timeout_s=0.2,
                                  poll_s=0.01)
    with pytest.raises(coord_lib.CoordinatorError,
                       match=r"rank 1 never started \(no lease\)"):
        c.barrier("lonely")


def test_wedged_rank_reads_alive_not_dead(tmp_path):
    coord_lib = _coord()
    root = str(tmp_path / "coord")
    stop = threading.Event()

    def wedged_rank():
        c = coord_lib.FileCoordinator(root, 1, 2, session="s0",
                                      poll_s=0.01, timeout_s=30,
                                      lease_interval_s=0.05,
                                      lease_ttl_s=5.0)
        c.barrier("start")
        try:
            c.broadcast("elsewhere", timeout_s=10)   # wrong wait: wedged
        except coord_lib.CoordinatorError:
            pass
        stop.set()

    t = threading.Thread(target=wedged_rank)
    t.start()
    try:
        parent = coord_lib.FileCoordinator(root, 0, 2, session="s0",
                                           poll_s=0.01, timeout_s=30,
                                           lease_interval_s=0.05,
                                           lease_ttl_s=5.0)
        parent.barrier("start", timeout_s=30)
        with pytest.raises(coord_lib.CoordinatorError,
                           match=r"rank 1 alive .* wedged"):
            parent.barrier("probe", timeout_s=0.4)
    finally:
        parent.broadcast("elsewhere", {"bye": True})
        t.join(timeout=15)
    assert not t.is_alive() and stop.is_set()


def test_lease_ttl_must_exceed_interval(tmp_path):
    coord_lib = _coord()
    with pytest.raises(coord_lib.CoordinatorError, match="lease_ttl_s"):
        coord_lib.FileCoordinator(str(tmp_path), 0, 1,
                                  lease_interval_s=2.0, lease_ttl_s=1.0)

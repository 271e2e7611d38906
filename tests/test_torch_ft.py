"""The port's fault tolerance (``repro_torch.training.ft``) on the CPU: the
reference's supervisor, injector and watchdog cases
(``tests/test_training.py``) on the port, and a run interrupted by an
injected failure against an uninterrupted one, through the launcher's own
code, equal to the bit.
"""
import os

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The reduced models gain nothing from intra-op threads, and a step
    takes tens of times longer on eight contending ones than on one.  Put
    back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mini_state(v=0.0):
    return {"params": {"a": torch.full((4, 3), v), "b": [torch.zeros(2)]},
            "step": torch.tensor(int(v), dtype=torch.int32)}


def test_supervisor_restarts_from_checkpoint(tmp_path):
    from repro_torch.training import ft
    d = str(tmp_path / "ck")
    calls = {"n": 0}

    def step_fn(state, step):
        calls["n"] += 1
        return {"params": state["params"], "step": state["step"] + 1}

    inj = ft.FailureInjector(fail_at_steps=(7, 13))
    out = ft.run_supervised(lambda: _mini_state(0.0), step_fn, n_steps=20,
                            ckpt_dir=d, ckpt_every=5, injector=inj,
                            device="cpu")
    assert out["restarts"] == 2
    assert out["completed_steps"] == 20
    assert int(out["state"]["step"]) == 20
    # restarted from steps 5 and 10: some steps ran twice
    assert calls["n"] == 20 + 2 + 3


def test_supervisor_gives_up_after_max_failures(tmp_path):
    from repro_torch.training import ft

    def always_fail(state, step):
        raise ft.SimulatedNodeFailure("boom")
    with pytest.raises(ft.SimulatedNodeFailure):
        ft.run_supervised(_mini_state, always_fail, n_steps=5,
                          ckpt_dir=str(tmp_path / "ck2"), ckpt_every=1,
                          max_failures=2, device="cpu")


def test_straggler_watchdog_flags_slow_steps():
    from repro_torch.training import ft
    wd = ft.StragglerWatchdog(warmup=2, slow_factor=2.0)
    for i in range(10):
        wd.observe(i, 0.1)
    assert wd.observe(10, 0.5)          # 5x slower than EWMA
    assert wd.flagged == [10]
    assert not wd.observe(11, 0.11)     # EWMA not poisoned by the straggler


def test_failure_injector_fires_once_per_step():
    from repro_torch.training import ft
    inj = ft.FailureInjector(fail_at_steps=(3,))
    inj.check(2)
    with pytest.raises(ft.SimulatedNodeFailure, match="step 3"):
        inj.check(3)
    inj.check(3)


def test_restore_onto_a_mesh_names_the_queue(tmp_path):
    """``state_shardings`` is ported (Queue A11; 4 ranks in
    ``tests/test_torch_sharded_train.py``): with placements on no mesh (a
    world of one) a supervised run with a failure writes the same
    checkpoint files as one without placements."""
    from repro_torch.core import spmd
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.training import ft

    def step_fn(state, step):
        p = state["params"]
        return {"params": {"a": p["a"] + 1.0, "b": [p["b"][0] - 0.5]},
                "step": state["step"] + 1}
    specs = {"params": {"a": spmd.Spec(None, None), "b": [spmd.Spec(None)]},
             "step": spmd.Spec()}
    files = []
    for label, sh in (("plain", None),
                      ("placed", mesh_lib.Shardings(None, specs))):
        d = tmp_path / label
        out = ft.run_supervised(
            lambda: _mini_state(0.0), step_fn, n_steps=4, ckpt_dir=str(d),
            ckpt_every=2, state_shardings=sh, device="cpu",
            injector=ft.FailureInjector(fail_at_steps=(3,)))
        assert out["restarts"] == 1
        step = d / "step_00000004"
        files.append({f: (step / f).read_bytes()
                      for f in sorted(os.listdir(step))})
    assert files[0] == files[1]


def _launch(tmp_path, steps, extra=()):
    from repro_torch.launch import train as launch
    args = launch.parse_args(
        ["--arch", "stablelm_1p6b", "--reduced", "--steps", str(steps),
         "--global-batch", "2", "--seq", "16", "--ckpt-every", "5",
         "--ckpt-dir", str(tmp_path), "--device", "cpu", *extra])
    return launch, args, launch.make_config(args)


def _state_bits(state):
    from repro_torch.training import checkpoint
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v
                          ).tobytes()
            for k, v in checkpoint._flatten(state)}


def test_interrupted_run_equals_uninterrupted_to_the_bit(tmp_path):
    """``launch.train.run`` for 12 steps, and again with a failure injected
    at step 7 (the restart restores the step-5 checkpoint and replays
    steps 5–6): the same losses from step 5 on, and the final parameters,
    moments and counters equal to the bit."""
    from repro_torch.training import ft
    launch, args, cfg = _launch(tmp_path / "a", 12)
    whole = launch.run(args, cfg, "cpu")
    _, args_b, _ = _launch(tmp_path / "b", 12)
    cut = launch.run(args_b, cfg, "cpu",
                     injector=ft.FailureInjector(fail_at_steps=(7,)))
    assert whole["result"]["restarts"] == 0
    assert cut["result"]["restarts"] == 1
    assert len(whole["losses"]) == 12 and len(cut["losses"]) == 14
    assert cut["losses"][-7:] == whole["losses"][-7:]
    a, b = _state_bits(whole["result"]["state"]), \
        _state_bits(cut["result"]["state"])
    assert a.keys() == b.keys() and "opt/nu/embed" in a
    assert a == b
    assert int(cut["result"]["state"]["step"]) == 12

"""The port's training launcher (``python -m repro_torch.launch.train``) and
``examples/torch_train_lm.py`` on the CPU: a run and its resume, the
mesh's refusal, a bfloat16 config built and trained in bfloat16, the
entry points' default device, and the example at a mini size.
"""
import importlib.util
import inspect
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The reduced models gain nothing from intra-op threads, and a step
    takes tens of times longer on eight contending ones than on one.  Put
    back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(ckpt, steps, *extra):
    return ["--reduced", "--steps", str(steps), "--global-batch", "2",
            "--seq", "16", "--ckpt-dir", str(ckpt), "--device", "cpu",
            *extra]


def test_main_runs_and_a_longer_rerun_resumes(tmp_path, capsys):
    from repro_torch.launch import train as launch
    from repro_torch.training import checkpoint
    ck = tmp_path / "ck"
    assert launch.main(_args(ck, 6, "--ckpt-every", "3")) == 0
    first = capsys.readouterr().out
    assert "step 0 loss" in first and "finished 6 steps" in first
    assert checkpoint.latest_valid_step(str(ck)) == 6
    args = launch.parse_args(_args(ck, 9, "--ckpt-every", "3"))
    got = launch.run(args, launch.make_config(args), "cpu")
    out = capsys.readouterr().out
    assert "step 0 loss" not in out and "step 6 loss" in out
    assert len(got["losses"]) == 3 and len(got["step_ms"]) == 3
    assert all(np.isfinite(got["losses"]))
    assert int(got["result"]["state"]["step"]) == 9
    assert int(got["result"]["state"]["opt"].step) == 9
    assert checkpoint.latest_valid_step(str(ck)) == 9


def test_compress_grads_and_remat_group_flags(tmp_path):
    from repro_torch.launch import train as launch
    args = launch.parse_args(_args(tmp_path, 2, "--compress-grads",
                                   "--remat-group", "2"))
    cfg = launch.make_config(args)
    assert cfg.remat_group == 2 and cfg.dtype == "float32"
    got = launch.run(args, cfg, "cpu")
    assert len(got["losses"]) == 2 and all(np.isfinite(got["losses"]))


def test_a_mesh_is_refused_naming_the_queue(tmp_path):
    """``--mesh`` is ported (Queue A11; ``--mesh 2,2`` on 4 ranks in
    ``tests/test_torch_sharded_train.py``): a mesh larger than the process
    group is refused before anything is written or a group comes up."""
    import torch.distributed as dist
    from repro_torch.launch import train as launch
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="need 2 ranks, have 1"):
        launch.main(_args(tmp_path, 1, "--mesh", "2,1"))
    assert not os.path.exists(tmp_path / "ck")
    assert not dist.is_initialized()


def test_a_bfloat16_config_builds_and_trains_in_bfloat16(tmp_path):
    """The published config is bfloat16 and builds as it is; a reduced
    config at bfloat16 trains through ``run`` and resumes from its
    bfloat16 checkpoint: bfloat16 parameters and moments, the inits'
    float32 leaves (the norm scales) float32, the counters int32."""
    import dataclasses
    from repro_torch.launch import train as launch
    from repro_torch.training import checkpoint, optimizer as opt_lib
    args = launch.parse_args(["--steps", "1", "--ckpt-dir", str(tmp_path),
                              "--device", "cpu"])
    cfg = launch.make_config(args)          # stablelm_1p6b, as published
    assert cfg.dtype == "bfloat16" and cfg.d_model == 2048
    ck = tmp_path / "ck"
    args = launch.parse_args(_args(ck, 2, "--ckpt-every", "2"))
    cfg = dataclasses.replace(launch.make_config(args), dtype="bfloat16")
    got = launch.run(args, cfg, "cpu")
    assert len(got["losses"]) == 2 and all(np.isfinite(got["losses"]))
    state = got["result"]["state"]
    for tree in (state["params"], state["opt"].mu, state["opt"].nu):
        dts = {t.dtype for t in opt_lib.tree_leaves(tree)}
        assert dts == {torch.bfloat16, torch.float32}, dts
    assert state["params"]["embed"].dtype == torch.bfloat16
    assert state["params"]["final_norm"]["scale"].dtype == torch.float32
    manifest = checkpoint.read_manifest(str(ck), 2)
    assert manifest["leaves"]["params/embed"]["dtype"] == "bfloat16"
    args = launch.parse_args(_args(ck, 3, "--ckpt-every", "2"))
    more = launch.run(args, cfg, "cpu")
    assert len(more["losses"]) == 1 and np.isfinite(more["losses"][0])
    assert int(more["result"]["state"]["step"]) == 3


def test_entry_points_default_to_the_card():
    from repro_torch.launch import train as launch
    from repro_torch.training import ft, train
    for fn in (train.make_state, ft.run_supervised, launch.run):
        assert inspect.signature(fn).parameters["device"].default == \
            "cuda", fn
    assert launch.parse_args([]).device == "cuda"


def _example(name):
    path = os.path.join(ROOT, "examples", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_lm_example_at_mini_size(tmp_path, capsys):
    """Training with a failure injected at step 5 (one restart), then BCD
    through the batched engine down to half of the FFN nonlinearities."""
    ex = _example("torch_train_lm.py")
    assert ex.parse_args([]).device == "cuda"
    out = ex.main(["--dim", "32", "--layers", "2", "--vocab", "64",
                   "--steps", "12", "--batch", "2", "--seq", "32",
                   "--inject-failure", "5", "--ckpt-dir", str(tmp_path)],
                  device="cpu")
    printed = capsys.readouterr().out
    assert out["restarts"] == 1 and "restarts=1" in printed
    assert len(out["losses"]) == 5 + 12   # no checkpoint before step 10
    assert all(np.isfinite(out["losses"]))
    assert out["kept"] == out["total"] // 2
    assert "BCD: kept" in printed and "[batched]" in printed
    assert 0.0 <= out["token_acc"] <= 100.0

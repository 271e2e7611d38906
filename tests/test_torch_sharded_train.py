"""Sharded training over a ``("data", "model")`` mesh, on 4 CPU ranks.

- The sharded float32 train step (``training.train.jit_train_step``)
  against the reference's single-device jitted step, from the reference's
  state, on reduced StableLM-2-1.6B and RWKV-6 3B: two steps on each mesh
  ``(4, 1)``, ``(2, 2)``, ``(1, 4)`` with ZeRO-3 (``fsdp``), and with
  ``compress_grads`` and with ZeRO-3 off (``CASES``), all under a gradient
  clip that bites; reduced DeepSeek-MoE-16B on ``(2, 2)`` and Zamba2-2.7B
  on ``(1, 4)``, their experts and Mamba2 heads split over ``"model"``.
  SGD with momentum at a learning rate of 1e-3 (Zamba2's at 1.0,
  ``LR_BY_ARCH``): the loss and every updated leaf within 1e-5 of the
  reference's.  (The rate keeps one int8 quantum of a
  compressed gradient, which an ulp of difference in the gradient can move
  across a rounding boundary, below the tolerance; AdamW divides each
  gradient by its own magnitude, so it is held by the update's relative
  L2 as ``tests/test_torch_train_lm.py`` holds the one-device step.)
- Checkpoints: a state sharded on each mesh and saved
  (``checkpoint.save(shardings=)``) gives files byte-identical to the
  reference's ``checkpoint.save`` of the same state, and restores
  (``restore(shardings=)``) onto every other mesh, and onto one process,
  to the bit.
- ``launch/train.py --mesh 2,2`` under the supervisor with an injected
  failure equals, to the bit, the uninterrupted run on the same mesh; it
  trains reduced DeepSeek-MoE and Zamba2 on that mesh too.

All four ranks run in one spawn for the module; every step pins one
intra-op thread.
"""
import os

import numpy as np
import pytest

from test_torch_helpers import reference, run_ranks, to_numpy_tree

MESHES = ((4, 1), (2, 2), (1, 4))
TOL = 1e-5
LR, CLIP = 1e-3, 0.5
# Zamba2's A_log starts at -4, where an update below 2.4e-7 rounds away: at
# LR a layer's A_log does not move; at 1.0 every leaf moves by ~100 ulps or
# more, so each leaf's update is held too (chip_smoke.py's SHARDED_F32_LR)
LR_BY_ARCH = {"zamba2_2p7b": 1.0}
B, S = 4, 16
# (arch, optimizer, compress_grads, fsdp, mesh): each mesh once, ZeRO-3 on
# and off, compression on and off
CASES = (("stablelm_1p6b", "sgd", False, True, (2, 2)),
         ("stablelm_1p6b", "sgd", True, True, (4, 1)),
         ("stablelm_1p6b", "sgd", False, False, (1, 4)),
         ("rwkv6_3b", "sgd", False, True, (2, 2)),
         ("deepseek_moe_16b", "sgd", False, True, (2, 2)),
         ("zamba2_2p7b", "sgd", False, True, (1, 4)),
         ("stablelm_1p6b", "adamw", False, True, (2, 2)))
_CACHE = {}


def _batches(vocab):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        t = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def _reference_runs():
    """The reference's state (SGD and AdamW) and its jitted steps' losses
    and parameters, per arch and per ``compress_grads``."""
    ref = reference()
    jax, jnp = ref.jax, ref.jnp
    from repro.core import linearize as rlin
    from repro.training import optimizer as ropt, train as rtrain
    out = {}
    for arch in sorted({c[0] for c in CASES}):
        cfg = ref.configs.get_config(arch).reduced()
        model = ref.lm.LM(cfg)
        masks = ref.masks.as_device(rlin.init_masks(model.mask_sites()))
        batches = _batches(cfg.vocab)
        run = {"batches": batches, "steps": {}}
        lr = LR_BY_ARCH.get(arch, LR)
        for name, opt in (("sgd", ropt.sgd(lr=lr, momentum=0.9,
                                           grad_clip=CLIP)),
                          ("adamw", ropt.adamw(lr=lr, grad_clip=CLIP))):
            todo = {c[2] for c in CASES if c[:2] == (arch, name)}
            if not todo:
                continue
            state0 = rtrain.make_state(model, opt, jax.random.PRNGKey(0))
            # plain dicts: the ranks must not unpickle the reference's types
            o = to_numpy_tree(state0["opt"])
            run[name] = dict(params=to_numpy_tree(state0["params"]),
                             opt=dict(step=o.step, mu=o.mu, nu=o.nu),
                             step=np.asarray(state0["step"]))
            for compress in sorted(todo):
                step = jax.jit(rtrain.make_train_step(
                    model, opt, rtrain.TrainStepCfg(
                        remat=False, compress_grads=compress, dp_axes=())))
                state, losses = state0, []
                for b in batches:
                    state, m = step(state, {k: jnp.asarray(v)
                                            for k, v in b.items()}, masks)
                    losses.append(float(m["loss"]))
                run["steps"][(name, compress)] = dict(
                    losses=losses, params=to_numpy_tree(state["params"]))
        out[arch] = run
    return out


def _port_state(tree, opt_name):
    """The reference's numpy train state as the port's (an SGD ``nu`` is
    None in the port)."""
    import torch
    from repro_torch import convert
    from repro_torch.training import optimizer as opt_lib
    o = tree["opt"]
    return {"params": convert.params_from_reference(tree["params"], "cpu"),
            "opt": opt_lib.OptState(
                torch.tensor(int(o["step"]), dtype=torch.int32),
                convert.params_from_reference(o["mu"], "cpu"),
                convert.params_from_reference(o["nu"], "cpu")
                if opt_name == "adamw" else None),
            "step": torch.tensor(int(tree["step"]), dtype=torch.int32)}


def _opt(name, arch="stablelm_1p6b"):
    from repro_torch.training import optimizer as opt_lib
    lr = LR_BY_ARCH.get(arch, LR)
    if name == "sgd":
        return opt_lib.sgd(lr=lr, momentum=0.9, grad_clip=CLIP)
    return opt_lib.adamw(lr=lr, grad_clip=CLIP)


def _numpy(tree):
    from repro_torch.training import optimizer as opt_lib
    return [t.numpy() for t in opt_lib.tree_leaves(tree)]


def _steps_on_ranks(runs):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import linearize, masks as M
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.lm import LM
    from repro_torch.training import train as train_lib
    out = {}
    for arch, name, compress, fsdp, shape in CASES:
        run = runs[arch]
        model = LM(get_config(arch).reduced())
        masks = M.as_device(linearize.init_masks(model.mask_sites()), "cpu")
        batches = [{k: torch.from_numpy(v.astype(np.int64))
                    for k, v in b.items()} for b in run["batches"]]
        mesh = mesh_lib.make_host_mesh(*shape, device="cpu")
        opt = _opt(name, arch)
        state = train_lib.shard_state(_port_state(run[name], name),
                                      model, opt, mesh, fsdp)
        step = train_lib.jit_train_step(
            model, opt, mesh, train_lib.TrainStepCfg(
                remat=True, fsdp=fsdp, compress_grads=compress))
        losses = []
        for b in batches:
            state, m = step(state, b, masks)
            losses.append(float(m["loss"]))
        held = train_lib.held_state_specs(model, opt, *shape, fsdp)
        whole = mesh_lib.gather_tree(state["params"], held["params"],
                                     mesh)
        out[(arch, name, compress, fsdp, shape)] = dict(
            losses=losses, params=_numpy(whole))
    return out


def _checkpoints_on_ranks(run, root):
    """A state saved sharded on each mesh, restored onto every mesh and
    onto one process; each restored leaf against the saved one, bit for
    bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.lm import LM
    from repro_torch.training import checkpoint, train as train_lib
    model = LM(get_config("stablelm_1p6b").reduced())
    opt = _opt("adamw")
    state = _port_state(run["adamw"], "adamw")
    want = [t.view(torch.int32).numpy() if t.is_floating_point()
            else t.numpy() for t in _leaves(state)]
    dirs, apart = {}, []
    for shape in MESHES:
        mesh = mesh_lib.make_host_mesh(*shape, device="cpu")
        sh = mesh_lib.Shardings(mesh, train_lib.held_state_specs(
            model, opt, *shape))
        local = train_lib.shard_state(state, model, opt, mesh)
        d = os.path.join(root, f"ck_{shape[0]}x{shape[1]}")
        checkpoint.save(local, d, 3, shardings=sh)
        dirs[shape] = d
    for saved in MESHES:
        for shape in MESHES + ((1, 1),):
            if shape == (1, 1):
                got, step = checkpoint.restore(state, dirs[saved],
                                               device="cpu")
            else:
                mesh = mesh_lib.make_host_mesh(*shape, device="cpu")
                held = train_lib.held_state_specs(model, opt, *shape)
                got, step = checkpoint.restore(
                    state, dirs[saved], device="cpu",
                    shardings=mesh_lib.Shardings(mesh, held))
                got = mesh_lib.gather_tree(got, held, mesh)
            leaves = [t.view(torch.int32).numpy() if t.is_floating_point()
                      else t.numpy() for t in _leaves(got)]
            if step != 3 or len(leaves) != len(want) or any(
                    not np.array_equal(a, b) for a, b in zip(leaves, want)):
                apart.append((saved, shape))
    return {"dirs": {f"{k[0]}x{k[1]}": v for k, v in dirs.items()},
            "apart": apart}


def _leaves(state):
    from repro_torch.training import optimizer as opt_lib
    o = state["opt"]
    return (opt_lib.tree_leaves(state["params"]) + [o.step]
            + opt_lib.tree_leaves(o.mu) + opt_lib.tree_leaves(o.nu)
            + [state["step"]])


def _launch_on_ranks(root):
    """``launch.train.run --mesh 2,2``: interrupted at step 3 and
    restarted from its step-2 checkpoint, against an uninterrupted run."""
    from repro_torch.launch import mesh as mesh_lib, train as launch
    from repro_torch.training import ft, train as train_lib
    got = {}
    for label, inj in (("plain", None),
                       ("failed", ft.FailureInjector(fail_at_steps=(3,)))):
        args = launch.parse_args(
            ["--arch", "stablelm_1p6b", "--reduced", "--steps", "4",
             "--global-batch", "4", "--seq", "16", "--ckpt-every", "2",
             "--mesh", "2,2", "--ckpt-dir", os.path.join(root, label),
             "--device", "cpu"])
        res = launch.run(args, launch.make_config(args), "cpu", injector=inj)
        mesh = launch.make_mesh(args, "cpu")
        model = launch.LM(launch.make_config(args))
        opt = launch.opt_lib.adamw(lr=args.lr)
        held = train_lib.held_state_specs(model, opt, 2, 2)
        whole = mesh_lib.gather_tree(res["result"]["state"], held, mesh)
        got[label] = dict(losses=res["losses"],
                          restarts=res["result"]["restarts"],
                          leaves=[t.numpy() for t in _leaves(whole)])
    return got


def _family_launch_on_ranks(root):
    """``launch.train.run --mesh 2,2`` of reduced DeepSeek-MoE and Zamba2:
    two steps each, experts and Mamba2 heads split over ``"model"``."""
    from repro_torch.launch import train as launch
    got = {}
    for arch in ("deepseek_moe_16b", "zamba2_2p7b"):
        args = launch.parse_args(
            ["--arch", arch, "--reduced", "--steps", "2", "--global-batch",
             "4", "--seq", "16", "--ckpt-every", "2", "--mesh", "2,2",
             "--ckpt-dir", os.path.join(root, arch), "--device", "cpu"])
        res = launch.run(args, launch.make_config(args), "cpu")
        got[arch] = dict(losses=res["losses"],
                         restarts=res["result"]["restarts"])
    return got


def _on_ranks(rank, world, runs, root):
    return dict(steps=_steps_on_ranks(runs),
                ckpt=_checkpoints_on_ranks(runs["stablelm_1p6b"], root),
                launch=_launch_on_ranks(os.path.join(root, "launch")),
                family_launch=_family_launch_on_ranks(
                    os.path.join(root, "family_launch")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if "runs" not in _CACHE:
        ref_runs = _reference_runs()
        root = str(tmp_path_factory.mktemp("ranks"))
        ranks = run_ranks(_on_ranks, 4, root, ref_runs, root, timeout=240)
        _CACHE["runs"] = (ref_runs, ranks, root)
    return _CACHE["runs"]


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == "sgd"],
                         ids=lambda c: "{}-{}-{}-{}x{}".format(
                             c[0].split("_")[0],
                             "compress" if c[2] else "plain",
                             "fsdp" if c[3] else "dp", *c[4]))
def test_sharded_step_matches_the_reference(runs, case):
    """Loss and every leaf within 1e-5; each leaf's two-step update within
    2 % of the reference's (largest entries), so that a wrong gradient of
    a leaf whose update is below 1e-5 fails too.  (Compressed steps read
    up to 0.9 % apart there: one int8 quantum moved by an ulp.)"""
    ref_runs, ranks, _ = runs
    arch, _, compress = case[:3]
    want = ref_runs[arch]["steps"][("sgd", compress)]
    from repro_torch.training import optimizer as opt_lib
    leaves = [np.asarray(x, np.float32)
              for x in opt_lib.tree_leaves(want["params"])]
    p0 = [np.asarray(x, np.float32)
          for x in opt_lib.tree_leaves(ref_runs[arch]["sgd"]["params"])]
    assert min(float(np.abs(a - b).max()) for a, b in zip(leaves, p0)) > 0
    for rank, got in enumerate(ranks):
        res = got["steps"][case]
        np.testing.assert_allclose(res["losses"], want["losses"], rtol=0,
                                   atol=TOL, err_msg=str(rank))
        assert len(res["params"]) == len(leaves)
        for a, b, z in zip(res["params"], leaves, p0):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL,
                                       err_msg=str(rank))
            assert np.abs((a - z) - (b - z)).max() <= \
                0.02 * np.abs(b - z).max(), rank


def test_sharded_adamw_step_matches_the_reference(runs):
    """AdamW on ``(2, 2)`` with ZeRO-3: the loss within 1e-5, each leaf's
    two-step update within 1e-3 of the reference's in relative L2."""
    ref_runs, ranks, _ = runs
    from repro_torch.training import optimizer as opt_lib
    arch = "stablelm_1p6b"
    want = ref_runs[arch]["steps"][("adamw", False)]
    p0 = [np.asarray(x, np.float32)
          for x in opt_lib.tree_leaves(ref_runs[arch]["adamw"]["params"])]
    w = [np.asarray(x, np.float32) for x in
         opt_lib.tree_leaves(want["params"])]
    for got in ranks:
        case = got["steps"][(arch, "adamw", False, True, (2, 2))]
        np.testing.assert_allclose(case["losses"], want["losses"], rtol=0,
                                   atol=TOL)
        for a, b, z in zip(case["params"], w, p0):
            du, dw = a - z, b - z
            rel = np.linalg.norm(du - dw) / max(np.linalg.norm(dw), 1e-30)
            assert rel <= 1e-3, rel


def test_sharded_save_is_byte_identical_to_the_reference(runs, tmp_path):
    ref = reference()
    ref_runs, ranks, _ = runs
    from repro.training import optimizer as ropt
    tree = ref_runs["stablelm_1p6b"]["adamw"]
    o = tree["opt"]
    as_jax = lambda t: ref.jax.tree.map(ref.jnp.asarray, t)  # noqa: E731
    state = {"params": as_jax(tree["params"]),
             "opt": ropt.OptState(ref.jnp.asarray(o["step"]),
                                  as_jax(o["mu"]), as_jax(o["nu"])),
             "step": ref.jnp.asarray(tree["step"])}
    d = str(tmp_path / "ref")
    ref.checkpoint.save(state, d, 3)
    want = os.path.join(d, "step_00000003")
    for label, path in ranks[0]["ckpt"]["dirs"].items():
        got = os.path.join(path, "step_00000003")
        assert sorted(os.listdir(got)) == sorted(os.listdir(want)), label
        for f in os.listdir(want):
            with open(os.path.join(got, f), "rb") as a, \
                    open(os.path.join(want, f), "rb") as b:
                assert a.read() == b.read(), (label, f)


def test_sharded_checkpoint_restores_onto_every_mesh_to_the_bit(runs):
    for got in runs[1]:
        assert got["ckpt"]["apart"] == []


def test_interrupted_sharded_launch_equals_the_uninterrupted_run(runs):
    for got in runs[1]:
        plain, failed = got["launch"]["plain"], got["launch"]["failed"]
        assert failed["restarts"] == 1 and plain["restarts"] == 0
        assert all(np.isfinite(plain["losses"])) and len(plain["losses"]) == 4
        # the failed run replays step 2 after restoring its step-2 save
        assert failed["losses"][:3] == plain["losses"][:3]
        assert failed["losses"][3:] == plain["losses"][2:]
        assert len(failed["leaves"]) == len(plain["leaves"])
        for a, b in zip(failed["leaves"], plain["leaves"]):
            assert np.array_equal(a, b)
    first = runs[1][0]["launch"]["plain"]["leaves"]
    for got in runs[1][1:]:
        for a, b in zip(got["launch"]["plain"]["leaves"], first):
            assert np.array_equal(a, b)


def test_sharded_launch_trains_the_moe_and_hybrid_families(runs):
    """``launch/train.py --mesh 2,2`` of reduced DeepSeek-MoE and Zamba2:
    finite losses, no restart, the same losses on every rank."""
    first = runs[1][0]["family_launch"]
    for got in runs[1]:
        assert got["family_launch"] == first
    for arch, res in first.items():
        assert len(res["losses"]) == 2 and res["restarts"] == 0, arch
        assert all(np.isfinite(res["losses"])), arch

"""``launch.mesh`` and the sharded evaluator's layout rule, on the CPU.

The reference lays its meshes over forced host devices in one process; the
port's counterpart is several ranks of ``torch.distributed`` (``gloo``),
spawned here with a ``FileStore`` under ``tmp_path``.  The per-call layout
of ``core.engine.ShardedEvaluator`` is host logic and is held to the
reference's ``ShardedEvaluator._chunk_sharding`` bit for bit with no ranks
at all.
"""
import types

import numpy as np
import pytest
import torch

from test_torch_helpers import reference, run_ranks

MESHES = {(4,): ("cand",), (2, 2): ("cand", "batch"),
          (1, 4): ("cand", "batch")}


@pytest.mark.parametrize("shape", list(MESHES))
def test_chunk_layout_matches_reference(shape):
    """Padded count and layout for n in 1..32 on (4,), (2, 2) and (1, 4)
    meshes, against the reference's method on a stand-in for its mesh."""
    from repro_torch.core import engine
    ref = reference()
    axes = MESHES[shape]
    sizes = dict(zip(axes, shape))
    n_dev = int(np.prod(shape))
    cand = int(np.prod([sizes[a] for a in axes if a != "batch"]))
    stand_in = types.SimpleNamespace(_n_dev=n_dev, _cand=cand,
                                     _joint_sharding="joint",
                                     _cand_sharding="cand")
    for n in range(1, 33):
        want = ref.engine.ShardedEvaluator._chunk_sharding(stand_in, n)
        assert engine.chunk_layout(n, n_dev, cand) == want, (shape, n)


def test_backend_rule(monkeypatch):
    from repro_torch.launch import mesh
    assert mesh.backend_for("cpu", 1) == "gloo"
    assert mesh.backend_for("cpu", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh.backend_for("cuda", 4) == "nccl"     # a card each
    assert mesh.backend_for("cuda", 8) == "gloo"     # ranks share cards
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.backend_for("cuda", 4) == "gloo"


def test_world_of_one_without_a_launcher(monkeypatch):
    """No launcher, no store: a world of 1, meshes of one rank, and the
    production mesh refused with the rank count it needs."""
    from repro_torch.core import engine, masks as M
    from repro_torch.launch import mesh
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.process_info() == (0, 1)
    try:
        m = mesh.make_candidate_mesh(device="cpu")
        assert tuple(m.mesh_dim_names) == ("cand",)
        assert tuple(m.mesh.shape) == (1,)
        assert mesh.process_info() == (0, 1)
        with pytest.raises(ValueError, match="need 256 ranks, have 1"):
            mesh.make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="need 512 ranks, have 1"):
            mesh.make_production_mesh(multi_pod=True, device="cpu")
        with pytest.raises(ValueError, match="need 2x1 ranks"):
            mesh.make_cand_batch_mesh(cand=2, batch=1, device="cpu")
        ev = engine.make_evaluator(
            "sharded", eval_fn=lambda m, ties=True: m["s"].sum(dim=-1),
            device="cpu")
        assert ev.name == "sharded"
        stacked = M.sample_removal_blocks(
            np.random.default_rng(0), {"s": np.ones((8,), np.float32)}, 2, 3)
        np.testing.assert_array_equal(ev.evaluate(stacked), [6.0] * 3)
        env = mesh.coordinator_env()
        assert env == {"REPRO_COORD_RANK": "0", "REPRO_COORD_WORLD": "1"}
    finally:
        mesh.shutdown()
    assert mesh.process_info() == (0, 1)


def _meshes_on_ranks(rank, world):
    import torch.distributed as dist
    from repro_torch.launch import mesh
    out = {"info": mesh.process_info()}
    cand = mesh.make_candidate_mesh(device="cpu")
    cb = mesh.make_cand_batch_mesh(cand=2, batch=2, device="cpu")
    host = mesh.make_host_mesh(2, 2, device="cpu")
    out["names"] = [tuple(m.mesh_dim_names) for m in (cand, cb, host)]
    out["shapes"] = [tuple(m.mesh.shape) for m in (cand, cb, host)]
    out["dp_axes"] = (mesh.dp_axes(cb), mesh.dp_axes(host))
    out["coord"] = list(cb.get_coordinate())
    # a reduction over each axis of the (cand, batch) mesh
    sums = {}
    for axis in ("cand", "batch"):
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=cb.get_group(axis))
        sums[axis] = float(t)
    out["sums"] = sums
    try:
        mesh.make_production_mesh(device="cpu")
    except ValueError as e:
        out["production"] = str(e)
    env = mesh.coordinator_env()
    out["env"] = env
    tree = {"w": torch.full((3,), float(rank)), "b": [torch.tensor(rank)]}
    mesh.broadcast_tree(tree)
    out["broadcast"] = (tree["w"].tolist(), int(tree["b"][0]))
    return out


def test_meshes_over_four_gloo_ranks(tmp_path):
    outs = run_ranks(_meshes_on_ranks, 4, tmp_path)
    session = outs[0]["env"]["REPRO_COORD_SESSION"]
    for rank, out in enumerate(outs):
        assert out["info"] == (rank, 4)
        assert out["names"] == [("cand",), ("cand", "batch"),
                                ("data", "model")]
        assert out["shapes"] == [(4,), (2, 2), (2, 2)]
        assert out["dp_axes"] == ((), ("data",))
        c, b = divmod(rank, 2)
        assert out["coord"] == [c, b]
        # ranks (c, 0) and (c, 1) share a batch group; (0, b), (1, b) a
        # cand group
        assert out["sums"] == {"batch": float(2 * c + 2 * c + 1),
                               "cand": float(b + 2 + b)}
        assert out["production"] == "need 256 ranks, have 4"
        assert out["env"] == {"REPRO_COORD_RANK": str(rank),
                              "REPRO_COORD_WORLD": "4",
                              "REPRO_COORD_SESSION": session}
        assert out["broadcast"] == ([0.0, 0.0, 0.0], 0)


def test_entry_points_default_to_the_card():
    import inspect
    from repro_torch.core import engine
    from repro_torch.launch import mesh
    for fn in (mesh.init_process_group, mesh.make_production_mesh,
               mesh.make_host_mesh, mesh.make_candidate_mesh,
               mesh.make_cand_batch_mesh, mesh.join_sharded_run,
               engine.ShardedEvaluator.__init__):
        assert inspect.signature(fn).parameters["device"].default == \
            "cuda", fn

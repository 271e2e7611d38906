"""The port's checkpoints (``repro_torch.training.checkpoint``) against the
reference's on-disk format, on the CPU.

A checkpoint written by either package restores in the other with equal
bits, and the same state written by both gives byte-identical files and the
same ``manifest_fingerprint`` — the manifest's ``treedef`` string included,
which the port formats itself.  Then the crash-safety contract, port only:
corrupted, partial and garbage checkpoints are refused, the newest valid
one is the resume point, readers time out on a dead writer, and a non-writer
rank writes nothing.

The state is the mini CNN's parameters (the reference's ``CNN.init``,
converted) beside numpy masks, plus a list of 13 leaves: sorted key strings
put ``w/10`` before ``w/2``, which is not the tree walk's order.
"""
import collections
import json
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from test_torch_helpers import random_masks, reference, to_numpy_tree

STAGES = ((8, 2, 1), (16, 2, 2))       # the r18-mini plan


class Pair(NamedTuple):
    first: object
    second: object


Point = collections.namedtuple("Point", "x y z")
Empty = collections.namedtuple("Empty", "")


@pytest.fixture(scope="module")
def states():
    """(reference tree of jax arrays, port tree of CPU tensors, masks) of
    one state."""
    from repro_torch import convert
    ref = reference()
    model = ref.resnet.CNN(ref.resnet.CNNConfig(
        "mini", 4, 8, STAGES, stem_channels=8))
    rparams = model.init(ref.jax.random.PRNGKey(0))
    masks = random_masks(model.mask_sites(), seed=3)
    extra = [np.full((2,), i, np.float32) for i in range(13)]
    rtree = {"masks": masks, "params": rparams,
             "extra": {"w": [ref.jnp.asarray(x) for x in extra],
                       "t": (np.int32(7), None)}}
    ttree = {"masks": masks,
             "params": convert.params_from_reference(to_numpy_tree(rparams),
                                                     "cpu"),
             "extra": {"w": [torch.from_numpy(x.copy()) for x in extra],
                       "t": (np.int32(7), None)}}
    return ref, rtree, ttree


def _leaves(tree):
    from repro_torch.training import checkpoint
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in checkpoint._flatten(tree)}


def _numpy_tree(tree):
    """A reference tree with jax arrays as numpy (None kept)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    return None if tree is None else np.asarray(tree)


def _assert_same_bits(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert la[k].shape == lb[k].shape, k
        assert la[k].tobytes() == lb[k].tobytes(), k


# ------------------------------------------------------- across packages


def test_reference_checkpoint_restores_in_port(states, tmp_path):
    from repro_torch.training import checkpoint
    ref, rtree, ttree = states
    d = str(tmp_path / "ck")
    ref.checkpoint.save(rtree, d, 4, meta={"by": "reference"})
    got, step = checkpoint.restore(ttree, d, device="cpu")
    assert step == 4
    assert all(isinstance(t, torch.Tensor)
               for _, t in checkpoint._flatten(got))
    assert got["extra"]["t"][1] is None and isinstance(got["extra"]["w"],
                                                        list)
    _assert_same_bits(got, _numpy_tree(rtree))


def test_port_checkpoint_restores_in_reference(states, tmp_path):
    from repro_torch.training import checkpoint
    ref, rtree, ttree = states
    d = str(tmp_path / "ck")
    checkpoint.save(ttree, d, 2, meta={"by": "port"})
    got, step = ref.checkpoint.restore(rtree, d)
    assert step == 2
    _assert_same_bits(_numpy_tree(got), ttree)


def test_same_state_gives_identical_files_and_fingerprint(states, tmp_path):
    from repro_torch.training import checkpoint
    ref, rtree, ttree = states
    meta = {"algo": "bcd", "history": [{"step": 0, "acc": 91.5}],
            "rng": np.random.default_rng(5).bit_generator.state}
    dr, dt = str(tmp_path / "r"), str(tmp_path / "t")
    ref.checkpoint.save(rtree, dr, 1, meta=meta)
    checkpoint.save(ttree, dt, 1, meta=meta)
    sr, st = os.path.join(dr, "step_00000001"), os.path.join(dt,
                                                             "step_00000001")
    assert sorted(os.listdir(sr)) == sorted(os.listdir(st))
    for name in os.listdir(sr):
        with open(os.path.join(sr, name), "rb") as a, \
                open(os.path.join(st, name), "rb") as b:
            assert a.read() == b.read(), name
    assert checkpoint.manifest_fingerprint(dt, 1) == \
        ref.checkpoint.manifest_fingerprint(dr, 1)


@pytest.mark.parametrize("tree", [
    {"masks": {"b": 1, "a": 2}, "params": {"w": [1, (2, None)], "z": {}}},
    {"n": None, "x": (1,), "y": [], "z": ()},
    {1: 2, 0: 3},
    [{"a": 1}, (None,)],
    np.ones(3),
    None,
    {"k'q": 1, 'u"v': 2},
    {"opt": Pair(1, {"b": 2, "a": [3]}), "step": 4},
    Point(None, (1,), {"q": Pair(2, None)}),
    [Empty(), Point(1, 2, 3)],
])
def test_treedef_string_is_jax_tree_util_s(tree):
    from repro_torch.training import checkpoint
    ref = reference()
    assert checkpoint.treedef_str(tree) == \
        str(ref.jax.tree_util.tree_structure(tree))


def test_leaves_are_numbered_by_sorted_key_strings(states, tmp_path):
    """``extra/w/10`` is written before ``extra/w/2`` — the order of the
    sorted joined keys, as the reference numbers files — and the file each
    key lands in is the reference's."""
    from repro_torch.training import checkpoint
    ref, rtree, ttree = states
    dt, dr = str(tmp_path / "t"), str(tmp_path / "r")
    checkpoint.save(ttree, dt, 0)
    ref.checkpoint.save(rtree, dr, 0)
    mine = checkpoint.read_manifest(dt, 0)["leaves"]
    theirs = ref.checkpoint.read_manifest(dr, 0)["leaves"]
    assert {k: v["file"] for k, v in mine.items()} == \
        {k: v["file"] for k, v in theirs.items()}
    keys = sorted(mine)
    assert keys.index("extra/w/10") < keys.index("extra/w/2")
    files = {k: int(v["file"][5:10]) for k, v in mine.items()}
    assert files["extra/w/10"] == files["extra/w/1"] + 1
    walk = [k for k, _ in checkpoint._flatten(ttree)]
    assert walk.index("extra/w/2") < walk.index("extra/w/10")


# --------------------------------------------- crash safety (port only)


def _two_checkpoints(tmp_path):
    from repro_torch.training import checkpoint
    d = str(tmp_path / "ck")
    tree = {"masks": {"a": np.ones(6, np.float32)},
            "params": {"w": torch.arange(4, dtype=torch.float32)}}
    for step in (1, 2):
        checkpoint.save(tree, d, step, keep=10)
    return tree, d


def test_corrupted_leaf_falls_back_to_previous_checkpoint(tmp_path):
    from repro_torch.training import checkpoint
    tree, d = _two_checkpoints(tmp_path)
    leaf = os.path.join(d, "step_00000002", "leaf_00000.npy")
    blob = bytearray(open(leaf, "rb").read())
    blob[-1] ^= 0xFF                      # same size, flipped bytes
    open(leaf, "wb").write(bytes(blob))
    assert checkpoint.validate(d, 2, deep=False)
    assert not checkpoint.validate(d, 2, deep=True)
    assert checkpoint.latest_valid_step(d) == 1
    with pytest.raises(checkpoint.CheckpointError, match="sha256"):
        checkpoint.restore(tree, d, 2, device="cpu")
    got, _ = checkpoint.restore(tree, d, 1, device="cpu")
    assert torch.equal(got["params"]["w"], tree["params"]["w"])


def test_partial_checkpoint_missing_leaf_rejected(tmp_path):
    from repro_torch.training import checkpoint
    tree, d = _two_checkpoints(tmp_path)
    os.remove(os.path.join(d, "step_00000002", "leaf_00001.npy"))
    assert not checkpoint.validate(d, 2)
    assert checkpoint.latest_valid_step(d) == 1
    with pytest.raises(checkpoint.CheckpointError, match="missing"):
        checkpoint.restore(tree, d, 2, device="cpu")


def test_garbage_manifest_rejected(tmp_path):
    from repro_torch.training import checkpoint
    tree, d = _two_checkpoints(tmp_path)
    with open(os.path.join(d, "step_00000002", "manifest.json"), "w") as f:
        f.write("{not json")
    assert not checkpoint.validate(d, 2)
    assert checkpoint.latest_valid_step(d) == 1
    with pytest.raises(checkpoint.CheckpointError, match="unreadable"):
        checkpoint.read_manifest(d, 2)


def test_latest_valid_step_and_gc(tmp_path):
    from repro_torch.training import checkpoint
    d = str(tmp_path / "ck")
    assert checkpoint.latest_valid_step(d) is None
    assert checkpoint.latest_step(d) is None
    for step in range(5):
        checkpoint.save({"x": np.full(3, step)}, d, step, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    os.remove(os.path.join(d, "step_00000004", "manifest.json"))
    assert checkpoint.latest_step(d) == 4           # present ...
    assert checkpoint.latest_valid_step(d) == 3     # ... but not valid
    with pytest.raises(checkpoint.CheckpointError, match="requires|missing"):
        checkpoint.restore({"y": np.zeros(3)}, d, 3, device="cpu")


def test_wait_for_step(tmp_path):
    from repro_torch.training import checkpoint
    d = str(tmp_path / "ck")
    with pytest.raises(checkpoint.CheckpointError, match="timed out"):
        checkpoint.wait_for_step(d, 1, timeout_s=0.2, poll_s=0.01)
    checkpoint.save({"x": np.ones(3)}, d, 2)
    assert checkpoint.wait_for_step(d, 1, timeout_s=0.2) == 2


def test_non_writer_rank_writes_nothing(tmp_path):
    from repro_torch.launch import coordinator as coord_lib
    from repro_torch.training import checkpoint
    reader = coord_lib.FileCoordinator(str(tmp_path / "c"), 1, 2)
    with pytest.raises(checkpoint.CheckpointError, match="writer"):
        checkpoint.save({"x": np.ones(3)}, str(tmp_path / "ck"), 0,
                        coordinator=reader)
    assert not os.path.exists(str(tmp_path / "ck"))


def test_bfloat16_leaves_round_trip_in_the_reference_format(tmp_path):
    """A bfloat16 leaf is written as ``np.save`` writes an ``ml_dtypes``
    array — an ``.npy`` header saying ``'<V2'``, the raw 16-bit payload —
    with ``"bfloat16"`` in the manifest, and restores to the bit as a
    ``torch.bfloat16`` tensor, 0-d leaves included; a file whose items are
    not 2 bytes wide is refused for a leaf the manifest calls bfloat16."""
    from repro_torch.training import checkpoint
    d = str(tmp_path / "ck")
    pattern = torch.tensor([0x3F80, 0x7F80, -0x0080, 0x7FC1, 0x0001, -1,
                            0x4049, 0], dtype=torch.int16)  # 1, ±inf, NaN …
    tree = {"w": pattern.view(torch.bfloat16).reshape(2, 4),
            "z": torch.tensor(2.5, dtype=torch.bfloat16),
            "s": torch.ones(3)}
    checkpoint.save(tree, d, 0)
    step_dir = os.path.join(d, "step_00000000")
    manifest = checkpoint.read_manifest(d, 0)
    assert manifest["leaves"]["w"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["z"]["shape"] == []
    raw = open(os.path.join(step_dir, manifest["leaves"]["w"]["file"]),
               "rb").read()
    assert raw.startswith(b"\x93NUMPY\x01\x00") and b"'descr': '<V2'" in raw
    assert raw.endswith(pattern.numpy().tobytes())
    got, _ = checkpoint.restore({"w": 0, "z": 0, "s": 0}, d, 0, device="cpu")
    assert got["w"].dtype == got["z"].dtype == torch.bfloat16
    assert got["z"].shape == ()
    assert torch.equal(got["w"].view(torch.int16), tree["w"].view(torch.int16))
    assert float(got["z"]) == 2.5 and got["s"].dtype == torch.float32
    # a manifest that calls a 4-byte leaf bfloat16 is refused
    mf = os.path.join(step_dir, "manifest.json")
    manifest["leaves"]["s"]["dtype"] = "bfloat16"
    json.dump(manifest, open(mf, "w"))
    with pytest.raises(checkpoint.CheckpointError, match="2-byte"):
        checkpoint.restore({"s": 0}, d, 0, device="cpu")


def test_unsupported_nodes_are_refused(tmp_path):
    """An OrderedDict, and a tuple subclass that is not a namedtuple,
    flatten otherwise in ``jax.tree_util``: refused."""
    from repro_torch.training import checkpoint

    class Triple(tuple):
        pass
    for tree in (collections.OrderedDict(a=np.ones(2)),
                 {"t": Triple((np.ones(2),))}):
        with pytest.raises(checkpoint.CheckpointError, match="unsupported"):
            checkpoint.save(tree, str(tmp_path / "ck"), 0)


def test_namedtuple_nodes_round_trip(tmp_path):
    """Any namedtuple flattens by its fields, keyed by their names, prints
    as ``jax.tree_util`` prints it, and is rebuilt as its own type."""
    from repro_torch.training import checkpoint
    ref = reference()
    tree = {"p": Point(torch.arange(3.0), None, [np.int32(5)]),
            "q": Pair(Empty(), torch.ones(2, 2))}
    d = str(tmp_path / "ck")
    checkpoint.save(tree, d, 3)
    manifest = checkpoint.read_manifest(d, 3)
    assert sorted(manifest["leaves"]) == ["p/x", "p/z/0", "q/second"]
    assert manifest["treedef"] == str(
        ref.jax.tree_util.tree_structure(tree))
    got, step = checkpoint.restore(tree, d, device="cpu")
    assert step == 3
    assert type(got["p"]) is Point and type(got["q"]) is Pair
    assert type(got["q"].first) is Empty and got["p"].y is None
    assert torch.equal(got["p"].x, tree["p"].x)
    assert int(got["p"].z[0]) == 5
    # the reference restores the port's file into the same structure
    back, _ = ref.checkpoint.restore(tree, d, 3)
    np.testing.assert_array_equal(np.asarray(back["q"].second),
                                  np.ones((2, 2)))


# ------------------------------------------------ a train state, OptState


@pytest.fixture(scope="module")
def train_states():
    """One reduced StableLM train state after a step of the reference's
    jitted ``make_train_step``, as the reference holds it and converted to
    the port's (counters 0-d int32 tensors, moments converted), and both
    packages' fresh templates."""
    ref = reference()
    import repro.training.optimizer as ropt
    import repro.training.train as rtrain
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.training import optimizer as opt_lib, train
    from repro_torch.data import MarkovTokens
    rcfg = ref.configs.get_config("stablelm_1p6b").reduced()
    rmodel, ropt_ = ref.lm.LM(rcfg), ropt.adamw(lr=1e-3)
    rstate = rtrain.make_state(rmodel, ropt_, ref.jax.random.PRNGKey(0))
    b = MarkovTokens(rcfg.vocab).batch(2, 16, 0)
    rstate, _ = ref.jax.jit(rtrain.make_train_step(
        rmodel, ropt_, rtrain.TrainStepCfg(dp_axes=())))(
        rstate, {k: ref.jnp.asarray(v) for k, v in b.items()},
        ref.masks.as_device(ref.linearize.init_masks(rmodel.mask_sites())))

    def conv(t):
        return convert.params_from_reference(
            ref.jax.tree.map(np.asarray, t), "cpu")
    o = rstate["opt"]
    tstate = {"params": conv(rstate["params"]),
              "opt": opt_lib.OptState(torch.tensor(int(o.step),
                                                   dtype=torch.int32),
                                      conv(o.mu), conv(o.nu)),
              "step": torch.tensor(int(rstate["step"]), dtype=torch.int32)}
    tmodel = LM(get_config("stablelm_1p6b").reduced())
    ttemplate = train.make_state(tmodel, opt_lib.adamw(lr=1e-3),
                                 torch.Generator().manual_seed(1), "cpu")
    rtemplate = rtrain.make_state(rmodel, ropt_, ref.jax.random.PRNGKey(1))
    return ref, rstate, tstate, rtemplate, ttemplate


def _train_state_leaves(state):
    from repro_torch.training import checkpoint
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in checkpoint._flatten(state)}


def test_train_state_crosses_packages_with_equal_bits(train_states,
                                                      tmp_path):
    """The reference's train state, ``OptState`` included, restores into
    the port's template with equal bits, and the port's into the
    reference's."""
    from repro_torch.training import checkpoint
    from repro_torch.training import optimizer as opt_lib
    ref, rstate, tstate, rtemplate, ttemplate = train_states
    dr, dt = str(tmp_path / "r"), str(tmp_path / "t")
    ref.checkpoint.save(rstate, dr, 1)
    got, _ = checkpoint.restore(ttemplate, dr, 1, device="cpu")
    assert type(got["opt"]) is opt_lib.OptState
    assert got["step"].dtype == torch.int32 and got["step"].dim() == 0
    want = _train_state_leaves(tstate)
    mine = _train_state_leaves(got)
    assert mine.keys() == want.keys()
    assert "opt/mu/embed" in mine and "opt/step" in mine
    for k in want:
        assert mine[k].dtype == want[k].dtype, k
        assert mine[k].tobytes() == want[k].tobytes(), k
    checkpoint.save(tstate, dt, 1)
    back, _ = ref.checkpoint.restore(rtemplate, dt, 1)
    assert type(back["opt"]).__name__ == "OptState"
    flat_r = dict(ref.checkpoint._flatten(rstate))
    for k, v in ref.checkpoint._flatten(back).items():
        a, b0 = np.asarray(v), np.asarray(flat_r[k])
        assert a.dtype == b0.dtype and a.tobytes() == b0.tobytes(), k


def test_train_state_files_are_byte_identical(train_states, tmp_path):
    from repro_torch.training import checkpoint
    ref, rstate, tstate, _, _ = train_states
    dr, dt = str(tmp_path / "r"), str(tmp_path / "t")
    ref.checkpoint.save(rstate, dr, 2)
    checkpoint.save(tstate, dt, 2)
    sr, st = (os.path.join(d, "step_00000002") for d in (dr, dt))
    assert sorted(os.listdir(sr)) == sorted(os.listdir(st))
    for name in os.listdir(sr):
        with open(os.path.join(sr, name), "rb") as a, \
                open(os.path.join(st, name), "rb") as b:
            assert a.read() == b.read(), name
    assert checkpoint.manifest_fingerprint(dt, 2) == \
        ref.checkpoint.manifest_fingerprint(dr, 2)
    assert "CustomNode(namedtuple[OptState]" in \
        checkpoint.read_manifest(dt, 2)["treedef"]


def test_manifest_fingerprint_tracks_content(tmp_path):
    from repro_torch.training import checkpoint
    d = str(tmp_path / "ck")
    checkpoint.save({"x": torch.ones(3)}, d, 0, meta={"tag": "a"})
    fp = checkpoint.manifest_fingerprint(d, 0)
    assert fp == checkpoint.manifest_fingerprint(d, 0)
    checkpoint.save({"x": torch.zeros(3)}, d, 0, meta={"tag": "a"})
    assert checkpoint.manifest_fingerprint(d, 0) != fp

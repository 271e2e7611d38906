"""The checkpoints' leaf hashes on several threads
(``repro_torch.training.checkpoint._HASH_THREADS``), on the CPU.

Saving hashes each leaf file while the next ones are written; restoring and
deep validation hash every file before the leaves are checked in order.  The
manifest, the files and the restored bits must not depend on the thread
count, they must equal what the reference writes for the same state, and a
corrupted checkpoint must still be refused at its first bad leaf in the
restore template's order.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from test_torch_helpers import reference

N_LEAVES = 12


def _state():
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((3 + i, 5)).astype(np.float32)
              for i in range(N_LEAVES)]
    return arrays, {"w": [torch.from_numpy(a.copy()) for a in arrays],
                    "step": np.int32(3)}


def _step_dir(d, step):
    return os.path.join(d, f"step_{step:08d}")


def _files(d, step):
    sd = _step_dir(d, step)
    return {name: open(os.path.join(sd, name), "rb").read()
            for name in sorted(os.listdir(sd))}


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_save_matches_the_reference_at_any_thread_count(threads, tmp_path,
                                                         monkeypatch):
    from repro_torch.training import checkpoint
    ref = reference()
    arrays, state = _state()
    monkeypatch.setattr(checkpoint, "_HASH_THREADS", threads)
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    checkpoint.save(state, mine, 1)
    ref.checkpoint.save({"w": [ref.jnp.asarray(a) for a in arrays],
                         "step": np.int32(3)}, theirs, 1)
    assert _files(mine, 1) == _files(theirs, 1)
    assert checkpoint.manifest_fingerprint(mine, 1) == \
        ref.checkpoint.manifest_fingerprint(theirs, 1)
    manifest = json.loads(_files(mine, 1)["manifest.json"])
    for info in manifest["leaves"].values():
        data = _files(mine, 1)[info["file"]]
        assert info["sha256"] == hashlib.sha256(data).hexdigest()


@pytest.mark.parametrize("threads", [1, 8])
def test_restore_and_validate_at_any_thread_count(threads, tmp_path,
                                                  monkeypatch):
    from repro_torch.training import checkpoint
    arrays, state = _state()
    d = str(tmp_path / "ck")
    checkpoint.save(state, d, 1)
    monkeypatch.setattr(checkpoint, "_HASH_THREADS", threads)
    assert checkpoint.validate(d, 1, deep=True)
    got, step = checkpoint.restore(state, d, device="cpu")
    assert step == 1
    for a, t in zip(arrays, got["w"]):
        assert t.numpy().tobytes() == a.tobytes()


@pytest.mark.parametrize("threads", [1, 8])
def test_first_bad_leaf_in_template_order_is_refused(threads, tmp_path,
                                                     monkeypatch):
    from repro_torch.training import checkpoint
    _, state = _state()
    d = str(tmp_path / "ck")
    checkpoint.save(state, d, 1)
    checkpoint.save(state, d, 2)
    monkeypatch.setattr(checkpoint, "_HASH_THREADS", threads)
    manifest = checkpoint.read_manifest(d, 2)
    # two leaves flipped: the template's walk meets w/4 before w/9
    for key in ("w/9", "w/4"):
        path = os.path.join(_step_dir(d, 2), manifest["leaves"][key]["file"])
        raw = bytearray(open(path, "rb").read())
        raw[-1] ^= 0xFF
        open(path, "wb").write(bytes(raw))
    with pytest.raises(checkpoint.CheckpointError, match="'w/4'"):
        checkpoint.restore(state, d, 2, device="cpu")
    assert checkpoint.validate(d, 2, deep=False)
    assert not checkpoint.validate(d, 2, deep=True)
    assert checkpoint.latest_valid_step(d) == 1
    # unverified, the flipped bytes load as they are
    got, _ = checkpoint.restore(state, d, 2, device="cpu", verify=False)
    assert not torch.equal(got["w"][4], state["w"][4])
    assert torch.equal(got["w"][5], state["w"][5])

"""The port's checkpoint manager (``repro_torch.checkpoint``) against the
reference's.

* ``tests/test_data_checkpoint.py::TestCheckpointManager`` on the port:
  round trip (bf16 included), retention, ``keep_every``, a checkpoint
  without its manifest skipped, ``.tmp`` junk ignored and removed, async
  save, restore of a given step, a missing checkpoint raising.
* The layout on disk is the reference's: each package lists, skips and
  restores what the other wrote (bf16 as raw ``uint16``), and the
  manifest's fingerprint (the CRC32 of each leaf's first 4096 bytes, a
  quirk kept: ``restore`` never checks it) is the reference's.
* The async hazard: the optimizer updates its moments in place, so a
  step that runs right after an async ``save`` must not reach the saved
  leaves.  The save's write is held until the step has run.
"""
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as manager_mod

torch.set_num_threads(1)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(8, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32),
            "mu": rng.normal(size=(8, 4)).astype(np.float32)}


def _tree(seed=0):
    """The reference test's ``_tree``, as tensors (``b`` in bf16)."""
    a = _arrays(seed)
    return {"params": {"w": torch.from_numpy(a["w"]),
                       "b": torch.from_numpy(a["b"]).to(torch.bfloat16)},
            "opt": {"mu": torch.from_numpy(a["mu"]),
                    "step": torch.tensor(17, dtype=torch.int32)}}


def _jax_tree(seed=0):
    a = _arrays(seed)
    return {"params": {"w": jnp.asarray(a["w"]),
                       "b": jnp.asarray(a["b"], jnp.bfloat16)},
            "opt": {"mu": jnp.asarray(a["mu"]),
                    "step": jnp.asarray(17, jnp.int32)}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


class TestCheckpointManager:
    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        tree = _tree()
        mgr.save(10, tree)
        step, restored = mgr.restore(_tree(seed=1))
        assert step == 10
        _assert_trees_equal(tree, restored)
        assert restored["params"]["b"].dtype == torch.bfloat16

    def test_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, _tree(s))
        assert [c.step for c in mgr.all_checkpoints()] == [3, 4]

    def test_keep_every(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=1, keep_every=2)
        for s in (1, 2, 3):
            mgr.save(s, _tree(s))
        steps = [c.step for c in mgr.all_checkpoints()]
        assert 2 in steps and 3 in steps and 1 not in steps

    def test_corrupt_checkpoint_skipped(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, _tree(1))
        mgr.save(2, _tree(2))
        os.remove(os.path.join(mgr._ckpt_dir(2), "manifest.json"))
        assert mgr.latest().step == 1
        step, restored = mgr.restore(_tree())
        assert step == 1
        _assert_trees_equal(restored, _tree(1))

    def test_tmp_junk_ignored_and_gced(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(5, _tree())
        junk = os.path.join(str(tmp_path), "step_0000000009.tmp")
        os.makedirs(junk)
        assert mgr.latest().step == 5
        CheckpointManager(str(tmp_path))  # re-open GCs tmp junk
        assert not os.path.exists(junk)

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        mgr.save(3, _tree())
        mgr.wait()
        assert mgr.latest().step == 3
        assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]

    def test_restore_specific_step(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=5)
        for s in (1, 2, 3):
            mgr.save(s, _tree(s))
        step, restored = mgr.restore(_tree(), step=2)
        assert step == 2
        assert torch.equal(restored["params"]["w"], _tree(2)["params"]["w"])

    def test_missing_raises(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        with pytest.raises(FileNotFoundError):
            mgr.restore(_tree())

    def test_lists_and_missing_leaves(self, tmp_path):
        """Lists (the port's per-layer blocks) round-trip by index, and a
        template leaf the checkpoint lacks raises."""
        tree = {"blocks": [{"w": torch.ones(2)}, {}, {"w": torch.zeros(3)}],
                "embed": torch.arange(6.0).reshape(2, 3)}
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, tree)
        _, restored = mgr.restore(tree)
        _assert_trees_equal(tree, restored)
        assert restored["blocks"][1] == {}
        with pytest.raises(ValueError, match="missing leaves"):
            mgr.restore(dict(tree, extra=torch.ones(1)))

    def test_elastic_restore_raises(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, _tree())
        with pytest.raises(NotImplementedError, match="multi-device"):
            mgr.restore(_tree(), shardings={})


class TestLayoutMatchesReference:
    def test_reference_reads_what_the_port_wrote(self, tmp_path):
        CheckpointManager(str(tmp_path), keep=5).save(4, _tree(4),
                                                      extra={"loss": 1.5})
        jm = JaxCheckpointManager(str(tmp_path))
        assert [c.step for c in jm.all_checkpoints()] == [4]
        step, restored = jm.restore(_jax_tree())
        assert step == 4
        want = _jax_tree(4)
        for k in ("w", "b"):
            np.testing.assert_array_equal(
                np.asarray(restored["params"][k], np.float32),
                np.asarray(want["params"][k], np.float32))
        assert restored["params"]["b"].dtype == jnp.bfloat16
        assert int(restored["opt"]["step"]) == 17
        assert jm.latest().manifest["extra"] == {"loss": 1.5}

    def test_port_reads_what_the_reference_wrote(self, tmp_path):
        jm = JaxCheckpointManager(str(tmp_path), keep=5)
        for s in (1, 2, 3):
            jm.save(s, _jax_tree(s))
        # a torn write of the newest: both managers skip it the same way
        os.remove(os.path.join(jm._ckpt_dir(3), "manifest.json"))
        mgr = CheckpointManager(str(tmp_path))
        assert [(c.step, c.path, c.manifest) for c in
                mgr.all_checkpoints()] == \
            [(c.step, c.path, c.manifest) for c in jm.all_checkpoints()]
        assert mgr.latest().step == jm.latest().step == 2
        step, restored = mgr.restore(_tree())
        assert step == 2
        _assert_trees_equal(restored, _tree(2))

    def test_manifest_matches_reference(self, tmp_path):
        """Leaf names, shapes, dtypes (bf16 as ``"bfloat16"``) and the
        head-CRC fingerprint equal the reference's; the fingerprint is
        the CRC of the first 4096 bytes only (a quirk: a change past them
        keeps it, and restore never checks it)."""
        big = np.random.default_rng(0).normal(size=(64, 64)).astype(
            np.float32)
        CheckpointManager(str(tmp_path / "t")).save(
            1, dict(_tree(), big=torch.from_numpy(big)))
        JaxCheckpointManager(str(tmp_path / "j")).save(
            1, dict(_jax_tree(), big=jnp.asarray(big)))
        man = {s: json.loads((tmp_path / s / "step_0000000001" /
                              "manifest.json").read_text())
               for s in ("t", "j")}
        for key in ("step", "n_leaves", "fingerprint", "leaves", "extra"):
            assert man["t"][key] == man["j"][key], key
        tail = big.copy()
        tail[-1, -1] += 1.0  # beyond the first 4096 bytes
        CheckpointManager(str(tmp_path / "t2")).save(
            1, dict(_tree(), big=torch.from_numpy(tail)))
        m2 = json.loads((tmp_path / "t2" / "step_0000000001" /
                         "manifest.json").read_text())
        assert m2["fingerprint"] == man["t"]["fingerprint"]


def test_step_after_async_save_does_not_reach_the_saved_leaves(
        tmp_path, monkeypatch):
    """An in-place update (AdamW's moments) right after ``save`` returns:
    the write is held until the update has run, and the restored leaves
    are still the state at the save."""
    tree = _tree()
    at_save = {k: v.clone() for k, v in tree["opt"].items()}
    stepped = threading.Event()
    real_savez = np.savez

    def held_savez(*args, **kw):
        assert stepped.wait(timeout=30)
        return real_savez(*args, **kw)

    monkeypatch.setattr(manager_mod.np, "savez", held_savez)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, tree)
    tree["opt"]["mu"].mul_(0.5).add_(1.0)  # the next step, in place
    tree["opt"]["step"].add_(1)
    stepped.set()
    mgr.wait()
    _, restored = mgr.restore(_tree(seed=9))
    assert torch.equal(restored["opt"]["mu"], at_save["mu"])
    assert int(restored["opt"]["step"]) == 17
    assert not torch.equal(tree["opt"]["mu"], at_save["mu"])


def test_async_write_error_is_raised_by_wait(tmp_path, monkeypatch):
    """A failed background write (a full disk) surfaces at the next
    ``wait()`` and leaves no checkpoint and no ``.tmp`` behind the next
    manager; the reference's thread drops the error."""
    def full_disk(*args, **kw):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(manager_mod.np, "savez", full_disk)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, _tree())
    with pytest.raises(OSError, match="No space left"):
        mgr.wait()
    mgr.wait()  # raised once
    assert mgr.latest() is None
    CheckpointManager(str(tmp_path))
    assert os.listdir(tmp_path) == []

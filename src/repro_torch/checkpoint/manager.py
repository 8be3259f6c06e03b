"""Atomic, retention-managed checkpointing of trees of tensors.

Counterpart of ``repro.checkpoint.manager``, with its layout on disk, so
either package lists the other's checkpoints:

* **Atomicity**: a checkpoint ``step_%010d/`` (``arrays.npz`` and
  ``manifest.json``) is staged under ``<name>.tmp`` and moved into place
  with ``os.replace``; the manifest is written last, and a directory
  without one is skipped.  Interrupted writes leave ``*.tmp`` junk that
  is skipped and removed when a manager opens the directory.
* **Retention**: the newest ``keep`` checkpoints stay, plus every step
  that is a multiple of ``keep_every``.
* **Async**: ``save`` can write on a background thread while training
  goes on; ``wait()`` joins it before the next save or at exit.  The
  tree is copied to the host inside ``save``, before the thread starts:
  the optimizer updates its moments in place (``optim.adamw_update``),
  so the next step would otherwise write into the leaves being saved.
  On the CPU ``Tensor.numpy()`` shares the tensor's memory, so that
  copy is a clone.  An error in the background write is raised by the
  next ``wait()`` (the reference's thread drops it, and the checkpoint
  is silently missing).
* **Restore** places each leaf on the device of the template's leaf.

bfloat16 leaves are stored as raw ``uint16`` with ``"bfloat16"`` in the
manifest (numpy has no bfloat16), as the reference stores them.  The
reference's quirk is kept: the manifest's ``fingerprint`` is the CRC32
of the first 4096 bytes of each leaf, and ``restore`` never checks it
(ROADMAP queue 3).  A tree is dicts and lists of tensors; a leaf's name
is its path of keys and indices joined by ``/``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager", "CheckpointInfo"]


@dataclass
class CheckpointInfo:
    step: int
    path: str
    manifest: Dict[str, Any]


def _to_savable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` that ``np.savez`` can store, and its dtype's
    name: bfloat16 goes through its bits as ``uint16``."""
    host = t.detach().to("cpu", copy=True).contiguous()
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = host.numpy()
    return arr, str(arr.dtype)


def _from_saved(arr: np.ndarray, dtype_str: str,
                device: torch.device) -> torch.Tensor:
    if dtype_str == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.astype(np.dtype(dtype_str), copy=False))
    return t.to(device)


def _flatten_with_names(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs: dict keys in sorted order (the reference's
    pytree order), list items by index."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten_with_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten_with_names(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _rebuild(template, arrays: Dict[str, torch.Tensor], prefix: str = ""):
    """``template``'s structure with each leaf replaced by the array of
    its name."""
    if isinstance(template, dict):
        return {k: _rebuild(v, arrays, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, arrays, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return arrays[prefix[:-1]]


def _head_crc(arr: np.ndarray, crc: int) -> int:
    """The reference's fingerprint term: CRC32 of the first 4096 bytes of
    the stored array (its ``tobytes()[:4096]``, without copying the
    whole leaf)."""
    head = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)[:4096]
    return zlib.crc32(head.tobytes(), crc)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 keep_every: Optional[int] = None, async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.keep_every = keep_every
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)
        self._gc_tmp()

    # ------------------------------------------------------------------
    def _gc_tmp(self):
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def _ckpt_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_checkpoints(self) -> List[CheckpointInfo]:
        out = []
        for name in sorted(os.listdir(self.directory)):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            path = os.path.join(self.directory, name)
            mpath = os.path.join(path, "manifest.json")
            try:
                with open(mpath) as f:
                    manifest = json.load(f)
                out.append(CheckpointInfo(manifest["step"], path, manifest))
            except (OSError, json.JSONDecodeError, KeyError):
                continue  # incomplete/corrupt: skip
        return sorted(out, key=lambda c: c.step)

    def latest(self) -> Optional[CheckpointInfo]:
        cks = self.all_checkpoints()
        return cks[-1] if cks else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[Dict[str, Any]] = None):
        self.wait()
        # host copies now, before any later step can write the leaves
        leaves = [(name, _to_savable(leaf))
                  for name, leaf in _flatten_with_names(tree)]
        if self.async_save:
            self._thread = threading.Thread(
                target=self._save_in_background,
                args=(step, leaves, extra or {}))
            self._thread.start()
        else:
            self._save_sync(step, leaves, extra or {})

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _save_in_background(self, step: int, leaves, extra: Dict[str, Any]):
        try:
            self._save_sync(step, leaves, extra)
        except BaseException as e:  # handed to wait(), which re-raises
            self._error = e

    def _save_sync(self, step: int, leaves, extra: Dict[str, Any]):
        final = self._ckpt_dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest_leaves = {}
        fp = 0
        for name, (savable, dtype_str) in leaves:
            manifest_leaves[name] = {"shape": list(savable.shape),
                                     "dtype": dtype_str}
            fp = _head_crc(savable, fp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k.replace("/", "__"): v for k, (v, _) in leaves})
        manifest = {
            "step": step,
            "time": time.time(),
            "n_leaves": len(leaves),
            "fingerprint": fp,
            "leaves": manifest_leaves,
            "extra": extra,
        }
        # manifest written last: its presence marks the checkpoint complete
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._retain()

    def _retain(self):
        cks = self.all_checkpoints()
        if len(cks) <= self.keep:
            return
        drop = cks[:-self.keep]
        for c in drop:
            if self.keep_every and c.step % self.keep_every == 0:
                continue
            shutil.rmtree(c.path, ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, template, step: Optional[int] = None,
                shardings=None) -> Tuple[int, Any]:
        """Restore into the structure of ``template``, each leaf on the
        device of the template's leaf at the same name.  ``shardings``
        (the reference's elastic restore onto another mesh) raises."""
        if shardings is not None:
            raise NotImplementedError(
                "CheckpointManager.restore(shardings=...): elastic restore "
                "onto a mesh needs ROADMAP queue 1: multi-device, which is "
                "not ported yet")
        self.wait()
        infos = self.all_checkpoints()
        if step is not None:
            infos = [c for c in infos if c.step == step]
        if not infos:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        info = infos[-1]
        devices = {n: (leaf.device if isinstance(leaf, torch.Tensor)
                       else torch.device("cpu"))
                   for n, leaf in _flatten_with_names(template)}
        with np.load(os.path.join(info.path, "arrays.npz")) as data:
            arrays = {}
            for k in data.files:
                name = k.replace("__", "/")
                dtype_str = info.manifest["leaves"][name]["dtype"]
                arrays[name] = _from_saved(
                    data[k], dtype_str,
                    devices.get(name, torch.device("cpu")))
        if len(arrays) != info.manifest["n_leaves"]:
            raise ValueError(f"checkpoint {info.path} is corrupt "
                             f"(leaf count mismatch)")
        missing = [n for n in devices if n not in arrays]
        if missing:
            raise ValueError(f"checkpoint missing leaves: {missing[:5]}...")
        return info.step, _rebuild(template, arrays)

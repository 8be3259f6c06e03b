"""Persistent kernel-autotune cache.

Own copy of ``repro.autotune.cache``.  One JSON file maps
``v4|kernel|shape-signature|dtype|backend|workload|mesh`` to the tuned
block configuration (plus the measured/modelled cost and provenance).  The
file is the contract between the tuning side
(``repro_torch.autotune.autotune_kernel``, ``python -m
repro_torch.launch.tune --tune-kernels``) and the consuming side
(``repro_torch.kernels.ops`` resolves launch knobs through it; the serve
engine consults it for its shapes).

Location: ``$REPRO_AUTOTUNE_CACHE`` if set, else
``~/.cache/repro/autotune.json`` — the same file and variable as the
reference, so winners from the card sit beside the TPU's in one file and
the backend component (the port's ``cuda-sm90`` and ``model-sm90``, the
reference's ``tpu`` and ``cpu``) keeps them apart.
Writes are atomic (tmp + ``os.replace``) and merge-on-save: under an
exclusive ``flock`` on a sidecar lock file, the cache file is re-read and
unioned with the in-memory view before the replace, so two processes
tuning into one file keep each other's entries.  Per-key conflicts stay
last-writer-wins.

Every write (and every ``reload``) bumps ``generation()``, which the
kernel entry points read to drop their memo of resolved knobs.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import threading
import time
from typing import Any, Dict, Optional, Tuple

try:  # POSIX cross-process file locking; absent on some platforms
    import fcntl
except ImportError:  # pragma: no cover - linux container always has it
    fcntl = None

__all__ = ["AutotuneCache", "SCHEMA_VERSION", "default_cache",
           "reset_default_cache", "mesh_sig", "parse_mesh_sig",
           "mesh_distance", "nearest_mesh", "generation"]

# Bump whenever the key schema changes meaning.  v2: flash_attention
# signatures gained the SK (KV sequence length) dim — v1 entries were keyed
# without it, so cross-attention / cache-prefill problems with different KV
# lengths collided on one entry.  v3: every key gained a trailing
# workload-signature component (``-`` = workload-generic) so serve winners
# tuned under different live request mixes coexist; v2 entries carry the
# same meaning at the generic signature, so ``_load``/``_save`` MIGRATE
# them (rewritten under ``v3|...|-``) instead of dropping them — only
# pre-v2 keys remain unresolvable and disappear on the next write.
# v4: keys gained a trailing device/mesh-signature component (``1dev`` =
# single device) so winners tuned at one device count / mesh orientation
# never silently deploy at another; every v3 entry was tuned on one
# device, so it migrates in place to ``v4|...|1dev``.
SCHEMA_VERSION = 4

# Bumped by every write and reload of any cache object in this process;
# the kernel entry points drop their memo of resolved knobs when it moves.
_generation = 0
_generation_lock = threading.Lock()


def generation() -> int:
    """The count of cache writes and reloads in this process so far."""
    return _generation


def _bump_generation() -> None:
    global _generation
    with _generation_lock:
        _generation += 1

# ---------------------------------------------------------------------------
# mesh signatures: the device-topology component of every v4 cache key
# ---------------------------------------------------------------------------
def mesh_sig(shape: Any = None) -> str:
    """Canonical device/mesh signature for a cache key.

    ``shape`` is a ``(data, model)`` mesh shape (the serve engine's
    orientation), an existing signature string, or ``None``/``(1, 1)``
    for the single-device case — all spellings of one device collapse to
    ``"1dev"`` so offline tuning and migrated v3 entries share one key.
    """
    if shape is None:
        return "1dev"
    if isinstance(shape, str):
        parsed = parse_mesh_sig(shape)
        if parsed is None:
            raise ValueError(f"not a mesh signature: {shape!r}")
        return mesh_sig(parsed)
    data, model = (int(shape[0]), int(shape[1]))
    if data < 1 or model < 1:
        raise ValueError(f"mesh shape must be positive, got {shape!r}")
    if data * model == 1:
        return "1dev"
    return f"d{data}m{model}"


def parse_mesh_sig(sig: str) -> Optional[Tuple[int, int]]:
    """``(data, model)`` for a mesh signature, or None for anything that
    is not one (other key components included)."""
    if sig == "1dev":
        return (1, 1)
    m = re.fullmatch(r"d(\d+)m(\d+)", str(sig))
    if m is None:
        return None
    data, model = int(m.group(1)), int(m.group(2))
    if data < 1 or model < 1:
        return None
    return (data, model)


def mesh_distance(a: str, b: str) -> float:
    """Topology distance between two mesh signatures: the sum of per-axis
    log2 size gaps.  Same mesh is 0; growing one axis 2x costs 1; the
    replicas-vs-TP orientation flip at equal device count (``d2m1`` vs
    ``d1m2``) costs 2 — a donor at the same orientation is always closer
    than the transposed mesh."""
    pa, pb = parse_mesh_sig(a), parse_mesh_sig(b)
    if pa is None or pb is None:
        return float("inf")
    return (abs(math.log2(pa[0]) - math.log2(pb[0]))
            + abs(math.log2(pa[1]) - math.log2(pb[1])))


def nearest_mesh(candidates: Any, target: str
                 ) -> Optional[Tuple[str, float]]:
    """The candidate mesh signature nearest ``target`` (and its
    distance), or None when no candidate parses.  Ties break on sorted
    signature order, so warm-start donor selection is deterministic."""
    best: Optional[Tuple[float, str]] = None
    for sig in sorted(set(candidates)):
        d = mesh_distance(sig, target)
        if math.isfinite(d) and (best is None or d < best[0]):
            best = (d, sig)
    if best is None:
        return None
    return best[1], best[0]


def _default_path() -> str:
    env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro",
                        "autotune.json")


class AutotuneCache:
    """(kernel, shape, dtype, backend) -> tuned block config, on disk."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or _default_path()
        self._lock = threading.Lock()
        self._data: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------
    @staticmethod
    def key(kernel: str, sig: str, dtype: str, backend: str,
            workload: str = "", mesh: str = "") -> str:
        """The canonical cache key.  Every component is coerced through
        ``str`` and the workload signature is ``|``-sanitized, so keys
        serialize identically from every producer — a formatting mismatch
        here is a silent cache miss (and, since v3, one the
        nearest-signature fallback would quietly paper over).
        ``workload`` defaults to ``-``: the workload-generic entry
        offline tuning writes and migrated v2 entries land on.
        ``mesh`` defaults to ``1dev``: the single-device signature
        offline tuning writes and migrated v3 entries land on."""
        w = str(workload or "-").replace("|", "/")
        m = mesh_sig(mesh) if mesh else "1dev"
        return (f"v{SCHEMA_VERSION}|{kernel}|{sig}|{str(dtype)}"
                f"|{str(backend)}|{w}|{m}")

    @staticmethod
    def _upgrade(key: str) -> Optional[str]:
        """The current-schema key a stored key maps to, or None.

        Identity for current and NEWER schemas (a shared cache file
        touched by binaries of different versions must not lose the
        newer entries — they are inert here, lookups only ever use the
        current prefix).  v3 keys migrate to v4 under the single-device
        ``1dev`` mesh signature (they were tuned on one device — same
        meaning, new shape); v2 keys additionally gain the generic ``-``
        workload signature.  Anything older (unversioned v1 included) is
        unresolvable: None.
        """
        head = key.split("|", 1)[0]
        if not head.startswith("v"):
            return None  # v1 keys carried no version
        try:
            version = int(head[1:])
        except ValueError:
            return None
        if version >= SCHEMA_VERSION:
            return key
        parts = key.split("|")
        if version == 3 and len(parts) == 6:
            # v3|kernel|sig|dtype|backend|workload
            return "|".join([f"v{SCHEMA_VERSION}"] + parts[1:] + ["1dev"])
        if version == 2 and len(parts) == 5:
            # v2|kernel|sig|dtype|backend
            return "|".join([f"v{SCHEMA_VERSION}"] + parts[1:]
                            + ["-", "1dev"])
        return None

    @classmethod
    def _stale(cls, key: str) -> bool:
        """True for keys that neither resolve nor migrate (pre-v2)."""
        return cls._upgrade(key) is None

    @classmethod
    def _migrate(cls, raw: Dict[str, Any]) -> Dict[str, Any]:
        """Raw file contents -> current-schema view: stale keys drop,
        v2 keys are rewritten in place (the migration), and a native
        current-schema key always wins over a migrated one (second pass
        overwrites), so re-tuned entries are never shadowed by their
        pre-migration ancestors."""
        out: Dict[str, Any] = {}
        for k, v in raw.items():
            nk = cls._upgrade(k)
            if nk is not None and nk != k:
                out[nk] = v
        for k, v in raw.items():
            if cls._upgrade(k) == k:
                out[k] = v
        return out

    def _load(self) -> Dict[str, Any]:
        if self._data is None:
            try:
                with open(self.path) as f:
                    raw = json.load(f)
            except (FileNotFoundError, json.JSONDecodeError):
                raw = {}
            # Migrate/invalidate entries from older key schemas: v2
            # entries re-key to the current schema here (and physically
            # on the next _save); pre-v2 entries drop.
            self._data = self._migrate(raw)
        return self._data

    def reload(self) -> None:
        """Drop the in-memory view and re-read the file on next access."""
        with self._lock:
            self._data = None
        _bump_generation()

    # ------------------------------------------------------------------
    def get(self, kernel: str, sig: str, dtype: str, backend: str,
            workload: str = "", mesh: str = "") -> Optional[Dict[str, Any]]:
        """The cached entry ({config, value, ...}) or None."""
        with self._lock:
            entry = self._load().get(self.key(kernel, sig, dtype, backend,
                                              workload, mesh))
        return dict(entry) if entry else None

    def get_config(self, kernel: str, sig: str, dtype: str, backend: str,
                   workload: str = "", mesh: str = ""
                   ) -> Optional[Dict[str, Any]]:
        entry = self.get(kernel, sig, dtype, backend, workload, mesh)
        return dict(entry["config"]) if entry else None

    def scan_workloads(self, kernel: str, sig: str, dtype: str,
                       backend: str, mesh: str = ""
                       ) -> Dict[str, Dict[str, Any]]:
        """Every entry at this (kernel, shape, dtype, backend, mesh),
        keyed by its workload-signature component (``-`` = workload-
        generic) — the candidate set a nearest-signature transfer
        searches.  Scoped to ONE mesh signature: workload transfer never
        crosses device topologies (that is ``scan_meshes``'s job, and an
        explicit warm-start decision)."""
        parts = self.key(kernel, sig, dtype, backend, "\0", mesh).split("|")
        head, tail = parts[:5], parts[6]
        with self._lock:
            data = self._load()
            out: Dict[str, Dict[str, Any]] = {}
            for k, v in data.items():
                kp = k.split("|")
                if len(kp) == 7 and kp[:5] == head and kp[6] == tail:
                    out[kp[5]] = dict(v)
            return out

    def scan_meshes(self, kernel: str, sig: str, dtype: str,
                    backend: str, workload: str = ""
                    ) -> Dict[str, Dict[str, Any]]:
        """Every entry at this (kernel, shape, dtype, backend, workload),
        keyed by its mesh-signature component — the donor set
        ``nearest_mesh`` warm-start transfer searches when no winner
        exists at the deployment's own topology."""
        parts = self.key(kernel, sig, dtype, backend, workload).split("|")
        head = parts[:6]
        with self._lock:
            data = self._load()
            out: Dict[str, Dict[str, Any]] = {}
            for k, v in data.items():
                kp = k.split("|")
                if len(kp) == 7 and kp[:6] == head:
                    out[kp[6]] = dict(v)
            return out

    def put(self, kernel: str, sig: str, dtype: str, backend: str,
            config: Dict[str, Any], value: float,
            meta: Optional[Dict[str, Any]] = None,
            workload: str = "", mesh: str = "") -> None:
        with self._lock:
            key = self.key(kernel, sig, dtype, backend, workload, mesh)
            entry = {
                "config": dict(config),
                "value": float(value),
                "meta": dict(meta or {}),
                "time": time.time(),
            }
            # save only the modified key: overlaying the whole in-memory
            # view would revert keys another process re-tuned since our
            # load (value-level lost update, not just key-level); _save
            # refreshes the in-memory view to the merged result.
            self._save({key: entry})

    @contextlib.contextmanager
    def _file_lock(self):
        """Exclusive cross-process lock over the read-merge-replace window
        (sidecar ``.lock`` file; the cache file itself is replaced, so it
        cannot carry the lock)."""
        if fcntl is None:  # pragma: no cover - non-POSIX fallback
            yield
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        fd = os.open(f"{self.path}.lock", os.O_CREAT | os.O_RDWR, 0o644)
        locked = False
        try:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX)
                locked = True
            except OSError:
                # No working lock manager (e.g. some NFS mounts): proceed
                # unlocked — the merge still narrows the lost-update
                # window to the read-merge-replace itself.
                pass
            yield
        finally:
            if locked:
                fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def _save(self, delta: Dict[str, Any]) -> None:
        """Write-temp-then-replace, merging concurrent writers' entries.

        ``delta`` holds ONLY the keys this writer modified.  Another
        process may have written the file since our in-memory view was
        loaded; dumping that whole view would silently erase its new keys
        (the classic lost update) or revert keys it re-tuned to our stale
        values.  Under the cross-process file lock the file is re-read and
        only the delta overlaid: our modified keys win, every other key
        keeps whatever the file now holds, older-schema keys migrate
        (v2) or stay dropped (pre-v2), and the in-memory view is
        refreshed to the merged state so subsequent gets observe the
        file's reality.
        """
        with self._file_lock():
            try:
                with open(self.path) as f:
                    disk = json.load(f)
            except (FileNotFoundError, json.JSONDecodeError):
                disk = {}
            merged = self._migrate(disk)
            merged.update(delta)
            self._data = merged
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(merged, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        _bump_generation()

    def __len__(self) -> int:
        with self._lock:
            return len(self._load())


_default: Optional[AutotuneCache] = None
_default_lock = threading.Lock()


def default_cache() -> AutotuneCache:
    global _default
    with _default_lock:
        if _default is None or _default.path != _default_path():
            _default = AutotuneCache()
        return _default


def reset_default_cache() -> None:
    """Forget the process-wide cache object (tests repoint the env var)."""
    global _default
    with _default_lock:
        _default = None
    _bump_generation()

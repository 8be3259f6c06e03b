"""Workload fingerprinting + online retuning for the serve engine.

The paper's scalability guarantee is about *workloads*, not just systems:
a winner tuned offline against one request mix goes stale the moment the
live mix drifts.  This module closes that loop for the continuous
runtime, in three pieces the engine composes per generation:

* ``WorkloadWindow`` — a sliding window of what the engine actually
  observed: admissions (arrival step, prompt length, generation budget,
  how much of each prompt repeats recently-seen prompts), queue depth per
  step, and draft-acceptance outcomes.  Every statistic is counted in
  *decode steps*, never wall-clock, so the whole retuning loop is
  deterministic (same trace ⇒ same fingerprints ⇒ same retune step).
* ``WorkloadFingerprint`` — the window reduced to the signature the
  tuner keys on: arrival rate, prompt/generation length distribution,
  demand depth, prefix-share fraction and the MEASURED draft acceptance
  rate (``nan`` until any draft or probe ran — no data is not 0.0).
  ``fingerprint_sig`` quantizes it into the cache's workload-signature
  key component; ``fingerprint_distance`` is the shift metric.
* ``OnlineRetuner`` — the shift detector + warm-started retune policy:
  when the live fingerprint drifts past ``threshold`` from the signature
  the active config was tuned under, it re-tunes the (frozen) serve knob
  space against surrogate params rebuilt from the *measured* fingerprint
  (``params_for_fingerprint``: the measured acceptance rate replaces the
  stale ``spec_accept`` constant), seeding the tuner with the active
  config and the nearest-signature cached winner instead of starting
  cold, and persists the new winner under the fingerprint's signature.

Counterpart of ``repro.serve.workload``, kept line for line: the same
fingerprints, signature strings (a signature written by either package
parses in the other) and retune decisions.  The one change: the
retuner's cache entries are keyed by ``backend_name(device)`` of the
engine it serves (``cuda-sm90`` on the card, ``model-sm90`` on the CPU),
never by the reference's ``cpu`` key.  Import discipline matches
``repro_torch.serve.space``: numpy-only at import time, with the
autotune cache imported lazily inside the methods that touch it.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.params import Config, ParameterSpace
from repro_torch.core.tuner import Tuner

from .space import CotuneParams, ServeSurrogate, params_for_fingerprint

__all__ = [
    "WorkloadFingerprint",
    "WorkloadWindow",
    "OnlineRetuner",
    "fingerprint_sig",
    "parse_sig",
    "fingerprint_distance",
    "nearest_workload",
    "coerce_config",
]


@dataclass(frozen=True)
class WorkloadFingerprint:
    """The live request window reduced to what the tuner keys on.

    All fields are measured by the engine (``WorkloadWindow``), none are
    assumed: ``accept_rate`` in particular is the real per-token draft
    acceptance (or the 1-token n-gram probe's hit rate when speculation
    is off) — ``nan`` means *no draft data yet*, which consumers must
    treat as "keep the prior", never as an acceptance of zero.
    """

    arrival_rate: float   # admissions per decode step over the window
    prompt_mean: float    # mean prompt length of windowed admissions
    prompt_spread: float  # relative prompt-length spread (std / mean)
    gen_mean: float       # mean requested generation budget
    depth: float          # mean queued+resident demand per step
    share_frac: float     # mean fraction of each prompt covering a
    #                       recently-seen prompt's prefix (sharing's win)
    accept_rate: float    # measured draft acceptance; nan = no data


# signature quantization: one letter per field, alphabetical, so the
# string is canonical; floats at 2 decimals, lengths/depth at integers
_SIG_FIELDS: Tuple[Tuple[str, str, str], ...] = (
    ("a", "arrival_rate", "f"),
    ("d", "depth", "i"),
    ("g", "gen_mean", "i"),
    ("p", "prompt_mean", "i"),
    ("r", "prompt_spread", "f"),
    ("s", "share_frac", "f"),
    ("x", "accept_rate", "f"),
)


def fingerprint_sig(fp: WorkloadFingerprint) -> str:
    """Quantized canonical string form, e.g.
    ``a0.50_d12_g8_p24_r0.35_s0.30_x0.60`` (``x?`` while acceptance has
    no data) — the cache key's workload-signature component."""
    parts = []
    for tag, name, kind in _SIG_FIELDS:
        v = float(getattr(fp, name))
        if math.isnan(v):
            parts.append(f"{tag}?")
        elif kind == "i":
            parts.append(f"{tag}{int(round(v))}")
        else:
            parts.append(f"{tag}{v:.2f}")
    return "_".join(parts)


def parse_sig(sig: str) -> Optional[WorkloadFingerprint]:
    """Inverse of ``fingerprint_sig`` (up to quantization).  ``None`` for
    anything that is not a workload signature — the generic ``"-"``
    component of offline/migrated cache entries included."""
    fields: Dict[str, float] = {}
    try:
        for part in str(sig).split("_"):
            tag, raw = part[:1], part[1:]
            fields[tag] = float("nan") if raw == "?" else float(raw)
    except (ValueError, IndexError):
        return None
    if sorted(fields) != [t for t, _, _ in _SIG_FIELDS]:
        return None
    return WorkloadFingerprint(
        **{name: fields[tag] for tag, name, _ in _SIG_FIELDS})


def _rel(a: float, b: float) -> float:
    """Relative gap in [0, 1]: |a-b| / max(a, b) (0 when both ~0)."""
    m = max(abs(a), abs(b))
    return abs(a - b) / m if m > 1e-12 else 0.0


def fingerprint_distance(a: WorkloadFingerprint,
                         b: WorkloadFingerprint) -> float:
    """Shift metric between two fingerprints: the mean of per-field
    normalized gaps (relative for rates/lengths/depth, absolute for the
    already-relative spread/share/accept fields).  The acceptance field
    is skipped while either side has no data — absence of draft evidence
    must not read as a workload shift."""
    comps = [
        _rel(a.arrival_rate, b.arrival_rate),
        _rel(a.prompt_mean, b.prompt_mean),
        _rel(a.gen_mean, b.gen_mean),
        _rel(a.depth, b.depth),
        abs(a.prompt_spread - b.prompt_spread),
        abs(a.share_frac - b.share_frac),
    ]
    if math.isfinite(a.accept_rate) and math.isfinite(b.accept_rate):
        comps.append(abs(a.accept_rate - b.accept_rate))
    return float(sum(comps) / len(comps))


def nearest_workload(candidates: Dict[str, Dict[str, Any]],
                     fp: WorkloadFingerprint, radius: float
                     ) -> Optional[Tuple[str, Dict[str, Any], float]]:
    """The cached entry whose workload signature lies nearest ``fp``
    within ``radius`` — the transfer lookup that replaces exact-key miss.

    Signature-less entries (the generic ``"-"`` of offline winners and
    migrated pre-signature entries) sit AT the radius: eligible as the
    fallback seed, but any parseable nearer signature beats them.  Ties
    break on sorted signature order, so transfer is deterministic.
    """
    best: Optional[Tuple[float, str]] = None
    for ws in sorted(candidates):
        parsed = parse_sig(ws)
        d = radius if parsed is None else fingerprint_distance(fp, parsed)
        if d <= radius and (best is None or d < best[0]):
            best = (d, ws)
    if best is None:
        return None
    d, ws = best
    return ws, candidates[ws], d


def coerce_config(space: ParameterSpace, config: Config) -> Config:
    """Snap a prior winner onto ``space``: unknown keys drop, missing
    keys default, out-of-domain values land on the nearest valid choice
    (via the unit-cube round trip).  Warm-start seeds come from other
    tuning contexts — a deployed ``prefill_chunk`` of 512 must seed a
    48-token window's space as its largest choice, not explode."""
    out: Config = {}
    for p in space:
        v = config.get(p.name, p.default)
        if p.validate(v):
            out[p.name] = v
            continue
        try:
            out[p.name] = p.from_unit(p.to_unit(v))
        except Exception:
            out[p.name] = p.default
    fixed = getattr(space, "fixed", None)
    if fixed:
        out.update(fixed)
    return out


class WorkloadWindow:
    """Sliding window of the engine's live workload observations.

    ``capacity`` bounds the admission records (and the recent-prompt set
    the share estimate matches against); draft outcomes and queue depths
    keep their own step-bounded windows.  Everything is O(capacity) per
    record — the window rides the serve loop's host side.
    """

    def __init__(self, capacity: int = 16, prefix_cap: int = 64,
                 step_window: int = 64):
        if capacity < 1:
            raise ValueError("window capacity must be >= 1")
        self.capacity = capacity
        self.prefix_cap = prefix_cap
        # (arrival step, prompt_len, gen_budget, share_estimate)
        self._reqs: deque = deque(maxlen=capacity)
        self._prompts: deque = deque(maxlen=capacity)
        self._drafts: deque = deque(maxlen=step_window)  # (proposed, hits)
        self._depths: deque = deque(maxlen=step_window)

    @property
    def n_requests(self) -> int:
        return len(self._reqs)

    def record_request(self, step: int, prompt: Sequence[int],
                       max_new: int) -> None:
        """One admission: length stats plus a config-independent share
        estimate — the longest common prefix against the recent prompts,
        as a fraction of this prompt (capped at ``prefix_cap`` tokens so
        the estimate stays O(capacity * prefix_cap)).  Measured from
        content, not from the sharing machinery, so the fingerprint sees
        a shareable workload even while ``share_prefix`` is off."""
        head = list(prompt[:self.prefix_cap])
        best = 0
        for prev in self._prompts:
            n = 0
            for x, y in zip(prev, head):
                if x != y:
                    break
                n += 1
            if n > best:
                best = n
        denom = max(1, min(len(prompt), self.prefix_cap))
        self._reqs.append((int(step), len(prompt), int(max_new),
                           best / denom))
        self._prompts.append(head)

    def record_draft(self, proposed: int, accepted: int) -> None:
        """One dispatch's draft outcome — real speculative verify counts
        when ``draft_len > 0``, the engine's 1-token n-gram probe when
        speculation is off (both measure per-token acceptance)."""
        if proposed > 0:
            self._drafts.append((int(proposed), int(accepted)))

    def record_depth(self, depth: int) -> None:
        """Queued + resident demand at one loop step."""
        self._depths.append(int(depth))

    def fingerprint(self, step: int) -> Optional[WorkloadFingerprint]:
        """The window reduced at loop step ``step`` (None while empty)."""
        if not self._reqs:
            return None
        steps, plens, gens, shares = zip(*self._reqs)
        span = max(1, int(step) - steps[0] + 1)
        pmean = sum(plens) / len(plens)
        if len(plens) > 1 and pmean > 0:
            var = sum((x - pmean) ** 2 for x in plens) / len(plens)
            spread = math.sqrt(var) / pmean
        else:
            spread = 0.0
        proposed = sum(d for d, _ in self._drafts)
        accepted = sum(h for _, h in self._drafts)
        depth = (sum(self._depths) / len(self._depths)
                 if self._depths else float(len(self._reqs)))
        return WorkloadFingerprint(
            arrival_rate=len(self._reqs) / span,
            prompt_mean=pmean,
            prompt_spread=spread,
            gen_mean=sum(gens) / len(gens),
            depth=depth,
            share_frac=sum(shares) / len(shares),
            accept_rate=(accepted / proposed if proposed > 0
                         else float("nan")),
        )


class OnlineRetuner:
    """Shift detector + warm-started retune policy for the serve loop.

    ``maybe_retune`` is called at the engine's step boundary: every
    ``check_every`` steps it fingerprints the window and, when the
    distance to the signature the active config was tuned under exceeds
    ``threshold`` (and the ``cooldown`` since the last retune elapsed),
    runs a ``budget``-test tune of the frozen serve knob space against
    surrogate params rebuilt from the measured fingerprint — seeded with
    the active config and the nearest-signature cached winner
    (``transfer_radius`` bounds how far transfer reaches).  The winner is
    persisted under the fingerprint's signature and becomes the new
    baseline; the returned event carries everything the engine needs to
    swap knobs and everything tests need to audit the decision.

    Deterministic end to end: step-counted trigger, seeded tuner,
    sorted-signature transfer ties.
    """

    def __init__(self, space: ParameterSpace, base_params: CotuneParams,
                 *, baseline: Any = None, budget: int = 16,
                 threshold: float = 0.25, min_requests: int = 6,
                 cooldown: int = 32, check_every: int = 4,
                 optimizer: str = "rrs", seed: int = 0,
                 batch: Optional[bool] = None,
                 active_config: Optional[Config] = None,
                 sig_dims: Optional[Dict[str, int]] = None,
                 dtype: str = "float32", cache: Any = None,
                 transfer_radius: float = 0.75, mesh: str = "",
                 device: Any = "cuda"):
        if isinstance(baseline, str):
            baseline = parse_sig(baseline)
        self.space = space
        self.base_params = base_params
        self.baseline: Optional[WorkloadFingerprint] = baseline
        self.budget = int(budget)
        self.threshold = float(threshold)
        self.min_requests = int(min_requests)
        self.cooldown = int(cooldown)
        self.check_every = max(1, int(check_every))
        self.optimizer = optimizer
        self.seed = int(seed)
        self.batch = batch
        self.active_config = (coerce_config(space, active_config)
                              if active_config else None)
        self.sig_dims = dict(sig_dims) if sig_dims else None
        self.dtype = dtype
        self.cache = cache
        self.transfer_radius = float(transfer_radius)
        # device-topology signature the engine runs at (autotune.mesh_sig;
        # "" = legacy single-device).  Winners persist AND transfer-scan
        # at this mesh only — a config tuned for a 4-way TP engine must
        # never warm-start a single-device loop as if it were native.
        self.mesh = str(mesh)
        # the engine's device: its cache entries' backend component
        # (read only when sig_dims is set, i.e. when the cache is touched)
        self.device = device
        self.n_retunes = 0
        self.tests_spent = 0
        self.events: List[Dict[str, Any]] = []
        self._next_check = 0
        self._last_retune: Optional[int] = None

    # ------------------------------------------------------------------
    def _candidates(self) -> Dict[str, Dict[str, Any]]:
        """Cached serve winners at this model shape, keyed by workload
        signature (empty without ``sig_dims`` — nothing to key on)."""
        if self.sig_dims is None:
            return {}
        from repro_torch import autotune

        cache = self.cache or autotune.default_cache()
        return cache.scan_workloads(
            autotune.SERVE_SYSTEM,
            autotune.shape_sig({k: int(v)
                                for k, v in self.sig_dims.items()}),
            self.dtype, autotune.backend_name(self.device), mesh=self.mesh)

    def _persist(self, sig: str, config: Config, value: float,
                 n_tests: int, step: int) -> None:
        if self.sig_dims is None:
            return
        from repro_torch import autotune

        autotune.put_serve_config(
            self.sig_dims, self.dtype, config, value,
            cache=self.cache, backend=autotune.backend_name(self.device),
            workload=sig, mesh=self.mesh,
            meta={"source": "online_retune", "step": int(step),
                  "n_tests": int(n_tests)})

    # ------------------------------------------------------------------
    def maybe_retune(self, window: WorkloadWindow,
                     step: int) -> Optional[Dict[str, Any]]:
        """The engine's per-step hook.  Returns the retune event (with
        the winning knobs under ``"config"``) or None."""
        if step < self._next_check:
            return None
        self._next_check = step + self.check_every
        if window.n_requests < self.min_requests:
            return None
        fp = window.fingerprint(step)
        if fp is None:
            return None
        if self.baseline is None:
            # no tuned signature on record: anchor on the first full
            # window instead of treating "unknown" as "shifted"
            self.baseline = fp
            return None
        dist = fingerprint_distance(fp, self.baseline)
        if dist <= self.threshold:
            return None
        if (self._last_retune is not None
                and step - self._last_retune < self.cooldown):
            return None
        return self.retune(fp, step=step, distance=dist)

    def retune(self, fp: WorkloadFingerprint, *, step: int = 0,
               distance: float = float("inf")) -> Dict[str, Any]:
        """Warm-started retune against the measured fingerprint."""
        sig = fingerprint_sig(fp)
        params = params_for_fingerprint(fp, self.base_params)
        seeds: List[Config] = []
        if self.active_config:
            seeds.append(self.active_config)
        warm_source = "cold"
        near = nearest_workload(self._candidates(), fp,
                                self.transfer_radius)
        if near is not None:
            ws, entry, d = near
            seeds.append(coerce_config(self.space, entry["config"]))
            warm_source = ("exact" if ws == sig
                           else f"near({ws}@{d:.2f})")
        report = Tuner(self.space, ServeSurrogate(params),
                       budget=self.budget, optimizer=self.optimizer,
                       seed=self.seed, batch=self.batch,
                       warm_start=seeds or None).run()
        winner = dict(report.best_config)
        self._persist(sig, winner, report.best_metric.value,
                      report.n_tests, step)
        self.baseline = fp
        self.active_config = winner
        self._last_retune = int(step)
        self.n_retunes += 1
        self.tests_spent += report.n_tests
        event = {
            "step": int(step),
            "distance": float(distance),
            "signature": sig,
            "fingerprint": {name: float(getattr(fp, name))
                            for _, name, _ in _SIG_FIELDS},
            "config": winner,
            "value": float(report.best_metric.value),
            "n_tests": int(report.n_tests),
            "warm_source": warm_source,
            # the surrogate constant the retune actually used vs the
            # engine's measurement — the bench's ±0.1 acceptance gate
            "spec_accept": float(params.spec_accept),
            "measured_accept": float(fp.accept_rate),
        }
        self.events.append(event)
        return event

"""Cross-system co-tuning: several SUTs as ONE system under tune.

The ACTS paper's §2.1 observation is that co-deployed systems "can interact
to affect the overall performance, they must be tuned together".  This
module makes that first-class:

* ``CompositeSpace`` joins named per-system ``ParameterSpace``s under
  prefixed keys (``"serve.max_batch"``) while keeping each subspace's own
  unit-matrix conversion — the vectorized batch path delegates each
  member's column block to that member's ``from_unit_matrix``, so frozen
  views, custom ``Parameter`` subclasses and subclassed spaces convert
  exactly as they would standalone.
* ``CompositeSUT`` aggregates member SUTs under ONE shared resource limit:
  a joint test applies one subconfig per member, collects one
  ``PerfMetric`` per member, and scalarizes them into the composite's
  single objective (throughput-under-latency-SLA, a weighted objective, or
  any callable).  It implements the tuner's ``BatchEvaluator`` protocol, so
  a batched optimizer round stays one ``test_batch`` call end to end.
* ``SubspaceRoundRobinOptimizer`` is BestConfig-style divide-and-diverge
  (Zhu et al., 2017) over the composite's subspaces: tune one subspace at a
  time in a shrinking window around the incumbent (divide), restart from a
  fresh joint LHS round when the whole cycle stalls (diverge).  The joint
  space's dimensionality therefore never inflates a single sampling round —
  each round is a low-dimensional LHS — which is what keeps the sample
  budget meaningful as subspaces are added.

Registered as optimizer ``"subspace_rr"``; on a non-composite space it
degrades to per-parameter round-robin (cyclic low-dimensional search).

Own copy of ``repro.core.composite``, line for line, so the same members,
scalarizer and seed give the reference's trial stream.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from .base import BatchObjective, BudgetedRun, BudgetExhausted, \
    Feasible, Objective, TuningResult
from .optimizers import OPTIMIZERS
from .params import Config, Parameter, ParameterSpace
from .sampling import lhs_unit
from .tuner import PerfMetric

__all__ = [
    "CompositeSpace",
    "CompositeSUT",
    "SubspaceRoundRobinOptimizer",
    "weighted_objective",
    "throughput_under_sla",
]


class CompositeSpace(ParameterSpace):
    """Named per-system subspaces joined into one joint knob space.

    Every member knob appears as ``f"{member}{sep}{knob}"``; the unit
    hypercube is the concatenation of the members' hypercubes (member order
    = column order).  Conversion, validation and defaults all delegate to
    the member spaces, so a ``FrozenSpaceView`` member keeps emitting its
    fixed values and a subclassed space keeps its own conversion kernels.
    """

    def __init__(self, subspaces: Mapping[str, ParameterSpace],
                 sep: str = "."):
        if not subspaces:
            raise ValueError("CompositeSpace needs at least one subspace")
        self.sep = sep
        self._subspaces: Dict[str, ParameterSpace] = {}
        self._slices: Dict[str, slice] = {}
        params: List[Parameter] = []
        col = 0
        for name, sub in subspaces.items():
            if not name or sep in name:
                raise ValueError(
                    f"bad subspace name {name!r}: must be non-empty and "
                    f"must not contain the separator {sep!r}")
            self._subspaces[name] = sub
            self._slices[name] = slice(col, col + sub.dim)
            col += sub.dim
            for p in sub:
                q = copy.copy(p)
                object.__setattr__(q, "name", f"{name}{sep}{p.name}")
                params.append(q)
        super().__init__(params)

    # --- structure ---------------------------------------------------------
    @property
    def subspace_names(self) -> List[str]:
        return list(self._subspaces)

    def subspace(self, name: str) -> ParameterSpace:
        return self._subspaces[name]

    def column_groups(self) -> Dict[str, List[int]]:
        """Unit-cube column indices per subspace (member order)."""
        return {name: list(range(s.start, s.stop))
                for name, s in self._slices.items()}

    def split(self, config: Mapping[str, Any]) -> Dict[str, Config]:
        """Joint config -> per-member subconfigs (prefixes stripped)."""
        out: Dict[str, Config] = {name: {} for name in self._subspaces}
        for key, v in config.items():
            name, _, knob = key.partition(self.sep)
            if not knob or name not in self._subspaces:
                raise ValueError(
                    f"config key {key!r} does not belong to any subspace "
                    f"of {self.subspace_names}")
            out[name][knob] = v
        return out

    def join(self, subconfigs: Mapping[str, Mapping[str, Any]]) -> Config:
        """Per-member subconfigs -> one prefixed joint config."""
        cfg: Config = {}
        for name, sub in subconfigs.items():
            if name not in self._subspaces:
                raise ValueError(f"unknown subspace {name!r}")
            for k, v in sub.items():
                cfg[f"{name}{self.sep}{k}"] = v
        return cfg

    # --- conversion (delegated per subspace) -------------------------------
    def default_config(self) -> Config:
        return self.join({name: sub.default_config()
                          for name, sub in self._subspaces.items()})

    def from_unit_matrix(self, units: np.ndarray) -> List[Config]:
        units = np.atleast_2d(np.asarray(units, dtype=float))
        if units.shape[1] != self.dim:
            raise ValueError(
                f"expected shape (m, {self.dim}), got {units.shape}")
        merged: List[Config] = [{} for _ in range(len(units))]
        for name, sub in self._subspaces.items():
            sep = f"{name}{self.sep}"
            for row, sub_cfg in zip(
                    merged, sub.from_unit_matrix(units[:, self._slices[name]])):
                for k, v in sub_cfg.items():
                    row[sep + k] = v
        return merged

    def from_unit_vector(self, u: np.ndarray) -> Config:
        u = np.asarray(u, dtype=float)
        if u.shape != (self.dim,):
            raise ValueError(f"expected shape ({self.dim},), got {u.shape}")
        return self.join({name: sub.from_unit_vector(u[self._slices[name]])
                          for name, sub in self._subspaces.items()})

    def to_unit_vector(self, config: Mapping[str, Any]) -> np.ndarray:
        parts = self.split(config)
        return np.concatenate([
            np.asarray(sub.to_unit_vector(parts[name]), dtype=float)
            for name, sub in self._subspaces.items()
        ]) if self.dim else np.zeros(0)

    def validate(self, config: Mapping[str, Any]) -> None:
        parts = self.split(config)
        for name, sub in self._subspaces.items():
            sub.validate(parts[name])


# ---------------------------------------------------------------------------
# scalarizers: Dict[member, PerfMetric] x Dict[member, Config] -> PerfMetric
# ---------------------------------------------------------------------------
Scalarizer = Callable[[Dict[str, PerfMetric], Dict[str, Config]], PerfMetric]


def weighted_objective(weights: Mapping[str, float]) -> Scalarizer:
    """Weighted sum of member objectives (each in its minimization view).

    Members measure in their own units; the weights are the exchange rate.
    Missing members default to weight 0 (measured but not scored).
    """

    def scalarize(metrics: Dict[str, PerfMetric],
                  configs: Dict[str, Config]) -> PerfMetric:
        parts = {name: float(weights.get(name, 0.0)) * m.objective()
                 for name, m in metrics.items()}
        return PerfMetric(value=float(sum(parts.values())),
                          higher_is_better=False,
                          metrics={"weighted_parts": parts})

    return scalarize


def throughput_under_sla(throughput_member: str, sla_s: float,
                         latency_member: Optional[str] = None,
                         latency_key: str = "latency_s",
                         penalty: float = 2.0) -> Scalarizer:
    """Maximize one member's throughput subject to a latency SLA.

    The SLA is enforced as a smooth penalty — ``tput * (sla/lat)**penalty``
    past the bound — so the optimizer keeps gradient information instead of
    falling off a feasibility cliff.
    """

    def scalarize(metrics: Dict[str, PerfMetric],
                  configs: Dict[str, Config]) -> PerfMetric:
        tput = float(metrics[throughput_member].value)
        src = latency_member or throughput_member
        raw_lat = metrics[src].metrics.get(latency_key)
        if raw_lat is None:
            # A missing measurement must not read as a met SLA — that
            # would silently drop the constraint from the whole search.
            raise ValueError(
                f"member {src!r} recorded no {latency_key!r} metric; "
                f"throughput_under_sla needs the latency measurement")
        lat = float(raw_lat)
        ok = lat <= sla_s
        value = tput if ok or lat <= 0 else tput * (sla_s / lat) ** penalty
        return PerfMetric(value=float(value), higher_is_better=True,
                          metrics={"raw_throughput": tput,
                                   "latency_s": lat, "sla_s": sla_s,
                                   "sla_met": bool(ok)})

    return scalarize


# ---------------------------------------------------------------------------
class CompositeSUT:
    """Member SUTs co-tuned as one system under one resource limit.

    One joint test = one test on every member (their subconfig applied),
    scalarized into a single ``PerfMetric`` — so the tuner's budget counts
    *co-deployment tests*, the machine-time unit of a staging environment
    that restarts every member per trial.  Implements ``BatchEvaluator``:
    a candidate round is split once and dispatched to each member's
    ``test_batch`` in a single call (per-config fallback for test-only
    members), keeping batched rounds O(members) Python calls.

    The scalarizer receives all member metrics AND all member subconfigs —
    cross-system interaction (e.g. a kernel block choice shifting the serve
    engine's optimal batching point) lives there, in the composition model,
    not in the members.

    A member given as a bare ``ParameterSpace`` is a **config-only
    subsystem**: its knobs join the space and reach the scalarizer, but no
    standalone evaluator runs for it — for subsystems whose contribution
    only exists in composition (no meaningful isolated measurement, or one
    the scalarizer would recompute anyway).

    Member feasibility models compose: every member exposing a
    ``feasibility_model`` contributes its predicates under the member's
    prefixed keys (``feasibility`` adds/overrides models per member name —
    the only way to constrain a config-only member, which has no SUT
    object to hang a model on).  The composed model is what the ``Tuner``
    auto-detects, so a joint candidate whose ANY subconfig is statically
    infeasible is pruned before a single member evaluates.
    """

    def __init__(self, members: Mapping[str, Any], scalarize: Scalarizer,
                 name: Optional[str] = None, sep: str = ".",
                 feasibility: Optional[Mapping[str, Any]] = None):
        if not members:
            raise ValueError("CompositeSUT needs at least one member")
        self.members = dict(members)
        self.scalarize = scalarize
        spaces: Dict[str, ParameterSpace] = {}
        self._evaluated: List[str] = []
        for n, m in self.members.items():
            if isinstance(m, ParameterSpace):
                spaces[n] = m  # config-only subsystem
            else:
                spaces[n] = m.space()
                self._evaluated.append(n)
        self._space = CompositeSpace(spaces, sep=sep)
        self.name = name or "+".join(self.members)
        models: Dict[str, Any] = {}
        for n, m in self.members.items():
            model = getattr(m, "feasibility_model", None)
            if model is not None:
                models[n] = model
        for n, model in dict(feasibility or {}).items():
            if n not in self.members:
                raise ValueError(f"feasibility for unknown member {n!r}")
            models[n] = model
        self.feasibility_model = None
        if models:
            from repro_torch.analysis.feasibility import \
                CompositeFeasibility

            self.feasibility_model = CompositeFeasibility(models, sep=sep)
        # dispatch accounting (the quantity the batched engine minimizes)
        self.member_batch_calls = {n: 0 for n in self._evaluated}
        self.member_test_calls = {n: 0 for n in self._evaluated}

    def space(self) -> CompositeSpace:
        return self._space

    def test(self, config: Config) -> PerfMetric:
        return self.test_batch([config])[0]

    def test_batch(self, configs: Sequence[Config]) -> List[PerfMetric]:
        parts = [self._space.split(c) for c in configs]
        per_member: Dict[str, List[PerfMetric]] = {}
        for name in self._evaluated:
            member = self.members[name]
            subs = [p[name] for p in parts]
            batch = getattr(member, "test_batch", None)
            if callable(batch):
                self.member_batch_calls[name] += 1
                metrics = list(batch(subs))
                if len(metrics) != len(subs):
                    raise ValueError(
                        f"member {name!r} returned {len(metrics)} metrics "
                        f"for {len(subs)} configs")
            else:
                self.member_test_calls[name] += len(subs)
                metrics = [member.test(c) for c in subs]
            per_member[name] = metrics
        out: List[PerfMetric] = []
        for i, part in enumerate(parts):
            row = {name: per_member[name][i] for name in self._evaluated}
            metric = self.scalarize(row, part)
            metric.metrics.setdefault(
                "member_values",
                {name: float(row[name].value) for name in self._evaluated})
            out.append(metric)
        return out


# ---------------------------------------------------------------------------
class SubspaceRoundRobinOptimizer:
    """BestConfig-style divide-and-diverge over a composite space.

    DIVIDE: visit subspaces round-robin; each visit is ONE candidate round
    of ``round_size`` LHS samples that vary only that subspace's columns
    inside a window of width ``span`` around the incumbent (every other
    column pinned).  The incumbent moves to the round's best improver.
    DIVERGE: a full cycle with no improvement shrinks the window; when it
    bottoms out below ``min_span``, restart from a fresh joint LHS round
    and re-center on its best sample even if worse — BestConfig's escape
    from local optima.

    Round-synchronous like every optimizer here: candidate generation never
    depends on the dispatch mode, so batched and sequential runs score the
    identical trial sequence.
    """

    def __init__(self, round_size: int = 7, span: float = 1.0,
                 shrink: float = 0.5, min_span: float = 0.05,
                 diverge_size: Optional[int] = None):
        if round_size < 1:
            raise ValueError("round_size must be >= 1")
        if not (0 < shrink < 1):
            raise ValueError("shrink must be in (0, 1)")
        self.round_size = round_size
        self.span0 = span
        self.shrink = shrink
        self.min_span = min_span
        self.diverge_size = diverge_size

    def optimize(
        self,
        space: ParameterSpace,
        objective: Objective,
        budget: int,
        rng: np.random.Generator,
        init_unit_points: Optional[np.ndarray] = None,
        batch_objective: Optional[BatchObjective] = None,
        feasible: Optional[Feasible] = None,
    ) -> TuningResult:
        run = BudgetedRun(space, objective, budget, batch_objective,
                          feasible=feasible)
        dim = space.dim
        if isinstance(space, CompositeSpace):
            groups = [np.asarray(g) for g in space.column_groups().values()]
        else:  # degrade gracefully: one group per parameter
            groups = [np.asarray([j]) for j in range(dim)]
        diverge_n = self.diverge_size or max(2 * dim, 8)
        try:
            if init_unit_points is not None:
                run.evaluate_batch(np.atleast_2d(init_unit_points), "explore")
            if run.best_u is None:
                run.evaluate_batch(lhs_unit(diverge_n, dim, rng), "explore")
            incumbent = np.asarray(run.best_u, dtype=float).copy()
            inc_val = run.best_val
            span = self.span0
            while True:
                improved_cycle = False
                for g in groups:
                    local = lhs_unit(self.round_size, len(g), rng)
                    lo = np.clip(incumbent[g] - span / 2, 0.0,
                                 max(0.0, 1.0 - span))
                    hi = np.minimum(lo + span, 1.0)
                    cands = np.tile(incumbent, (self.round_size, 1))
                    cands[:, g] = lo + local * (hi - lo)
                    vals = run.evaluate_batch(cands, "exploit")
                    j = int(np.argmin(vals))
                    if float(vals[j]) < inc_val:
                        incumbent = cands[j].copy()
                        inc_val = float(vals[j])
                        improved_cycle = True
                if not improved_cycle:
                    span *= self.shrink
                    if span < self.min_span:
                        batch = lhs_unit(diverge_n, dim, rng)
                        vals = run.evaluate_batch(batch, "explore")
                        j = int(np.argmin(vals))
                        incumbent = np.asarray(batch[j], dtype=float).copy()
                        inc_val = float(vals[j])
                        span = self.span0
        except BudgetExhausted:
            pass
        return run.result()


# Self-registration keeps the optimizer registry import-cycle-free
# (tuner -> optimizers; composite -> tuner): importing repro_torch.core (or
# any of its submodules) loads this module and makes "subspace_rr"
# available.
OPTIMIZERS["subspace_rr"] = SubspaceRoundRobinOptimizer

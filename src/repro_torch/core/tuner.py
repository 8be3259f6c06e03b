"""The ACTS flexible architecture (paper §4.2, Figure 2).

Three components, deliberately decoupled so each scalability axis can vary
independently:

* ``SystemManipulator`` — knows how to apply a configuration setting to the
  SUT and (re)start it.  Swapping the manipulator swaps the SUT/deployment
  (SUT + deployment-environment scalability).
* ``WorkloadGenerator`` — knows how to drive the configured SUT and measure a
  ``PerfMetric`` (workload scalability).
* ``Tuner`` — owns the parameter space, the resource limit, the sampler and
  the optimizer; it never touches the SUT directly (parameter-set and
  resource-limit scalability).

The tuner runs every test through a cache keyed on the concrete config, so
duplicate settings (common once enum/int knobs quantize) never burn budget —
the resource limit counts *actual tests on the SUT*, which is what costs
machine-time in the paper's staging environment.
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Protocol, Sequence, \
    Tuple

import numpy as np

from .base import BudgetExhausted, Trial, TuningResult
from .optimizers import get_optimizer
from .params import Config, ParameterSpace
from .sampling import lhs_unit

__all__ = [
    "PerfMetric",
    "SystemManipulator",
    "WorkloadGenerator",
    "BatchEvaluator",
    "TunableSystem",
    "CallableSUT",
    "Tuner",
    "TuningReport",
]


@dataclass
class PerfMetric:
    """A single performance measurement of the SUT under the workload."""

    value: float  # primary metric (e.g. ops/sec or est. step seconds)
    higher_is_better: bool = True
    metrics: Dict[str, Any] = field(default_factory=dict)  # secondary metrics

    def objective(self) -> float:
        """Minimization view of the metric."""
        v = float(self.value)
        if math.isnan(v):
            return math.inf
        return -v if self.higher_is_better else v


class SystemManipulator(Protocol):
    """Controls the SUT in its deployment environment (start/stop/configure)."""

    def apply(self, config: Config) -> Any:
        """Apply a configuration and (re)start the SUT; returns a handle."""
        ...

    def teardown(self, handle: Any) -> None:
        ...


class WorkloadGenerator(Protocol):
    """Drives the configured SUT and measures performance."""

    def run(self, handle: Any) -> PerfMetric:
        ...


class BatchEvaluator(Protocol):
    """A SUT that can score a whole sample set in one call.

    ``test_batch`` must return one ``PerfMetric`` per config, in order, and
    must be *value-equivalent* to calling ``test`` per config — the tuner
    relies on that equivalence for batched-vs-sequential parity.  SUTs whose
    evaluation is vectorizable (analytic surrogates, batched
    models) implement this to collapse each optimizer round into a single
    Python call; the trial cache, budget accounting and ``TuningReport``
    are unaffected.
    """

    def test_batch(self, configs: Sequence[Config]) -> Sequence[PerfMetric]:
        ...


class TunableSystem:
    """Manipulator + workload generator == one testable SUT deployment."""

    def __init__(
        self,
        manipulator: SystemManipulator,
        workload: WorkloadGenerator,
        name: str = "sut",
    ):
        self.manipulator = manipulator
        self.workload = workload
        self.name = name

    def test(self, config: Config) -> PerfMetric:
        handle = self.manipulator.apply(config)
        try:
            return self.workload.run(handle)
        finally:
            self.manipulator.teardown(handle)


class CallableSUT:
    """Adapter: a plain ``config -> PerfMetric`` function as a TunableSystem.

    Pass ``batch_fn`` (configs -> metrics) to make the adapter a
    ``BatchEvaluator``; without it the tuner falls back to per-config calls.
    """

    def __init__(self, fn: Callable[[Config], PerfMetric], name: str = "sut",
                 batch_fn: Optional[
                     Callable[[Sequence[Config]], Sequence[PerfMetric]]
                 ] = None):
        self.fn = fn
        self.name = name
        if batch_fn is not None:
            # instance attribute, so hasattr-based batch detection only
            # fires for adapters that actually provide one
            self.test_batch = batch_fn

    def test(self, config: Config) -> PerfMetric:
        return self.fn(config)


@dataclass
class TuningReport:
    sut_name: str
    best_config: Config
    best_metric: PerfMetric
    default_config: Config
    default_metric: PerfMetric
    n_tests: int
    budget: int
    wall_seconds: float
    history: List[Trial]
    optimizer: str
    sampler: str
    # candidates the static feasibility model rejected before the SUT —
    # uncharged, unrecorded; the budget they would have burned went to
    # feasible candidates instead (0 when no model is attached)
    n_infeasible_pruned: int = 0

    @property
    def improvement(self) -> float:
        """best/default ratio in the *user-facing* direction (≥1 is better)."""
        d, b = self.default_metric, self.best_metric
        if d.value == 0:
            return math.inf
        ratio = b.value / d.value
        return ratio if d.higher_is_better else (1.0 / ratio if ratio else math.inf)

    def best_so_far_values(self) -> List[float]:
        """Best metric value (user-facing direction) after each test."""
        sign = -1.0 if self.default_metric.higher_is_better else 1.0
        return [sign * v for v in TuningResult(
            self.best_config, self.best_metric.objective(), self.history,
            self.n_tests).best_so_far()]

    def to_json(self) -> str:
        return json.dumps(
            {
                "sut": self.sut_name,
                "optimizer": self.optimizer,
                "sampler": self.sampler,
                "budget": self.budget,
                "n_tests": self.n_tests,
                "n_infeasible_pruned": self.n_infeasible_pruned,
                "wall_seconds": self.wall_seconds,
                "default": {
                    "config": _jsonable(self.default_config),
                    "value": self.default_metric.value,
                    "metrics": _jsonable(self.default_metric.metrics),
                },
                "best": {
                    "config": _jsonable(self.best_config),
                    "value": self.best_metric.value,
                    "metrics": _jsonable(self.best_metric.metrics),
                },
                "improvement": self.improvement,
                "history": [
                    {
                        "test": t.test_index,
                        "phase": t.phase,
                        "value": t.value,
                        "config": _jsonable(t.config),
                    }
                    for t in self.history
                ],
            },
            indent=2,
        )


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


class Tuner:
    """The ACTS tuner: resource-limited LHS + RRS over a TunableSystem.

    ``budget`` is the number of allowed tests (§3: the resource limit).  The
    given/default configuration is always tested first — the ACTS contract is
    to return a setting *at least as good as* the given one, so the default's
    measurement both anchors the improvement ratio and participates in the
    search history.

    ``batch`` selects the evaluation engine: ``None`` (default) batches
    whenever the SUT implements the ``BatchEvaluator`` protocol, ``True``
    forces batching (falling back to an internal loop for test-only SUTs)
    and ``False`` forces one ``sut.test`` call per trial.  Both engines run
    the identical trial sequence — same seed + budget gives the same best
    config and test count — because the optimizers generate candidates
    round-by-round independent of how rounds are scored.

    ``feasibility`` attaches a static feasibility model (a ``Config ->
    bool`` callable; see ``repro_torch.analysis.feasibility``): candidates it
    rejects are pruned inside the optimizer's ``BudgetedRun`` without
    charging budget or touching the SUT, and the count surfaces as
    ``TuningReport.n_infeasible_pruned``.  ``None`` (default) auto-detects
    the SUT's ``feasibility_model`` attribute; ``False`` disables pruning
    outright.  The default configuration is still tested unconditionally —
    the ACTS contract anchors on the given config, feasible or not.

    ``warm_start`` seeds the run with prior winners (transfer from a
    related tuning context — another workload signature, an earlier
    deployment): each seed is tested right after the default, before any
    sampling, and joins the history as an ordinary ``"warm"`` trial — so
    the "best tested config" contract returns a seed that still holds up
    even when the budget leaves no room for search, and the optimizer's
    budget share shrinks by exactly the seeds' test cost.  Seeds must
    validate in ``space`` (snap out-of-space transfers first); statically infeasible seeds
    are skipped uncharged.
    """

    def __init__(
        self,
        space: ParameterSpace,
        sut,
        budget: int,
        optimizer: str = "rrs",
        sampler: str = "lhs",
        init_fraction: float = 0.3,
        seed: int = 0,
        optimizer_kwargs: Optional[Dict[str, Any]] = None,
        verbose: bool = False,
        batch: Optional[bool] = None,
        feasibility: Any = None,
        warm_start: Optional[Sequence[Config]] = None,
    ):
        if budget < 1:
            raise ValueError("budget (resource limit) must be >= 1")
        self.space = space
        self.sut = sut
        self.budget = budget
        if feasibility is None:
            feasibility = getattr(sut, "feasibility_model", None)
        elif feasibility is False:
            feasibility = None
        if feasibility is not None and not callable(feasibility):
            raise TypeError("feasibility must be callable (Config -> "
                            f"bool), False, or None; got {feasibility!r}")
        self.feasibility = feasibility
        self.optimizer_name = optimizer
        self.sampler_name = sampler
        self.init_fraction = init_fraction
        self.seed = seed
        self.optimizer_kwargs = dict(optimizer_kwargs or {})
        self.verbose = verbose
        self.warm_start = [dict(c) for c in (warm_start or [])]
        if batch is None:
            batch = callable(getattr(sut, "test_batch", None))
        self.batch = bool(batch)

        self._cache: Dict[Tuple, PerfMetric] = {}
        self._n_tests = 0
        self._higher_is_better: Optional[bool] = None
        # SUT invocations: one per test() call plus one per test_batch()
        # call — the quantity the batched engine minimizes.
        self.n_evaluator_calls = 0

    # ------------------------------------------------------------------
    def _run_sut(self, configs: List[Config]) -> List[PerfMetric]:
        """Uncached, unbudgeted SUT evaluation of distinct configs."""
        if self.batch and callable(getattr(self.sut, "test_batch", None)):
            self.n_evaluator_calls += 1
            metrics = list(self.sut.test_batch(configs))
            if len(metrics) != len(configs):
                raise ValueError(
                    f"{getattr(self.sut, 'name', 'sut')}.test_batch returned "
                    f"{len(metrics)} metrics for {len(configs)} configs")
            return metrics
        out = []
        for cfg in configs:
            self.n_evaluator_calls += 1
            out.append(self.sut.test(cfg))
        return out

    def _record(self, keys: List[Tuple], metrics: List[PerfMetric]) -> None:
        for key, metric in zip(keys, metrics):
            self._n_tests += 1
            self._cache[key] = metric
            if self._higher_is_better is None:
                self._higher_is_better = metric.higher_is_better
            if self.verbose:
                print(
                    f"[tuner] test {self._n_tests}/{self.budget}: "
                    f"value={metric.value:.6g} config={dict(key)}"
                )

    def _test(self, config: Config) -> PerfMetric:
        """Budgeted, cached test of one configuration on the real SUT."""
        key = self.space.config_key(config)
        if key in self._cache:
            return self._cache[key]
        if self._n_tests >= self.budget:
            raise BudgetExhausted
        self._record([key], self._run_sut([config]))
        return self._cache[key]

    def _test_many(self, configs: Sequence[Config]) -> List[PerfMetric]:
        """Budgeted, cached test of a candidate round.

        Returns metrics for the longest *prefix* of ``configs`` the resource
        limit allows (cache hits are free; only distinct new configs count).
        A short return signals budget exhaustion to the optimizer, matching
        what a per-config loop would have evaluated before stopping.
        """
        plan: List[Tuple] = []  # key per prefix config, in order
        miss_keys: List[Tuple] = []
        miss_cfgs: List[Config] = []
        pending = set()
        for cfg in configs:
            key = self.space.config_key(cfg)
            if key not in self._cache and key not in pending:
                if self._n_tests + len(miss_cfgs) >= self.budget:
                    break  # this config would exceed the resource limit
                pending.add(key)
                miss_keys.append(key)
                miss_cfgs.append(cfg)  # SUTs must not mutate configs
            plan.append(key)
        if miss_cfgs:
            self._record(miss_keys, self._run_sut(miss_cfgs))
        return [self._cache[k] for k in plan]

    def run(self) -> TuningReport:
        t0 = time.time()
        rng = np.random.default_rng(self.seed)
        history: List[Trial] = []

        # 1. Measure the given (default) configuration first.
        default_cfg = self.space.default_config()
        default_metric = self._test(default_cfg)
        history.append(
            Trial(default_cfg, default_metric.objective(), self._n_tests, "default",
                  metrics=dict(default_metric.metrics))
        )

        # 1b. Warm-start round: transfer seeds are tested before any
        # sampling and join the history like ordinary trials.  Duplicate
        # seeds (and seeds equal to the default) are cache hits — free;
        # statically infeasible seeds are skipped uncharged; a short
        # _test_many prefix means the budget ran out mid-round.  The rng
        # is untouched, so seeding never perturbs the sampled sequence
        # beyond the budget it consumes.
        if self.warm_start:
            seeds = []
            for cfg in self.warm_start:
                self.space.validate(cfg)
                if self.feasibility is None or self.feasibility(cfg):
                    seeds.append(cfg)
            for cfg, metric in zip(seeds, self._test_many(seeds)):
                history.append(
                    Trial(cfg, metric.objective(), self._n_tests, "warm",
                          metrics=dict(metric.metrics)))

        # 2. Initial LHS round (§4.3): coverage at any budget.
        n_init = min(
            max(0, self.budget - self._n_tests),
            max(1, int(self.budget * self.init_fraction)),
        )
        init_points = lhs_unit(n_init, self.space.dim, rng) if n_init else None

        # 3. Optimizer consumes the remaining budget (RRS by default).
        def objective(cfg: Config) -> float:
            return self._test(cfg).objective()

        def batch_objective(cfgs: Sequence[Config]) -> List[float]:
            return [m.objective() for m in self._test_many(cfgs)]

        opt = get_optimizer(self.optimizer_name, **self.optimizer_kwargs)
        remaining = self.budget - self._n_tests
        n_pruned = 0
        if remaining > 0:
            # The optimizer gets head-room over the real limit because cached
            # (duplicate) configs don't consume SUT tests; the tuner's own
            # short-prefix/BudgetExhausted signal is what stops the run.
            result = opt.optimize(
                self.space,
                objective,
                budget=remaining * 4,
                rng=rng,
                init_unit_points=init_points,
                batch_objective=batch_objective,
                feasible=self.feasibility,
            )
            n_pruned = result.n_infeasible_pruned
            # Re-index trials to global test counters (optimizer counts its own).
            offset = len(history)
            for t in result.history:
                history.append(
                    Trial(t.config, t.value, offset + t.test_index, t.phase)
                )

        # 4. Pick the best *tested* configuration (ACTS contract: >= default).
        best_trial = min(history, key=lambda t: t.value)
        best_cfg = best_trial.config
        best_metric = self._cache[self.space.config_key(best_cfg)]

        return TuningReport(
            sut_name=getattr(self.sut, "name", "sut"),
            best_config=best_cfg,
            best_metric=best_metric,
            default_config=default_cfg,
            default_metric=default_metric,
            n_tests=self._n_tests,
            budget=self.budget,
            wall_seconds=time.time() - t0,
            history=history,
            optimizer=self.optimizer_name,
            sampler=self.sampler_name,
            n_infeasible_pruned=n_pruned,
        )

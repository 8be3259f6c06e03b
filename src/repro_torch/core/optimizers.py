"""Search-based optimizers for ACTS, plus the registry.

RRS (``repro_torch.core.rrs``) is the algorithm the paper adopts.  The baselines
here are the methods the paper positions against:

* ``random``      — pure random sampling (the no-structure floor),
* ``lhs_only``    — a single LHS design, take the best (sampling w/o search),
* ``shc``         — Smart Hill-Climbing (Xi et al., WWW'04 [44]): LHS init,
                    then weighted-Gaussian sampling around the incumbent with
                    shrinking variance; restarts on stagnation,
* ``coordinate``  — cyclic one-knob-at-a-time line search (the "tuning guide"
                    strategy humans follow, §5.3).

``subspace_rr`` (BestConfig-style divide-and-diverge over a composite
space's subspaces) lives in ``repro_torch.core.composite`` and registers
itself into ``OPTIMIZERS`` on import — keeping the registry here
import-cycle-free.

All optimizers minimize, operate on the unit hypercube, and respect a strict
test budget — the resource limit of the ACTS problem definition (§3).

Every optimizer is *round-based*: candidates are generated a whole round at
a time and scored through ``_BudgetedRun.evaluate_batch``, which dispatches
to a vectorized ``batch_objective`` when one is provided (the tuner's
``BatchEvaluator`` path) and falls back to a per-config loop otherwise.
Candidate generation never depends on the dispatch mode, so batched and
sequential runs of the same seed evaluate the *identical* trial sequence —
the parity guarantee the batched-tuning tests pin down.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .base import BatchObjective, BudgetedRun, BudgetExhausted, \
    Feasible, Objective, TuningResult
from .params import ParameterSpace
from .rrs import RRSOptimizer
from .sampling import lhs_unit

_BudgetedRun = BudgetedRun  # shared bookkeeping lives in base.py

__all__ = [
    "RandomSearchOptimizer",
    "LHSOnlyOptimizer",
    "SmartHillClimbingOptimizer",
    "CoordinateSearchOptimizer",
    "get_optimizer",
    "OPTIMIZERS",
]


class RandomSearchOptimizer:
    """Uniform random sampling in rounds of ``round_size``."""

    def __init__(self, round_size: int = 64):
        self.round_size = max(1, round_size)

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
        run = _BudgetedRun(space, objective, budget, batch_objective,
                           feasible=feasible)
        try:
            if init_unit_points is not None:
                run.evaluate_batch(np.atleast_2d(init_unit_points), "explore")
            while True:
                n = min(self.round_size, max(run.remaining, 1))
                run.evaluate_batch(rng.random((n, space.dim)), "explore")
        except BudgetExhausted:
            pass
        return run.result()


class LHSOnlyOptimizer:
    """One Latin hypercube of size == budget; best sample wins."""

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
        run = _BudgetedRun(space, objective, budget, batch_objective,
                           feasible=feasible)
        try:
            if init_unit_points is not None:
                run.evaluate_batch(np.atleast_2d(init_unit_points), "explore")
            remaining = run.remaining
            if remaining > 0:
                run.evaluate_batch(lhs_unit(remaining, space.dim, rng),
                                   "explore")
        except BudgetExhausted:
            pass
        return run.result()


class SmartHillClimbingOptimizer:
    """Smart Hill-Climbing (Xi et al. 2004), simplified:

    LHS initial design (one batched round) → Gaussian proposals around the
    incumbent with per-round variance shrink; random restart after
    ``patience`` stale rounds.  The climb itself is inherently sequential
    (every proposal conditions on the previous outcome), so proposals run
    as rounds of one.
    """

    def __init__(self, init_frac: float = 0.25, shrink: float = 0.7,
                 patience: int = 5, sigma0: float = 0.25):
        self.init_frac = init_frac
        self.shrink = shrink
        self.patience = patience
        self.sigma0 = sigma0

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
        run = _BudgetedRun(space, objective, budget, batch_objective,
                           feasible=feasible)
        dim = space.dim
        try:
            if init_unit_points is not None:
                run.evaluate_batch(np.atleast_2d(init_unit_points), "explore")
            n_init = max(2, int(budget * self.init_frac) - run.n_tests)
            run.evaluate_batch(lhs_unit(n_init, dim, rng), "explore")
            sigma, stale = self.sigma0, 0
            incumbent = run.best_u if run.best_u is not None else rng.random(dim)
            incumbent_val = run.best_val
            while True:
                cand = np.clip(incumbent + rng.normal(0, sigma, dim), 0, 1 - 1e-12)
                val = run.evaluate(cand, "exploit")
                if val < incumbent_val:
                    incumbent, incumbent_val = cand, val
                    stale = 0
                else:
                    stale += 1
                    if stale % 2 == 0:
                        sigma = max(sigma * self.shrink, 1e-3)
                    if stale >= self.patience:
                        incumbent = rng.random(dim)  # restart
                        incumbent_val = run.evaluate(incumbent, "explore")
                        sigma, stale = self.sigma0, 0
        except BudgetExhausted:
            pass
        return run.result()


class CoordinateSearchOptimizer:
    """Cyclic coordinate line search — the manual-tuning-guide strategy.

    Each axis sweep is one candidate round: all probe points along the axis
    are generated from the current incumbent and scored together, then the
    incumbent moves to the best improving probe.
    """

    def __init__(self, points_per_axis: int = 5, shrink: float = 0.5):
        self.points_per_axis = points_per_axis
        self.shrink = shrink

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
        run = _BudgetedRun(space, objective, budget, batch_objective,
                           feasible=feasible)
        dim = space.dim
        try:
            if init_unit_points is not None:
                run.evaluate_batch(np.atleast_2d(init_unit_points), "explore")
            x = space.to_unit_vector(space.default_config())
            fx = run.evaluate(x, "explore")
            span = 1.0
            while True:
                improved_any = False
                for j in range(dim):
                    lo = max(0.0, x[j] - span / 2)
                    hi = min(1.0, x[j] + span / 2)
                    cands = []
                    for t in np.linspace(lo, hi, self.points_per_axis):
                        cand = x.copy()
                        cand[j] = min(t, 1 - 1e-12)
                        if abs(cand[j] - x[j]) < 1e-12:
                            continue
                        cands.append(cand)
                    if not cands:
                        continue
                    vals = run.evaluate_batch(np.stack(cands), "exploit")
                    best_i = int(np.argmin(vals))
                    if vals[best_i] < fx:
                        x, fx = cands[best_i], float(vals[best_i])
                        improved_any = True
                if not improved_any:
                    span *= self.shrink
                    if span < 1e-3:
                        x = rng.random(dim)
                        fx = run.evaluate(x, "explore")
                        span = 1.0
        except BudgetExhausted:
            pass
        return run.result()


OPTIMIZERS: Dict[str, type] = {
    "rrs": RRSOptimizer,
    "random": RandomSearchOptimizer,
    "lhs_only": LHSOnlyOptimizer,
    "shc": SmartHillClimbingOptimizer,
    "coordinate": CoordinateSearchOptimizer,
}


def get_optimizer(name: str, **kwargs):
    try:
        cls = OPTIMIZERS[name]
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(OPTIMIZERS)}")
    return cls(**kwargs)

"""Shared types for ACTS optimizers and the tuner."""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .params import Config

__all__ = ["Trial", "TuningResult", "Objective", "BatchObjective",
           "Feasible", "BudgetedRun", "BudgetExhausted"]


class BudgetExhausted(Exception):
    """Raised by a budgeted objective when the resource limit is used up."""


@dataclass
class Trial:
    config: Config
    value: float  # minimized objective value
    test_index: int  # which test (1-based) produced this sample
    phase: str = ""  # e.g. "default", "explore", "exploit"
    metrics: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TuningResult:
    best_config: Config
    best_value: float
    history: List[Trial]
    n_tests: int
    # candidates rejected by the static feasibility model before reaching
    # the SUT — never charged against the budget, never in the history
    n_infeasible_pruned: int = 0

    @property
    def best_trial(self) -> Optional[Trial]:
        best = None
        for t in self.history:
            if best is None or t.value < best.value:
                best = t
        return best

    def best_so_far(self) -> List[float]:
        """Monotone best-value trace, one entry per test (for convergence plots)."""
        out: List[float] = []
        cur = float("inf")
        for t in sorted(self.history, key=lambda t: t.test_index):
            cur = min(cur, t.value)
            out.append(cur)
        return out


Objective = Callable[[Config], float]

# A static feasibility test: True = worth spending a test on.  Infeasible
# candidates are pruned before the objective runs and charge NO budget
# (``repro_torch.analysis.feasibility`` builds these from declarative models).
Feasible = Callable[[Config], bool]

# A batch objective scores a whole candidate round in one call.  It may
# return values for a strict *prefix* of the requested configs: a short
# return means the resource limit was exhausted after that prefix, and the
# caller must record the prefix and stop.
BatchObjective = Callable[[Sequence[Config]], Sequence[float]]


class BudgetedRun:
    """Shared optimizer bookkeeping: budget enforcement + history + best.

    ``evaluate_batch`` scores one candidate round.  The round is truncated
    to the remaining budget; if the objective itself runs out of resource
    (a short prefix return from a ``BatchObjective``), the prefix is
    recorded before ``BudgetExhausted`` propagates — exactly what a
    point-by-point loop would have left behind.  Candidate rounds are
    scored through ``batch_objective`` when one is provided (the tuner's
    vectorized ``BatchEvaluator`` path) and per-config otherwise; the two
    modes evaluate the identical trial sequence.

    When a ``feasible`` model is given, statically-infeasible candidates
    are pruned BEFORE the objective runs: they charge no budget, record no
    trial, and return ``math.inf`` in their round slot (positionally — the
    value the cost model would have reported, so round argmins and
    incumbent updates are unchanged).  Candidate *generation* is untouched
    and the mask is a deterministic function of the candidates, so the
    same seed still yields the same trial stream; the budget a pruned
    candidate would have burned flows to the round's (and later rounds')
    feasible candidates instead.
    """

    # A space whose feasible region the model rejects entirely would let a
    # round-based optimizer generate forever without ever consuming
    # budget.  After this many consecutive pruned candidates with no
    # intervening test, the run is declared exhausted (deterministic — a
    # pure count, no wall clock).
    MAX_CONSECUTIVE_PRUNED = 100_000

    def __init__(self, space, objective: Optional[Objective], budget: int,
                 batch_objective: Optional[BatchObjective] = None,
                 feasible: Optional[Feasible] = None):
        self.space = space
        self.objective = objective
        self.batch_objective = batch_objective
        self.feasible = feasible
        self.budget = budget
        self.history: List[Trial] = []
        self.n_tests = 0
        self.n_infeasible_pruned = 0
        self._pruned_since_test = 0
        self.best_u = None
        self.best_val = math.inf

    @property
    def remaining(self) -> int:
        return self.budget - self.n_tests

    def evaluate_batch(self, units, phase: str):
        units = np.atleast_2d(np.asarray(units, dtype=float))
        if self.remaining <= 0:
            raise BudgetExhausted
        cfgs = self.space.from_unit_matrix(units)
        # Walk the round in candidate order, exactly like a sequential
        # loop would: infeasible candidates are pruned for free, feasible
        # ones are charged until the resource limit cuts the round.
        eval_idx: List[int] = []
        n_pruned = 0
        truncated = False
        for i, cfg in enumerate(cfgs):
            if self.feasible is not None and not self.feasible(cfg):
                n_pruned += 1
                continue
            if len(eval_idx) >= self.remaining:
                truncated = True  # rows past this point never run
                break
            eval_idx.append(i)
        self.n_infeasible_pruned += n_pruned
        if eval_idx:
            self._pruned_since_test = 0
        else:
            self._pruned_since_test += n_pruned
            if self._pruned_since_test > self.MAX_CONSECUTIVE_PRUNED:
                raise BudgetExhausted  # feasible region is (near-)empty
        sub = [cfgs[i] for i in eval_idx]
        if self.batch_objective is not None:
            vals = [float(v) for v in self.batch_objective(sub)]
        else:
            vals = []
            try:
                for cfg in sub:
                    vals.append(float(self.objective(cfg)))
            except BudgetExhausted:
                pass  # record the prefix below, then re-raise
        # Pruned slots report inf — the value the roofline cost model
        # assigns an infeasible config — so optimizers that argmin a round
        # behave as if it had been scored, minus the budget charge.
        out = np.full(len(cfgs), math.inf)
        for i, val in zip(eval_idx, vals):
            self.n_tests += 1
            self.history.append(Trial(cfgs[i], val, self.n_tests, phase))
            if val < self.best_val:
                self.best_val, self.best_u = val, units[i].copy()
            out[i] = val
        if truncated or len(vals) < len(eval_idx):
            raise BudgetExhausted
        return out

    def evaluate(self, u, phase: str) -> float:
        return float(
            self.evaluate_batch(np.asarray(u, float)[None], phase)[0])

    def result(self) -> TuningResult:
        if self.best_u is None:
            return TuningResult(
                self.space.default_config(), math.inf, self.history,
                self.n_tests, self.n_infeasible_pruned)
        return TuningResult(
            self.space.from_unit_vector(self.best_u),
            self.best_val,
            self.history,
            self.n_tests,
            self.n_infeasible_pruned,
        )

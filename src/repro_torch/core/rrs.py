"""Recursive Random Search (Ye & Kalyanaraman, SIGMETRICS 2003 [46]).

The optimization algorithm adopted by the ACTS paper (§4.3) because it meets
the three scalability conditions:

  (1) it returns an answer at *any* sample budget (pure sampling, no gradient
      or model fit),
  (2) a larger budget strictly widens/deepens the search (more exploration
      batches, finer exploitation), and
  (3) the re-exploration stage prevents permanent capture by local optima.

Structure (round-synchronous variant):

  EXPLORE   Draw ``n = ln(1-p)/ln(1-r)`` samples; with confidence ``p`` the
            best of them lies in the top ``r``-fraction of the space.  The
            running ``r``-quantile of all exploration values is the promise
            threshold ``y_r``.  Any sample beating ``y_r`` seeds exploitation.
  EXPLOIT   Recursive local search in an axis-aligned box of measure ``rho``
            (initially ``r``) centred on the promising point: ``l =
            ln(1-q)/ln(1-v)`` samples per round; the whole round is scored
            at once and the box re-centres on the round's best improver;
            no improvement in a round ⇒ shrink the box by ``c``; stop when
            the box measure falls below ``st`` and resume exploration.

Every round — exploration batch, warm-start batch and exploitation round —
is evaluated as ONE call through ``_BudgetedRun.evaluate_batch``, so a SUT
exposing the tuner's ``BatchEvaluator`` protocol scores each round in a
single vectorized call instead of ``n`` Python round-trips.  (The original
formulation evaluates exploitation candidates one at a time and re-centres
on the *first* improver; scoring the full round and taking its best is the
standard batch-parallel adaptation, and is what makes the evaluation
pipeline vectorizable end to end.)  Candidate generation is independent of
the dispatch mode, so batched and sequential runs are trial-for-trial
identical.

ACTS couples RRS with LHS (§4.3 "LHS + RRS"): the exploration batches here
are drawn with LHS rather than i.i.d. uniform, inheriting LHS's stratified
coverage; set ``explore_sampler="random"`` for the original formulation.

Everything operates on the unit hypercube via ``ParameterSpace``; boolean and
enum knobs quantize on the way out, so mixed spaces (§4.1) work unchanged.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from .base import BatchObjective, BudgetExhausted, Feasible, \
    Objective, TuningResult
from .base import BudgetedRun as _BudgetedRun
from .params import ParameterSpace
from .sampling import get_sampler

__all__ = ["RRSOptimizer"]


class RRSOptimizer:
    def __init__(
        self,
        p: float = 0.99,
        r: float = 0.1,
        q: float = 0.99,
        v: float = 0.5,
        c: float = 0.5,
        st: float = 1e-3,
        explore_sampler: str = "lhs",
    ):
        # v=0.5 (l = ln(1-q)/ln(1-v) = 7 samples per exploitation round) is
        # the round-synchronous default: wider rounds both amortize the
        # per-round dispatch of the batched evaluation engine and drill the
        # promising box with confidence q per round.  The original paper's
        # sequential formulation used v=0.8 (l = 3); pass it explicitly to
        # reproduce that behaviour.
        if not (0 < r < 1 and 0 < p < 1 and 0 < q < 1 and 0 < v < 1):
            raise ValueError("p, r, q, v must be in (0, 1)")
        if not (0 < c < 1):
            raise ValueError("shrink factor c must be in (0, 1)")
        self.p, self.r, self.q, self.v, self.c, self.st = p, r, q, v, c, st
        self.explore_sampler = explore_sampler
        # Sample counts per the confidence arguments in the original paper.
        self.n_explore = max(1, math.ceil(math.log(1 - p) / math.log(1 - r)))
        self.n_exploit = max(1, math.ceil(math.log(1 - q) / math.log(1 - v)))

    # ------------------------------------------------------------------
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
        """Minimize ``objective`` over ``space`` within ``budget`` tests."""
        dim = space.dim
        sampler = get_sampler(self.explore_sampler)
        run = _BudgetedRun(space, objective, budget, batch_objective,
                           feasible=feasible)
        explore_values: List[float] = []

        def threshold() -> float:
            """Running r-quantile of exploration values (promise threshold)."""
            if not explore_values:
                return math.inf
            return float(np.quantile(np.array(explore_values), self.r))

        try:
            # Optional warm start (e.g. the tuner's initial LHS round).
            if init_unit_points is not None:
                vals = run.evaluate_batch(np.atleast_2d(init_unit_points),
                                          "explore")
                explore_values.extend(float(v) for v in vals)

            while True:
                # ---------------- exploration ----------------
                # Snapshot the promise threshold BEFORE this batch extends
                # the exploration evidence (§4.3 running-quantile): a batch
                # minimum may only seed exploitation if it beats the
                # r-quantile of *prior* exploration values.  Testing against
                # a batch-inclusive quantile lets a batch min self-qualify
                # even when it beats no earlier evidence.
                y_r = threshold()
                batch = sampler(self.n_explore, dim, rng)
                vals = run.evaluate_batch(batch, "explore")
                explore_values.extend(float(v) for v in vals)
                i_best = int(np.argmin(vals))
                promising = np.asarray(batch[i_best], dtype=float)
                promising_val = float(vals[i_best])
                # Only exploit points that beat the running r-quantile
                # threshold (the "promising" test of the original paper).
                if promising_val > y_r:
                    continue

                # ---------------- exploitation ----------------
                center, center_val = promising, promising_val
                rho = self.r  # box measure as a fraction of the space
                while rho >= self.st:
                    cands = self._sample_box_round(center, rho, dim, rng,
                                                   self.n_exploit)
                    cvals = run.evaluate_batch(cands, "exploit")
                    j = int(np.argmin(cvals))
                    if float(cvals[j]) < center_val:
                        center, center_val = cands[j], float(cvals[j])
                    else:
                        rho *= self.c  # shrink and keep drilling
        except BudgetExhausted:
            pass

        return run.result()

    # ------------------------------------------------------------------
    @staticmethod
    def _sample_box(
        center: np.ndarray, rho: float, dim: int, rng: np.random.Generator
    ) -> np.ndarray:
        """Uniform sample from a box of measure ``rho`` centred at ``center``,
        clipped to the unit cube (the box slides inward at the boundary so its
        measure is preserved)."""
        side = rho ** (1.0 / dim)
        lo = np.clip(center - side / 2, 0.0, 1.0 - side)
        lo = np.maximum(lo, 0.0)
        hi = np.minimum(lo + side, 1.0)
        return lo + rng.random(dim) * (hi - lo)

    @staticmethod
    def _sample_box_round(
        center: np.ndarray, rho: float, dim: int,
        rng: np.random.Generator, n: int
    ) -> np.ndarray:
        """One exploitation round of ``n`` box samples in a single draw.

        ``rng.random((n, dim))`` consumes the bit stream exactly like ``n``
        sequential ``_sample_box`` calls, so round-based runs reproduce the
        point-by-point candidate sequence."""
        side = rho ** (1.0 / dim)
        lo = np.clip(center - side / 2, 0.0, 1.0 - side)
        lo = np.maximum(lo, 0.0)
        hi = np.minimum(lo + side, 1.0)
        return lo + rng.random((n, dim)) * (hi - lo)

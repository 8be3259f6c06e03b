"""Scalable sampling for ACTS (§4.1 condition set, §4.3).

The paper requires a sampling method whose sample sets
  (1) widely cover the high-dimensional knob space,
  (2) fit the resource limit (|set| == m exactly), and
  (3) widen their coverage monotonically as m grows.

LHS (McKay, Beckman & Conover 2000 [36]) satisfies all three: each of the m
strata of every dimension is used exactly once, so marginal coverage is
uniform at any m and refines as m grows.  We implement plain LHS plus a
maximin variant (best-of-k candidate sets by minimum pairwise distance), and
uniform random sampling as the baseline architecture the paper compares
against.  Coverage metrics used by ``benchmarks/lhs_coverage.py`` live here
too.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .params import Config, ParameterSpace

__all__ = [
    "lhs_unit",
    "lhs",
    "maximin_lhs",
    "random_unit",
    "random_sampling",
    "min_pairwise_distance",
    "centered_l2_discrepancy",
    "stratification_counts",
    "get_sampler",
]


# --------------------------------------------------------------------------
# samplers (unit hypercube)
# --------------------------------------------------------------------------
def lhs_unit(m: int, dim: int, rng: np.random.Generator) -> np.ndarray:
    """Latin hypercube: (m, dim) points, one per stratum per dimension."""
    if m <= 0:
        return np.zeros((0, dim))
    # For each dim: a random permutation of the m strata, jittered in-stratum.
    strata = np.argsort(rng.random((dim, m)), axis=1).T  # (m, dim), each col a perm
    jitter = rng.random((m, dim))
    return (strata + jitter) / m


def random_unit(m: int, dim: int, rng: np.random.Generator) -> np.ndarray:
    return rng.random((max(m, 0), dim))


def maximin_lhs(
    m: int, dim: int, rng: np.random.Generator, candidates: int = 16
) -> np.ndarray:
    """Best-of-k LHS by maximin distance — still a valid Latin hypercube."""
    best, best_d = None, -1.0
    for _ in range(max(candidates, 1)):
        pts = lhs_unit(m, dim, rng)
        d = min_pairwise_distance(pts)
        if d > best_d:
            best, best_d = pts, d
    return best


def lhs(space: ParameterSpace, m: int, rng: np.random.Generator) -> List[Config]:
    return [space.from_unit_vector(u) for u in lhs_unit(m, space.dim, rng)]


def random_sampling(
    space: ParameterSpace, m: int, rng: np.random.Generator
) -> List[Config]:
    return [space.from_unit_vector(u) for u in random_unit(m, space.dim, rng)]


_SAMPLERS = {
    "lhs": lhs_unit,
    "maximin_lhs": maximin_lhs,
    "random": random_unit,
}


def get_sampler(name: str):
    try:
        return _SAMPLERS[name]
    except KeyError:
        raise ValueError(f"unknown sampler {name!r}; have {sorted(_SAMPLERS)}")


# --------------------------------------------------------------------------
# coverage metrics
# --------------------------------------------------------------------------
def min_pairwise_distance(pts: np.ndarray) -> float:
    """Maximin coverage criterion (larger = better spread)."""
    n = len(pts)
    if n < 2:
        return float("inf")
    d2 = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    d2[np.diag_indices(n)] = np.inf
    return float(np.sqrt(d2.min()))

def centered_l2_discrepancy(pts: np.ndarray) -> float:
    """Centered L2 discrepancy (Hickernell); smaller = more uniform."""
    n, d = pts.shape
    if n == 0:
        return float("nan")
    x = pts - 0.5
    ax = np.abs(x)
    term1 = np.prod(1 + 0.5 * ax - 0.5 * ax**2, axis=1).sum() * (2.0 / n)
    cross = (
        1
        + 0.5 * (ax[:, None, :] + ax[None, :, :])
        - 0.5 * np.abs(x[:, None, :] - x[None, :, :])
    ).prod(axis=-1)
    term2 = cross.sum() / (n * n)
    return float(np.sqrt(max((13.0 / 12.0) ** d - term1 + term2, 0.0)))


def stratification_counts(pts: np.ndarray) -> np.ndarray:
    """Per-dimension histogram over m strata.  All-ones ⟺ valid LHS."""
    m, dim = pts.shape
    counts = np.zeros((dim, m), dtype=int)
    strata = np.clip((pts * m).astype(int), 0, m - 1)
    for j in range(dim):
        counts[j] = np.bincount(strata[:, j], minlength=m)
    return counts

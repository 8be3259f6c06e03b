"""ACTS — Automatic Configuration Tuning with Scalability guarantees.

Own copy of ``repro.core`` (pure numpy): typed parameter spaces over a
unit hypercube, LHS sampling, RRS and the baseline optimizers, and the
tuner ⇄ system-under-tune architecture.  Module for module, name for name
and draw for draw it is the reference's code, so the same space, objective
and seed give the same trial stream in both packages
(``tests/test_torch_tuner.py``).  The reference's surrogates, composite
spaces and the JAX system-under-tune are not ported yet (ROADMAP queue 1:
co-tuning; dry-run and roofline).
"""
from .base import BatchObjective, BudgetedRun, BudgetExhausted, Trial, \
    TuningResult
from .optimizers import (
    OPTIMIZERS,
    CoordinateSearchOptimizer,
    LHSOnlyOptimizer,
    RandomSearchOptimizer,
    SmartHillClimbingOptimizer,
    get_optimizer,
)
from .params import (
    BoolParam,
    EnumParam,
    FloatParam,
    IntParam,
    Parameter,
    ParameterSpace,
)
from .rrs import RRSOptimizer
from .sampling import (
    centered_l2_discrepancy,
    get_sampler,
    lhs,
    lhs_unit,
    maximin_lhs,
    min_pairwise_distance,
    random_sampling,
    random_unit,
    stratification_counts,
)
from .tuner import (
    BatchEvaluator,
    CallableSUT,
    PerfMetric,
    SystemManipulator,
    TunableSystem,
    Tuner,
    TuningReport,
    WorkloadGenerator,
)

__all__ = [n for n in dir() if not n.startswith("_")]

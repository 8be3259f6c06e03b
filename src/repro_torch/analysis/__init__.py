"""Static analysis of tuning spaces: the kernel feasibility models
(own copy of the kernel half of ``repro.analysis.feasibility``)."""
from .feasibility import (FeasibilityModel, Predicate, Violation,
                          kernel_feasibility)

__all__ = ["FeasibilityModel", "Predicate", "Violation",
           "kernel_feasibility"]

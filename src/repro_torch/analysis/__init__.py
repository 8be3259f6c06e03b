"""Static analysis of tuning spaces: the kernel and serve feasibility
models and their composition (own copy of ``repro.analysis.feasibility``)."""
from .feasibility import (CompositeFeasibility, FeasibilityModel, Predicate,
                          Violation, kernel_feasibility, serve_feasibility)

__all__ = ["CompositeFeasibility", "FeasibilityModel", "Predicate",
           "Violation", "kernel_feasibility", "serve_feasibility"]

"""Declarative feasibility models for the kernel tuning spaces.

Own copy of the kernel half of ``repro.analysis.feasibility``.  A
``FeasibilityModel`` is a named bag of ``Predicate``s over concrete
configs; ``error``-severity predicates define feasibility (the tuner
prunes violators before they reach the system under tune, charging no
budget).  The one kernel predicate on Hopper is ``smem_fits``: the
block's shared-memory footprint must fit the opt-in maximum per block.
It reads the SAME per-kernel function (``KernelDef.smem_footprint``) as
the roofline cost model's ``inf`` region, so

    ``model(config)  ⇔  cost_model(config) < inf``

holds exactly (``tests/test_torch_autotune.py``).  The reference's
sublane-alignment warning is a Mosaic idea and has no counterpart here;
the serve-knob models come with the ``--joint`` mode (ROADMAP queue 1:
co-tuning).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

__all__ = [
    "Predicate",
    "Violation",
    "FeasibilityModel",
    "kernel_feasibility",
]

Config = Dict[str, Any]

# A predicate check returns None when the config passes and a human-readable
# reason string when it does not.
CheckFn = Callable[[Config], Optional[str]]


@dataclass(frozen=True)
class Violation:
    predicate: str
    reason: str
    severity: str = "error"  # "error" => infeasible; "warn" => hazard only


@dataclass(frozen=True)
class Predicate:
    name: str
    check: CheckFn
    severity: str = "error"

    def __post_init__(self):
        if self.severity not in ("error", "warn"):
            raise ValueError(f"severity must be error|warn, "
                             f"got {self.severity!r}")


class FeasibilityModel:
    """Named predicates over one parameter space's concrete configs.

    Calling the model answers the tuner's question — is this config worth
    a test? — from the ``error`` predicates alone.  ``check`` returns every
    violation (warnings included) for reporting and for the lint-style
    ``explain`` string.
    """

    def __init__(self, name: str, predicates: Sequence[Predicate]):
        self.name = name
        self.predicates = tuple(predicates)
        names = [p.name for p in self.predicates]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate predicate names in {name!r}: "
                             f"{names}")

    def __call__(self, config: Mapping[str, Any]) -> bool:
        return all(p.check(dict(config)) is None
                   for p in self.predicates if p.severity == "error")

    def check(self, config: Mapping[str, Any]) -> List[Violation]:
        cfg = dict(config)
        out: List[Violation] = []
        for p in self.predicates:
            reason = p.check(cfg)
            if reason is not None:
                out.append(Violation(p.name, reason, p.severity))
        return out

    def explain(self, config: Mapping[str, Any]) -> str:
        vs = self.check(config)
        if not vs:
            return f"{self.name}: feasible"
        return "\n".join(f"{self.name}.{v.predicate} [{v.severity}]: "
                         f"{v.reason}" for v in vs)

    def __repr__(self) -> str:
        return (f"FeasibilityModel({self.name!r}, "
                f"{[p.name for p in self.predicates]})")


def kernel_feasibility(kernel: str, dims: Mapping[str, int],
                       dtype: str = "float32",
                       smem_limit: Optional[int] = None) -> FeasibilityModel:
    """The feasibility model of one kernel × problem signature.

    ``smem_fits`` (error): the block's shared-memory footprint, computed
    by the SAME ``KernelDef.smem_footprint`` the roofline cost model uses,
    must fit ``smem_limit`` (default: the H100's opt-in maximum per block,
    ``SMEM_PER_BLOCK_OPTIN``; the kernel-under-tune passes the device's
    own figure when it times on a card).  It is the only source of ``inf``
    in the cost model, which is what makes the model's boolean agree
    exactly with cost finiteness.
    """
    from repro_torch.autotune.space import (KERNELS, SMEM_PER_BLOCK_OPTIN,
                                            KernelSpace)

    kdef = KERNELS[kernel]  # KeyError on unknown kernel is the right error
    d = KernelSpace(kernel).validate_dims(dict(dims))
    limit = SMEM_PER_BLOCK_OPTIN if smem_limit is None else int(smem_limit)

    def smem_fits(cfg: Config) -> Optional[str]:
        need = int(kdef.smem_footprint(cfg, d, dtype))
        if need > limit:
            return (f"shared-memory footprint {need} bytes exceeds the "
                    f"{limit}-byte opt-in maximum per block "
                    f"(cost model returns inf)")
        return None

    return FeasibilityModel(f"kernel[{kernel}]",
                            [Predicate("smem_fits", smem_fits)])

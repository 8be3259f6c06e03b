"""Declarative feasibility models for the kernel and serve tuning spaces.

Own copy of ``repro.analysis.feasibility``.  A
``FeasibilityModel`` is a named bag of ``Predicate``s over concrete
configs; ``error``-severity predicates define feasibility (the tuner
prunes violators before they reach the system under tune, charging no
budget).  The one kernel predicate on Hopper is ``smem_fits``: the
block's shared-memory footprint must fit the opt-in maximum per block.
It reads the SAME per-kernel function (``KernelDef.smem_footprint``) as
the roofline cost model's ``inf`` region, so

    ``model(config)  ⇔  cost_model(config) < inf``

holds exactly (``tests/test_torch_autotune.py``).  The reference's
sublane-alignment warning is a Mosaic idea and has no counterpart here.
The serve predicates encode the ``apply_serve_knobs``/``min_pages_for``
deployability floor (and the mesh predicates, which pass on one device);
``CompositeFeasibility`` composes member models under the composite
space's prefixed keys.  A host of more than one device is not ported
(ROADMAP queue 1: multi-device).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

__all__ = [
    "Predicate",
    "Violation",
    "FeasibilityModel",
    "CompositeFeasibility",
    "kernel_feasibility",
    "serve_feasibility",
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


class CompositeFeasibility:
    """Member feasibility models composed under prefixed keys.

    Mirrors ``CompositeSpace``: a joint config's ``f"{member}{sep}{knob}"``
    keys are routed to each member's model with the prefix stripped, and
    violations come back with the member prefix on the predicate name.
    Joint feasibility is the conjunction of member feasibilities — a
    member with no model constrains nothing.
    """

    def __init__(self, members: Mapping[str, FeasibilityModel],
                 sep: str = "."):
        if not members:
            raise ValueError("CompositeFeasibility needs at least one "
                             "member model")
        self.members = dict(members)
        self.sep = sep
        self.name = "+".join(self.members)

    def _split(self, config: Mapping[str, Any]) -> Dict[str, Config]:
        out: Dict[str, Config] = {n: {} for n in self.members}
        for key, v in config.items():
            name, _, knob = key.partition(self.sep)
            if knob and name in out:
                out[name][knob] = v
        return out

    def __call__(self, config: Mapping[str, Any]) -> bool:
        parts = self._split(config)
        return all(model(parts[name])
                   for name, model in self.members.items())

    def check(self, config: Mapping[str, Any]) -> List[Violation]:
        parts = self._split(config)
        out: List[Violation] = []
        for name, model in self.members.items():
            for v in model.check(parts[name]):
                out.append(Violation(f"{name}{self.sep}{v.predicate}",
                                     v.reason, v.severity))
        return out

    def explain(self, config: Mapping[str, Any]) -> str:
        vs = self.check(config)
        if not vs:
            return f"{self.name}: feasible"
        return "\n".join(f"{v.predicate} [{v.severity}]: {v.reason}"
                         for v in vs)


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


# ---------------------------------------------------------------------------
# serve model: the apply_serve_knobs deployability floor
# ---------------------------------------------------------------------------
def serve_feasibility(max_seq: int = 2048, *, runtime: str = "continuous",
                      kv_layout: str = "paged",
                      kv_page_block: int = 1,
                      n_devices: Optional[int] = None,
                      n_heads: Optional[int] = None,
                      n_kv_heads: Optional[int] = None) -> FeasibilityModel:
    """The serve knob space's deployability predicates.

    ``kv_pages_floor`` (error) encodes exactly the floor
    ``apply_serve_knobs`` raises ``kv_cache_pages`` to when building a
    ``ServeConfig``: under the paged continuous runtime one ``max_seq``
    request (+ the scratch group) must fit (``min_pages_for``); dense
    layouts allocate the full ``slots × max_seq`` footprint.  A config
    below the floor would be silently mutated at deployment — the tuner
    would score one config and deploy another — so it is statically
    infeasible and never charged a test.

    The sharding subspace's predicates (``mesh_fits``, ``heads_divide``
    and the warning ``kv_heads_shardable``) are the reference's; its
    knobs are absent from a single-device space, and absent knobs pass.
    ``n_devices > 1`` is a multi-device host, which the port does not run
    yet: it raises.  ``None`` topology fields skip their predicates
    (unknown ≠ violated).
    """
    if n_devices is not None and n_devices > 1:
        raise NotImplementedError(
            f"serve_feasibility(n_devices={n_devices}): a mesh of more "
            "than one device needs ROADMAP queue 1: multi-device, which "
            "is not ported yet")
    from repro_torch.serve.paging import PAGE_TOKENS, min_pages_for

    paged = runtime == "continuous" and kv_layout == "paged"

    def kv_pages_floor(cfg: Config) -> Optional[str]:
        pages = int(cfg["kv_cache_pages"])
        slots = int(cfg["max_batch"])
        if paged:
            floor = min_pages_for(max_seq, kv_page_block)
        else:
            floor = -(-slots * max_seq // PAGE_TOKENS)
        if pages < floor:
            return (f"kv_cache_pages={pages} below the deployable floor "
                    f"{floor} for max_seq={max_seq} "
                    f"({runtime}/{kv_layout}): apply_serve_knobs would "
                    f"raise it, so tuned != deployed")
        return None

    def _mesh(cfg: Config) -> int:
        return int(cfg.get("mesh_devices", 1))

    def _is_tp(cfg: Config) -> bool:
        return str(cfg.get("tp_vs_replicas", "tp")) == "tp"

    def mesh_fits(cfg: Config) -> Optional[str]:
        dev = _mesh(cfg)
        if dev <= 1 or n_devices is None:
            return None
        if dev > n_devices or n_devices % dev:
            return (f"mesh_devices={dev} does not divide the host's "
                    f"{n_devices} devices: ServeEngine refuses to build "
                    f"this mesh")
        return None

    def heads_divide(cfg: Config) -> Optional[str]:
        dev = _mesh(cfg)
        if dev <= 1 or not _is_tp(cfg) or n_heads is None:
            return None
        if n_heads % dev:
            return (f"{dev}-way model axis does not divide n_heads="
                    f"{n_heads}: the engine would replicate attention "
                    f"and deploy an engine the tuner never scored")
        return None

    def kv_heads_shardable(cfg: Config) -> Optional[str]:
        dev = _mesh(cfg)
        if dev <= 1 or not _is_tp(cfg) or n_kv_heads is None:
            return None
        if n_kv_heads % dev:
            return (f"{dev}-way model axis does not divide n_kv_heads="
                    f"{n_kv_heads}: the paged KV pool replicates per "
                    f"device (deployable, but no pool-memory win)")
        return None

    return FeasibilityModel(
        "serve",
        [Predicate("kv_pages_floor", kv_pages_floor),
         Predicate("mesh_fits", mesh_fits),
         Predicate("heads_divide", heads_divide),
         Predicate("kv_heads_shardable", kv_heads_shardable,
                   severity="warn")])

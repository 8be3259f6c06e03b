"""Configuration-parameter spaces for ACTS.

The paper (§3, §4.1) requires the tuner to handle *all* knob types — boolean,
enumeration and numerics — over wide ranges, and to scale with the size of the
parameter set.  Every parameter therefore knows how to map itself to and from
the unit interval, so the whole space is a unit hypercube on which LHS and RRS
operate uniformly regardless of knob type.

Parameters are deliberately framework-agnostic (pure numpy): the same space
implementation tunes a surrogate MySQL, a Tomcat model, or the port's own
CUDA kernels (``repro_torch.autotune``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Parameter",
    "BoolParam",
    "EnumParam",
    "IntParam",
    "FloatParam",
    "ParameterSpace",
]


class Parameter:
    """Base class: a named, bounded, unit-mappable configuration knob."""

    name: str
    default: Any

    # --- unit-cube mapping ------------------------------------------------
    def from_unit(self, u: float) -> Any:
        """Map ``u ∈ [0, 1)`` to a concrete knob value."""
        raise NotImplementedError

    def to_unit(self, value: Any) -> float:
        """Map a concrete knob value to a representative ``u ∈ [0, 1)``."""
        raise NotImplementedError

    def validate(self, value: Any) -> bool:
        raise NotImplementedError

    def from_unit_array(self, us: np.ndarray) -> List[Any]:
        """Vectorized ``from_unit`` over a 1-D array of unit samples.

        The input must already be clipped to [0, 1) —
        ``ParameterSpace.from_unit_matrix`` clips the whole sample matrix
        once so the per-parameter kernels stay allocation-light.  Returns
        plain Python values (the scalar path's types), so configs built
        from a batch are indistinguishable from per-point ones.
        """
        return [self.from_unit(float(u)) for u in us]

    # Number of distinct values (None for continuous).
    @property
    def cardinality(self) -> Optional[int]:
        return None

    def grid(self, n: int) -> List[Any]:
        """n representative values spanning the range (for surface plots)."""
        us = (np.arange(n) + 0.5) / n
        out: List[Any] = []
        for u in us:
            v = self.from_unit(float(u))
            if not out or out[-1] != v:
                out.append(v)
        return out


def _clip_unit(u: float) -> float:
    # Keep strictly inside [0, 1) so index arithmetic never overflows.
    return min(max(float(u), 0.0), np.nextafter(1.0, 0.0))


def _clip_unit_arr(us: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(us, dtype=float), 0.0, np.nextafter(1.0, 0.0))


@dataclass(frozen=True)
class BoolParam(Parameter):
    name: str
    default: bool = False

    def from_unit(self, u: float) -> bool:
        return _clip_unit(u) >= 0.5

    def from_unit_array(self, us: np.ndarray) -> List[Any]:
        return (us >= 0.5).tolist()

    def to_unit(self, value: Any) -> float:
        return 0.75 if value else 0.25

    def validate(self, value: Any) -> bool:
        return isinstance(value, (bool, np.bool_))

    @property
    def cardinality(self) -> Optional[int]:
        return 2


@dataclass(frozen=True)
class EnumParam(Parameter):
    name: str
    choices: Tuple[Any, ...]
    default: Any = None

    def __post_init__(self):
        if not self.choices:
            raise ValueError(f"EnumParam {self.name!r} needs at least one choice")
        if self.default is None:
            object.__setattr__(self, "default", self.choices[0])
        if self.default not in self.choices:
            raise ValueError(
                f"EnumParam {self.name!r}: default {self.default!r} not in choices"
            )

    def from_unit(self, u: float) -> Any:
        idx = int(_clip_unit(u) * len(self.choices))
        return self.choices[idx]

    def from_unit_array(self, us: np.ndarray) -> List[Any]:
        idx = (us * len(self.choices)).astype(np.int64)
        return [self.choices[i] for i in idx]

    def to_unit(self, value: Any) -> float:
        idx = self.choices.index(value)
        return (idx + 0.5) / len(self.choices)

    def validate(self, value: Any) -> bool:
        return value in self.choices

    @property
    def cardinality(self) -> Optional[int]:
        return len(self.choices)


@dataclass(frozen=True)
class IntParam(Parameter):
    name: str
    lo: int
    hi: int  # inclusive
    default: Optional[int] = None
    log: bool = False  # sample on a log scale (wide ranges, e.g. buffer sizes)

    def __post_init__(self):
        if self.hi < self.lo:
            raise ValueError(f"IntParam {self.name!r}: hi < lo")
        if self.log and self.lo <= 0:
            raise ValueError(f"IntParam {self.name!r}: log scale needs lo > 0")
        if self.default is None:
            object.__setattr__(self, "default", self.lo)
        if not (self.lo <= self.default <= self.hi):
            raise ValueError(f"IntParam {self.name!r}: default out of range")

    def from_unit(self, u: float) -> int:
        u = _clip_unit(u)
        if self.log:
            lo, hi = math.log(self.lo), math.log(self.hi + 1)
            return min(self.hi, int(math.exp(lo + u * (hi - lo))))
        return self.lo + int(u * (self.hi - self.lo + 1))

    def from_unit_array(self, us: np.ndarray) -> List[Any]:
        if self.log:
            lo, hi = math.log(self.lo), math.log(self.hi + 1)
            vals = np.minimum(
                self.hi, np.exp(lo + us * (hi - lo)).astype(np.int64))
        else:
            vals = self.lo + (us * (self.hi - self.lo + 1)).astype(np.int64)
        return vals.tolist()

    def to_unit(self, value: Any) -> float:
        v = int(value)
        if self.log:
            lo, hi = math.log(self.lo), math.log(self.hi + 1)
            return _clip_unit((math.log(v + 0.5) - lo) / (hi - lo))
        return _clip_unit((v - self.lo + 0.5) / (self.hi - self.lo + 1))

    def validate(self, value: Any) -> bool:
        return isinstance(value, (int, np.integer)) and self.lo <= value <= self.hi

    @property
    def cardinality(self) -> Optional[int]:
        return self.hi - self.lo + 1


@dataclass(frozen=True)
class FloatParam(Parameter):
    name: str
    lo: float
    hi: float
    default: Optional[float] = None
    log: bool = False

    def __post_init__(self):
        if self.hi <= self.lo:
            raise ValueError(f"FloatParam {self.name!r}: hi <= lo")
        if self.log and self.lo <= 0:
            raise ValueError(f"FloatParam {self.name!r}: log scale needs lo > 0")
        if self.default is None:
            object.__setattr__(self, "default", self.lo)
        if not (self.lo <= self.default <= self.hi):
            raise ValueError(f"FloatParam {self.name!r}: default out of range")

    def from_unit(self, u: float) -> float:
        u = _clip_unit(u)
        if self.log:
            lo, hi = math.log(self.lo), math.log(self.hi)
            return float(math.exp(lo + u * (hi - lo)))
        return float(self.lo + u * (self.hi - self.lo))

    def from_unit_array(self, us: np.ndarray) -> List[Any]:
        if self.log:
            lo, hi = math.log(self.lo), math.log(self.hi)
            return np.exp(lo + us * (hi - lo)).tolist()
        return (self.lo + us * (self.hi - self.lo)).tolist()

    def to_unit(self, value: Any) -> float:
        v = float(value)
        if self.log:
            lo, hi = math.log(self.lo), math.log(self.hi)
            return _clip_unit((math.log(v) - lo) / (hi - lo))
        return _clip_unit((v - self.lo) / (self.hi - self.lo))

    def validate(self, value: Any) -> bool:
        return isinstance(value, (int, float, np.floating)) and (
            self.lo <= float(value) <= self.hi
        )


Config = Dict[str, Any]


class ParameterSpace:
    """An ordered set of configuration parameters ≡ a unit hypercube.

    Supports the paper's parameter-set scalability requirement: spaces compose
    (``merge``) so co-deployed systems (e.g. Hadoop + JVM, §2.1; DB + frontend,
    §5.5) are tuned *together* in one joint space, and restrict (``subset``)
    so a tuner can be pointed at any knob subset without touching the SUT.
    """

    def __init__(self, params: Sequence[Parameter]):
        names = [p.name for p in params]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate parameter names: {dupes}")
        self._params: Dict[str, Parameter] = {p.name: p for p in params}

    # --- basic introspection ---------------------------------------------
    def __len__(self) -> int:
        return len(self._params)

    def __iter__(self):
        return iter(self._params.values())

    def __contains__(self, name: str) -> bool:
        return name in self._params

    def __getitem__(self, name: str) -> Parameter:
        return self._params[name]

    @property
    def names(self) -> List[str]:
        return list(self._params.keys())

    @property
    def dim(self) -> int:
        return len(self._params)

    def log_cardinality(self) -> float:
        """log10 of the number of distinct settings (inf if any continuous)."""
        total = 0.0
        for p in self:
            c = p.cardinality
            if c is None:
                return math.inf
            total += math.log10(c)
        return total

    # --- configs <-> unit vectors ------------------------------------------
    def default_config(self) -> Config:
        return {p.name: p.default for p in self}

    def from_unit_vector(self, u: np.ndarray) -> Config:
        u = np.asarray(u, dtype=float)
        if u.shape != (self.dim,):
            raise ValueError(f"expected shape ({self.dim},), got {u.shape}")
        return {p.name: p.from_unit(float(ui)) for p, ui in zip(self, u)}

    def _conversion_plan(self):
        """Group parameters by conversion kind for matrix-wide transforms.

        Computed once per space: sampling-heavy optimizer loops convert
        hundreds of small rounds, so the per-round fixed cost must be a
        handful of vector ops, not ~3 per parameter.
        """
        plan = {
            "bool": [], "enum": [], "int_lin": [], "int_log": [],
            "float_lin": [], "float_log": [], "custom": [],
        }
        for j, p in enumerate(self):
            t = type(p)
            if t is BoolParam:
                plan["bool"].append(j)
            elif t is EnumParam:
                plan["enum"].append((j, p.choices))
            elif t is IntParam:
                plan["int_log" if p.log else "int_lin"].append((j, p))
            elif t is FloatParam:
                plan["float_log" if p.log else "float_lin"].append((j, p))
            else:  # subclassed parameter: fall back to its own kernel
                plan["custom"].append((j, p))
        for kind in ("int_lin", "int_log", "float_lin", "float_log"):
            entries = plan[kind]
            if not entries:
                continue
            idx = [j for j, _ in entries]
            if kind == "int_lin":
                lo = np.array([p.lo for _, p in entries], float)
                span = np.array([p.hi - p.lo + 1 for _, p in entries], float)
            elif kind == "float_lin":
                lo = np.array([p.lo for _, p in entries], float)
                span = np.array([p.hi - p.lo for _, p in entries], float)
            elif kind == "int_log":
                lo = np.array([math.log(p.lo) for _, p in entries], float)
                span = np.array([math.log(p.hi + 1) - math.log(p.lo)
                                 for _, p in entries], float)
            else:  # float_log
                lo = np.array([math.log(p.lo) for _, p in entries], float)
                span = np.array([math.log(p.hi) - math.log(p.lo)
                                 for _, p in entries], float)
            plan[kind] = (idx, lo, span,
                          [p.hi for _, p in entries] if kind == "int_log"
                          else None)
        self.__dict__["_plan"] = plan
        return plan

    def from_unit_matrix(self, units: np.ndarray) -> List[Config]:
        """Vectorized ``from_unit_vector`` over an (m, dim) sample matrix.

        Parameters are converted in matrix-wide groups (one transform per
        parameter *kind*) — the conversion half of the batched evaluation
        engine's speedup.
        """
        units = np.atleast_2d(np.asarray(units, dtype=float))
        if units.shape[1] != self.dim:
            raise ValueError(
                f"expected shape (m, {self.dim}), got {units.shape}")
        units = _clip_unit_arr(units)  # one clip for the whole matrix
        plan = self.__dict__.get("_plan") or self._conversion_plan()
        cols: List[Any] = [None] * self.dim
        if plan["bool"]:
            idx = plan["bool"]
            vals = units[:, idx] >= 0.5
            for k, j in enumerate(idx):
                cols[j] = vals[:, k].tolist()
        for j, choices in plan["enum"]:
            ci = (units[:, j] * len(choices)).astype(np.int64)
            cols[j] = [choices[i] for i in ci]
        for kind in ("int_lin", "int_log", "float_lin", "float_log"):
            entry = plan[kind]
            if not entry or isinstance(entry, list):
                continue
            idx, lo, span, hi = entry
            if kind == "int_lin":
                # match the scalar formula exactly: lo + int(u * span)
                vals = lo.astype(np.int64) + (
                    units[:, idx] * span).astype(np.int64)
            elif kind == "int_log":
                vals = np.minimum(np.exp(lo + units[:, idx] * span)
                                  .astype(np.int64),
                                  np.array(hi, dtype=np.int64))
            elif kind == "float_log":
                vals = np.exp(lo + units[:, idx] * span)
            else:
                vals = lo + units[:, idx] * span
            for k, j in enumerate(idx):
                cols[j] = vals[:, k].tolist()
        for j, p in plan["custom"]:
            # Trust a subclass's own vectorized kernel only if it defines
            # one; otherwise loop its (possibly overridden) from_unit so
            # batched conversion never diverges from the scalar path.
            if "from_unit_array" in type(p).__dict__:
                cols[j] = p.from_unit_array(units[:, j])
            else:
                cols[j] = [p.from_unit(float(u)) for u in units[:, j]]
        names = self.names
        return [dict(zip(names, row)) for row in zip(*cols)]

    def to_unit_vector(self, config: Mapping[str, Any]) -> np.ndarray:
        self.validate(config)
        return np.array([p.to_unit(config[p.name]) for p in self], dtype=float)

    def validate(self, config: Mapping[str, Any]) -> None:
        missing = [n for n in self.names if n not in config]
        if missing:
            raise ValueError(f"config missing parameters: {missing}")
        for p in self:
            if not p.validate(config[p.name]):
                raise ValueError(
                    f"invalid value {config[p.name]!r} for parameter {p.name!r}"
                )

    def random_config(self, rng: np.random.Generator) -> Config:
        return self.from_unit_vector(rng.random(self.dim))

    # --- composition --------------------------------------------------------
    def merge(self, other: "ParameterSpace", prefix: str = "") -> "ParameterSpace":
        """Join two spaces (co-deployed systems tuned together, §5.5)."""
        import copy

        params: List[Parameter] = list(self)
        for p in other:
            q = copy.copy(p)
            if prefix:
                object.__setattr__(q, "name", f"{prefix}{p.name}")
            params.append(q)
        return ParameterSpace(params)

    def subset(self, names: Iterable[str]) -> "ParameterSpace":
        return ParameterSpace([self._params[n] for n in names])

    def freeze(self, fixed: Mapping[str, Any]) -> "FrozenSpaceView":
        """A view with some knobs pinned (tune the rest)."""
        return FrozenSpaceView(self, dict(fixed))

    def config_key(self, config: Mapping[str, Any]) -> Tuple:
        """Hashable identity of a config (for duplicate-test caching)."""
        return tuple((n, config[n]) for n in self._params)


class FrozenSpaceView(ParameterSpace):
    """A ParameterSpace with some parameters fixed to constants.

    Sampling/optimization sees only the free parameters; emitted configs
    always carry the fixed values too.
    """

    def __init__(self, base: ParameterSpace, fixed: Dict[str, Any]):
        for n, v in fixed.items():
            if n not in base:
                raise ValueError(f"unknown fixed parameter {n!r}")
            if not base[n].validate(v):
                raise ValueError(f"invalid fixed value {v!r} for {n!r}")
        free = [p for p in base if p.name not in fixed]
        super().__init__(free)
        self._fixed = dict(fixed)
        self._base = base

    @property
    def fixed(self) -> Dict[str, Any]:
        return dict(self._fixed)

    def from_unit_vector(self, u: np.ndarray) -> Config:
        cfg = super().from_unit_vector(u)
        cfg.update(self._fixed)
        return cfg

    def from_unit_matrix(self, units: np.ndarray) -> List[Config]:
        cfgs = super().from_unit_matrix(units)
        for cfg in cfgs:
            cfg.update(self._fixed)
        return cfgs

    def to_unit_vector(self, config: Mapping[str, Any]) -> np.ndarray:
        return np.array([p.to_unit(config[p.name]) for p in self], dtype=float)

    def default_config(self) -> Config:
        cfg = {p.name: p.default for p in self}
        cfg.update(self._fixed)
        return cfg

    def validate(self, config: Mapping[str, Any]) -> None:
        # Free params must be valid; fixed params, if present, must match.
        for p in self:
            if p.name not in config:
                raise ValueError(f"config missing parameter {p.name!r}")
            if not p.validate(config[p.name]):
                raise ValueError(
                    f"invalid value {config[p.name]!r} for parameter {p.name!r}"
                )

    def config_key(self, config: Mapping[str, Any]) -> Tuple:
        return tuple((n, config[n]) for n in self._params)

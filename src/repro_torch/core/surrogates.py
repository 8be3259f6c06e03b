"""The surrogate system-under-tune base class.

Own copy of the ``Surrogate`` base of ``repro.core.surrogates``: a
deterministic ``config -> PerfMetric`` SUT with a knob space, which the
co-deployment serve surrogate (``repro_torch.serve.space.ServeSurrogate``)
subclasses.  The reference's benchmark surrogates (MySQL, Tomcat, Spark,
the front end and their composition) are not ported yet (ROADMAP queue 1:
lint and benches).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .params import Config, ParameterSpace
from .tuner import PerfMetric

__all__ = ["Surrogate"]


class Surrogate:
    """Base: a deterministic ``config -> PerfMetric`` SUT with a knob space."""

    name = "surrogate"

    def space(self) -> ParameterSpace:
        raise NotImplementedError

    def test(self, config: Config) -> PerfMetric:
        """Validate + score one configuration (a batch of one)."""
        self.space().validate(config)
        return self.test_batch([config])[0]

    def test_batch(self, configs: Sequence[Config]) -> List[PerfMetric]:
        """Score a whole candidate round in one vectorized call.

        Configs are trusted (no per-config validation) — the tuner only
        sends configs produced by ``ParameterSpace.from_unit_vector``.
        Subclasses override this with a vectorized path; the fallback here
        loops a subclass-provided ``test``.
        """
        if type(self).test is Surrogate.test:  # neither method overridden
            raise NotImplementedError("override test or test_batch")
        return [self.test(c) for c in configs]

    # For Fig.1-style projections.
    def surface(
        self, knob_x: str, knob_y: str, n: int = 25
    ) -> Tuple[list, list, np.ndarray]:
        space = self.space()
        base = space.default_config()
        xs = space[knob_x].grid(n)
        ys = space[knob_y].grid(n)
        cfgs = []
        for xv in xs:
            for yv in ys:
                cfg = dict(base)
                cfg[knob_x] = xv
                cfg[knob_y] = yv
                cfgs.append(cfg)
        vals = np.array([m.value for m in self.test_batch(cfgs)])
        return xs, ys, vals.reshape(len(xs), len(ys))

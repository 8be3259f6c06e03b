"""The port's co-tuning core (``repro_torch.core.composite``) against the
reference's (``repro.core.composite``).

Both packages get the same member spaces, the same pure-Python member
objectives and the same seed.  The cases of ``tests/test_composite.py``
(prefixing, split/join, per-subspace conversion with a custom parameter
and a frozen member, the two scalarizers, one shared budget with one
dispatch a member a round, config-only members, composed feasibility,
``subspace_rr``'s budget and its one-subspace-a-round rounds) are run on
both sides, and every tested config, its value, its test index and phase
must be equal, batched and sequential, over several seeds and
optimizers.  The reference's MySQL and front-end surrogates are not
ported (ROADMAP queue 1: lint and benches), so the members here are
bumpy analytic objectives written once and built in each package.
"""
import math

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.analysis import feasibility as jfeas
from repro_torch.analysis import feasibility as tfeas

PACKAGES = {"reference": (jcore, jfeas), "port": (tcore, tfeas)}


def _odd_param(core):
    class OddIntParam(core.IntParam):
        """Always lands on odd values: the composite must route its
        columns through this subclass's own conversion."""

        def from_unit(self, u: float) -> int:
            v = super().from_unit(u)
            return v if v % 2 == 1 else min(self.hi, v + 1)

    return OddIntParam


def _toy_spaces(core):
    a = core.ParameterSpace([core.FloatParam("x", 0.0, 1.0, default=0.5),
                             core.IntParam("n", 1, 10, default=2)])
    b = core.ParameterSpace([_odd_param(core)("m", 1, 99, default=3)])
    return a, b


def _db_space(core):
    return core.ParameterSpace([
        core.IntParam("threads", 1, 64, 8),
        core.IntParam("buffer_kb", 16, 65536, 1024, log=True),
        core.FloatParam("ratio", 0.0, 1.0, 0.5),
        core.EnumParam("policy", ("lru", "fifo", "clock", "arc"), "lru"),
        core.BoolParam("compress", False),
    ])


def _fe_space(core):
    return core.ParameterSpace([
        core.IntParam("workers", 1, 256, 16, log=True),
        core.FloatParam("timeout", 0.01, 10.0, 1.0, log=True),
        core.EnumParam("balance", ("rr", "least", "hash"), "rr"),
    ])


def _db_value(cfg):
    """Throughput (maximized) with a basin off the default."""
    v = 1000.0 - (cfg["threads"] - 23) ** 2
    v -= 40.0 * (math.log2(cfg["buffer_kb"]) - 12.0) ** 2
    v += 80.0 * math.sin(7.0 * cfg["ratio"])
    v += {"lru": 10.0, "fifo": 0.0, "clock": 25.0, "arc": 40.0}[
        cfg["policy"]]
    return v - (15.0 if cfg["compress"] else 0.0)


def _fe_value(cfg):
    """Latency seconds (minimized)."""
    v = 0.2 + abs(math.log2(cfg["workers"]) - 5.0) * 0.03
    v += abs(math.log10(cfg["timeout"]) - 0.3) * 0.1
    return v + {"rr": 0.02, "least": 0.0, "hash": 0.05}[cfg["balance"]]


class _Member:
    """A member system: its space, and a ``config -> PerfMetric``
    objective, batched or not."""

    def __init__(self, core, space, fn, higher, batched, latency=None):
        self._space = space
        self._metric = lambda c: core.PerfMetric(
            fn(c), higher_is_better=higher,
            metrics={} if latency is None else {"latency_s": latency(c)})
        self.calls = 0
        if batched:
            self.test_batch = lambda cs: [self._metric(c) for c in cs]

    def space(self):
        return self._space

    def test(self, config):
        self.calls += 1
        return self._metric(config)


def _feasible_db(feas):
    def odd_threads(cfg):
        if cfg["threads"] > 40 and cfg["threads"] % 2:
            return "odd thread counts above 40"
        return None

    return feas.FeasibilityModel("db", [feas.Predicate("even", odd_threads)])


def _composed(core, feas, *, batched=True, scalarizer="weighted",
              feasibility=False, config_only=False):
    members = {
        "db": _Member(core, _db_space(core), _db_value, True, batched,
                      latency=lambda c: 0.5 + c["ratio"]),
        "fe": _Member(core, _fe_space(core), _fe_value, False, batched),
    }
    if config_only:
        members["knob"] = core.ParameterSpace(
            [core.IntParam("k", 1, 9, default=5)])
    if scalarizer == "weighted":
        sc = core.weighted_objective({"db": 1.0, "fe": 500.0})
    else:
        sc = core.throughput_under_sla("db", sla_s=1.0)
    return core.CompositeSUT(
        members, sc, feasibility={"db": _feasible_db(feas)}
        if feasibility else None)


def _stream(report):
    return [(t.test_index, t.phase, t.value, sorted(t.config.items()))
            for t in report.history]


def _run(pkg, optimizer, seed, batch, budget=90, **kw):
    core, feas = PACKAGES[pkg]
    sut = _composed(core, feas, batched=batch, **kw)
    return sut, core.Tuner(sut.space(), sut, budget=budget, seed=seed,
                           optimizer=optimizer, batch=batch).run()


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_composite_space_structure(pkg):
    core = PACKAGES[pkg][0]
    a, b = _toy_spaces(core)
    cs = core.CompositeSpace({"a": a, "b": b})
    assert cs.names == ["a.x", "a.n", "b.m"]
    assert cs.column_groups() == {"a": [0, 1], "b": [2]}
    assert cs.subspace("b") is b
    parts = cs.split(cs.default_config())
    assert parts == {"a": {"x": 0.5, "n": 2}, "b": {"m": 3}}
    assert cs.join(parts) == cs.default_config()
    for bad in ({"nosuch.k": 1}, {"unprefixed": 1}):
        with pytest.raises(ValueError):
            cs.split(bad)
    for bad in ({"with.dot": a}, {"": a}, {}):
        with pytest.raises(ValueError):
            core.CompositeSpace(bad)


@pytest.mark.parametrize("frozen", [False, True])
def test_composite_conversion_matches_reference(frozen):
    """Per-subspace conversion (a custom parameter, a frozen member):
    equal configs from equal unit matrices, and the matrix path equal to
    the scalar path, in both packages."""
    out = {}
    for pkg, (core, _) in PACKAGES.items():
        a, b = _toy_spaces(core)
        if frozen:
            a = a.freeze({"n": 7})
        cs = core.CompositeSpace({"a": a, "b": b})
        u = np.random.default_rng(0).random((64, cs.dim))
        batch = cs.from_unit_matrix(u)
        assert batch == [cs.from_unit_vector(row) for row in u]
        assert all(c["b.m"] % 2 == 1 for c in batch)
        assert all(not frozen or c["a.n"] == 7 for c in batch)
        again = [cs.from_unit_vector(cs.to_unit_vector(c)) for c in batch]
        assert again == batch
        out[pkg] = (batch, cs.default_config(), cs.dim)
    assert out["port"] == out["reference"]


def test_scalarizers_match_reference():
    rows = [({"db": (100.0, True, 0.5), "fe": (3.0, False, None)}),
            ({"db": (100.0, True, 2.0), "fe": (0.25, False, None)}),
            ({"db": (7.5, True, 1.0), "fe": (1e-3, False, None)})]
    got = {}
    for pkg, (core, _) in PACKAGES.items():
        w = core.weighted_objective({"db": 1.0, "fe": 2.0})
        s = core.throughput_under_sla("db", sla_s=1.0, penalty=2.0)
        out = []
        for row in rows:
            metrics = {n: core.PerfMetric(v, h, {} if lat is None
                                          else {"latency_s": lat})
                       for n, (v, h, lat) in row.items()}
            for sc in (w, s):
                m = sc(metrics, {})
                out.append((m.value, m.higher_is_better, m.metrics))
        with pytest.raises(ValueError, match="latency"):
            s({"db": core.PerfMetric(1.0)}, {})
        got[pkg] = out
    assert got["port"] == got["reference"]
    # the SLA's soft penalty: (sla/lat)**2 past the bound
    assert got["port"][3][0] == pytest.approx(25.0)


@pytest.mark.parametrize("scalarizer", ["weighted", "sla"])
@pytest.mark.parametrize("batch", [True, False],
                         ids=["batched", "sequential"])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("optimizer", ["rrs", "subspace_rr", "shc",
                                       "lhs_only"])
def test_trial_stream_matches_reference(optimizer, seed, batch, scalarizer):
    _, want = _run("reference", optimizer, seed, batch,
                   scalarizer=scalarizer)
    _, got = _run("port", optimizer, seed, batch, scalarizer=scalarizer)
    assert _stream(got) == _stream(want)
    assert got.best_config == want.best_config
    assert got.best_metric.value == want.best_metric.value
    assert got.n_tests == want.n_tests == 90


@pytest.mark.parametrize("optimizer", ["rrs", "subspace_rr"])
def test_batched_and_sequential_port_runs_agree(optimizer):
    _, a = _run("port", optimizer, 3, True)
    _, b = _run("port", optimizer, 3, False)
    assert _stream(a) == _stream(b)


@pytest.mark.parametrize("optimizer", ["rrs", "subspace_rr"])
def test_feasibility_and_config_only_member_match_reference(optimizer):
    """A member's feasibility model joins the composite's (prefixed keys)
    and prunes before any member runs; a bare-space member's knobs reach
    the scalarizer but nothing evaluates it."""
    reps = {}
    for pkg in PACKAGES:
        sut, rep = _run(pkg, optimizer, 1, True, budget=60,
                        feasibility=True, config_only=True)
        assert rep.n_infeasible_pruned > 0
        assert set(sut.member_batch_calls) == {"db", "fe"}
        assert sut.members["db"].calls == 0  # one test_batch a round
        assert "knob.k" in rep.best_config
        m = sut.test(sut.space().default_config())
        assert set(m.metrics["member_values"]) == {"db", "fe"}
        bad = dict(sut.space().default_config(), **{"db.threads": 41})
        assert not sut.feasibility_model(bad)
        assert [v.predicate for v in sut.feasibility_model.check(bad)] == [
            "db.even"]
        reps[pkg] = rep
    assert _stream(reps["port"]) == _stream(reps["reference"])
    assert (reps["port"].n_infeasible_pruned
            == reps["reference"].n_infeasible_pruned)


def test_shared_budget_and_single_dispatch():
    """Batched composite rounds dispatch as one test_batch call a member
    a round, never a call a config, under ONE shared budget."""
    core, feas = PACKAGES["port"]
    sut = _composed(core, feas)
    tuner = core.Tuner(sut.space(), sut, budget=120, seed=0)
    assert tuner.batch
    rep = tuner.run()
    assert rep.n_tests == 120
    assert tuner.n_evaluator_calls < 120 / 5
    for name in ("db", "fe"):
        assert sut.member_batch_calls[name] == tuner.n_evaluator_calls
        assert sut.member_test_calls[name] == 0


def test_subspace_rr_registered_and_bounded():
    assert isinstance(tcore.get_optimizer("subspace_rr"),
                      tcore.SubspaceRoundRobinOptimizer)
    with pytest.raises(ValueError):
        tcore.SubspaceRoundRobinOptimizer(round_size=0)
    with pytest.raises(ValueError):
        tcore.SubspaceRoundRobinOptimizer(shrink=1.0)
    space = tcore.ParameterSpace(
        [tcore.FloatParam(f"x{i}", -5.0, 5.0, default=4.0)
         for i in range(4)])
    calls = []

    def obj(cfg):
        calls.append(1)
        return sum(v * v for v in cfg.values())

    res = tcore.SubspaceRoundRobinOptimizer().optimize(
        space, obj, budget=80, rng=np.random.default_rng(0))
    assert len(calls) == 80 == res.n_tests
    trace = res.best_so_far()
    assert all(a >= b for a, b in zip(trace, trace[1:]))
    assert res.best_value < 4 * 16.0


def test_subspace_rr_varies_one_subspace_a_round():
    a, b = _toy_spaces(tcore)
    cs = tcore.CompositeSpace({"a": a, "b": b})
    rounds = []

    def batch_obj(cfgs):
        rounds.append(cfgs)
        return [abs(c["a.x"] - 0.3) + abs(c["b.m"] - 51) / 50 for c in cfgs]

    tcore.SubspaceRoundRobinOptimizer(round_size=5).optimize(
        cs, None, budget=60, rng=np.random.default_rng(0),
        batch_objective=batch_obj)
    for cfgs in rounds:
        if len(cfgs) != 5:
            continue  # explore/diverge round
        varies_a = len({(c["a.x"], c["a.n"]) for c in cfgs}) > 1
        varies_b = len({c["b.m"] for c in cfgs}) > 1
        assert not (varies_a and varies_b)


def test_composite_feasibility_matches_reference():
    cfgs = [{"db.threads": t, "fe.workers": w, "other.k": 1}
            for t in (8, 41, 42) for w in (1, 300)]
    out = {}
    for pkg, (core, feas) in PACKAGES.items():
        def too_many(cfg):
            return "too many" if cfg["workers"] > 256 else None

        model = feas.CompositeFeasibility({
            "db": _feasible_db(feas),
            "fe": feas.FeasibilityModel("fe", [
                feas.Predicate("cap", too_many),
                feas.Predicate("hint", lambda c: "hint", severity="warn")]),
        })
        out[pkg] = [(model(c), [(v.predicate, v.reason, v.severity)
                                for v in model.check(c)], model.explain(c))
                    for c in cfgs]
        with pytest.raises(ValueError):
            feas.CompositeFeasibility({})
    assert out["port"] == out["reference"]

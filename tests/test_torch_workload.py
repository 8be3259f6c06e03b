"""The port's online retuner (``repro_torch.serve.workload``) and the
engine's retune path, against the reference's.

* Fingerprints, signatures, ``nearest_workload``, ``coerce_config``, the
  window and the retuner: each test of ``tests/test_workload_retune.py``
  (``TestSignature``, ``TestNearestWorkload``, ``TestCoerceConfig``,
  ``TestWorkloadWindow``, ``TestShiftDetection``, ``TestWarmTransfer``,
  ``TestAcceptanceRate``) runs on the port and on the reference with the
  same inputs; the port must pass the reference's asserts and give the
  reference's values.  A signature written by either package parses in
  the other.
* The engine on ``_drift_workload`` with ``RETUNE_KW`` (the reference
  test's tiny model, from bridged weights): with no patch the tokens,
  steps and the seven work counts equal the reference's.  The retune
  events are held field by field only under ``same_attention``
  (``tests/test_torch_cotune.py``): without it the port prices a decode
  step's attention by its Hopper cost model and the reference by its TPU
  roofline, so the surrogate values differ and a retune may choose
  another winner.  Under it ``value`` and ``distance`` agree to 1e-9
  relative, every other field exactly, and so does the engine's
  ``cfg`` after the swap (both mutate it in place).
* The winner persists under ``model-sm90`` on the CPU and leaves the
  reference's ``cpu`` entries byte for byte; ``slot_cap`` caps admission,
  not tokens; the retune step is the same on two runs.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

import repro.serve.workload as jw
import repro_torch.serve.workload as tw
from repro import autotune as jautotune
from repro.core.tuner import Tuner as JTuner
from repro.models import Model as JaxModel
from repro.serve import GenerationResult as JGenerationResult
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import space as jspace
from repro_torch import autotune as tautotune
from repro_torch.core.tuner import Tuner as TTuner
from repro_torch.models import Model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve import GenerationResult, ServeConfig, ServeEngine
from repro_torch.serve import space as tspace
from test_torch_cotune import same_attention  # noqa: F401  (fixture)
from test_torch_model import port_cfg
from test_workload_retune import (RETUNE_KW, _drift_workload,
                                  tiny_engine_parts)  # noqa: F401

torch.set_num_threads(1)

# side name -> (workload module, space module, Tuner)
SIDES = {"reference": (jw, jspace, JTuner), "port": (tw, tspace, TTuner)}
COUNTS = ("steps", "prefill_chunks", "preemptions", "cow_splits",
          "shared_prefix_tokens", "drafted", "accepted")
FP_ARGS = (0.5, 24.0, 0.35, 8.0, 12.0, 0.30, 0.60)


def _fp(w, *args):
    return w.WorkloadFingerprint(*(args or FP_ARGS))


# ---------------------------------------------------------------------------
# signatures, transfer, coercion, the window
# ---------------------------------------------------------------------------
class TestSignature:
    def test_canonical_form_and_round_trip(self):
        for w, _, _ in SIDES.values():
            fp = _fp(w)
            assert w.fingerprint_sig(fp) == \
                "a0.50_d12_g8_p24_r0.35_s0.30_x0.60"
            assert w.fingerprint_distance(
                fp, w.parse_sig(w.fingerprint_sig(fp))) < 1e-9

    def test_signatures_cross_parse(self):
        """A signature written by one package parses in the other, to the
        same fields, on random fingerprints (nan acceptance included)."""
        rng = np.random.default_rng(0)
        for i in range(200):
            vals = [rng.uniform(0, 2), rng.uniform(1, 3000),
                    rng.uniform(0, 1), rng.uniform(1, 500),
                    rng.uniform(0, 64), rng.uniform(0, 1),
                    float("nan") if i % 5 == 0 else rng.uniform(0, 1)]
            sigs = {s: w.fingerprint_sig(w.WorkloadFingerprint(*vals))
                    for s, (w, _, _) in SIDES.items()}
            assert sigs["port"] == sigs["reference"]
            back = {s: dataclasses.astuple(w.parse_sig(sigs[other]))
                    for (s, (w, _, _)), other in zip(
                        SIDES.items(), ("port", "reference"))}
            np.testing.assert_array_equal(back["port"], back["reference"])

    def test_nan_acceptance_round_trips(self):
        for w, _, _ in SIDES.values():
            sig = w.fingerprint_sig(w.WorkloadFingerprint(
                0.5, 24.0, 0.35, 8.0, 12.0, 0.30, float("nan")))
            assert sig.endswith("x?")
            assert math.isnan(w.parse_sig(sig).accept_rate)

    @pytest.mark.parametrize("junk", ["-", "", "v3|serve|x", "a0.5",
                                      "a0.50_d12_g8_p24_r0.35_s0.30",
                                      "z1_y2_x3_w4_v5_u6_t7"])
    def test_non_signatures_parse_to_none(self, junk):
        assert tw.parse_sig(junk) is None
        assert jw.parse_sig(junk) is None

    def test_distance_matches_reference(self):
        rng = np.random.default_rng(1)
        for i in range(100):
            a, b = (rng.uniform(0, 3, size=7) for _ in range(2))
            if i % 4 == 0:
                a[6] = float("nan")
            d = {s: w.fingerprint_distance(w.WorkloadFingerprint(*a),
                                           w.WorkloadFingerprint(*b))
                 for s, (w, _, _) in SIDES.items()}
            assert d["port"] == d["reference"]
        other = (1.0, 30.0, 0.10, 6.0, 4.0, 0.80, 0.20)
        assert tw.fingerprint_distance(_fp(tw), _fp(tw)) == 0.0
        assert tw.fingerprint_distance(_fp(tw), _fp(tw, *other)) == \
            tw.fingerprint_distance(_fp(tw, *other), _fp(tw)) > 0.0
        nodata = FP_ARGS[:6] + (float("nan"),)
        assert tw.fingerprint_distance(_fp(tw), _fp(tw, *nodata)) == 0.0


class TestNearestWorkload:
    @staticmethod
    def _entry(tag):
        return {"config": {"max_batch": 4}, "value": 1.0,
                "meta": {"t": tag}}

    @pytest.mark.parametrize("case", ["near", "generic", "beyond", "empty"])
    def test_matches_reference(self, case):
        near = tw.fingerprint_sig(tw.WorkloadFingerprint(
            0.55, 24.0, 0.35, 8.0, 12.0, 0.30, 0.60))
        far = tw.fingerprint_sig(tw.WorkloadFingerprint(
            2.0, 4.0, 0.0, 30.0, 1.0, 0.0, 0.0))
        cands, radius = {
            "near": ({near: self._entry("near"), far: self._entry("far"),
                      "-": self._entry("generic")}, 0.75),
            "generic": ({"-": self._entry("generic")}, 0.75),
            "beyond": ({far: self._entry("far")}, 0.3),
            "empty": ({}, 0.75)}[case]
        got = {s: w.nearest_workload(cands, _fp(w), radius)
               for s, (w, _, _) in SIDES.items()}
        assert got["port"] == got["reference"]
        if case == "near":
            ws, entry, d = got["port"]
            assert ws == near and entry["meta"]["t"] == "near" and d < 0.1
        elif case == "generic":
            assert got["port"][0] == "-" and got["port"][2] == 0.75
        else:
            assert got["port"] is None


class TestCoerceConfig:
    @pytest.mark.parametrize("case", ["snap", "bad-enum", "frozen"])
    def test_matches_reference(self, case):
        config, freeze = {
            "snap": ({"max_batch": 64, "prefill_chunk": 512,
                      "kv_cache_pages": 9999, "schedule": "sjf",
                      "page_policy": "on_demand", "share_prefix": 1,
                      "draft_len": 4, "bogus_knob": 7}, None),
            "bad-enum": ({"schedule": "not-a-policy"}, None),
            "frozen": ({"kv_cache_pages": 24}, {"kv_cache_pages": 12}),
        }[case]
        got = {}
        for side, (w, sp, _) in SIDES.items():
            space = sp.serve_knob_space(48, max_slots=8)
            if freeze:
                space = space.freeze(freeze)
            got[side] = w.coerce_config(space, dict(config))
            space.validate(got[side])
        assert got["port"] == got["reference"]
        if case == "snap":
            assert "bogus_knob" not in got["port"]
            assert got["port"]["max_batch"] == 8
            assert got["port"]["draft_len"] == 4
        elif case == "bad-enum":
            assert got["port"]["schedule"] == "fifo"
        else:
            assert got["port"]["kv_cache_pages"] == 12


class TestWorkloadWindow:
    @staticmethod
    def _both(drive, capacity=16):
        out = {}
        for side, (w, _, _) in SIDES.items():
            win = w.WorkloadWindow(capacity=capacity)
            out[side] = drive(win)
        return out

    def test_fingerprint_measures_the_trace(self):
        def drive(w):
            for i in range(4):
                w.record_request(step=i * 2, prompt=[1] * 20, max_new=10)
            w.record_depth(3)
            w.record_depth(5)
            return w.fingerprint(step=7)

        got = self._both(drive, capacity=8)
        np.testing.assert_array_equal(dataclasses.astuple(got["port"]),
                                      dataclasses.astuple(got["reference"]))
        fp = got["port"]
        assert fp.prompt_mean == 20 and fp.gen_mean == 10
        assert fp.arrival_rate == pytest.approx(4 / 8)
        assert fp.depth == pytest.approx(4.0)
        assert fp.prompt_spread == 0.0 and fp.share_frac > 0.5

    def test_random_traces_match_reference(self):
        """Random admissions, depths and drafts through both windows give
        the same fingerprint at every step (nan acceptance included)."""
        rng = np.random.default_rng(3)
        ops = []
        shared = rng.integers(1, 500, size=30).tolist()
        for step in range(80):
            if rng.random() < 0.4:
                n = int(rng.integers(1, 90))
                p = (shared[:int(rng.integers(0, 30))]
                     + rng.integers(1, 500, size=n).tolist())
                ops.append(("req", step, p, int(rng.integers(1, 40))))
            if rng.random() < 0.3:
                k = int(rng.integers(0, 5))
                ops.append(("draft", k, int(rng.integers(0, k + 1))))
            ops.append(("depth", int(rng.integers(0, 20))))
            ops.append(("fp", step))

        def drive(w):
            fps = []
            for op in ops:
                if op[0] == "req":
                    w.record_request(op[1], op[2], op[3])
                elif op[0] == "draft":
                    w.record_draft(op[1], op[2])
                elif op[0] == "depth":
                    w.record_depth(op[1])
                else:
                    fp = w.fingerprint(op[1])
                    fps.append(None if fp is None
                               else dataclasses.astuple(fp))
            return fps

        got = self._both(drive, capacity=10)
        assert len(got["port"]) == 80
        for a, b in zip(got["port"], got["reference"]):
            if a is None or b is None:
                assert a is b
            else:
                np.testing.assert_array_equal(a, b)

    def test_distinct_prompts_share_nothing(self):
        rng = np.random.default_rng(0)
        w = tw.WorkloadWindow(capacity=8)
        for i in range(5):
            w.record_request(i, rng.integers(1, 500, size=16).tolist(), 4)
        assert w.fingerprint(step=5).share_frac < 0.2

    def test_acceptance_nan_until_drafts(self):
        w = tw.WorkloadWindow()
        w.record_request(0, [1, 2, 3], 4)
        assert math.isnan(w.fingerprint(0).accept_rate)
        w.record_draft(4, 3)
        assert w.fingerprint(0).accept_rate == pytest.approx(0.75)
        w.record_draft(0, 0)  # no proposal: must not dilute the rate
        assert w.fingerprint(0).accept_rate == pytest.approx(0.75)

    def test_empty_window_and_capacity(self):
        assert tw.WorkloadWindow().fingerprint(0) is None
        with pytest.raises(ValueError):
            tw.WorkloadWindow(capacity=0)
        w = tw.WorkloadWindow(capacity=2)
        for step, n in ((0, 30), (1, 6), (2, 6)):
            w.record_request(step, [1] * n, 2)
        assert w.n_requests == 2 and w.fingerprint(2).prompt_mean == 6.0


# ---------------------------------------------------------------------------
# the retuner on synthetic traces (the reference's _retuner and _drive)
# ---------------------------------------------------------------------------
def _retuner(side, **kw):
    w, sp, _ = SIDES[side]
    defaults = dict(budget=8, threshold=0.25, min_requests=4, cooldown=8,
                    check_every=2, optimizer="rrs", seed=0, batch=None)
    defaults.update(kw)
    return w.OnlineRetuner(sp.serve_knob_space(48, max_slots=8),
                           sp.CotuneParams(max_seq=48, prompt_len=24,
                                           gen_len=12), **defaults)


def _drive(side, rt, *, shift_at=20, n_steps=40, trace_seed=7):
    rng = np.random.default_rng(trace_seed)
    w = SIDES[side][0].WorkloadWindow(capacity=8)
    shared = rng.integers(1, 500, size=20).tolist()
    events = []
    for step in range(n_steps):
        if step % 4 == 0:
            if step < shift_at:
                w.record_request(step,
                                 rng.integers(1, 500, size=24).tolist(), 12)
            else:
                for _ in range(3):
                    w.record_request(
                        step, shared + rng.integers(1, 500, size=2).tolist(),
                        3)
        w.record_depth(2 if step < shift_at else 8)
        hit = rt.maybe_retune(w, step)
        if hit is not None:
            events.append(hit)
    return events


def _events_equal(got, want, rel=1e-9):
    assert len(got) == len(want)
    for g, e in zip(got, want):
        assert set(g) == set(e)
        for key in e:
            if key in ("value", "distance"):
                assert g[key] == pytest.approx(e[key], rel=rel, abs=0), key
            elif key in ("spec_accept", "measured_accept"):
                assert (g[key] == e[key]
                        or math.isnan(g[key]) and math.isnan(e[key])), key
            elif key == "fingerprint":
                np.testing.assert_array_equal(
                    [g[key][n] for n in sorted(e[key])],
                    [e[key][n] for n in sorted(e[key])])
            else:
                assert g[key] == e[key], key


class TestShiftDetection:
    # (retuner changes, drive changes)
    CASES = {
        "anchors-then-fires-once": (dict(cooldown=1000), {}),
        "no-shift": ({}, dict(shift_at=10 ** 9)),
        "eager": (dict(threshold=0.05, cooldown=4), dict(n_steps=60)),
        "lazy": (dict(threshold=0.05, cooldown=1000), dict(n_steps=60)),
        "min-requests": (dict(min_requests=10 ** 6, cooldown=1000), {}),
    }

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_events_match_reference_under_the_same_attention(
            self, same_attention, case):  # noqa: F811
        rkw, dkw = self.CASES[case]
        events = {s: _drive(s, _retuner(s, **rkw), **dkw) for s in SIDES}
        _events_equal(events["port"], events["reference"])
        port = events["port"]
        if case == "anchors-then-fires-once":
            assert len(port) == 1 and port[0]["step"] >= 20
            assert port[0]["distance"] > 0.25
        elif case in ("no-shift", "min-requests"):
            assert port == []
        elif case == "lazy":
            assert len(port) == 1
        else:
            assert len(port) >= 1

    def test_fires_on_the_hopper_model_too(self):
        """Without the shared attention function the trigger step and the
        signature still equal the reference's (they do not depend on the
        surrogate); only the winner may differ."""
        events = {s: _drive(s, _retuner(s, cooldown=1000)) for s in SIDES}
        assert [(e["step"], e["signature"], e["distance"])
                for e in events["port"]] == \
            [(e["step"], e["signature"], e["distance"])
             for e in events["reference"]]

    def test_measured_acceptance_feeds_spec_accept(self):
        rt = _retuner("port", cooldown=1000)
        ev = rt.retune(tw.WorkloadFingerprint(0.5, 6.0, 0.1, 3.0, 8.0, 0.9,
                                              0.85), step=0)
        assert ev["spec_accept"] == pytest.approx(0.85)
        assert ev["measured_accept"] == pytest.approx(0.85)
        params = tspace.params_for_fingerprint(
            tw.WorkloadFingerprint(0.5, 6.0, 0.1, 3.0, 8.0, 0.9,
                                   float("nan")),
            tspace.CotuneParams(max_seq=48))
        assert params.spec_accept == tspace.CotuneParams(
            max_seq=48).spec_accept

    def test_same_trace_same_trigger(self):
        runs = [_drive("port", _retuner("port", cooldown=1000))
                for _ in range(2)]
        assert [e["step"] for e in runs[0]] == [e["step"] for e in runs[1]]
        assert runs[0][0]["config"] == runs[1][0]["config"]
        assert runs[0][0]["signature"] == runs[1][0]["signature"]


class TestWarmTransfer:
    FP_B = (0.75, 22.0, 0.10, 3.0, 8.0, 0.90, 0.85)

    def test_nearest_signature_beats_cold_at_equal_budget(
            self, same_attention):  # noqa: F811
        got = {}
        for side, (w, sp, Tuner) in SIDES.items():
            fp_b = w.WorkloadFingerprint(*self.FP_B)
            params = sp.params_for_fingerprint(fp_b,
                                               sp.CotuneParams(max_seq=48))
            donor = Tuner(sp.serve_knob_space(48, max_slots=8),
                          sp.ServeSurrogate(params), budget=64,
                          seed=3).run()
            near_sig = w.fingerprint_sig(w.WorkloadFingerprint(
                0.70, 22.0, 0.12, 3.0, 8.0, 0.88, 0.80))
            rt_warm = _retuner(side, budget=6, cooldown=1000)
            rt_warm._candidates = lambda: {
                near_sig: {"config": dict(donor.best_config),
                           "value": donor.best_metric.value}}
            rt_warm.sig_dims = None  # no cache writes from the unit test
            rt_cold = _retuner(side, budget=6, cooldown=1000)
            got[side] = (rt_warm.retune(fp_b, step=0),
                         rt_cold.retune(fp_b, step=0))
        for i in range(2):
            _events_equal([got["port"][i]], [got["reference"][i]])
        ev_warm, ev_cold = got["port"]
        assert ev_warm["warm_source"].startswith("near(")
        assert ev_cold["warm_source"] == "cold"
        assert ev_warm["n_tests"] == ev_cold["n_tests"] == 6
        assert ev_warm["value"] > ev_cold["value"]

    def test_exact_signature_hit_is_labelled(self):
        fp_b = tw.WorkloadFingerprint(*self.FP_B)
        sig = tw.fingerprint_sig(fp_b)
        rt = _retuner("port", budget=6, cooldown=1000)
        rt._candidates = lambda: {
            sig: {"config": tspace.serve_knob_space(48, 8).default_config(),
                  "value": 1.0}}
        assert rt.retune(fp_b, step=0)["warm_source"] == "exact"

    def test_retune_updates_baseline_and_active_config(self):
        rt = _retuner("port", cooldown=1000)
        fp_b = tw.WorkloadFingerprint(*self.FP_B)
        ev = rt.retune(fp_b, step=5)
        assert rt.baseline == fp_b
        assert rt.active_config == ev["config"]
        assert rt.tests_spent == ev["n_tests"]
        assert tw.fingerprint_distance(fp_b, rt.baseline) == 0.0


class TestAcceptanceRate:
    @pytest.mark.parametrize("drafted,accepted", [(0, 0), (5, 0), (8, 6)])
    def test_matches_reference(self, drafted, accepted):
        got = GenerationResult([], 0.0, 0.0, 0, drafted=drafted,
                               accepted=accepted).acceptance_rate
        want = JGenerationResult([], 0.0, 0.0, 0, drafted=drafted,
                                 accepted=accepted).acceptance_rate
        assert got == want or math.isnan(got) and math.isnan(want)
        assert math.isnan(got) == (drafted == 0)


# ---------------------------------------------------------------------------
# the engine's retune path against the reference engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines(tiny_engine_parts):  # noqa: F811
    """The reference test's tiny model on both sides, same weights."""
    jm, jp, jcfg = tiny_engine_parts
    cfg = port_cfg(jcfg)
    return jm, jp, Model(cfg, device="cpu"), params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _serve(side, engines, prompts, max_new, cache_path, monkeypatch,
           **overrides):
    """The reference test's ``_serve`` for either side (into the cache
    file ``cache_path``)."""
    jm, jp, model, params = engines
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(cache_path))
    jautotune.reset_default_cache()
    tautotune.reset_default_cache()
    base = dict(max_seq=48, batch_slots=8, kv_layout="paged", seed=0,
                prefill_chunk=8, slot_cap=3)
    base.update(overrides)
    try:
        if side == "reference":
            eng = JaxServeEngine(jm, jp, JaxServeConfig(**base))
        else:
            eng = ServeEngine(model, params, ServeConfig(**base),
                              device="cpu")
        return eng, eng.generate(prompts, max_new)
    finally:
        jautotune.reset_default_cache()
        tautotune.reset_default_cache()


def _phase_a_sig(side, engines, tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    pa = [rng.integers(1, 500, size=20).tolist() for _ in range(6)]
    eng, _ = _serve(side, engines, pa, [12] * 6, tmp_path / f"a-{side}.json",
                    monkeypatch, retune=True, retune_threshold=10.0,
                    retune_min_requests=6, retune_window=10)
    return SIDES[side][0].fingerprint_sig(eng.last_retuner.baseline)


def _drift_runs(engines, tmp_path, monkeypatch):
    """{side: (engine, result)} of the drifting trace, each anchored on
    its own phase-A signature (which must be the reference's)."""
    sigs = {s: _phase_a_sig(s, engines, tmp_path, monkeypatch)
            for s in SIDES}
    assert sigs["port"] == sigs["reference"]
    prompts, max_new = _drift_workload()
    return {s: _serve(s, engines, prompts, max_new, tmp_path / f"{s}.json",
                      monkeypatch, tuned_signature=sigs[s], **RETUNE_KW)
            for s in SIDES}


def _assert_tokens_and_counts(got, want):
    assert got.tokens == want.tokens
    assert {c: getattr(got, c) for c in COUNTS} == \
        {c: getattr(want, c) for c in COUNTS}


def test_engine_retune_tokens_and_counts_match_reference(
        engines, tmp_path, monkeypatch):
    """No patch: the port prices attention by its Hopper model, and the
    tokens, steps and work counts still equal the reference's; the swap
    fires once past the threshold, leaves the pool balanced and keeps the
    tokens of the run without retuning."""
    runs = _drift_runs(engines, tmp_path, monkeypatch)
    (eng, got), (_, want) = runs["port"], runs["reference"]
    _assert_tokens_and_counts(got, want)
    assert len(got.retunes) == 1
    ev = got.retunes[0]
    assert ev["distance"] > 0.3 and ev["applied"]
    assert ev["step"] == want.retunes[0]["step"]
    assert ev["signature"] == want.retunes[0]["signature"]
    eng.last_alloc.check_balanced()
    assert eng.last_alloc.groups_in_use == 0
    assert math.isfinite(ev["measured_accept"])
    assert abs(ev["spec_accept"] - ev["measured_accept"]) <= 0.1
    _, base = _serve("port", engines, *_drift_workload(),
                     tmp_path / "base.json", monkeypatch)
    assert got.tokens == base.tokens


def test_engine_retune_events_match_reference_under_the_same_attention(
        engines, tmp_path, monkeypatch, same_attention):  # noqa: F811
    runs = _drift_runs(engines, tmp_path, monkeypatch)
    (eng, got), (jeng, want) = runs["port"], runs["reference"]
    _assert_tokens_and_counts(got, want)
    _events_equal(got.retunes, want.retunes)
    assert len(got.retunes) == 1
    # the swap mutates the engine's config in place, in both packages
    assert dataclasses.asdict(eng.cfg) == {
        k: v for k, v in dataclasses.asdict(jeng.cfg).items()
        if k in {f.name for f in dataclasses.fields(ServeConfig)}}
    assert eng.cfg.draft_len == got.retunes[0]["config"]["draft_len"]


def test_retune_step_is_deterministic(engines, tmp_path, monkeypatch):
    sig = _phase_a_sig("port", engines, tmp_path, monkeypatch)
    prompts, max_new = _drift_workload()
    runs = [_serve("port", engines, prompts, max_new,
                   tmp_path / f"d{i}.json", monkeypatch,
                   tuned_signature=sig, **RETUNE_KW)[1] for i in range(2)]
    assert [e["step"] for e in runs[0].retunes] == \
        [e["step"] for e in runs[1].retunes]
    assert runs[0].retunes[0]["config"] == runs[1].retunes[0]["config"]
    assert runs[0].tokens == runs[1].tokens


def test_anchor_without_acceptance_triggers_on_the_trace_alone(
        engines, tmp_path, monkeypatch):
    """An anchor with its acceptance unset (``x?``) makes the distance skip
    that term, so the swap's step and distance, and every fingerprint
    field but the acceptance, depend on the trace alone: two sets of
    weights, which accept different shares of the n-gram probe, swap at
    the same step and distance."""
    sig = _phase_a_sig("port", engines, tmp_path, monkeypatch)
    anchor = tw.fingerprint_sig(dataclasses.replace(
        tw.parse_sig(sig), accept_rate=float("nan")))
    assert anchor.endswith("_x?") and anchor != sig
    jm, jp, model, params = engines
    runs = [_serve("port", (jm, jp, model, p), *_drift_workload(),
                   tmp_path / f"w{i}.json", monkeypatch,
                   tuned_signature=anchor, **RETUNE_KW)[1].retunes
            for i, p in enumerate((params, model.init(11)))]
    assert len(runs[0]) >= 1 and len(runs[1]) >= 1
    a, b = runs[0][0], runs[1][0]
    assert a["distance"] > RETUNE_KW["retune_threshold"]
    assert (a["step"], a["distance"]) == (b["step"], b["distance"])
    assert a["measured_accept"] != b["measured_accept"]
    assert {k: v for k, v in a["fingerprint"].items() if k != "accept_rate"} \
        == {k: v for k, v in b["fingerprint"].items() if k != "accept_rate"}


def test_winner_persists_under_model_sm90(engines, tmp_path, monkeypatch):
    """Both engines retune into one cache file: the port's winner lands
    under ``model-sm90`` at its signature, and the reference's ``cpu``
    entries are left byte for byte (nor does the port warm-start from
    them: its scan reads its own backend only)."""
    sig = _phase_a_sig("reference", engines, tmp_path, monkeypatch)
    prompts, max_new = _drift_workload()
    path = tmp_path / "shared.json"
    _, want = _serve("reference", engines, prompts, max_new, path,
                     monkeypatch, tuned_signature=sig, **RETUNE_KW)
    before = json.loads(path.read_text())
    cpu_before = {k: json.dumps(v, sort_keys=True)
                  for k, v in before.items() if "|cpu|" in k}
    assert cpu_before
    _, got = _serve("port", engines, prompts, max_new, path, monkeypatch,
                    tuned_signature=sig, **RETUNE_KW)
    after = json.loads(path.read_text())
    assert {k: json.dumps(v, sort_keys=True) for k, v in after.items()
            if "|cpu|" in k} == cpu_before
    ev = got.retunes[0]
    assert ev["warm_source"] == "cold"
    mcfg = engines[2].cfg
    dims = {"S": 48, "H": mcfg.n_heads, "KV": mcfg.n_kv_heads,
            "D": mcfg.head_dim_}
    cands = tautotune.serve_config_candidates(
        dims, mcfg.compute_dtype, cache=tautotune.AutotuneCache(str(path)),
        backend="model-sm90")
    entry = cands[ev["signature"]]
    assert entry["config"] == ev["config"]
    assert entry["meta"]["source"] == "online_retune"
    assert not any("|cuda-sm90|" in k for k in after)


def test_slot_cap_caps_admission_not_tokens(engines, tmp_path, monkeypatch):
    prompts, max_new = _drift_workload()
    res = {cap: _serve("port", engines, prompts, max_new,
                       tmp_path / f"cap{cap}.json", monkeypatch,
                       slot_cap=cap)[1] for cap in (2, None)}
    _, want = _serve("reference", engines, prompts, max_new,
                     tmp_path / "ref2.json", monkeypatch, slot_cap=2)
    assert res[2].tokens == res[None].tokens
    assert res[2].steps > res[None].steps
    _assert_tokens_and_counts(res[2], want)


def test_engine_retune_through_preemption_and_swaps_matches_reference(
        engines, tmp_path, monkeypatch, same_attention):  # noqa: F811
    """An on_demand pool too small for the trace preempts twice while a
    low threshold retunes seven times, swapping the page policy back to
    reserve (the on_demand latch holds) and the schedule to sjf: tokens,
    counts, per-request preemptions and every event equal the
    reference's; a re-admitted request is not recorded twice in the
    window (else the fingerprints would differ)."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 500, size=n).tolist()
               for n in (3, 4, 5, 4, 3, 6, 2, 3)]
    max_new = [14, 12, 16, 13, 18, 12, 3, 2]
    kw = dict(max_seq=32, batch_slots=3, prefill_chunk=4, kv_cache_pages=4,
              page_policy="on_demand", slot_cap=None, retune=True,
              retune_budget=6, retune_threshold=0.05, retune_window=4,
              retune_cooldown=4, retune_check_every=1,
              retune_min_requests=3)
    runs = {s: _serve(s, engines, prompts, max_new, tmp_path / f"{s}.json",
                      monkeypatch, **kw) for s in SIDES}
    (eng, got), (jeng, want) = runs["port"], runs["reference"]
    _assert_tokens_and_counts(got, want)
    assert [r["preemptions"] for r in got.per_request] == \
        [r["preemptions"] for r in want.per_request]
    assert got.preemptions == 2
    _events_equal(got.retunes, want.retunes)
    moved = [k for e in got.retunes for k in e["applied"]]
    assert "page_policy" in moved and "schedule" in moved
    assert eng.cfg.page_policy == jeng.cfg.page_policy == "reserve"
    eng.last_alloc.check_balanced()
    assert eng.last_alloc.groups_in_use == 0

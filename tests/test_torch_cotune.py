"""The port's co-deployment surrogate (``repro_torch.serve.space``), its
serve feasibility model and the cache's serve/train entries, against the
reference's.

* ``serve_knob_space``, ``apply_serve_knobs`` and ``serve_feasibility``
  give the reference's spaces, ``ServeConfig`` fields and verdicts over
  random configs.
* ``coupled_serve_metrics`` equals the reference's exactly when both
  sides price a decode step's attention by the same function (the port
  prices it by its Hopper cost model, the reference by its TPU roofline
  and a VMEM spill term: that function is the one change of substance),
  under every page policy, prefix sharing and drafts; ``make_cotune_sut``
  gives the reference's trial stream when both sides get the same kernel
  space and the same coupling.
* ``TestSurrogateRankAgreement`` (``tests/test_continuous_batching.py``)
  against the port's engine counts, and the port's own Hopper coupling.
* The cache's mesh scans and the serve/train entries of the autotune
  API, keyed under the port's backends.
"""
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro import autotune as jautotune
from repro.analysis.feasibility import serve_feasibility as j_serve_feas
from repro.serve import ServeConfig as JServeConfig
from repro.serve import space as jspace
from repro_torch import autotune as tautotune
from repro_torch.analysis.feasibility import serve_feasibility as t_serve_feas
from repro_torch.configs import ModelConfig
from repro_torch.models import Model
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve import space as tspace

torch.set_num_threads(1)

SIDES = {"reference": (jspace, jcore, JServeConfig, j_serve_feas),
         "port": (tspace, tcore, ServeConfig, t_serve_feas)}
WINDOWS = [(128, 8), (256, 16), (2048, 64)]


def _random_configs(space, n, seed):
    return space.from_unit_matrix(np.random.default_rng(seed).random(
        (n, space.dim)))


@pytest.mark.parametrize("max_seq,max_slots", WINDOWS)
def test_serve_knob_space_matches_reference(max_seq, max_slots):
    js = jspace.serve_knob_space(max_seq, max_slots)
    ts = tspace.serve_knob_space(max_seq, max_slots)
    assert ts.names == js.names
    assert ts.default_config() == js.default_config()
    assert _random_configs(ts, 200, max_seq) == _random_configs(
        js, 200, max_seq)


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("max_seq,max_slots", WINDOWS)
def test_apply_serve_knobs_matches_reference(max_seq, max_slots, layout):
    """Every field of the deployed ``ServeConfig`` (the pages raised to
    the floor where the tuned pool is below it) equals the reference's."""
    configs = _random_configs(jspace.serve_knob_space(max_seq, max_slots),
                              64, max_seq + 1)
    configs.append({"max_batch": 4, "prefill_chunk": 256,
                    "kv_cache_pages": 2048, "schedule": "sjf"})
    for cfg in configs:
        out = {}
        for side, (sp, _, SC, _) in SIDES.items():
            base = SC(max_seq=max_seq, kv_layout=layout,
                      batch_slots=max_slots,
                      runtime="continuous")
            out[side] = dataclasses.asdict(sp.apply_serve_knobs(cfg, base))
        assert out["port"] == out["reference"], cfg
    # a tuned pool below the floor is raised and counted (and warned
    # about once a process)
    before = tspace.kv_floor_raise_count()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        dep = tspace.apply_serve_knobs(
            {"max_batch": 64, "prefill_chunk": 512, "kv_cache_pages": 128,
             "schedule": "fifo"})
    assert dep.kv_cache_pages * tspace.PAGE_TOKENS >= 64 * dep.max_seq
    assert tspace.kv_floor_raise_count() == before + 1


@pytest.mark.parametrize("layout,block", [("paged", 1), ("paged", 4),
                                          ("dense", 1)])
def test_serve_feasibility_matches_reference(layout, block):
    max_seq = 256
    configs = _random_configs(tspace.serve_knob_space(max_seq, 16), 100, 9)
    configs += [dict(configs[0], kv_cache_pages=p) for p in (1, 16, 17, 20)]
    got = {}
    for side, (_, _, _, feas) in SIDES.items():
        model = feas(max_seq, runtime="continuous", kv_layout=layout,
                     kv_page_block=block, n_devices=1, n_heads=4,
                     n_kv_heads=2)
        got[side] = [(model(c), [(v.predicate, v.reason, v.severity)
                                 for v in model.check(c)]) for c in configs]
    assert got["port"] == got["reference"]
    assert any(not ok for ok, _ in got["port"])  # the floor prunes


def test_multi_device_raises():
    with pytest.raises(NotImplementedError, match="multi-device"):
        t_serve_feas(2048, n_devices=2)
    with pytest.raises(NotImplementedError, match="multi-device"):
        tspace.serve_knob_space(2048, max_devices=2)
    with pytest.raises(NotImplementedError, match="multi-device"):
        tspace.make_cotune_sut(max_devices=4)


def _shared_attn(kernel_cfg, batch, p):
    """One attention-time function for both sides: it reads only fields
    both ``CotuneParams`` have."""
    bk = int(kernel_cfg["block_kv"]) or 256
    return 1e-6 * batch * p.max_seq / 256.0 * (1.0 + 32.0 / bk) + 2e-6


@pytest.fixture
def same_attention(monkeypatch):
    monkeypatch.setattr(jspace, "_attn_step_seconds", _shared_attn)
    monkeypatch.setattr(tspace, "_attn_step_seconds", _shared_attn)


WORKLOADS = [dict(), dict(prompt_len=64, gen_len=16, max_seq=256,
                          n_requests=16),
             dict(prompt_len=32, gen_len=96, max_seq=256, n_requests=16,
                  spec_accept=0.0),
             dict(prefix_share_frac=0.6, spec_accept=0.9, sla_s=0.1)]


@pytest.mark.parametrize("work", range(len(WORKLOADS)))
def test_coupled_metrics_equal_under_the_same_attention(same_attention,
                                                        work):
    jp = jspace.CotuneParams(**WORKLOADS[work])
    tp = tspace.CotuneParams(**WORKLOADS[work])
    configs = _random_configs(tspace.serve_knob_space(tp.max_seq), 300,
                              work)
    # every page policy, sharing and draft length, on small pools too
    configs += [dict(configs[0], page_policy=pol, share_prefix=sh,
                     draft_len=k, kv_cache_pages=pg, schedule=s)
                for pol in ("reserve", "on_demand") for sh in (0, 1)
                for k in (0, 2, 8) for pg in (3, 21, 256)
                for s in ("fifo", "interleave")]
    kcfgs = [{"block_kv": b} for b in (0, 32, 256, 1024)]
    for i, cfg in enumerate(configs):
        kcfg = kcfgs[i % len(kcfgs)]
        want = jspace.coupled_serve_metrics(cfg, kcfg, jp)
        got = tspace.coupled_serve_metrics(cfg, kcfg, tp)
        assert (got.value, got.higher_is_better, got.metrics) == (
            want.value, want.higher_is_better, want.metrics), cfg


def _fake_kernel_sut(core):
    """The same kernel member on both sides: the port's decode space
    (``block_kv``) and a deterministic cost."""

    class FakeKernelSUT:
        def __init__(self, kernel, dims, dtype="float32", **kw):
            self.dims = dims
            self.name = f"fake[{kernel}]"

        def space(self):
            return core.ParameterSpace([core.EnumParam(
                "block_kv", (0, 32, 64, 128, 256, 512, 1024), 0)])

        def test_batch(self, configs):
            return [core.PerfMetric(_shared_attn(c, self.dims["B"],
                                                 tspace.CotuneParams()),
                                    higher_is_better=False)
                    for c in configs]

    return FakeKernelSUT


@pytest.mark.parametrize("batch", [True, False],
                         ids=["batched", "sequential"])
@pytest.mark.parametrize("seed", [0, 2])
def test_joint_surrogate_stream_matches_reference(same_attention,
                                                  monkeypatch, seed, batch):
    """``make_cotune_sut`` (config-only serve member, kernel member,
    coupling scalarizer, serve feasibility) gives the reference's trial
    stream when both sides get the same kernel space and coupling."""
    monkeypatch.setattr("repro.autotune.sut.KernelSUT",
                        _fake_kernel_sut(jcore))
    monkeypatch.setattr("repro_torch.autotune.sut.KernelSUT",
                        _fake_kernel_sut(tcore))
    reps = {}
    for side, (sp, core, _, _) in SIDES.items():
        sut = sp.make_cotune_sut(sp.CotuneParams(max_seq=512))
        reps[side] = core.Tuner(sut.space(), sut, budget=60, seed=seed,
                                optimizer="subspace_rr", batch=batch).run()
    stream = {s: [(t.test_index, t.phase, t.value, sorted(t.config.items()))
                  for t in r.history] for s, r in reps.items()}
    assert stream["port"] == stream["reference"]
    assert reps["port"].n_infeasible_pruned == \
        reps["reference"].n_infeasible_pruned


def test_cotune_parity_through_composite():
    """The port's own joint surrogate (its Hopper coupling): batched and
    sequential runs of one seed score the identical trial sequence."""
    reps = []
    for batch in (True, False):
        sut = tspace.make_cotune_sut(tspace.CotuneParams())
        reps.append(tcore.Tuner(sut.space(), sut, budget=50, seed=2,
                                optimizer="subspace_rr", batch=batch).run())
    assert [t.config for t in reps[0].history] == \
        [t.config for t in reps[1].history]
    assert reps[0].best_metric.value == reps[1].best_metric.value


class TestHopperCoupling:
    """The port prices a decode step's attention by its Hopper cost model
    of the dense decode kernel, without the reference's VMEM spill term.
    The reference's claim that a faster kernel moves the serve optimum to
    a larger batch (``tests/test_composite.py::test_deterministic_and_
    coupled``) does not hold on it: attention is a few percent of the
    modelled decode step, and every kernel config leaves the best batch
    where it was (``PERF.md``, section 6).  The coupling that remains: the
    serve value follows the kernel's cost at the resident batch."""

    def _best_batch(self, kernel_cfg):
        p = tspace.CotuneParams()
        space = tspace.serve_knob_space(p.max_seq)
        base = space.default_config()
        vals = {}
        for B in (4, 8, 12, 16, 24, 32):
            cfg = dict(base, max_batch=B,
                       kv_cache_pages=max(space["kv_cache_pages"].lo,
                                          B * p.max_seq // 16))
            vals[B] = tspace.coupled_serve_metrics(cfg, kernel_cfg, p)
        return max(vals, key=lambda b: vals[b].value), vals

    def test_optimum_batch_does_not_move_with_the_kernel(self):
        best = {bk: self._best_batch({"block_kv": bk})[0]
                for bk in (0, 32, 64, 256, 1024)}
        assert set(best.values()) == {32}

    def test_value_follows_the_kernel_cost(self):
        p = tspace.CotuneParams()
        for bk_slow, bk_fast in ((32, 0), (64, 1024)):
            slow = self._best_batch({"block_kv": bk_slow})[1]
            fast = self._best_batch({"block_kv": bk_fast})[1]
            for B in (16, 24, 32):
                t_slow = tspace._attn_step_seconds(
                    {"block_kv": bk_slow}, B, p)
                t_fast = tspace._attn_step_seconds(
                    {"block_kv": bk_fast}, B, p)
                assert t_slow > t_fast
                assert slow[B].value < fast[B].value
                assert slow[B].metrics["attn_s"] == pytest.approx(
                    p.n_layers * t_slow)
        m1 = tspace.coupled_serve_metrics(
            tspace.serve_knob_space().default_config(), {"block_kv": 256}, p)
        m2 = tspace.coupled_serve_metrics(
            dict(tspace.serve_knob_space().default_config()),
            {"block_kv": 256}, p)
        assert m1.value == m2.value

    @pytest.mark.parametrize("seed", [0, 1])
    def test_joint_beats_independent_at_equal_budget(self, seed):
        """The tentpole claim at the reference test's budget (160), on
        the port's coupling."""
        p = tspace.CotuneParams()
        budget = 160
        half = budget // 2
        ksut = tautotune.KernelSUT("decode_attention", p.decode_dims(8),
                                   dtype=p.dtype, device="cpu")
        krep = tcore.Tuner(ksut.space(), ksut, budget=half, seed=seed).run()
        srep = tcore.Tuner(tspace.serve_knob_space(p.max_seq),
                           tspace.ServeSurrogate(p), budget=budget - half,
                           seed=seed).run()
        indep = tspace.coupled_serve_metrics(srep.best_config,
                                             krep.best_config, p)
        sut = tspace.make_cotune_sut(p)
        jrep = tcore.Tuner(sut.space(), sut, budget=budget, seed=seed,
                           optimizer="subspace_rr").run()
        parts = sut.space().split(jrep.best_config)
        joint = tspace.coupled_serve_metrics(parts["serve"],
                                             parts["kernel"], p)
        assert joint.objective() <= indep.objective()


def test_cotune_params_from_model_reads_n_heads():
    from repro_torch.configs import get_config

    cfg = get_config("gemma-7b")
    p = tspace.CotuneParams.from_model(cfg, max_seq=4096)
    assert (p.heads, p.kv_heads, p.head_dim, p.n_layers, p.dtype) == (
        cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.n_layers,
        cfg.compute_dtype)
    assert p.sla_s == pytest.approx(0.55 * 2)
    assert p.decode_dims(8) == {"B": 8, "S": 4096, "H": 16, "KV": 16,
                                "D": 256}
    assert p.kernel_space().names == ["block_kv"]
    fp = type("FP", (), dict(prompt_mean=40.4, gen_mean=9.6,
                             prompt_spread=1.7, depth=3.2,
                             share_frac=float("nan"), accept_rate=0.5))
    assert tspace.params_for_fingerprint(fp, p) == dataclasses.replace(
        p, prompt_len=40, gen_len=10, prompt_spread=1.0, n_requests=3,
        spec_accept=0.5)


# ---------------------------------------------------------------------------
# TestSurrogateRankAgreement against the port's engine
# ---------------------------------------------------------------------------
TINY = ModelConfig(
    name="tiny-lm", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
    param_dtype="float32", compute_dtype="float32", vocab_pad_multiple=64,
    rope_theta=10_000.0,
)
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5], [2, 2, 2],
           [7, 1, 4, 1, 5, 9, 2, 6], [3, 3], [5, 4, 3, 2, 1, 6]]
MAX_NEW = [6, 3, 5, 2, 7, 4]


@pytest.fixture(scope="module")
def engine():
    model = Model(TINY, device="cpu")
    return model, model.init(0)


def _cfg(**kw):
    base = dict(max_seq=32, batch_slots=2, runtime="continuous",
                prefill_chunk=4, kv_layout="paged")
    base.update(kw)
    return ServeConfig(**base)


class TestSurrogateRankAgreement:
    """The port's surrogate ranks configs as the port's engine does, on
    the runtime's noise-free counters where possible (the reference's
    ``tests/test_continuous_batching.py::TestSurrogateRankAgreement``)."""

    def _surrogate(self, schedule, pages, p=None, policy="reserve"):
        p = p or tspace.CotuneParams(prompt_len=64, gen_len=16, max_seq=256,
                                     n_requests=16)
        cfg = tspace.serve_knob_space(p.max_seq).default_config()
        cfg["schedule"] = schedule
        cfg["kv_cache_pages"] = pages
        cfg["page_policy"] = policy
        return tspace.coupled_serve_metrics(cfg, p.default_kernel_config(),
                                            p)

    def test_pages_rank_agreement(self, engine):
        model, params = engine
        steps = {}
        for pages in (3, 8):
            eng = ServeEngine(model, params, _cfg(
                batch_slots=3, kv_cache_pages=pages), device="cpu")
            steps[pages] = eng.generate(PROMPTS, MAX_NEW).steps
        assert steps[3] > steps[8]
        lo = self._surrogate("fifo", pages=2)
        hi = self._surrogate("fifo", pages=16)
        assert lo.value < hi.value
        assert lo.metrics["resident"] < hi.metrics["resident"]

    def test_page_policy_rank_agreement(self, engine):
        model, params = engine
        heavy = ([[1, 2, 3], [9, 8, 7, 6], [2, 2, 2, 2, 2], [7, 1, 4, 1],
                  [3, 3, 3], [5, 4, 3, 2, 1, 6]], [14, 12, 16, 13, 18, 12])
        steps = {}
        for policy in ("reserve", "on_demand"):
            eng = ServeEngine(model, params, _cfg(
                batch_slots=3, kv_cache_pages=4, page_policy=policy),
                device="cpu")
            steps[policy] = eng.generate(*heavy).steps
        assert steps["on_demand"] < steps["reserve"]
        p = tspace.CotuneParams(prompt_len=32, gen_len=96, max_seq=256,
                                n_requests=16)
        small_od = self._surrogate("fifo", 21, p, "on_demand")
        small_rs = self._surrogate("fifo", 21, p, "reserve")
        assert small_od.value > small_rs.value
        assert small_od.metrics["resident"] > small_rs.metrics["resident"]
        assert small_od.metrics["preempt_frac"] > 0
        big_od = self._surrogate("fifo", 256, p, "on_demand")
        big_rs = self._surrogate("fifo", 256, p, "reserve")
        assert big_rs.value > big_od.value
        assert big_od.metrics["preempt_frac"] == 0
        assert big_od.metrics["resident"] == big_rs.metrics["resident"]

    def test_sjf_rank_agreement_on_mean_latency(self, engine):
        model, params = engine
        prompts = [[7] * 24] + [[i + 1, 2, 3] for i in range(4)]
        res = {}
        for sched in ("fifo", "sjf"):
            eng = ServeEngine(model, params, _cfg(
                batch_slots=1, schedule=sched, prefill_chunk=8),
                device="cpu")
            res[sched] = eng.generate(prompts, [4] * 5)
        order = {s: [r["rid"] for r in sorted(
            res[s].per_request, key=lambda r: r["latency_s"])] for s in res}
        # sjf finishes the four short prompts before the long one
        assert order["sjf"][-1] == 0 and order["fifo"][0] == 0
        # Mean latency counted in dispatches, not wall-clock seconds (host
        # noise moves those).  batch_slots=1 serialises the requests: each
        # costs ceil(len / prefill_chunk) prefill chunks and max_new - 1
        # decode steps (its first token comes from prefill), and finishes
        # after its own and those of every request before it
        cost = {i: -(-len(p) // 8) + 4 - 1 for i, p in enumerate(prompts)}
        mean = {}
        for s in res:
            finish = np.cumsum([cost[rid] for rid in order[s]])
            assert finish[-1] == res[s].prefill_chunks + res[s].steps
            mean[s] = float(np.mean(finish))
        assert mean["sjf"] < mean["fifo"]
        assert res["sjf"].steps == res["fifo"].steps
        s_f = self._surrogate("fifo", pages=64)
        s_s = self._surrogate("sjf", pages=64)
        assert s_s.metrics["latency_s"] < s_f.metrics["latency_s"]
        assert s_s.metrics["raw_throughput"] == \
            s_f.metrics["raw_throughput"]

    def test_interleave_rank_agreement_on_overlap(self, engine):
        model, params = engine
        out = {}
        for sched in ("fifo", "interleave"):
            eng = ServeEngine(model, params, _cfg(schedule=sched),
                              device="cpu")
            out[sched] = eng.generate([[1, 2, 3], [9] * 24], [12, 2])
        assert out["interleave"].tokens == out["fifo"].tokens
        s_f = self._surrogate("fifo", pages=64)
        s_i = self._surrogate("interleave", pages=64)
        assert s_i.metrics["raw_throughput"] >= s_f.metrics["raw_throughput"]


# ---------------------------------------------------------------------------
# the cache's mesh scans and the serve / train entries
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("a,b", [("1dev", "1dev"), ("d2m1", "d1m2"),
                                 ("d1m4", "1dev"), ("d4m2", "d1m1"),
                                 ("bogus", "1dev")])
def test_mesh_distance_matches_reference(a, b):
    from repro.autotune.cache import mesh_distance as jmd

    assert tautotune.mesh_distance(a, b) == jmd(a, b)


def test_nearest_mesh_matches_reference():
    from repro.autotune.cache import nearest_mesh as jnm

    for cands, target in ((["d1m2", "d2m1", "d1m8"], "d1m4"),
                          (["x", "y"], "1dev"), ([], "1dev"),
                          (["d1m2", "d1m8"], "d1m4")):
        assert tautotune.nearest_mesh(cands, target) == jnm(cands, target)


def _fill(pkg, cache, backend):
    dims = {"S": 128, "H": 4, "KV": 4, "D": 16}
    pkg.put_serve_config(dims, "float32", {"max_batch": 2}, 1.0,
                         cache=cache, backend=backend)
    pkg.put_serve_config(dims, "float32", {"max_batch": 4}, 2.0,
                         cache=cache, backend=backend, workload="w1")
    pkg.put_serve_config(dims, "float32", {"max_batch": 8}, 3.0,
                         cache=cache, backend=backend, mesh=(1, 2))
    pkg.put_serve_config(dims, "float32", {"max_batch": 16}, 4.0,
                         cache=cache, backend=backend, mesh="d4m1")
    pkg.put_train_config(dict(dims, S=32, B=8), "float32",
                         {"microbatches": 2}, 5.0, cache=cache,
                         backend=backend, meta={"mode": "x"})
    return dims


def test_serve_and_train_entries_match_reference(tmp_path):
    """The same calls give the same file contents in both packages (the
    port keyed under its own backend), and the same reads back."""
    out = {}
    for name, pkg, backend in (("reference", jautotune, "cpu"),
                               ("port", tautotune, "model-sm90")):
        path = str(tmp_path / f"{name}.json")
        cache = pkg.AutotuneCache(path)
        dims = _fill(pkg, cache, backend)
        reads = (
            pkg.cached_serve_config(dims, "float32", cache=cache,
                                    backend=backend),
            pkg.cached_serve_config(dims, "float32", cache=cache,
                                    backend=backend, workload="w1"),
            pkg.cached_serve_config(dims, "float32", cache=cache,
                                    backend=backend, mesh="d1m2"),
            sorted(pkg.serve_config_candidates(dims, "float32", cache=cache,
                                               backend=backend)),
            pkg.nearest_mesh_serve_config(dims, "float32", "d1m4",
                                          cache=cache, backend=backend),
            pkg.nearest_mesh_serve_config(dims, "float32", "",
                                          cache=cache, backend=backend),
            pkg.cached_train_config(dict(dims, S=32, B=8), "float32",
                                    cache=cache, backend=backend),
            sorted(cache.scan_meshes(pkg.SERVE_SYSTEM, "D16_H4_KV4_S128",
                                     "float32", backend)),
        )
        raw = json.load(open(path))
        keys = sorted(k.replace(f"|{backend}|", "|B|") for k in raw)
        for r in reads:
            if isinstance(r, dict):
                r.pop("updated", None)
        out[name] = (reads[:3] + reads[3:4] + reads[6:], keys,
                     [{k: v for k, v in (r or {}).items()
                       if k not in ("updated", "time")} for r in reads[4:6]])
    assert out["port"] == out["reference"]
    assert tautotune.SERVE_SYSTEM == jautotune.SERVE_SYSTEM
    assert tautotune.TRAIN_SYSTEM == jautotune.TRAIN_SYSTEM


def test_serve_entries_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cache = tautotune.AutotuneCache(str(tmp_path / "c.json"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tautotune.put_serve_config({"S": 1}, "float32", {}, 1.0,
                                   cache=cache)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tautotune.cached_train_config({"S": 1}, "float32", cache=cache)

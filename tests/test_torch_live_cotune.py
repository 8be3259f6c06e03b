"""The live co-tuning path on the CPU: the real engine, the real train step
and the decode kernel's cost model as one ``CompositeSUT``, and the
``--joint`` launcher, against the reference.

* ``LiveServeSUT`` builds the real engine under the candidate knobs and
  wall-clocks it; its prompts and its counts (``prefill_chunks``,
  ``steps``, ``tokens``) equal the reference's ``LiveServeSUT`` on the
  same bridged weights, under each serve knob.
* ``TrainStepSUT`` rebuilds and times the real train step
  (``tests/test_train_serve.py::test_train_step_sut_measures_real_step``).
* ``LiveCotuneScalarizer`` gives the reference's arithmetic.
* ``python -m repro_torch.launch.tune --joint`` and ``--joint --real
  --device cpu`` through ``main()`` at a budget of 4 write their winners
  under ``model-sm90`` and leave the reference's ``cpu`` entries byte for
  byte.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import autotune as jautotune
from repro.core.tuner import PerfMetric as JPerfMetric
from repro.models import Model as JaxModel
from repro.serve import ServeConfig as JServeConfig
from repro.serve import space as jspace
from repro_torch import autotune
from repro_torch.core.sut_torch import TrainStepSUT, median_wall_clock
from repro_torch.core.tuner import PerfMetric, Tuner
from repro_torch.models import Model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve import ServeConfig
from repro_torch.serve import space as tspace
from test_torch_model import port_cfg
from test_torch_train import TINY

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(TINY)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = port_cfg(TINY)
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               "cpu")
    return jm, jp, Model(cfg, device="cpu"), params


KNOBS = [dict(), dict(prefill_chunk=8, schedule="sjf"),
         dict(prefill_chunk=4, schedule="interleave", max_batch=3),
         dict(page_policy="on_demand", kv_cache_pages=5, max_batch=4),
         dict(share_prefix=1, draft_len=2), dict(draft_len=4, max_batch=1)]


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "-".join(
    f"{a}={b}" for a, b in k.items()) or "defaults")
def test_live_serve_counts_match_reference(pair, knobs):
    jm, jp, model, params = pair
    kw = dict(prompt_len=9, gen_len=6, n_requests=5, warmup=0, repeats=1,
              max_slots=4, seed=3)
    jsut = jspace.LiveServeSUT(
        jm, jp, base=JServeConfig(max_seq=32, kv_layout="paged"), **kw)
    tsut = tspace.LiveServeSUT(
        model, params, base=ServeConfig(max_seq=32, kv_layout="paged"),
        device="cpu", **kw)
    assert tsut.prompts == jsut.prompts
    assert tsut.space().names == jsut.space().names
    cfg = dict(tsut.space().default_config(), **knobs)
    assert tsut.feasibility_model(cfg) == jsut.feasibility_model(cfg)
    want, got = jsut.test(cfg), tsut.test(cfg)
    for key in ("prefill_chunks", "steps", "tokens", "warmup", "repeats"):
        assert got.metrics[key] == want.metrics[key], key
    assert got.metrics["tokens"] == 5 * 6
    assert got.higher_is_better and got.value > 0
    assert got.metrics["latency_s"] > 0 and got.metrics["prefill_s"] > 0


def test_live_serve_sut_measures_real_engine(pair):
    """``tests/test_train_serve.py::test_live_serve_sut_measures_real_
    engine`` on the port: 9-token prompts in chunks of 4 are 3 chunks a
    request on the continuous runtime."""
    _, _, model, params = pair
    sut = tspace.LiveServeSUT(model, params,
                              base=ServeConfig(max_seq=32, kv_layout="paged"),
                              prompt_len=9, gen_len=4, n_requests=2,
                              warmup=1, repeats=1, max_slots=2, device="cpu")
    cfg = dict(sut.space().default_config(), prefill_chunk=4, max_batch=2)
    m = sut.test(cfg)
    assert m.higher_is_better and m.value > 0
    assert m.metrics["latency_s"] > 0
    assert m.metrics["prefill_chunks"] == 6
    assert m.metrics["prefill_s"] > 0
    with pytest.raises(ValueError, match="serving window"):
        tspace.LiveServeSUT(model, params, base=ServeConfig(max_seq=8),
                            prompt_len=9, device="cpu")


def test_train_step_sut_measures_real_step():
    sut = TrainStepSUT(port_cfg(TINY), seq_len=16, global_batch=4, steps=1,
                       warmup=1, repeats=1, device="cpu")
    cfg = dict(sut.space().default_config(), microbatches=2, remat="full",
               compression="int8")
    m = sut.test(cfg)
    assert m.higher_is_better and m.value > 0
    assert m.metrics["step_seconds"] > 0
    assert np.isfinite(m.metrics["loss"])
    assert sut.space().names == ["microbatches", "remat", "attn_block_q",
                                 "attn_block_kv", "compression"]


def test_median_wall_clock_trims_warmup_and_takes_the_median():
    calls = []
    times = iter([0.0, 0.3, 1.0, 1.1, 2.0, 2.5])  # 0.3, 0.1, 0.5 s

    def fn():
        calls.append(1)

    import repro_torch.core.sut_torch as st

    real = st.time.perf_counter
    st.time.perf_counter = lambda: next(times)
    try:
        assert median_wall_clock(fn, warmup=2, repeats=3) == pytest.approx(
            0.3)
    finally:
        st.time.perf_counter = real
    assert len(calls) == 5


@pytest.mark.parametrize("kw", [dict(), dict(sla_s=0.5),
                                dict(sla_s=2.0, train_weight=1.0,
                                     kernel_coupling=0.5),
                                dict(kernel_ref=None)])
def test_live_scalarizer_matches_reference(kw):
    kw = dict(dict(kernel_ref=2e-5), **kw)
    rows = [(1000.0, 1.0, 400.0, 1e-5), (250.0, 0.25, 9000.0, 4e-5)]
    for serve, lat, train, kern in rows:
        out = []
        for Metric, mod in ((JPerfMetric, jspace), (PerfMetric, tspace)):
            metrics = {
                "serve": Metric(serve, metrics={"latency_s": lat,
                                                "prefill_chunks": 3}),
                "train": Metric(train),
                "kernel": Metric(kern, higher_is_better=False)}
            m = mod.LiveCotuneScalarizer(**kw)(metrics, {})
            out.append((m.value, m.higher_is_better, m.metrics))
        assert out[0] == out[1]


def test_make_live_cotune_sut_runs_on_the_cpu():
    """The three members under one budget: the engine and the train step
    timed, the decode kernel scored on the Hopper cost model."""
    sut = tspace.make_live_cotune_sut(
        port_cfg(TINY), max_seq=32, prompt_len=8, gen_len=4, n_requests=3,
        max_slots=2, train_seq=16, train_batch=4, repeats=1, device="cpu")
    assert sut.space().subspace_names == ["serve", "train", "kernel"]
    assert sut.members["kernel"].mode == "model"
    rep = Tuner(sut.space(), sut, budget=3, optimizer="subspace_rr",
                seed=0).run()
    assert rep.n_tests == 3
    for m in (rep.default_metric, rep.best_metric):
        assert set(m.metrics["member_values"]) == {
            "serve", "train", "kernel"}
        assert m.metrics["serve_tput"] > 0
        assert m.metrics["train_tput"] > 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "cache.json")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", path)
    autotune.reset_default_cache()
    jautotune.reset_default_cache()
    yield path
    autotune.reset_default_cache()
    jautotune.reset_default_cache()


@pytest.mark.parametrize("real", [False, True], ids=["surrogate", "real"])
def test_joint_launcher_writes_its_winners(tmp_cache, tmp_path, real):
    from repro_torch.launch.tune import main

    jcache = jautotune.default_cache()
    jcache.put("serve_engine", "D256_H16_KV16_S4096", "bfloat16", "cpu",
               {"max_batch": 8}, 1.5)
    jcache.put("decode_attention", "B8_D16_H4_KV4_S128", "float32", "cpu",
               {"block_kv": 128}, 2.5)

    def reference_entries():
        raw = json.load(open(tmp_cache))
        return {k: json.dumps(v, sort_keys=True) for k, v in raw.items()
                if k.split("|")[4] == "cpu"}

    before = reference_entries()
    argv = ["--arch", "gemma-7b", "--shape", "train_4k", "--joint",
            "--budget", "4", "--out-dir", str(tmp_path / "out")]
    if real:
        argv += ["--real", "--device", "cpu", "--real-repeats", "1"]
    assert main(argv) == 0
    assert reference_entries() == before
    ours = {k.split("|")[1]: k.split("|")
            for k in json.load(open(tmp_cache))
            if k.split("|")[4] == "model-sm90"}
    want = {"decode_attention", "serve_engine"} | (
        {"train_step"} if real else set())
    assert set(ours) == want
    assert all(k[6] == "1dev" for k in ours.values())
    report = json.load(open(tmp_path / "out" / (
        "joint_gemma-7b_train_4k" + ("_real" if real else "") + ".json")))
    assert report["n_tests"] == 4
    cache = autotune.AutotuneCache(tmp_cache)
    if real:
        dims = {"S": 128, "H": 4, "KV": 4, "D": 16}
        dtype = "float32"
        assert autotune.cached_train_config(
            dict(dims, S=32, B=8), dtype, cache=cache,
            backend="model-sm90")["remat"] in ("none", "full", "dots")
    else:
        dims = {"S": 4096, "H": 16, "KV": 16, "D": 256}
        dtype = "bfloat16"
    keys = report["persisted"]
    assert (keys["backend"], keys["dtype"], keys["serve"]) == (
        "model-sm90", dtype, dims)
    assert keys["train"] == (dict(dims, S=32, B=8) if real else None)
    assert autotune.shape_sig(keys["kernel"]) == ours["decode_attention"][2]
    serve = autotune.cached_serve_config(dims, dtype, cache=cache,
                                         backend="model-sm90")
    assert set(serve) == set(tspace.serve_knob_space().names)
    kernel_sig = ours["decode_attention"][2]
    assert f"B{serve['max_batch']}_" in kernel_sig or real


def test_joint_real_defaults_to_the_card(monkeypatch, tmp_cache):
    from repro_torch.launch.tune import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "gemma-7b", "--shape", "train_4k", "--joint",
              "--real", "--budget", "1"])
    for bad in (["--real"], ["--joint", "--real", "--surrogate"]):
        with pytest.raises(SystemExit):
            main(["--arch", "gemma-7b", "--shape", "train_4k", *bad])

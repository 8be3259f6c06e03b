"""The port's paged continuous engine against the reference ``ServeEngine``.

Both engines get the same weights (``params_from_numpy`` of the
reference's init) and the same ``ServeConfig`` values; per-request greedy
tokens must be equal, and so must the count of decode steps and prefill
chunks.  The rest mirrors the paged cases of
``tests/test_continuous_batching.py`` (``TestScheduleParity``,
``TestPagingRuntime``) that fall in the ported slice (fifo, reserve,
greedy), against the reference's one-request-per-wave oracle tokens.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.models import Model as JaxModel
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.models import Model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.paging import PAGE_TOKENS
from test_torch_model import CONFIGS, TINY, port_cfg

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5], [2, 2, 2],
           [7, 1, 4, 1, 5, 9, 2, 6], [3, 3], [5, 4, 3, 2, 1, 6]]
MAX_NEW = [6, 3, 5, 2, 7, 4]


def _models(jcfg):
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               "cpu")
    return jm, jp, Model(cfg, device="cpu"), params


@pytest.fixture(scope="module")
def tiny():
    return _models(TINY)


def _kw(**kw):
    base = dict(max_seq=32, batch_slots=2, runtime="continuous",
                prefill_chunk=4, kv_layout="paged")
    base.update(kw)
    return base


def _port(model, params, **kw):
    return ServeEngine(model, params, ServeConfig(**_kw(**kw)), device="cpu")


@pytest.fixture(scope="module")
def reference_tokens(tiny):
    """Oracle continuations from the reference: wave runtime, one request
    per wave."""
    jm, jp, _, _ = tiny
    eng = JaxServeEngine(jm, jp, JaxServeConfig(
        max_seq=32, batch_slots=1, runtime="wave"))
    return [eng.generate([p], m).tokens[0]
            for p, m in zip(PROMPTS, MAX_NEW)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_matches_reference_engine(name):
    """Same ServeConfig, mixed prompt lengths and max_new: equal tokens,
    equal decode steps, equal prefill chunks."""
    jm, jp, model, params = _models(CONFIGS[name])
    kw = _kw(batch_slots=3)
    want = JaxServeEngine(jm, jp, JaxServeConfig(**kw)).generate(
        PROMPTS, MAX_NEW)
    got = ServeEngine(model, params, ServeConfig(**kw),
                      device="cpu").generate(PROMPTS, MAX_NEW)
    assert got.tokens == want.tokens
    assert got.steps == want.steps
    assert got.prefill_chunks == want.prefill_chunks


def test_serve_config_fields_and_defaults_match_reference():
    """Every reference ServeConfig field exists with the same default, so
    configs carry over (unported values raise at engine build)."""
    want = {f.name: f.default for f in dataclasses.fields(JaxServeConfig)}
    got = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    assert got == want


# --- mirrors of tests/test_continuous_batching.py, paged + fifo ---------
def test_tokens_match_reference_oracle(tiny, reference_tokens):
    _, _, model, params = tiny
    assert _port(model, params).generate(
        PROMPTS, MAX_NEW).tokens == reference_tokens


@pytest.mark.parametrize("slots", [1, 3])
def test_slot_count_invariance(tiny, reference_tokens, slots):
    """More slots change concurrency, not content."""
    _, _, model, params = tiny
    eng = _port(model, params, batch_slots=slots)
    assert eng.generate(PROMPTS, MAX_NEW).tokens == reference_tokens


def test_eos_frees_slot_early(tiny):
    _, _, model, params = tiny
    eos = _port(model, params, batch_slots=1).generate(
        [[3, 1, 4]], 1).tokens[0][0]
    res = _port(model, params, batch_slots=1, eos_token=int(eos)).generate(
        [[3, 1, 4], [1, 2, 3, 4]], [8, 2])
    assert res.tokens[0] == [eos]
    assert len(res.tokens[1]) == 2


def test_no_page_leaks_after_mixed_run(tiny):
    _, _, model, params = tiny
    eng = _port(model, params, batch_slots=3)
    eng.generate(PROMPTS, MAX_NEW)
    alloc = eng.last_alloc
    assert alloc.groups_in_use == 0  # every completion released
    assert alloc.high_water > 0
    alloc.check_balanced()


def test_small_pool_bounds_concurrency_not_tokens(tiny, reference_tokens):
    """A pool big enough for about one request serializes admission but
    generates the same tokens, in more decode steps."""
    _, _, model, params = tiny
    small = _port(model, params, batch_slots=3, kv_cache_pages=3)
    big = _port(model, params, batch_slots=3)
    rs, rb = (e.generate(PROMPTS, MAX_NEW) for e in (small, big))
    assert rs.tokens == rb.tokens == reference_tokens
    assert rs.steps > rb.steps
    assert small.last_alloc.high_water <= 2


def test_undersized_pool_rejected_at_config():
    with pytest.raises(ValueError, match="KV cache too small"):
        ServeConfig(max_seq=64, runtime="continuous", kv_layout="paged",
                    kv_cache_pages=2)


def test_unknown_runtime_and_layout_rejected():
    with pytest.raises(ValueError, match="unknown runtime"):
        ServeConfig(runtime="batch")
    with pytest.raises(ValueError, match="unknown kv_layout"):
        ServeConfig(kv_layout="ring")


def test_grouped_pool_layout(tiny, reference_tokens):
    """kv_page_block > 1 coarsens the allocator's groups (the pool's token
    tile) without touching tokens."""
    _, _, model, params = tiny
    eng = _port(model, params, kv_page_block=2)
    assert eng.group_tokens == 2 * PAGE_TOKENS
    assert eng.generate(PROMPTS, MAX_NEW).tokens == reference_tokens


def test_error_path_releases_pages(tiny, monkeypatch):
    """A failure mid-generation releases every reservation."""
    _, _, model, params = tiny
    eng = _port(model, params, batch_slots=3)
    calls = {"n": 0}
    real = model.decode_step_multi

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected decode failure")
        return real(*a, **k)

    monkeypatch.setattr(model, "decode_step_multi", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        eng.generate(PROMPTS, MAX_NEW)
    assert eng.last_alloc.groups_in_use == 0
    eng.last_alloc.check_balanced()


def test_per_request_provenance(tiny):
    _, _, model, params = tiny
    res = _port(model, params).generate(PROMPTS, MAX_NEW)
    assert [r["rid"] for r in res.per_request] == list(range(len(PROMPTS)))
    assert [r["new_tokens"] for r in res.per_request] == MAX_NEW
    assert [r["prompt_len"] for r in res.per_request] == \
        [len(p) for p in PROMPTS]
    assert all(0 <= r["ttft_s"] <= r["latency_s"] for r in res.per_request)
    assert res.p50_latency_s <= res.p95_latency_s


# --- kernel autotune (ServeConfig.autotune_kernels) ----------------------
@pytest.mark.parametrize("kv_pages", [None, 5], ids=["auto-pool", "tight"])
def test_autotune_engine_adopts_seeded_group_size_like_reference(
        tiny, tmp_path, monkeypatch, kv_pages):
    """A paged_attention winner (pages_per_block=2) seeded in one cache
    file under each package's own CPU key (the reference's ``cpu``, the
    port's ``model-sm90``) is adopted by both engines with autotune on:
    the same group size (clamped alike when the page budget is tight),
    the same re-keyed runtime entry, the same tokens and decode steps.
    The cost models differ between the packages, so no tuning outcome is
    compared."""
    from repro import autotune as jautotune
    from repro_torch import autotune

    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    jautotune.reset_default_cache()
    autotune.reset_default_cache()
    jm, jp, model, params = tiny
    kw = _kw(max_seq=40, batch_slots=2, autotune_kernels=True,
             autotune_budget=3, kv_cache_pages=kv_pages)
    dims = {"B": 2, "S": 40, "H": TINY.padded_heads,
            "KV": TINY.n_kv_heads, "D": TINY.head_dim_}
    for cache, backend in ((jautotune.default_cache(), "cpu"),
                           (autotune.default_cache(), "model-sm90")):
        cache.put("paged_attention", autotune.shape_sig(dims),
                  TINY.compute_dtype, backend, {"pages_per_block": 2}, 1.0)
    prompts, max_new = PROMPTS[:4], MAX_NEW[:4]
    got_eng = ServeEngine(model, params, ServeConfig(**kw), device="cpu")
    got = got_eng.generate(prompts, max_new)
    want_eng = JaxServeEngine(jm, jp, JaxServeConfig(**kw))
    want = want_eng.generate(prompts, max_new)
    jautotune.reset_default_cache()
    autotune.reset_default_cache()

    assert got_eng.group_tokens == want_eng.group_tokens
    assert got_eng.max_groups == want_eng.max_groups
    assert got_eng.pool_groups == want_eng.pool_groups
    assert got_eng.group_tokens == (2 if kv_pages is None else 1) * \
        PAGE_TOKENS
    assert got_eng.kernel_blocks["paged_attention"] == {"pages_per_block": 2}
    assert set(got_eng.kernel_blocks) == set(want_eng.kernel_blocks)
    assert got.tokens == want.tokens
    assert got.steps == want.steps
    keys = json.load(open(path))
    if kv_pages is None:  # 40 tokens run as 2 groups of 32: S=64 re-keyed
        runtime = autotune.shape_sig(dict(dims, S=64))
        assert any(f"|paged_attention|{runtime}|" in k for k in keys)
    # the decode-attention warm-up landed too (the reference's quirk:
    # tuned, never run by the paged runtime)
    assert any("|decode_attention|" in k for k in keys)

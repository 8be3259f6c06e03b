"""The port's serve knobs against the reference ``ServeEngine``.

Both engines get the same weights (``params_from_numpy`` of the
reference's init) and the same ``ServeConfig`` values.  Under the
schedules (sjf, interleave), the on_demand page policy with recompute
preemption, copy-on-write prefix sharing and n-gram drafts, alone and
composed, per-request greedy tokens must equal the reference's, and so
must the counts of decode steps, prefill chunks, preemptions, CoW
splits, shared tokens, drafted and accepted tokens; the pool must be
balanced after every run, the error path included.  The cases mirror the
paged, greedy cases of ``tests/test_continuous_batching.py``
(``TestScheduleParity``, ``TestPagePolicy``, ``TestPrefixSharing``,
``TestSpeculativeDecode``) and ``tests/test_preemption.py``
(``TestAllocatorProperties`` against the port's allocator,
``TestPreemptionParityMatrix``), on ``TINY`` and ``reduced(gemma-7b)``.

Temperature sampling cannot reproduce ``jax.random``'s bits, so it is
held to the reference's invariance tests instead: the sampled tokens do
not change with the schedule, the slot count, preemption, sharing or the
draft length.
"""
import math
import re

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.models import Model as JaxModel
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import engine as jengine
from repro.serve import paging as jpaging
from repro.serve import scheduler as jscheduler
from repro_torch.models import Model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import paging, scheduler
from repro_torch.serve.paging import (PAGE_TOKENS, OversubscriptionError,
                                      PageAllocator)
from test_torch_model import CONFIGS, port_cfg

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5], [2, 2, 2],
           [7, 1, 4, 1, 5, 9, 2, 6], [3, 3], [5, 4, 3, 2, 1, 6]]
MAX_NEW = [6, 3, 5, 2, 7, 4]
# decode-heavy: worst-case footprints of 2 groups each, so a 4-page pool
# (3 usable groups) serializes reserve admission and makes on_demand
# preempt (tests/test_preemption.py's MATRIX_*)
HEAVY = ([[1, 2, 3], [9, 8, 7, 6], [2, 2, 2, 2, 2], [7, 1, 4, 1],
          [3, 3, 3], [5, 4, 3, 2, 1, 6]], [14, 12, 16, 13, 18, 12])
TIGHT = dict(batch_slots=3, kv_cache_pages=4)
# an 18-token common prefix (one full group + 2) and distinct tails
SHARED_PREFIX = [7, 3, 9, 1, 4, 4, 8, 2, 6, 5, 1, 9, 2, 7, 3, 8, 5, 2]
SHARED = ([SHARED_PREFIX + [11], SHARED_PREFIX + [12, 13],
           SHARED_PREFIX + [14, 15, 16], SHARED_PREFIX + [17]],
          [5, 4, 6, 3])
# both sharers' coverage ends mid-group, forcing CoW splits
_DONOR = [((i * 37) % 509) + 1 for i in range(32)]
COW = ([_DONOR, [1, 2, 3], list(_DONOR), _DONOR[:20]], [26, 2, 5, 4])
# a blocked sjf head whose reservation does not fit a 4-page pool
BYPASS = ([[1, 2, 3, 4], [9, 8, 7, 6, 5], [2, 4, 6, 8, 1, 3]], [28, 27, 6])
WORKLOADS = {"mixed": (PROMPTS, MAX_NEW), "heavy": HEAVY, "shared": SHARED,
             "cow": COW, "bypass": BYPASS,
             "overlap": ([[1, 2, 3], [9] * 24], [12, 2])}

COUNTS = ("steps", "prefill_chunks", "preemptions", "cow_splits",
          "shared_prefix_tokens", "drafted", "accepted")


def _kw(**kw):
    base = dict(max_seq=32, batch_slots=2, runtime="continuous",
                prefill_chunk=4, kv_layout="paged")
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def models():
    """{config name: (jax model, jax params, port model, port params)},
    built once for the module."""
    out = {}
    for name, jcfg in CONFIGS.items():
        jm = JaxModel(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        cfg = port_cfg(jcfg)
        out[name] = (jm, jp, Model(cfg, device="cpu"), params_from_numpy(
            cfg, jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    return out


def _port(models, name, **kw):
    _, _, model, params = models[name]
    return ServeEngine(model, params, ServeConfig(**_kw(**kw)),
                       device="cpu")


def _run(eng, workload):
    """Generate ``workload`` and hold the pool balanced and empty."""
    res = eng.generate(*WORKLOADS[workload])
    eng.last_alloc.check_balanced()
    assert eng.last_alloc.groups_in_use == 0
    return res


# --- tokens and counts against the reference ----------------------------
# (config, workload, ServeConfig changes)
CASES = {
    "sjf": ("tiny", "mixed", dict(schedule="sjf")),
    "interleave": ("tiny", "mixed", dict(schedule="interleave")),
    "interleave-overlap": ("tiny", "overlap", dict(schedule="interleave")),
    "reserve-tight-sjf": ("tiny", "heavy", dict(TIGHT, schedule="sjf")),
    "reserve-tight-interleave": ("tiny", "heavy",
                                 dict(TIGHT, schedule="interleave")),
    "on_demand-tight": ("tiny", "heavy", dict(TIGHT, page_policy="on_demand")),
    "on_demand-tight-sjf": ("tiny", "heavy", dict(
        TIGHT, page_policy="on_demand", schedule="sjf")),
    "on_demand-tight-interleave": ("tiny", "heavy", dict(
        TIGHT, page_policy="on_demand", schedule="interleave")),
    "on_demand-big": ("tiny", "heavy", dict(
        batch_slots=3, kv_cache_pages=16, page_policy="on_demand")),
    "sjf-bypass": ("tiny", "bypass", dict(kv_cache_pages=4, schedule="sjf")),
    "fifo-bypass": ("tiny", "bypass", dict(kv_cache_pages=4)),
    "share": ("tiny", "shared", dict(max_seq=64, share_prefix=True)),
    "share-sjf": ("tiny", "shared", dict(max_seq=64, share_prefix=True,
                                         schedule="sjf")),
    "share-interleave": ("tiny", "shared", dict(
        max_seq=64, share_prefix=True, schedule="interleave")),
    "share-cow": ("tiny", "cow", dict(max_seq=64, share_prefix=True)),
    "share-on_demand": ("tiny", "shared", dict(
        max_seq=64, share_prefix=True, batch_slots=3, kv_cache_pages=5,
        page_policy="on_demand")),
    "draft2": ("tiny", "mixed", dict(draft_len=2)),
    "draft4-sjf": ("tiny", "mixed", dict(draft_len=4, schedule="sjf")),
    "draft4-interleave": ("tiny", "mixed", dict(draft_len=4,
                                                schedule="interleave")),
    "draft4-on_demand": ("tiny", "heavy", dict(
        TIGHT, page_policy="on_demand", draft_len=4)),
    "draft4-share": ("tiny", "shared", dict(max_seq=64, share_prefix=True,
                                            draft_len=4)),
    "gemma-sjf": ("gemma-7b-smoke", "mixed", dict(schedule="sjf")),
    "gemma-interleave": ("gemma-7b-smoke", "mixed",
                         dict(schedule="interleave")),
    "gemma-on_demand": ("gemma-7b-smoke", "heavy", dict(
        TIGHT, page_policy="on_demand")),
    "gemma-share-cow": ("gemma-7b-smoke", "cow", dict(max_seq=64,
                                                      share_prefix=True)),
    "gemma-draft3-on_demand": ("gemma-7b-smoke", "heavy", dict(
        TIGHT, page_policy="on_demand", draft_len=3)),
}


@pytest.fixture(scope="module")
def reference(models):
    """Each case's reference run, once for the module."""
    out = {}

    def get(case):
        if case not in out:
            name, workload, kw = CASES[case]
            jm, jp, _, _ = models[name]
            eng = JaxServeEngine(jm, jp, JaxServeConfig(**_kw(**kw)))
            out[case] = eng.generate(*WORKLOADS[workload])
            eng.last_alloc.check_balanced()
        return out[case]

    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_tokens_and_counts_match_reference(models, reference, case):
    name, workload, kw = CASES[case]
    got = _run(_port(models, name, **kw), workload)
    want = reference(case)
    assert got.tokens == want.tokens
    assert {c: getattr(got, c) for c in COUNTS} == \
        {c: getattr(want, c) for c in COUNTS}
    assert [r["preemptions"] for r in got.per_request] == \
        [r["preemptions"] for r in want.per_request]
    assert [r["shared_tokens"] for r in got.per_request] == \
        [r["shared_tokens"] for r in want.per_request]
    if got.drafted:
        assert got.acceptance_rate == want.acceptance_rate
    else:
        assert math.isnan(got.acceptance_rate)


# --- what each knob does, on the port (mirrors of the reference's tests) -
def test_schedules_agree_with_fifo(models, reference):
    """TestScheduleParity: sjf and interleave move work, never tokens."""
    fifo = _run(_port(models, "tiny"), "mixed")
    for case in ("sjf", "interleave"):
        assert reference(case).tokens == fifo.tokens


def test_forced_preemption_token_parity(models):
    """TestPagePolicy: on_demand preempts on the tight pool, gives reserve's
    tokens in fewer steps, and per-request provenance sums to the count."""
    reserve = _run(_port(models, "tiny", **TIGHT), "heavy")
    on_demand = _run(_port(models, "tiny", page_policy="on_demand",
                           **TIGHT), "heavy")
    assert on_demand.preemptions > 0 and reserve.preemptions == 0
    assert on_demand.tokens == reserve.tokens
    assert on_demand.steps < reserve.steps
    assert sum(r["preemptions"] for r in on_demand.per_request) == \
        on_demand.preemptions


def test_on_demand_inert_on_big_pools(models):
    kw = dict(batch_slots=3, kv_cache_pages=16)
    reserve = _run(_port(models, "tiny", **kw), "heavy")
    on_demand = _run(_port(models, "tiny", page_policy="on_demand", **kw),
                     "heavy")
    assert on_demand.preemptions == 0
    assert (on_demand.tokens, on_demand.steps) == \
        (reserve.tokens, reserve.steps)


@pytest.mark.parametrize("policy", ["reserve", "on_demand"])
@pytest.mark.parametrize("extra", [{}, dict(share_prefix=True, draft_len=2)],
                         ids=["plain", "share-draft"])
def test_error_path_releases_pages(models, monkeypatch, policy, extra):
    """A failure mid-generation, with live slots, unwinds every
    reservation (shared refs included)."""
    eng = _port(models, "tiny", batch_slots=3, max_seq=64,
                page_policy=policy, **extra)
    model = models["tiny"][2]
    calls = {"n": 0}
    real = model.decode_step_multi

    def boom(*a, **k):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise RuntimeError("injected decode failure")
        return real(*a, **k)

    monkeypatch.setattr(model, "decode_step_multi", boom)
    with pytest.raises(RuntimeError, match="injected"):
        eng.generate(*SHARED)
    assert eng.last_alloc.groups_in_use == 0
    eng.last_alloc.check_balanced()


def test_sjf_bypass_beats_head_of_line_blocking(models):
    """A blocked sjf head must not starve a smaller request that fits:
    rid 2 starts before rid 1 under sjf; fifo stays strict."""
    ttft = {}
    for sched in ("sjf", "fifo"):
        res = _run(_port(models, "tiny", kv_cache_pages=4, schedule=sched),
                   "bypass")
        ttft[sched] = [r["ttft_s"] for r in res.per_request]
    assert ttft["sjf"][2] < ttft["sjf"][1]
    assert ttft["fifo"][1] < ttft["fifo"][2]


def test_sharing_skips_prefill_and_keeps_tokens(models):
    """TestPrefixSharing: fewer prefill chunks, the same tokens,
    provenance that sums to the shared count, a donor that shared
    nothing; the registry publishes only while its groups live."""
    off = _run(_port(models, "tiny", max_seq=64), "shared")
    eng = _port(models, "tiny", max_seq=64, share_prefix=True)
    on = _run(eng, "shared")
    assert on.tokens == off.tokens
    assert on.shared_prefix_tokens > 0 == off.shared_prefix_tokens
    assert on.prefill_chunks < off.prefill_chunks
    assert sum(r["shared_tokens"] for r in on.per_request) == \
        on.shared_prefix_tokens
    assert any(r["shared_tokens"] == 0 for r in on.per_request)
    # every request finished, so no registered group is live any more
    assert eng.last_prefix.match(SHARED[0][0]) == ([], 0)


def test_forced_cow_split_preserves_tokens(models):
    off = _run(_port(models, "tiny", max_seq=64), "cow")
    on = _run(_port(models, "tiny", max_seq=64, share_prefix=True), "cow")
    assert on.tokens == off.tokens
    assert on.cow_splits >= 2
    assert on.prefill_chunks < off.prefill_chunks


def test_sharing_survives_preemption_and_cuts_recompute(models):
    kw = dict(max_seq=64, batch_slots=3, kv_cache_pages=5,
              page_policy="on_demand")
    prompts, new = SHARED[0], [14, 13, 16, 12]
    outs = {}
    for share in (False, True):
        eng = _port(models, "tiny", share_prefix=share, **kw)
        outs[share] = eng.generate(prompts, new)
        eng.last_alloc.check_balanced()
    assert outs[True].tokens == outs[False].tokens
    assert outs[True].preemptions > 0
    assert outs[True].prefill_chunks < outs[False].prefill_chunks


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros(v) for v in tree]
    return torch.zeros_like(tree)


def test_drafts_keep_tokens_and_cut_dispatches(models):
    """TestSpeculativeDecode: on a constant-output model (zeroed weights:
    greedy repeats token 0) the n-gram draft matches, verification
    accepts it, and the same tokens arrive in fewer dispatches."""
    _, _, model, params = models["tiny"]
    zero = _zeros(params)
    runs = {}
    for k in (0, 4):
        eng = ServeEngine(model, zero, ServeConfig(**_kw(draft_len=k)),
                          device="cpu")
        runs[k] = eng.generate([[5, 3, 5, 3]], 12)
    assert runs[4].tokens == runs[0].tokens
    assert runs[4].drafted > 0 and runs[4].accepted > 0
    assert runs[4].steps < runs[0].steps
    assert 0.0 < runs[4].acceptance_rate <= 1.0
    assert runs[0].drafted == runs[0].accepted == 0


def test_draft_config_range_checks():
    with pytest.raises(ValueError, match="draft_len"):
        ServeConfig(draft_len=-1)
    with pytest.raises(ValueError, match="draft_window"):
        ServeConfig(draft_window=1)


# --- temperature: invariants, not the reference's bits -------------------
# (workload, ServeConfig changes) that must leave sampled tokens alone
TEMP_VARIANTS = {
    "sjf": ("heavy", dict(schedule="sjf")),
    "interleave": ("heavy", dict(schedule="interleave")),
    "one-slot": ("heavy", dict(batch_slots=1)),
    "three-slots": ("heavy", dict(batch_slots=3)),
    "on_demand-preempts": ("heavy", dict(TIGHT, page_policy="on_demand")),
    "draft2": ("heavy", dict(draft_len=2)),
    "draft4-on_demand": ("heavy", dict(TIGHT, page_policy="on_demand",
                                       draft_len=4)),
    "share": ("shared", dict(share_prefix=True)),
    "share-draft4-sjf": ("shared", dict(share_prefix=True, draft_len=4,
                                        schedule="sjf")),
}
SAMPLED = dict(temperature=0.8, seed=7)


@pytest.fixture(scope="module")
def sampled_baseline(models):
    return {w: _run(_port(models, "tiny", **SAMPLED), w)
            for w in ("heavy", "shared")}


@pytest.mark.parametrize("variant", sorted(TEMP_VARIANTS))
def test_temperature_tokens_invariant(models, sampled_baseline, variant):
    workload, kw = TEMP_VARIANTS[variant]
    res = _run(_port(models, "tiny", **SAMPLED, **kw), workload)
    assert res.tokens == sampled_baseline[workload].tokens
    if kw.get("page_policy") == "on_demand":
        assert res.preemptions > 0
    if kw.get("share_prefix"):
        assert res.shared_prefix_tokens > 0


def test_temperature_samples(models, sampled_baseline):
    """Sampling is live: the tokens are not greedy's, another seed gives
    others, and a repeat of the same seed gives the same."""
    greedy = _run(_port(models, "tiny"), "heavy")
    again = _run(_port(models, "tiny", **SAMPLED), "heavy")
    other = _run(_port(models, "tiny", temperature=0.8, seed=8), "heavy")
    base = sampled_baseline["heavy"].tokens
    assert again.tokens == base
    assert base != greedy.tokens and base != other.tokens


def test_sampled_token_depends_on_logits_and_key_only(models):
    """``_categorical_grid`` column i of row b equals a one-row draw at
    key (seed, rid, produced + i), whatever the rest of the batch."""
    eng = _port(models, "tiny", temperature=0.8, seed=3)
    g = torch.Generator().manual_seed(0)
    lg = torch.randn((3, 4, 576), generator=g)
    grid = eng._categorical_grid(lg, [(3, 5), None, (3, 9)], [2, 0, 7])
    for b, (rid, p) in ((0, (5, 2)), (2, (9, 7))):
        for i in range(4):
            one = eng._categorical_grid(lg[b:b + 1, i:i + 1], [(3, rid)],
                                        [p + i])
            assert int(one[0, 0]) == int(grid[b, i])
    # a low temperature approaches greedy
    cold = _port(models, "tiny", temperature=1e-6, seed=3)
    assert torch.equal(cold._categorical_grid(lg, [(3, 1)] * 3, [0] * 3),
                       lg[..., :512].argmax(-1))


# --- host-side pieces against the reference's ----------------------------
@pytest.mark.parametrize("seed", range(4))
def test_ngram_draft_and_tail_history_match_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        prompt = rng.integers(0, 4, size=int(rng.integers(0, 12))).tolist()
        out = rng.integers(0, 4, size=int(rng.integers(0, 12))).tolist()
        window = int(rng.integers(0, 20))
        assert engine_mod._tail_history(prompt, out, window) == \
            jengine._tail_history(prompt, out, window)
        hist = prompt + out
        k, n = int(rng.integers(0, 5)), int(rng.integers(1, 4))
        assert ServeEngine._ngram_draft(hist, k, n, window) == \
            JaxServeEngine._ngram_draft(hist, k, n, window)


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_matches_reference(seed):
    """Admission order, the sjf bypass scan and victim selection give the
    reference's choices on random queues."""
    rng = np.random.default_rng(seed)
    for policy in scheduler.SCHEDULES:
        lens = rng.integers(1, 9, size=8)
        mk = [(i, [1] * int(n), int(rng.integers(1, 9)))
              for i, n in enumerate(lens)]
        got = scheduler.SlotScheduler(policy, 2)
        want = jscheduler.SlotScheduler(policy, 2)
        got.submit([scheduler.Request(*a) for a in mk])
        want.submit([jscheduler.Request(*a) for a in mk])
        assert [r.rid for r in got._pending] == [r.rid for r in want._pending]
        got.resubmit(got.pop())
        want.resubmit(want.pop())
        assert got.queue_depth == want.queue_depth
        other = scheduler.SCHEDULES[int(rng.integers(3))]
        got.set_policy(other)
        want.set_policy(other)
        assert [r.rid for r in got._pending] == [r.rid for r in want._pending]
        assert got.interleave_prefill == want.interleave_prefill
        got.set_page_policy("on_demand")
        want.set_page_policy("on_demand")
        assert got.on_demand and want.on_demand
        assert got.peek().rid == want.peek().rid
        limit = int(rng.integers(1, 6))
        cut = int(rng.integers(1, 9))
        a = got.pop_first_fit(lambda r: r.prompt_len >= cut, limit)
        b = want.pop_first_fit(lambda r: r.prompt_len >= cut, limit)
        assert (a and a.rid) == (b and b.rid)
        running = [scheduler.Request(*m) for m in mk]
        jrunning = [jscheduler.Request(*m) for m in mk]
        for r, jr in zip(running, jrunning):
            r.arrival = jr.arrival = int(rng.integers(0, 4))
        costs = rng.integers(0, 3, size=len(mk))
        assert scheduler.SlotScheduler.select_victim(
            running, lambda r: costs[r.rid]).rid == \
            jscheduler.SlotScheduler.select_victim(
                jrunning, lambda r: costs[r.rid]).rid
        assert scheduler.SlotScheduler.select_victim(running).rid == \
            jscheduler.SlotScheduler.select_victim(jrunning).rid


def _alloc_op(a, idx, op, owner, pick, toks, grow):
    """One random operation on an allocator and its prefix registry ->
    (its result, free groups, high water), the pool checked balanced."""
    try:
        if op == 0:  # admit, and publish the prompt's full groups
            got = a.try_alloc(owner, len(toks))
            if got is not None:
                idx.register(toks, got)
        elif op == 1:  # admit onto the groups the registry offers
            gids, covered = idx.match(toks)
            got = (gids, covered, a.share(owner, gids) if gids else None)
        elif pick is None:
            got = None
        elif op == 2:
            got = a.extend(pick, len(a.owned_groups(pick)) * a.group_tokens
                           + grow)
        elif op == 3:
            shared = [i for i, g in enumerate(a.owned_groups(pick))
                      if a.ref(g) >= 2]
            got = a.cow_split(pick, shared[0]) if shared else None
        else:
            got = (a.shared_prefix_tokens(pick), a.release(pick))
    except ValueError as e:  # either package's OversubscriptionError
        got = type(e).__name__
    a.check_balanced()
    return got, a.free_groups, a.high_water


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n_pages=st.integers(4, 40),
       pages_per_group=st.integers(1, 3))
def test_allocator_and_prefix_index_match_reference(seed, n_pages,
                                                    pages_per_group):
    """Random try_alloc / extend / share / cow_split / release and prefix
    register / match on the port's allocator and the reference's: every
    return value equal, both balanced after every operation."""
    if n_pages // pages_per_group < 2:
        n_pages = 2 * pages_per_group
    allocs = (PageAllocator(n_pages, pages_per_group=pages_per_group),
              jpaging.PageAllocator(n_pages,
                                    pages_per_group=pages_per_group))
    sides = [(allocs[0], paging.PrefixIndex(allocs[0])),
             (allocs[1], jpaging.PrefixIndex(allocs[1]))]
    rng = np.random.default_rng(seed)
    T = allocs[0].group_tokens
    live = []
    for owner in range(60):
        op = int(rng.integers(0, 5))
        toks = rng.integers(0, 3, size=int(rng.integers(1, 3 * T))).tolist()
        grow = int(rng.integers(1, 2 * T))
        pick = live[int(rng.integers(len(live)))] if live else None
        outs = [_alloc_op(a, idx, op, owner, pick, toks, grow)
                for a, idx in sides]
        assert outs[0] == outs[1]
        got = outs[0][0]
        if (op == 0 and isinstance(got, list)) or (op == 1 and got[0]):
            live.append(owner)
        elif op == 4 and pick is not None:
            live.remove(pick)
    for a in allocs:
        a.release_all()
        assert a.groups_in_use == 0
        a.check_balanced()


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n_pages=st.integers(4, 40),
       pages_per_group=st.integers(1, 3))
def test_random_interleavings_stay_balanced(seed, n_pages, pages_per_group):
    """TestAllocatorProperties on the port's allocator: alloc / extend /
    release in random order keep the pool balanced, the scratch group
    out of every reservation, and the high-water mark monotone."""
    if n_pages // pages_per_group < 2:
        n_pages = 2 * pages_per_group
    a = PageAllocator(n_pages, pages_per_group=pages_per_group)
    rng = np.random.default_rng(seed)
    live = {}
    next_owner = 0
    hw = a.high_water
    for _ in range(60):
        op = rng.integers(0, 3)
        if op == 0:
            tokens = int(rng.integers(1, a.usable_tokens + 1))
            try:
                got = a.try_alloc(next_owner, tokens)
            except OversubscriptionError:
                got = None
            if got is not None:
                assert PageAllocator.SCRATCH_GROUP not in got
                assert len(got) == a.groups_for(tokens)
                live[next_owner] = tokens
                next_owner += 1
        elif op == 1 and live:
            owner = int(rng.choice(list(live)))
            grow_to = live[owner] + int(rng.integers(1, 2 * a.group_tokens))
            try:
                new = a.extend(owner, grow_to)
            except OversubscriptionError:
                new = None
            if new is not None:
                assert PageAllocator.SCRATCH_GROUP not in new
                live[owner] = grow_to
                assert len(a.owned_groups(owner)) == a.groups_for(grow_to)
        elif op == 2 and live:
            owner = int(rng.choice(list(live)))
            a.release(owner)
            del live[owner]
        a.check_balanced()
        assert a.high_water >= hw
        hw = a.high_water
        assert a.free_groups + a.groups_in_use == a.usable_groups
    for owner in list(live):
        a.release(owner)
    assert a.groups_in_use == 0
    a.check_balanced()


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_extend_equals_upfront_reservation(seed):
    rng = np.random.default_rng(seed)
    total = int(rng.integers(1, 6 * PAGE_TOKENS))
    start = int(rng.integers(1, total + 1))
    a, b = PageAllocator(16), PageAllocator(16)
    a.try_alloc(0, total)
    b.try_alloc(0, start)
    for t in range(start + 1, total + 1):
        assert b.extend(0, t) is not None
    assert len(b.owned_groups(0)) == len(a.owned_groups(0))


# --- TestPreemptionParityMatrix ------------------------------------------
def test_preemption_matrix_one_token_stream(models):
    """reserve/on_demand x fifo/sjf/interleave on the tight pool, and both
    policies on a comfortable one: one token stream, preemptions only
    under on_demand (their reference counts are held above)."""
    ref = _run(_port(models, "tiny", batch_slots=3), "heavy")
    preempted = 0
    for policy in ("reserve", "on_demand"):
        for sched in ("fifo", "sjf", "interleave"):
            res = _run(_port(models, "tiny", page_policy=policy,
                             schedule=sched, **TIGHT), "heavy")
            assert res.tokens == ref.tokens, (policy, sched)
            if policy == "on_demand":
                preempted += res.preemptions
            else:
                assert res.preemptions == 0
    assert preempted > 0
    for policy in ("reserve", "on_demand"):
        res = _run(_port(models, "tiny", page_policy=policy, batch_slots=3,
                         kv_cache_pages=16), "heavy")
        assert res.tokens == ref.tokens and res.preemptions == 0


def test_launcher_runs_the_knob_flags(capsys):
    """``--schedule``, ``--page-policy`` and ``--temperature`` reach the
    engine (a 6-page pool makes on_demand preempt)."""
    from repro_torch.launch.serve import main

    assert main(["--arch", "gemma-7b", "--requests", "4", "--max-new", "20",
                 "--schedule", "sjf", "--page-policy", "on_demand",
                 "--temperature", "0.7", "--kv-pages", "6",
                 "--kv-layout", "paged", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "continuous/paged/sjf on cpu" in out
    assert int(re.search(r"\[on_demand, (\d+) preemptions\]",
                         out).group(1)) > 0

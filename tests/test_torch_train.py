"""The port's train step and its substrate against the reference's.

* ``SyntheticLMDataset`` batches equal the reference's byte for byte.
* ``lr_at``, AdamW, global-norm clipping and gradient compression match
  the reference's on random trees (f32: each op is the reference's, in
  its order; the tolerance is a few f32 ulps of the values).
* ``make_train_step`` on ``TINY`` from bridged weights: 3 steps at a
  constant learning rate (``OptimizerConfig(schedule="constant",
  warmup_steps=0, learning_rate=1e-3)``, so every update moves the
  params) under every value of every knob of ``train_knob_space``
  (microbatches 1/2/4, remat none/full/dots, compression none/int8/topk,
  the inert attention blocks), against the reference's jitted step.
  Bars, from f32 rounding: each side's f32 gradients lie 1e-5 to 3e-5
  (norm-relative, per leaf) from the same gradients in f64, so the first
  step's grad norm is held to 1e-4; Adam turns a gradient near zero into
  an update of up to lr either way, so a few elements of the params move
  apart by O(lr) and the later steps see slightly different params.
  Measured over the cases: losses within 7e-6 (bar 1e-4, relative),
  later grad norms within 3.4e-3 (bar 1e-2), the three steps' update
  within 4.5e-3 of the reference's in norm (bar 2e-2), and at most 3e-4
  of the elements more than lr/10 apart (bar 1e-3).  Compression sees
  the block gradients stacked by weight, as the reference holds them
  (an int8 scale or top-k threshold per weight over its layers; a tuple
  leaf of its per-layer slices).
* Remat and microbatch equivalence (``tests/test_train_serve.py``'s
  ``test_remat_equivalence`` and ``test_microbatch_equivalence``) and a
  loss that decreases, on the port's step; a microbatch count that does
  not divide the batch raises, as the reference's reshape does.
* ``remat="full"`` and ``"dots"`` give ``"none"``'s gradients.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JaxModelConfig
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMDataset as JDataset
from repro.models import Model as JaxModel
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.train.space import apply_train_knobs as j_apply
from repro.train.space import train_knob_space as j_space
from repro.train.step import RunKnobs as JRunKnobs
from repro.train.step import make_train_step as j_make_step
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models import Model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp
from repro_torch.optim import tree_leaves, tree_map
from repro_torch.train import (RunKnobs, apply_train_knobs,
                               init_train_state, make_train_step,
                               train_knob_space)
from test_torch_model import port_cfg

torch.set_num_threads(1)

TINY = JaxModelConfig(
    name="tiny-lm", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
    param_dtype="float32", compute_dtype="float32", vocab_pad_multiple=64,
    rope_theta=10_000.0,
)
OPT = dict(learning_rate=1e-3, warmup_steps=0, schedule="constant")
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
# the first step (same params) / later steps (params one or two updates
# apart)
GRAD_TOL = {False: dict(rtol=1e-4, atol=0), True: dict(rtol=1e-2, atol=0)}
UPDATE_TOL = 2e-2
OFF_SHARE = 1e-3


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(vocab_size=512, seq_len=32, global_batch=8, seed=0),
    dict(vocab_size=256000, seq_len=16, global_batch=4, seed=1234),
    dict(vocab_size=97, seq_len=8, global_batch=6, seed=7, n_hosts=3,
         host_id=2, zipf_a=1.5)], ids=["tiny", "gemma-vocab", "hosts"])
def test_batches_equal_the_reference_byte_for_byte(kw):
    j, t = JDataset(JDataConfig(**kw)), SyntheticLMDataset(DataConfig(**kw))
    for step in (0, 1, 17):
        a, b = j.batch_at(step), t.batch_at(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            assert a[k].tobytes() == b[k].tobytes()
    with pytest.raises(ValueError):
        SyntheticLMDataset(DataConfig(vocab_size=8, seq_len=4,
                                      global_batch=5, n_hosts=2))


# ---------------------------------------------------------------------------
# optimizer substrate
# ---------------------------------------------------------------------------
def _tree(rng, scale=1.0):
    """A random tree of the port's shape: dicts and a list."""
    return {"embed": rng.normal(size=(16, 8)) * scale,
            "blocks": [{"w": rng.normal(size=(8, 8)) * scale,
                        "b": rng.normal(size=(8,)) * scale}
                       for _ in range(2)],
            "norm": rng.normal(size=(8,)) * scale}


def _np32(tree):
    return tree_map(lambda a: np.asarray(a, np.float32), tree)


def _to_jax(tree):
    """A port-shaped numpy tree as the reference's pytree (lists are
    pytrees in jax too)."""
    return tree_map(jnp.asarray, _np32(tree))


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), _np32(tree))


def _close(t_tree, j_tree, **tol):
    tree_map(lambda a, b: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), **tol), t_tree, j_tree)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_reference(schedule):
    for kw in (dict(warmup_steps=100, total_steps=1000),
               dict(warmup_steps=0, total_steps=50, min_lr_ratio=0.3)):
        jc = jadamw.OptimizerConfig(schedule=schedule, **kw)
        tc = tadamw.OptimizerConfig(schedule=schedule, **kw)
        for step in (0, 1, 50, 99, 100, 101, 500, 999, 1000, 4000):
            want = float(jadamw.lr_at(jc, jnp.int32(step)))
            got = float(tadamw.lr_at(tc, torch.tensor(step, dtype=torch.int32)))
            assert got == pytest.approx(want, rel=2e-7, abs=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_and_global_norm_match_reference(max_norm):
    g = _tree(np.random.default_rng(0), 3.0)
    jc, jn = jadamw.clip_by_global_norm(_to_jax(g), max_norm)
    tc, tn = tadamw.clip_by_global_norm(_to_torch(g), max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    _close(tc, jc, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_matches_reference(wd):
    rng = np.random.default_rng(1)
    jc = jadamw.OptimizerConfig(learning_rate=1e-2, weight_decay=wd,
                                warmup_steps=2, total_steps=20)
    tc = tadamw.OptimizerConfig(learning_rate=1e-2, weight_decay=wd,
                                warmup_steps=2, total_steps=20)
    p = _tree(rng)
    jp, tp = _to_jax(p), _to_torch(p)
    js, ts = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    assert all(m.dtype == torch.float32 for m in tree_leaves(ts["mu"]))
    for _ in range(4):
        g = _tree(rng, 0.1)
        jp, js, jlr = jadamw.adamw_update(_to_jax(g), js, jp, jc)
        tp, ts, tlr = tadamw.adamw_update(_to_torch(g), ts, tp, tc)
        assert float(tlr) == pytest.approx(float(jlr), rel=1e-7)
        assert int(ts["step"]) == int(js["step"])
    _close(tp, jp, rtol=1e-6, atol=1e-7)
    _close(ts["mu"], js["mu"], rtol=1e-6, atol=1e-8)
    _close(ts["nu"], js["nu"], rtol=1e-6, atol=1e-9)


def test_adamw_keeps_bf16_params_and_f32_moments():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    s = tadamw.adamw_init(p)
    cfg = tadamw.OptimizerConfig(learning_rate=0.1, weight_decay=0.5,
                                 warmup_steps=0, schedule="constant")
    for _ in range(3):
        p, s, _ = tadamw.adamw_update({"w": torch.zeros(4)}, s, p, cfg)
    assert p["w"].dtype == torch.bfloat16 and s["mu"]["w"].dtype == \
        torch.float32
    assert float(p["w"].float().abs().max()) < 1.0  # weight decay shrinks


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compression_matches_reference(scheme):
    rng = np.random.default_rng(2)
    p = _tree(rng)
    je = jcomp.compression_init(_to_jax(p), scheme)
    te = tcomp.compression_init(_to_torch(p), scheme)
    for _ in range(3):
        g = _tree(rng, 0.1)
        jg, je = jcomp.compress_grads(_to_jax(g), je, scheme)
        tg, te = tcomp.compress_grads(_to_torch(g), te, scheme)
        _close(tg, jg, rtol=1e-6, atol=1e-9)
        _close(te, je, rtol=1e-6, atol=1e-9)
    kept = [float((x != 0).float().mean()) for x in tree_leaves(tg)]
    if scheme == "topk":  # 5% of each leaf, at least one element
        assert all(k <= 0.13 for k in kept)
    assert tcomp.compression_init(_to_torch(p), "none") is None
    assert tcomp.compress_grads(tg, None, "none") == (tg, None)


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_grouped_compression_is_the_references_on_a_stacked_weight(scheme):
    """A tuple leaf (the per-layer slices of one weight, as the train step
    groups them) shares one scale or threshold: the reference's result on
    the weight stacked along the layer axis."""
    rng = np.random.default_rng(4)
    layers = [rng.normal(size=(6, 5)).astype(np.float32) * s
              for s in (0.01, 1.0, 0.1)]
    stacked = jnp.asarray(np.stack(layers))
    want, werr = jcomp.compress_grads({"w": stacked},
                                      {"w": jnp.zeros_like(stacked)}, scheme)
    g = {"w": tuple(torch.from_numpy(x) for x in layers)}
    err = {"w": tuple(torch.zeros(6, 5) for _ in layers)}
    got, gerr = tcomp.compress_grads(g, err, scheme)
    assert gerr is err  # the error state is updated in place
    for i in range(3):
        np.testing.assert_allclose(got["w"][i].numpy(),
                                   np.asarray(want["w"][i]), rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(err["w"][i].numpy(),
                                   np.asarray(werr["w"][i]), rtol=1e-6,
                                   atol=1e-9)
    # per layer, the small layer would keep its own largest elements
    alone, _ = tcomp.compress_grads(torch.from_numpy(layers[0]),
                                    torch.zeros(6, 5), scheme)
    assert not torch.equal(alone, got["w"][0])


# ---------------------------------------------------------------------------
# the train step against the reference's jitted step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    jm = JaxModel(TINY)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = port_cfg(TINY)
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               "cpu")
    data = JDataset(JDataConfig(vocab_size=TINY.vocab_size, seq_len=16,
                                global_batch=4, seed=0))
    batches = [data.batch_at(i) for i in range(3)]
    return jm, jp, Model(cfg, device="cpu"), params, batches


def _knob_cases():
    """Every value of every knob of train_knob_space, each beside the
    defaults of the others, plus the composed corners."""
    space = train_knob_space(max_microbatches=4)
    base = space.default_config()
    cases = [base]
    for p in space:
        for v in p.choices:
            if v != base[p.name]:
                cases.append(dict(base, **{p.name: v}))
    cases += [dict(base, microbatches=2, remat="full", compression="int8"),
              dict(base, microbatches=4, remat="dots", compression="topk")]
    return cases


CASES = _knob_cases()


def _case_id(cfg):
    return "-".join(f"{k}={v}" for k, v in sorted(cfg.items())
                    if train_knob_space(4).default_config()[k] != v) \
        or "defaults"


def test_knob_cases_cover_every_value():
    space = train_knob_space(max_microbatches=4)
    for p in space:
        assert {c[p.name] for c in CASES} == set(p.choices)


def _flat(tree):
    return torch.cat([x.reshape(-1).double() for x in tree_leaves(tree)])


@pytest.mark.parametrize("config", CASES, ids=_case_id)
def test_train_step_matches_reference(tiny, config):
    jm, jp, model, params, batches = tiny
    knobs = apply_train_knobs(config, RunKnobs(rules_preset="dp",
                                               loss_chunk=0))
    jknobs = j_apply(config, JRunKnobs(rules_preset="dp", loss_chunk=0))
    jopt = jadamw.adamw_init(jp)
    topt = tadamw.adamw_init(params)
    if knobs.compression != "none":
        jopt["error"] = jcomp.compression_init(jp, knobs.compression)
        topt["error"] = tcomp.compression_init(params, knobs.compression)
    jstep = jax.jit(j_make_step(jm, jadamw.OptimizerConfig(**OPT), jknobs))
    tstep = make_train_step(model, tadamw.OptimizerConfig(**OPT), knobs)
    jparams, tparams = jp, params
    for i, b in enumerate(batches):
        jparams, jopt, jm_ = jstep(jparams, jopt,
                                   {k: jnp.asarray(v) for k, v in b.items()})
        tparams, topt, tm_ = tstep(tparams, topt,
                                   {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        for key in ("loss", "total_loss", "accuracy", "grad_norm",
                    "learning_rate", "tokens"):
            tol = (GRAD_TOL[i > 0] if key == "grad_norm" else LOSS_TOL)
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                       err_msg=f"{key} at step {i}", **tol)
    want = params_from_numpy(model.cfg, jax.tree_util.tree_map(
        np.asarray, jparams), "cpu")
    p0, got, ref = _flat(params), _flat(tparams), _flat(want)
    assert float((ref - p0).abs().max()) > 2e-3  # three steps of ~lr each
    update_err = float((got - ref).norm() / (ref - p0).norm())
    off = float(((got - ref).abs() > OPT["learning_rate"] / 10)
                .double().mean())
    assert update_err <= UPDATE_TOL, update_err
    assert off <= OFF_SHARE, off
    assert int(topt["step"]) == 3


def test_train_knob_space_and_knobs_match_reference():
    for mb in (1, 4, 8, 6):
        js, ts = j_space(mb), train_knob_space(mb)
        assert ts.names == js.names
        assert ts.default_config() == js.default_config()
        u = np.random.default_rng(mb).random((40, ts.dim))
        configs = ts.from_unit_matrix(u)
        assert configs == js.from_unit_matrix(u)
        for cfg in configs:
            assert dataclasses.asdict(apply_train_knobs(cfg)) == \
                dataclasses.asdict(j_apply(cfg))
    assert dataclasses.asdict(RunKnobs()) == dataclasses.asdict(JRunKnobs())
    with pytest.raises(NotImplementedError, match="multi-device"):
        RunKnobs().axis_rules()


# ---------------------------------------------------------------------------
# the port's own step: equivalences and training
# ---------------------------------------------------------------------------
def _train(model, params, steps, **knobs):
    knobs = RunKnobs(**dict(dict(rules_preset="dp", remat="none",
                                 microbatches=1, loss_chunk=0), **knobs))
    opt = tadamw.OptimizerConfig(learning_rate=3e-3, warmup_steps=2,
                                 total_steps=50)
    step = make_train_step(model, opt, knobs)
    state = tadamw.adamw_init(params)
    if knobs.compression != "none":
        state["error"] = tcomp.compression_init(params, knobs.compression)
    data = SyntheticLMDataset(DataConfig(vocab_size=512, seq_len=32,
                                         global_batch=4, seed=1234))
    losses = []
    for i in range(steps):
        b = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    return losses


def test_remat_and_microbatch_equivalence(tiny):
    model, params = tiny[2], tiny[3]
    base = _train(model, params, 4)
    for remat in ("full", "dots"):
        np.testing.assert_allclose(_train(model, params, 4, remat=remat),
                                   base, rtol=1e-4)
    np.testing.assert_allclose(_train(model, params, 4, microbatches=2),
                               base, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("k", [3, 8], ids=["remainder", "more-than-rows"])
def test_microbatches_must_divide_the_batch(tiny, k):
    """A batch of 4 rows cut into 3 or 8 microbatches raises, as the
    reference's reshape(k, b // k, ...) does, instead of training on part
    of the batch."""
    jm, jp, model, params, batches = tiny
    jstep = j_make_step(jm, jadamw.OptimizerConfig(**OPT),
                        JRunKnobs(rules_preset="dp", microbatches=k,
                                  loss_chunk=0))
    with pytest.raises(TypeError):
        jstep(jp, jadamw.adamw_init(jp),
              {n: jnp.asarray(v) for n, v in batches[0].items()})
    step = make_train_step(model, tadamw.OptimizerConfig(**OPT),
                           RunKnobs(rules_preset="dp", microbatches=k,
                                    loss_chunk=0))
    with pytest.raises(ValueError, match=f"4 rows .* {k} microbatches"):
        step(params, tadamw.adamw_init(params),
             {n: torch.from_numpy(v) for n, v in batches[0].items()})


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_loss_decreases(tiny, compression):
    losses = _train(tiny[2], tiny[3], 20, compression=compression)
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_gradients(tiny, remat):
    model, params = tiny[2], tiny[3]
    batch = {k: torch.from_numpy(v) for k, v in tiny[4][0].items()}

    def grads(policy):
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        it = iter(live)
        tracked = tree_map(lambda _: next(it), params)
        total, _ = model.loss(tracked, batch, remat=policy)
        return total, torch.autograd.grad(total, live)

    l0, g0 = grads("none")
    l1, g1 = grads(remat)
    assert float(l1.detach()) == float(l0.detach())
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)
    with pytest.raises(ValueError, match="remat"):
        model.loss(params, batch, remat="bogus")


def test_init_train_state_on_the_port():
    model = Model(port_cfg(TINY), device="cpu")
    params, state = init_train_state(model, 0, RunKnobs(compression="topk"))
    assert set(state) == {"mu", "nu", "step", "error"}
    assert [e.shape for e in tree_leaves(state["error"])] == [
        p.shape for p in tree_leaves(params)]
    assert all(e.dtype == torch.float32 and float(e.abs().max()) == 0
               for e in tree_leaves(state["error"]))
    params, state = init_train_state(model, 0, RunKnobs())
    assert "error" not in state

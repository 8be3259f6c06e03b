"""The port's Mamba2 hybrid (Zamba2) against the reference, on the CPU.

Weights come from the reference's ``Model.init`` through
``repro_torch.models.bridge.params_from_numpy`` and inputs from numpy
with a seed, so both sides see the same numbers:

* the non-gated GELU ``mlp``, ``_blocked_attend``, ``attend``'s ``auto``
  dispatch and cache-free ``self_attention`` (the shared block's pieces);
* ``mamba2_block``, one layer;
* ``Model.forward`` (hidden state) and ``Model.loss`` (loss, accuracy,
  tokens) of ``reduced(zamba2-1.2b)`` under the reference's
  ``gla_impl="jnp"`` and ``"pallas"`` (its kernel in interpret mode; the
  port's CPU path is the kernel's plain version), and of
  ``reduced(gemma-7b)``.

Tolerances (f32).  One layer: 1e-5 relative to the layer's largest
output (matmul reassociation: XLA's CPU dot against PyTorch's).  The whole
38-layer stack amplifies such differences: the reference's random init
takes each weight's fan-in from the layer-stacked shape (2 superblocks),
so its weights have std 1/sqrt(2) and the stack is chaotic.  Measured in
units of the bar of ``tests/test_arch_smoke.py::test_pallas_gla_impl_
matches_jnp`` (rtol 2e-3, atol 5e-3), the port's hidden state lies 0.33
to 1.03 times that bar from the reference's on the four cases below (the
largest, 1.03, under ``gla_impl="jnp"`` at B=1, S=24).  So it is held to
1.25 times the reference's bar, rtol 2.5e-3 and atol 6.25e-3; the loss,
a mean over tokens, to 1e-4 (measured 3e-6 to 1.3e-5); accuracy and the
token count exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import Model as JaxModel
from repro.models import attention as jattention
from repro.models import mlp as jmlp
from repro.models import ssm as jssm
from repro_torch.configs import ModelConfig, get_config, reduced
from repro_torch.models import Model, attention, mlp, ssm
from repro_torch.models.bridge import params_from_numpy

torch.set_num_threads(1)

LAYER_REL = 1e-5
HIDDEN_TOL = dict(rtol=2.5e-3, atol=6.25e-3)
LOSS_ATOL = 1e-4
F32 = dict(rtol=2e-5, atol=2e-5)


def port_cfg(jcfg):
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{n: getattr(jcfg, n) for n in names})


@pytest.fixture(scope="module")
def zamba():
    jcfg = jax_reduced(jax_get_config("zamba2-1.2b"))
    jp = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               "cpu")
    return jcfg, jp, cfg, params


def test_reduced_config_is_the_references():
    for arch in ("zamba2-1.2b", "gemma-7b"):
        assert port_cfg(jax_reduced(jax_get_config(arch))) == \
            reduced(get_config(arch))
        assert port_cfg(jax_get_config(arch)) == get_config(arch)


def test_bridge_keeps_the_shared_tree_and_f32_leaves(zamba):
    jcfg, jp, cfg, params = zamba
    assert set(params) == {"embed", "blocks", "final_norm", "shared"}
    assert len(params["blocks"]) == cfg.n_layers
    assert params["blocks"][9] == {} and params["blocks"][28] == {}
    mixer = params["blocks"][0]["mixer"]
    assert {k for k, v in mixer.items() if v.dtype == torch.float32} >= {
        "A_log", "D", "dt_bias", "norm_scale"}
    np.testing.assert_array_equal(
        params["blocks"][19 + 3]["mixer"]["A_log"].numpy(),
        np.asarray(jp["blocks"]["3_mamba2"]["mixer"]["A_log"][1]))
    assert set(params["shared"]["mlp"]) == {"wi", "wo"}  # GELU: no gate


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_gelu_mlp_matches_reference(zamba):
    jcfg, jp, cfg, params = zamba
    x = np.random.default_rng(0).normal(size=(2, 16, cfg.d_model)).astype(
        np.float32)
    want = jmlp.mlp(jp["shared"]["mlp"], jnp.asarray(x), jcfg)
    got = mlp.mlp(params["shared"]["mlp"], _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,q_offset,bq,bk", [
    (2, 64, 64, 4, 4, 16, True, 0, 16, 32),
    (1, 70, 70, 4, 2, 16, True, 0, 16, 32),    # ragged, GQA
    (2, 40, 100, 4, 1, 8, True, 60, 16, 32),   # queries at the end
    (1, 48, 48, 2, 2, 16, False, 0, 32, 16),   # non-causal
])
def test_blocked_attend_matches_reference(B, Sq, Sk, H, KV, D, causal,
                                          q_offset, bq, bk):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    want = jattention._blocked_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=bq, block_kv=bk, q_offset=q_offset)
    got = attention._blocked_attend(_t(q), _t(k), _t(v), causal=causal,
                                    block_q=bq, block_kv=bk,
                                    q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("impl,S,kv_len,chosen", [
    ("auto", 24, None, "dense"),      # Sk < 2 * attn_block_kv
    ("auto", 64, None, "blocked"),    # Sk >= 2 * attn_block_kv (32)
    ("auto", 64, 50, "dense"),        # a kv_len: the decode rule
    ("blocked", 24, None, "blocked"),
    ("pallas", 40, None, "pallas"),   # the kernel's plain version here
    ("dense", 64, None, "dense"),
])
def test_attend_dispatch_matches_reference(zamba, monkeypatch, impl, S,
                                           kv_len, chosen):
    jcfg, _, cfg, _ = zamba
    jcfg = dataclasses.replace(jcfg, attn_impl=impl)
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(1, S, 4, 16)).astype(np.float32)
               for _ in range(3))
    calls = []
    for impl_name, module, fn in (
            ("dense", attention, "_dense_attend"),
            ("blocked", attention, "_blocked_attend"),
            ("pallas", attention.ops, "flash_attention")):
        real = getattr(module, fn)
        monkeypatch.setattr(module, fn,
                            lambda *a, _r=real, _n=impl_name, **kw:
                            (calls.append(_n), _r(*a, **kw))[1])
    want = jattention.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             cfg=jcfg, kv_len=kv_len)
    got = attention.attend(_t(q), _t(k), _t(v), cfg=cfg, kv_len=kv_len)
    assert calls == [chosen]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_cache_free_self_attention_matches_reference(zamba):
    jcfg, jp, cfg, params = zamba
    x = np.random.default_rng(3).normal(size=(2, 20, cfg.d_model)).astype(
        np.float32)
    want, _ = jattention.self_attention(jp["shared"]["attn"], jnp.asarray(x),
                                        cfg=jcfg, positions=jnp.arange(20))
    got, cache = attention.self_attention(params["shared"]["attn"], _t(x),
                                          cfg=cfg,
                                          positions=torch.arange(20))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("gla_impl", ["jnp", "pallas"])
def test_mamba2_block_matches_reference(zamba, gla_impl):
    jcfg, jp, cfg, params = zamba
    jcfg = dataclasses.replace(jcfg, gla_impl=gla_impl)
    cfg = dataclasses.replace(cfg, gla_impl=gla_impl)
    u = np.random.default_rng(4).normal(size=(2, 40, cfg.d_model)).astype(
        np.float32)  # 40 steps: two full chunks of 16 and a ragged one
    jb = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["0_mamba2"])
    want = np.asarray(jssm.mamba2_block(jb["mixer"], jnp.asarray(u), jcfg))
    got = ssm.mamba2_block(params["blocks"][0]["mixer"], _t(u), cfg).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=LAYER_REL,
                               atol=LAYER_REL * scale)


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1).astype(np.int32)


# test_arch_smoke's batches: make_batch's default, and the one its
# test_pallas_gla_impl_matches_jnp uses
@pytest.mark.parametrize("B,S", [(2, 32), (1, 24)])
@pytest.mark.parametrize("gla_impl", ["jnp", "pallas"])
def test_zamba2_forward_and_loss_match_reference(zamba, gla_impl, B, S):
    jcfg, jp, cfg, params = zamba
    jm = JaxModel(dataclasses.replace(jcfg, gla_impl=gla_impl))
    tm = Model(dataclasses.replace(cfg, gla_impl=gla_impl), device="cpu")
    tokens, labels = _batch(cfg, B, S)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(tokens),
              "labels": torch.from_numpy(labels)}
    hj, auxj = jm.forward(jp, jbatch)
    ht, auxt = tm.forward(params, tbatch)
    assert ht.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **HIDDEN_TOL)
    assert float(auxt) == float(auxj) == 0.0
    # loss_chunk 8 splits the sequence as the reference's scan does
    totj, mj = jm.loss(jp, jbatch, loss_chunk=8)
    tott, mt = tm.loss(params, tbatch, loss_chunk=8)
    assert abs(float(mt["loss"]) - float(mj["loss"])) <= LOSS_ATOL
    assert abs(float(tott) - float(totj)) <= LOSS_ATOL
    assert float(mt["accuracy"]) == float(mj["accuracy"])
    assert float(mt["tokens"]) == float(mj["tokens"]) == B * S


def test_loss_masks_and_chunks_like_the_reference(zamba):
    """Negative labels are masked out, and the chunked loss equals the
    whole-sequence one."""
    jcfg, jp, cfg, params = zamba
    tokens, labels = _batch(cfg, 2, 32, seed=1)
    labels[0, :5] = -1
    tm = Model(cfg, device="cpu")
    tb = {"tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels)}
    whole, mw = tm.loss(params, tb)
    chunked, mc = tm.loss(params, tb, loss_chunk=16)
    _, mj = JaxModel(jcfg).loss(jp, {"tokens": jnp.asarray(tokens),
                                     "labels": jnp.asarray(labels)})
    assert float(mw["tokens"]) == float(mj["tokens"]) == 64 - 5
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=1e-6)
    assert abs(float(mw["loss"]) - float(mj["loss"])) <= LOSS_ATOL


def test_gemma_forward_and_loss_match_reference():
    """The dense stack's forward (attn_impl auto) and loss."""
    jcfg = jax_reduced(jax_get_config("gemma-7b"))
    jp = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               "cpu")
    tokens, labels = _batch(cfg, 2, 64)  # Sk 64: the blocked path
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels)}
    hj, _ = JaxModel(jcfg).forward(jp, jb)
    ht, _ = Model(cfg, device="cpu").forward(params, tb)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-4,
                               atol=1e-4)
    _, mj = JaxModel(jcfg).loss(jp, jb)
    _, mt = Model(cfg, device="cpu").loss(params, tb)
    assert abs(float(mt["loss"]) - float(mj["loss"])) <= LOSS_ATOL
    assert float(mt["accuracy"]) == float(mj["accuracy"])


def test_serve_paths_raise_on_a_hybrid_stack(zamba):
    _, _, cfg, params = zamba
    model = Model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.init_paged_cache(4, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.forward(params, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                      remat="full")


def test_port_init_runs_the_hybrid_stack():
    """The port's own random init (a torch.Generator) gives a finite
    forward and a loss near log(vocab) at the reduced width."""
    cfg = reduced(get_config("zamba2-1.2b"))
    model = Model(cfg, device="cpu")
    params = model.init(0)
    assert params["blocks"][0]["mixer"]["A_log"].dtype == torch.float32
    tokens, labels = _batch(cfg, 1, 24)
    total, m = model.loss(params, {"tokens": torch.from_numpy(tokens),
                                   "labels": torch.from_numpy(labels)})
    assert torch.isfinite(total)
    assert abs(float(m["loss"]) - np.log(cfg.vocab_size)) < 3.0

"""The port's model against ``repro.models.Model`` at the same chunking.

Weights come from the reference's ``Model.init`` through
``repro_torch.models.bridge.params_from_numpy``, so both sides start from
the same parameters.  Two slots are prefilled chunk by chunk through
``prefill_chunk_slot_paged`` (permuted page tables, an idle third slot on
the scratch group), then decoded three steps with ``decode_step_multi``.

Tolerances (f32): logits atol 1e-4, KV pools atol 5e-5.  The reference's
own chunked and whole-prompt prefill already differ by up to 3.3e-5 in
the KV cache (ROADMAP queue 3), so pools are held to the same order,
and logits, which sum over d_model and the vocab projection, to 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JaxModelConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import Model as JaxModel
from repro_torch.configs import ModelConfig, get_config, reduced
from repro_torch.models import Model
from repro_torch.models.bridge import params_from_numpy

torch.set_num_threads(1)

LOGITS_TOL = dict(rtol=0, atol=1e-4)
POOL_TOL = dict(rtol=0, atol=5e-5)

TINY = JaxModelConfig(
    name="tiny-lm", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
    param_dtype="float32", compute_dtype="float32", vocab_pad_multiple=64,
    rope_theta=10_000.0,
)
CONFIGS = {"tiny": TINY, "gemma-7b-smoke": jax_reduced(jax_get_config(
    "gemma-7b"))}


def port_cfg(jcfg):
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{n: getattr(jcfg, n) for n in names})


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    jcfg = CONFIGS[request.param]
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               "cpu")
    return jm, jp, Model(cfg, device="cpu"), params


def test_reduced_config_matches_reference():
    """The port's own ``reduced(get_config("gemma-7b"))`` is the
    reference's, field for field, and the full config too."""
    assert reduced(get_config("gemma-7b")) == port_cfg(
        jax_reduced(jax_get_config("gemma-7b")))
    assert get_config("gemma-7b") == port_cfg(jax_get_config("gemma-7b"))


def test_bridge_unstacks_layers(pair):
    jm, jp, model, params = pair
    cfg = model.cfg
    assert len(params["blocks"]) == cfg.n_layers
    for i, blk in enumerate(params["blocks"]):
        np.testing.assert_array_equal(
            blk["attn"]["wq"].numpy(),
            np.asarray(jp["blocks"]["0_attn"]["attn"]["wq"][i]))
        np.testing.assert_array_equal(
            blk["mlp"]["wo"].numpy(),
            np.asarray(jp["blocks"]["0_attn"]["mlp"]["wo"][i]))
    assert params["embed"].shape == (cfg.padded_vocab, cfg.d_model)


def _pools(jcache, cache):
    for layer, blk in enumerate(cache["blocks"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                blk[name].numpy(),
                np.asarray(jcache["blocks"]["0_attn"][name][layer]),
                **POOL_TOL)


def test_paged_prefill_and_decode_match_reference(pair):
    jm, jp, model, params = pair
    G, T, MAXG, chunk = 12, 16, 4, 4
    rng = np.random.default_rng(0)
    V = model.cfg.vocab_size
    prompts = [rng.integers(1, V, size=13), rng.integers(1, V, size=6)]
    rows = np.zeros((3, MAXG), np.int32)  # slot 2 idles on scratch group 0
    rows[0, :2] = [5, 2]
    rows[1, :1] = [9]
    jcache = jm.init_paged_cache(G, T)
    cache = model.init_paged_cache(G, T)
    slot_prefill = jax.jit(jm.prefill_chunk_slot_paged)
    decode = jax.jit(jm.decode_step_multi)
    last = []
    for b, prompt in enumerate(prompts):
        for s in range(0, len(prompt), chunk):
            piece = prompt[None, s:s + chunk]
            jl, jcache = slot_prefill(
                jp, {"tokens": jnp.asarray(piece, jnp.int32)}, jcache,
                jnp.asarray(rows[b]), jnp.asarray(s, jnp.int32))
            tl, cache = model.prefill_chunk_slot_paged(
                params, {"tokens": torch.from_numpy(piece)}, cache,
                torch.from_numpy(rows[b]), s)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGITS_TOL)
        last.append(int(np.argmax(np.asarray(jl)[0, -1, :V])))
    _pools(jcache, cache)

    lengths = np.asarray([13, 6, 0], np.int32)
    feed = np.asarray([last[0], last[1], 0])
    for _ in range(3):
        jl, jcache = decode(
            jp, jnp.asarray(feed[:, None], jnp.int32), jcache,
            jnp.asarray(lengths), jnp.asarray(rows))
        tl, cache = model.decode_step_multi(
            params, torch.from_numpy(feed[:, None]), cache,
            torch.from_numpy(lengths), torch.from_numpy(rows))
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                                   **LOGITS_TOL)
        feed = np.argmax(np.asarray(jl)[:, -1, :V], axis=-1)
        lengths = lengths + np.asarray([1, 1, 0], np.int32)
    _pools(jcache, cache)


def test_init_draws_on_the_model_device_from_a_seed(pair):
    _, _, model, _ = pair
    a, b = model.init(3), model.init(3)
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], model.init(4)["embed"])
    assert a["blocks"][0]["attn"]["wq"].device.type == "cpu"
    assert a["blocks"][0]["attn"]["wq"].shape == (
        model.cfg.d_model, model.cfg.n_heads, model.cfg.head_dim_)

"""Port layers against their reference counterparts, f32 on the CPU.

Each case builds its inputs and weights with numpy from a seed and hands
the same arrays to ``repro.models`` (JAX) and ``repro_torch.models``.
Tolerance atol 1e-5: every quantity here is O(1) and the two sides differ
only in the order of f32 sums (XLA's CPU dots against PyTorch's).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro_torch.models import attention, common, mlp
from test_torch_model import TINY, port_cfg

torch.set_num_threads(1)

ATOL = dict(rtol=0, atol=1e-5)

CFG = port_cfg(TINY)


def _np(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, s = _np(rng, 3, 5, 64), _np(rng, 64)
    np.testing.assert_allclose(
        common.rms_norm(_t(x), _t(s)).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(s))), **ATOL)


@pytest.mark.parametrize("pos_shape", [(7,), (3, 7)])
def test_rope(pos_shape):
    rng = np.random.default_rng(1)
    x = _np(rng, 3, 7, 4, 16)
    pos = rng.integers(0, 300, size=pos_shape)
    jcos, jsin = jcommon.rope_freqs(jnp.asarray(pos), 16, 10_000.0)
    cos, sin = common.rope_freqs(_t(pos), 16, 10_000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **ATOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **ATOL)
    np.testing.assert_allclose(
        common.apply_rope(_t(x), cos, sin).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jcos, jsin)), **ATOL)


@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_mlp(activation):
    rng = np.random.default_rng(2)
    jcfg = dataclasses.replace(TINY, activation=activation)
    p = {"wi": _np(rng, 64, 128) / 8, "wg": _np(rng, 64, 128) / 8,
         "wo": _np(rng, 128, 64) / 11}
    x = _np(rng, 2, 5, 64)
    want = jmlp.mlp({k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x), jcfg)
    got = mlp.mlp({k: _t(v) for k, v in p.items()}, _t(x),
                  port_cfg(jcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)


def _attn_params(rng):
    return {"wq": _np(rng, 64, 4, 16) / 8, "wk": _np(rng, 64, 2, 16) / 8,
            "wv": _np(rng, 64, 2, 16) / 8, "wo": _np(rng, 4, 16, 64) / 8}


def test_self_attention_paged_append_and_decode():
    """One decode token per slot appended through the page table, then
    paged attention (reference: the paged single-token branch of
    ``self_attention`` with its jnp gather oracle on the CPU)."""
    rng = np.random.default_rng(3)
    p = _attn_params(rng)
    B, G, T, MAXG = 3, 10, 16, 3
    kp, vp = _np(rng, G, T, 2, 16), _np(rng, G, T, 2, 16)
    pt = (1 + rng.permutation(G - 1)[:B * MAXG]).reshape(B, MAXG)
    pt = pt.astype(np.int32)
    lengths = np.asarray([0, 17, 40], np.int32)
    x = _np(rng, B, 1, 64)
    pos = lengths[:, None]
    want, wcache = jattn.self_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), cfg=TINY,
        positions=jnp.asarray(pos),
        cache={"k": jnp.asarray(kp), "v": jnp.asarray(vp)},
        cache_index=jnp.asarray(lengths), page_table=jnp.asarray(pt))
    cache = {"k": _t(kp), "v": _t(vp)}
    got, gcache = attention.self_attention(
        {k: _t(v) for k, v in p.items()}, _t(x), cfg=CFG,
        positions=_t(pos), cache=cache, cache_index=_t(lengths),
        page_table=_t(pt))
    assert gcache is cache  # appended in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(gcache[name].numpy(),
                                   np.asarray(wcache[name]), **ATOL)


@pytest.mark.parametrize("index,chunk", [(0, 5), (7, 4)])
def test_self_attention_chunk_append(index, chunk):
    """A prompt chunk appended at a scalar cache index, then dense causal
    attention over the valid prefix (the chunked-prefill branch)."""
    rng = np.random.default_rng(4)
    p = _attn_params(rng)
    S = 16
    kb, vb = _np(rng, 1, S, 2, 16), _np(rng, 1, S, 2, 16)
    x = _np(rng, 1, chunk, 64)
    pos = index + np.arange(chunk)
    want, wcache = jattn.self_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), cfg=TINY,
        positions=jnp.asarray(pos),
        cache={"k": jnp.asarray(kb), "v": jnp.asarray(vb)},
        cache_index=jnp.asarray(index))
    got, gcache = attention.self_attention(
        {k: _t(v) for k, v in p.items()}, _t(x), cfg=CFG, positions=_t(pos),
        cache={"k": _t(kb), "v": _t(vb)}, cache_index=index)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(gcache[name].numpy(),
                                   np.asarray(wcache[name]), **ATOL)


@pytest.mark.parametrize("chain", [1, 3])
def test_self_attention_per_slot_dense_append(chain):
    """A (B,) cache index on a dense buffer (the dense continuous layout):
    each slot appends its token(s) at its own index and attends over its
    own prefix.  A verify chain (chain > 1) that runs past the buffer
    writes the columns that fit and drops the rest, as the reference's
    scatter does; the logits of the columns that fit are the
    reference's."""
    rng = np.random.default_rng(6)
    p = _attn_params(rng)
    S = 8
    kb, vb = _np(rng, 2, S, 2, 16), _np(rng, 2, S, 2, 16)
    x = _np(rng, 2, chain, 64)
    idx = np.asarray([3, S - 2], np.int32)
    pos = idx[:, None] + np.arange(chain)
    want, wcache = jattn.self_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), cfg=TINY,
        positions=jnp.asarray(pos),
        cache={"k": jnp.asarray(kb), "v": jnp.asarray(vb)},
        cache_index=jnp.asarray(idx))
    got, gcache = attention.self_attention(
        {k: _t(v) for k, v in p.items()}, _t(x), cfg=CFG, positions=_t(pos),
        cache={"k": _t(kb), "v": _t(vb)}, cache_index=torch.from_numpy(idx))
    fits = min(chain, 2)  # slot 1's columns past the buffer are dropped
    np.testing.assert_allclose(got.numpy()[0], np.asarray(want)[0], **ATOL)
    np.testing.assert_allclose(got.numpy()[1, :fits],
                               np.asarray(want)[1, :fits], **ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(gcache[name].numpy(),
                                   np.asarray(wcache[name]), **ATOL)


def test_unported_attention_paths_raise():
    """Cache-free attention, the blocked impl and the per-slot dense cache
    are ported (held to the reference in tests/test_torch_ssm.py and
    above); the banded sliding-window impl is not."""
    rng = np.random.default_rng(5)
    q = _t(_np(rng, 1, 16, 4, 16))
    with pytest.raises(NotImplementedError, match="impl 'local'"):
        attention.attend(q, q, q, cfg=CFG, impl="local", window=4)

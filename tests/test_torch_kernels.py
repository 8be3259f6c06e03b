"""Port kernels against the reference, on the CPU.

``repro_torch.kernels.ops.paged_flash_decode`` on CPU tensors (the plain
PyTorch version of the CUDA kernel) against the reference Pallas kernel
``paged_flash_decode_pallas`` run in interpret mode, on the same numpy
inputs.  Tolerances are the reference's own kernel tolerances
(``tests/test_kernels.py::TOL``): f32 2e-5, bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_flash_decode_pallas
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import _check, paged_attention_ref
from repro_torch.kernels.ref import attention_ref

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _bf16_exact(a: np.ndarray, dtype: str) -> np.ndarray:
    """Round f32 inputs to bf16 once, so both sides see identical bits."""
    if dtype == "bfloat16":
        return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                        .astype(jnp.float32))
    return a


def _case(seed, B, H, KV, D, T, maxg, dtype, extra=3):
    rng = np.random.default_rng(seed)
    G = B * maxg + extra
    q = _bf16_exact(rng.normal(size=(B, H, D)).astype(np.float32), dtype)
    kp = _bf16_exact(rng.normal(size=(G, T, KV, D)).astype(np.float32), dtype)
    vp = _bf16_exact(rng.normal(size=(G, T, KV, D)).astype(np.float32), dtype)
    # random non-identity table over groups 1..G-1, unique per entry
    pt = (1 + rng.permutation(G - 1)[:B * maxg]).reshape(B, maxg)
    lengths = rng.integers(1, maxg * T, size=B)
    return q, kp, vp, pt.astype(np.int32), lengths.astype(np.int32)


def _both(arrs, dtype):
    jdt, tdt = DTYPES[dtype]
    q, kp, vp, pt, ln = arrs
    jx = (jnp.asarray(q).astype(jdt), jnp.asarray(kp).astype(jdt),
          jnp.asarray(vp).astype(jdt), jnp.asarray(pt), jnp.asarray(ln))
    tx = (torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
          torch.from_numpy(vp).to(tdt), torch.from_numpy(pt),
          torch.from_numpy(ln))
    return jx, tx


# the reference kernel tests' shapes (tests/test_kernels.py TestPagedDecode)
SHAPES = [
    (1, 2, 2, 8, 16, 2),
    (2, 8, 2, 16, 32, 3),   # GQA, multi-page
    (3, 4, 1, 32, 16, 4),   # MQA
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,D,T,maxg", SHAPES)
def test_paged_decode_matches_pallas_interpret(dtype, B, H, KV, D, T, maxg):
    arrs = _case(hash((B, H, KV, D, T)) % 2**31, B, H, KV, D, T, maxg, dtype)
    jx, tx = _both(arrs, dtype)
    want = paged_flash_decode_pallas(*jx, interpret=True)
    got = ops.paged_flash_decode(*tx)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (B, H, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_paged_decode_page_table_permutation_invariance():
    """Scattering the same logical cache over other physical groups
    leaves the plain version's output unchanged (reference test of the
    same name)."""
    rng = np.random.default_rng(11)
    B, H, KV, D, T, maxg = 2, 4, 2, 16, 16, 3
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    lk = rng.normal(size=(B, maxg * T, KV, D)).astype(np.float32)
    lv = rng.normal(size=(B, maxg * T, KV, D)).astype(np.float32)
    lengths = torch.tensor([40, 17], dtype=torch.int32)
    outs = []
    for seed in (0, 1):
        pt = (1 + np.random.default_rng(seed).permutation(B * maxg)
              ).reshape(B, maxg)
        kp = np.zeros((B * maxg + 2, T, KV, D), np.float32)
        vp = np.zeros_like(kp)
        for b in range(B):
            for g in range(maxg):
                kp[pt[b, g]] = lk[b, g * T:(g + 1) * T]
                vp[pt[b, g]] = lv[b, g * T:(g + 1) * T]
        outs.append(ops.paged_flash_decode(
            q, torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(pt.astype(np.int32)), lengths).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 0), (False, 0, 0), (True, 8, 5)])
def test_attention_ref_matches_reference(causal, window, q_offset):
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 20, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 20, 2, 16)).astype(np.float32)
    want = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window, q_offset=q_offset)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal, window=window,
                        q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


def test_plain_version_matches_dense_oracle():
    """The gather-then-attend plain version equals dense attention over
    each sequence's logically ordered valid prefix."""
    q, kp, vp, pt, ln = _case(5, 2, 8, 2, 16, 32, 3, "float32")
    out = paged_attention_ref(*(torch.from_numpy(a)
                                for a in (q, kp, vp, pt, ln)))
    kd = kp[pt].reshape(2, -1, 2, 16)
    vd = vp[pt].reshape(2, -1, 2, 16)
    for b in range(2):
        L = int(ln[b])
        dense = attention_ref(torch.from_numpy(q[b:b + 1, None]),
                              torch.from_numpy(kd[b:b + 1, :L]),
                              torch.from_numpy(vd[b:b + 1, :L]),
                              causal=False)[:, 0]
        np.testing.assert_allclose(out[b:b + 1].numpy(), dense.numpy(),
                                   **TOL["float32"])


def _good():
    return (torch.zeros(2, 4, 16), torch.zeros(5, 16, 2, 16),
            torch.zeros(5, 16, 2, 16), torch.ones(2, 2, dtype=torch.int32),
            torch.ones(2, dtype=torch.int32))


@pytest.mark.parametrize("bad,match", [
    (lambda a: (a[0].double(),) + a[1:], "not supported"),
    (lambda a: (a[0], a[1].bfloat16(), a[2], a[3], a[4]), "share one dtype"),
    (lambda a: a[:3] + (a[3].long(), a[4]), "int32"),
    (lambda a: (torch.zeros(2, 3, 16),) + a[1:], "multiple of KV"),
    (lambda a: (torch.zeros(2, 4, 24), torch.zeros(5, 16, 2, 24),
                torch.zeros(5, 16, 2, 24)) + a[3:], "head dim 24"),
    (lambda a: (a[0], torch.zeros(5, 8, 2, 16), torch.zeros(5, 8, 2, 16))
     + a[3:], "multiple of 16"),
    (lambda a: (a[0], a[1].transpose(0, 1).contiguous().transpose(0, 1))
     + a[2:], "contiguous"),
    (lambda a: a[:4] + (torch.ones(3, dtype=torch.int32),), "lengths"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    """The CUDA launch path validates its inputs before any launch."""
    with pytest.raises((ValueError, TypeError), match=match):
        _check(*bad(_good()), num_warps=4)


def test_wrapper_rejects_bad_num_warps():
    _check(*_good(), num_warps=4)
    with pytest.raises(ValueError, match="num_warps"):
        _check(*_good(), num_warps=3)


def test_ops_resolves_explicit_over_default():
    assert ops._resolve("paged_attention", {"num_warps": None}) == \
        ops.DEFAULT_BLOCKS["paged_attention"]
    assert ops._resolve("paged_attention", {"num_warps": 8}) == \
        {"num_warps": 8}

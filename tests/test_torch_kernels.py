"""Port kernels against the reference, on the CPU.

Each entry point of ``repro_torch.kernels.ops`` on CPU tensors (the plain
PyTorch version of its CUDA kernel) against the reference Pallas kernel
run in interpret mode, on the same numpy inputs and the shapes of
``tests/test_kernels.py``: ``paged_flash_decode`` against
``paged_flash_decode_pallas``, ``flash_attention`` against
``flash_attention_pallas``, ``flash_decode`` against
``flash_decode_pallas`` and ``rmsnorm`` against ``rmsnorm_pallas``.
Tolerances are the reference's own kernel tolerances
(``tests/test_kernels.py::TOL``): f32 2e-5, bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import flash_decode_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.paged_attention import paged_flash_decode_pallas
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.kernels.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro_torch import autotune
from repro_torch.kernels import decode_attention as fd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.paged_attention import _check, paged_attention_ref
from repro_torch.kernels.ref import attention_ref, rmsnorm_ref

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


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    autotune.reset_default_cache()
    yield
    autotune.reset_default_cache()


def test_ops_resolves_explicit_over_default(tmp_cache):
    dims = {"B": 2, "S": 64, "H": 4, "KV": 2, "D": 16}
    default = ops.DEFAULT_BLOCKS["paged_attention"]
    assert ops._resolve("paged_attention", dims, torch.float32, "cpu",
                        {"num_warps": None}) == default
    assert ops._resolve("paged_attention", dims, torch.float32, "cpu",
                        {"num_warps": 8}) == dict(default, num_warps=8)
    autotune.default_cache().put("paged_attention",
                                 autotune.shape_sig(dims), "float32",
                                 "model-sm90",
                                 {"pages_per_block": 2, "num_warps": 4}, 1.0)
    assert ops._resolve("paged_attention", dims, torch.float32, "cpu",
                        {"num_warps": None}) == {"pages_per_block": 2,
                                                 "num_warps": 4}
    assert ops._resolve("paged_attention", dims, torch.float32, "cpu",
                        {"num_warps": 8})["num_warps"] == 8


def _rand(rng, shape, dtype):
    return _bf16_exact(rng.normal(size=shape).astype(np.float32), dtype)


def _pair(a, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _close(got, want, dtype):
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


# tests/test_kernels.py TestFlashAttention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,D,bq,bk", [
    (1, 16, 1, 1, 8, 16, 16),     # minimal
    (2, 64, 4, 2, 16, 32, 32),    # GQA
    (1, 96, 8, 1, 32, 32, 32),    # MQA, non-square blocks
    (2, 100, 4, 4, 16, 32, 16),   # ragged seq vs blocks (padding)
    (1, 128, 2, 2, 64, 64, 128),  # bq < bk
])
def test_flash_attention_matches_pallas_interpret(dtype, B, S, H, KV, D, bq,
                                                  bk):
    rng = np.random.default_rng(hash((B, S, H, KV, D)) % 2**31)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(_rand(rng, shape, dtype), dtype)
        for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    want = flash_attention_pallas(jq, jk, jv, causal=True, block_q=bq,
                                  block_kv=bk, interpret=True)
    _close(ops.flash_attention(tq, tk, tv, block_q=bq, block_kv=bk), want,
           dtype)


@pytest.mark.parametrize("causal,window,q_offset,Sq,Sk", [
    (True, 8, 0, 72, 72),      # sliding windows of the reference tests
    (True, 24, 0, 72, 72),
    (True, 64, 0, 72, 72),
    (False, 0, 0, 48, 48),     # non-causal
    (True, 0, 40, 24, 64),     # queries at the end of a longer cache
    (True, 16, 30, 40, 70),    # ... under a window, ragged tiles
])
def test_flash_attention_masks_match_pallas_interpret(causal, window,
                                                      q_offset, Sq, Sk):
    rng = np.random.default_rng(window + q_offset)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.normal(size=shape).astype(np.float32), "float32")
        for shape in ((2, Sq, 4, 16), (2, Sk, 2, 16), (2, Sk, 2, 16)))
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  q_offset=q_offset, block_q=16,
                                  block_kv=16, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              q_offset=q_offset, block_q=16, block_kv=16)
    _close(got, want, "float32")


# tests/test_kernels.py TestFlashDecode
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,D,bkv", [
    (1, 32, 2, 2, 8, 16),
    (2, 96, 8, 2, 16, 32),
    (1, 100, 4, 1, 32, 32),   # MQA + ragged cache
])
def test_flash_decode_matches_pallas_interpret(dtype, B, S, H, KV, D, bkv):
    rng = np.random.default_rng(hash((B, S, H, KV, D)) % 2**31)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(_rand(rng, shape, dtype), dtype)
        for shape in ((B, H, D), (B, S, KV, D), (B, S, KV, D)))
    for kv_len in (1, S // 3, S):
        want = flash_decode_pallas(jq, jk, jv, kv_len, block_kv=bkv,
                                   interpret=True)
        _close(ops.flash_decode(tq, tk, tv, kv_len, block_kv=bkv), want,
               dtype)
        # a 0-d int32 tensor, as a decode loop holds the length
        _close(ops.flash_decode(tq, tk, tv,
                                torch.tensor(kv_len, dtype=torch.int32)),
               want, dtype)


# tests/test_kernels.py TestRMSNorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,block", [
    ((4, 32), 4), ((3, 7, 64), 16), ((1, 128), 256), ((5, 100), 32),
])
def test_rmsnorm_matches_pallas_interpret(dtype, shape, block):
    rng = np.random.default_rng(hash(shape) % 2**31)
    jx, tx = _pair(_rand(rng, shape, dtype), dtype)
    s = rng.normal(size=(shape[-1],)).astype(np.float32)
    want = rmsnorm_pallas(jx, jnp.asarray(s), block_rows=block,
                          interpret=True)
    got = ops.rmsnorm(tx, torch.from_numpy(s), block_rows=block)
    assert tuple(got.shape) == shape
    _close(got, want, dtype)


def test_plain_versions_match_reference_oracles():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(6, 48)).astype(np.float32)
    s = rng.normal(size=(48,)).astype(np.float32)
    np.testing.assert_allclose(
        rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(jax_rmsnorm_ref(jnp.asarray(x), jnp.asarray(s))),
        **TOL["float32"])
    q = torch.from_numpy(rng.normal(size=(2, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 30, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 30, 2, 16)).astype(np.float32))
    want = attention_ref(q[:, None], k[:, :11], v[:, :11], causal=False)
    np.testing.assert_allclose(fd.decode_attention_ref(q, k, v, 11).numpy(),
                               want[:, 0].numpy(), **TOL["float32"])


def test_smem_footprints():
    """The figures the C launchers report, by formula: the bf16 flash
    kernel's aligned Q tile, two K/V stages and barriers, the f32 flash
    kernel's f32 query tile, accumulator and row state plus padded K/V
    tiles; the decode kernels' per-warp and merged softmax state."""
    assert fa.smem_bytes(256, "bfloat16", 64, 32) == (
        1024 + 64 * 256 * 2 + 4 * 32 * 256 * 2 + 64)
    assert fa.smem_bytes(8, "float32", 16, 16) == (
        (2 * 16 * 8 + 2 * 16) * 4 + 2 * 16 * 9 * 4)
    assert fd.smem_bytes(16, 16, 256) == (64 + 256 + 2) * 4
    assert fd.smem_bytes(24, 2, 64) == (64 * 8 + 8 * 64 + 2 * 8) * 4
    assert rn.smem_bytes() == 0


@pytest.mark.parametrize("D,block_q,block_kv,bf16_bytes", [
    # 1024 alignment slack + Q (64 rows a warpgroup) + 2 x (K + V) at the
    # instruction's key tile + 64 bytes of barriers; D padded to 16
    (256, 64, 32, 1024 + 64 * 256 * 2 + 4 * 32 * 256 * 2 + 64),
    (256, 128, 64, 1024 + 128 * 256 * 2 + 4 * 64 * 256 * 2 + 64),
    (256, 64, 128, 1024 + 64 * 256 * 2 + 4 * 128 * 256 * 2 + 64),
    (64, 100, 70, 1024 + 128 * 64 * 2 + 4 * 128 * 64 * 2 + 64),
    (64, 40, 16, 1024 + 64 * 64 * 2 + 4 * 16 * 64 * 2 + 64),
    (8, 16, 5, 1024 + 64 * 16 * 2 + 4 * 16 * 16 * 2 + 64),
], ids=["gemma-default", "gemma-128x64", "gemma-128keys", "ragged",
        "zamba-16keys", "d8"])
def test_flash_smem_bytes_bf16_design_and_f32(D, block_q, block_kv,
                                              bf16_bytes):
    """bf16: the tensor-core design's footprint, the key tile rounded up
    to the instruction's N; f32: today's CUDA-core kernel's."""
    assert fa.smem_bytes(D, "bfloat16", block_q, block_kv) == bf16_bytes
    assert fa.smem_bytes(D, "float32", block_q, block_kv) == (
        (2 * block_q * D + 2 * block_q) * 4 + 2 * block_kv * (D + 1) * 4)
    assert fa.tile_keys(block_kv) == max(16, 1 << (block_kv - 1).bit_length())


@pytest.mark.parametrize("call,match", [
    (lambda: fa._check(torch.zeros(1, 4, 2, 24), torch.zeros(1, 4, 2, 24),
                       torch.zeros(1, 4, 2, 24), 4, 4), "head dim"),
    (lambda: fa._check(torch.zeros(1, 4, 3, 16), torch.zeros(1, 4, 2, 16),
                       torch.zeros(1, 4, 2, 16), 4, 4), "multiple"),
    (lambda: fa._check(torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2, 16),
                       torch.zeros(1, 4, 2, 16), 4, 256), "block_kv"),
    (lambda: fa._check(torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2, 16),
                       torch.zeros(1, 4, 2, 16).double(), 4, 4),
     "share one dtype"),
    (lambda: fd._check(torch.zeros(2, 4, 16), torch.zeros(2, 8, 2, 16),
                       torch.zeros(2, 8, 2, 16),
                       torch.tensor(3, dtype=torch.int64), 4, None),
     "int32"),
    (lambda: fd._check(torch.zeros(2, 4, 16), torch.zeros(2, 8, 2, 16),
                       torch.zeros(2, 8, 2, 16), 3, 4, 3), "num_warps"),
    (lambda: rn._check(torch.zeros(4, 8), torch.zeros(4), 4, None),
     "must be"),
    (lambda: rn._check(torch.zeros(4, 8), torch.zeros(8).bfloat16(), 4,
                       None), "scale must be"),
    (lambda: fa._check(*[torch.zeros(1 + 64 * 2 * 16, dtype=torch.bfloat16)
                         [1:].view(1, 64, 2, 16)] * 3, 64, 32),
     "16-byte aligned"),
    (lambda: fa._check(*[torch.zeros(1, 256, 2, 16, dtype=torch.bfloat16)]
                       * 3, 256, 32), "block_q"),
    (lambda: fa._check(*[torch.zeros(1, 256, 2, 256, dtype=torch.bfloat16)]
                       * 3, 64, 128), "shared memory"),
], ids=["fa-head-dim", "fa-gqa", "fa-block-kv", "fa-dtype", "fd-kv-len",
        "fd-warps", "rn-scale-shape", "rn-scale-dtype", "fa-bf16-align",
        "fa-bf16-block-q", "fa-bf16-smem"])
def test_new_wrappers_reject_what_the_kernels_do_not_take(call, match):
    """The CUDA launch paths validate their inputs before any launch."""
    with pytest.raises((ValueError, TypeError), match=match):
        call()

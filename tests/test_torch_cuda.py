"""The port's CUDA kernels, autotune and engine on an NVIDIA GPU.

Marked ``cuda``: each test skips where there is no card.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(this file imports no JAX, so it also runs where JAX is not installed).
Each kernel is held to its plain PyTorch version with the CPU tests'
tolerances, f32 2e-5 and bf16 2e-2.
"""
import pytest
import torch

from repro_torch import autotune
from repro_torch.configs import ModelConfig
from repro_torch.kernels import decode_attention as fd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.ref import attention_ref, rmsnorm_ref
from repro_torch.models import Model
from repro_torch.serve import ServeConfig, ServeEngine

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(B, H, KV, D, T, maxg, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    G = B * maxg + 1
    q = torch.randn((B, H, D), generator=g, device="cuda").to(dtype)
    kp = torch.randn((G, T, KV, D), generator=g, device="cuda").to(dtype)
    vp = torch.randn((G, T, KV, D), generator=g, device="cuda").to(dtype)
    pt = (1 + torch.randperm(G - 1, generator=g, device="cuda")[:B * maxg]
          ).reshape(B, maxg).to(torch.int32)
    ln = torch.randint(1, maxg * T + 1, (B,), generator=g, device="cuda",
                       dtype=torch.int32)
    return q, kp, vp, pt, ln


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,D,T,maxg", [
    (1, 2, 2, 8, 16, 2),
    (2, 8, 2, 16, 32, 3),     # GQA
    (3, 4, 1, 32, 16, 4),     # MQA
    (2, 24, 2, 64, 16, 3),    # 12 query heads per KV head: two head tiles
    (4, 8, 8, 128, 64, 4),    # T = 64
    (8, 16, 16, 256, 16, 16),  # the Gemma-7B head layout
])
def test_kernel_matches_plain_version(card, dtype, B, H, KV, D, T, maxg):
    case = _case(B, H, KV, D, T, maxg, dtype)
    before = pa.paged_flash_decode_cuda.launches
    got = ops.paged_flash_decode(*case)
    want = pa.paged_attention_ref(*case)
    torch.cuda.synchronize()
    assert pa.paged_flash_decode_cuda.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("num_warps", [None, 1, 2, 8, 16])
def test_kernel_num_warps(card, num_warps):
    case = _case(3, 8, 2, 64, 16, 5, torch.float32, seed=1)
    got = ops.paged_flash_decode(*case, num_warps=num_warps)
    torch.testing.assert_close(got, pa.paged_attention_ref(*case),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_out_of_range_page_table_gives_nan_rows(card):
    q, kp, vp, pt, ln = _case(2, 4, 2, 16, 16, 2, torch.float32)
    pt[1, 0] = kp.shape[0]  # past the pool
    ln[1] = 5
    out = ops.paged_flash_decode(q, kp, vp, pt, ln)
    assert torch.isnan(out[1]).all()
    assert torch.isfinite(out[0]).all()


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(card):
    cfg = ModelConfig(
        name="tiny-lm", family="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
        param_dtype="float32", compute_dtype="float32",
        vocab_pad_multiple=64)
    params = Model(cfg, device="cpu").init(0)
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], [2, 2, 2, 2, 2, 2, 2, 2, 2]]
    scfg = ServeConfig(max_seq=32, batch_slots=2, kv_layout="paged",
                       prefill_chunk=4)
    toks = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(Model(cfg, device=dev), params, scfg, device=dev)
        toks[dev] = eng.generate(prompts, [6, 3, 5]).tokens
    assert toks["cuda"] == toks["cpu"]


def _randn(shape, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,SK,H,KV,D,causal,window,q_offset,bq,bk", [
    (1, 16, 16, 1, 1, 8, True, 0, 0, 16, 16),
    (2, 64, 64, 4, 2, 16, True, 0, 0, 32, 32),      # GQA
    (1, 96, 96, 8, 1, 32, True, 0, 0, 32, 32),      # MQA
    (2, 100, 100, 4, 4, 16, True, 0, 0, 32, 16),    # ragged tiles
    (1, 128, 128, 2, 2, 64, True, 0, 0, 64, 128),   # bq < bk
    (2, 72, 72, 4, 2, 16, True, 24, 0, 16, 16),     # sliding window
    (1, 48, 48, 2, 2, 16, False, 0, 0, 16, 16),     # non-causal
    (2, 40, 70, 4, 2, 16, True, 16, 30, 16, 16),    # q_offset + window
    (1, 200, 260, 16, 16, 256, True, 0, 60, 64, 32),  # Gemma width
])
def test_flash_attention_matches_plain_version(card, dtype, B, S, SK, H, KV,
                                               D, causal, window, q_offset,
                                               bq, bk):
    q = _randn((B, S, H, D), dtype, 1)
    k = _randn((B, SK, KV, D), dtype, 2)
    v = _randn((B, SK, KV, D), dtype, 3)
    before = fa.flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, block_q=bq, block_kv=bk)
    want = attention_ref(q, k, v, causal=causal, window=window,
                         q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,D,bkv", [
    (1, 32, 2, 2, 8, 16),
    (2, 96, 8, 2, 16, 32),
    (1, 100, 4, 1, 32, 32),     # MQA, ragged cache
    (2, 80, 24, 2, 64, 32),     # two head tiles
    (8, 2048, 16, 16, 256, 256),  # the Gemma-7B engine shape
])
def test_flash_decode_matches_plain_version(card, dtype, B, S, H, KV, D,
                                            bkv):
    q = _randn((B, H, D), dtype, 1)
    k = _randn((B, S, KV, D), dtype, 2)
    v = _randn((B, S, KV, D), dtype, 3)
    for kv_len in (1, S // 3, S):
        before = fd.flash_decode_cuda.launches
        kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        got = ops.flash_decode(q, k, v, kl, block_kv=bkv)
        want = fd.decode_attention_ref(q, k, v, kv_len)
        torch.cuda.synchronize()
        assert fd.flash_decode_cuda.launches == before + 1
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
    # an empty cache gives zeros, as the Pallas kernel does
    assert (ops.flash_decode(q, k, v, 0, block_kv=bkv) == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,block_rows,num_warps", [
    ((4, 32), 4, None), ((3, 7, 64), 16, 4), ((1, 128), 256, None),
    ((5, 100), 32, 2), ((4096, 3072), 4, None)])
def test_rmsnorm_matches_plain_version(card, dtype, shape, block_rows,
                                       num_warps):
    x = _randn(shape, dtype, 1)
    s = _randn((shape[-1],), torch.float32, 2)
    before = rn.rmsnorm_cuda.launches
    got = ops.rmsnorm(x, s, block_rows=block_rows, num_warps=num_warps)
    want = rmsnorm_ref(x, s)
    torch.cuda.synchronize()
    assert rn.rmsnorm_cuda.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("call", [
    lambda: ops.flash_attention(_randn((1, 8, 2, 16), torch.float32),
                                torch.zeros(1, 8, 2, 16),
                                torch.zeros(1, 8, 2, 16)),
    lambda: ops.flash_decode(_randn((1, 2, 16), torch.float32),
                             _randn((1, 8, 2, 16), torch.float32),
                             _randn((1, 8, 2, 16), torch.float32),
                             torch.tensor(3, dtype=torch.int32)),
    lambda: ops.rmsnorm(_randn((4, 16), torch.float32), torch.ones(16)),
    lambda: ops.paged_flash_decode(
        _randn((1, 2, 16), torch.float32), torch.zeros(3, 16, 2, 16),
        torch.zeros(3, 16, 2, 16), torch.ones(1, 1, dtype=torch.int32),
        torch.ones(1, dtype=torch.int32)),
], ids=["flash_attention", "flash_decode", "rmsnorm", "paged"])
def test_wrappers_raise_on_mixed_devices(card, call):
    """A CUDA tensor beside a CPU one raises: nothing falls back."""
    with pytest.raises(ValueError, match="is on cpu"):
        call()


@pytest.mark.cuda
def test_autotune_times_on_the_card(card, tmp_path, monkeypatch):
    """mode="time" on the card: the winner persists under cuda-sm<cc>,
    the kernel launched, and ops resolves the winner."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    autotune.reset_default_cache()
    dims = {"ROWS": 512, "D": 1024}
    before = rn.rmsnorm_cuda.launches
    res = autotune.autotune_kernel("rmsnorm", dims, dtype="bfloat16",
                                   budget=4)
    assert res["mode"] == "time" and res["backend"].startswith("cuda-sm")
    assert rn.rmsnorm_cuda.launches > before
    got = ops._resolve("rmsnorm", dims, torch.bfloat16, "cuda",
                       {"block_rows": None, "num_warps": None})
    assert got == res["config"]
    autotune.reset_default_cache()

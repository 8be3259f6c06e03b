"""The port's CUDA kernel and engine on an NVIDIA GPU.

Marked ``cuda``: each test skips where there is no card.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(this file imports no JAX, so it also runs where JAX is not installed).
The kernel is held to its plain PyTorch version with the CPU tests'
tolerances, f32 2e-5 and bf16 2e-2.
"""
import pytest
import torch

from repro_torch.configs import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
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

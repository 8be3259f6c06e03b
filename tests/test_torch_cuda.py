"""The port's CUDA kernels, autotune and engine on an NVIDIA GPU.

Marked ``cuda``: each test skips where there is no card.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(this file imports no JAX, so it also runs where JAX is not installed).
Each kernel is held to its plain PyTorch version with the CPU tests'
tolerances, f32 2e-5 and bf16 2e-2 (for GLA, whose f32 sums have terms as
large as the largest output, the absolute part scales with max |ref|).
"""
import dataclasses

import pytest
import torch

from repro_torch import autotune
from repro_torch.configs import ModelConfig, get_config, reduced
from repro_torch.kernels import decode_attention as fd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gla as gl
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.ref import attention_ref, rmsnorm_ref
from repro_torch.models import Model
from repro_torch.models.gla import chunked_gla
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
@pytest.mark.parametrize("dtype,split_tokens", [
    (torch.float32, None), (torch.float32, 32), (torch.float32, 64),
    (torch.float32, 256), (torch.bfloat16, None), (torch.bfloat16, 64),
    (torch.bfloat16, 192), (torch.bfloat16, 256),
], ids=["f32-auto", "f32-32", "f32-64", "f32-one-split", "bf16-auto",
        "bf16-64", "bf16-192", "bf16-one-split"])
def test_kernel_split_tokens(card, dtype, split_tokens):
    """Splits of 2 to 12 groups of 16 (the f32 tile at D=64 is 32 tokens,
    the bf16 one 64) and one split a row; lengths that end inside a
    split's last group (55, 250), inside a first group (17) and at the
    capacity (256)."""
    q, kp, vp, pt, _ = _case(4, 8, 2, 64, 16, 16, dtype, seed=1)
    ln = torch.tensor([55, 250, 17, 256], dtype=torch.int32, device="cuda")
    got = pa.paged_flash_decode_cuda(q, kp, vp, pt, ln,
                                     split_tokens=split_tokens)
    torch.testing.assert_close(
        got.float(), pa.paged_attention_ref(q, kp, vp, pt, ln).float(),
        rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
def test_out_of_range_page_table_gives_nan_rows(card):
    q, kp, vp, pt, ln = _case(2, 4, 2, 16, 16, 2, torch.float32)
    pt[1, 0] = kp.shape[0]  # past the pool
    ln[1] = 5
    out = ops.paged_flash_decode(q, kp, vp, pt, ln)
    assert torch.isnan(out[1]).all()
    assert torch.isfinite(out[0]).all()


@pytest.mark.cuda
def test_paged_graph_replay_with_changed_lengths(card):
    """A captured CUDA graph of the call, replayed twice with the lengths
    changed in place between the replays (and once more at the first):
    each replay equals a fresh call bit for bit, so the merge counters
    were back at 0, and the plain version within tolerance."""
    q, kp, vp, pt, ln = _case(8, 16, 16, 256, 16, 32, torch.bfloat16,
                              seed=2)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # built and opted in before the capture
        ops.paged_flash_decode(q, kp, vp, pt, ln)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = ops.paged_flash_decode(q, kp, vp, pt, ln)
    for lengths in ([512, 1, 17, 300, 64, 511, 129, 2],
                    [3, 500, 256, 16, 480, 33, 1, 512],
                    [512, 1, 17, 300, 64, 511, 129, 2]):
        ln.copy_(torch.tensor(lengths, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ops.paged_flash_decode(q, kp, vp, pt, ln))
        torch.testing.assert_close(
            out.float(), pa.paged_attention_ref(q, kp, vp, pt, ln).float(),
            rtol=TOL[torch.bfloat16], atol=TOL[torch.bfloat16])


@pytest.mark.cuda
def test_graph_replay_after_the_stream_scratch_grew(card):
    """Graphs of a paged and a dense decode call captured on one stream,
    then eager calls on that stream at shapes that need more scratch than
    any before (the stream's eager buffers are replaced and the old ones
    freed), then a replay of each graph: each capture took partials and
    counters of its own from its graph's pool, so each replay equals a
    fresh call bit for bit."""
    paged = _case(8, 16, 16, 256, 16, 32, torch.bfloat16, seed=6)
    dense = tuple(_randn((4, 512, 2, 64) if i else (4, 8, 64),
                         torch.bfloat16, 10 + i) for i in range(3))
    kv_len = torch.tensor(300, dtype=torch.int32, device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # built and opted in before capture
        ops.paged_flash_decode(*paged)
        ops.flash_decode(*dense, kv_len)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    key = (paged[0].device.index, stream.cuda_stream)
    small = fd._SCRATCH[key]  # the stream's eager scratch
    graphs = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()]
    with torch.cuda.graph(graphs[0], stream=stream):
        out_paged = ops.paged_flash_decode(*paged)
    with torch.cuda.graph(graphs[1], stream=stream):
        out_dense = ops.flash_decode(*dense, kv_len)
    assert fd._SCRATCH[key][0] != 0  # the last capture's own
    with torch.cuda.stream(stream):
        ops.paged_flash_decode(*_case(32, 16, 16, 256, 16, 32,
                                      torch.bfloat16, seed=7))
        ops.flash_decode(*(t.repeat(8, *(1,) * (t.dim() - 1))
                           for t in dense), kv_len)
        torch.cuda.synchronize()
        for g in graphs:
            g.replay()
    torch.cuda.synchronize()
    assert small[0] == 0 and fd._SCRATCH[key][0] == 0
    assert fd._SCRATCH[key][1].numel() > small[1].numel()
    assert torch.equal(out_paged, ops.paged_flash_decode(*paged))
    assert torch.equal(out_dense, ops.flash_decode(*dense, kv_len))


@pytest.mark.cuda
def test_bad_entry_in_a_later_split_gives_a_nan_row(card):
    """A page-table entry past the pool inside the third split of a row,
    a negative one in another row's first split, and a length past the
    capacity: those rows are NaN after the merge; the others are right."""
    q, kp, vp, pt, ln = _case(4, 4, 2, 64, 16, 8, torch.float32, seed=3)
    ln.copy_(torch.tensor([100, 90, 70, 129], dtype=torch.int32))
    want = pa.paged_attention_ref(q, kp, vp, pt, ln.clamp(max=128))
    pt[0, 5] = kp.shape[0]  # tokens 80..95: the third split of 32
    pt[1, 0] = -1
    got = pa.paged_flash_decode_cuda(q, kp, vp, pt, ln, split_tokens=32)
    torch.cuda.synchronize()
    assert torch.isnan(got[0]).all() and torch.isnan(got[1]).all()
    assert torch.isnan(got[3]).all()  # 129 > 8 groups of 16
    torch.testing.assert_close(got[2], want[2], rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("split_tokens", [None, 32])
def test_zero_length_gives_zeros(card, split_tokens):
    """A row of length 0 gives zeros, as the Pallas kernel does (the
    plain version gives the mean of V there); the other rows are right."""
    q, kp, vp, pt, ln = _case(3, 8, 2, 64, 16, 6, torch.float32, seed=4)
    ln.copy_(torch.tensor([0, 70, 5], dtype=torch.int32))
    got = pa.paged_flash_decode_cuda(q, kp, vp, pt, ln,
                                     split_tokens=split_tokens)
    want = pa.paged_attention_ref(q, kp, vp, pt, ln)
    torch.cuda.synchronize()
    assert (got[0] == 0).all()
    torch.testing.assert_close(got[1:], want[1:], rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("split_tokens", [None, 32, 96])
def test_tile_spanning_two_groups(card, split_tokens):
    """bf16 at D=128 with T=16: a 32-token tile is two TMA boxes, one a
    group, from groups far apart in the pool; lengths that end in a
    tile's first and second group."""
    q, kp, vp, pt, _ = _case(4, 16, 4, 128, 16, 12, torch.bfloat16, seed=5)
    ln = torch.tensor([8, 24, 191, 150], dtype=torch.int32, device="cuda")
    got = pa.paged_flash_decode_cuda(q, kp, vp, pt, ln,
                                     split_tokens=split_tokens)
    torch.testing.assert_close(
        got.float(), pa.paged_attention_ref(q, kp, vp, pt, ln).float(),
        rtol=TOL[torch.bfloat16], atol=TOL[torch.bfloat16])


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


TINY_F32 = ModelConfig(
    name="tiny-lm", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
    param_dtype="float32", compute_dtype="float32", vocab_pad_multiple=64)
_DONOR = [((i * 37) % 509) + 1 for i in range(32)]
# (ServeConfig changes, prompts, max_new): each knob on a workload that
# makes it act (a preemption, a CoW split, drafted columns)
KNOB_RUNS = {
    "sjf": (dict(schedule="sjf"), None, None),
    "interleave": (dict(schedule="interleave"), None, None),
    "on_demand": (dict(batch_slots=3, kv_cache_pages=4,
                       page_policy="on_demand"),
                  [[1, 2, 3], [9, 8, 7, 6], [2, 2, 2, 2, 2], [7, 1, 4, 1]],
                  [14, 12, 16, 13]),
    "share_prefix": (dict(max_seq=64, share_prefix=True),
                     [_DONOR, [1, 2, 3], list(_DONOR), _DONOR[:20]],
                     [26, 2, 5, 4]),
    "draft_len": (dict(draft_len=3), None, None),
    "temperature": (dict(temperature=0.8, seed=7), None, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("knob", sorted(KNOB_RUNS))
def test_engine_knob_on_card_matches_cpu(card, knob):
    """Each serve knob on the card gives the CPU's tokens and counts; the
    paged kernel runs n_layers times a single-token step and never on a
    verify step (draft_len > 0 makes every step one)."""
    kw, prompts, max_new = KNOB_RUNS[knob]
    prompts = prompts or [[1, 2, 3, 4, 5], [9, 8, 7], [2] * 9, [5, 4, 3]]
    max_new = max_new or [6, 3, 5, 7]
    params = Model(TINY_F32, device="cpu").init(0)
    scfg = ServeConfig(**dict(dict(max_seq=32, batch_slots=2,
                                   kv_layout="paged", prefill_chunk=4),
                              **kw))
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(Model(TINY_F32, device=dev), params, scfg,
                          device=dev)
        before = pa.paged_flash_decode_cuda.launches
        res = eng.generate(prompts, max_new)
        launched = pa.paged_flash_decode_cuda.launches - before
        eng.last_alloc.check_balanced()
        out[dev] = (res.tokens, res.steps, res.prefill_chunks,
                    res.preemptions, res.cow_splits,
                    res.shared_prefix_tokens, res.drafted, res.accepted)
    assert out["cuda"] == out["cpu"]
    single = 0 if scfg.draft_len else res.steps
    assert launched == TINY_F32.n_layers * single
    if knob == "on_demand":
        assert res.preemptions > 0
    if knob == "share_prefix":
        assert res.cow_splits > 0


@pytest.mark.cuda
def test_verify_step_launches_no_paged_kernel(card):
    """decode_step_multi at C = 1 launches the paged kernel once a layer;
    at C = 4 (a verify step) it launches none, and its column 0 equals
    the single-token step's logits within the f32 tolerance."""
    model = Model(TINY_F32, device="cuda")
    params = model.init(0)
    T, maxg = 16, 4
    table = torch.arange(1, 2 * maxg + 1, dtype=torch.int32,
                         device="cuda").reshape(2, maxg)
    lengths = torch.tensor([5, 17], dtype=torch.int32, device="cuda")
    logits = {}
    for C in (1, 4):
        cache = model.init_paged_cache(2 * maxg + 1, T)
        for layer in cache["blocks"]:  # resident K/V for the lengths
            for pool in layer.values():
                pool.normal_(generator=torch.Generator(
                    device="cuda").manual_seed(1))
        feed = torch.tensor([[3, 1, 4, 1], [5, 9, 2, 6]],
                            device="cuda")[:, :C]
        before = pa.paged_flash_decode_cuda.launches
        logits[C], _ = model.decode_step_multi(params, feed, cache, lengths,
                                               table)
        torch.cuda.synchronize()
        logits[C] = (logits[C], pa.paged_flash_decode_cuda.launches - before)
    assert logits[1][1] == TINY_F32.n_layers
    assert logits[4][1] == 0
    torch.testing.assert_close(logits[4][0][:, :1], logits[1][0],
                               rtol=1e-4, atol=1e-4)


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
@pytest.mark.parametrize("block_kv", fa.TILE_KEYS)
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("B,S,SK,H,KV,causal,window,q_offset,block_q", [
    (2, 100, 130, 4, 2, True, 0, 30, 128),   # ragged Sq and Sk, q_offset
    (1, 70, 90, 4, 1, True, 24, 20, 32),     # a window, a small tile
    (1, 48, 40, 2, 2, False, 0, 0, 64),      # non-causal, Sk < block_kv
], ids=["ragged-offset", "window", "non-causal"])
def test_flash_tensor_core_kernel_every_head_dim_and_key_tile(
        card, D, block_kv, B, S, SK, H, KV, causal, window, q_offset,
        block_q):
    """The bf16 tensor-core kernel at every D it takes and every key tile
    (wgmma N) it is built for, against ``attention_ref``; D=256 at 128
    keys needs more shared memory than a block has, and is refused."""
    q = _randn((B, S, H, D), torch.bfloat16, 1)
    k = _randn((B, SK, KV, D), torch.bfloat16, 2)
    v = _randn((B, SK, KV, D), torch.bfloat16, 3)

    def call():
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, block_q=block_q,
                                   block_kv=block_kv)

    if fa.smem_bytes(D, "bfloat16", min(block_q, S),
                     min(block_kv, SK)) > autotune.smem_limit("cuda"):
        with pytest.raises(ValueError, match="shared memory"):
            call()
        return
    before = fa.flash_attention_cuda.launches
    got = call()
    want = attention_ref(q, k, v, causal=causal, window=window,
                         q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


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
@pytest.mark.parametrize("bkv,S", [
    (4096, 1000),   # one split: the block writes the output itself
    (64, 1000),     # 16 splits merged by the last block to finish
    (32, 4096),     # 128 splits
], ids=["one-split", "16-splits", "128-splits"])
def test_flash_decode_one_and_many_splits(card, dtype, bkv, S):
    """The fused merge against the plain version at one split and many,
    with a kv_len inside the first split and the whole cache."""
    q = _randn((2, 16, 128), dtype, 1)
    k = _randn((2, S, 8, 128), dtype, 2)
    v = _randn((2, S, 8, 128), dtype, 3)
    for kv_len in (min(bkv, S) // 2 + 1, S):
        got = ops.flash_decode(q, k, v, kv_len, block_kv=bkv)
        torch.testing.assert_close(
            got.float(), fd.decode_attention_ref(q, k, v, kv_len).float(),
            rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
def test_flash_decode_is_bitwise_repeatable_and_graph_safe(card):
    """Two calls give the same bits; so do two replays of a captured CUDA
    graph of the call, whose merge counters the kernel must have reset
    (a counter left at a count would make a replay merge too early, or
    never)."""
    q = _randn((8, 16, 256), torch.bfloat16, 1)
    k = _randn((8, 2048, 16, 256), torch.bfloat16, 2)
    v = _randn((8, 2048, 16, 256), torch.bfloat16, 3)
    kl = torch.tensor(1500, dtype=torch.int32, device="cuda")
    first = ops.flash_decode(q, k, v, kl, block_kv=128)
    assert torch.equal(first, ops.flash_decode(q, k, v, kl, block_kv=128))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # built and opted in before the capture
        ops.flash_decode(q, k, v, kl, block_kv=128)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = ops.flash_decode(q, k, v, kl, block_kv=128)
    outs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        outs.append(out.clone())
    assert torch.equal(outs[0], first) and torch.equal(outs[1], first)
    # the graph reads kv_len on the device: a new length, a new result
    kl.fill_(700)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ops.flash_decode(q, k, v, kl, block_kv=128))


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
@pytest.mark.parametrize("scale_dtype", ["f32", "x"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (64, 3072),   # registers: 12 (bf16) or 24 (f32) vectors a lane
    (9, 2048),    # registers, fewer rows than a block
    (64, 3002),   # the loop: d not a multiple of a 16-byte vector
    (4, 10240),   # the loop: a row too long for the registers
], ids=["reg-3072", "reg-2048", "loop-3002", "loop-10240"])
def test_rmsnorm_register_and_loop_paths(card, shape, dtype, scale_dtype):
    x = _randn(shape, dtype, 1)
    s = _randn((shape[-1],), torch.float32 if scale_dtype == "f32" else dtype,
               2)
    got = ops.rmsnorm(x, s)
    torch.testing.assert_close(got.float(), rmsnorm_ref(x, s).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


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
    lambda: ops.gla(_randn((1, 8, 2, 16), torch.float32),
                    torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16),
                    torch.zeros(1, 8, 2)),
], ids=["flash_attention", "flash_decode", "rmsnorm", "paged", "gla"])
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


def _gla_inputs(B, S, H, dk, dv, dtype, shared_qk=False):
    if shared_qk:  # one row per step broadcast over the heads (Mamba2)
        rows = _randn((B, S, 2 * dk), dtype, 1)
        q = rows[:, :, None, :dk].expand(B, S, H, dk)
        k = rows[:, :, None, dk:].expand(B, S, H, dk)
    else:
        q, k = _randn((B, S, H, dk), dtype, 1), _randn((B, S, H, dk), dtype, 2)
    v = _randn((B, S, H, dv), dtype, 3)
    log_g = -_randn((B, S, H), torch.float32, 4).abs() * 0.3
    return q, k, v, log_g


def _gla_close(got, want, tol):
    w = want.float()
    err = (got.float() - w).abs()
    assert bool((err <= tol * float(w.abs().max()) + tol * w.abs()).all()), \
        float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,dk,dv,chunk,shared_qk", [
    (1, 16, 1, 4, 4, 8, False),
    (2, 64, 3, 8, 16, 16, False),
    (1, 70, 2, 16, 8, 32, False),      # ragged
    (2, 128, 4, 32, 32, 64, False),
    (2, 1000, 4, 64, 32, 256, True),   # ragged at the model's chunk
    (1, 300, 2, 128, 128, 256, False),  # the largest head
    (1, 4096, 64, 64, 64, 256, True),  # Zamba2-1.2B's Mamba2 layer
])
def test_gla_matches_plain_version(card, dtype, B, S, H, dk, dv, chunk,
                                   shared_qk):
    q, k, v, lg = _gla_inputs(B, S, H, dk, dv, dtype, shared_qk)
    before = gl.gla_cuda.launches
    y, st = ops.gla(q, k, v, lg, chunk=chunk)
    yr, sr = chunked_gla(q, k, v, lg, chunk=chunk)
    torch.cuda.synchronize()
    assert gl.gla_cuda.launches == before + 1
    assert y.dtype == dtype and st.dtype == torch.float32
    _gla_close(y, yr, TOL[dtype])
    _gla_close(st, sr, TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [8, 16, 64, 100, 1024])
def test_gla_chunk_lengths(card, chunk):
    """Chunks shorter than a 64-step tile, not a multiple of it, and longer
    than S (clamped): the sequence split at each."""
    q, k, v, lg = _gla_inputs(1, 200, 3, 32, 64, torch.float32)
    y, st = ops.gla(q, k, v, lg, chunk=chunk)
    yr, sr = chunked_gla(q, k, v, lg, chunk=chunk)
    _gla_close(y, yr, 2e-5)
    _gla_close(st, sr, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gla_two_rows_and_broadcast_against_copies(card, dtype):
    """B=2 with q and k broadcast over the heads (two heads an output
    block) against the same values materialized (a head a block), within
    tolerance, and against the plain version."""
    q, k, v, lg = _gla_inputs(2, 700, 8, 64, 64, dtype, shared_qk=True)
    assert gl.head_group(q, k) == 2
    qc, kc = q.contiguous(), k.contiguous()
    assert gl.head_group(qc, kc) == 1
    y, st = ops.gla(q, k, v, lg, chunk=256)
    yc, stc = ops.gla(qc, kc, v, lg, chunk=256)
    yr, sr = chunked_gla(q, k, v, lg, chunk=256)
    _gla_close(y, yc, TOL[dtype])
    _gla_close(st, stc, TOL[torch.float32])
    _gla_close(y, yr, TOL[dtype])
    _gla_close(st, sr, TOL[torch.float32])


@pytest.mark.cuda
def test_gla_is_bitwise_repeatable(card):
    q, k, v, lg = _gla_inputs(1, 4096, 64, 64, 64, torch.float32,
                              shared_qk=True)
    y0, s0 = ops.gla(q, k, v, lg, chunk=256)
    y1, s1 = ops.gla(q, k, v, lg, chunk=256)
    assert torch.equal(y0, y1) and torch.equal(s0, s1)


@pytest.mark.cuda
def test_gla_rejects_a_head_whose_state_does_not_fit(card):
    q, k, v, lg = _gla_inputs(1, 16, 2, 512, 513, torch.float32)
    with pytest.raises(ValueError, match="dk=512"):
        ops.gla(q, k, v, lg)


@pytest.mark.cuda
def test_gla_raises_on_inputs_that_require_grad(card):
    q, k, v, lg = _gla_inputs(1, 32, 2, 16, 16, torch.float32)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.gla(q.requires_grad_(), k, v, lg)
    with torch.no_grad():  # nothing to differentiate: it launches
        ops.gla(q, k, v, lg)


def _to_card(tree):
    if isinstance(tree, dict):
        return {k: _to_card(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_card(v) for v in tree]
    return tree.cuda()


@pytest.mark.cuda
def test_zamba2_forward_on_card_matches_cpu(card):
    """reduced(zamba2-1.2b), f32: the kernel path on the card (36 GLA and
    2 flash launches a forward) against the plain path on the CPU, from
    the same weights."""
    cfg = dataclasses.replace(reduced(get_config("zamba2-1.2b")),
                              gla_impl="pallas", attn_impl="pallas")
    params = Model(cfg, device="cpu").init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    _, want = Model(cfg, device="cpu").loss(params, batch)
    h_cpu, _ = Model(cfg, device="cpu").forward(params, batch)
    on_card = {k: v.cuda() for k, v in batch.items()}
    card_params = _to_card(params)
    model = Model(cfg, device="cuda")
    g0, f0 = gl.gla_cuda.launches, fa.flash_attention_cuda.launches
    with torch.no_grad():
        h, _ = model.forward(card_params, on_card)
        _, got = model.loss(card_params, on_card)
    torch.cuda.synchronize()
    assert gl.gla_cuda.launches - g0 == 2 * 36
    assert fa.flash_attention_cuda.launches - f0 == 2 * 2
    torch.testing.assert_close(h.cpu(), h_cpu, rtol=1e-3, atol=1e-3)
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [dict(), dict(schedule="interleave",
                                                prefill_chunk=8),
                                   dict(draft_len=2, share_prefix=1)],
                         ids=["defaults", "interleave", "drafts"])
def test_live_serve_sut_counts_on_card_match_cpu(card, knobs):
    """LiveServeSUT on a tiny f32 model: the card's counts (chunks, steps,
    tokens) are the CPU's, and each timed generate of a single-token
    config launches the paged kernel n_layers times a step."""
    from repro_torch.serve.space import LiveServeSUT

    params = Model(TINY_F32, device="cpu").init(0)
    out = {}
    for dev in ("cpu", "cuda"):
        sut = LiveServeSUT(Model(TINY_F32, device=dev), params,
                           base=ServeConfig(max_seq=32, kv_layout="paged"),
                           prompt_len=9, gen_len=6, n_requests=4, warmup=1,
                           repeats=2, max_slots=4, device=dev)
        cfg = dict(sut.space().default_config(), **knobs)
        before = pa.paged_flash_decode_cuda.launches
        m = sut.test(cfg)
        launched = pa.paged_flash_decode_cuda.launches - before
        out[dev] = {k: m.metrics[k] for k in ("prefill_chunks", "steps",
                                              "tokens")}
    assert out["cuda"] == out["cpu"]
    single = 0 if cfg["draft_len"] else out["cuda"]["steps"]
    assert launched == TINY_F32.n_layers * single * (1 + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("remat,microbatches", [("none", 1), ("full", 2),
                                                ("dots", 4)])
def test_train_step_on_card_matches_cpu(card, remat, microbatches):
    """Three train steps of a tiny f32 model from the same weights and
    batches: the card's losses follow the CPU's (cuBLAS and the CPU's
    GEMMs round differently; Adam amplifies a near-zero gradient's
    rounding to an update of up to lr, so later steps are held to a
    looser bar than the first)."""
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.train import RunKnobs, make_train_step

    knobs = RunKnobs(rules_preset="dp", remat=remat,
                     microbatches=microbatches, loss_chunk=0)
    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=0,
                          schedule="constant")
    params = Model(TINY_F32, device="cpu").init(0)
    data = SyntheticLMDataset(DataConfig(vocab_size=512, seq_len=16,
                                         global_batch=4, seed=0))
    losses = {}
    for dev in ("cpu", "cuda"):
        model = Model(TINY_F32, device=dev)
        step = make_train_step(model, opt, knobs)
        p = _to_card(params) if dev == "cuda" else params
        state = adamw_init(p)
        losses[dev] = []
        for i in range(3):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch_at(i).items()}
            p, state, m = step(p, state, batch)
            losses[dev].append(float(m["loss"]))
    assert abs(losses["cuda"][0] - losses["cpu"][0]) <= 1e-5
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-3 * abs(b)


def _drift_workload(seed=0):
    """``tests/test_workload_retune.py``'s drifting trace: distinct long
    prompts, then a shared prefix with short tails and short gens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pa_ = [rng.integers(1, 500, size=20).tolist() for _ in range(3)]
    shared = rng.integers(1, 500, size=32).tolist()
    pb = [shared + rng.integers(1, 500, size=3).tolist()
          for _ in range(12)]
    return pa_ + pb, [12] * 3 + [6] * 12


RETUNE_KW = dict(retune=True, retune_budget=8, retune_threshold=0.3,
                 retune_window=10, retune_cooldown=200,
                 retune_check_every=2, retune_min_requests=6,
                 tuned_signature="a0.43_d5_g12_p20_r0.00_s0.00_x0.00")
EVENT_KEYS = ("step", "signature", "config", "applied", "warm_source")


@pytest.mark.cuda
def test_engine_retune_on_card_matches_cpu(card, tmp_path, monkeypatch):
    """The drifting trace under retune on the card gives the CPU's tokens,
    counts and retune events (the winner keyed ``cuda-sm90`` there,
    ``model-sm90`` here), and the paged kernel runs n_layers times a
    single-token step (none on the verify steps the swap turns on)."""
    import json

    params = Model(TINY_F32, device="cpu").init(0)
    scfg = ServeConfig(max_seq=48, batch_slots=8, kv_layout="paged",
                       prefill_chunk=8, slot_cap=3, **RETUNE_KW)
    out = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / dev))
        autotune.reset_default_cache()
        eng = ServeEngine(Model(TINY_F32, device=dev), params, scfg,
                          device=dev)
        before = pa.paged_flash_decode_cuda.launches
        res = eng.generate(*_drift_workload())
        launched = pa.paged_flash_decode_cuda.launches - before
        eng.last_alloc.check_balanced()
        out[dev] = (res.tokens, res.steps, res.prefill_chunks,
                    res.drafted, res.accepted,
                    [{k: e[k] for k in EVENT_KEYS} for e in res.retunes])
        keys = list(json.loads((tmp_path / dev).read_text()))
    autotune.reset_default_cache()
    assert out["cuda"] == out["cpu"]
    assert len(res.retunes) == 1 and res.retunes[0]["applied"]
    assert all("|cuda-sm90|" in k for k in keys)
    assert launched >= TINY_F32.n_layers  # single-token steps before it


@pytest.mark.cuda
def test_checkpoint_async_save_on_card(card, tmp_path):
    """A tree on the card (bf16 and f32) saved asynchronously, then
    updated in place: the restore onto a card template is the state at
    the save, bit for bit, on the card."""
    from repro_torch.checkpoint import CheckpointManager

    g = torch.Generator(device="cuda").manual_seed(0)
    tree = {"p": torch.randn((64, 32), generator=g, device="cuda").to(
        torch.bfloat16),
        "mu": [torch.randn((1000,), generator=g, device="cuda")],
        "step": torch.tensor(3, dtype=torch.int32, device="cuda")}
    at_save = {"p": tree["p"].clone(), "mu": tree["mu"][0].clone()}
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, tree)
    tree["mu"][0].mul_(0.5)
    tree["p"].add_(1)
    _, restored = mgr.restore(tree)
    assert restored["p"].device.type == "cuda"
    assert restored["p"].dtype == torch.bfloat16
    assert torch.equal(restored["p"], at_save["p"])
    assert torch.equal(restored["mu"][0], at_save["mu"])
    assert int(restored["step"]) == 3


@pytest.mark.cuda
def test_train_loop_resume_on_card(card, tmp_path):
    """A run killed by SimulatedFailure resumes on the card from its async
    checkpoint to the uninterrupted run's losses."""
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import (RunKnobs, SimulatedFailure,
                                   TrainLoopConfig, train)

    def loop(**kw):
        return TrainLoopConfig(**dict(dict(
            steps=6, seq_len=32, global_batch=4, log_every=0,
            opt=OptimizerConfig(learning_rate=3e-3, warmup_steps=2,
                                total_steps=50),
            knobs=RunKnobs(rules_preset="dp", remat="none", microbatches=1,
                           loss_chunk=0)), **kw))

    straight = train(TINY_F32, loop())
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(SimulatedFailure):
        train(TINY_F32, loop(ckpt_dir=ckpt, ckpt_every=2, ckpt_async=True,
                             fail_at_step=3))
    resumed = train(TINY_F32, loop(ckpt_dir=ckpt, ckpt_every=2,
                                   ckpt_async=True))
    assert resumed["final_step"] == 6 and len(resumed["history"]) == 4
    for a, b in zip(straight["history"][2:], resumed["history"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(a["loss"])
    assert resumed["params"]["embed"].device.type == "cuda"

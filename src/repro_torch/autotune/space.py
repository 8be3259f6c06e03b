"""Kernel launch-configuration spaces + analytic cost models, for Hopper.

Counterpart of ``repro.autotune.space``.  ``KernelSpace`` turns each CUDA
kernel's launch knobs into an ACTS ``ParameterSpace`` so the ordinary
tuner stack (LHS + RRS, budget, cache, report) drives kernel autotuning
exactly like it drives any other system's knobs.

Per kernel: the knob space (the kernel's tile sizes, named as in the
reference, plus ``num_warps``: the CUDA block is ``num_warps * 32``
threads, and 0 leaves the block size to the C launcher, which takes the
most warps the kernel's registers allow; flash attention has no
``num_warps``, its bf16 kernel's warps being its warpgroups), an input
builder for a problem signature, a call adapter, a roofline cost model
and the block's shared-memory footprint.

The cost model (``mode="model"``, what the CPU tests run) scores a config
by a Hopper roofline at the H100 SXM datasheet figures (3.35 TB/s HBM,
989 TFLOP/s dense bf16; 67 TFLOP/s f32 for the kernels that run on the
CUDA cores: GLA, and flash attention in f32) plus a scheduling term per
wave of blocks.  Its only ``inf`` is a block whose shared memory
exceeds the opt-in maximum per block; ``smem_footprint`` is the single
function behind that and behind the ``smem_fits`` feasibility predicate
(``repro_torch.analysis.feasibility``), and the C launchers report the
same number (``chip_smoke.py`` holds them equal).  On the card the
kernel-under-tune times the kernel instead (``mode="time"``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.params import EnumParam, ParameterSpace
from repro_torch.kernels.build import SMEM_PER_BLOCK_OPTIN

__all__ = ["KernelSpace", "KERNELS", "shape_sig", "SMEM_PER_BLOCK_OPTIN"]

# H100 SXM (NVIDIA data sheet; the hopper-kernels guide's table)
HBM_BYTES_PER_S = 3.35e12
TENSOR_FLOPS_PER_S = 989e12  # dense bf16
CUDA_CORE_F32_FLOPS_PER_S = 67e12  # f32 outside the tensor cores
SM_COUNT = 132
SMEM_PER_SM = 233_472           # 228 KB shared memory on an SM
THREADS_PER_SM = 2048
MAX_BLOCKS_PER_SM = 32
# scheduling cost of one wave of resident blocks at full occupancy; a
# wave of blocks with few warps hides less latency and costs more
WAVE_S = 2e-6


def shape_sig(dims: Dict[str, int]) -> str:
    """Canonical problem signature, e.g. ``B2_D64_H4_KV2_S256``."""
    return "_".join(f"{k}{int(v)}" for k, v in sorted(dims.items()))


def _dtype_bytes(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2}[dtype]


def _torch_dtype(dtype: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]


def _roofline_s(flops: float, hbm_bytes: float, n_blocks: float,
                warps: int, smem: int,
                flops_per_s: float = TENSOR_FLOPS_PER_S) -> float:
    """Roofline time plus the scheduling term of the blocks' waves; inf
    when a block's shared memory does not fit."""
    if smem > SMEM_PER_BLOCK_OPTIN:
        return math.inf
    resident = min(THREADS_PER_SM // (32 * warps), MAX_BLOCKS_PER_SM)
    if smem:
        resident = min(resident, SMEM_PER_SM // smem)
    waves = math.ceil(n_blocks / (SM_COUNT * max(resident, 1)))
    compute = flops / flops_per_s
    stream = hbm_bytes / HBM_BYTES_PER_S
    return max(compute, stream) + waves * WAVE_S * (1.0 + 2.0 / warps)


def _warps(config, auto: int) -> int:
    """The config's block size in warps; 0 (the launcher's choice) counts
    as ``auto``, what the launcher would pick for this config."""
    return int(config["num_warps"]) or auto


def _rand(rng: np.random.Generator, shape, dtype: str, device
          ) -> torch.Tensor:
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device=device, dtype=_torch_dtype(dtype))


@dataclass(frozen=True)
class KernelDef:
    name: str
    dims: Tuple[str, ...]  # required signature dims
    knobs: Tuple[str, ...]
    make_space: Callable[[], ParameterSpace]
    # (dims, dtype, rng, device) -> inputs of ``call``
    make_inputs: Callable[..., Any]
    # (inputs, config) -> the kernel's output for that launch config
    call: Callable[[Any, Dict[str, Any]], torch.Tensor]
    model_cost: Callable[[Dict[str, Any], Dict[str, int], str], float]
    # (config, dims, dtype) -> shared-memory bytes of one block.  The
    # SINGLE source of the cost model's hard infeasibility and of the
    # static feasibility predicate, so ``feasible(cfg) ⇔ cost < inf``
    # holds exactly; the C launchers report the same figure.
    smem_footprint: Callable[[Dict[str, Any], Dict[str, int], str], int]


_WARPS = (0, 1, 2, 4, 8, 16, 32)  # 0 = the launcher's choice


# -- flash attention ---------------------------------------------------------
# No num_warps knob: the bf16 kernel's warps are its warpgroups (one a 64
# query rows of the tile), and the f32 kernel keeps its launcher's choice.
def _fa_space() -> ParameterSpace:
    return ParameterSpace([
        EnumParam("block_q", (16, 32, 64, 128), 64),
        EnumParam("block_kv", (16, 32, 64, 128), 32),
    ])


def _fa_inputs(d, dtype, rng, device):
    q = _rand(rng, (d["B"], d["S"], d["H"], d["D"]), dtype, device)
    k = _rand(rng, (d["B"], d["SK"], d["KV"], d["D"]), dtype, device)
    v = _rand(rng, (d["B"], d["SK"], d["KV"], d["D"]), dtype, device)
    return q, k, v


def _fa_call(inputs, config):
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q, k, v = inputs
    # SK >= S: queries sit at the end of the KV stream (cache-prefill
    # semantics); SK < S is cross-attention, timed unmasked (as the
    # reference's adapter does)
    causal = k.shape[1] >= q.shape[1]
    q_offset = k.shape[1] - q.shape[1] if causal else 0
    return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset,
                                block_q=config["block_q"],
                                block_kv=config["block_kv"])


def _fa_smem(config, d, dtype):
    from repro_torch.kernels.flash_attention import smem_bytes

    return smem_bytes(d["D"], dtype, min(config["block_q"], d["S"]),
                      min(config["block_kv"], d["SK"]))


def _fa_live_tiles(S, SK, bq, bk) -> int:
    """Key tiles the kernel visits per query-tile column, summed: with
    the queries at the end of the KV stream (q_offset = SK - S), query
    tile iq reaches keys up to SK - S + (iq + 1) * bq - 1; cross-attention
    (SK < S) is unmasked."""
    nq, nk = math.ceil(S / bq), math.ceil(SK / bk)
    if SK < S:
        return nq * nk
    off = SK - S
    return sum(min(nk, (off + (iq + 1) * bq - 1) // bk + 1)
               for iq in range(nq))


def _fa_cost(config, d, dtype):
    from repro_torch.kernels.flash_attention import tile_keys

    B, S, SK, H, D = d["B"], d["S"], d["SK"], d["H"], d["D"]
    bq, bk = min(config["block_q"], S), min(config["block_kv"], SK)
    live = B * H * _fa_live_tiles(S, SK, bq, bk)
    ib = _dtype_bytes(dtype)
    if dtype == "bfloat16":
        # tensor cores; a warpgroup computes 64 rows and the instruction's
        # keys over a head dim padded to 16, whatever the tile holds
        n_wg = math.ceil(bq / 64)
        rows, keys, dp = 64 * n_wg, tile_keys(bk), max(D, 16)
        rate, warps = TENSOR_FLOPS_PER_S, 4 * n_wg
    else:  # CUDA cores, at the launcher's block size
        rows, keys, dp = bq, bk, D
        rate, warps = CUDA_CORE_F32_FLOPS_PER_S, min(16, bq)
    flops = live * 4.0 * rows * keys * dp
    hbm = (2.0 * B * S * H * D * ib          # q in, out
           + 2.0 * live * keys * D * ib)     # streamed k/v tiles
    n_blocks = B * H * math.ceil(S / bq)
    return _roofline_s(flops, hbm, n_blocks, warps,
                       _fa_smem(config, d, dtype), flops_per_s=rate)


# -- decode attention --------------------------------------------------------
def _fd_space() -> ParameterSpace:
    return ParameterSpace([
        EnumParam("block_kv", (32, 64, 128, 256, 512, 1024), 256),
        EnumParam("num_warps", _WARPS, 0),
    ])


def _fd_inputs(d, dtype, rng, device):
    q = _rand(rng, (d["B"], d["H"], d["D"]), dtype, device)
    k = _rand(rng, (d["B"], d["S"], d["KV"], d["D"]), dtype, device)
    v = _rand(rng, (d["B"], d["S"], d["KV"], d["D"]), dtype, device)
    # the valid length as a device scalar, as a decode loop holds it
    kv_len = torch.tensor(d["S"], dtype=torch.int32, device=device)
    return q, k, v, kv_len


def _fd_call(inputs, config):
    from repro_torch.kernels.decode_attention import flash_decode_cuda

    q, k, v, kv_len = inputs
    return flash_decode_cuda(q, k, v, kv_len, block_kv=config["block_kv"],
                             num_warps=config["num_warps"])


def _fd_smem(config, d, dtype):
    from repro_torch.kernels.decode_attention import smem_bytes

    return smem_bytes(d["H"], d["KV"], d["D"])


def _fd_cost(config, d, dtype):
    B, S, H, KV, D = d["B"], d["S"], d["H"], d["KV"], d["D"]
    bk = min(config["block_kv"], S)
    n_split = math.ceil(S / bk)
    ib = _dtype_bytes(dtype)
    flops = 4.0 * B * H * S * D
    hbm = (2.0 * B * S * KV * D * ib        # the cache, once
           + 2.0 * B * H * D * ib           # q in, out
           + 2.0 * B * H * n_split * (D + 2) * 4)  # partials, each way
    n_blocks = B * KV * math.ceil(H // KV / 8) * n_split + B * H
    return _roofline_s(flops, hbm, n_blocks,
                       _warps(config, max(1, min(32, bk // 8))),
                       _fd_smem(config, d, dtype))


# -- paged decode attention --------------------------------------------------
def _pa_space() -> ParameterSpace:
    # pages_per_block is the pool-layout granularity: the serve engine's
    # allocator adopts the tuned value as its group size, so the knob
    # couples the kernel's page-table walk with allocator fragmentation.
    return ParameterSpace([
        EnumParam("pages_per_block", (1, 2, 4, 8, 16, 32), 4),
        EnumParam("num_warps", _WARPS, 0),
    ])


def _pa_inputs(d, dtype, rng, device):
    # Dense K/V + the valid length; the call adapter lays the pool out at
    # the candidate pages_per_block (layout is part of the config under
    # test), once per layout, outside the timed call.
    q = _rand(rng, (d["B"], d["H"], d["D"]), dtype, device)
    k = _rand(rng, (d["B"], d["S"], d["KV"], d["D"]), dtype, device)
    v = _rand(rng, (d["B"], d["S"], d["KV"], d["D"]), dtype, device)
    return {"q": q, "k": k, "v": v, "kv_len": d["S"], "pools": {}}


def _pa_pool(inputs, T):
    q, k, v = inputs["q"], inputs["k"], inputs["v"]
    B, S, KV, D = k.shape
    pad = (-S) % T
    if pad:
        zeros = k.new_zeros((B, pad, KV, D))
        k, v = torch.cat([k, zeros], 1), torch.cat([v, zeros], 1)
    maxg = k.shape[1] // T
    pt = torch.arange(B * maxg, dtype=torch.int32, device=q.device)
    lengths = torch.full((B,), inputs["kv_len"], dtype=torch.int32,
                         device=q.device)
    return (k.reshape(B * maxg, T, KV, D).contiguous(),
            v.reshape(B * maxg, T, KV, D).contiguous(),
            pt.reshape(B, maxg), lengths)


def _page_tokens() -> int:
    # the authoritative page granularity; imported late because the serve
    # package imports the models, whose kernels import this module
    from repro_torch.serve.paging import PAGE_TOKENS

    return PAGE_TOKENS


def _pa_call(inputs, config):
    from repro_torch.kernels.paged_attention import paged_flash_decode_cuda

    T = int(config["pages_per_block"]) * _page_tokens()
    if T not in inputs["pools"]:
        inputs["pools"][T] = _pa_pool(inputs, T)
    k_pages, v_pages, pt, lengths = inputs["pools"][T]
    return paged_flash_decode_cuda(inputs["q"], k_pages, v_pages, pt,
                                   lengths, num_warps=config["num_warps"])


def _pa_smem(config, d, dtype):
    from repro_torch.kernels.paged_attention import smem_bytes

    return smem_bytes(d["H"], d["KV"], d["D"])


def _pa_cost(config, d, dtype):
    B, S, H, KV, D = d["B"], d["S"], d["H"], d["KV"], d["D"]
    T = int(config["pages_per_block"]) * _page_tokens()
    ng = math.ceil(S / T)
    ib = _dtype_bytes(dtype)
    flops = 4.0 * B * H * S * D
    # the pool once, q in and out, and the page-table walk: one entry a
    # group, read by every warp of the block that crosses it
    hbm = (2.0 * B * S * KV * D * ib + 2.0 * B * H * D * ib
           + B * KV * ng * 4.0 * 32)
    n_blocks = B * KV * math.ceil(H // KV / 8)
    return _roofline_s(flops, hbm, n_blocks, _warps(config, 32),
                       _pa_smem(config, d, dtype))


# -- rmsnorm -----------------------------------------------------------------
def _rn_space() -> ParameterSpace:
    return ParameterSpace([
        EnumParam("block_rows", (1, 2, 4, 8, 16, 32), 4),
        EnumParam("num_warps", _WARPS, 0),
    ])


def _rn_inputs(d, dtype, rng, device):
    x = _rand(rng, (d["ROWS"], d["D"]), dtype, device)
    s = torch.from_numpy(rng.normal(size=(d["D"],)).astype(np.float32)).to(
        device)
    return x, s


def _rn_call(inputs, config):
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    x, s = inputs
    return rmsnorm_cuda(x, s, block_rows=config["block_rows"],
                        num_warps=config["num_warps"])


def _rn_smem(config, d, dtype):
    from repro_torch.kernels.rmsnorm import smem_bytes

    return smem_bytes()


def _rn_cost(config, d, dtype):
    rows, D = d["ROWS"], d["D"]
    br = min(config["block_rows"], rows)
    ib = _dtype_bytes(dtype)
    flops = 4.0 * rows * D
    hbm = 2.0 * rows * D * ib + D * 4.0
    warps = _warps(config, min(32, br))
    # a block's warps past its rows idle: charge the blocks at the warps
    # that do work
    return _roofline_s(flops, hbm, math.ceil(rows / br), min(warps, br),
                       _rn_smem(config, d, dtype))


# -- gated linear attention -------------------------------------------------
# a block walks its chunks in order: each chunk costs the scan's and the
# sub-tiles' barriers whatever its length
GLA_CHUNK_STEP_S = 1e-6


def _gla_space() -> ParameterSpace:
    return ParameterSpace([
        EnumParam("chunk", (16, 32, 64, 128, 256), 128),
        EnumParam("num_warps", (0, 2, 4, 8, 16), 0),
    ])


def _gla_inputs(d, dtype, rng, device):
    q = _rand(rng, (d["B"], d["S"], d["H"], d["DK"]), dtype, device)
    k = _rand(rng, (d["B"], d["S"], d["H"], d["DK"]), dtype, device)
    v = _rand(rng, (d["B"], d["S"], d["H"], d["DV"]), dtype, device)
    g = torch.from_numpy(
        (-np.abs(rng.normal(size=(d["B"], d["S"], d["H"]))) * 0.3)
        .astype(np.float32)).to(device)
    return q, k, v, g


def _gla_call(inputs, config):
    from repro_torch.kernels.gla import gla_cuda

    q, k, v, g = inputs
    return gla_cuda(q, k, v, g, chunk=config["chunk"],
                    num_warps=config["num_warps"])[0]


def _gla_smem(config, d, dtype):
    from repro_torch.kernels.gla import smem_bytes

    return smem_bytes(d["DK"], d["DV"], min(config["chunk"], d["S"]))


def _gla_cost(config, d, dtype):
    from repro_torch.kernels.gla import SUB_TILE

    B, S, H, DK, DV = d["B"], d["S"], d["H"], d["DK"], d["DV"]
    L = min(config["chunk"], S)
    nc = math.ceil(S / L)
    nt = math.ceil(L / min(SUB_TILE, L))
    ts = min(SUB_TILE, L)
    # per chunk: the (query, key) sub-tile pairs up to the diagonal, each
    # a score tile and its product with v, plus the inter-chunk term and
    # the state update (2 * L * DK * DV each), f32 on the CUDA cores
    flops = B * H * nc * (nt * (nt + 1) / 2 * 2.0 * ts * ts * (DK + DV)
                          + 4.0 * L * DK * DV)
    ib = _dtype_bytes(dtype)
    hbm = (B * S * H * (2 * DK + 2 * DV) * ib  # q, k, v in, y out
           + B * S * H * 4.0                   # the gates
           + B * H * DK * DV * 4.0)            # the final state
    return (_roofline_s(flops, hbm, B * H, _warps(config, 16),
                        _gla_smem(config, d, dtype),
                        flops_per_s=CUDA_CORE_F32_FLOPS_PER_S)
            + nc * GLA_CHUNK_STEP_S)


KERNELS: Dict[str, KernelDef] = {
    # SK = KV sequence length; distinct from S so cross-attention and
    # cache-prefill problems key separate autotune entries.
    "flash_attention": KernelDef(
        "flash_attention", ("B", "S", "SK", "H", "KV", "D"),
        ("block_q", "block_kv"),
        _fa_space, _fa_inputs, _fa_call, _fa_cost, _fa_smem),
    "decode_attention": KernelDef(
        "decode_attention", ("B", "S", "H", "KV", "D"),
        ("block_kv", "num_warps"),
        _fd_space, _fd_inputs, _fd_call, _fd_cost, _fd_smem),
    "paged_attention": KernelDef(
        "paged_attention", ("B", "S", "H", "KV", "D"),
        ("pages_per_block", "num_warps"),
        _pa_space, _pa_inputs, _pa_call, _pa_cost, _pa_smem),
    "rmsnorm": KernelDef(
        "rmsnorm", ("ROWS", "D"),
        ("block_rows", "num_warps"),
        _rn_space, _rn_inputs, _rn_call, _rn_cost, _rn_smem),
    "gla": KernelDef(
        "gla", ("B", "S", "H", "DK", "DV"),
        ("chunk", "num_warps"),
        _gla_space, _gla_inputs, _gla_call, _gla_cost, _gla_smem),
}


class KernelSpace:
    """The ACTS parameter space of one kernel's launch knobs."""

    def __init__(self, kernel: str):
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; "
                             f"have {sorted(KERNELS)}")
        self.kernel = kernel
        self.definition = KERNELS[kernel]

    def space(self) -> ParameterSpace:
        return self.definition.make_space()

    @property
    def knobs(self) -> Tuple[str, ...]:
        return self.definition.knobs

    def validate_dims(self, dims: Dict[str, int]) -> Dict[str, int]:
        missing = [k for k in self.definition.dims if k not in dims]
        if missing:
            raise ValueError(
                f"kernel {self.kernel}: missing dims {missing}")
        return {k: int(dims[k]) for k in self.definition.dims}

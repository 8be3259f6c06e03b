"""Serve-engine knobs as an ACTS ``ParameterSpace`` + the co-tuning surface.

Counterpart of ``repro.serve.space``.  ``serve_knob_space`` exposes the
engine's config surface — batch slots, prefill chunk, KV-cache pages,
scheduling policy, page policy, prefix sharing, draft length — to the
ordinary tuner stack, and ``apply_serve_knobs`` maps a tuned config back
onto a ``ServeConfig``.

The middle of the module is the **co-deployment surrogate** behind
``python -m repro_torch.launch.tune --joint``: the reference's analytic
serve-throughput model (``coupled_serve_metrics``, line for line, with the
reference's calibration constants, which are plausible rather than
measured), whose optimum depends on the decode kernel's launch config
through the latency SLA: a slower attention kernel inflates the decode
step, so the SLA binds at a smaller batch.  The one change of substance
is the price of a decode step's attention (``_attn_step_seconds``): the
reference prices it by its TPU roofline plus a VMEM co-residency spill
term; the port prices it by its own Hopper cost model of the dense decode
kernel (``KERNELS["decode_attention"].model_cost``) at the resident
batch, which already bounds blocks per SM by shared memory.  There is no
spill term: on Hopper the engine's slot state lives in device memory, and
no knob of the port's decode space changes the kernel's shared memory.

The **live** path is ``LiveServeSUT`` / ``make_live_cotune_sut`` at the
bottom: the same ``CompositeSUT`` wiring wall-clocking the real
``ServeEngine.generate`` (plus the real train step and the decode kernel)
— what ``python -m repro_torch.launch.tune --joint --real`` runs.  A host
of more than one device is not ported (ROADMAP queue 1: multi-device).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.autotune.space import KERNELS, _dtype_bytes
from repro_torch.core.composite import CompositeSUT
from repro_torch.core.params import (Config, EnumParam, IntParam,
                                     ParameterSpace)
from repro_torch.core.surrogates import Surrogate
from repro_torch.core.tuner import PerfMetric

from .paging import PAGE_TOKENS
from .scheduler import PAGE_POLICIES, SCHEDULES, TP_MODES

__all__ = [
    "PAGE_TOKENS",
    "SCHEDULES",
    "PAGE_POLICIES",
    "TP_MODES",
    "serve_knob_space",
    "apply_serve_knobs",
    "kv_floor_raise_count",
    "CotuneParams",
    "params_for_fingerprint",
    "coupled_serve_metrics",
    "ServeSurrogate",
    "ServeKernelCoupling",
    "make_cotune_sut",
    "LiveServeSUT",
    "LiveCotuneScalarizer",
    "make_live_cotune_sut",
]


def _single_device(max_devices: int) -> None:
    if max_devices > 1:
        raise NotImplementedError(
            f"max_devices={max_devices}: the sharding subspace needs "
            "ROADMAP queue 1: multi-device, which is not ported yet")


def serve_knob_space(max_seq: int = 2048, max_slots: int = 64,
                     max_devices: int = 1) -> ParameterSpace:
    """The serve engine's tunable knobs (``ServeConfig`` fields).

    The KV-page range scales with ``max_seq`` so the knob always spans
    "one resident sequence" .. "all ``max_slots`` slots resident".  The
    prefill-chunk choices scale DOWN with small windows (powers of two,
    floor max(8, min(128, max_seq/16)), ceiling min(max_seq, 2048)) so
    the knob stays live on the small serving windows the wall-clock
    (``--real``) mode tunes.  ``max_slots`` bounds the batch-slot knob.
    ``max_devices > 1`` (the reference's sharding subspace) raises.
    """
    _single_device(max_devices)
    page_per_seq = max(1, max_seq // PAGE_TOKENS)
    chunk_lo = max(8, min(128, max_seq // 16))
    chunk_choices = tuple(
        c for c in (8, 16, 32, 64, 128, 256, 512, 1024, 2048)
        if chunk_lo <= c <= max_seq) or (max_seq,)
    default_slots = min(8, max_slots)
    return ParameterSpace([
        # engine batch slots (ServeConfig.batch_slots)
        IntParam("max_batch", 1, max_slots, default=default_slots, log=True),
        # prefill split size: scheduler granularity vs per-chunk overhead
        EnumParam("prefill_chunk", chunk_choices,
                  chunk_choices[len(chunk_choices) // 2]),
        # KV pool in PAGE_TOKENS-token pages (paged layout: residency
        # bound)
        IntParam("kv_cache_pages", page_per_seq, max_slots * page_per_seq,
                 default=default_slots * page_per_seq, log=True),
        # continuous-runtime admission order (scheduler.py)
        EnumParam("schedule", SCHEDULES, "fifo"),
        # worst-case reservations up front (reserve) vs prompt-only plus
        # on-demand growth with recompute preemption (on_demand)
        EnumParam("page_policy", PAGE_POLICIES, "reserve"),
        # prompt-prefix groups mapped copy-on-write instead of prefilled
        EnumParam("share_prefix", (0, 1), 0),
        # n-gram draft length (0 = off)
        EnumParam("draft_len", (0, 2, 4, 8), 0),
    ])


# apply_serve_knobs floor-raise accounting: raising a tuned kv_cache_pages
# to the deployable floor means the deployed config is NOT the config the
# tuner scored.  Fresh tuning runs cannot produce one (the serve
# feasibility predicate prunes below-floor candidates), but cached winners
# still pass through here — so the mutation warns once per process and
# stays countable instead of silent.
_floor_raise_count = 0
_floor_raise_warned = False


def kv_floor_raise_count() -> int:
    """How many times ``apply_serve_knobs`` raised tuned pages this
    process (0 for any winner produced by a feasibility-pruned run)."""
    return _floor_raise_count


def apply_serve_knobs(config: Config, base: Optional[Any] = None):
    """Tuned serve knobs -> a ``ServeConfig``.

    Pages are raised to the floor a constructible config requires — the
    paged continuous runtime needs ONE max_seq request (+ scratch group)
    resident; the dense layouts the full ``slots × max_seq`` footprint.
    A raise means tuned != deployed, so it is counted in
    ``kv_floor_raise_count`` and warned once per process.  A cached
    winner's ``mesh_devices``/``tp_vs_replicas`` map onto ``mesh_shape``
    as in the reference (the engine raises on a mesh, ROADMAP queue 1:
    multi-device).
    """
    from .engine import ServeConfig

    base = base or ServeConfig()
    slots = int(config["max_batch"])
    if base.runtime == "continuous" and base.kv_layout == "paged":
        from .paging import min_pages_for

        min_pages = min_pages_for(base.max_seq, base.kv_page_block)
    else:
        min_pages = -(-slots * base.max_seq // PAGE_TOKENS)
    tuned_pages = int(config["kv_cache_pages"])
    if tuned_pages < min_pages:
        global _floor_raise_count, _floor_raise_warned
        _floor_raise_count += 1
        if not _floor_raise_warned:
            _floor_raise_warned = True
            import warnings

            warnings.warn(
                f"apply_serve_knobs raised tuned kv_cache_pages "
                f"{tuned_pages} to the deployable floor {min_pages} "
                f"(max_seq={base.max_seq}, {base.runtime}/"
                f"{base.kv_layout}): the deployed config is not the "
                f"config the tuner scored — re-tune under "
                f"serve_feasibility to make the winner deployable as-is",
                RuntimeWarning, stacklevel=2)
    tp_mode = str(config.get("tp_vs_replicas", base.tp_vs_replicas))
    mesh_shape = base.mesh_shape
    if "mesh_devices" in config:
        n_dev = int(config["mesh_devices"])
        if n_dev <= 1:
            mesh_shape = None
        elif tp_mode == "replicas":
            mesh_shape = (n_dev, 1)
        else:
            mesh_shape = (1, n_dev)
    return replace(
        base,
        batch_slots=slots,
        prefill_chunk=int(config["prefill_chunk"]),
        kv_cache_pages=max(tuned_pages, min_pages),
        schedule=str(config["schedule"]),
        # absent in older cached winners: keep the base's settings then
        page_policy=str(config.get("page_policy", base.page_policy)),
        share_prefix=bool(int(config.get(
            "share_prefix", 1 if base.share_prefix else 0))),
        draft_len=int(config.get("draft_len", base.draft_len)),
        mesh_shape=mesh_shape,
        tp_vs_replicas=tp_mode,
    )


# ---------------------------------------------------------------------------
# the co-deployment surrogate
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class CotuneParams:
    """Model shape + serving workload behind the co-deployment surrogate.

    The reference's fields and calibration constants (see
    ``repro.serve.space.CotuneParams``), less the two that only its VMEM
    spill term read (``slot_vmem_bytes``, ``kv_buffer_factor``).
    """

    heads: int = 16
    kv_heads: int = 4
    head_dim: int = 64
    n_layers: int = 8
    max_seq: int = 2048
    prompt_len: int = 512
    gen_len: int = 64
    n_requests: int = 64         # queued workload depth behind the SLA
    prompt_spread: float = 0.35  # relative prompt-length variation (sjf win)
    dtype: str = "float32"
    sla_s: float = 0.55          # mean per-request latency SLA
    sla_penalty: float = 2.0     # soft-penalty exponent past the SLA
    weight_stream_s: float = 2e-3   # weights read once per decode step
    per_token_s: float = 5e-5       # non-attention compute per token
    slot_dispatch_s: float = 2e-5   # per-slot decode dispatch state, even idle
    prefill_tok_s: float = 2e-6
    prefill_chunk_overhead_s: float = 1e-3
    interleave_step_factor: float = 1.03  # mixed chunk+decode dispatch cost
    sjf_latency_gain: float = 0.3   # mean-latency win per unit of spread
    page_table_s: float = 2e-8      # per page per step (table walk)
    # on_demand: per-resident-slot reservation-growth checks each step,
    # and the recompute tax of an over-admitted request (a fraction of an
    # extra prefill)
    extend_check_s: float = 1e-6
    preempt_recompute: float = 0.5
    # the workload's shared prompt fraction, the n-gram drafter's
    # per-token acceptance, and the verify-column cost of a draft token
    prefix_share_frac: float = 0.25
    spec_accept: float = 0.6
    draft_token_s: float = 1e-5
    # tensor-parallel communication terms (reached only by a cached
    # config with mesh knobs: the port's space has none)
    allreduce_base_s: float = 3e-5
    allreduce_byte_s: float = 5e-9

    @classmethod
    def from_model(cls, cfg, max_seq: int = 2048, **kw) -> "CotuneParams":
        """Derive the shape fields from a ``ModelConfig`` (``n_heads``: the
        port has no head padding, so it is the reference's
        ``padded_heads`` for every ported config).  The SLA scales with
        the serving window unless given explicitly."""
        kw.setdefault("sla_s", 0.55 * max_seq / 2048.0)
        return cls(heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                   head_dim=cfg.head_dim_, n_layers=cfg.n_layers,
                   max_seq=max_seq, dtype=cfg.compute_dtype, **kw)

    def decode_dims(self, batch: int) -> Dict[str, int]:
        return {"B": int(batch), "S": self.max_seq, "H": self.heads,
                "KV": self.kv_heads, "D": self.head_dim}

    def default_kernel_config(self) -> Config:
        return KERNELS["decode_attention"].make_space().default_config()

    def kernel_space(self) -> ParameterSpace:
        return KERNELS["decode_attention"].make_space()


def params_for_fingerprint(fp: Any, base: CotuneParams) -> CotuneParams:
    """Measured workload feedback -> surrogate params.

    ``fp`` is a workload fingerprint (duck-typed: ``prompt_mean``,
    ``gen_mean``, ``prompt_spread``, ``depth``, ``share_frac``,
    ``accept_rate``): the measured acceptance rate replaces
    ``spec_accept`` and the measured prefix-share fraction replaces
    ``prefix_share_frac``; ``nan`` (no data yet) keeps the prior.  The
    length/demand fields re-center the workload shape.
    """
    kw: Dict[str, Any] = {
        "prompt_len": max(1, int(round(fp.prompt_mean))),
        "gen_len": max(1, int(round(fp.gen_mean))),
        "prompt_spread": float(min(max(fp.prompt_spread, 0.0), 1.0)),
        "n_requests": max(1, int(round(fp.depth))),
    }
    if math.isfinite(fp.share_frac):
        kw["prefix_share_frac"] = float(min(max(fp.share_frac, 0.0), 0.95))
    if math.isfinite(fp.accept_rate):
        kw["spec_accept"] = float(min(max(fp.accept_rate, 0.0), 0.99))
    return replace(base, **kw)


def _attn_step_seconds(kernel_cfg: Config, batch: int,
                       p: CotuneParams) -> float:
    """Per-decode-step attention time at this batch: the Hopper cost model
    of the dense decode kernel at the resident batch (its shared-memory
    bound on blocks per SM included)."""
    return float(KERNELS["decode_attention"].model_cost(
        kernel_cfg, p.decode_dims(batch), p.dtype))


def coupled_serve_metrics(serve_cfg: Config, kernel_cfg: Config,
                          p: CotuneParams) -> PerfMetric:
    """End-to-end serve throughput (tokens/s) for one co-deployment
    config, derived from the continuous runtime's semantics — the
    reference's model term for term (see
    ``repro.serve.space.coupled_serve_metrics`` for the derivation):
    residency bounded by the page pool under each page policy, fifo/sjf
    admission stalls against interleave's overlapped prefill, sjf's
    mean-latency gain, prefix sharing's private footprint, draft
    acceptance, the on_demand recompute tax.

    value = throughput under the mean-latency SLA (soft penalty past it);
    metrics carry the raw throughput and the step breakdown.
    Deterministic, so batched/sequential tuner parity is exact.
    """
    B = int(serve_cfg["max_batch"])
    chunk = int(serve_cfg["prefill_chunk"])
    pages = int(serve_cfg["kv_cache_pages"])
    schedule = str(serve_cfg["schedule"])
    policy = str(serve_cfg.get("page_policy", "reserve"))
    share = bool(int(serve_cfg.get("share_prefix", 0)))
    k_draft = int(serve_cfg.get("draft_len", 0))
    # sharding knobs (absent = single device, the port's whole space)
    n_dev = int(serve_cfg.get("mesh_devices", 1))
    tp_mode = str(serve_cfg.get("tp_vs_replicas", "tp"))
    r_rep = n_dev if (n_dev > 1 and tp_mode == "replicas") else 1
    m_tp = n_dev if (n_dev > 1 and tp_mode == "tp") else 1
    m_eff = m_tp if p.heads % m_tp == 0 else 1

    f_share = p.prefix_share_frac if share else 0.0
    prompt_eff = p.prompt_len * (1.0 - f_share)

    # group-granular residency minus the scratch group: reserve packs by
    # the worst-case footprint, on_demand by the expected one
    groups_worst = math.ceil((prompt_eff + p.gen_len) / PAGE_TOKENS)
    if policy == "on_demand":
        groups_per_req = math.ceil(
            (prompt_eff + p.gen_len / 2.0) / PAGE_TOKENS)
    else:
        groups_per_req = groups_worst
    c_pages = max(1, (pages - 1) // groups_per_req)
    C = max(1, min(B * r_rep, c_pages * r_rep, p.n_requests))
    c_rep = -(-C // r_rep)

    attn_s = p.n_layers * _attn_step_seconds(kernel_cfg, c_rep, p) / m_eff
    step_s = (p.weight_stream_s / m_tp + c_rep * p.per_token_s + attn_s
              + B * r_rep * p.slot_dispatch_s
              + pages * r_rep * p.page_table_s)
    comm_s = 0.0
    if m_tp > 1:
        act_bytes = c_rep * p.heads * p.head_dim * _dtype_bytes(p.dtype)
        comm_s = p.n_layers * 2 * (
            p.allreduce_base_s
            + p.allreduce_byte_s * act_bytes * (m_tp - 1) / m_tp)
        step_s += comm_s
    if policy == "on_demand":  # per-step reservation-growth bookkeeping
        step_s += c_rep * p.extend_check_s

    # prefill over the non-shared tail, in chunks paying a fixed overhead
    chunk = min(chunk, max(int(math.ceil(prompt_eff)), 1))
    n_chunks = math.ceil(prompt_eff / chunk)
    prefill_s = n_chunks * (p.prefill_chunk_overhead_s
                            + chunk * p.prefill_tok_s / m_eff)

    # recompute tax past the preemption-free concurrency
    preempt_frac = 0.0
    if policy == "on_demand":
        c_worst = max(1, min(
            B * r_rep,
            max(1, (pages - 1) // groups_worst) * r_rep,
            p.n_requests))
        preempt_frac = max(0.0, 1.0 - c_worst / float(C))
        prefill_s *= 1.0 + p.preempt_recompute * preempt_frac

    # drafts: E = (1-a^(k+1))/(1-a) tokens a dispatch, each dispatch
    # dearer by k verify columns
    spec_E = 1.0
    step_eff = step_s
    if k_draft > 0:
        a = min(max(p.spec_accept, 0.0), 0.999)
        spec_E = (1.0 - a ** (k_draft + 1)) / (1.0 - a)
        step_eff = step_s + k_draft * p.draft_token_s

    g = p.gen_len
    decode_cycle = g / spec_E * step_eff
    if schedule == "interleave":
        denom = decode_cycle * p.interleave_step_factor + prefill_s
    else:
        denom = decode_cycle + c_rep * prefill_s
    tput = C * g / denom

    # mean latency: service at residency C + queue wait behind R requests
    service = prefill_s + decode_cycle
    R = max(p.n_requests, C)
    latency = service * (R + C) / (2.0 * C)
    if schedule == "sjf":  # short jobs exit first under mixed lengths
        latency *= 1.0 - p.sjf_latency_gain * p.prompt_spread

    value = tput
    if latency > p.sla_s > 0:
        value = tput * (p.sla_s / latency) ** p.sla_penalty
    return PerfMetric(
        value=float(value), higher_is_better=True,
        metrics={"raw_throughput": float(tput), "latency_s": float(latency),
                 "step_s": float(step_s), "attn_s": float(attn_s),
                 "prefill_s": float(prefill_s),
                 "resident": float(C),
                 "resident_per_replica": float(c_rep),
                 "kv_util": float(C) / float(B * r_rep),
                 "mesh_devices": int(n_dev),
                 "tp_vs_replicas": tp_mode,
                 "comm_s": float(comm_s),
                 "page_policy": policy,
                 "preempt_frac": float(preempt_frac),
                 "share_prefix": bool(share),
                 "draft_len": int(k_draft),
                 "spec_tokens_per_step": float(spec_E),
                 "sla_met": bool(latency <= p.sla_s)})


class ServeSurrogate(Surrogate):
    """The serve engine tuned *in isolation*: the kernel is whatever config
    the serve team deploys against (stock launch config by default) — the
    independent-tuning arm of the co-tuning comparison."""

    name = "serve"

    def __init__(self, params: Optional[CotuneParams] = None,
                 kernel_cfg: Optional[Config] = None,
                 max_devices: int = 1):
        self.params = params or CotuneParams()
        self.kernel_cfg = dict(kernel_cfg) if kernel_cfg \
            else self.params.default_kernel_config()
        self.max_devices = int(max_devices)

    def space(self) -> ParameterSpace:
        return serve_knob_space(self.params.max_seq,
                                max_devices=self.max_devices)

    @property
    def feasibility_model(self):
        """Deployability floor of the paged continuous runtime the
        surrogate models: configs ``apply_serve_knobs`` would mutate are
        pruned before they burn a test."""
        from repro_torch.analysis.feasibility import serve_feasibility

        return serve_feasibility(self.params.max_seq,
                                 n_devices=self.max_devices,
                                 n_heads=self.params.heads,
                                 n_kv_heads=self.params.kv_heads)

    def test_batch(self, configs: Sequence[Config]) -> List[PerfMetric]:
        return [coupled_serve_metrics(c, self.kernel_cfg, self.params)
                for c in configs]


class ServeKernelCoupling:
    """Scalarizer for the joint SUT: the end-to-end measurement, computed
    at the *actual* kernel launch config under test — the interaction the
    member metrics alone cannot express.  The kernel member's standalone
    cost is kept in the metrics for reporting."""

    def __init__(self, params: Optional[CotuneParams] = None):
        self.params = params or CotuneParams()

    def __call__(self, metrics: Dict[str, PerfMetric],
                 configs: Dict[str, Config]) -> PerfMetric:
        out = coupled_serve_metrics(configs["serve"], configs["kernel"],
                                    self.params)
        if "kernel" in metrics:
            out.metrics["kernel_alone_s"] = float(metrics["kernel"].value)
        return out


# ---------------------------------------------------------------------------
# the LIVE co-tuning path (wall-clock the real engine; --joint --real)
# ---------------------------------------------------------------------------
class LiveServeSUT:
    """The real ``ServeEngine`` as a system-under-tune.

    Each test maps the candidate knobs onto a ``ServeConfig``
    (``apply_serve_knobs``), builds a fresh engine on ``device`` — the
    paper's apply-config-and-restart loop — and wall-clocks ``generate``
    over a fixed synthetic workload by the shared live methodology
    (``repro_torch.core.sut_torch.median_wall_clock``): ``warmup`` untimed
    calls (kernel builds included), then the median of ``repeats`` timed
    calls, each ended by a device sync.

    The metric is generated tokens/sec; ``latency_s`` (the full-workload
    wall time) rides along for SLA scalarizers, as do the prefill/decode
    split, the chunk and step counts.
    """

    def __init__(self, model, params, base: Optional[Any] = None,
                 prompt_len: int = 32, gen_len: int = 8,
                 n_requests: int = 8, warmup: int = 1, repeats: int = 3,
                 seed: int = 0, max_slots: int = 64,
                 max_devices: int = 1,
                 device: Union[str, torch.device] = "cuda"):
        from repro_torch.models.common import resolve_device

        from .engine import ServeConfig

        _single_device(max_devices)
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.base = base or ServeConfig(max_seq=128)
        self.max_devices = int(max_devices)
        if prompt_len + gen_len > self.base.max_seq:
            raise ValueError("prompt_len + gen_len exceeds the serving "
                             f"window ({self.base.max_seq})")
        self.prompt_len = prompt_len
        self.gen_len = gen_len
        self.warmup = warmup
        self.repeats = repeats
        self.max_slots = max_slots
        rng = np.random.default_rng(seed)
        self.prompts = rng.integers(
            1, model.cfg.vocab_size, size=(n_requests, prompt_len)).tolist()
        self.name = f"serve-live[{model.cfg.name}]"

    def space(self) -> ParameterSpace:
        return serve_knob_space(self.base.max_seq, self.max_slots,
                                max_devices=self.max_devices)

    @property
    def feasibility_model(self):
        """The deployability floor of THIS deployment base: a below-floor
        candidate would not build the engine the knobs describe."""
        from repro_torch.analysis.feasibility import serve_feasibility

        return serve_feasibility(
            self.base.max_seq, runtime=self.base.runtime,
            kv_layout=self.base.kv_layout,
            kv_page_block=self.base.kv_page_block,
            n_devices=self.max_devices,
            n_heads=self.model.cfg.n_heads,
            n_kv_heads=self.model.cfg.n_kv_heads)

    def test(self, config: Config) -> PerfMetric:
        from repro_torch.core.sut_torch import median_wall_clock, sync

        from .engine import ServeEngine

        scfg = apply_serve_knobs(config, self.base)
        engine = ServeEngine(self.model, self.params, scfg,
                             device=self.device)
        out: Dict[str, Any] = {}

        def run():
            out["res"] = engine.generate(self.prompts, self.gen_len)
            sync(self.device)

        wall = median_wall_clock(run, self.warmup, self.repeats)
        res = out["res"]
        n_tok = sum(len(t) for t in res.tokens)
        tput = n_tok / max(wall, 1e-9)
        return PerfMetric(
            value=float(tput), higher_is_better=True,
            metrics={"latency_s": float(wall),
                     "prefill_s": float(res.prefill_seconds),
                     "decode_s": float(res.decode_seconds),
                     "prefill_chunks": int(res.prefill_chunks),
                     "steps": int(res.steps), "tokens": int(n_tok),
                     "warmup": self.warmup, "repeats": self.repeats})


class LiveCotuneScalarizer:
    """Joint objective for the live composite (serve + train + kernel).

    value = serve tokens/s, SLA-penalized when ``sla_s > 0`` (smooth
    ``(sla/lat)**penalty`` past the bound), scaled by the decode kernel's
    speedup over its default launch config raised to ``kernel_coupling``
    (roughly the attention share of a decode step), plus train tokens/s at
    the ``train_weight`` exchange rate.  Every member's raw value is kept
    in the metrics.
    """

    def __init__(self, sla_s: float = 0.0, penalty: float = 2.0,
                 train_weight: float = 0.25,
                 kernel_coupling: float = 0.25,
                 kernel_ref: Optional[float] = None):
        self.sla_s = sla_s
        self.penalty = penalty
        self.train_weight = train_weight
        self.kernel_coupling = kernel_coupling
        self.kernel_ref = kernel_ref

    def __call__(self, metrics: Dict[str, PerfMetric],
                 configs: Dict[str, Config]) -> PerfMetric:
        serve = metrics["serve"]
        lat = float(serve.metrics["latency_s"])
        value = float(serve.value)
        sla_met = True
        if self.sla_s > 0 and lat > self.sla_s:
            sla_met = False
            value *= (self.sla_s / lat) ** self.penalty
        kern = metrics.get("kernel")
        kernel_speedup = 1.0
        if kern is not None and self.kernel_ref:
            kernel_speedup = self.kernel_ref / max(float(kern.value), 1e-12)
            value *= kernel_speedup ** self.kernel_coupling
        train = metrics.get("train")
        train_tput = float(train.value) if train is not None else 0.0
        value += self.train_weight * train_tput
        return PerfMetric(
            value=float(value), higher_is_better=True,
            metrics={"serve_tput": float(serve.value),
                     "latency_s": lat, "sla_met": bool(sla_met),
                     "train_tput": train_tput,
                     "kernel_speedup": float(kernel_speedup),
                     "prefill_chunks": serve.metrics.get("prefill_chunks")})


def make_live_cotune_sut(model_cfg, *, max_seq: int = 128,
                         prompt_len: int = 32, gen_len: int = 8,
                         n_requests: int = 8, max_slots: int = 8,
                         train_seq: int = 32, train_batch: int = 8,
                         warmup: int = 1, repeats: int = 3, seed: int = 0,
                         sla_s: float = 0.0, train_weight: float = 0.25,
                         max_devices: int = 1,
                         device: Union[str, torch.device] = "cuda"
                         ) -> CompositeSUT:
    """Serve engine + train step + decode kernel as ONE live SUT on
    ``device``.

    Every serve/train test wall-clocks the real system: the engine is
    rebuilt under the candidate knobs and timed end to end, and the train
    step is rebuilt and timed.  The kernel member times the CUDA decode
    kernel on the card and scores the Hopper cost model on the CPU
    (``KernelSUT``'s mode follows the device); its default-config cost is
    measured once up front as the speedup reference the scalarizer
    couples through.  The model's weights are random from ``seed``.
    """
    from repro_torch.autotune.sut import KernelSUT
    from repro_torch.core.sut_torch import TrainStepSUT
    from repro_torch.models import Model

    from .engine import ServeConfig

    _single_device(max_devices)
    model = Model(model_cfg, device=device)
    params = model.init(seed)
    # the paged continuous runtime: schedule AND kv_cache_pages act in the
    # engine being wall-clocked
    base = ServeConfig(max_seq=max_seq, kv_layout="paged")
    serve = LiveServeSUT(model, params, base=base, prompt_len=prompt_len,
                         gen_len=gen_len, n_requests=n_requests,
                         warmup=warmup, repeats=repeats, seed=seed,
                         max_slots=max_slots, max_devices=max_devices,
                         device=device)
    train = TrainStepSUT(model_cfg, seq_len=train_seq,
                         global_batch=train_batch, warmup=warmup,
                         repeats=repeats, seed=seed, device=device)
    default_batch = int(serve.space()["max_batch"].default)
    dims = {"B": default_batch, "S": max_seq, "H": model_cfg.n_heads,
            "KV": model_cfg.n_kv_heads, "D": model_cfg.head_dim_}
    kernel = KernelSUT("decode_attention", dims,
                       dtype=model_cfg.compute_dtype, device=device)
    kernel_ref = float(
        kernel.test(kernel.space().default_config()).value)
    return CompositeSUT(
        {"serve": serve, "train": train, "kernel": kernel},
        scalarize=LiveCotuneScalarizer(
            sla_s=sla_s, train_weight=train_weight, kernel_ref=kernel_ref),
        name="serve+train+kernel:live",
    )


def make_cotune_sut(params: Optional[CotuneParams] = None,
                    max_devices: int = 1) -> CompositeSUT:
    """Serve engine + decode kernel as one SUT under one budget, on the
    analytic surrogate: it never touches a card.

    The serve subsystem is config-only (its end-to-end measurement IS the
    scalarizer, which needs the kernel config); the kernel member scores
    the Hopper cost model at the stock serve batch — exactly what tuning
    it in isolation sees — and its cost is the ``kernel_alone_s``
    provenance in every joint metric.
    """
    from repro_torch.analysis.feasibility import serve_feasibility
    from repro_torch.autotune.sut import KernelSUT

    params = params or CotuneParams()
    default_batch = int(serve_knob_space(params.max_seq)["max_batch"].default)
    return CompositeSUT(
        {
            "serve": serve_knob_space(params.max_seq,
                                      max_devices=max_devices),
            "kernel": KernelSUT("decode_attention",
                                params.decode_dims(default_batch),
                                dtype=params.dtype, device="cpu",
                                mode="model"),
        },
        scalarize=ServeKernelCoupling(params),
        name="serve+kernel",
        # the serve member is config-only (a bare space has no SUT to
        # carry a model), so its deployability predicates attach here
        feasibility={"serve": serve_feasibility(
            params.max_seq, n_devices=max_devices,
            n_heads=params.heads, n_kv_heads=params.kv_heads)},
    )

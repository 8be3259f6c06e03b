"""Serving engine: continuous-batching runtime over a paged KV cache.

Counterpart of ``repro.serve.engine`` for the configuration the live
system under tune runs (``kv_layout="paged"``, ``schedule="fifo"``,
``page_policy="reserve"``, greedy decoding): a slot scheduler admits
requests into decode slots as they free up, each admission reserves its
worst-case page groups and prefills its prompt through the exact chunked
path, and decode is one batched dispatch per step at per-slot cache
lengths, whose attention is the paged decode kernel.  With
``autotune_kernels`` the engine tunes (or loads from the autotune cache)
the launch configs of its kernel shapes on its own device and adopts the
paged kernel's tuned ``pages_per_block`` as the pool's group size.

``ServeConfig`` keeps every field and default of the reference so configs
carry over; a knob whose path is not ported yet raises
``NotImplementedError`` naming its ROADMAP item when the engine is built
(it is never silently ignored).  The engine runs on ``device``; the
default ``"cuda"`` raises without a card.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import autotune
from repro_torch.models import Model
from repro_torch.models.common import resolve_device

from .paging import (PAGE_TOKENS, OversubscriptionError, PageAllocator,
                     min_pages_for)
from .scheduler import PAGE_POLICIES, SCHEDULES, Request, SlotScheduler

__all__ = ["ServeConfig", "ServeEngine", "GenerationResult",
           "OversubscriptionError"]

RUNTIMES = ("continuous", "wave")
KV_LAYOUTS = ("dense", "paged")


@dataclass
class ServeConfig:
    """The reference's serve config, field for field (see
    ``repro.serve.engine.ServeConfig`` for what each knob does).  Only
    the knobs this slice runs are range-checked here; the engine rejects
    the others while their paths are not ported (``_UNPORTED``)."""

    max_seq: int = 2048
    batch_slots: int = 8
    temperature: float = 0.0  # 0 = greedy
    eos_token: Optional[int] = None
    seed: int = 0
    prefill_chunk: int = 512
    # KV capacity in PAGE_TOKENS-token pages; None auto-sizes to full
    # residency (+ the scratch group under paging)
    kv_cache_pages: Optional[int] = None
    schedule: str = "fifo"
    page_policy: str = "reserve"
    runtime: str = "continuous"
    kv_layout: str = "dense"
    # pages per allocation group == the pool's token tile
    kv_page_block: int = 1
    share_prefix: bool = False
    draft_len: int = 0
    draft_window: int = 256
    # effective admission cap <= batch_slots (None = all slots)
    slot_cap: Optional[int] = None
    retune: bool = False
    retune_budget: int = 16
    retune_threshold: float = 0.25
    retune_window: int = 16
    retune_cooldown: int = 32
    retune_check_every: int = 4
    retune_min_requests: int = 6
    tuned_signature: Optional[str] = None
    autotune_kernels: bool = False
    autotune_budget: int = 12
    mesh_shape: Optional[Tuple[int, int]] = None
    rules_preset: str = "serve_tp"
    tp_vs_replicas: str = "tp"

    def __post_init__(self):
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}; "
                             f"have {SCHEDULES}")
        if self.runtime not in RUNTIMES:
            raise ValueError(f"unknown runtime {self.runtime!r}; "
                             f"have {RUNTIMES}")
        if self.kv_layout not in KV_LAYOUTS:
            raise ValueError(f"unknown kv_layout {self.kv_layout!r}; "
                             f"have {KV_LAYOUTS}")
        if self.page_policy not in PAGE_POLICIES:
            raise ValueError(f"unknown page_policy {self.page_policy!r}; "
                             f"have {PAGE_POLICIES}")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.kv_page_block < 1:
            raise ValueError("kv_page_block must be >= 1")
        if self.slot_cap is not None and not (
                1 <= self.slot_cap <= self.batch_slots):
            raise ValueError(f"slot_cap must be in [1, batch_slots="
                             f"{self.batch_slots}]; got {self.slot_cap}")
        paged = self.runtime == "continuous" and self.kv_layout == "paged"
        needed = self.batch_slots * self.max_seq
        # remember auto-sizing: pool sizing re-derives full residency
        self._kv_pages_auto = self.kv_cache_pages is None
        if self.kv_cache_pages is None:
            pages = -(-needed // PAGE_TOKENS)
            if paged:  # round to group granularity + the scratch group
                ppb = self.kv_page_block
                pages = (-(-pages // ppb) + 1) * ppb
            self.kv_cache_pages = pages
        if paged:
            # Pages bound residency, not the dense footprint — but one
            # max_seq request (plus the scratch group) must always fit.
            floor = min_pages_for(self.max_seq, self.kv_page_block)
            if self.kv_cache_pages < floor:
                raise ValueError(
                    f"KV cache too small: a single {self.max_seq}-token "
                    f"request (+ the scratch group) needs {floor} pages at "
                    f"{self.kv_page_block} pages/group but "
                    f"kv_cache_pages={self.kv_cache_pages}")
        else:
            capacity = self.kv_cache_pages * PAGE_TOKENS
            if needed > capacity:
                raise ValueError(
                    f"KV cache too small: {self.batch_slots} slots x "
                    f"{self.max_seq} tokens needs {needed} tokens but "
                    f"kv_cache_pages={self.kv_cache_pages} holds only "
                    f"{capacity}")


# (knob, predicate that means "set to a value this slice does not run",
#  where the port of that path is tracked)
_UNPORTED = (
    ("runtime", lambda c: c.runtime != "continuous",
     "the wave runtime (ROADMAP queue 1, item 3)"),
    ("kv_layout", lambda c: c.kv_layout != "paged",
     "the dense KV layout (ROADMAP queue 1, item 3)"),
    ("temperature", lambda c: c.temperature > 0,
     "temperature sampling (ROADMAP queue 1, item 3)"),
    ("schedule", lambda c: c.schedule != "fifo",
     "the sjf and interleave schedules (ROADMAP queue 1, item 3)"),
    ("page_policy", lambda c: c.page_policy != "reserve",
     "the on_demand page policy and preemption (ROADMAP queue 1, item 3)"),
    ("share_prefix", lambda c: c.share_prefix,
     "prefix sharing (ROADMAP queue 1, item 3)"),
    ("draft_len", lambda c: c.draft_len != 0,
     "n-gram drafts with a verify pass (ROADMAP queue 1, item 3)"),
    ("retune", lambda c: c.retune,
     "online retuning (ROADMAP queue 1, item 5)"),
    ("mesh_shape", lambda c: c.mesh_shape is not None,
     "multi-device serving (ROADMAP queue 1, item 8)"),
)


def _check_ported(cfg: ServeConfig) -> None:
    for knob, unported, where in _UNPORTED:
        if unported(cfg):
            raise NotImplementedError(
                f"ServeConfig.{knob}={getattr(cfg, knob)!r} needs {where}, "
                "which is not ported yet")


@dataclass
class GenerationResult:
    tokens: List[List[int]]  # generated continuations (per request)
    prefill_seconds: float
    decode_seconds: float
    steps: int  # batched decode dispatches
    prefill_chunks: int = 0  # prefill dispatches actually issued
    # per-request provenance (rid order == input order):
    # {"rid", "prompt_len", "new_tokens", "latency_s", "ttft_s",
    #  "preemptions"}
    per_request: List[Dict[str, Any]] = field(default_factory=list)
    preemptions: int = 0  # always 0 under the reserve policy

    @property
    def decode_tokens_per_sec(self) -> float:
        n = sum(len(t) for t in self.tokens)
        return n / max(self.decode_seconds, 1e-9)

    def latency_percentile(self, q: float) -> float:
        """q-th percentile (0..100) of per-request latency seconds."""
        lats = [r["latency_s"] for r in self.per_request]
        if not lats:
            return 0.0
        return float(np.percentile(np.asarray(lats), q))

    @property
    def p50_latency_s(self) -> float:
        return self.latency_percentile(50.0)

    @property
    def p95_latency_s(self) -> float:
        return self.latency_percentile(95.0)


class ServeEngine:
    def __init__(self, model: Model, params, cfg: ServeConfig,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        _check_ported(cfg)
        if model.device.type != self.device.type:
            raise ValueError(f"the model makes its caches on {model.device}"
                             f" but the engine runs on {self.device}")
        self.model = model
        self.params = _to_device(params, self.device)
        # private copy: pool sizing rewrites kv_cache_pages and must not
        # leak into a caller-owned config reused across engines
        orig = cfg
        self.cfg = cfg = dataclasses.replace(cfg)
        cfg._kv_pages_auto = getattr(orig, "_kv_pages_auto", False)
        # tuned launch configs for this engine's kernel shapes (filled when
        # cfg.autotune_kernels; consulted implicitly by kernels.ops)
        self.kernel_blocks: Dict[str, Dict[str, Any]] = {}
        mcfg = model.cfg
        if cfg.autotune_kernels:
            # The reference's quirk, kept: the engine tunes the dense
            # decode kernel at its slot shape although the paged runtime
            # never runs it (ROADMAP queue 3).
            self.kernel_blocks["decode_attention"] = self._ensure(
                "decode_attention",
                {"B": cfg.batch_slots, "S": cfg.max_seq,
                 "H": mcfg.n_heads, "KV": mcfg.n_kv_heads,
                 "D": mcfg.head_dim_})
        self._size_paged_pool()

    def _ensure(self, kernel: str, dims: Dict[str, int]) -> Dict[str, Any]:
        return autotune.ensure_tuned(kernel, dims,
                                     dtype=self.model.cfg.compute_dtype,
                                     budget=self.cfg.autotune_budget,
                                     device=self.device)

    def _size_paged_pool(self) -> None:
        """Fix the pool geometry: group size (pages), groups per request,
        total groups.  With autotune the paged kernel's tuned
        ``pages_per_block`` becomes the group size — clamped so one
        max_seq request still fits the configured page budget.  The
        reference also re-keys the winner under the runtime pool
        signature for its run-time consult point; the port's paged kernel
        has no launch knob besides the group size, so nothing would read
        such an entry."""
        cfg, mcfg = self.cfg, self.model.cfg
        ppb = cfg.kv_page_block
        if cfg.autotune_kernels:
            tuned = self._ensure(
                "paged_attention",
                {"B": cfg.batch_slots, "S": cfg.max_seq,
                 "H": mcfg.n_heads, "KV": mcfg.n_kv_heads,
                 "D": mcfg.head_dim_})
            self.kernel_blocks["paged_attention"] = tuned
            ppb = int(tuned.get("pages_per_block", ppb))
        if not cfg._kv_pages_auto:
            while ppb > 1:  # tuned tile too coarse for this page budget
                if cfg.kv_cache_pages >= min_pages_for(cfg.max_seq, ppb):
                    break
                ppb //= 2
        self.group_pages = ppb
        self.group_tokens = ppb * PAGE_TOKENS
        self.max_groups = -(-cfg.max_seq // self.group_tokens)
        if cfg._kv_pages_auto:
            # auto-sized budget: full residency at the group size
            self.pool_groups = cfg.batch_slots * self.max_groups + 1
        else:
            self.pool_groups = max(cfg.kv_cache_pages // ppb,
                                   self.max_groups + 1)
        # the config reports the pool actually allocated
        cfg.kv_cache_pages = self.pool_groups * ppb

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: Union[int, Sequence[int]],
    ) -> GenerationResult:
        """Generate continuations for a batch of requests.

        Prompts may have mixed lengths and ``max_new_tokens`` may be
        per-request; completed requests free their slot and KV pages for
        pending ones mid-generation.
        """
        n = len(prompts)
        if isinstance(max_new_tokens, (int, np.integer)):
            max_new = [int(max_new_tokens)] * n
        else:
            max_new = [int(m) for m in max_new_tokens]
            if len(max_new) != n:
                raise ValueError("per-request max_new_tokens length must "
                                 "match the number of prompts")
        if any(m < 1 for m in max_new):
            raise ValueError("max_new_tokens must be >= 1")
        for p, m in zip(prompts, max_new):
            if len(p) + m > self.cfg.max_seq:
                raise ValueError("prompt + generation exceeds max_seq")
        return self._generate_continuous(prompts, max_new)

    # ------------------------------------------------------------------
    # continuous-batching runtime
    # ------------------------------------------------------------------
    def _greedy_rows(self, logits: torch.Tensor) -> torch.Tensor:
        lg = logits[:, -1, :self.model.cfg.vocab_size].float()
        return lg.argmax(dim=-1)

    def _init_continuous_cache(self):
        """Slot KV state: the paged pools."""
        return self.model.init_paged_cache(self.pool_groups,
                                           self.group_tokens)

    def _generate_continuous(self, prompts, max_new: List[int]
                             ) -> GenerationResult:
        cfg = self.cfg
        dev = self.device
        B = cfg.batch_slots
        reqs = [Request(i, list(p), max_new[i])
                for i, p in enumerate(prompts)]
        sched = SlotScheduler(cfg.schedule, B, page_policy=cfg.page_policy)
        sched.submit(reqs)
        # the allocator mirrors the device pool exactly
        alloc = PageAllocator(self.pool_groups * self.group_pages,
                              PAGE_TOKENS, self.group_pages)
        page_tables = np.zeros((B, self.max_groups), np.int32)
        cache = self._init_continuous_cache()
        # admission cap: only slots below it admit
        slot_cap = min(cfg.slot_cap or B, B)

        # host-side slot state
        slot_req: List[Optional[Request]] = [None] * B
        slot_chunks: List[List[np.ndarray]] = [[] for _ in range(B)]
        slot_out: List[List[int]] = [[] for _ in range(B)]
        lengths = np.zeros(B, np.int64)
        next_tok = np.zeros(B, np.int64)

        results: List[Optional[List[int]]] = [None] * len(prompts)
        per_request: List[Optional[Dict[str, Any]]] = [None] * len(prompts)
        first_tok_t: Dict[int, float] = {}  # rid -> first-token time
        prefill_s = decode_s = 0.0
        steps = chunks_issued = 0
        t0 = time.time()

        def run_chunk(b: int) -> None:
            nonlocal cache, prefill_s, chunks_issued
            piece_tokens = slot_chunks[b].pop(0)
            piece = {"tokens": torch.as_tensor(piece_tokens, device=dev)}
            page_row = torch.as_tensor(page_tables[b], device=dev)
            r = slot_req[b]
            t = time.time()
            logits, cache = self.model.prefill_chunk_slot_paged(
                self.params, piece, cache, page_row, int(lengths[b]))
            lengths[b] += piece_tokens.shape[1]
            chunks_issued += 1
            if not slot_chunks[b]:  # prefill done: sample the next token
                tok = int(self._greedy_rows(logits)[0])
                prefill_s += time.time() - t
                first_tok_t.setdefault(r.rid, time.time())
                accept_token(b, tok)
            else:
                self._sync()
                prefill_s += time.time() - t

        def accept_token(b: int, tok: int) -> None:
            r = slot_req[b]
            slot_out[b].append(tok)
            next_tok[b] = tok
            done = len(slot_out[b]) >= r.max_new or (
                cfg.eos_token is not None and tok == cfg.eos_token)
            if done:
                finish_slot(b)

        def clear_slot(b: int) -> None:
            slot_req[b] = None
            slot_out[b] = []
            slot_chunks[b] = []
            lengths[b] = 0
            next_tok[b] = 0
            page_tables[b, :] = PageAllocator.SCRATCH_GROUP

        def finish_slot(b: int) -> None:
            r = slot_req[b]
            now = time.time()
            results[r.rid] = list(slot_out[b])
            per_request[r.rid] = {
                "rid": r.rid, "prompt_len": r.prompt_len,
                "new_tokens": len(slot_out[b]),
                "latency_s": now - t0,
                "ttft_s": first_tok_t.get(r.rid, now) - t0,
                "preemptions": 0,
            }
            alloc.release(r.rid)
            clear_slot(b)

        def next_admission():
            """(request, groups) for the head request when its worst-case
            reservation fits the pool, else None (fifo is strict)."""
            head = sched.peek()
            groups = alloc.try_alloc(head.rid, head.total_tokens)
            if groups is None:
                return None
            sched.pop()
            return head, groups

        def loop() -> None:
            nonlocal cache, decode_s, steps
            while sched.has_pending or any(r is not None for r in slot_req):
                progressed = False
                # 1. admission into freed slots, in fifo order, each
                # admitted prompt prefilled chunk by chunk right away
                for b in range(B):
                    if b >= slot_cap:
                        continue
                    if slot_req[b] is not None or not sched.has_pending:
                        continue
                    admitted = next_admission()
                    if admitted is None:
                        break  # pool full: wait for a release
                    head, groups = admitted
                    page_tables[b, :] = PageAllocator.SCRATCH_GROUP
                    page_tables[b, :len(groups)] = groups
                    slot_req[b] = head
                    lengths[b] = 0
                    chunk = cfg.prefill_chunk
                    toks = np.asarray([list(head.prompt)], np.int64)
                    slot_out[b] = []
                    slot_chunks[b] = [toks[:, s:s + chunk]
                                      for s in range(0, toks.shape[1],
                                                     chunk)]
                    progressed = True
                    while slot_chunks[b] and slot_req[b] is not None:
                        run_chunk(b)
                # 2. one batched decode step over every decoding slot
                active = [b for b in range(B)
                          if slot_req[b] is not None and not slot_chunks[b]]
                if active:
                    t = time.time()
                    feed = torch.as_tensor(next_tok[:, None], device=dev)
                    lens = torch.as_tensor(lengths, dtype=torch.int32,
                                           device=dev)
                    table = torch.as_tensor(page_tables, device=dev)
                    logits, cache = self.model.decode_step_multi(
                        self.params, feed, cache, lens, table)
                    toks = self._greedy_rows(logits).cpu().numpy()
                    decode_s += time.time() - t
                    steps += 1
                    progressed = True
                    for b in active:
                        lengths[b] += 1  # the fed token is now resident
                        first_tok_t.setdefault(slot_req[b].rid, time.time())
                        accept_token(b, int(toks[b]))
                if not progressed:  # defensive: cannot happen (paging.py)
                    raise RuntimeError(
                        "continuous scheduler stalled: pending requests "
                        "but no admissible slot or decode step")

        try:
            loop()
        except BaseException:
            # no page group may outlive the generation
            alloc.release_all()
            raise
        finally:
            # post-run pool introspection (tests/bench), even on unwind
            self.last_alloc = alloc

        return GenerationResult(
            [list(t) for t in results], prefill_s, decode_s, steps,
            chunks_issued, [dict(r) for r in per_request])


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)

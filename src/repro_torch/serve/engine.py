"""Serving engine: continuous batching over dense or paged KV caches,
and the equal-length wave runtime.

Counterpart of ``repro.serve.engine``.  The continuous runtime (the
default) admits requests into decode slots as they free up, prefills
each admission's prompt through the exact chunked path, and decodes
every slot in one batched dispatch a step at per-slot cache lengths.
Its KV layout is ``dense`` (the default: per-slot (B, max_seq, KV, D)
buffers, attended densely) or ``paged`` (a pool of page groups and an
allocator; the attention of a decode step is the paged decode kernel),
the configuration the live system under tune runs.  The knobs
``serve_knob_space`` sweeps all act here:

* ``schedule``: ``fifo``, ``sjf`` (shortest prompt first, with a bounded
  bypass of a head whose reservation does not fit) or ``interleave``
  (prefill one chunk a slot between decode steps);
* ``page_policy``: ``reserve`` (worst-case reservations) or
  ``on_demand`` (prompt-size reservations grown as decode crosses group
  boundaries; on exhaustion the cheapest-recompute request is preempted
  and re-prefilled later); paged layout only;
* ``share_prefix``: admission maps registry-matched prompt-prefix groups
  copy-on-write instead of prefilling them; paged layout only;
* ``draft_len``: n-gram drafts from a request's own history ride extra
  columns of the decode dispatch (a verify step, plain PyTorch attention
  as in the reference) and the prefix that matches what single-token
  decode would sample is accepted;
* ``temperature``: sampling keyed on (seed, request id, token index).

None of them changes a greedy token.  With ``retune`` the engine
fingerprints its live request window (``serve.workload``), and when the
mix drifts from the signature its knobs were tuned under it re-tunes
them on the serve surrogate and swaps the winner into the running loop
at a step boundary: ``max_batch`` (the admission cap), ``schedule``,
``page_policy``, ``prefill_chunk``, ``draft_len`` and ``share_prefix``.

The wave runtime (``runtime="wave"``, and every stack without
``supports_continuous_batching``, such as Zamba2's Mamba2 layers) packs
equal-length prompts into waves of ``batch_slots``, prefills each wave
whole (``Model.prefill``: under ``attn_impl="pallas"`` the
flash-attention kernel) or in chunks, and decodes it in lockstep over
dense caches.  With ``autotune_kernels`` the engine tunes (or loads from
the autotune cache) the launch configs of its kernel shapes on its own
device: dense decode at its slot shape, the paged kernel's
``pages_per_block`` (adopted as the pool's group size), and on the wave
runtime flash attention and RMSNorm at each wave's prompt length.

``ServeConfig`` keeps every field and default of the reference so configs
carry over; meshes (``mesh_shape``) are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item when the engine is
built (the knob is never silently ignored).  The engine runs on
``device``; the default ``"cuda"`` raises without a card.
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
                     PrefixIndex, min_pages_for)
from .scheduler import PAGE_POLICIES, SCHEDULES, Request, SlotScheduler

__all__ = ["ServeConfig", "ServeEngine", "GenerationResult",
           "OversubscriptionError"]

RUNTIMES = ("continuous", "wave")
KV_LAYOUTS = ("dense", "paged")


def _tail_history(prompt: Sequence[int], out: List[int],
                  window: int) -> List[int]:
    """The trailing ``window`` tokens of prompt + generated, without
    building the whole concatenation (``window <= 0``: all of it)."""
    if window <= 0:
        return list(prompt) + out
    if window <= len(out):
        return out[-window:]
    head = list(prompt[-(window - len(out)):]) if len(prompt) else []
    return head + out


def _token_seed(key: Tuple[int, ...]) -> int:
    """The 64-bit generator seed of one sampled token, from its key
    (seed, request id, token index): a hash (numpy's ``SeedSequence``),
    so nearby keys give unrelated streams."""
    lo, hi = np.random.SeedSequence(
        [k & 0xFFFF_FFFF_FFFF_FFFF for k in key]).generate_state(2)
    return int(lo) | int(hi) << 32


@dataclass
class ServeConfig:
    """The reference's serve config, field for field (see
    ``repro.serve.engine.ServeConfig`` for what each knob does).  Only
    the knobs the port runs are range-checked here; the engine rejects
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
        if self.draft_len < 0:
            raise ValueError("draft_len must be >= 0")
        if self.draft_window < 2:
            raise ValueError("draft_window must be >= 2 (an n-gram draft "
                             "needs at least a 1-token suffix + 1 earlier "
                             "token to match against)")
        if self.slot_cap is not None and not (
                1 <= self.slot_cap <= self.batch_slots):
            raise ValueError(f"slot_cap must be in [1, batch_slots="
                             f"{self.batch_slots}]; got {self.slot_cap}")
        for knob in ("retune_budget", "retune_window", "retune_cooldown",
                     "retune_check_every", "retune_min_requests"):
            if getattr(self, knob) < 1:
                raise ValueError(f"{knob} must be >= 1")
        if self.retune_threshold < 0:
            raise ValueError("retune_threshold must be >= 0")
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


# (knob, predicate that means "set to a value the port does not run",
#  the ROADMAP queue-1 item that ports that path, by its title)
_UNPORTED = (
    ("mesh_shape", lambda c: c.mesh_shape is not None,
     "multi-device serving (ROADMAP queue 1: multi-device)"),
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
    #  "preemptions", "shared_tokens"}
    per_request: List[Dict[str, Any]] = field(default_factory=list)
    # recompute preemptions issued (on_demand page policy only)
    preemptions: int = 0
    # prompt tokens admitted straight from shared resident groups (their
    # prefill skipped), copy-on-write group splits, draft tokens proposed
    # to verification, and draft tokens accepted (beyond the first token
    # of every dispatch)
    shared_prefix_tokens: int = 0
    cow_splits: int = 0
    drafted: int = 0
    accepted: int = 0
    # online retune events (cfg.retune): one dict per swap, {"step",
    # "distance", "signature", "fingerprint", "config", "value",
    # "n_tests", "warm_source", "spec_accept", "measured_accept",
    # "applied": {knob: (old, new)}}
    retunes: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens accepted; ``nan`` when
        nothing was drafted ("no speculation ran" is not "every draft was
        rejected")."""
        if self.drafted == 0:
            return float("nan")
        return self.accepted / self.drafted

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
        # the last generation's OnlineRetuner (cfg.retune), allocator and
        # prefix registry (paged layout only), else None
        self.last_retuner = self.last_alloc = self.last_prefix = None
        self._continuous = (cfg.runtime == "continuous"
                            and model.supports_continuous_batching)
        self._paged = self._continuous and cfg.kv_layout == "paged"
        if cfg.kv_layout == "paged" and not self._paged:
            # The reference's wave fallback (semantics, not a device or
            # kernel fallback): a stack without continuous support runs
            # the wave loop over dense buffers even when the config asks
            # for paging.  The config passed the paged layout's lenient
            # one-request validation, so restore the dense footprint it
            # waived: kv_cache_pages reports the memory really allocated.
            needed = cfg.batch_slots * cfg.max_seq
            if cfg.kv_cache_pages * PAGE_TOKENS < needed:
                cfg.kv_cache_pages = -(-needed // PAGE_TOKENS)
        mcfg = model.cfg
        if cfg.autotune_kernels:
            # The reference's quirk, kept: the engine tunes the dense
            # decode kernel at its slot shape, which no layout's decode
            # runs (dense-layout decode attends with impl="dense";
            # ROADMAP queue 3).
            self.kernel_blocks["decode_attention"] = self._ensure(
                "decode_attention",
                {"B": cfg.batch_slots, "S": cfg.max_seq,
                 "H": mcfg.n_heads, "KV": mcfg.n_kv_heads,
                 "D": mcfg.head_dim_})
        if self._paged:
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

    def _warm_prefill_blocks(self, prompt_len: int) -> None:
        """Tune (or load) the launch configs of the shapes a wave runs on
        this engine's device: prefill attention at S = prompt_len, RMSNorm
        at the prefill and decode row counts.  Cache hits are free.  The
        model calls the plain ``rms_norm``, so the RMSNorm entries are
        tuned and never read (a reference quirk, ROADMAP queue 3)."""
        mcfg = self.model.cfg
        B = self.cfg.batch_slots
        self.kernel_blocks["flash_attention"] = self._ensure(
            "flash_attention",
            {"B": B, "S": prompt_len, "SK": prompt_len, "H": mcfg.n_heads,
             "KV": mcfg.n_kv_heads, "D": mcfg.head_dim_})
        self.kernel_blocks["rmsnorm_prefill"] = self._ensure(
            "rmsnorm", {"ROWS": B * prompt_len, "D": mcfg.d_model})
        self.kernel_blocks["rmsnorm_decode"] = self._ensure(
            "rmsnorm", {"ROWS": B, "D": mcfg.d_model})

    def _make_retuner(self):
        """The online workload-aware retuner for this engine (cfg.retune).

        It optimises over the same ``serve_knob_space`` the offline joint
        mode tunes, with ``kv_cache_pages`` frozen to the pool actually
        allocated, and keys its cache entries by the shape signature
        ``launch.tune --joint`` uses and by this engine's device, so
        online and offline winners on one backend transfer both ways
        through nearest-signature lookup."""
        from repro_torch.autotune import mesh_sig

        from .space import CotuneParams, serve_knob_space
        from .workload import OnlineRetuner

        cfg, mcfg = self.cfg, self.model.cfg
        B = cfg.batch_slots
        base_params = CotuneParams.from_model(mcfg, max_seq=cfg.max_seq)
        # clamp the allocated pool into the knob's range (the space uses
        # the same page_per_seq arithmetic) so the frozen value validates
        lo = max(1, cfg.max_seq // PAGE_TOKENS)
        pages = min(max(cfg.kv_cache_pages, lo), B * lo)
        space = serve_knob_space(cfg.max_seq, max_slots=B).freeze(
            {"kv_cache_pages": pages})
        active = {
            "max_batch": min(cfg.slot_cap or B, B),
            "prefill_chunk": cfg.prefill_chunk,
            "kv_cache_pages": pages,
            "schedule": cfg.schedule,
            "page_policy": cfg.page_policy,
            "share_prefix": int(bool(cfg.share_prefix)),
            "draft_len": cfg.draft_len,
        }
        # the dims launch.tune keys serve winners under (n_heads: the
        # port has no head padding)
        sig_dims = {"S": cfg.max_seq, "H": mcfg.n_heads,
                    "KV": mcfg.n_kv_heads, "D": mcfg.head_dim_}
        return OnlineRetuner(
            space, base_params, baseline=cfg.tuned_signature,
            budget=cfg.retune_budget, threshold=cfg.retune_threshold,
            min_requests=cfg.retune_min_requests,
            cooldown=cfg.retune_cooldown,
            check_every=cfg.retune_check_every, seed=cfg.seed,
            active_config=active, sig_dims=sig_dims,
            dtype=mcfg.compute_dtype, mesh=mesh_sig(None),
            device=self.device)

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

        Under the continuous runtime prompts may have mixed lengths and
        ``max_new_tokens`` may be per-request; completed requests free
        their slot (and KV pages) for pending ones mid-generation.  The
        wave runtime takes equal-length prompts, packed into
        ``batch_slots``-sized waves, a short last wave padded with copies.
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
        if self._continuous:
            return self._generate_continuous(prompts, max_new)
        return self._generate_waves(prompts, max_new)

    # ------------------------------------------------------------------
    # wave runtime
    # ------------------------------------------------------------------
    def _generate_waves(self, prompts, max_new: List[int]
                        ) -> GenerationResult:
        lens = {len(p) for p in prompts}
        if len(lens) != 1:
            raise ValueError("the wave runtime batches equal-length "
                             f"prompts; got lengths {sorted(lens)} "
                             "(use runtime='continuous' for mixed)")
        (plen,) = lens
        if self.cfg.autotune_kernels:
            self._warm_prefill_blocks(plen)
        self.last_alloc = self.last_prefix = None
        slots = self.cfg.batch_slots
        outputs: List[List[int]] = []
        per_request: List[Dict[str, Any]] = []
        prefill_s = decode_s = 0.0
        steps = chunks = 0
        t0 = time.time()
        for start in range(0, len(prompts), slots):
            wave = list(prompts[start:start + slots])
            wave_new = max_new[start:start + slots]
            n_real = len(wave)
            while len(wave) < slots:
                wave.append(wave[0])  # pad with a copy; discarded later
            toks, pf, dc, st, nc = self._generate_wave(
                np.asarray(wave, np.int64), max(wave_new))
            wave_done = time.time() - t0
            for i in range(n_real):
                t = toks[i][:wave_new[i]]
                outputs.append(t)
                per_request.append({
                    "rid": start + i, "prompt_len": plen,
                    "new_tokens": len(t), "latency_s": wave_done,
                    "ttft_s": wave_done - dc,
                    "preemptions": 0,  # waves hold slots to completion
                })
            prefill_s += pf
            decode_s += dc
            steps += st
            chunks += nc
        return GenerationResult(outputs, prefill_s, decode_s, steps, chunks,
                                per_request)

    def _generate_wave(self, prompt_arr: np.ndarray, max_new: int):
        """One wave: prefill (whole, or in chunks where the stack supports
        it), then lockstep decode until ``max_new`` or every row hit
        ``eos``.  Returns (tokens a row, prefill s, decode s, decode
        dispatches, prefill dispatches)."""
        B, P = prompt_arr.shape
        cache = self.model.init_cache(B, self.cfg.max_seq)
        chunk = self.cfg.prefill_chunk
        chunked = chunk < P and self.model.supports_chunked_prefill
        # host->device copy outside the timed window, as in the reference
        tokens = torch.as_tensor(prompt_arr, device=self.device)
        t0 = time.time()
        if chunked:
            n_chunks = 0
            for s0 in range(0, P, chunk):
                logits, cache = self.model.prefill_chunk(
                    self.params, {"tokens": tokens[:, s0:s0 + chunk]}, cache)
                n_chunks += 1
        else:
            logits, cache = self.model.prefill(self.params,
                                               {"tokens": tokens}, cache)
            n_chunks = 1
        self._sync()
        prefill_s = time.time() - t0

        eos = self.cfg.eos_token
        out = np.zeros((B, max_new), np.int64)
        done = np.zeros(B, bool)
        t0 = time.time()
        produced = 0
        for step in range(max_new):
            tok = self._sample(logits, step)
            out[:, step] = tok[:, 0].cpu().numpy()
            produced = step + 1
            if eos is not None:
                done |= out[:, step] == eos
                if done.all():
                    break
            if produced < max_new:
                logits, cache = self.model.decode_step(self.params, tok,
                                                       cache)
        decode_s = time.time() - t0

        results = []
        for b in range(B):
            toks = out[b, :produced].tolist()
            if eos is not None and eos in toks:
                toks = toks[:toks.index(eos) + 1]
            results.append(toks)
        return results, prefill_s, decode_s, produced, n_chunks

    def _sample(self, logits: torch.Tensor, step: int) -> torch.Tensor:
        """The wave's next tokens (B, 1) from its last logits: greedy, or
        with ``temperature`` the Gumbel-max draw of every row from one
        generator seeded by the key (seed, step), the port's counterpart
        of the reference's ``fold_in(PRNGKey(seed), step)`` over the whole
        wave (``_token_seed``; the noise made on the CPU in f64 and
        rounded once to f32, as in ``_noise``)."""
        lg = logits[:, -1, :self.model.cfg.vocab_size].float()
        if self.cfg.temperature > 0:
            gen = torch.Generator()
            gen.manual_seed(_token_seed((self.cfg.seed, step)))
            u = torch.rand(lg.shape, generator=gen, dtype=torch.float64)
            noise = -self.cfg.temperature * torch.log(-torch.log(u))
            lg = lg + noise.float().to(lg.device)
        return lg.argmax(-1, keepdim=True)

    # ------------------------------------------------------------------
    # continuous-batching runtime
    # ------------------------------------------------------------------
    def _greedy_grid(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy over a (B, C, V) dispatch grid -> (B, C) tokens (C == 1
        is the single-token step)."""
        return logits[..., :self.model.cfg.vocab_size].float().argmax(-1)

    # Temperature sampling.  Token ``i`` of request ``rid`` is drawn by the
    # Gumbel-max trick, argmax(logits + temperature * g), with standard
    # Gumbel noise g from a CPU ``torch.Generator`` seeded by the key
    # ``_base_key(rid) + (i,)`` (``_token_seed``), the port's counterpart
    # of the reference's ``fold_in(fold_in(PRNGKey(seed), rid), i)``.  The
    # noise is made on the CPU in f64 and rounded once to f32, and the
    # only arithmetic on the logits' device is one f32 add and an argmax,
    # so a sampled token depends on the logits and the key alone, on
    # either device: never on the schedule, the slot, a preemption,
    # sharing or the draft length, and never on global RNG state.  Torch
    # cannot reproduce ``jax.random``'s bits, so the tokens are not the
    # reference's.
    def _base_key(self, rid: int) -> Tuple[int, int]:
        """Per-request key root: (seed, request id)."""
        return (self.cfg.seed, rid)

    def _noise(self, keys: Sequence[Optional[Tuple[int, ...]]]
               ) -> torch.Tensor:
        """``temperature`` times Gumbel noise, one f32 row of the true
        vocabulary a key (zeros for a None key: an idle row), on the
        CPU."""
        V = self.model.cfg.vocab_size
        noise = torch.zeros((len(keys), V))
        gen = torch.Generator()
        for i, key in enumerate(keys):
            if key is not None:
                gen.manual_seed(_token_seed(key))
                u = torch.rand(V, generator=gen, dtype=torch.float64)
                noise[i] = -self.cfg.temperature * torch.log(-torch.log(u))
        return noise

    def _categorical_grid(self, logits: torch.Tensor,
                          base_keys: Sequence[Optional[Tuple[int, int]]],
                          produced: Sequence[int]) -> torch.Tensor:
        """Temperature sampling over a (B, C, V) dispatch grid: column i
        of slot b keys on ``base_keys[b] + (produced[b] + i,)``, the key
        single-token decode would use i steps later, which makes draft
        acceptance token-exact."""
        B, C = logits.shape[:2]
        lg = logits[..., :self.model.cfg.vocab_size].float()
        keys = [None if k is None else k + (p + i,)
                for k, p in zip(base_keys, produced) for i in range(C)]
        noise = self._noise(keys).to(lg.device).reshape(B, C, -1)
        return (lg + noise).argmax(-1)

    def _sample_slot(self, logits: torch.Tensor, rid: int,
                     produced: int) -> int:
        """ONE request's next token from (1, S, V) logits, keyed on
        (rid, produced) like the batched path."""
        if self.cfg.temperature <= 0:
            return int(self._greedy_grid(logits[:, -1:])[0, 0])
        return int(self._categorical_grid(
            logits[:, -1:], [self._base_key(rid)], [produced])[0, 0])

    def _copy_group_blocks(self, cache, src: int, dst: int) -> None:
        """Device copy of one physical pool group (the CoW split): pool
        row ``src`` into ``dst`` in every layer's K and V, in place.  The
        pools keep their storage: the paged kernel caches TMA tensor maps
        keyed on each pool's address."""
        for layer in cache["blocks"]:
            for pool in layer.values():
                pool[dst].copy_(pool[src])

    @staticmethod
    def _ngram_draft(history: List[int], k: int, max_n: int = 3,
                     window: int = 0) -> List[int]:
        """Self-drafted continuation: the most recent earlier occurrence of
        the longest (<= max_n) suffix of ``history`` and the <= k tokens
        that followed it.  A wrong draft costs verify columns, never
        tokens.  ``window`` bounds the lookback (0: unbounded)."""
        if window and len(history) > window:
            history = history[-window:]
        L = len(history)
        if k <= 0 or L < 2:
            return []
        for n in range(min(max_n, L - 1), 0, -1):
            suffix = history[L - n:]
            for s in range(L - n - 1, -1, -1):
                if history[s:s + n] == suffix:
                    return history[s + n:s + n + k]
        return []

    def _init_continuous_cache(self):
        """Slot KV state: the paged pools, or dense per-slot buffers (their
        lengths are per-slot host state, so the scalar index goes)."""
        if self._paged:
            return self.model.init_paged_cache(self.pool_groups,
                                               self.group_tokens)
        cache = self.model.init_cache(self.cfg.batch_slots, self.cfg.max_seq)
        del cache["index"]
        return cache

    def _generate_continuous(self, prompts, max_new: List[int]
                             ) -> GenerationResult:
        cfg = self.cfg
        dev = self.device
        B = cfg.batch_slots
        reqs = [Request(i, list(p), max_new[i])
                for i, p in enumerate(prompts)]
        sched = SlotScheduler(cfg.schedule, B, page_policy=cfg.page_policy)
        sched.submit(reqs)
        alloc = prefix = page_tables = None
        if self._paged:
            # the allocator mirrors the device pool exactly
            alloc = PageAllocator(self.pool_groups * self.group_pages,
                                  PAGE_TOKENS, self.group_pages)
            page_tables = np.zeros((B, self.max_groups), np.int32)
            # with retuning the registry is kept warm even while sharing
            # is off, so a mid-run swap to share_prefix has resident
            # prompts to match (matching is gated on the live
            # cfg.share_prefix)
            if cfg.share_prefix or cfg.retune:
                prefix = PrefixIndex(alloc)
        # on_demand reservations need the decode extend path until they
        # drain, also after a retune swaps the policy back to reserve: the
        # latch only ever sets.  Dense buffers have no allocator: the
        # page policy is inert there
        ever_on_demand = alloc is not None and sched.on_demand
        cache = self._init_continuous_cache()
        # admission cap (the retuner's max_batch knob): only slots below
        # it admit, so the dispatch shapes never change
        slot_cap = min(cfg.slot_cap or B, B)
        window = retuner = None
        retunes: List[Dict[str, Any]] = []
        seen_rids: set = set()
        if cfg.retune:
            from .workload import WorkloadWindow

            window = WorkloadWindow(capacity=cfg.retune_window)
            retuner = self._make_retuner()
        self.last_retuner = retuner

        # host-side slot state
        slot_req: List[Optional[Request]] = [None] * B
        slot_chunks: List[List[np.ndarray]] = [[] for _ in range(B)]
        slot_out: List[List[int]] = [[] for _ in range(B)]
        lengths = np.zeros(B, np.int64)
        next_tok = np.zeros(B, np.int64)

        results: List[Optional[List[int]]] = [None] * len(prompts)
        per_request: List[Optional[Dict[str, Any]]] = [None] * len(prompts)
        first_tok_t: Dict[int, float] = {}  # rid -> first-ever-token time
        shared_by_rid: Dict[int, int] = {}  # rid -> shared-admitted tokens
        prefill_s = decode_s = 0.0
        steps = chunks_issued = preemptions = 0
        shared_total = cow_splits = drafted = accepted = 0
        t0 = time.time()

        def run_chunk(b: int) -> None:
            nonlocal cache, prefill_s, chunks_issued
            piece_tokens = slot_chunks[b].pop(0)
            piece = {"tokens": torch.as_tensor(piece_tokens, device=dev)}
            r = slot_req[b]
            t = time.time()
            if self._paged:
                logits, cache = self.model.prefill_chunk_slot_paged(
                    self.params, piece, cache,
                    torch.as_tensor(page_tables[b], device=dev),
                    int(lengths[b]))
            else:
                logits, cache = self.model.prefill_chunk_slot(
                    self.params, piece, cache, b, int(lengths[b]))
            lengths[b] += piece_tokens.shape[1]
            chunks_issued += 1
            if not slot_chunks[b]:  # prefill done: sample the next token
                # publish this prompt's full-chunk groups for sharers
                if prefix is not None:
                    prefix.register(list(r.prompt),
                                    [int(g) for g in page_tables[b]])
                # token index = tokens carried from before a preemption
                # (0 for fresh requests): the (rid, index) key continues
                tok = self._sample_slot(logits, r.rid, len(slot_out[b]))
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
            if alloc is not None:
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
                "preemptions": r.preemptions,
                "shared_tokens": shared_by_rid.get(r.rid, 0),
            }
            if alloc is not None:
                alloc.release(r.rid)
            clear_slot(b)

        def preempt_slot(b: int) -> None:
            """Recompute preemption: keep the victim's generated tokens in
            its request, release its groups and re-queue it at the head;
            readmission re-prefills prompt + generated and continues at
            the same (rid, token-index) keys."""
            nonlocal preemptions
            r = slot_req[b]
            r.generated = list(slot_out[b])
            r.preemptions += 1
            preemptions += 1
            alloc.release(r.rid)
            clear_slot(b)
            sched.resubmit(r)

        def admit_tokens(r: Request) -> int:
            """The admission reservation: worst-case prompt + max_new
            under ``reserve``, the prefill footprint under ``on_demand``
            (paged layout only)."""
            if alloc is not None and sched.on_demand:
                return r.resident_tokens
            return r.total_tokens

        def shared_match(r: Request):
            """``(gids, covered, cow)`` the registry offers ``r``: live
            groups whose registered chunks cover a prefix of its prompt
            (+ carried tokens), capped one token short of the whole so at
            least one token runs through prefill (its logits seed
            sampling); ``cow`` when the first write lands inside the last
            shared group, which must then be split.  Gated on the live
            ``cfg.share_prefix`` (a retune knob): with sharing off the
            registry still registers but never matches."""
            if prefix is None or not cfg.share_prefix:
                return [], 0, False
            toks = list(r.prompt) + list(r.generated)
            gids, covered = prefix.match(toks)
            covered = min(covered, len(toks) - 1)
            keep = -(-covered // self.group_tokens)
            return gids[:keep], covered, bool(covered % self.group_tokens)

        def try_admit(r: Request):
            """Secure ``r``'s reservation: refs on matched shared groups,
            private groups for the rest, and a CoW split (allocator swap +
            device group copy) of the boundary group the suffix writes
            into.  Returns ``(groups, covered)`` or None when the pool
            cannot host ``r`` yet."""
            nonlocal cow_splits
            gids, covered, cow = shared_match(r)
            if not gids:
                groups = alloc.try_alloc(r.rid, admit_tokens(r))
                return None if groups is None else (groups, 0)
            alloc.share(r.rid, gids)
            if alloc.extend(r.rid, admit_tokens(r)) is None:
                alloc.release(r.rid)  # undo: the shared refs must not leak
                return None
            if cow:
                new = alloc.cow_split(r.rid, len(gids) - 1)
                if new is None:
                    alloc.release(r.rid)
                    return None
                # the split group's resident tokens must read the same
                # through the new mapping: copy the physical bytes
                self._copy_group_blocks(cache, gids[-1], new)
                cow_splits += 1
            return alloc.owned_groups(r.rid), covered

        def fits_shared(r: Request) -> bool:
            """``try_admit``'s free-space arithmetic exactly (the sjf
            bypass scan must never disagree with admission)."""
            gids, covered, cow = shared_match(r)
            need = (alloc.groups_for(admit_tokens(r)) - len(gids)
                    + (1 if cow else 0))
            return need <= alloc.free_groups

        def next_admission():
            """(request, groups, covered) for the next admissible request,
            else None: head first in policy order; under ``sjf`` a bounded
            bypass admits the first fitting pending request when the
            head's reservation does not fit; fifo and interleave stay
            strictly in order.  Dense buffers hold every slot's worst
            case: the head is always admissible."""
            head = sched.peek()
            if alloc is None:
                return sched.pop(), None, 0
            got = try_admit(head)
            if got is not None:
                sched.pop()
                return head, got[0], got[1]
            if cfg.schedule != "sjf":
                return None
            cand = sched.pop_first_fit(fits_shared)
            if cand is None:
                return None
            got = try_admit(cand)
            if got is None:  # admitting with a stale table corrupts KV
                raise RuntimeError("pop_first_fit and try_admit disagree")
            return cand, got[0], got[1]

        def extend_slot(b: int, want: Optional[int] = None) -> None:
            """Grow slot ``b``'s reservation to cover the next decode write
            (``want`` tokens under speculation: every column that could be
            accepted must land in reserved groups, not scratch); on pool
            exhaustion preempt the cheapest-recompute victim (resident
            tokens minus the shared-prefix tokens other owners keep
            alive, ties youngest) and retry.  ``b`` itself may be the
            victim; the caller drops it from the dispatch."""
            r = slot_req[b]
            target = int(lengths[b]) + 1 if want is None else want
            while True:
                new = alloc.extend(r.rid, target)
                if new is not None:
                    if new:
                        grown = alloc.owned_groups(r.rid)
                        page_tables[b, :len(grown)] = grown
                    return
                occupied = [bb for bb in range(B)
                            if slot_req[bb] is not None]
                by_rid = {slot_req[bb].rid: bb for bb in occupied}

                def recompute_cost(rr: Request) -> int:
                    return max(0, int(lengths[by_rid[rr.rid]])
                               - alloc.shared_prefix_tokens(rr.rid))

                victim = SlotScheduler.select_victim(
                    [slot_req[bb] for bb in occupied], cost=recompute_cost)
                vb = by_rid[victim.rid]
                preempt_slot(vb)
                if vb == b:
                    return

        def dispatch(feed: np.ndarray, active: List[int]) -> np.ndarray:
            """One batched decode dispatch of ``feed`` (B, C) -> sampled
            tokens (B, C) on the host: on the paged layout C == 1 runs
            the paged decode kernel, C > 1 the verify attention; dense
            buffers attend densely."""
            nonlocal cache, decode_s, steps
            t = time.time()
            logits, cache = self.model.decode_step_multi(
                self.params, torch.as_tensor(feed, device=dev), cache,
                torch.as_tensor(lengths, dtype=torch.int32, device=dev),
                None if page_tables is None
                else torch.as_tensor(page_tables, device=dev))
            if cfg.temperature <= 0:
                toks = self._greedy_grid(logits)
            else:
                toks = self._categorical_grid(
                    logits,
                    [self._base_key(slot_req[b].rid) if b in active
                     else None for b in range(B)],
                    [len(slot_out[b]) for b in range(B)])
            toks = toks.cpu().numpy()
            decode_s += time.time() - t
            steps += 1
            return toks

        def apply_knobs(knob_cfg: Dict[str, Any]) -> Dict[str, Any]:
            """Swap a retuned winner into the running loop at this step
            boundary: no drain, and no change of the dispatch shapes
            (``max_batch`` caps admission; the slot count is fixed).  No
            greedy token can change: every knob here is token-invariant.
            Updates ``self.cfg`` in place, as the reference does.  On
            dense buffers the paged-only knobs (page_policy,
            share_prefix) stay as they are, inert.  Returns {knob: (old,
            new)} for the knobs that moved."""
            nonlocal slot_cap, ever_on_demand
            applied: Dict[str, Any] = {}
            new_cap = min(int(knob_cfg["max_batch"]), B)
            if new_cap != slot_cap:
                applied["max_batch"] = (slot_cap, new_cap)
                slot_cap = new_cap
            new_sched = str(knob_cfg["schedule"])
            if new_sched != cfg.schedule:
                applied["schedule"] = (cfg.schedule, new_sched)
                sched.set_policy(new_sched)  # re-sorts pending
                cfg.schedule = new_sched
            new_pp = str(knob_cfg.get("page_policy", cfg.page_policy))
            if alloc is not None and new_pp != cfg.page_policy:
                applied["page_policy"] = (cfg.page_policy, new_pp)
                sched.set_page_policy(new_pp)
                cfg.page_policy = new_pp
                if new_pp == "on_demand":
                    ever_on_demand = True
            new_chunk = int(knob_cfg["prefill_chunk"])
            if new_chunk != cfg.prefill_chunk:
                applied["prefill_chunk"] = (cfg.prefill_chunk, new_chunk)
                cfg.prefill_chunk = new_chunk
            new_draft = int(knob_cfg.get("draft_len", cfg.draft_len))
            if new_draft != cfg.draft_len:
                applied["draft_len"] = (cfg.draft_len, new_draft)
                cfg.draft_len = new_draft
            new_share = bool(int(knob_cfg.get(
                "share_prefix", int(cfg.share_prefix))))
            if alloc is not None and new_share != cfg.share_prefix:
                applied["share_prefix"] = (cfg.share_prefix, new_share)
                cfg.share_prefix = new_share
            return applied

        def loop() -> None:
            nonlocal shared_total, drafted, accepted
            while sched.has_pending or any(r is not None for r in slot_req):
                progressed = False
                # 1. admission into freed slots, in policy order
                for b in range(B):
                    if b >= slot_cap:
                        continue
                    if slot_req[b] is not None or not sched.has_pending:
                        continue
                    admitted = next_admission()
                    if admitted is None:
                        break  # pool full: wait for a release
                    head, groups, covered = admitted
                    if window is not None and head.rid not in seen_rids:
                        seen_rids.add(head.rid)  # re-admissions don't
                        window.record_request(steps, head.prompt,
                                              head.max_new)
                    if groups is not None:
                        page_tables[b, :] = PageAllocator.SCRATCH_GROUP
                        page_tables[b, :len(groups)] = groups
                    if covered:
                        shared_total += covered
                        shared_by_rid[head.rid] = (
                            shared_by_rid.get(head.rid, 0) + covered)
                    slot_req[b] = head
                    lengths[b] = covered
                    chunk = cfg.prefill_chunk
                    # a preempted request re-prefills its prompt plus the
                    # tokens it had generated; shared leading tokens are
                    # already resident, so only the private suffix runs
                    toks = np.asarray(
                        [(list(head.prompt)
                          + list(head.generated))[covered:]], np.int64)
                    slot_out[b] = list(head.generated)
                    slot_chunks[b] = [toks[:, s:s + chunk]
                                      for s in range(0, toks.shape[1],
                                                     chunk)]
                    progressed = True
                    if not sched.interleave_prefill:
                        while slot_chunks[b] and slot_req[b] is not None:
                            run_chunk(b)
                # 2. pending prefill chunks: one a slot a step under
                # interleave, drained back to back otherwise (reached only
                # after a retune swaps the policy away from interleave
                # mid-prefill: admission drains the other schedules)
                for b in range(B):
                    if slot_req[b] is None or not slot_chunks[b]:
                        continue
                    if sched.interleave_prefill:
                        run_chunk(b)
                    else:
                        while slot_chunks[b] and slot_req[b] is not None:
                            run_chunk(b)
                    progressed = True
                # 3. one batched decode step over every decoding slot: with
                # speculation, draft_len extra n-gram columns ride the same
                # dispatch; under on_demand, first grow reservations to
                # cover the step's writes, preempting on exhaustion
                active = [b for b in range(B)
                          if slot_req[b] is not None and not slot_chunks[b]]
                drafts: Dict[int, List[int]] = {}
                if cfg.draft_len > 0:
                    for b in active:
                        r = slot_req[b]
                        # never draft past the generation budget
                        room = r.max_new - len(slot_out[b]) - 1
                        d = self._ngram_draft(
                            _tail_history(r.prompt, slot_out[b],
                                          cfg.draft_window),
                            min(cfg.draft_len, room))
                        if d:
                            drafts[b] = d
                if ever_on_demand:
                    for b in active:
                        if slot_req[b] is None:
                            continue  # preempted as a victim this pass
                        want = None
                        if b in drafts:
                            want = min(
                                int(lengths[b]) + 1 + len(drafts[b]),
                                slot_req[b].total_tokens)
                        extend_slot(b, want)
                    active = [b for b in active
                              if slot_req[b] is not None
                              and not slot_chunks[b]]
                if active and cfg.draft_len > 0:
                    C = cfg.draft_len + 1
                    feed = np.zeros((B, C), np.int64)
                    feed[:, 0] = next_tok
                    for b, d in drafts.items():
                        if slot_req[b] is not None:
                            feed[b, 1:1 + len(d)] = d
                    toks = dispatch(feed, active)
                    progressed = True
                    for b in active:
                        d = drafts.get(b, [])
                        drafted += len(d)
                        acc_b = 0
                        # column 0 is the ordinary sampled token (always
                        # accepted); column i+1 is valid only if draft
                        # token d[i] matched the token sampled at column i
                        for i in range(C):
                            lengths[b] += 1  # the fed token is resident
                            first_tok_t.setdefault(slot_req[b].rid,
                                                   time.time())
                            tok = int(toks[b, i])
                            accept_token(b, tok)
                            if i > 0:
                                accepted += 1
                                acc_b += 1
                            if slot_req[b] is None:
                                break  # finished mid-chain
                            if i >= len(d) or tok != d[i]:
                                break
                        if window is not None and d:
                            window.record_draft(len(d), acc_b)
                elif active:
                    toks = dispatch(next_tok[:, None], active)
                    progressed = True
                    for b in active:
                        lengths[b] += 1  # the fed token is now resident
                        first_tok_t.setdefault(slot_req[b].rid, time.time())
                        tok = int(toks[b, 0])
                        if window is not None:
                            # shadow probe: would a 1-token n-gram draft
                            # have been accepted?  It measures acceptance
                            # while draft_len=0, so the retuner can turn
                            # speculation on, not only off
                            pred = self._ngram_draft(
                                _tail_history(slot_req[b].prompt,
                                              slot_out[b],
                                              cfg.draft_window), 1)
                            if pred:
                                window.record_draft(
                                    1, 1 if pred[0] == tok else 0)
                        accept_token(b, tok)
                if window is not None:
                    window.record_depth(
                        sched.queue_depth
                        + sum(1 for r in slot_req if r is not None))
                    hit = retuner.maybe_retune(window, steps)
                    if hit is not None:
                        hit["applied"] = apply_knobs(hit["config"])
                        retunes.append(hit)
                if not progressed:  # defensive: cannot happen (paging.py)
                    raise RuntimeError(
                        "continuous scheduler stalled: pending requests "
                        "but no admissible slot, chunk or decode step")

        try:
            loop()
        except BaseException:
            # no page group may outlive the generation
            if alloc is not None:
                alloc.release_all()
            raise
        finally:
            # post-run pool introspection (tests/bench), even on unwind
            self.last_alloc = alloc
            self.last_prefix = prefix

        return GenerationResult(
            [list(t) for t in results], prefill_s, decode_s, steps,
            chunks_issued, [dict(r) for r in per_request],
            preemptions=preemptions, shared_prefix_tokens=shared_total,
            cow_splits=cow_splits, drafted=drafted, accepted=accepted,
            retunes=retunes)


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)

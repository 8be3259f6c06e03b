"""Runtime request scheduling for the continuous-batching serve engine.

Own copy of ``repro.serve.scheduler``.  The ``schedule`` knob acts at
admission:

* ``fifo``       — requests enter freed decode slots in arrival order.
* ``sjf``        — shortest-job-first by prompt length (tie: arrival
                   order).
* ``interleave`` — fifo admission, but prefill is issued one
                   ``prefill_chunk`` at a time between decode steps.

The ``page_policy`` knob decides what a KV reservation means:

* ``reserve``    — admission reserves the worst-case ``prompt + max_new``
                   footprint up front.
* ``on_demand``  — admission reserves only the prompt footprint and the
                   engine grows the reservation group by group as decode
                   crosses group boundaries; when the pool runs dry the
                   engine preempts a victim (``select_victim``: the
                   cheapest recompute), releases its groups and re-queues
                   it at the head (``resubmit``) with its generated
                   tokens folded into the prompt.  Tokens stay the same
                   because sampling is keyed on ``(rid, token-index)``.

The scheduler is pure Python: it owns the pending queue and the
admission policy; slot and page state stay in the engine.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

__all__ = ["SCHEDULES", "PAGE_POLICIES", "TP_MODES", "ADMIT_SCAN",
           "Request", "SlotScheduler", "admission_order"]

SCHEDULES = ("fifo", "sjf", "interleave")
PAGE_POLICIES = ("reserve", "on_demand")
# How a flat tuned device count maps onto the engine's (data, model) mesh.
TP_MODES = ("tp", "replicas")
# bounded sjf admission-bypass window: how many pending requests past a
# non-fitting head the engine may scan for one that fits the page pool
ADMIT_SCAN = 4


@dataclass
class Request:
    """One generation request as the scheduler sees it."""

    rid: int                  # caller-side index (results keep this order)
    prompt: Sequence[int]
    max_new: int
    arrival: int = -1         # submission order; assigned on FIRST submit
    # tokens produced before a preemption (folded into the re-prefill and
    # carried so readmission continues at the right (rid, token-index))
    generated: List[int] = field(default_factory=list)
    preemptions: int = 0

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def resident_tokens(self) -> int:
        """The prefill footprint at (re)admission: the prompt plus any
        tokens generated before a preemption (the ``on_demand``
        reservation)."""
        return self.prompt_len + len(self.generated)

    @property
    def total_tokens(self) -> int:
        """Worst-case KV footprint: the ``reserve`` admission size."""
        return self.prompt_len + self.max_new


def admission_order(policy: str, requests: Sequence[Request]) -> List[Request]:
    """The order the policy would admit ``requests`` given free slots
    (``interleave`` admits fifo: it changes prefill timing, not order)."""
    if policy not in SCHEDULES:
        raise ValueError(f"unknown schedule {policy!r}; have {SCHEDULES}")
    reqs = sorted(requests, key=lambda r: r.arrival)
    if policy == "sjf":
        reqs.sort(key=lambda r: (r.prompt_len, r.arrival))
    return reqs


@dataclass
class SlotScheduler:
    """Pending queue + admission policy for a fixed set of decode slots."""

    policy: str
    slots: int
    page_policy: str = "reserve"
    _pending: List[Request] = field(default_factory=list)
    # preempted requests, re-queued ahead of everything pending
    _resubmitted: List[Request] = field(default_factory=list)
    _arrivals: int = 0

    def __post_init__(self):
        if self.policy not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.policy!r}; "
                             f"have {SCHEDULES}")
        if self.page_policy not in PAGE_POLICIES:
            raise ValueError(f"unknown page_policy {self.page_policy!r}; "
                             f"have {PAGE_POLICIES}")
        if self.slots < 1:
            raise ValueError("need at least one decode slot")

    @property
    def interleave_prefill(self) -> bool:
        """Whether prefill chunks are spread across decode steps."""
        return self.policy == "interleave"

    @property
    def on_demand(self) -> bool:
        """Whether admission reserves prompt-only footprints that the
        engine grows (and, under pressure, preempts) at decode time."""
        return self.page_policy == "on_demand"

    def set_policy(self, policy: str) -> None:
        """Swap the admission policy: the pending queue re-sorts to the
        new order; resubmitted requests keep their head-of-line place and
        ``arrival`` stamps are untouched."""
        if policy not in SCHEDULES:
            raise ValueError(f"unknown schedule {policy!r}; "
                             f"have {SCHEDULES}")
        self.policy = policy
        self._pending = admission_order(policy, self._pending)

    def set_page_policy(self, policy: str) -> None:
        """Swap the reservation policy: only new admissions change
        meaning; live reservations keep their size."""
        if policy not in PAGE_POLICIES:
            raise ValueError(f"unknown page_policy {policy!r}; "
                             f"have {PAGE_POLICIES}")
        self.page_policy = policy

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a slot (pending + preempted re-queued)."""
        return len(self._resubmitted) + len(self._pending)

    def submit(self, requests: Sequence[Request]) -> None:
        for r in requests:
            if r.arrival < 0:  # first submission only: a re-submitted
                r.arrival = self._arrivals  # request keeps its place in
                self._arrivals += 1         # the fifo/tie-break order
            self._pending.append(r)
        self._pending = admission_order(self.policy, self._pending)

    def resubmit(self, request: Request) -> None:
        """Re-queue a preempted request at the head of the line (ahead of
        everything pending, whatever the policy); ``arrival`` is kept."""
        self._resubmitted.append(request)

    @property
    def has_pending(self) -> bool:
        return bool(self._resubmitted) or bool(self._pending)

    def peek(self) -> Optional[Request]:
        """The request the policy would admit next (None when drained)."""
        if self._resubmitted:
            return self._resubmitted[0]
        return self._pending[0] if self._pending else None

    def pop(self) -> Request:
        """Admit the head request (call after its resources are secured)."""
        if self._resubmitted:
            return self._resubmitted.pop(0)
        return self._pending.pop(0)

    def pop_first_fit(self, fits: Callable[[Request], bool],
                      limit: int = ADMIT_SCAN) -> Optional[Request]:
        """Admit the first request within the next ``limit`` queue entries
        for which ``fits`` holds, removing it from the queue: the bounded
        head-of-line bypass of ``sjf`` (the engine calls it for sjf
        only)."""
        window = max(limit, 1)
        queue = (self._resubmitted[:window]
                 + self._pending[:max(0, window - len(self._resubmitted))])
        for i, r in enumerate(queue):
            if fits(r):
                if i < len(self._resubmitted):
                    return self._resubmitted.pop(i)
                return self._pending.pop(i - len(self._resubmitted))
        return None

    @staticmethod
    def select_victim(running: Sequence[Request],
                      cost: Optional[Callable[[Request], int]] = None
                      ) -> Request:
        """The preemption victim.  With ``cost`` (the engine passes the
        recompute bill: resident tokens minus the shared-prefix tokens
        that survive the preemption), the cheapest recompute, ties
        youngest-first (largest arrival, then largest rid); without it,
        the youngest."""
        if not running:
            raise ValueError("no running requests to preempt")
        if cost is None:
            return max(running, key=lambda r: (r.arrival, r.rid))
        return min(running, key=lambda r: (cost(r), -r.arrival, -r.rid))

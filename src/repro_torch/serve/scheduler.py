"""Runtime request scheduling for the continuous-batching serve engine.

Own copy of ``repro.serve.scheduler`` cut to what this slice runs: the
``fifo`` schedule (requests enter freed decode slots in arrival order)
under the ``reserve`` page policy (admission reserves the worst-case
``prompt + max_new`` footprint up front).  The constants name every
value the reference accepts, so configs validate the same way; the
``sjf``/``interleave`` schedules and the ``on_demand`` policy with
preemption are ROADMAP queue 1, item 3, and raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

__all__ = ["SCHEDULES", "PAGE_POLICIES", "TP_MODES", "Request",
           "SlotScheduler"]

SCHEDULES = ("fifo", "sjf", "interleave")
PAGE_POLICIES = ("reserve", "on_demand")
# How a flat tuned device count maps onto the engine's (data, model) mesh.
TP_MODES = ("tp", "replicas")


@dataclass
class Request:
    """One generation request as the scheduler sees it."""

    rid: int                  # caller-side index (results keep this order)
    prompt: Sequence[int]
    max_new: int
    arrival: int = -1         # submission order; assigned on submit

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def total_tokens(self) -> int:
        """Worst-case KV footprint: the ``reserve`` admission size."""
        return self.prompt_len + self.max_new


@dataclass
class SlotScheduler:
    """Pending queue + fifo admission for a fixed set of decode slots."""

    policy: str
    slots: int
    page_policy: str = "reserve"
    _pending: List[Request] = field(default_factory=list)
    _arrivals: int = 0

    def __post_init__(self):
        if self.policy not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.policy!r}; "
                             f"have {SCHEDULES}")
        if self.page_policy not in PAGE_POLICIES:
            raise ValueError(f"unknown page_policy {self.page_policy!r}; "
                             f"have {PAGE_POLICIES}")
        if self.policy != "fifo" or self.page_policy != "reserve":
            raise NotImplementedError(
                f"schedule={self.policy!r} page_policy={self.page_policy!r}"
                ": only fifo/reserve is ported (ROADMAP queue 1, item 3)")
        if self.slots < 1:
            raise ValueError("need at least one decode slot")

    def submit(self, requests: Sequence[Request]) -> None:
        for r in requests:
            if r.arrival < 0:
                r.arrival = self._arrivals
                self._arrivals += 1
            self._pending.append(r)

    @property
    def has_pending(self) -> bool:
        return bool(self._pending)

    def peek(self) -> Request:
        """The request fifo admits next (call only while has_pending)."""
        return self._pending[0]

    def pop(self) -> Request:
        """Admit the head request (call after its pages are secured)."""
        return self._pending.pop(0)

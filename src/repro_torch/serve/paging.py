"""Paged KV-cache allocator: free-list of fixed-size page groups.

Own copy of ``repro.serve.paging`` cut to what the ``reserve`` page
policy uses: whole reservations taken at admission and released at
completion.  Refcounted sharing, copy-on-write splits, on-demand growth
and the prefix registry come with the slices that port prefix sharing
and the ``on_demand`` policy (ROADMAP queue 1, item 3).

The serving engine's KV memory is a pool of ``PAGE_TOKENS``-token pages.
Requests own *groups* of ``pages_per_group`` physically-contiguous pages
(the group size is also the token tile of the paged decode kernel's
pool).  Group 0 is a reserved scratch group: idle engine slots park their
page tables on it, so masked-out decode lanes can never write into live
requests' memory.  This module is pure Python; the device-side pool
lives with the model cache.
"""
from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["PAGE_TOKENS", "OversubscriptionError", "PageAllocator",
           "min_pages_for"]

PAGE_TOKENS = 16  # KV-cache page granularity (tokens per page)


def min_pages_for(max_tokens: int, pages_per_group: int = 1) -> int:
    """Smallest page budget at which ONE ``max_tokens`` request fits a
    pool of ``pages_per_group``-page groups alongside the reserved
    scratch group."""
    groups = -(-max(int(max_tokens), 1) // (pages_per_group * PAGE_TOKENS))
    return (groups + 1) * pages_per_group


class OversubscriptionError(ValueError):
    """A single request needs more KV pages than the whole pool holds."""


class PageAllocator:
    """Free-list allocator over groups of ``pages_per_group`` pages.

    ``try_alloc`` is the admission check: it returns the group ids for a
    reservation of ``n_tokens`` tokens, or ``None`` when the pool is
    *temporarily* full (admission waits until a running request completes
    and releases its groups).  A request that could never fit, even with
    the pool empty, raises ``OversubscriptionError``.
    """

    SCRATCH_GROUP = 0

    def __init__(self, n_pages: int, page_tokens: int = PAGE_TOKENS,
                 pages_per_group: int = 1):
        if n_pages < 1 or page_tokens < 1 or pages_per_group < 1:
            raise ValueError("n_pages, page_tokens and pages_per_group "
                             "must be >= 1")
        self.n_pages = int(n_pages)
        self.page_tokens = int(page_tokens)
        self.pages_per_group = int(pages_per_group)
        self.group_tokens = self.page_tokens * self.pages_per_group
        self.n_groups = self.n_pages // self.pages_per_group
        if self.n_groups < 2:
            raise ValueError(
                f"pool of {n_pages} pages at {pages_per_group} pages/group "
                "yields no usable groups beyond the reserved scratch group")
        self._free: List[int] = list(range(self.n_groups - 1, 0, -1))
        self._owned: Dict[int, List[int]] = {}  # owner id -> group ids
        self.high_water = 0

    # ------------------------------------------------------------------
    @property
    def usable_groups(self) -> int:
        return self.n_groups - 1

    @property
    def usable_tokens(self) -> int:
        return self.usable_groups * self.group_tokens

    @property
    def groups_in_use(self) -> int:
        return self.usable_groups - len(self._free)

    def groups_for(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 1) // self.group_tokens)

    def fits(self, n_tokens: int) -> bool:
        """Would ``try_alloc(_, n_tokens)`` succeed right now?"""
        return self.groups_for(n_tokens) <= len(self._free)

    # ------------------------------------------------------------------
    def try_alloc(self, owner: int, n_tokens: int) -> Optional[List[int]]:
        """Reserve groups covering ``n_tokens`` for ``owner``.

        Returns the group ids (logical order), ``None`` if the pool is
        temporarily full, and raises ``OversubscriptionError`` when the
        request exceeds the pool's total usable capacity.
        """
        if owner in self._owned:
            raise ValueError(f"owner {owner} already holds pages")
        need = self.groups_for(n_tokens)
        if need > self.usable_groups:
            raise OversubscriptionError(
                f"request needs {n_tokens} KV tokens ({need} groups of "
                f"{self.group_tokens}) but the pool holds only "
                f"{self.usable_tokens} usable tokens "
                f"({self.usable_groups} groups) — raise kv_cache_pages")
        if not self.fits(n_tokens):
            return None
        groups = [self._free.pop() for _ in range(need)]
        self._owned[owner] = groups
        self.high_water = max(self.high_water, self.groups_in_use)
        return list(groups)

    def release(self, owner: int) -> None:
        """Return every group ``owner`` holds to the free list."""
        groups = self._owned.pop(owner, None)
        if groups is None:
            raise KeyError(f"owner {owner} holds no pages")
        self._free.extend(reversed(groups))

    def release_all(self) -> int:
        """Release every live reservation (engine unwind path: an exception
        mid-generation must not strand page groups).  Returns the number of
        owners released."""
        owners = list(self._owned)
        for owner in owners:
            self.release(owner)
        return len(owners)

    def check_balanced(self) -> None:
        """Invariant: free + owned == usable, with no id lost, duplicated
        or leaked into the scratch group."""
        owned = [g for gs in self._owned.values() for g in gs]
        all_ids = self._free + owned
        if len(all_ids) != self.usable_groups or \
                len(set(all_ids)) != len(all_ids) or \
                self.SCRATCH_GROUP in all_ids:
            raise AssertionError(
                f"page-pool imbalance: {len(self._free)} free + "
                f"{len(owned)} owned != {self.usable_groups} usable "
                "(dups or scratch leakage)")

"""Paged KV-cache allocator: free-list of fixed-size page groups.

Own copy of ``repro.serve.paging``, with the reference's arithmetic.

The serving engine's KV memory is a pool of ``PAGE_TOKENS``-token pages.
Requests own *groups* of ``pages_per_group`` physically-contiguous pages
(the group size is also the token tile of the paged decode kernel's
pool).  Group 0 is a reserved scratch group: idle engine slots park their
page tables on it, so masked-out decode lanes can never write into live
requests' memory.

Groups are refcounted: ``share`` maps another owner onto groups a
request already holds (prefix sharing), ``cow_split`` gives an owner a
private copy of one shared logical position before a divergent write
(copy-on-write), and ``release`` returns a group to the free list only
when its last owner lets go.  Each group carries a generation counter,
bumped every time it is freed, so stale references (the ``PrefixIndex``
registry) are detected instead of aliasing recycled memory.  ``extend``
grows a reservation under the ``on_demand`` page policy.

This module is pure Python; the device-side pool lives with the model
cache.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["PAGE_TOKENS", "OversubscriptionError", "PageAllocator",
           "PrefixIndex", "min_pages_for"]

PAGE_TOKENS = 16  # KV-cache page granularity (tokens per page)


def min_pages_for(max_tokens: int, pages_per_group: int = 1) -> int:
    """Smallest page budget at which ONE ``max_tokens`` request fits a
    pool of ``pages_per_group``-page groups alongside the reserved
    scratch group — the constructibility floor every paged ``ServeConfig``
    must clear (validation, knob application and the engine's group-size
    clamp all share this one formula)."""
    groups = -(-max(int(max_tokens), 1) // (pages_per_group * PAGE_TOKENS))
    return (groups + 1) * pages_per_group


class OversubscriptionError(ValueError):
    """A single request needs more KV pages than the whole pool holds."""


class PageAllocator:
    """Free-list allocator over groups of ``pages_per_group`` pages.

    ``try_alloc`` is the admission check: it returns the group ids for a
    reservation of ``n_tokens`` tokens, or ``None`` when the pool is
    *temporarily* full (the scheduler defers admission until a running
    request completes and releases its groups).  A request that could
    never fit — even with the pool empty — raises
    ``OversubscriptionError`` instead, so impossible workloads fail
    loudly rather than deadlocking admission.

    ``extend`` is the on-demand growth path (``page_policy="on_demand"``):
    admission reserves only the prompt footprint and decode grows the
    reservation group-by-group; a ``None`` from ``extend`` is the signal
    to preempt a victim (release its groups, re-queue it for recompute)
    and retry.
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
        # group 0 is scratch; partial trailing pages are unusable (the
        # pool's group layout is what the kernel tiles over)
        self.n_groups = self.n_pages // self.pages_per_group
        if self.n_groups < 2:
            raise ValueError(
                f"pool of {n_pages} pages at {pages_per_group} pages/group "
                "yields no usable groups beyond the reserved scratch group")
        self._free: List[int] = list(range(self.n_groups - 1, 0, -1))
        self._owned: Dict[int, List[int]] = {}  # owner id -> group ids
        self._refs: Dict[int, int] = {}  # group id -> owner count (live only)
        self._gen: Dict[int, int] = {}   # group id -> free cycles (staleness)
        self.high_water = 0

    # ------------------------------------------------------------------
    @property
    def usable_groups(self) -> int:
        return self.n_groups - 1

    @property
    def usable_tokens(self) -> int:
        return self.usable_groups * self.group_tokens

    @property
    def free_groups(self) -> int:
        return len(self._free)

    @property
    def groups_in_use(self) -> int:
        return self.usable_groups - len(self._free)

    def groups_for(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 1) // self.group_tokens)

    def fits(self, n_tokens: int) -> bool:
        """Would ``try_alloc(_, n_tokens)`` succeed right now?  The ONE
        free-space test (admission bypass scans use it, so they can never
        drift from the allocation path's arithmetic)."""
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
        groups = [self._take_free() for _ in range(need)]
        self._owned[owner] = groups
        self.high_water = max(self.high_water, self.groups_in_use)
        return list(groups)

    def _take_free(self) -> int:
        gid = self._free.pop()
        self._refs[gid] = 1
        return gid

    def _drop_ref(self, gid: int) -> bool:
        """Decrement ``gid``'s refcount; free (and age) it at zero.
        Returns True when the group actually went back to the free list."""
        left = self._refs[gid] - 1
        if left > 0:
            self._refs[gid] = left
            return False
        del self._refs[gid]
        self._gen[gid] = self._gen.get(gid, 0) + 1
        self._free.append(gid)
        return True

    def extend(self, owner: int, n_tokens: int) -> Optional[List[int]]:
        """Grow ``owner``'s reservation to cover ``n_tokens`` total tokens.

        The on-demand growth path: a request admitted on a prompt-sized
        reservation calls this as decode crosses group boundaries.  Returns
        the *newly added* group ids (``[]`` when the current reservation
        already covers ``n_tokens``), ``None`` when the pool is temporarily
        full (the caller preempts a victim and retries), and raises
        ``OversubscriptionError`` when ``n_tokens`` exceeds the pool's
        total usable capacity — which, like ``try_alloc``'s, can only
        happen on pools below the one-``max_seq``-request floor the engine
        config already enforces.
        """
        groups = self._owned.get(owner)
        if groups is None:
            raise KeyError(f"owner {owner} holds no pages")
        need = self.groups_for(n_tokens)
        if need > self.usable_groups:
            raise OversubscriptionError(
                f"request grew to {n_tokens} KV tokens ({need} groups of "
                f"{self.group_tokens}) but the pool holds only "
                f"{self.usable_tokens} usable tokens "
                f"({self.usable_groups} groups) — raise kv_cache_pages")
        grow = need - len(groups)
        if grow <= 0:
            return []
        if grow > len(self._free):
            return None
        new = [self._take_free() for _ in range(grow)]
        groups.extend(new)
        self.high_water = max(self.high_water, self.groups_in_use)
        return list(new)

    # ------------------------------------------------------------------
    # prefix sharing: refcounts, copy-on-write, staleness
    # ------------------------------------------------------------------
    def ref(self, gid: int) -> int:
        """Current owner count of ``gid`` (0 = free or never allocated)."""
        return self._refs.get(gid, 0)

    def generation(self, gid: int) -> int:
        """How many times ``gid`` has been freed.  A reference captured at
        generation ``g`` is stale once ``generation(gid) != g`` — the group
        has been recycled and holds someone else's KV."""
        return self._gen.get(gid, 0)

    def share(self, owner: int, gids: Sequence[int]) -> List[int]:
        """Map ``owner`` onto groups other requests already hold (prefix
        sharing): each group's refcount is incremented and the list becomes
        the leading segment of ``owner``'s reservation (grow the private
        tail with ``extend``).  Every group must be live — sharing a free
        group would alias recycled memory."""
        if owner in self._owned:
            raise ValueError(f"owner {owner} already holds pages")
        gids = list(gids)
        for g in gids:
            if g == self.SCRATCH_GROUP:
                raise ValueError("cannot share the scratch group")
            if self._refs.get(g, 0) < 1:
                raise ValueError(f"group {g} is not live; cannot share it")
        for g in gids:
            self._refs[g] += 1
        self._owned[owner] = gids
        return list(gids)

    def cow_split(self, owner: int, logical: int) -> Optional[int]:
        """Copy-on-write: give ``owner`` a private copy slot for logical
        group ``logical`` of its reservation (which must currently be
        shared, refcount >= 2).  Returns the fresh physical group id —
        the caller copies the device bytes and repoints its page table —
        or ``None`` when the pool is temporarily full (preempt + retry)."""
        groups = self._owned.get(owner)
        if groups is None:
            raise KeyError(f"owner {owner} holds no pages")
        old = groups[logical]
        if self._refs.get(old, 0) < 2:
            raise ValueError(
                f"group {old} has a single owner; nothing to split")
        if not self._free:
            return None
        new = self._take_free()
        self._refs[old] -= 1
        groups[logical] = new
        self.high_water = max(self.high_water, self.groups_in_use)
        return new

    def shared_prefix_tokens(self, owner: int) -> int:
        """Token capacity of ``owner``'s leading still-shared groups
        (refcount >= 2).  This is KV that survives the owner's preemption
        — other owners keep the groups live, so readmission re-prefills
        only the private tail; the cost-aware victim selector subtracts it
        from the recompute bill."""
        groups = self._owned.get(owner)
        if groups is None:
            raise KeyError(f"owner {owner} holds no pages")
        n = 0
        for g in groups:
            if self._refs.get(g, 0) < 2:
                break
            n += 1
        return n * self.group_tokens

    def owned_groups(self, owner: int) -> List[int]:
        """The groups ``owner`` currently holds, in logical order."""
        groups = self._owned.get(owner)
        if groups is None:
            raise KeyError(f"owner {owner} holds no pages")
        return list(groups)

    def release(self, owner: int) -> None:
        """Drop ``owner``'s claim on every group it holds.  Groups whose
        refcount hits zero return to the free list (and age a generation);
        groups still shared by other owners stay resident."""
        groups = self._owned.pop(owner, None)
        if groups is None:
            raise KeyError(f"owner {owner} holds no pages")
        for g in reversed(groups):
            self._drop_ref(g)

    def release_all(self) -> int:
        """Release every live reservation (engine unwind path: an exception
        mid-generation must not strand page groups).  Returns the number of
        owners released."""
        owners = list(self._owned)
        for owner in owners:
            self.release(owner)
        return len(owners)

    def check_balanced(self) -> None:
        """Invariant: free + *distinct* owned == usable (no id lost or
        duplicated between the lists), no scratch leakage, and every
        group's refcount equals the number of owners mapping it (never
        zero while owned, absent once free)."""
        counts: Dict[int, int] = {}
        for gs in self._owned.values():
            for g in gs:
                counts[g] = counts.get(g, 0) + 1
        all_ids = self._free + list(counts)
        if len(all_ids) != self.usable_groups or \
                len(set(all_ids)) != len(all_ids) or \
                self.SCRATCH_GROUP in all_ids:
            raise AssertionError(
                f"page-pool imbalance: {len(self._free)} free + "
                f"{len(counts)} distinct owned != {self.usable_groups} "
                "usable (dups or scratch leakage)")
        if counts != self._refs:
            raise AssertionError(
                f"refcount drift: recorded {self._refs} vs actual owner "
                f"counts {counts}")


class PrefixIndex:
    """Registry of fully-prefilled prompt chunks for prefix sharing.

    Keys are *running prefixes*: a chunk registered under prefix ``P``
    means "some live request's prompt starts with ``P + chunk`` and the
    chunk's KV sits, complete, in physical group ``gid``".  ``match``
    walks a new prompt chunk by chunk through the registry and returns
    the groups a sharer can map instead of re-prefilling; the final
    *partial* chunk may boundary-share a registered full chunk whose
    stored tokens extend it (the engine CoW-splits that group before the
    first divergent write).

    Entries are validated lazily against the allocator: a hit requires
    the group to still be live (``ref > 0``) at the generation captured
    when it was registered — a freed-and-recycled group can never be
    handed to a sharer.  Dead entries are pruned as they are seen.

    Sharing is only ever *content-checked* (token tuples compared
    exactly, not hashed), so a registry hit is a guarantee, and only
    full groups of ORIGINAL prompts are registered — generated tokens
    and partial chunks never enter the index.
    """

    def __init__(self, alloc: PageAllocator):
        self.alloc = alloc
        self.group_tokens = alloc.group_tokens
        # running-prefix tuple -> [[chunk tuple, gid, generation], ...]
        self._children: Dict[Tuple[int, ...], List[List[Any]]] = {}

    def _live(self, gid: int, gen: int) -> bool:
        return self.alloc.ref(gid) > 0 and self.alloc.generation(gid) == gen

    def _prune(self, prefix: Tuple[int, ...]) -> List[List[Any]]:
        kids = [e for e in self._children.get(prefix, [])
                if self._live(e[1], e[2])]
        if kids:
            self._children[prefix] = kids
        else:
            self._children.pop(prefix, None)
        return kids

    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """-> ``(gids, covered)``: live groups whose registered chunks
        chain-match ``tokens`` from position 0, and the matched token
        count.  A trailing partial chunk counts as covered when a
        registered full chunk extends it (boundary share: its group is
        the last of ``gids``; the caller must CoW before writing into
        it).  Group-granular by construction — a divergence mid-chunk
        shares nothing of that chunk."""
        T = self.group_tokens
        toks = list(tokens)
        gids: List[int] = []
        covered = 0
        prefix: Tuple[int, ...] = ()
        while covered + T <= len(toks):
            chunk = tuple(toks[covered:covered + T])
            hit = next((e for e in self._prune(prefix) if e[0] == chunk),
                       None)
            if hit is None:
                break
            gids.append(hit[1])
            covered += T
            prefix += chunk
        rest = tuple(toks[covered:])
        if rest and covered + len(rest) == len(toks):
            hit = next((e for e in self._prune(prefix)
                        if e[0][:len(rest)] == rest), None)
            if hit is not None:
                gids.append(hit[1])
                covered += len(rest)
        return gids, covered

    def register(self, tokens: Sequence[int], gids: Sequence[int]) -> int:
        """Publish the full-chunk groups of a freshly prefilled prompt:
        group ``k`` of ``gids`` holds chunk ``k`` of ``tokens``.  Chunks
        already covered by a live entry are skipped (first registration
        wins — its group is the one sharers already map).  Returns the
        number of new entries."""
        T = self.group_tokens
        toks = list(tokens)
        added = 0
        prefix: Tuple[int, ...] = ()
        for k in range(len(toks) // T):
            chunk = tuple(toks[k * T:(k + 1) * T])
            kids = self._prune(prefix)
            if not any(e[0] == chunk for e in kids):
                gid = int(gids[k])
                kids.append([chunk, gid, self.alloc.generation(gid)])
                self._children[prefix] = kids
                added += 1
            prefix += chunk
        return added

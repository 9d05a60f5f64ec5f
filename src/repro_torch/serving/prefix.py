"""Prefix-sharing index: a radix trie over prompt pages, by content.

The paged backend keys resident prompt pages by the *padded* token block
they hold (``page_size`` rows each): a trie node is one full page whose
path from the root spells the padded prompt head that produced it.
Admission walks the trie with the new request's padded rows — every
matched node's physical page is mapped read-only into the slot's page
table (refcount +1) and prefill starts at the first non-shared row.  At
the first divergent page the trie can still donate a *partial* block:
the longest common row prefix is copy-on-write'd into a private page so
the suffix prefill starts at the exact divergence row.

Because prompts are LEFT-padded to their bucket width (pad rows are
ordinary attended tokens — the established serving semantics), the
index keys on the padded layout: two prompts share pages exactly when
their padded heads are identical, i.e. equal-total-length prompts with
a common head (the shared-system-prompt shape), or prompts led by a
:meth:`Engine.register_prefix`-pinned head that fills its rows.

Lifecycle of a node's page:

  * **live** — ``refs > 0``: mapped by at least one running slot or
    pinned by a :class:`PrefixHandle`.  Never evicted; counted against
    the pool in admission.
  * **retained** — ``refs == 0``: the request(s) retired but the page
    stays warm for future hits.  Reclaimed LRU-first when the allocator
    runs dry (so retention never blocks admission) or when the retained
    set exceeds ``ServeConfig.prefix_cache_pages``.

Refcounts are chain-monotone: a slot always maps a root-anchored chain,
so a node's refcount is never below any descendant's — the retained set
is downward-closed and always has a leaf to evict.

The port keeps its own copy of the JAX package's numpy-only module,
with the walk the engine audit makes (:meth:`PrefixIndex.iter_nodes`)
and the handle's pin id in the engine's registry and journal.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class _Node:
    """One full prompt page: ``tokens`` (page_size,) is the padded block
    it holds, ``page`` the physical page id owning its KV rows."""

    __slots__ = ("tokens", "page", "parent", "children", "refs", "lru")

    def __init__(self, tokens: np.ndarray, page: int,
                 parent: Optional["_Node"]):
        self.tokens = tokens
        self.page = page
        self.parent = parent
        self.children: Dict[bytes, "_Node"] = {}
        self.refs = 0
        self.lru = 0

    def __repr__(self) -> str:
        return (f"_Node(page={self.page}, refs={self.refs}, "
                f"children={len(self.children)})")


class PrefixIndex:
    """Host-side radix trie over full prompt pages.

    Pure bookkeeping — no device arrays.  The backend owns when pages
    move between the free list, slot-private lists and this index; the
    index owns matching, refcounts and the retained-LRU eviction order.
    """

    def __init__(self, page_size: int, capacity: int = 0):
        self.ps = page_size
        self.capacity = capacity        # retained-page cap; 0 → unlimited
        self.children: Dict[bytes, _Node] = {}   # the root's children
        self.live_pages = 0             # nodes with refs > 0
        self.retained: Dict[_Node, None] = {}    # refs == 0, LRU order
        self._clock = 0

    # --- matching -----------------------------------------------------

    def match(self, tokens: np.ndarray, rows: int
              ) -> Tuple[List[_Node], Optional[Tuple[_Node, int]]]:
        """Walk the trie with ``rows`` padded prompt rows.

        Returns ``(nodes, partial)``: ``nodes`` is the chain of fully
        matched page blocks (root-anchored), ``partial`` the best
        divergent child at the next block — ``(node, r)`` with ``r`` the
        longest common row prefix (``1 ≤ r``) — or ``None``.  A full
        match of the next block only counts as partial when the query
        block itself is short (the prompt tail); the caller handles the
        keep-one-suffix-row cap.
        """
        ps = self.ps
        nodes: List[_Node] = []
        kids = self.children
        b = 0
        while (b + 1) * ps <= rows:
            child = kids.get(tokens[b * ps:(b + 1) * ps].tobytes())
            if child is None:
                break
            nodes.append(child)
            kids = child.children
            b += 1
        tail = tokens[b * ps:rows]          # next (possibly short) block
        best: Optional[Tuple[_Node, int]] = None
        if len(tail) and kids:
            for child in kids.values():
                n = min(len(tail), ps)
                neq = np.nonzero(child.tokens[:n] != tail[:n])[0]
                r = int(neq[0]) if len(neq) else n
                if r >= 1 and (best is None or r > best[1]):
                    best = (child, r)
        return nodes, best

    # --- insertion / refcounts ----------------------------------------

    def insert(self, parent: Optional[_Node], tokens: np.ndarray,
               page: int) -> Tuple[Optional[_Node], bool]:
        """Add one full block under ``parent`` (``None`` → root) holding
        ``page``; the caller transfers page ownership to the index and
        must :meth:`acquire` the node.  Returns ``(node, created)`` —
        ``created`` is False when an identical child already exists (the
        caller then keeps its page private)."""
        key = tokens.tobytes()
        kids = self.children if parent is None else parent.children
        if key in kids:
            return kids[key], False
        node = _Node(np.array(tokens, np.int32), page, parent)
        kids[key] = node
        return node, True

    def acquire(self, node: _Node) -> None:
        """Refcount +1 (a slot mapping the page, or a pin)."""
        if node.refs == 0:
            self.retained.pop(node, None)
            self.live_pages += 1
        node.refs += 1

    def release(self, node: _Node) -> List[int]:
        """Refcount -1; at zero the page is *retained* (warm, evictable),
        not freed.  Returns pages evicted to honor the retained cap."""
        node.refs -= 1
        assert node.refs >= 0, "prefix page released below refcount zero"
        if node.refs == 0:
            self.live_pages -= 1
            self._clock += 1
            node.lru = self._clock
            self.retained[node] = None
        freed: List[int] = []
        if self.capacity:
            while len(self.retained) > self.capacity:
                page = self.evict_one()
                if page is None:
                    break
                freed.append(page)
        return freed

    # --- eviction -----------------------------------------------------

    def evict_one(self) -> Optional[int]:
        """Drop the least-recently-retired childless retained node and
        return its page (``None`` if nothing is evictable).  Refcount
        chain-monotonicity guarantees the retained set has a childless
        node whenever it is non-empty."""
        victim: Optional[_Node] = None
        for node in self.retained:
            if not node.children and (victim is None
                                      or node.lru < victim.lru):
                victim = node
        if victim is None:
            return None
        del self.retained[victim]
        kids = (self.children if victim.parent is None
                else victim.parent.children)
        del kids[victim.tokens.tobytes()]
        victim.parent = None
        return victim.page

    def iter_nodes(self):
        """Every node in the trie, live and retained, depth-first: what
        ``Engine.audit()`` walks for page-id conservation."""
        stack = list(self.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    @property
    def retained_pages(self) -> int:
        return len(self.retained)

    @property
    def total_pages(self) -> int:
        return self.live_pages + len(self.retained)


class PrefixHandle:
    """A pinned, refcounted shared prefix (``Engine.register_prefix``).

    The handle holds one refcount on every page of the registered head,
    keeping those pages resident across slot churn and eviction —
    ``submit(prompt, prefix=handle)`` prepends the handle's tokens to
    the prompt, and admission maps the pinned pages whenever the
    prompt's padded head lines up with them (see the module docstring
    for the left-padding alignment contract).  :meth:`release` drops the
    pin (idempotent); the pages then age out of the cache normally.
    """

    def __init__(self, engine: Any, tokens: np.ndarray,
                 nodes: List[_Node]):
        self._engine = engine
        self._tokens = tokens
        self._nodes = nodes
        self._released = False
        self._pid = None            # pin id in the engine's WAL/registry

    @property
    def tokens(self) -> np.ndarray:
        """The registered token head (a copy; rows [0, len) of any
        prompt that shares it)."""
        return self._tokens.copy()

    @property
    def n_pages(self) -> int:
        return len(self._nodes)

    @property
    def released(self) -> bool:
        return self._released

    def release(self) -> None:
        """Unpin: drop this handle's refcount on every page.  The pages
        stay retained (warm) until evicted; safe to call twice."""
        if not self._released:
            self._released = True
            self._engine._release_prefix(self)

    def __repr__(self) -> str:
        state = "released" if self._released else "pinned"
        return (f"PrefixHandle(tokens={len(self._tokens)}, "
                f"pages={len(self._nodes)}, {state})")

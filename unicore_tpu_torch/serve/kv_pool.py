"""Paged KV-cache pool: host-side page accounting for the serve tier.

The device buffers (one ``[num_pages * page_size, H, Dh]`` k/v pair per
decoder layer) are allocated ONCE at engine init and updated in place by
every step — zero reallocation after warmup.  This module is a copy of
``unicore_tpu/serve/kv_pool.py`` (the port imports nothing of the JAX
package) and owns everything about the buffers that is NOT math:
which pages belong to which sequence, in what order, which are free —
and, since the multi-tenant refactor, which pages are SHARED between
sequences.  It is pure Python over ints, so the allocation invariants
are directly property-testable without a device.

Design notes (after "Ragged Paged Attention", arxiv 2604.15464, and the
vLLM paged-KV prefix-caching scheme):

- **Page 0 is reserved as the trash page.**  Steps always run at a
  fixed batch/width, so inactive batch rows and padded prompt
  positions still produce k/v writes; their ``slot_mapping`` entries
  point into page 0, which no sequence ever owns and no mask ever
  admits.  That keeps every scatter in-bounds without per-row cond.
- Page tables are append-only per sequence: token at position ``p``
  lives in the sequence's ``p // page_size``-th page at offset
  ``p % page_size``, so the flat gathered layout is position-ordered by
  construction and the causal mask is a plain position compare.
- ``alloc``/``extend``/``free`` enforce strict invariants (no
  unaccounted aliasing, no double-free, exhaustion raises
  :class:`PoolExhausted`) instead of degrading silently — the
  scheduler's eviction logic is built on top of these exceptions.

Shared-prefix dedup (multi-tenant pool):

- Pages are REFCOUNTED.  A FULL page whose tokens are a prefix of a
  registered prompt is indexed by a stable chain digest
  (blake2b over ``prev_digest || page tokens`` — never Python's salted
  ``hash()``), so a later sequence opening with the same tokens gets
  that page by table reference instead of re-prefilling it:
  ``alloc(..., tokens=...)`` matches the longest indexed chain and the
  engine skips the KV writes for the matched tokens entirely.
- **Only full, immutable pages are ever shared.**  The match is capped
  at ``len(tokens) - 1`` so at least one token (the one whose logits
  seed sampling) is always re-prefilled, and the page holding it — the
  partial/boundary tail — is always privately owned: the tail's shared
  content is recomputed into the private copy on first write
  (copy-on-write by recompute), so one sequence's decode writes can
  never mutate another's shared page.  Structurally: every write a
  sequence issues lands at a position ``>= cached_tokens``, and those
  positions map into pages past the shared run.
- A freed page whose refcount hits zero RETURNS TO THE CACHE if it is
  registered (LRU-ordered), not to the free list: a drained engine
  keeps a warm prefix cache (``is_idle`` counts cached pages as free
  capacity).  Allocation takes the free list first, then evicts cached
  pages oldest-first — deterministic, so a replayed trace makes the
  same eviction (and therefore the same hit/miss) decisions every run.
"""

import hashlib
from collections import OrderedDict


class PoolExhausted(Exception):
    """Raised when an alloc/extend needs more free pages than exist."""


def _page_digest(prev, tokens):
    """Stable chain digest of one full page of token ids: blake2b over
    the previous page's digest plus this page's tokens — process-stable
    (never the salted built-in ``hash()``), so two sequences, two runs,
    or two replicas agree on what a shared prefix is."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(b"|".join(str(int(t)).encode() for t in tokens))
    return h.digest()


class PagedKVPool:
    """Fixed-capacity refcounted page allocator with per-sequence page
    tables and an optional shared-prefix page index."""

    def __init__(self, num_pages, page_size, prefix_cache=True):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the "
                             "reserved trash page)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.prefix_cache = bool(prefix_cache)
        # LIFO free list keeps recently-freed (cache-warm) pages hot
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._tables = {}  # seq_id -> [page, ...] in position order
        self._lens = {}    # seq_id -> token count
        self._refs = {}    # page -> number of tables referencing it
        # prefix index: chain digest -> page (full prompt pages only);
        # _cached holds registered pages with refcount 0 in LRU order
        # (oldest first = next evicted)
        self._index = {}        # digest -> page
        self._page_digests = {}  # page -> digest (registered pages)
        self._cached = OrderedDict()  # page -> digest, LRU order
        self._shared_tokens = {}  # seq_id -> tokens satisfied by dedup
        # last _match_chain result, keyed by (tokens, cap) + an index
        # generation counter: admission calls can_alloc then alloc with
        # the same prompt back to back, and the blake2b chain walk is
        # the expensive part of the hot admission path
        self._match_memo = None
        self._index_gen = 0
        self.prefix_stats = {
            "lookups": 0, "hits": 0, "tokens_saved": 0,
            "pages_shared": 0, "cache_evictions": 0,
        }

    # -- capacity ------------------------------------------------------

    @property
    def num_usable_pages(self):
        return self.num_pages - 1

    @property
    def num_free_pages(self):
        """Allocatable pages: the free list plus reclaimable cached
        prefix pages (refcount 0) — cache residency never shrinks the
        pool's capacity, it only changes what a miss costs."""
        return len(self._free) + len(self._cached)

    def occupancy(self):
        """Fraction of usable pages currently allocated (cached-free
        prefix pages count as free)."""
        used = self.num_usable_pages - self.num_free_pages
        return used / self.num_usable_pages

    def pages_for(self, num_tokens):
        """Pages a sequence of ``num_tokens`` tokens occupies."""
        return -(-int(num_tokens) // self.page_size)

    def _match_chain(self, tokens, num_tokens):
        """(shared_pages, [page, ...]) — the longest indexed chain run
        over ``tokens``' full pages, capped so at least one token stays
        un-matched (the tail is always re-prefilled privately).
        Memoized across the back-to-back can_alloc/alloc pair of one
        admission (invalidated whenever the index mutates)."""
        if not self.prefix_cache or tokens is None:
            return 0, []
        cap = (int(num_tokens) - 1) // self.page_size
        key = (tuple(tokens[:cap * self.page_size]), cap)
        if (self._match_memo is not None
                and self._match_memo[0] == key
                and self._match_memo[1] == self._index_gen):
            n, pages = self._match_memo[2]
            return n, list(pages)
        pages = []
        digest = b""
        for i in range(cap):
            digest = _page_digest(
                digest, tokens[i * self.page_size:(i + 1) * self.page_size]
            )
            page = self._index.get(digest)
            if page is None:
                break
            pages.append(page)
        self._match_memo = (key, self._index_gen, (len(pages), list(pages)))
        return len(pages), pages

    def _new_page_budget(self, shared_pages):
        """Pages available for FRESH allocation alongside a matched
        chain: matched pages currently parked in the cache stop being
        reclaimable the moment they are re-referenced, so they must not
        double-count as free capacity."""
        cached_matched = sum(1 for p in shared_pages if p in self._cached)
        return len(self._free) + len(self._cached) - cached_matched

    def can_alloc(self, num_tokens, tokens=None):
        """Whether a new sequence of ``num_tokens`` tokens fits —
        with ``tokens`` the check credits shared-prefix pages the
        allocation would not actually consume."""
        need = self.pages_for(num_tokens)
        shared, shared_pages = self._match_chain(tokens, num_tokens)
        return need - shared <= self._new_page_budget(shared_pages)

    def is_idle(self):
        """True iff no sequence holds pages and every usable page is
        free or cached-reclaimable — what a drained engine's pool must
        look like (the drain report and chaos harness assert it
        alongside :meth:`check_invariants`); a warm prefix cache is
        idle by design."""
        return (not self._tables
                and self.num_free_pages == self.num_usable_pages)

    # -- page acquisition ----------------------------------------------

    def _take_page(self):
        """One free page: the free list first (LIFO), then the OLDEST
        cached prefix page — deterministic eviction, so replayed traces
        make identical hit/miss decisions."""
        if self._free:
            return self._free.pop()
        page, digest = self._cached.popitem(last=False)
        del self._index[digest]
        del self._page_digests[page]
        self._index_gen += 1
        self.prefix_stats["cache_evictions"] += 1
        return page

    def _acquire_shared(self, pages):
        """Take refcounts on matched chain pages (pulling any cached
        ones back into service)."""
        for p in pages:
            self._refs[p] = self._refs.get(p, 0) + 1
            if p in self._cached:
                del self._cached[p]

    def _release(self, page):
        """Drop one reference; a zero-ref registered page parks in the
        cache (MRU end), anything else returns to the free list."""
        self._refs[page] -= 1
        if self._refs[page] > 0:
            return
        del self._refs[page]
        if page in self._page_digests:
            self._cached[page] = self._page_digests[page]
        else:
            self._free.append(page)

    # -- alloc / extend / free -----------------------------------------

    def alloc(self, seq_id, num_tokens, tokens=None):
        """Allocate pages for a new sequence of ``num_tokens`` tokens.

        With ``tokens`` (the sequence's token ids) and the prefix cache
        on, full pages matching a registered prefix chain are SHARED by
        reference; :meth:`cached_tokens` reports how many leading
        tokens' KV already exists, so the caller can skip prefilling
        them."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        shared, shared_pages = self._match_chain(tokens, num_tokens)
        need = self.pages_for(num_tokens) - shared
        if need > self._new_page_budget(shared_pages):
            raise PoolExhausted(
                f"need {need} new pages for {num_tokens} tokens "
                f"({shared} shared), "
                f"{self._new_page_budget(shared_pages)} free"
            )
        self._acquire_shared(shared_pages)
        table = list(shared_pages)
        for _ in range(need):
            p = self._take_page()
            self._refs[p] = self._refs.get(p, 0) + 1
            table.append(p)
        self._tables[seq_id] = table
        self._lens[seq_id] = int(num_tokens)
        self._shared_tokens[seq_id] = shared * self.page_size
        if tokens is not None and self.prefix_cache:
            self.prefix_stats["lookups"] += 1
            if shared:
                self.prefix_stats["hits"] += 1
                self.prefix_stats["tokens_saved"] += shared * self.page_size
                self.prefix_stats["pages_shared"] += shared
        return list(table)

    def cached_tokens(self, seq_id):
        """How many leading tokens of this sequence's last ``alloc``
        were satisfied by shared-prefix pages (their KV already exists;
        prefill starts past them)."""
        return self._shared_tokens.get(seq_id, 0)

    def extend(self, seq_id, num_tokens=1):
        """Grow a sequence by ``num_tokens``; allocates new pages only
        when a token crosses a page boundary."""
        if seq_id not in self._tables:
            raise KeyError(f"sequence {seq_id!r} not allocated")
        new_len = self._lens[seq_id] + int(num_tokens)
        need = self.pages_for(new_len) - len(self._tables[seq_id])
        if need > self.num_free_pages:
            raise PoolExhausted(
                f"sequence {seq_id!r} needs {need} more page(s), "
                f"{self.num_free_pages} free"
            )
        for _ in range(max(need, 0)):
            p = self._take_page()
            self._refs[p] = self._refs.get(p, 0) + 1
            self._tables[seq_id].append(p)
        self._lens[seq_id] = new_len
        return list(self._tables[seq_id])

    def free(self, seq_id):
        """Drop all of a sequence's page references.  Exclusive
        unregistered pages return to the free list; registered pages
        whose last reference this was park in the prefix cache."""
        if seq_id not in self._tables:
            raise KeyError(f"sequence {seq_id!r} not allocated "
                           "(double free?)")
        pages = self._tables.pop(seq_id)
        del self._lens[seq_id]
        self._shared_tokens.pop(seq_id, None)
        for p in reversed(pages):
            self._release(p)
        return pages

    # -- prefix registration -------------------------------------------

    def register_prefix(self, seq_id, tokens):
        """Index this sequence's full pages covering ``tokens`` (the
        engine calls this once the prompt's KV is fully written) so
        later sequences sharing the prefix dedup against them.  Only
        pages whose every slot is already written (full pages strictly
        inside ``tokens``) are registered — the partial tail stays
        private.  Returns the number of newly indexed pages."""
        if not self.prefix_cache:
            return 0
        table = self._tables.get(seq_id)
        if table is None:
            raise KeyError(f"sequence {seq_id!r} not allocated")
        if len(tokens) > self._lens[seq_id]:
            raise ValueError(
                f"cannot register {len(tokens)} tokens for sequence "
                f"{seq_id!r} holding {self._lens[seq_id]}"
            )
        registered = 0
        digest = b""
        for i in range(len(tokens) // self.page_size):
            digest = _page_digest(
                digest, tokens[i * self.page_size:(i + 1) * self.page_size]
            )
            page = table[i]
            if digest in self._index:
                # a concurrent prompt already owns this chain entry; a
                # second registration would alias one digest to two
                # pages — keep the first, this page stays private
                continue
            if page in self._page_digests:
                continue  # already indexed (a shared page we matched)
            self._index[digest] = page
            self._page_digests[page] = digest
            registered += 1
        if registered:
            self._index_gen += 1
        return registered

    # -- lookups -------------------------------------------------------

    def page_table(self, seq_id):
        return list(self._tables[seq_id])

    def seq_len(self, seq_id):
        return self._lens[seq_id]

    def seq_ids(self):
        return list(self._tables)

    def slot(self, seq_id, position):
        """Flat pool slot (page * page_size + offset) of ``position``."""
        table = self._tables[seq_id]
        page_idx, offset = divmod(int(position), self.page_size)
        if page_idx >= len(table):
            raise IndexError(
                f"position {position} beyond the {len(table)} page(s) of "
                f"sequence {seq_id!r}"
            )
        return table[page_idx] * self.page_size + offset

    def check_invariants(self):
        """Internal-consistency audit (cheap; tests call it after every
        mutation): refcount property (every reference accounted, shared
        pages only within registered prefixes), free/cached/referenced
        partition, lengths vs table sizes, trash page never handed
        out."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate pages in free list"
        cached = set(self._cached)
        assert not free & cached, "page both free and cached"
        counted = {}
        for sid, table in self._tables.items():
            assert self.pages_for(self._lens[sid]) == len(table), (
                sid, self._lens[sid], table)
            shared_pages = -(-self._shared_tokens.get(sid, 0)
                             // self.page_size)
            for i, p in enumerate(table):
                assert p not in free and p not in cached, (
                    f"page {p} referenced by {sid!r} but free/cached")
                counted[p] = counted.get(p, 0) + 1
                if counted[p] > 1 or self._refs.get(p, 0) > 1:
                    # multi-referenced pages must be registered prefix
                    # pages or this sequence's matched shared run
                    assert (p in self._page_digests
                            or i < shared_pages), (
                        f"page {p} aliased outside the prefix index")
        assert counted == self._refs, (counted, self._refs)
        for digest, page in self._index.items():
            assert self._page_digests.get(page) == digest, (
                f"index/digest maps disagree on page {page}")
            assert page in cached or page in counted, (
                f"indexed page {page} is neither cached nor referenced")
        for page, digest in self._cached.items():
            assert self._index.get(digest) == page, (
                f"cached page {page} not in the index")
        seen = free | cached | set(counted)
        assert 0 not in seen, "trash page 0 was handed out"
        assert seen == set(range(1, self.num_pages)), "pages leaked"

"""Page-aligned prefix-hash chain and the prefix-page cache's map.

Counterpart of paddle_tpu/inference/prefix.py, copied (that module is
stdlib-only, but importing it would import the JAX package).

A FULL page of prompt tokens is immutable once written (later tokens
land in later pages), so serving a repeated prefix is extra rows in a
block table plus a refcount. `PagedKVEngine` keys full prompt pages by
`chain_keys` and keeps the key -> physical-page map in a `PrefixCache`
(LRU under a page budget; the engine owns the refcounts). A prompt
router hashes inbound prompts the same way to steer repeated prefixes
to the replica that holds their pages, so the keys must equal the JAX
module's byte for byte.

The hash is a rolling CHAIN: page j's key folds page j-1's key in
(`key_j = H(key_{j-1} || tokens[j*ps:(j+1)*ps])`), so a key hit implies
the ENTIRE prefix up to and including page j matches, and a flat dict
gives longest-prefix-match semantics. blake2b (not Python's salted
`hash()`) keeps keys stable across processes.
"""
from __future__ import annotations

import collections
import hashlib

__all__ = ["chain_keys", "PrefixCache"]


def chain_keys(tokens, page_size, max_pages=None):
    """Rolling-hash chain over the FULL pages of `tokens`.

    Returns one hex key per full page (``len(tokens) // page_size``
    keys, capped at `max_pages`); the trailing partial page never gets
    a key — it is still being written to, so it can never be shared.
    ``keys[j]`` commits to every token in pages ``0..j``.
    """
    ps = int(page_size)
    if ps <= 0:
        raise ValueError(f"page_size must be > 0, got {page_size}")
    toks = [int(t) for t in tokens]
    n_full = len(toks) // ps
    if max_pages is not None:
        n_full = min(n_full, max(0, int(max_pages)))
    keys = []
    prev = b""
    for j in range(n_full):
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        page = toks[j * ps:(j + 1) * ps]
        h.update(b",".join(str(t).encode() for t in page))
        prev = h.digest()
        keys.append(prev.hex())
    return keys


class PrefixCache:
    """Bounded LRU of chain-key -> physical page id.

    A deliberately dumb map: page REFCOUNTS (who may free a page, when
    int8 scales reset) belong to the engine; the cache only decides which
    keys are remembered and which entry is coldest. One entry pins
    exactly one page, so ``len(cache)`` IS the page footprint measured
    against `page_budget`.
    """

    def __init__(self, page_budget):
        self.page_budget = int(page_budget)
        if self.page_budget <= 0:
            raise ValueError(
                f"page_budget must be > 0, got {page_budget}")
        self._entries: collections.OrderedDict[str, int] = \
            collections.OrderedDict()

    def __len__(self):
        return len(self._entries)

    def __contains__(self, key):
        return key in self._entries

    def get(self, key):
        return self._entries.get(key)

    def pages(self):
        """Snapshot of the cached page ids."""
        return list(self._entries.values())

    def match(self, keys):
        """Pages for the longest LEADING run of `keys` present (a
        mid-chain eviction truncates the run). Matched entries are
        touched (LRU)."""
        pages = []
        for k in keys:
            page = self._entries.get(k)
            if page is None:
                break
            self._entries.move_to_end(k)
            pages.append(page)
        return pages

    def leading_run(self, keys):
        """Length of the leading run of `keys` already resident, like
        `match` but read-only: no LRU touch, no pages returned."""
        n = 0
        for k in keys:
            if k not in self._entries:
                break
            n += 1
        return n

    def insert(self, key, page):
        """Remember `key` -> `page`; an existing entry wins (the first
        physical copy of a prefix stays canonical; the duplicate's pages
        retire with their slot). Returns True when inserted."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        self._entries[key] = int(page)
        return True

    def over_budget(self):
        return max(0, len(self._entries) - self.page_budget)

    def pop(self, key):
        """Targeted eviction: remove `key` and return its page, or
        None."""
        return self._entries.pop(key, None)

    def pop_lru(self):
        """Evict the coldest entry; (key, page) or None when empty."""
        if not self._entries:
            return None
        return self._entries.popitem(last=False)

    def pop_lru_where(self, pred):
        """Evict the coldest entry whose page satisfies `pred` (the
        engine passes "only the cache still holds this page", so an
        on-demand eviction always turns an entry into a FREE page).
        None when nothing qualifies."""
        for k, page in self._entries.items():
            if pred(page):
                del self._entries[k]
                return (k, page)
        return None

"""Content-addressed prefix store: admission-gated shared-context reuse
(port of ``repro/serving/prefix_cache.py``; pure Python and numpy, so the
chained digests equal the reference's byte for byte).

Multi-turn chat and agentic workloads resend a growing shared context on
every turn; re-prefilling it burns TTFT on tokens whose gated KV the
engine already computed.  This store caches the *post-admission* cache
tree (the WG-KV dual cache after the write gate filtered the prefix) at
chunk-boundary positions, keyed by a chained content hash of the token
prefix, and splices it back into a slot on the next request that shares
the prefix — the fused ragged scan then resumes at the suffix.

Design points
-------------

* **Chunk-quantised keys.**  The fused tick advances prefill in
  ``chunk_tokens`` quanta, so cache state is only capturable/resumable at
  positions ``N`` that are multiples of the scheduler chunk.  Hashes are
  chained per quantum — ``h_N = H(h_{N-Q} || tokens[N-Q:N])`` — so a
  lookup walks boundary hashes from the longest aligned prefix down and
  the store needs no trie.

* **Proper-prefix hits only.**  A hit at ``N == len(prompt)`` would leave
  no suffix token to produce last-position logits, so lookup requires
  ``N < len(prompt)`` (capture likewise targets the largest boundary
  strictly inside the prompt).

* **COW isolation.**  The stored device tree is immutable (splice copies
  it into the slot row); the host paged-pool mirror is shared by
  refcount with copy-on-write pages
  (:meth:`~repro_torch.serving.paged.PagedKVPool.share_stream`), so a
  hit never aliases mutable decode state.

* **Refcounted LRU.**  Eviction under ``budget_bytes`` is deferred for
  entries still referenced by an admitted-but-not-yet-spliced request:
  they move to a zombie list and are freed when the last ref drops.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["CachedPrefix", "PrefixCache", "chain_hashes"]


def chain_hashes(prompt: Sequence[int], quantum: int) -> List[Tuple[int, str]]:
    """Chained content hashes at every chunk boundary inside ``prompt``.

    Returns ``[(Q, h_Q), (2Q, h_2Q), ...]`` for boundaries strictly less
    than ``len(prompt)`` (a whole-prompt entry could never be resumed —
    see module docstring).  ``h_N`` commits to the entire prefix
    ``prompt[:N]`` via chaining, so equal hashes mean equal prefixes
    (modulo blake2b collisions, which we accept at 128 bits).
    """
    out: List[Tuple[int, str]] = []
    prev = b""
    for n in range(quantum, len(prompt), quantum):
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(np.asarray(prompt[n - quantum:n], np.int32).tobytes())
        digest = h.hexdigest()
        out.append((n, digest))
        prev = digest.encode()
    return out


@dataclass
class CachedPrefix:
    """One stored prefix: the post-admission batch-1 cache tree plus the
    host-side paged-mirror bookkeeping needed to adopt it into a slot."""
    key: str                      # chained content hash of prompt[:n_tokens]
    n_tokens: int                 # prefix length (chunk-aligned)
    caches: Any                   # batch-1 device cache tree (immutable)
    adm_weighted: float = 0.0     # sum of admission probs over [0, n_tokens)
    meta: Dict[Any, Dict[str, Any]] = field(default_factory=dict)
    kv_tokens: int = 0            # logical KV entries summed over streams
    # device + mirrored pool bytes, what the LRU budget counts (on a mesh,
    # summed over its model ranks)
    n_bytes: int = 0
    stream_keys: Tuple[Any, ...] = ()   # pool streams pinned by this entry
    refs: int = 0                 # admitted-but-not-spliced requests
    hits: int = 0


class PrefixCache:
    """LRU map ``hash -> CachedPrefix`` under a byte budget.

    ``quantum`` must equal the scheduler's ``chunk_tokens`` (the
    orchestrator validates this): capture happens at a collect whose row
    position is a chunk multiple, and a hit resumes the scan at exactly
    that position.

    ``free_fn`` (typically ``engine.release_prefix``) is invoked when an
    entry's storage is actually reclaimed — at eviction if unreferenced,
    else when the last in-flight reference is released.
    """

    def __init__(self, quantum: int, budget_bytes: int = 256 << 20, *,
                 free_fn: Optional[Callable[[CachedPrefix], None]] = None):
        if quantum <= 0:
            raise ValueError(f"quantum must be a positive chunk size, got "
                             f"{quantum}")
        self.quantum = int(quantum)
        self.budget_bytes = int(budget_bytes)
        self._free_fn = free_fn
        self._entries: "OrderedDict[str, CachedPrefix]" = OrderedDict()
        self._zombies: List[CachedPrefix] = []   # evicted but still ref'd
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0

    # ------------------------------------------------------------------
    @property
    def bytes_used(self) -> int:
        return self._bytes

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def counters(self) -> Dict[str, float]:
        return {"prefix_hit": float(self.hits),
                "prefix_miss": float(self.misses),
                "prefix_evict": float(self.evictions),
                "prefix_bytes": float(self._bytes)}

    # ------------------------------------------------------------------
    def lookup(self, prompt: Sequence[int]) -> Optional[CachedPrefix]:
        """Longest stored aligned proper prefix of ``prompt``, or None.

        A returned entry is pinned (``refs`` incremented) until the
        caller's :meth:`release` — the orchestrator releases once the
        hitting request has been spliced into its slot (or cancelled
        before that).
        """
        best: Optional[CachedPrefix] = None
        for _, digest in chain_hashes(prompt, self.quantum):
            e = self._entries.get(digest)
            if e is not None:
                best = e          # boundaries ascend: later hit is longer
        if best is None:
            self.misses += 1
            return None
        best.refs += 1
        best.hits += 1
        self.hits += 1
        self._entries.move_to_end(best.key)
        return best

    def capture_target(self, prompt: Sequence[int]
                       ) -> Optional[Tuple[int, str]]:
        """Longest aligned proper boundary of ``prompt`` not yet stored:
        the ``(n_tokens, key)`` a finishing request should capture at.
        Returns None when the whole useful prefix is already cached (or
        the prompt is shorter than one quantum)."""
        boundaries = chain_hashes(prompt, self.quantum)
        if not boundaries:
            return None
        n, digest = boundaries[-1]
        if digest in self._entries:
            return None
        return (n, digest)

    # ------------------------------------------------------------------
    def insert(self, entry: CachedPrefix) -> None:
        """Store a captured prefix; evicts LRU entries over budget.

        Duplicate keys (two in-flight requests racing to capture the
        same prefix) keep the existing entry — it may already be pinned
        by a hit — and free the newcomer's storage.
        """
        if entry.key in self._entries:
            self._reclaim(entry)
            return
        self._entries[entry.key] = entry
        self._bytes += entry.n_bytes
        self.inserts += 1
        self._evict_over_budget()

    def release(self, entry: CachedPrefix) -> None:
        """Drop one in-flight reference; frees zombie storage at zero."""
        if entry.refs <= 0:
            raise ValueError(f"over-released prefix entry {entry.key}")
        entry.refs -= 1
        if entry.refs == 0 and entry in self._zombies:
            self._zombies.remove(entry)
            self._reclaim(entry)

    def clear(self) -> None:
        """Drop every unreferenced entry (referenced ones zombie)."""
        for key in list(self._entries):
            self._evict(key)

    # ------------------------------------------------------------------
    def _evict_over_budget(self) -> None:
        while self._bytes > self.budget_bytes and len(self._entries) > 1:
            key = next(iter(self._entries))   # LRU head
            self._evict(key)

    def _evict(self, key: str) -> None:
        entry = self._entries.pop(key)
        self._bytes -= entry.n_bytes
        self.evictions += 1
        if entry.refs > 0:
            self._zombies.append(entry)   # storage reclaimed at release()
        else:
            self._reclaim(entry)

    def _reclaim(self, entry: CachedPrefix) -> None:
        if self._free_fn is not None:
            self._free_fn(entry)

"""Dual-cache paged memory management (port of ``repro/serving/paged.py``,
paper §4.1, Fig. 6).

A unified pool of fixed-size pages (16 tokens) shared by every (request x
layer x kv-head x region) stream, with per-stream page tables. The
allocator and the pool live on the host (numpy); :meth:`PagedKVPool.kernel_args`
hands the pool and the page tables to the ``paged_decode`` kernel as
tensors on the engine's device.

Pages are refcounted: :meth:`PagedKVPool.share_stream` aliases one
stream's pages into another (the prefix store's zero-copy hit), and a
write through either copies a shared page first (copy-on-write), so
neither sharer sees the other's writes. Copy-on-write is host-only: the
device sees the pool as it stands at the next ``kernel_args``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

PAGE_SIZE = 16


class PoolExhausted(RuntimeError):
    pass


@dataclasses.dataclass
class StreamTable:
    """Page table of one logical stream (request, layer, kv-head, region)."""

    pages: List[int] = dataclasses.field(default_factory=list)
    length: int = 0  # tokens written


class PagedKVPool:
    """Unified physical pool + free-list allocator (host numpy) with
    refcounted pages and copy-on-write."""

    def __init__(self, num_pages: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        self.num_pages = num_pages
        self.head_dim = head_dim
        self.k = np.zeros((num_pages, PAGE_SIZE, head_dim), np.float32)
        self.v = np.zeros((num_pages, PAGE_SIZE, head_dim), np.float32)
        # page 0 is reserved as the null page (masked in kernels)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self.tables: Dict[Tuple, StreamTable] = {}
        # physical-page refcounts; pages absent from the dict are free
        self._refs: Dict[int, int] = {}
        self.dtype = dtype
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)

    # ---- allocator ------------------------------------------------------
    def alloc_page(self) -> int:
        if not self._free:
            raise PoolExhausted("KV pool exhausted")
        page = self._free.pop()
        self._refs[page] = 1
        return page

    def _decref(self, page: int) -> None:
        n = self._refs.get(page, 0)
        if n <= 1:
            self._refs.pop(page, None)
            self._free.append(page)
        else:
            self._refs[page] = n - 1

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def free_stream(self, key: Tuple) -> None:
        t = self.tables.pop(key, None)
        if t:
            for p in t.pages:
                self._decref(p)

    def share_stream(self, src: Tuple, dst: Tuple) -> None:
        """Alias ``dst`` to ``src``'s pages (incref, no copy). Later
        writes through either key copy any shared page first."""
        s = self.tables[src]
        if dst in self.tables:
            raise ValueError(f"share_stream: {dst} already exists")
        for p in s.pages:
            self._refs[p] = self._refs.get(p, 0) + 1
        self.tables[dst] = StreamTable(pages=list(s.pages), length=s.length)

    def _writable_page(self, t: StreamTable, idx: int) -> int:
        """``t.pages[idx]``, copied to a fresh page first if shared."""
        page = t.pages[idx]
        if self._refs.get(page, 0) > 1:
            fresh = self.alloc_page()
            self.k[fresh] = self.k[page]
            self.v[fresh] = self.v[page]
            self._decref(page)
            t.pages[idx] = fresh
            page = fresh
        return page

    def table(self, key: Tuple) -> StreamTable:
        if key not in self.tables:
            self.tables[key] = StreamTable()
        return self.tables[key]

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def utilization(self) -> float:
        """Fraction of allocated slots actually holding tokens."""
        used = self.pages_in_use * PAGE_SIZE
        toks = sum(t.length for t in self.tables.values())
        return toks / used if used else 1.0

    # ---- writes ---------------------------------------------------------
    def append(self, key: Tuple, k_vec: np.ndarray, v_vec: np.ndarray) -> None:
        t = self.table(key)
        if t.length % PAGE_SIZE == 0:
            t.pages.append(self.alloc_page())
        page = self._writable_page(t, t.length // PAGE_SIZE)
        off = t.length % PAGE_SIZE
        self.k[page, off] = np.asarray(k_vec, np.float32)
        self.v[page, off] = np.asarray(v_vec, np.float32)
        t.length += 1

    def bulk_append(self, key: Tuple, ks: np.ndarray, vs: np.ndarray) -> None:
        for i in range(ks.shape[0]):
            self.append(key, ks[i], vs[i])

    def overwrite(self, key: Tuple, pos: int, k_vec, v_vec) -> None:
        page = self._writable_page(self.table(key), pos // PAGE_SIZE)
        off = pos % PAGE_SIZE
        self.k[page, off] = np.asarray(k_vec, np.float32)
        self.v[page, off] = np.asarray(v_vec, np.float32)

    # ---- reads ----------------------------------------------------------
    def gather(self, key: Tuple) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize a stream's tokens [len, hd] (verification/tests)."""
        t = self.table(key)
        if t.length == 0:
            return (np.zeros((0, self.head_dim), np.float32),) * 2
        pages = np.asarray(t.pages)
        k = self.k[pages].reshape(-1, self.head_dim)[: t.length]
        v = self.v[pages].reshape(-1, self.head_dim)[: t.length]
        return k, v

    def kernel_args(self, keys: List[Tuple], max_pages: Optional[int] = None
                    ) -> Tuple[torch.Tensor, ...]:
        """(k_pool, v_pool, page_table [N, max_pages] int32, lengths [N]
        int32) tensors on the pool's device for the paged_decode kernel
        over the given streams."""
        if max_pages is None:
            max_pages = max((len(self.table(k).pages) for k in keys), default=1)
        max_pages = max(max_pages, 1)
        tbl = np.zeros((len(keys), max_pages), np.int32)
        lens = np.zeros((len(keys),), np.int32)
        for i, key in enumerate(keys):
            t = self.table(key)
            tbl[i, : len(t.pages)] = t.pages
            lens[i] = t.length

        def dev(a, dt=None):
            return torch.as_tensor(a).to(device=self.device, dtype=dt,
                                         copy=True)

        return (dev(self.k, self.dtype), dev(self.v, self.dtype),
                dev(tbl), dev(lens))

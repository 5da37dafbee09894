"""Serving substrate of the port: the Equilibrium-balanced paged KV pool
(the counterpart of ``src/repro/serve/paged_kv.py``); the decode engine
is not ported yet."""

from .paged_kv import PagedKVPool, PagedKVSpec

__all__ = ["PagedKVPool", "PagedKVSpec"]

"""Serving substrate of the port: the decode engine and the
Equilibrium-balanced paged KV pool (the counterparts of
``src/repro/serve/``)."""

from .paged_kv import PagedKVPool, PagedKVSpec
from .engine import ServeEngine, Request

__all__ = ["PagedKVPool", "PagedKVSpec", "ServeEngine", "Request"]

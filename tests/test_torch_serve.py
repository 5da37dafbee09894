"""The port's serving path against the JAX package's, on the CPU: the
decode cache (``cache_spec``, ``init_cache``), ``decode_step`` step by
step, and the ``ServeEngine`` request lifecycle with its Equilibrium
page balancing; plus the serving launcher ``python -m
repro_torch.launch.serve``.  Reduced configurations in float32, the
reference's weights carried across by ``params_from_numpy``, tokens from
NumPy with a seed.

Tolerance: float32 1e-5 (``F32``) on every step's logits and every
cache leaf — the same function in another summation order.  The engines
must agree exactly in tokens, steps, step dicts and migrated bytes; for
that to be a test of the port and not of luck, every greedy choice is
made with a top-two margin above 100 times the largest logit gap seen
between the two packages, so that a flipped token would show as a near
tie first."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro.serve import PagedKVPool as RefPool
from repro.serve import PagedKVSpec as RefSpec
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.models import (ModelConfig, cache_spec, decode_step,
                                init_cache, params_from_numpy)
from repro_torch.serve import PagedKVPool, PagedKVSpec, Request, ServeEngine

F32 = dict(rtol=1e-5, atol=1e-5)
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side: keep torch's
    CPU ops on one thread each so they do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(ref_cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(ref_cfg))


def _reduced(arch: str, **overrides):
    return ref_get_config(arch).reduced(dtype="float32", **overrides)


#: reduced configurations by name: the hybrid (4 SSD layers, the shared
#: block applied twice), the SSD stack, the dense decoder with qk-norm
#: and GQA, alternating windows with softcaps (window 4, so that 12
#: steps outgrow it), and an all-sliding-window dense config whose ring
#: of 5 slots the steps wrap past
CONFIGS = {
    "zamba2": lambda: _reduced("zamba2-7b"),
    "mamba2": lambda: _reduced("mamba2-2.7b"),
    "qwen3": lambda: _reduced("qwen3-0.6b"),
    "gemma2": lambda: _reduced("gemma2-9b", n_layers=3, sliding_window=4),
    "qwen3_all_swa": lambda: _reduced("qwen3-0.6b", swa_pattern="all",
                                      sliding_window=5),
}


def _pair(ref_cfg, seed=0):
    """The reference's parameters and the port's LM holding them."""
    params = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return params, params_from_numpy(_port_cfg(ref_cfg), tree, device="cpu")


# ---------------------------------------------------------------------------
# the cache


@pytest.mark.parametrize("name", ["zamba2", "mamba2", "qwen3",
                                  "qwen3_all_swa"])
def test_cache_spec_and_init_cache_match_reference(name):
    """Leaf by leaf the reference's shape and dtype (the ring's length
    min(window, max_len)); zeros on the named device; ``len`` a host int
    where the reference keeps a () int32 leaf."""
    ref_cfg = CONFIGS[name]()
    cfg = _port_cfg(ref_cfg)
    want = ref_lm.cache_spec(ref_cfg, 3, 24)
    got = cache_spec(cfg, 3, 24)
    assert set(got) | {"len"} == set(want)
    for leaf, spec in got.items():
        assert tuple(spec.shape) == want[leaf].shape, leaf
        assert str(spec.dtype) == f"torch.{want[leaf].dtype}", leaf
        assert spec.device.type == "meta"
    ref_zero = ref_lm.init_cache(ref_cfg, 3, 24)
    cache = init_cache(cfg, 3, 24, device="cpu")
    assert cache["len"] == int(ref_zero["len"]) == 0
    assert isinstance(cache["len"], int)
    for leaf, t in ((k, v) for k, v in cache.items() if k != "len"):
        assert t.device.type == "cpu" and not t.any()
        assert tuple(t.shape) == ref_zero[leaf].shape
    if name == "qwen3_all_swa":
        assert got["k"].shape[2] == 5


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "seamless-m4t-large-v2"])
def test_unported_families_raise_for_the_cache(arch):
    cfg = _port_cfg(ref_get_config(arch).reduced())
    with pytest.raises(NotImplementedError):
        cache_spec(cfg, 2, 16)
    with pytest.raises(NotImplementedError):
        init_cache(cfg, 2, 16, device="cpu")


# ---------------------------------------------------------------------------
# decode_step


def _lockstep(ref_cfg, max_len: int, steps: int = 12, B: int = 2,
              seed: int = 0) -> None:
    """``steps`` decode steps from an empty cache in both packages on the
    same tokens: every step's logits and every cache leaf within ``F32``,
    ``len`` equal."""
    params, model = _pair(ref_cfg, seed)
    ref_step = jax.jit(lambda p, c, t: ref_lm.decode_step(p, c, t, ref_cfg))
    ref_cache = ref_lm.init_cache(ref_cfg, B, max_len)
    cache = init_cache(model.cfg, B, max_len, device="cpu")
    tokens = np.random.default_rng(seed).integers(
        0, ref_cfg.vocab_size, (steps, B, 1))
    for i in range(steps):
        want, ref_cache = ref_step(params, ref_cache,
                                   jnp.asarray(tokens[i], jnp.int32))
        got, cache = decode_step(model, cache, torch.from_numpy(tokens[i]))
        assert got.dtype == torch.float32
        assert got.shape == (B, ref_cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32,
                                   err_msg=f"logits, step {i}")
        assert cache["len"] == int(ref_cache["len"]) == i + 1
        for leaf, t in cache.items():
            if leaf != "len":
                np.testing.assert_allclose(
                    t.numpy(), np.asarray(ref_cache[leaf]), **F32,
                    err_msg=f"cache {leaf!r}, step {i}")


@pytest.mark.parametrize("name", ["zamba2", "mamba2", "qwen3", "gemma2"])
def test_decode_step_matches_reference(name):
    """12 steps within a cache of 16."""
    _lockstep(CONFIGS[name](), max_len=16)


def test_decode_step_wraps_the_ring():
    """All sliding windows: a ring of 5 slots, 12 steps, so the writes
    wrap twice and the oldest entries are overwritten."""
    _lockstep(CONFIGS["qwen3_all_swa"](), max_len=16)


@pytest.mark.parametrize("name", ["zamba2", "qwen3"])
def test_decode_step_past_max_len_matches_reference(name):
    """12 steps into a linear cache of 8: from step 9 on every write
    lands in the last slot, as the reference's clamped update puts it,
    and the query attends to all 8 slots."""
    _lockstep(CONFIGS[name](), max_len=8)


# ---------------------------------------------------------------------------
# the engine


def _recording(decode, into: list):
    """Wrap an engine's decode call to keep each call's logits."""
    def call(*args):
        out = decode(*args)
        into.append(np.asarray(out[0] if isinstance(out, tuple) else out,
                               np.float32))
        return out
    return call


def _engines_lockstep(ref_cfg, slots, max_len, spec, rebalance_every,
                      requests) -> tuple:
    """The reference's and the port's engine on one set of weights and
    requests (``(id, prompt, max_new_tokens)``), stepped side by side
    until both are idle: every step's dict equal, every decode call's
    logits within ``F32``, every greedy choice of an active slot made
    with a top-two margin above 100 times the largest gap seen; then
    every request's tokens, the steps, the migrated bytes, the pool's
    utilization and the cache's ``len`` equal.  Returns both engines."""
    params, model = _pair(ref_cfg)
    ref = RefEngine(ref_cfg, params, batch_slots=slots, max_len=max_len,
                    pool=RefPool(RefSpec(**spec)),
                    rebalance_every=rebalance_every)
    port = ServeEngine(model.cfg, model, batch_slots=slots, max_len=max_len,
                       pool=PagedKVPool(PagedKVSpec(**spec)),
                       rebalance_every=rebalance_every)
    assert port.device.type == "cpu"
    ref_reqs = [RefRequest(id=i, prompt=p, max_new_tokens=n)
                for i, p, n in requests]
    port_reqs = [Request(id=i, prompt=p, max_new_tokens=n)
                 for i, p, n in requests]
    for a, b in zip(ref_reqs, port_reqs):
        ref.submit(a)
        port.submit(b)
    ref_logits, port_logits = [], []
    ref._decode = _recording(ref._decode, ref_logits)
    port._decode = _recording(port._decode, port_logits)
    gap = 0.0
    while ref.active or ref.queue:
        # admitting first is what step() does first; it tells which
        # slots the step's greedy choice serves
        ref._admit()
        port._admit()
        rows = sorted(ref.active)
        assert sorted(port.active) == rows
        info = ref.step()
        assert port.step() == info, f"step {ref.steps}"
        assert len(port_logits) == len(ref_logits) > 0
        for want, got in zip(ref_logits, port_logits):
            np.testing.assert_allclose(got, want, **F32)
            gap = max(gap, float(np.abs(got - want).max()))
        top2 = np.sort(ref_logits[-1][rows], axis=-1)[:, -2:]
        margin = float((top2[:, 1] - top2[:, 0]).min())
        assert margin > 100 * gap, (ref.steps, margin, gap)
        ref_logits.clear()
        port_logits.clear()
        assert ref.steps < 500
    assert not (port.active or port.queue)
    assert {r.id: r.generated for r in port_reqs} \
        == {r.id: r.generated for r in ref_reqs}
    assert all(len(r.generated) == r.max_new_tokens for r in port_reqs)
    assert port.steps == ref.steps
    assert port.migrated_bytes == ref.migrated_bytes
    np.testing.assert_array_equal(port.pool.utilization(),
                                  ref.pool.utilization())
    assert port.cache["len"] == int(ref.cache["len"])
    assert port.run() == ref.run() == []
    return ref, port


def test_serve_engine_lifecycle_matches_reference():
    """The reference's own lifecycle test's setting, in float32: reduced
    qwen3 (2 layers, vocab 64), 2 slots, 3 requests of 3 prompt tokens
    and 4 new ones."""
    ref_cfg = _reduced("qwen3-0.6b", n_layers=2, vocab_size=64)
    reqs = [(i, np.array([1, 2, 3]), 4) for i in range(3)]
    ref, _ = _engines_lockstep(
        ref_cfg, 2, 64, dict(n_chips=2, page_tokens=8, pages_per_chip=64),
        64, reqs)
    assert ref.migrated_bytes == 0.0


def test_serve_engine_migrates_like_reference():
    """4 slots over a pool of 2 chips (4-token pages), 6 requests of 2 to
    8 prompt tokens and 3 to 11 new ones from a NumPy seed, a rebalance
    every 4 steps: the pool migrates, and both engines agree."""
    ref_cfg = _reduced("qwen3-0.6b", n_layers=2, vocab_size=64)
    rng = np.random.default_rng(2)
    reqs = [(i, rng.integers(1, 64, size=int(rng.integers(2, 9))),
             int(rng.integers(3, 12))) for i in range(6)]
    ref, _ = _engines_lockstep(
        ref_cfg, 4, 128, dict(n_chips=2, page_tokens=4, pages_per_chip=64),
        4, reqs)
    assert ref.migrated_bytes > 0


# ---------------------------------------------------------------------------
# the launcher


def test_launch_serve_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "4", "--new-tokens", "4"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("[serve] 4 requests × 4 tokens in ")
    assert "tok/s on CPU" in proc.stdout

"""The port stands alone: importing every module of ``repro_torch``
loads neither JAX nor the reference package ``repro``; no module of the
port, nor ``chip_smoke.py`` or the planner carries it shares with the
tests, imports either; and the default device of the batch engine, of
the LM and of the serving path is the card — each raises without one
rather than carrying on on the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print(len(names))
print(",".join(bad))
print(",".join(names))
"""


def test_importing_every_port_module_loads_no_jax_or_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines() + [""]
    assert int(lines[0]) >= 15
    assert lines[1] == "", f"port imports pulled in: {lines[1]}"
    walked = set(lines[2].split(","))
    assert {"repro_torch.kernels.flash_attention",
            "repro_torch.kernels.ssd_scan", "repro_torch.models.lm",
            "repro_torch.models.convert",
            "repro_torch.configs.zamba2_7b", "repro_torch.core.simulate",
            "repro_torch.sim.engine", "repro_torch.sim.generate",
            "repro_torch.fleet.pack", "repro_torch.fleet.planner",
            "repro_torch.fleet.service", "repro_torch.fleet.loadgen",
            "repro_torch.serve.engine", "repro_torch.launch.serve",
            "repro_torch.configs.qwen3_0_6b"} <= walked


def _imported_roots(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [REPO / "chip_smoke.py",
                            REPO / "tests" / "_select_rows_carries.py"],
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_module_imports_jax_or_repro(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_batch_default_device_is_cuda():
    """``device=None`` means the card; without one the planner raises."""
    from repro_torch.core.equilibrium_batch import BatchPlanner
    from repro_torch.core.clustergen import small_test_cluster
    from repro_torch.core.planner import create_planner
    if torch.cuda.is_available():
        planner = create_planner("equilibrium_batch")
        assert planner.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        create_planner("equilibrium_batch")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchPlanner(small_test_cluster())


def test_lm_default_device_is_cuda():
    """``device=None`` means the card for the LM's entry points; without
    one they raise."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, params_from_numpy
    cfg = get_config("zamba2-7b").reduced()
    if torch.cuda.is_available():
        assert build_model(cfg).embed.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(cfg, {})


def test_serving_default_device_is_cuda():
    """``init_cache`` with no device, and ``ServeEngine`` given the
    reference's parameter tree rather than a model, go to the card;
    without one they raise.  An engine runs where its model lies."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_cache
    from repro_torch.serve import ServeEngine
    cfg = get_config("qwen3-0.6b").reduced(n_layers=1, vocab_size=64)
    assert ServeEngine(cfg, build_model(cfg, device="cpu"),
                       batch_slots=2).device.type == "cpu"
    if torch.cuda.is_available():
        assert init_cache(cfg, 2, 16)["k"].device.type == "cuda"
        assert ServeEngine(cfg, build_model(cfg)).cache["k"].device.type \
            == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, {})


@pytest.mark.cuda
def test_batch_on_cuda_launches_k1_and_matches_faithful():
    """On the card the engine goes through the hand-written kernel and
    emits the faithful sequence."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.clustergen import cluster_a
    from repro_torch.core.planner import create_planner
    from repro_torch.kernels import select_move
    ref = create_planner("equilibrium_faithful").plan(cluster_a())
    select_move.reset_launch_count()
    got = create_planner("equilibrium_batch").plan(cluster_a())
    assert [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in got.moves] \
        == [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in ref.moves]
    assert select_move.launch_count() >= len(got.moves)

"""The port's checkpoints and training launcher against the JAX
package's, on the CPU: ``save_checkpoint`` writes the reference's
manifest and chunk files byte for byte from the same NumPy tree, each
package restores the other's, a lost storage host is survived while a
replica lives, a failed write never commits, and ``python -m
repro_torch.launch.train --device cpu`` trains, saves, resumes from the
latest manifest with the loader's cursor and keeps the reference's
quirk at a resume past ``--steps``."""

import dataclasses
import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.launch import train as ref_launch_train
from repro.train import train_step as ref_train_step
from repro_torch.checkpoint import (StorageHost, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint import checkpoint as port_ckpt
from repro_torch.launch import train as launch_train
from repro_torch.models import ModelConfig, params_from_numpy
from repro_torch.train import init_train_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed: int = 0) -> dict:
    """Nested dicts inserted out of key order, leaves of several dtypes
    and ranks: a 410 KB leaf that chunks along axis 0, scalars, int32."""
    rng = np.random.default_rng(seed)
    return {"step": np.asarray(7, np.int32),
            "params": {"z": rng.standard_normal((50, 64, 32)).astype(
                           np.float32),
                       "layers": {"w": rng.standard_normal((3, 16, 8))
                                  .astype(np.float32),
                                  "ln": rng.standard_normal((3, 16))
                                  .astype(np.float32)},
                       "a": rng.standard_normal(16).astype(np.float32)},
            "opt": {"count": np.asarray(7, np.int32),
                    "mu": {"idx": rng.integers(0, 9, (40,), np.int64)}}}


HOSTS = [StorageHost("h0", 4e6, "r0"), StorageHost("h1", 2e6, "r1"),
         StorageHost("h2", 3e6, "r2")]


def _files(root) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _assert_trees_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("hosts,replicas", [(None, 1), (HOSTS, 2)],
                         ids=["one_host", "three_racks_two_replicas"])
def test_save_checkpoint_writes_the_references_files(tmp_path, hosts,
                                                     replicas):
    """The same tree through both packages' ``save_checkpoint`` (chunks
    of 64 KB): the same ``manifest.json`` text and the same ``.npy``
    files under the same hosts, byte for byte."""
    kw = dict(hosts=hosts, replicas=replicas, chunk_bytes=64 << 10,
              extra_meta={"loader": {"cursor": 12}})
    want = ref_ckpt.save_checkpoint(tmp_path / "ref", 3, _tree(), **kw)
    got = save_checkpoint(tmp_path / "port", 3, _tree(), **kw)
    assert got.name == want.name == "step_00000003"
    manifest = json.loads((got / "manifest.json").read_text())
    assert len(manifest["leaves"]["params/z"]["chunks"]) == 7
    assert list(manifest["leaves"]) == sorted(manifest["leaves"])
    assert _files(got) == _files(want)


def test_round_trip_and_restore_across_packages(tmp_path):
    """Each package restores the other's checkpoint to the tree it
    saved, dtypes and shapes included, and finds the latest step."""
    tree = _tree(1)
    save_checkpoint(tmp_path / "port", 2, _tree(0), hosts=HOSTS, replicas=2,
                    chunk_bytes=64 << 10)
    save_checkpoint(tmp_path / "port", 5, tree, hosts=HOSTS, replicas=2,
                    chunk_bytes=64 << 10)
    ref_ckpt.save_checkpoint(tmp_path / "ref", 5, tree, hosts=HOSTS,
                             replicas=2, chunk_bytes=64 << 10)
    assert latest_step(tmp_path / "port") == 5
    for root in ("port", "ref"):
        got, manifest = restore_checkpoint(tmp_path / root)
        _assert_trees_equal(got, tree)
        want, ref_manifest = ref_ckpt.restore_checkpoint(tmp_path / root)
        _assert_trees_equal(want, tree)
        assert manifest == ref_manifest
    old, _ = restore_checkpoint(tmp_path / "port", step=2)
    _assert_trees_equal(old, _tree(0))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "empty")


def test_restore_survives_a_lost_host(tmp_path):
    """Two replicas on distinct racks: any one host lost, the tree comes
    back whole; a chunk whose replicas are all lost raises."""
    tree = _tree(2)
    save_checkpoint(tmp_path, 1, tree, hosts=HOSTS, replicas=2,
                    chunk_bytes=64 << 10)
    for host in HOSTS:
        got, _ = restore_checkpoint(tmp_path, unavailable_hosts={host.name})
        _assert_trees_equal(got, tree)
    _, manifest = restore_checkpoint(tmp_path)
    assert all(len(set(h)) == 2 for h in manifest["assignment"].values())
    with pytest.raises(IOError, match="no surviving replica"):
        restore_checkpoint(tmp_path, unavailable_hosts={"h0", "h1", "h2"})


def test_a_failed_write_never_commits(tmp_path, monkeypatch):
    """A writer that dies mid-write leaves only ``step_N.tmp``: the
    latest step stays the committed one, and the next save of step N
    clears the leftover and commits."""
    save_checkpoint(tmp_path, 1, _tree(0))
    calls = []

    def dying_save(path, arr):
        calls.append(path)
        if len(calls) == 3:
            raise OSError("disk gone")
        np.save(path, arr)
    monkeypatch.setattr(port_ckpt.np, "save", dying_save)
    with pytest.raises(OSError, match="disk gone"):
        save_checkpoint(tmp_path, 2, _tree(1))
    monkeypatch.undo()
    assert (tmp_path / "step_00000002.tmp").is_dir()
    assert not (tmp_path / "step_00000002").exists()
    assert latest_step(tmp_path) == 1
    _assert_trees_equal(restore_checkpoint(tmp_path)[0], _tree(0))
    save_checkpoint(tmp_path, 2, _tree(1))
    assert not (tmp_path / "step_00000002.tmp").exists()
    _assert_trees_equal(restore_checkpoint(tmp_path)[0], _tree(1))


def test_train_state_saves_as_the_references(tmp_path):
    """A port train state holding the reference's initial parameters
    saves to the files the reference's initial train state saves to: the
    layers stacked, the moments float32, ``count`` and ``step`` int32
    scalars."""
    ref_cfg = ref_get_config("mamba2-2.7b").reduced(dtype="float32")
    cfg = ModelConfig(**dataclasses.asdict(ref_cfg))
    ref_state = jax.tree.map(np.asarray, ref_train_step.init_train_state(
        ref_cfg, jax.random.PRNGKey(0)))
    state = init_train_state(cfg, model=params_from_numpy(
        cfg, ref_state["params"], device="cpu"))
    ref_ckpt.save_checkpoint(tmp_path / "ref", 0, ref_state)
    save_checkpoint(tmp_path / "port", 0,
                    launch_train.state_to_numpy(state))
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


TRAIN = ["--device", "cpu", "--batch", "2", "--seq", "32"]


def _run(tmp_path, steps: int, capsys, **hooks):
    """The launcher in this process (reduced qwen3-0.6b on the CPU),
    saving every 2 steps under ``tmp_path``; → (per-step records, the
    printed lines)."""
    records = []

    def on_step(step, state, metrics):
        records.append({"step": step, **{k: float(v)
                                         for k, v in metrics.items()}})
    launch_train.main(TRAIN + ["--steps", str(steps), "--save-every", "2",
                               "--checkpoint-dir", str(tmp_path)],
                      on_step=on_step, **hooks)
    return records, capsys.readouterr().out.splitlines()


def test_launch_train_trains_saves_and_resumes(tmp_path, capsys):
    """4 steps in one run against 3 steps, then a restart to 4: the
    restart resumes from step 2 (the latest manifest) with the loader's
    cursor, its restored tensors equal the saved ones bitwise, and its
    steps 3 and 4 give the uninterrupted run's losses and checkpoint
    files exactly (the CPU is deterministic)."""
    whole, lines = _run(tmp_path / "whole", 4, capsys)
    assert [r["step"] for r in whole] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in whole)
    assert abs(whole[0]["loss"] - np.log(512)) < 0.5
    assert lines[0].startswith("[train] step     1 loss=")
    assert "[train] checkpoint @ step 2" in lines \
        and "[train] checkpoint @ step 4" in lines
    assert lines[-1] == (f"[train] done: 4 steps, final loss "
                         f"{whole[-1]['loss']:.4f}")

    cut, _ = _run(tmp_path / "cut", 3, capsys)
    assert [r["loss"] for r in cut] == [r["loss"] for r in whole[:3]]
    arch = tmp_path / "cut" / "qwen3-0.6b"
    assert latest_step(arch) == 2
    saved, manifest = restore_checkpoint(arch)
    assert manifest["meta"]["loader"]["cursor"] == 4

    def on_restore(state, manifest):
        got = launch_train.state_to_numpy(state)
        _assert_trees_equal(got, saved)
    resumed, lines = _run(tmp_path / "cut", 4, capsys,
                          on_restore=on_restore)
    assert lines[0] == "[train] resumed from step 2"
    assert [r["step"] for r in resumed] == [3, 4]
    assert [r["loss"] for r in resumed] == [r["loss"] for r in whole[2:]]
    assert _files(arch / "step_00000004") \
        == _files(tmp_path / "whole" / "qwen3-0.6b" / "step_00000004")


def test_resume_at_steps_keeps_the_references_quirk(tmp_path, capsys,
                                                    monkeypatch):
    """A restart whose latest checkpoint is at ``--steps`` runs no step
    and fails at the final print (``metrics`` unbound), as the
    reference's launcher does; the reference's launcher, restoring the
    port's checkpoint, fails the same way."""
    _run(tmp_path, 2, capsys)
    with pytest.raises(UnboundLocalError, match="metrics"):
        _run(tmp_path, 2, capsys)
    assert capsys.readouterr().out.splitlines()[:1] \
        == ["[train] resumed from step 2"]
    monkeypatch.setattr(sys, "argv", [
        "train", "--steps", "2", "--batch", "2", "--seq", "32",
        "--checkpoint-dir", str(tmp_path)])
    with pytest.raises(UnboundLocalError, match="metrics"):
        ref_launch_train.main()
    assert capsys.readouterr().out.splitlines()[:1] \
        == ["[train] resumed from step 2"]

"""The port's legality core: every criterion gives bitwise-equal float64
decisions when evaluated on NumPy arrays and on torch tensors (CPU here,
CUDA where a card is present), and equals the JAX package's module on
NumPy inputs — the foundation of the batch engine's bit-identity.
Inputs are made from a seed with NumPy, in the manner of
tests/test_legality_core.py."""

import ast
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro.core import legality as ref_leg
from repro.core.cluster import TiB
from repro.core.clustergen import small_test_cluster as ref_small
from repro_torch.core import legality as leg
from repro_torch.core.clustergen import small_test_cluster


def _inputs(seed=1, n=32, rows=8):
    rng = np.random.default_rng(seed)
    cap = rng.uniform(4, 16, n) * TiB
    used = cap * rng.uniform(0.2, 0.9, n)
    util = used / cap
    util[3] = util[7]                          # a tie
    size = rng.uniform(0.01, 0.4, (rows, 1)) * TiB
    counts = rng.integers(0, 40, (rows, n)).astype(np.float64)
    ideal = rng.uniform(0, 40, (rows, n))
    return {"cap": cap, "used": used, "util": util, "size": size,
            "counts": counts, "ideal": ideal,
            "us": float(util.sum()), "usq": float((util ** 2).sum()),
            "cls": rng.integers(-1, 3, (rows, 1)),
            "dev_class": rng.integers(0, 3, n),
            "dok_a": rng.random((rows, n)) < 0.5,
            "dok_b": rng.random((rows, n)) < 0.5, "n": n}


def _criteria(mod, x, asarray):
    """Every criterion of ``mod`` on the inputs ``x`` lifted by
    ``asarray`` (NumPy or torch); returns name -> result."""
    a = {k: asarray(v) if isinstance(v, np.ndarray) else v
         for k, v in x.items()}
    src = 5
    idx = asarray(np.arange(x["n"]))
    # the engine keeps the variance divisor a tensor on the device (a CUDA
    # division by a host scalar multiplies by the reciprocal instead)
    n_f = float(x["n"]) if asarray is np.asarray \
        else asarray(np.array(float(x["n"])))
    lim = mod.capacity_limit(a["cap"], 0.1)
    return {
        "class_ok": mod.class_ok(a["cls"], a["dev_class"]),
        "dst_count_ok": mod.dst_count_ok(a["counts"], a["ideal"], 0.0),
        "dst_count_ok_slack": mod.dst_count_ok(a["counts"], a["ideal"], 1.0),
        "src_count_ok": mod.src_count_ok(a["counts"], a["ideal"], 0.5),
        "capacity_limit": lim,
        "capacity_ok": mod.capacity_ok(a["used"], lim, a["size"]),
        "variance_from_moments": mod.variance_from_moments(
            a["util"] ** 2, a["util"], n_f),
        "variance_improves": mod.variance_improves(
            a["used"][src], a["used"][None, :], a["cap"][src],
            a["cap"][None, :], a["util"][src], a["util"][None, :],
            a["size"], x["us"], x["usq"], n_f, 0.0),
        "variance_improves_min": mod.variance_improves(
            a["used"][src], a["used"][None, :], a["cap"][src],
            a["cap"][None, :], a["util"][src], a["util"][None, :],
            a["size"], x["us"], x["usq"], n_f, 1e-9),
        "before_source": mod.before_source(a["util"], a["util"][src], idx,
                                           src),
        "bound_crossed": mod.bound_crossed(
            a["util"][src] + 0.05, a["util"][src] - 0.05, a["util"], src,
            idx),
        "bound_capacity_binding": mod.bound_capacity_binding(
            a["used"][:, None], lim[:, None], a["size"][:, 0][None, :]),
        "count_flip_enables": mod.count_flip_enables(a["dok_a"], a["dok_b"]),
    }


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_bitwise(got, want, name):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert got.shape == want.shape, name
    if got.dtype == np.float64:
        got, want = got.view(np.int64), want.view(np.int64)
    assert np.array_equal(got, want), name


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_numpy_and_torch_cpu_decisions_bit_identical(seed):
    x = _inputs(seed)
    want = _criteria(leg, x, np.asarray)
    got = _criteria(leg, x, torch.from_numpy)
    for name in want:
        _assert_bitwise(got[name], want[name], name)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_port_criteria_equal_the_reference_module(seed):
    x = _inputs(seed)
    want = _criteria(ref_leg, x, np.asarray)
    got = _criteria(leg, x, np.asarray)
    for name in want:
        _assert_bitwise(got[name], want[name], name)


@pytest.mark.cuda
def test_numpy_and_torch_cuda_decisions_bit_identical():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _inputs(4)
    want = _criteria(leg, x, np.asarray)
    got = _criteria(leg, x, lambda a: torch.from_numpy(a).cuda())
    for name in want:
        _assert_bitwise(got[name], want[name], name)


def test_bound_capacity_binding_python_scalars():
    """The host engines call it with Python floats: it must return a real
    bool there (not ``~True == -2``), equal to the tensor evaluation."""
    for used, lim, big in ((1.0, 2.0, 0.5), (1.0, 2.0, 1.5),
                           (3.0, 2.0, 0.0), (1.0, 2.0, 1.0)):
        got = leg.bound_capacity_binding(used, lim, big)
        assert got is (used + big > lim)
        assert got == ref_leg.bound_capacity_binding(used, lim, big)
        t = leg.bound_capacity_binding(torch.tensor(used, dtype=torch.float64),
                                       torch.tensor(lim, dtype=torch.float64),
                                       big)
        assert bool(t) is got


def test_fullest_first_and_ids_match_reference():
    rng = np.random.default_rng(5)
    util = rng.random(40)
    util[[4, 9, 17]] = util[2]
    assert np.array_equal(leg.fullest_first(util),
                          ref_leg.fullest_first(util))
    port, ref = small_test_cluster(), ref_small()
    p, r = (leg.LegalityState.from_cluster(port),
            ref_leg.LegalityState.from_cluster(ref))
    assert p.class_id == r.class_id and p.levels == r.levels
    assert p.n_domains == r.n_domains
    for f in ("dev_class", "dev_domain_arr", "dev_in", "cap"):
        assert np.array_equal(getattr(p, f), getattr(r, f))
    assert leg.LEVELS == ref_leg.LEVELS
    assert leg.rule_slot_steps(port.pools[0].rule) \
        == ref_leg.rule_slot_steps(ref.pools[0].rule)


def test_public_names_are_the_functions():
    """``_public`` binds each criterion under the reference's name."""
    for name in ("class_ok", "dst_count_ok", "src_count_ok",
                 "capacity_limit", "capacity_ok", "variance_from_moments",
                 "variance_improves", "before_source", "fullest_first",
                 "bound_crossed", "bound_capacity_binding",
                 "count_flip_enables", "device_class_ids",
                 "device_domain_ids", "LegalityState"):
        obj = getattr(leg, name)
        assert obj.__name__ == name


# ---------------------------------------------------------------------------
# the port's own guard: legality math is declared only in its core

REPO = pathlib.Path(__file__).resolve().parent.parent
#: the one port module that may define the legality vocabulary
PORT_HOME = "repro_torch/core/legality.py"
#: port modules that must import it (dropping the import would mean
#: re-derived expressions)
PORT_MUST_IMPORT = ("repro_torch/core/equilibrium.py",
                    "repro_torch/core/equilibrium_batch.py",
                    "repro_torch/core/equilibrium_dense.py",
                    "repro_torch/core/dense.py",
                    "repro_torch/kernels/ref.py")


def _legality_tool():
    """``tools/check_legality.py`` as a module (its AST walk and its
    ``LEGALITY_NAMES``)."""
    path = REPO / "tools" / "check_legality.py"
    spec = importlib.util.spec_from_file_location("check_legality", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _port_violations(tool, src: pathlib.Path) -> list[str]:
    out = []
    for path in sorted((src / "repro_torch").rglob("*.py")):
        rel = path.relative_to(src).as_posix()
        if rel != PORT_HOME:
            out += tool._check_file(path, rel)
    out += [f"{rel}: does not import the legality core"
            for rel in PORT_MUST_IMPORT
            if not tool._imports_legality(ast.parse((src / rel).read_text()))]
    return out


def test_port_declares_legality_math_only_in_its_core():
    tool = _legality_tool()
    assert _port_violations(tool, REPO / "src") == []
    assert {n for n in tool.LEGALITY_NAMES if not hasattr(leg, n)} == set()


def test_port_legality_guard_catches_a_redeclaration(tmp_path):
    """The same walk on a copy of the engine modules with one criterion
    re-declared, and with the core's import dropped, reports both."""
    tool = _legality_tool()
    src = tmp_path / "src"
    for rel in PORT_MUST_IMPORT:
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        (src / rel).write_text((REPO / "src" / rel).read_text())
    batch = src / "repro_torch/core/equilibrium_batch.py"
    batch.write_text(batch.read_text() + "\n\ndef dst_count_ok(c, i, s):\n"
                     "    return c < i\n")
    ref = src / "repro_torch/kernels/ref.py"
    ref.write_text(ref.read_text().replace("from ..core import legality",
                                           "legality = None"))
    found = _port_violations(tool, src)
    assert any("equilibrium_batch.py" in v and "dst_count_ok" in v
               for v in found), found
    assert any(v.startswith("repro_torch/kernels/ref.py: does not import")
               for v in found), found

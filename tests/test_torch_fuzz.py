"""The port's differential fuzzer (``repro_torch.fuzz``) against the JAX
package's (``repro.fuzz``), compared exactly: the corpus timelines'
lanes, the mutations' oracle failures and messages, generated timelines
of both profiles through the port's whole ``"equilibrium"`` class, the
shrinker's output and evaluation count, the corpus files, and the
``fuzz.*`` registry counters.

The batch and legacy lanes run here with ``device="cpu"`` (their
kernels' plain versions); on the card the batch lane's selection is the
``select_rows`` kernel, which no legality mutation reaches, and the
CLI's guard against that combination is tested on a device object."""

import importlib.util
import json
import pathlib

import pytest
import torch

import repro.fuzz as ref_fuzz
import repro.sim as ref_sim
from repro import obs as ref_obs
from repro_torch import fuzz, obs, sim
from repro_torch.core import legality, small_test_cluster
from repro_torch.core.equilibrium_batch import dense_rebuild_count
from repro_torch.core.planner import create_planner
from repro_torch.fuzz import __main__ as cli
from repro_torch.fuzz.harness import _ReplayPlanner

REPO = pathlib.Path(__file__).resolve().parent.parent
CORPUS = fuzz.iter_corpus()
MUTANTS = [p for p in CORPUS
           if "mutation" in json.loads(p.read_text())["provenance"]]
HOST = ("equilibrium", "equilibrium_faithful")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side: keep torch's
    CPU ops (the batch and legacy lanes' plain versions) on one thread
    each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(paths):
    return [p.stem for p in paths]


def _both(path):
    """(reference timeline, port timeline) of one corpus file."""
    return ref_fuzz.load_timeline(path), fuzz.load_timeline(path)


def _same_lane(got, want) -> None:
    assert got.moves == want.moves
    assert got.metrics_json == want.metrics_json
    assert got.planned_moves == want.planned_moves


def _reference_cli():
    """The JAX package's fuzz CLI, ``tools/fuzz.py``, as a module."""
    spec = importlib.util.spec_from_file_location(
        "_reference_fuzz_cli", REPO / "tools" / "fuzz.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the corpus


def test_corpus_is_the_reference_corpus():
    """``corpus_dir()`` resolves to the reference's ``tests/regressions``
    from the port's own file, and it holds the four timelines."""
    assert fuzz.corpus_dir() == ref_fuzz.corpus_dir() \
        == REPO / "tests" / "regressions"
    assert CORPUS == ref_fuzz.iter_corpus()
    assert len(CORPUS) >= 4 and len(MUTANTS) >= 3


@pytest.mark.parametrize("path", CORPUS, ids=_ids(CORPUS))
def test_corpus_lanes_match_reference_faithful(path):
    """Each corpus timeline through the port's harness (every oracle,
    the baselines and the replay) on the CPU: every Equilibrium lane
    equals the reference's ``equilibrium_faithful`` lane, move for move
    and byte for byte in the metrics JSON; the slack regression's file
    keeps the legacy lane, whose float32 downcast it once caught."""
    ref_tl, tl = _both(path)
    engines = HOST + ("equilibrium_batch",)
    if "legacy" in path.stem:
        engines += ("equilibrium_jax_legacy",)
    lanes = fuzz.run_timeline(tl, engines=engines, device="cpu")
    want = ref_fuzz.run_lane(ref_tl, "equilibrium_faithful")
    for engine in engines:
        _same_lane(lanes[engine], want)
    assert lanes["equilibrium_batch"].rebuilds == 1


# ---------------------------------------------------------------------------
# the mutations


@pytest.mark.parametrize("path", MUTANTS, ids=_ids(MUTANTS))
def test_mutant_caught_like_the_reference(path):
    """Each mutant file under its recorded mutation fires the recorded
    oracle with the reference's message on the host lanes; the legality
    module is healthy again after the context."""
    ref_tl, tl = _both(path)
    name, oracle = tl.provenance["mutation"], tl.provenance["oracle"]
    attr = fuzz.MUTATIONS[name][0]
    healthy = getattr(legality, attr)
    with ref_fuzz.mutated(name):
        with pytest.raises(ref_fuzz.OracleFailure) as want:
            ref_fuzz.run_timeline(ref_tl, engines=HOST, baseline_lanes=(),
                                  replay_check=False)
    with fuzz.mutated(name):
        assert getattr(legality, attr) is not healthy
        with pytest.raises(fuzz.OracleFailure) as got:
            fuzz.run_timeline(tl, engines=HOST, baseline_lanes=(),
                              replay_check=False, device="cpu")
    assert got.value.oracle == want.value.oracle == oracle
    assert str(got.value) == str(want.value)
    assert fuzz.failure_signature(got.value) == oracle
    assert getattr(legality, attr) is healthy
    _same_lane(fuzz.run_lane(tl, "equilibrium"),
               ref_fuzz.run_lane(ref_tl, "equilibrium"))


@pytest.mark.parametrize("lane", ["equilibrium_batch",
                                  "equilibrium_jax_legacy"])
@pytest.mark.parametrize("path", MUTANTS, ids=_ids(MUTANTS))
def test_mutation_reaches_the_device_lanes_on_the_cpu(path, lane):
    """On the CPU the mutation reaches the batch lane's plain selection
    (``select_rows_masks``) and the legacy lane's mask: each fails as the
    host ``equilibrium`` lane does, on the same move."""
    tl = fuzz.load_timeline(path)
    with fuzz.mutated(tl.provenance["mutation"]):
        with pytest.raises(fuzz.OracleFailure) as host:
            fuzz.run_lane(tl, "equilibrium")
        with pytest.raises(fuzz.OracleFailure) as got:
            fuzz.run_lane(tl, lane, device="cpu")
    assert got.value.oracle == host.value.oracle
    assert got.value.detail == host.value.detail.replace(
        "equilibrium:", f"{lane}:", 1)


# ---------------------------------------------------------------------------
# generated timelines through the whole class


@pytest.mark.parametrize("profile,seed", [("quick", 0), ("quick", 1),
                                          ("quick", 5), ("nightly", 2)])
def test_generated_timeline_matches_reference(profile, seed):
    """A generated timeline through the port's whole class (batch and
    legacy lanes on the CPU), the ``mgr`` and ``none`` baselines and the
    replay: every lane equals the reference's run of the same timeline
    through its host lanes."""
    tl = sim.generate_timeline(seed, profile)
    want = ref_fuzz.run_timeline(ref_sim.generate_timeline(seed, profile),
                                 engines=HOST)
    lanes = fuzz.run_timeline(tl, device="cpu")
    assert set(lanes) == {"equilibrium", "equilibrium_batch",
                          "equilibrium_faithful", "equilibrium_jax_legacy",
                          "mgr", "none"}
    for engine, lane in lanes.items():
        _same_lane(lane, want.get(engine, want["equilibrium"]))
    assert lanes["equilibrium_batch"].rebuilds <= 1


def test_fuzz_counters_match_reference():
    """The ``fuzz.*`` registry deltas of a passing run, a failing run
    under a mutation and a shrink equal the reference's."""
    def counted(pkg, registry, tl):
        snap = registry.snapshot("fuzz.")
        pkg.run_timeline(tl, engines=HOST)
        with pkg.mutated("variance_always_improves"):
            with pytest.raises(pkg.OracleFailure):
                pkg.run_timeline(tl, engines=HOST, baseline_lanes=())
        pkg.shrink_timeline(tl.to_dict(), lambda d: len(d["events"]) > 2,
                            max_evals=6)
        return registry.deltas_since(snap, "fuzz.")

    want = counted(ref_fuzz, ref_obs.registry(),
                   ref_sim.generate_timeline(0))
    got = counted(fuzz, obs.registry(), sim.generate_timeline(0))
    assert got == want
    assert got["fuzz.oracle_failures{oracle=variance}"] == 1


# ---------------------------------------------------------------------------
# the shrinker


def _shrink_case(pkg):
    d = pkg.generate_timeline(1).to_dict()   # two out/fail events

    def fails(cand):
        return any(ev["kind"] in ("DeviceOut", "DeviceFail")
                   for ev in cand["events"])
    assert fails(d)
    return d, fails


def test_shrinker_matches_reference():
    """The reference test's synthetic case: the same minimized dict and
    evaluation count, deterministic, and within the budget."""
    got, n_got = fuzz.shrink_timeline(*_shrink_case(sim))
    want, n_want = ref_fuzz.shrink_timeline(*_shrink_case(ref_sim))
    assert (got, n_got) == (want, n_want)
    assert fuzz.shrink_timeline(*_shrink_case(sim)) == (got, n_got)
    assert len(got["events"]) == 1 and got["sim"]["ticks"] == 1
    for budget in (1, 5):
        small, evals = fuzz.shrink_timeline(*_shrink_case(sim),
                                            max_evals=budget)
        assert evals <= budget
        assert (small, evals) == ref_fuzz.shrink_timeline(
            *_shrink_case(ref_sim), max_evals=budget)


def test_real_shrink_matches_reference():
    """One shrink of a generated timeline under a mutation, through each
    CLI's predicate (host lanes), with a small budget: the same
    reproducer and evaluation count as the reference's."""
    ref_cli = _reference_cli()
    d = sim.generate_timeline(0).to_dict()
    d["provenance"].update(mutation="variance_always_improves",
                           oracle="variance")
    with fuzz.mutated("variance_always_improves"):
        got = fuzz.shrink_timeline(
            d, cli.make_predicate(HOST, "variance", "cpu"), max_evals=8)
    with ref_fuzz.mutated("variance_always_improves"):
        want = ref_fuzz.shrink_timeline(
            d, ref_cli.make_predicate(HOST, "variance"), max_evals=8)
    assert got == want
    assert got[1] == 8
    assert len(got[0]["events"]) < len(d["events"])


# ---------------------------------------------------------------------------
# the corpus files


def test_corpus_round_trip(tmp_path):
    """``save_timeline`` writes the reference's bytes, ``load_timeline``
    reads them back, ``iter_corpus`` lists them in order; nothing lands
    in ``tests/regressions``."""
    before = sorted(p.name for p in CORPUS)
    d = sim.generate_timeline(3, "nightly").to_dict()
    mine, theirs = tmp_path / "port", tmp_path / "reference"
    b = fuzz.save_timeline(d, "b-seed3", mine)
    a = fuzz.save_timeline(sim.generate_timeline(4).to_dict(), "a-seed4",
                           mine)
    ref_b = ref_fuzz.save_timeline(d, "b-seed3", theirs)
    assert b.read_bytes() == ref_b.read_bytes()
    assert fuzz.load_timeline(b).to_dict() == d
    assert fuzz.iter_corpus(mine) == [a, b]
    assert fuzz.iter_corpus(tmp_path / "absent") == []
    assert fuzz.corpus_dir(mine) == mine
    assert sorted(p.name for p in fuzz.iter_corpus()) == before


# ---------------------------------------------------------------------------
# the CLI


@pytest.mark.parametrize("device", [None, "cuda", torch.device("cuda:0")],
                         ids=["default", "cuda", "cuda:0"])
def test_cli_refuses_mutating_the_card_kernel_lane(device):
    """``--mutate`` with the batch lane on a CUDA device (the default is
    the card) raises and says why; the host lanes on CUDA and the batch
    lane on the CPU pass the guard.  No card is needed."""
    with pytest.raises(ValueError, match="select_rows"):
        cli.check_mutation_lanes(HOST + ("equilibrium_batch",), device)
    cli.check_mutation_lanes(HOST + ("equilibrium_jax_legacy",), device)
    cli.check_mutation_lanes(("equilibrium_batch",), "cpu")
    with pytest.raises(ValueError, match="select_rows"):
        cli.main(["--mutate", "class_blind", "--seeds", "0:1",
                  "--engines", "equilibrium,equilibrium_batch"]
                 + ([] if device is None else ["--device", str(device)]))


def test_cli_mutation_smoke_shrinks_small(capsys):
    """``python -m repro_torch.fuzz --mutate variance_always_improves
    --shrink --device cpu`` exits 0 with a reproducer of at most 12
    events, printing the reference CLI's lines."""
    assert cli.main(["--mutate", "variance_always_improves", "--shrink",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == [
        "mutation 'variance_always_improves' caught at seed 0: [variance] "
        "equilibrium: variance rose 0.0037737887856465 -> "
        "0.003786698440232322 on pg=(2, 5) slot=0 10->1",
        "shrunk to 1 events / 1 ticks in 11 evals"]


def test_cli_replay_and_sweep(capsys):
    """Replay of the slack regression and a two-seed sweep through the
    whole class on the CPU both exit 0."""
    path = fuzz.corpus_dir() / "legacy-slack-divergence.json"
    assert cli.main(["--replay", str(path), "--device", "cpu"]) == 0
    assert cli.main(["--seeds", "2:4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"replay ok: {path} (30 moves)" in out
    assert "sweep ok: 2 timelines x 4 engines, 0 oracle failures" in out


# ---------------------------------------------------------------------------
# the replay copy and the warm planner


def test_replay_copy_does_not_notify_the_warm_planner():
    """The legality oracle's pre-plan copy starts with no subscribers, so
    replaying the moves on it never reaches the warm planner bound to the
    live state: no pending delta, not stale, and the next plan absorbs
    nothing and rebuilds nothing."""
    state = small_test_cluster()
    inner = create_planner("equilibrium_batch", device="cpu", chunk=4)
    proxy = _ReplayPlanner(inner, "equilibrium_batch", check_variance=True)
    assert state.copy()._subscribers == []
    first = proxy.plan(state, budget=4)
    assert len(first.moves) == 4 and len(proxy.moves) == 4
    impl = inner._impl
    assert impl._pending == {} and not impl.stale
    reg = obs.registry()
    snap, rebuilds = reg.snapshot(), dense_rebuild_count()
    proxy.plan(state, budget=4)
    assert dense_rebuild_count() == rebuilds
    assert reg.deltas_since(snap, "absorb.") == {}

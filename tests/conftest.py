"""Ensures the tests directory is importable (``_hypothesis_compat``)
and registers the ``slow`` marker: the heaviest scenario-equivalence
tests stay in CI but are deselectable locally with ``-m "not slow"``
(keeps a local tier-1 pass under ~2 minutes on a laptop/container)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: slowest scenario-equivalence tests (kept in CI; deselect "
        "locally with -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the PyTorch port's hand-written "
        "kernels); skips with a reason where torch.cuda.is_available() "
        "is False")

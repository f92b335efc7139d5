"""Shared pytest configuration: the ``slow`` marker and its gate.

``slow`` marks the mega-fleet and subprocess tests (fresh-interpreter
sharding / determinism checks each pay a full jax import + compile).
They are *skipped by default* so the tier-1 loop

    PYTHONPATH=src python -m pytest -x -q

stays snappy; CI runs them in a dedicated job with ``--runslow`` (see
.github/workflows/ci.yml), so everything still runs on every PR.

    python -m pytest -q --runslow              # everything
    python -m pytest -q --runslow -m slow      # only the slow tier
"""
import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (mega-fleet scale, subprocess "
             "sharding/determinism) instead of skipping them")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: mega-fleet / subprocess tests, skipped unless --runslow")
    config.addinivalue_line(
        "markers",
        "cuda: launches a CUDA kernel of repro_torch; skips without a GPU")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow: needs --runslow (CI slow job)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)

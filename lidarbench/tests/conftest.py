"""Shared small-scale settings for the benchmark's CPU tests."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from lidarbench.spec import Spec  # noqa: E402

@pytest.fixture(scope="session")
def spec():
    return Spec()

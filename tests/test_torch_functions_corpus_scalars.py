"""F6 to F11 of the function corpus (presto_tpu_torch/
function_queries.py: strings, regular expressions, dates, math, bitwise
and JSON over TPC-H) against presto_tpu on the CPU at SF0.01, in
"dynamic" and "auto", with the checks of
tests/test_torch_functions_corpus.py: rows, counters, execution mode and
memo entry equal to presto_tpu's, and a static pass that reads nothing
back to the host.
"""

import pytest

from tests.test_torch_functions_corpus import (
    MODES, Runs, assert_query_matches_reference,
    assert_static_pass_reads_nothing_back)
from tests.torch_threads import torch_one_thread  # noqa: F401

NAMES = ("F6", "F7", "F8", "F9", "F10", "F11")


@pytest.fixture(scope="module")
def runs():
    return Runs()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_query_matches_reference(name, mode, runs):
    assert_query_matches_reference(name, mode, runs)


@pytest.mark.parametrize("name", NAMES)
def test_static_pass_reads_nothing_back(name, runs):
    assert_static_pass_reads_nothing_back(name, runs.port_catalog)

"""Torch's thread count for a port test module, as an autouse module
fixture: ``_pinned_threads = thread_count(1)`` sets the count when the
module's tests start and restores the earlier one after. Every port test
module has one, so each runs at the count it names whatever module ran
before it on the same worker; a test may still change the count (the
CLI tests set 2), and the module's end restores it.

The count is set when the tests start, not at import: a pytest worker
imports every module before it runs any, and a module that ran earlier
on the same worker may have changed it (the parity tests' numbers depend
on it where a ReLU sits near its kink).
"""

import pytest
import torch


def thread_count(n: int):
    @pytest.fixture(autouse=True, scope="module")
    def fixture():
        old = torch.get_num_threads()
        torch.set_num_threads(n)
        yield
        torch.set_num_threads(old)
    return fixture

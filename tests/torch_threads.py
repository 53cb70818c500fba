"""A module-scoped fixture that runs a port test file's torch work on one
intra-op thread.

Import it into a test module (``from torch_threads import
one_torch_thread``) to make it apply there. Files whose fits are thousands
of small steps (index_add_, the LSTM recurrence, tile emulations) run as
fast on one thread alone, and under the parallel test run, where six
workers share the cores, each small op's parallel region otherwise waits
for threads that other workers hold: such files took 5 to 60 times their alone
time there.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

"""``one_thread``: a module fixture that runs a test module's torch work on
one thread.  The tier-1 run's parallel workers share the machine's cores,
and torch's own threads, one a core in every worker, would spin against
theirs and against JAX's.  A module takes it with ``from torch_threads
import one_thread``; it is autouse, so the import is the whole of it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

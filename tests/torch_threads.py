"""Two intra-op threads for a port test module. Tier-1 runs six workers on
eight cores: torch's default pool of one thread per core oversubscribes the
machine, and large CPU ops then slow down many times over. A test module
takes the fixture by importing it:

    from torch_threads import two_threads  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

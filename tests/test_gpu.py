"""Device-path checks that need an NVIDIA GPU (marker `gpu`; they skip
elsewhere).  Run on a GPU host with:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("batch", [2048, 8192])
def test_count_extensions_lookup_exact(gpu_device, batch):
    """count_batch, the extension columns and lookup_join on the GPU equal
    their numpy oracles exactly."""
    import chip_smoke
    chip_smoke.check_count(batch)


def test_golden_digests(gpu_device):
    import bench
    dev, host, dev2, host2 = bench.golden_digests()
    assert dev == host
    assert dev2 == host2

"""Pin the bench's scalar golden digests (bench._digest_np and the
device-side twin in bench.golden_digests) against each other and against
mutations — the golden check reads back ONE u32 per seed instead of the
whole table, so these digests carry the bench's correctness claim (ref
semantics being checked: src/Kmer.h:2161-2299 counting and
src/KmerTrackingData.h:153-230 extension tracking)."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402


def _host_tables():
    codes, bad, lengths = bench._golden_batch()
    logp = bench.golden_logp(bad)
    return codes, bad, logp, lengths


def test_digest_matches_device_path_on_cpu(capfd):
    """The full device stage (device digests vs host oracles, then the
    timed loop) passes on the CPU backend — the same code the GPU runs."""
    bench.device_child(steps=3)
    out = capfd.readouterr().out
    assert 'DEVICE={"platform": "cpu"' in out
    assert "GOLDEN=ok" in out
    assert "GOLDEN2=ok" in out
    assert "RATE=" in out


def test_digest_sensitive_to_count_mutation():
    codes, bad, logp, lengths = _host_tables()
    base = bench._host_count_digests(codes, logp, lengths)
    # recompute with one read dropped: counts (and likely keys) shift
    d2 = bench._host_count_digests(codes[:-1], logp[:-1], lengths[:-1])
    assert base != d2
    assert base[0] != d2[0] and base[1] != d2[1]


def test_digest_sensitive_to_single_base_flip():
    codes, bad, logp, lengths = _host_tables()
    base = bench._host_count_digests(codes, logp, lengths)
    mut = codes.copy()
    mut[3, 50] = (mut[3, 50] + 1) % 4
    d2 = bench._host_count_digests(mut, logp, lengths)
    assert base[0] != d2[0] and base[1] != d2[1]


def test_digest_sensitive_to_multiplicity_split():
    """A split count (2+3 as two rows vs one 5) moves the digest: the sum
    is over mix(count), and mix is nonlinear."""
    hi = np.array([7, 7], dtype=np.uint32)
    lo = np.array([9, 9], dtype=np.uint32)
    split = bench._digest_np(hi, lo, np.array([2, 3], np.uint32), 123)
    merged = bench._digest_np(hi[:1], lo[:1], np.array([5], np.uint32), 123)
    assert split != merged


def test_digest_order_insensitive():
    rng = np.random.default_rng(5)
    hi = rng.integers(0, 2**32, 100, dtype=np.uint32)
    lo = rng.integers(0, 2**32, 100, dtype=np.uint32)
    val = rng.integers(1, 50, 100, dtype=np.uint32)
    perm = rng.permutation(100)
    for seed in bench._DIGEST_SEEDS:
        assert (bench._digest_np(hi, lo, val, seed)
                == bench._digest_np(hi[perm], lo[perm], val[perm], seed))


def test_ext_digest_sensitive_to_extension_change():
    """Flipping a base OUTSIDE every window of a read (impossible at
    L=100, so instead: flip the base just right of the first window) can
    change only extension observations for some windows — the ext digest
    must move even when the count digest may not."""
    codes, bad, logp, lengths = _host_tables()
    base = bench._host_ext_digests(codes, logp, lengths)
    mut = codes.copy()
    mut[0, 99] = (mut[0, 99] + 2) % 4  # last base: right-ext of window 69
    d2 = bench._host_ext_digests(mut, logp, lengths)
    assert base != d2


def test_bad_windows_excluded():
    """A read whose logp makes every window bad contributes nothing."""
    codes, bad, logp, lengths = _host_tables()
    base = bench._host_count_digests(codes, logp, lengths)
    logp2 = logp.copy()
    logp2[5, :] = bench.LOGP_BAD  # read 5: all windows bad
    d2 = bench._host_count_digests(codes, logp2, lengths)
    assert base != d2
    # and dropping the read entirely gives the same digests as muting it
    d3 = bench._host_count_digests(np.delete(codes, 5, 0),
                                   np.delete(logp, 5, 0),
                                   np.delete(lengths, 5))
    assert d2 == d3


@pytest.mark.parametrize("seed", bench._DIGEST_SEEDS)
def test_empty_table_digest_is_zero(seed):
    z = np.zeros(0, np.uint32)
    assert bench._digest_np(z, z, z, seed) == 0

"""Multi-chip sharded spectrum: decomposition invariance on the virtual CPU
mesh — counts must match the single-device exact host pipeline regardless of
device count (the reference's core distributed test property,
ref: test/runFilterTests.sh rank sweep)."""
import numpy as np
import pytest

import jax

from kmernator_tpu.io.reads import load_reads
from tests.test_device_spectrum import host_counts

K = 31


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_distributed_counts_match_host(ndev, phix_fastq):
    import jax.numpy as jnp
    from kmernator_tpu.parallel.mesh import make_mesh, distributed_spectrum_fn
    from kmernator_tpu.parallel.device_spectrum import pack_readset

    rs = load_reads([phix_fastq])
    rs.identify_pairs()
    L = rs.max_length()
    codes, logp, lengths = pack_readset(rs, L, 3, 33)
    # pad batch to a multiple of ndev
    B = codes.shape[0]
    pad = (-B) % ndev
    if pad:
        codes = np.concatenate([codes, np.zeros((pad, L), codes.dtype)])
        logp = np.concatenate([logp, np.full((pad, L), -1e30, np.float32)])
        lengths = np.concatenate([lengths, np.zeros(pad, np.int32)])

    mesh = make_mesh(ndev)
    fn = distributed_spectrum_fn(mesh, K)
    counts, shard_keys, shard_counts, overflow = fn(
        jnp.asarray(codes), jnp.asarray(logp), jnp.asarray(lengths))
    assert int(np.asarray(overflow).sum()) == 0
    counts = np.asarray(counts)[:B]

    want_counts, good_host, sp = host_counts(rs, K)
    lens = rs.lengths()
    nw = np.maximum(lens - K + 1, 0)
    woff = np.concatenate([[0], np.cumsum(nw)])
    mism = 0
    for i in range(rs.n):
        n = int(nw[i])
        mism += int((counts[i, :n] != want_counts[woff[i]:woff[i] + n]).sum())
    assert mism == 0

    # the union of shard tables equals the host spectrum
    sk = np.asarray(shard_keys)
    sc = np.asarray(shard_counts)
    real = ~np.all(sk == 0xFFFFFFFF, axis=1) & (sc > 0)
    keys64 = (sk[real, 0].astype(np.uint64) << np.uint64(32)) | sk[real, 1]
    got = dict(zip(keys64.tolist(), sc[real].tolist()))
    sp_all = host_counts(rs, K, 1)[2]
    want = dict(zip(sp_all.keys.tolist(), sp_all.counts.tolist()))
    assert got == want


def test_sentinel_windows_not_routed():
    """Reads shorter than k make every window sentinel; those rows must be
    dropped, not routed (they'd all hash to one owner and overflow,
    which is what happened with qtrim remnant reads at 100MB scale)."""
    import jax.numpy as jnp
    import numpy as np
    from kmernator_tpu.parallel.mesh import make_mesh, distributed_count_fn

    rng = np.random.default_rng(2)
    D, B, L = 8, 512, 64
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lengths = np.full(B, L, np.int32)
    lengths[rng.random(B) < 0.9] = 10  # 90% shorter than k -> all-sentinel
    good = np.ones((B, L - K + 1), dtype=bool)
    mesh = make_mesh(D)
    # tight capacity: valid windows ~ 0.1*B*NW; sentinel rows ~0.9*B*NW
    fn = distributed_count_fn(mesh, K, capacity_factor=0.5, min_count=1)
    counts, overflow = fn(jnp.asarray(codes), jnp.asarray(good),
                          jnp.asarray(lengths))
    assert int(np.asarray(overflow).sum()) == 0
    counts = np.asarray(counts)
    # short reads have zero counts everywhere; full reads have counts >= 1
    long_rows = lengths == L
    assert (counts[~long_rows] == 0).all()
    assert (counts[long_rows] >= 1).all()

"""Device (jit) spectrum pipeline agrees with the exact host pipeline."""
import numpy as np
import pytest

from kmernator_tpu.io.reads import load_reads, BASE_CODE
from kmernator_tpu.ops.kmer import extract_kmers_flat
from kmernator_tpu.ops.weights import window_weights, good_kmer_mask
from kmernator_tpu.parallel.spectrum import KmerSpectrum, pack_u64

K = 31


@pytest.fixture(scope="module")
def rs(phix_fastq):
    r = load_reads([phix_fastq])
    r.identify_pairs()
    return r


def host_counts(rs, k, min_count=2):
    codes_raw = BASE_CODE[rs.seq]
    markup = codes_raw == 4
    codes = np.where(markup, 0, codes_raw).astype(np.uint8)
    canon, is_fwd, read_id, pos = extract_kmers_flat(codes, rs.offsets, k)
    keys = pack_u64(canon)
    p = rs.base_probabilities(3, 33)
    w = window_weights(p, rs.offsets, markup, k)
    good = good_kmer_mask(w, 0.10)
    sp = KmerSpectrum.from_observations(k, keys, good)
    sp.purge_min_depth(min_count)
    return sp.lookup_counts(keys), good, sp


def test_device_matches_host(rs):
    import jax.numpy as jnp
    from kmernator_tpu.parallel.device_spectrum import (
        pack_readset, extract_canonical, window_good, count_and_score)

    L = rs.max_length()
    codes, logp, lengths = pack_readset(rs, L, 3, 33)
    canon, is_fwd, valid = extract_canonical(jnp.asarray(codes),
                                             jnp.asarray(lengths), K)
    wsum, good_dev = window_good(jnp.asarray(logp), jnp.asarray(lengths), K,
                                 float(np.log2(0.10)))
    counts_dev, sorted_state = count_and_score(canon, good_dev, K, 2)

    want_counts, good_host, sp = host_counts(rs, K)

    # compare per-window (ragged host vs padded device)
    lens = rs.lengths()
    nw = np.maximum(lens - K + 1, 0)
    woff = np.concatenate([[0], np.cumsum(nw)])
    cd = np.asarray(counts_dev)
    gd = np.asarray(good_dev)
    mism_good = 0
    mism_cnt = 0
    for i in range(rs.n):
        n = int(nw[i])
        if rs.discarded[i]:
            continue
        hg = good_host[woff[i]:woff[i] + n] & ~rs.discarded[i]
        mism_good += int((gd[i, :n] != hg).sum())
        mism_cnt += int((cd[i, :n] != want_counts[woff[i]:woff[i] + n]).sum())
    assert mism_good == 0, "log-space good mask diverged on real data"
    assert mism_cnt == 0

    # spectrum compaction matches host unique counts
    from kmernator_tpu.parallel.device_spectrum import compact_spectrum
    tk, tc, nu = compact_spectrum(*sorted_state)
    assert int(nu) == sp.raw_good_kmers * 0 + len(host_counts(rs, K, 1)[2].keys)


def test_lookup_join(rs):
    import jax.numpy as jnp
    from kmernator_tpu.parallel.device_spectrum import lookup_join

    rng = np.random.default_rng(0)
    M, Q, W = 1000, 500, 2
    tkeys = np.unique(rng.integers(0, 2**32 - 2, (M, W)).astype(np.uint32), axis=0)
    M = len(tkeys)
    tcounts = rng.integers(1, 100, M).astype(np.int32)
    # half the queries hit, half miss
    qsel = rng.integers(0, M, Q // 2)
    qkeys = np.concatenate([tkeys[qsel],
                            rng.integers(0, 2**32 - 2, (Q - Q // 2, W)).astype(np.uint32)])
    got = np.asarray(lookup_join(jnp.asarray(tkeys), jnp.asarray(tcounts),
                                 jnp.asarray(qkeys)))
    # host oracle
    lut = {tuple(k): c for k, c in zip(map(tuple, tkeys), tcounts)}
    want = np.array([lut.get(tuple(q), 0) for q in qkeys], np.int32)
    assert np.array_equal(got, want)


def test_ragged_padded_roundtrip():
    from kmernator_tpu.parallel.device_spectrum import (ragged_to_padded,
                                                        padded_to_ragged)
    rng = np.random.default_rng(3)
    nw = np.array([3, 0, 5, 1, 0, 7])
    flat = rng.integers(0, 100, int(nw.sum())).astype(np.int32)
    padded = ragged_to_padded(flat, nw, 8, fill=-1)
    assert padded.shape == (6, 8)
    assert (padded[1] == -1).all() and (padded[0, 3:] == -1).all()
    assert (padded[2, :5] == flat[3:8]).all()
    back = padded_to_ragged(padded, nw)
    assert (back == flat).all()


def test_extract_canonical_cols_matches_stacked():
    import jax.numpy as jnp
    from kmernator_tpu.parallel.device_spectrum import (extract_canonical,
                                                        extract_canonical_cols)
    rng = np.random.default_rng(11)
    for k in (21, 31, 33, 64):
        codes = jnp.asarray(rng.integers(0, 4, (37, 80), dtype=np.uint8))
        lengths = jnp.asarray(rng.integers(k, 81, 37).astype(np.int32))
        canon, f1, v1 = extract_canonical(codes, lengths, k)
        cols, f2, v2 = extract_canonical_cols(codes, lengths, k)
        assert (np.asarray(f1) == np.asarray(f2))[np.asarray(v1)].all()
        assert (np.asarray(v1) == np.asarray(v2)).all()
        for w in range(canon.shape[-1]):
            assert (np.asarray(canon[..., w]) == np.asarray(cols[w])).all(), (k, w)


def test_auto_mesh_batch_selection(monkeypatch):
    """auto_mesh_batch: 2048 reads on the GPU and on the CPU, and the
    KMTPU_MESH_BATCH override on every backend."""
    import kmernator_tpu.parallel.device_spectrum as ds

    monkeypatch.delenv("KMTPU_MESH_BATCH", raising=False)
    for backend in ("cpu", "gpu"):
        monkeypatch.setattr(ds.jax, "default_backend", lambda: backend)
        assert ds.auto_mesh_batch() == 2048
        monkeypatch.setenv("KMTPU_MESH_BATCH", "123")
        assert ds.auto_mesh_batch() == 123
        monkeypatch.delenv("KMTPU_MESH_BATCH")

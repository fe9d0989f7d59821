"""Distributed kmer->read-id matcher vs the host KmerReadIndex oracle
(the exchangeGlobalReads analogue; ref: src/MatcherInterface.h:352-578).
Hit sets must be decomposition-invariant."""
import numpy as np
import pytest

K = 31
MAX_IDS = 48


def _inputs(path):
    from kmernator_tpu.io.reads import load_reads, BASE_CODE
    from kmernator_tpu.ops.kmer import extract_kmers_flat
    from kmernator_tpu.ops.weights import window_weights, good_kmer_mask
    from kmernator_tpu.parallel.device_spectrum import pack_readset
    from kmernator_tpu.parallel.spectrum import pack_u64

    rs = load_reads([path])
    L = rs.max_length()
    codes, _, lengths = pack_readset(rs, L, 3, 33)

    codes_raw = BASE_CODE[rs.seq]
    markup = codes_raw == 4
    flat_codes = np.where(markup, 0, codes_raw).astype(np.uint8)
    canon, _, read_id, _ = extract_kmers_flat(flat_codes, rs.offsets, K)
    p = rs.base_probabilities(3, 33)
    w = window_weights(p, rs.offsets, markup, K)
    good_flat = good_kmer_mask(w, 0.10) & ~rs.discarded[read_id]

    NW = L - K + 1
    good2d = np.zeros((rs.n, NW), dtype=bool)
    lens = rs.lengths()
    nw = np.maximum(lens - K + 1, 0)
    woff = np.concatenate([[0], np.cumsum(nw)])
    for i in range(rs.n):
        good2d[i, :nw[i]] = good_flat[woff[i]:woff[i] + nw[i]]

    keys_flat = pack_u64(canon)
    return rs, codes, good2d, lengths, canon, keys_flat, read_id, good_flat


@pytest.mark.parametrize("ndev", [1, 4])
def test_dist_match_vs_host(ndev, phix_fastq):
    import jax.numpy as jnp
    from kmernator_tpu.parallel.mesh import make_mesh
    from kmernator_tpu.parallel.dist_match import build_index_fn, match_fn
    from kmernator_tpu.ops.match import KmerReadIndex
    from kmernator_tpu.io.reads import load_reads

    rs, codes, good2d, lengths, canon, keys_flat, read_id, good_flat = _inputs(phix_fastq)
    B, L = codes.shape
    pad = (-B) % ndev
    if pad:
        codes = np.concatenate([codes, np.zeros((pad, L), codes.dtype)])
        good2d = np.concatenate([good2d, np.zeros((pad, good2d.shape[1]), bool)])
        lengths = np.concatenate([lengths, np.zeros(pad, np.int32)])
    read_global = np.arange(codes.shape[0], dtype=np.int32)

    mesh = make_mesh(ndev)
    bfn = build_index_fn(mesh, K)
    ikeys, irid, overflow = bfn(jnp.asarray(codes), jnp.asarray(good2d),
                                jnp.asarray(lengths),
                                jnp.asarray(read_global))
    assert int(np.asarray(overflow).sum()) == 0

    # queries: canonical kmers of the first window of 64 reads + 4 misses
    host = KmerReadIndex(rs, K, min_depth=1)
    qrows = []
    expect = []
    lens = rs.lengths()
    nw = np.maximum(lens - K + 1, 0)
    woff = np.concatenate([[0], np.cumsum(nw)])
    for i in range(64):
        if nw[i] == 0 or not good_flat[woff[i]]:
            continue
        key = keys_flat[woff[i]]
        j = np.searchsorted(host.keys, key)
        s, e = host.offsets[j], host.offsets[j + 1]
        if e - s > MAX_IDS:
            continue
        qrows.append(canon[woff[i]])
        expect.append(set(host.read_ids[s:e].tolist()))
    # guaranteed misses: absent keys (all-A style patterns not in data)
    for miss in (0x0F0F0F0F, 0x12345678):
        qrows.append(np.array([miss, miss], dtype=np.uint32))
        expect.append(set())
    assert len(qrows) >= 32
    queries = np.stack(qrows)

    mfn = match_fn(mesh, K, max_ids=MAX_IDS)
    ids = np.asarray(mfn(jnp.asarray(queries), ikeys, irid))
    for q in range(len(qrows)):
        got = set(int(x) for x in ids[q] if x >= 0)
        assert got == expect[q], (q, got, expect[q])

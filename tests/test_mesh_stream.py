"""Streaming sharded spectrum (mesh_stream.py): batches routed over the
mesh and merged into persistent per-device shard tables must reproduce the
one-shot host spectrum, and the sharded-table lookup must reproduce host
window counts — at every mesh size and batch cadence."""
import numpy as np
import pytest

K = 31


def _padded_input(path):
    """The seeded 1000-read FASTQ as padded (codes, good2d, lengths) with the exact host
    goodness mask (same prep as apps/filter_reads.py --mesh)."""
    from kmernator_tpu.io.reads import load_reads, BASE_CODE
    from kmernator_tpu.ops.weights import window_weights, good_kmer_mask
    from kmernator_tpu.parallel.device_spectrum import (pack_readset,
                                                        ragged_to_padded)
    rs = load_reads([path])
    L = max(rs.max_length(), K)
    codes, _, lengths = pack_readset(rs, L, 3, 33)
    codes_raw = BASE_CODE[rs.seq]
    markup = codes_raw == 4
    p = rs.base_probabilities(3, 33)
    w = window_weights(p, rs.offsets, markup, K)
    good = good_kmer_mask(w, 0.10)
    nw = np.maximum(rs.lengths() - K + 1, 0)
    good2d = ragged_to_padded(good, nw, L - K + 1, fill=False)
    good2d &= ~rs.discarded[:, None]
    return rs, codes, good2d, lengths, nw


def _host_table(path):
    from kmernator_tpu.io.reads import load_reads
    from kmernator_tpu.apps.filter_reads import build_spectrum
    rs = load_reads([path])
    sp = build_spectrum(rs, K, 3, 33, 0.10)
    sp.purge_min_depth(2)
    return dict(zip(sp.keys.tolist(), sp.counts.tolist())), rs


@pytest.mark.parametrize("n_devices,batch_reads", [(1, 1000), (2, 250),
                                                   (8, 128), (8, 1000)])
def test_mesh_stream_build_matches_host(n_devices, batch_reads, phix_fastq):
    from kmernator_tpu.parallel.mesh import make_mesh
    from kmernator_tpu.parallel.mesh_stream import MeshStreamingSpectrum
    from kmernator_tpu.parallel.spectrum import pack_keys

    rs, codes, good2d, lengths, nw = _padded_input(phix_fastq)
    mesh = make_mesh(n_devices)
    sp = MeshStreamingSpectrum(mesh, K, capacity=65536)
    for s in range(0, rs.n, batch_reads):
        e = min(s + batch_reads, rs.n)
        sp.add_batch(codes[s:e], good2d[s:e], lengths[s:e])
    keys, counts = sp.finalize(min_depth=2)
    got = dict(zip(pack_keys(keys).tolist(), counts.tolist()))
    want, _ = _host_table(phix_fastq)
    assert got == want
    assert sp.purged_singletons == 0


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_mesh_stream_lookup_matches_host(n_devices, phix_fastq):
    """Two-pass flow: streaming build, then batched lookup — per-window
    counts must equal the host spectrum lookup (the ReqResp analogue,
    ref: DistributedFunctions.h:809-902)."""
    from kmernator_tpu.apps.filter_reads import window_count_lookup
    from kmernator_tpu.parallel.mesh import make_mesh
    from kmernator_tpu.parallel.mesh_stream import MeshStreamingSpectrum
    from kmernator_tpu.parallel.device_spectrum import (ragged_to_padded,
                                                        padded_to_ragged)
    from kmernator_tpu.io.reads import load_reads
    from kmernator_tpu.apps.filter_reads import build_spectrum

    rs, codes, good2d, lengths, nw = _padded_input(phix_fastq)
    mesh = make_mesh(n_devices)
    sp = MeshStreamingSpectrum(mesh, K, capacity=65536)
    B = 250
    for s in range(0, rs.n, B):
        sp.add_batch(codes[s:s + B], good2d[s:s + B], lengths[s:s + B])

    # host oracle
    hsp = build_spectrum(rs, K, 3, 33, 0.10)
    hsp.purge_min_depth(2)
    want, woff = window_count_lookup(rs, hsp, K)

    NW = codes.shape[1] - K + 1
    allw = np.ones((rs.n, NW), dtype=bool)
    rows = []
    for s in range(0, rs.n, B):
        e = min(s + B, rs.n)
        c2d = sp.lookup_batch(codes[s:e], allw[s:e], lengths[s:e],
                              min_count=2)
        rows.append(c2d[:e - s])
    got2d = np.concatenate(rows)
    got = padded_to_ragged(got2d, nw).astype(np.int64)
    assert np.array_equal(got, want)


def test_mesh_stream_purge_under_pressure():
    """Tiny per-shard capacity: singletons purge, solid keys survive with
    at-most-true counts (per-shard version of the StreamingSpectrum purge
    test)."""
    from kmernator_tpu.ops.kmer import extract_kmers_flat
    from kmernator_tpu.parallel.spectrum import pack_u64
    from kmernator_tpu.parallel.mesh import make_mesh
    from kmernator_tpu.parallel.mesh_stream import MeshStreamingSpectrum

    rng = np.random.default_rng(7)
    L, B = 64, 256
    genome = rng.integers(0, 4, 2000, dtype=np.uint8)
    batches = []
    for bi in range(12):
        codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
        starts = rng.integers(0, 2000 - L, B // 2)
        codes[:B // 2] = genome[starts[:, None] + np.arange(L)[None, :]]
        batches.append(codes)

    true = {}
    for codes in batches:
        flat = codes.reshape(-1)
        offs = np.arange(0, (B + 1) * L, L)
        canon, _, _, _ = extract_kmers_flat(flat, offs, K)
        for kk in pack_u64(canon).tolist():
            true[kk] = true.get(kk, 0) + 1

    mesh = make_mesh(8)
    sp = MeshStreamingSpectrum(mesh, K, capacity=2048)  # 16384 total rows
    good = np.ones((B, L - K + 1), dtype=bool)
    lengths = np.full(B, L, np.int32)
    for codes in batches:
        sp.add_batch(codes, good, lengths)
    keys, counts = sp.finalize(min_depth=2)
    assert sp.purged_singletons > 0
    keys64 = (keys[:, 0].astype(np.uint64) << np.uint64(32)) | keys[:, 1]
    got = dict(zip(keys64.tolist(), counts.tolist()))
    assert len(got) > 0
    for kk, c in got.items():
        assert kk in true and c <= true[kk]
    solid_true = [(kk, c) for kk, c in true.items() if c >= 12]
    assert len(solid_true) > 1000
    devs = [c - got.get(kk, 0) for kk, c in solid_true]
    assert all(0 <= d <= 5 for d in devs)
    assert sum(1 for d in devs if d == 0) >= 0.9 * len(devs)


def test_mesh_stream_set_table_roundtrip(phix_fastq):
    """set_table (push a host-transformed table back to the shards) must
    leave lookups identical when the table is unchanged."""
    from kmernator_tpu.parallel.mesh import make_mesh
    from kmernator_tpu.parallel.mesh_stream import MeshStreamingSpectrum

    rs, codes, good2d, lengths, nw = _padded_input(phix_fastq)
    mesh = make_mesh(4)
    sp = MeshStreamingSpectrum(mesh, K, capacity=65536)
    sp.add_batch(codes, good2d, lengths)
    keys, counts = sp.finalize(min_depth=1)
    NW = codes.shape[1] - K + 1
    allw = np.ones((rs.n, NW), dtype=bool)
    before = sp.lookup_batch(codes, allw, lengths, min_count=2)
    sp.set_table(keys, counts.astype(np.int32))
    after = sp.lookup_batch(codes, allw, lengths, min_count=2)
    assert np.array_equal(before, after)


def test_mesh_stream_grow_on_pressure_exact():
    """Grow-on-pressure (max_capacity > capacity): the shard tables start
    tiny, double whenever over half full, never purge below the ceiling,
    and the finished table is EXACTLY the fixed-big-capacity build — the
    memory fix that keeps per-device tables sized to the unique
    population instead of the raw stream estimate."""
    from kmernator_tpu.ops.kmer import extract_kmers_flat
    from kmernator_tpu.parallel.spectrum import pack_u64
    from kmernator_tpu.parallel.mesh import make_mesh
    from kmernator_tpu.parallel.mesh_stream import MeshStreamingSpectrum

    rng = np.random.default_rng(11)
    L, B = 64, 256
    genome = rng.integers(0, 4, 3000, dtype=np.uint8)
    batches = []
    for bi in range(10):
        codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
        starts = rng.integers(0, 3000 - L, B // 2)
        codes[:B // 2] = genome[starts[:, None] + np.arange(L)[None, :]]
        batches.append(codes)

    true = {}
    for codes in batches:
        flat = codes.reshape(-1)
        offs = np.arange(0, (B + 1) * L, L)
        canon, _, _, _ = extract_kmers_flat(flat, offs, K)
        for kk in pack_u64(canon).tolist():
            true[kk] = true.get(kk, 0) + 1

    mesh = make_mesh(4)
    good = np.ones((B, L - K + 1), dtype=bool)
    lengths = np.full(B, L, np.int32)

    grown = MeshStreamingSpectrum(mesh, K, capacity=1024,
                                  max_capacity=1 << 20)
    for codes in batches:
        grown.add_batch(codes, good, lengths)
    gk, gc = grown.finalize(min_depth=1)
    assert grown.cap > 1024, "table never grew"
    assert grown.purged_singletons == 0, "growth must pre-empt the purge"

    fixed = MeshStreamingSpectrum(mesh, K, capacity=65536)
    for codes in batches:
        fixed.add_batch(codes, good, lengths)
    fk, fc = fixed.finalize(min_depth=1)
    assert fixed.purged_singletons == 0

    def as_dict(keys, counts):
        k64 = (keys[:, 0].astype(np.uint64) << np.uint64(32)) | keys[:, 1]
        return dict(zip(k64.tolist(), counts.tolist()))

    g, f = as_dict(gk, gc), as_dict(fk, fc)
    assert g == f == true

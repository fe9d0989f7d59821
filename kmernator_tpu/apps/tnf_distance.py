"""TnfDistance: tetra(or other k)-nucleotide-frequency vectors, distances,
and clustering for contig binning (ref: apps/TnfDistance.cpp).

Array design: per-sequence TNF vectors are bincounts over canonical
small-k codes ([B, n_canonical] one pass), and all pairwise Euclidean
distances come from a single matmul on the L2-normalized matrix
(d^2 = 2 - 2 a.b) — replacing the reference's per-pair scalar loops.

Output column order uses sorted canonical k-mers (the reference emits in
hash-bucket order; distances are unaffected).
"""
from __future__ import annotations

import sys
from typing import List

import numpy as np

from kmernator_tpu.io.reads import ReadSet, load_reads, BASE_CODE
from kmernator_tpu.ops.kmer import extract_kmers_flat, kmer_to_string
from kmernator_tpu.utils.options import GeneralOptions, compose


class _TnfOptions:
    FLAGS = {"kmer-size": int, "reference-file": list,
             "inter-distance-file": str, "cluster-file": str,
             "cluster-threshold-distance": float,
             "distance-formula": str, "min-sequence-length": int,
             "intra-inter-file": str, "window-size": int, "window-step": int,
             "window2-size": int, "window2-step": int,
             "include-intra-inter-data-file":
                 lambda v: str(v).lower() not in ("0", "false", ""),
             "likelihood-bins": int, "max-samples": int}

    def __init__(self):
        self.kmer_size = 4
        self.reference_file = []
        self.inter_distance_file = ""
        self.cluster_file = ""
        self.cluster_threshold_distance = 0.175
        self.distance_formula = "EUCLIDEAN"
        self.min_sequence_length = 0
        self.intra_inter_file = ""
        self.window_size = 2000
        self.window_step = 1000
        self.window2_size = -1
        self.window2_step = 1000
        self.include_intra_inter_data_file = False
        self.likelihood_bins = 250
        self.max_samples = 2_000_000


def canonical_index_table(k: int):
    """Map every k-mer value (2k bits) to a compact canonical index."""
    n = 4 ** k
    vals = np.arange(n, dtype=np.uint64)
    # compute canonical value per kmer via string method (k small)
    canon = np.zeros(n, dtype=np.uint64)
    for v in range(n):
        # unpack bases (big-endian 2-bit within 2k bits)
        bases = [(v >> (2 * (k - 1 - i))) & 3 for i in range(k)]
        rc = [3 - b for b in reversed(bases)]
        fv = v
        rv = 0
        for b in rc:
            rv = (rv << 2) | b
        canon[v] = min(fv, rv)
    uniq = np.unique(canon)
    index = np.searchsorted(uniq, canon)
    return index.astype(np.int32), uniq


def tnf_vectors(rs: ReadSet, k: int):
    """[B, n_canonical] float32 counts (good windows only — windows covering
    markups weigh 0, ref: buildWeightedKmers)."""
    index, uniq = canonical_index_table(k)
    n_can = len(uniq)
    codes_raw = BASE_CODE[rs.seq]
    markup = codes_raw == 4
    codes = np.where(markup, 0, codes_raw).astype(np.uint8)
    lens = rs.lengths()
    nw = np.maximum(lens - k + 1, 0)
    out = np.zeros((rs.n, n_can), dtype=np.float64)
    if nw.sum() == 0:
        return out, uniq
    canon, _, read_id, pos = extract_kmers_flat(codes, rs.offsets, k)
    # small-k canonical value packed from word 0 (k <= 16)
    val = (canon[:, 0] >> np.uint32(32 - 2 * k)).astype(np.int64)
    ci = index[val]
    # markup-covered windows are zero-weight
    mcum = np.concatenate([[0], np.cumsum(markup.astype(np.int64))])
    base0 = rs.offsets[:-1][read_id] + pos
    good = (mcum[base0 + k] - mcum[base0]) == 0
    flat = read_id.astype(np.int64) * n_can + ci
    np.add.at(out.reshape(-1), flat[good], 1.0)
    return out, uniq


def distances(tnfs: np.ndarray, formula: str = "EUCLIDEAN") -> np.ndarray:
    norms = np.sqrt((tnfs * tnfs).sum(axis=1))
    norms = np.where(norms == 0, 1.0, norms)
    a = tnfs / norms[:, None]
    if formula == "SPEARMAN":
        from scipy.stats import rankdata  # optional
        a = np.apply_along_axis(rankdata, 1, tnfs)
        a = a - a.mean(axis=1, keepdims=True)
        a = a / np.sqrt((a * a).sum(axis=1))[:, None]
        return np.sqrt(np.maximum(0.0, (1.0 - a @ a.T)))
    try:
        import jax.numpy as jnp
        g = np.asarray(jnp.matmul(jnp.asarray(a, jnp.float32),
                                  jnp.asarray(a.T, jnp.float32),
                                  preferred_element_type=jnp.float32))
    except Exception:
        g = a @ a.T
    d2 = np.maximum(0.0, 2.0 - 2.0 * g)
    return np.sqrt(d2)


def cluster(dist: np.ndarray, threshold: float) -> List[List[int]]:
    """Greedy agglomerative single-link clustering at the threshold
    (ref: TnfDistance.cpp cluster flow :900-1000)."""
    n = len(dist)
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(n):
        for j in range(i + 1, n):
            if dist[i, j] <= threshold:
                pi, pj = find(i), find(j)
                if pi != pj:
                    parent[pi] = pj
    groups = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    return list(groups.values())


def shred_windows(rs: ReadSet, window: int, step: int) -> ReadSet:
    """ref: shredReadByWindow — fixed windows every `step` bases."""
    out = ReadSet()
    out.input_qual_base = rs.input_qual_base
    for i in range(rs.n):
        seq = rs.get_seq(i)
        L = len(seq)
        for s in range(0, max(L - window, 0) or 1, step):
            if L <= window and s > 0:
                break
            out.append_read(rs.names[i] + b":%d-%d" % (s, min(s + window, L)),
                            b"", seq[s:s + window], None)
            out.file_idx[-1] = rs.file_idx[i]
    return out


def intra_inter_likelihood(rs: ReadSet, tnfo, k: int) -> str:
    """Intra- vs inter-file TNF distance likelihood tables
    (ref: TnfDistance.cpp --intra-inter-file flow :700-860): shred every
    sequence into windows, histogram pairwise distances within a file
    (intra) vs across files (inter), plus window-vs-whole-file distances."""
    rng = np.random.default_rng(0)
    max_dist = np.sqrt(2.0) if tnfo.distance_formula == "EUCLIDEAN" else 1.0
    bins = tnfo.likelihood_bins
    edges = np.linspace(0.0, max_dist, bins + 1)
    names = ["intra", "inter", "intra_vs_whole", "inter_vs_whole"]
    use_w2 = tnfo.window2_size > 0
    if use_w2:
        names += ["intra_w1w2", "inter_w1w2"]
    hists = {name: np.zeros(bins + 1, dtype=np.int64) for name in names}
    raw = [] if tnfo.include_intra_inter_data_file else None

    def observe(name, d):
        idx = np.minimum((d / (max_dist / bins)).astype(np.int64), bins)
        np.add.at(hists[name], idx, 1)
        if raw is not None:
            for v in np.atleast_1d(d):
                raw.append("%s\t%g" % (name, v))

    shreds = shred_windows(rs, tnfo.window_size, tnfo.window_step)
    tnfs, _ = tnf_vectors(shreds, k)
    # purge short windows (ref: purgeShortTNFS at 3/4 of the window)
    keep = tnfs.sum(axis=1) >= tnfo.window_size * 3 // 4
    tnfs = tnfs[keep]
    files = shreds.file_idx[keep]
    if use_w2:
        shreds2 = shred_windows(rs, tnfo.window2_size, tnfo.window2_step)
        tnfs2, _ = tnf_vectors(shreds2, k)
        keep2 = tnfs2.sum(axis=1) >= tnfo.window2_size * 3 // 4
        tnfs2 = tnfs2[keep2]
        files2 = shreds2.file_idx[keep2]
    whole, _ = tnf_vectors(rs, k)
    whole_by_file = np.zeros((int(rs.file_idx.max()) + 1, whole.shape[1]))
    np.add.at(whole_by_file, rs.file_idx, whole)

    n_files = whole_by_file.shape[0]
    max_intra = tnfo.max_samples // max(n_files, 1)
    for fi in range(n_files):
        sel = np.flatnonzero(files == fi)
        if len(sel) < 2:
            continue
        sub = tnfs[sel]
        d2whole = distances(np.concatenate([whole_by_file[fi:fi + 1], sub]),
                            tnfo.distance_formula)[0, 1:]
        observe("intra_vs_whole", d2whole)
        dm = distances(sub, tnfo.distance_formula)
        iu = np.triu_indices(len(sub), 1)
        vals = dm[iu]
        if len(vals) > max_intra:
            vals = rng.choice(vals, max_intra, replace=False)
        observe("intra", vals)
        if use_w2:
            sel2 = np.flatnonzero(files2 == fi)
            if len(sel2):
                dm12 = distances(np.concatenate([sub, tnfs2[sel2]]),
                                 tnfo.distance_formula)[:len(sub), len(sub):]
                v12 = dm12.reshape(-1)
                if len(v12) > max_intra:
                    v12 = rng.choice(v12, max_intra, replace=False)
                observe("intra_w1w2", v12)
    # inter: across file pairs
    if n_files >= 2:
        max_inter = tnfo.max_samples // (n_files * (n_files - 1) // 2)
        for fi in range(n_files):
            for fj in range(fi + 1, n_files):
                a = tnfs[files == fi]
                b = tnfs[files == fj]
                if not len(a) or not len(b):
                    continue
                dm = distances(np.concatenate([a, b]),
                               tnfo.distance_formula)[:len(a), len(a):]
                vals = dm.reshape(-1)
                if len(vals) > max_inter:
                    vals = rng.choice(vals, max_inter, replace=False)
                observe("inter", vals)
                observe("inter_vs_whole",
                        distances(np.concatenate([whole_by_file[fj:fj + 1], a]),
                                  tnfo.distance_formula)[0, 1:])
                observe("inter_vs_whole",
                        distances(np.concatenate([whole_by_file[fi:fi + 1], b]),
                                  tnfo.distance_formula)[0, 1:])
                if use_w2:
                    b2 = tnfs2[files2 == fj]
                    if len(a) and len(b2):
                        dm12 = distances(np.concatenate([a, b2]),
                                         tnfo.distance_formula)[:len(a), len(a):]
                        v12 = dm12.reshape(-1)
                        if len(v12) > max_inter:
                            v12 = rng.choice(v12, max_inter, replace=False)
                        observe("inter_w1w2", v12)
    header = ["BinStart", "Intra", "Inter", "IntraVsWhole", "InterVsWhole"]
    cols = ["intra", "inter", "intra_vs_whole", "inter_vs_whole"]
    if use_w2:
        header += ["IntraW1W2", "InterW1W2"]
        cols += ["intra_w1w2", "inter_w1w2"]
    lines = ["\t".join(header)]
    for b in range(bins + 1):
        lines.append("\t".join(["%g" % edges[min(b, bins)]] +
                                ["%d" % hists[c][b] for c in cols]))
    table = "\n".join(lines) + "\n"
    if raw is not None and tnfo.intra_inter_file:
        with open(tnfo.intra_inter_file + ".data", "w") as f:
            f.write("\n".join(raw) + "\n")
    return table


def run(argv: List[str]) -> int:
    opts = GeneralOptions()
    tnfo = _TnfOptions()
    argv = ["--output-file" if a == "--out" else a for a in argv]
    compose([opts, tnfo], argv, positional=["input-file"])
    k = tnfo.kmer_size

    rs = load_reads(opts.input_file, opts.fastq_base_quality,
                    opts.fastq_output_base_quality, opts.keep_read_comment)
    tnfs, uniq = tnf_vectors(rs, k)

    out = sys.stdout
    close = False
    if opts.output_file:
        out = open(opts.output_file, "w")
        close = True

    if tnfo.reference_file:
        ref = load_reads(tnfo.reference_file, opts.fastq_base_quality,
                         opts.fastq_output_base_quality, opts.keep_read_comment)
        rt, _ = tnf_vectors(ref, k)
        ref_vec = rt.sum(axis=0, keepdims=True)
        allv = np.concatenate([ref_vec, tnfs])
        d = distances(allv, tnfo.distance_formula)[0, 1:]
        order = np.argsort(d, kind="stable")
        for i in order:
            out.write("%g\t%s\n" % (d[i], rs.names[i].decode()))
    else:
        header = ["Label", "Count", "Length"]
        W = (k + 15) // 16
        for v in uniq:
            words = np.array([np.uint32(v << np.uint64(32 - 2 * k))], dtype=np.uint32)
            header.append(kmer_to_string(words, k))
        out.write("\t".join(header) + "\n")
        norms = np.sqrt((tnfs * tnfs).sum(axis=1))
        norms = np.where(norms == 0, 1.0, norms)
        for i in range(rs.n):
            row = [rs.names[i].decode(), "%g" % tnfs[i].sum(), "%g" % norms[i]]
            row += ["%g" % x for x in (tnfs[i] / norms[i])]
            out.write("\t".join(row) + "\n")

    if tnfo.inter_distance_file:
        d = distances(tnfs, tnfo.distance_formula)
        with open(tnfo.inter_distance_file, "w") as f:
            for i in range(rs.n):
                f.write(rs.names[i].decode())
                for j in range(i):
                    f.write("\t%g" % d[i, j])
                f.write("\n")

    if tnfo.cluster_file:
        d = distances(tnfs, tnfo.distance_formula)
        groups = cluster(d, tnfo.cluster_threshold_distance)
        with open(tnfo.cluster_file, "w") as f:
            for gi, g in enumerate(groups):
                for i in g:
                    f.write("%d\t%s\n" % (gi, rs.names[i].decode()))

    if tnfo.intra_inter_file:
        with open(tnfo.intra_inter_file, "w") as f:
            f.write(intra_inter_likelihood(rs, tnfo, k))
    if close:
        out.close()
    return 0


def main():
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()

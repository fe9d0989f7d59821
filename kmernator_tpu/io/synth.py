"""Seeded synthetic inputs: read sets generated from a seed, so tests and
the device smoke run from what is in the repository.

- `phix_paired_fastq`: interleaved read pairs sampled from the bundled
  PhiX174 genome (`kmernator_tpu/data/phix174.fasta`) with substitutions,
  low-quality 3' tails and some shortened reads.
- `phix_seeds_fasta`: short exact substrings of PhiX174, the seed contigs
  of the nucleating assembler.
- `random_genome_fastq`: single-end 100-base reads from a random genome
  (0.3% substitutions, 1% low-quality bases), sized in MB.
"""
from __future__ import annotations

import os

import numpy as np

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_PHIX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "data", "phix174.fasta")


def phix_codes() -> np.ndarray:
    """PhiX174 as base codes 0..3 (A, C, G, T)."""
    with open(_PHIX, "rb") as f:
        seq = b"".join(l.strip() for l in f if not l.startswith(b">"))
    lut = np.full(256, 255, dtype=np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    codes = lut[np.frombuffer(seq, dtype=np.uint8)]
    if (codes == 255).any():
        raise ValueError("non-ACGT base in %s" % _PHIX)
    return codes


def _write_fastq(f, names, codes, quals, lengths):
    f.write(b"".join(
        b"@%s\n%s\n+\n%s\n" % (nm, _ACGT[c[:n]].tobytes(), q[:n].tobytes())
        for nm, c, q, n in zip(names, codes, quals, lengths)))


def phix_paired_fastq(path: str, n_pairs: int = 500, read_length: int = 100,
                      seed: int = 1) -> str:
    """Write `n_pairs` interleaved pairs (`name/1`, `name/2`; mate 2 is the
    reverse complement of the fragment's far end) with phred+33 qualities.
    Per read: 0.5% substitutions; 30% get a low-quality 3' tail of 5..30
    bases (phred 2..12); 10% are cut to 50..L-1 bases."""
    rng = np.random.default_rng(seed)
    genome = phix_codes()
    L = read_length
    n = 2 * n_pairs
    frag = rng.integers(2 * L, 3 * L + 1, n_pairs)
    start = rng.integers(0, len(genome) - frag)
    r1 = genome[start[:, None] + np.arange(L)[None, :]]
    end = start + frag
    r2 = 3 - genome[end[:, None] - 1 - np.arange(L)[None, :]]
    codes = np.empty((n, L), dtype=np.uint8)
    codes[0::2], codes[1::2] = r1, r2
    err = rng.random((n, L)) < 0.005
    codes[err] = (codes[err] + rng.integers(1, 4, int(err.sum()))) % 4
    q = np.clip(rng.normal(36, 3, (n, L)), 2, 40).astype(np.uint8)
    tail = np.where(rng.random(n) < 0.3, rng.integers(5, 31, n), 0)
    in_tail = np.arange(L)[None, :] >= (L - tail)[:, None]
    q[in_tail] = rng.integers(2, 13, int(in_tail.sum()))
    lengths = np.where(rng.random(n) < 0.1, rng.integers(50, L, n), L)
    names = [b"phix_%d/%d" % (i // 2, 1 + i % 2) for i in range(n)]
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _write_fastq(f, names, codes, q + 33, lengths)
    os.replace(tmp, path)
    return path


def phix_seeds_fasta(path: str, n_seeds: int = 5, length: int = 76,
                     seed: int = 2) -> str:
    """Write `n_seeds` exact PhiX174 substrings as FASTA seed contigs,
    starts spread over the genome."""
    rng = np.random.default_rng(seed)
    genome = phix_codes()
    span = (len(genome) - length) // n_seeds
    with open(path, "wb") as f:
        for i in range(n_seeds):
            s = i * span + int(rng.integers(0, span))
            f.write(b">seed%d\n%s\n" % (i, _ACGT[genome[s:s + length]].tobytes()))
    return path


def random_genome_fastq(path: str, mb: float, genome_bp: int = 5_000_000,
                        read_length: int = 100, seed: int = 11) -> str:
    """Write about `mb` MB of single-end reads (`@r<i>`) sampled from a
    random `genome_bp` genome: 0.3% substitutions, phred ~N(37, 3) with 1%
    of bases at phred 2..14.  A file already at `path` of the right size
    is kept."""
    if os.path.exists(path) and os.path.getsize(path) > mb * 900000:
        return path
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_bp, dtype=np.uint8)
    L = read_length
    n_reads = int(mb * 1e6 / (2 * L + 15))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        done = 0
        while done < n_reads:
            b = min(100000, n_reads - done)
            starts = rng.integers(0, len(genome) - L, b)
            codes = genome[starts[:, None] + np.arange(L)[None, :]].copy()
            err = rng.random((b, L)) < 0.003
            codes[err] = (codes[err] + rng.integers(1, 4, err.sum())) % 4
            q = np.clip(rng.normal(37, 3, (b, L)), 2, 40).astype(np.uint8)
            low = rng.random((b, L)) < 0.01
            q[low] = rng.integers(2, 15, low.sum())
            _write_fastq(f, [b"r%d" % (done + i) for i in range(b)], codes,
                         q + 33, np.full(b, L))
            done += b
    os.replace(tmp, path)
    return path

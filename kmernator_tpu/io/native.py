"""ctypes bindings for the native IO kernels (native/io_native.cpp).

Builds the shared library on first use (g++ is in the image) for the host
it runs on; all callers fall back to the pure-numpy paths when compilation
is unavailable.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE = os.path.join(_REPO, "native")

_lib = None
_tried = False

# kernels default to this thread count; worker-pool parents set it to 1
# before forking so 4 processes x 4 threads don't oversubscribe 4 cores
DEFAULT_THREADS = 0  # 0 = cpu_count


def set_default_threads(n: int):
    global DEFAULT_THREADS
    DEFAULT_THREADS = n


def _threads(n_threads: int) -> int:
    if n_threads > 0:
        return n_threads
    if DEFAULT_THREADS > 0:
        return DEFAULT_THREADS
    return os.cpu_count() or 1


def host_target_flags() -> str:
    """g++'s target options under -march=native: the instruction-set
    features a -march=native build of this host may use."""
    return subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                          check=True, capture_output=True, text=True).stdout


def native_build_path(name: str, shared: bool, target_flags: str) -> str:
    """native/build/<host key>/<name>-<source key>[.so]: the host key
    hashes the target flags, the source key the committed source, so a
    binary is reused only on a host with the same instruction set and only
    for the source it was built from."""
    with open(os.path.join(_NATIVE, name + ".cpp"), "rb") as f:
        src_key = hashlib.sha256(f.read()).hexdigest()[:16]
    host_key = hashlib.sha256(target_flags.encode()).hexdigest()[:16]
    return os.path.join(_NATIVE, "build", host_key, "%s-%s%s"
                        % (name, src_key, ".so" if shared else ""))


def build_native(name: str, shared: bool = False) -> str:
    """Compile native/<name>.cpp with -O3 -march=native for this host
    (a shared library when `shared`) unless the host-keyed build exists;
    returns its path.  Raises CalledProcessError when g++ fails."""
    out = native_build_path(name, shared, host_target_flags())
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = "%s.tmp%d" % (out, os.getpid())
        cmd = ["g++", "-O3", "-march=native", "-o", tmp,
               os.path.join(_NATIVE, name + ".cpp")]
        cmd += ["-shared", "-fPIC"] if shared else ["-lpthread"]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(build_native("io_native", shared=True))
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.fastq_index.restype = ctypes.c_long
    lib.fastq_index_mt.restype = ctypes.c_long
    if hasattr(lib, "format_mer_lines"):
        lib.format_mer_lines.restype = ctypes.c_long
    _lib = lib
    return _lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def fastq_index(data: bytes, n_threads: int = 0):
    """FASTQ record index (multithreaded chunked scan with record-boundary
    resync).  Returns dict of numpy offset arrays or None if the native lib
    is unavailable / input malformed."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    n_threads = _threads(n_threads)
    # capacity: exact newline count for small inputs, sampled estimate with
    # an exact-count retry for large ones (avoids a full pre-pass)
    if len(buf) < (16 << 20):
        caps = [int((buf == 10).sum()) // 4 + 2]
    else:
        sample = int((buf[:4 << 20] == 10).sum())
        est = int(len(buf) * (max(sample, 1) / float(4 << 20)) / 4 * 1.15)
        caps = [est + 1024, int((buf == 10).sum()) // 4 + 2]
    for cap in caps:
        cap = max(cap, 16)
        cols = {name: np.zeros(cap, dtype=np.int64) for name in
                ("name_off", "name_len", "comment_off", "comment_len",
                 "seq_off", "seq_len", "qual_off")}
        n = lib.fastq_index_mt(_ptr(buf), ctypes.c_long(len(buf)),
                               ctypes.c_long(cap),
                               *[_ptr(cols[c]) for c in
                                 ("name_off", "name_len", "comment_off",
                                  "comment_len", "seq_off", "seq_len",
                                  "qual_off")],
                               ctypes.c_int(n_threads))
        if 0 <= n < cap - 1:  # n == cap-1/cap could be a silent truncation
            return {k: v[:n] for k, v in cols.items()}
    if n >= 0:
        return {k: v[:n] for k, v in cols.items()}
    return None


def normalize_bases(seq: np.ndarray) -> np.ndarray:
    lib = get_lib()
    out = np.empty_like(seq)
    if lib is None:
        from kmernator_tpu.io.reads import _BASE_NORM
        return _BASE_NORM[seq]
    lib.normalize_bases(_ptr(seq), ctypes.c_long(len(seq)), _ptr(out))
    return out


def pack_batch_idx(data: np.ndarray, seq_off: np.ndarray, qual_off: np.ndarray,
                   seq_len: np.ndarray, L: int, logp_table: np.ndarray,
                   logp_floor: float = -1e30, n_threads: int = 0):
    """Pack straight from the raw buffer via index arrays (fast path;
    multithreaded over reads when the batch is large)."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(seq_off)
    codes = np.zeros((B, L), dtype=np.uint8)
    logp = np.zeros((B, L), dtype=np.float32)
    lengths = np.zeros(B, dtype=np.int32)
    tab = np.ascontiguousarray(logp_table, dtype=np.float64)
    n_threads = _threads(n_threads)
    lib.pack_batch_idx_mt(_ptr(data),
                          _ptr(np.ascontiguousarray(seq_off, np.int64)),
                          _ptr(np.ascontiguousarray(qual_off, np.int64)),
                          _ptr(np.ascontiguousarray(seq_len, np.int64)),
                          ctypes.c_long(B), ctypes.c_long(L), _ptr(tab),
                          ctypes.c_float(logp_floor),
                          _ptr(codes), _ptr(logp), _ptr(lengths),
                          ctypes.c_int(n_threads))
    return codes, logp, lengths


def pack_batch_qual(data: np.ndarray, seq_off: np.ndarray,
                    qual_off: np.ndarray, seq_len: np.ndarray, L: int,
                    n_threads: int = 0):
    """Pack codes + raw quality bytes (1B/base transfer format for
    device-side logp conversion).  Markup/pad positions get qual 0, which
    the device table maps to the -inf floor."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(seq_off)
    codes = np.zeros((B, L), dtype=np.uint8)
    qual = np.zeros((B, L), dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    n_threads = _threads(n_threads)
    lib.pack_batch_qual_mt(_ptr(data),
                           _ptr(np.ascontiguousarray(seq_off, np.int64)),
                           _ptr(np.ascontiguousarray(qual_off, np.int64)),
                           _ptr(np.ascontiguousarray(seq_len, np.int64)),
                           ctypes.c_long(B), ctypes.c_long(L),
                           _ptr(codes), _ptr(qual), _ptr(lengths),
                           ctypes.c_int(n_threads))
    return codes, qual, lengths


def pack_batch_2bit_qual(data: np.ndarray, seq_off: np.ndarray,
                         qual_off: np.ndarray, seq_len: np.ndarray, L: int,
                         n_threads: int = 0):
    """2-bit packed codes (4 bases/byte — the reference wire format) + raw
    qual bytes: the minimal host->device transfer encoding."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(seq_off)
    Lb = (L + 3) // 4
    codes2 = np.zeros((B, Lb), dtype=np.uint8)
    qual = np.zeros((B, L), dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    n_threads = _threads(n_threads)
    lib.pack_batch_2bit_qual_mt(
        _ptr(data),
        _ptr(np.ascontiguousarray(seq_off, np.int64)),
        _ptr(np.ascontiguousarray(qual_off, np.int64)),
        _ptr(np.ascontiguousarray(seq_len, np.int64)),
        ctypes.c_long(B), ctypes.c_long(L),
        _ptr(codes2), _ptr(qual), _ptr(lengths), ctypes.c_int(n_threads))
    return codes2, qual, lengths


def pack_batch(seq: np.ndarray, qual: np.ndarray, offsets: np.ndarray,
               L: int, logp_table: np.ndarray, logp_floor: float = -1e30):
    """Dense [B, L] codes/logp/lengths from ragged reads (native scatter)."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(offsets) - 1
    codes = np.zeros((B, L), dtype=np.uint8)
    logp = np.zeros((B, L), dtype=np.float32)
    lengths = np.zeros(B, dtype=np.int32)
    off = np.ascontiguousarray(offsets, dtype=np.int64)
    tab = np.ascontiguousarray(logp_table, dtype=np.float64)
    lib.pack_batch(_ptr(seq), _ptr(qual), _ptr(off), ctypes.c_long(B),
                   ctypes.c_long(L), _ptr(tab), ctypes.c_float(logp_floor),
                   _ptr(codes), _ptr(logp), _ptr(lengths))
    return codes, logp, lengths


def format_mer_lines(keys: np.ndarray, cols_f: np.ndarray,
                     cols_r: np.ndarray, k: int, tail_zero: bool,
                     n_threads: int = 4) -> Optional[bytes]:
    """Native Meraculous dump: keys [M] u64 canonical kmers, cols_f/cols_r
    [M, ncols] int64 column values for the forward / revcomp lines.
    Emits both strand lines per kmer.  None if the lib is unavailable or
    keys are wide (k > 32 uses the numpy fallback)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "format_mer_lines") \
            or keys.dtype != np.uint64:
        return None
    M = len(keys)
    ncols = cols_f.shape[1]
    keys = np.ascontiguousarray(keys)
    cols_f = np.ascontiguousarray(cols_f, np.int64)
    cols_r = np.ascontiguousarray(cols_r, np.int64)
    dmax = len(str(int(max(cols_f.max(initial=0), cols_r.max(initial=0), 1))))
    cap = 2 * M * (k + 3 + ncols * (dmax + 1)) + 64
    out = np.empty(cap, np.uint8)
    n = lib.format_mer_lines(_ptr(keys), ctypes.c_long(M), ctypes.c_int(k),
                             _ptr(cols_f), _ptr(cols_r),
                             ctypes.c_int(ncols),
                             ctypes.c_int(1 if tail_zero else 0), _ptr(out),
                             ctypes.c_int(n_threads))
    if n <= 0 or n > cap:
        return None
    return out[:n].tobytes()


def kmer_observe(codes: np.ndarray, markup: np.ndarray, p: np.ndarray,
                 offsets: np.ndarray, k: int, n_threads: int = 0):
    """Native canonical-key + bit-exact-weight extraction (k <= 32).
    Returns (keys u64 [N], weights f64 [N]) in extract_kmers_flat order,
    or None when the native lib is unavailable."""
    if k > 32:
        return None
    lib = get_lib()
    if lib is None or not hasattr(lib, "kmer_observe"):
        return None
    n_threads = _threads(n_threads)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    mk = np.ascontiguousarray(markup, dtype=np.uint8)
    p = np.ascontiguousarray(p, dtype=np.float64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lens = offsets[1:] - offsets[:-1]
    nw = np.maximum(lens - k + 1, 0)
    woff = np.concatenate([[0], np.cumsum(nw)]).astype(np.int64)
    N = int(woff[-1])
    keys = np.empty(N, dtype=np.uint64)
    w = np.empty(N, dtype=np.float64)
    lib.kmer_observe.restype = ctypes.c_long
    got = lib.kmer_observe(
        _ptr(codes), _ptr(mk), _ptr(p), _ptr(offsets), _ptr(woff),
        ctypes.c_long(len(offsets) - 1), ctypes.c_int(k),
        _ptr(keys), _ptr(w), ctypes.c_int(n_threads))
    if got != N:
        return None
    return keys, w


def kmer_keys(codes: np.ndarray, offsets: np.ndarray, k: int,
              n_threads: int = 0):
    """Native canonical u64 window keys (k <= 32), extract_kmers_flat order;
    None when unavailable."""
    if k > 32:
        return None
    lib = get_lib()
    if lib is None or not hasattr(lib, "kmer_keys"):
        return None
    n_threads = _threads(n_threads)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    nw = np.maximum(offsets[1:] - offsets[:-1] - k + 1, 0)
    woff = np.concatenate([[0], np.cumsum(nw)]).astype(np.int64)
    N = int(woff[-1])
    keys = np.empty(N, dtype=np.uint64)
    lib.kmer_keys.restype = ctypes.c_long
    got = lib.kmer_keys(_ptr(codes), _ptr(offsets), _ptr(woff),
                        ctypes.c_long(len(offsets) - 1), ctypes.c_int(k),
                        _ptr(keys), ctypes.c_int(n_threads))
    if got != N:
        return None
    return keys


_RAW_PROB_TABLES = {}


def _raw_prob_table(input_base: int, min_quality: int,
                    output_base: int) -> np.ndarray:
    """256-entry P(correct) indexed by the RAW quality byte: the
    phred_probability table pre-composed with phred = raw - input_base
    (ref: src/Sequence.cpp:522-540)."""
    key = (input_base, min_quality, output_base)
    tab = _RAW_PROB_TABLES.get(key)
    if tab is None:
        from kmernator_tpu.ops.weights import phred_probability
        raw = np.arange(256, dtype=np.int16) - np.int16(input_base)
        tab = np.ascontiguousarray(
            phred_probability(raw, min_quality, output_base))
        _RAW_PROB_TABLES[key] = tab
    return tab


def observe_chunk(rs, k: int, min_quality: int, output_base: int,
                  min_kmer_quality: float, want_weights: bool = True,
                  n_threads: int = 0):
    """Fused native _chunk_observations core: raw seq/qual bytes -> canonical
    u64 keys, good mask (weight threshold AND NOT discarded), and optional
    f32 weights, all in one pass with no intermediate base-sized temps.
    Returns (keys u64 [N], good bool [N], w f32 [N] | None) or None when
    the native lib is unavailable / k > 32."""
    if k > 32:
        return None
    lib = get_lib()
    if lib is None or not hasattr(lib, "observe_chunk"):
        return None
    n_threads = _threads(n_threads)
    from kmernator_tpu.io.reads import BASE_CODE
    seq = np.ascontiguousarray(rs.seq, dtype=np.uint8)
    qual = np.ascontiguousarray(rs.qual, dtype=np.uint8)
    offsets = np.ascontiguousarray(rs.offsets, dtype=np.int64)
    disc = np.ascontiguousarray(rs.discarded, dtype=np.uint8)
    hq = np.ascontiguousarray(rs.has_quals, dtype=np.uint8)
    prob = _raw_prob_table(rs.input_qual_base, min_quality, output_base)
    nw = np.maximum(offsets[1:] - offsets[:-1] - k + 1, 0)
    woff = np.concatenate([[0], np.cumsum(nw)]).astype(np.int64)
    N = int(woff[-1])
    keys = np.empty(N, dtype=np.uint64)
    good = np.empty(N, dtype=np.uint8)
    w = np.empty(N, dtype=np.float32) if want_weights else None
    lib.observe_chunk.restype = ctypes.c_long
    got = lib.observe_chunk(
        _ptr(seq), _ptr(qual), _ptr(offsets), _ptr(woff), _ptr(disc),
        _ptr(hq), ctypes.c_long(len(offsets) - 1), ctypes.c_int(k),
        _ptr(BASE_CODE), _ptr(prob),
        ctypes.c_float(np.float32(min_kmer_quality)),
        _ptr(keys), _ptr(good),
        _ptr(w) if w is not None else None, ctypes.c_int(n_threads))
    if got != N:
        return None
    return keys, good.view(bool), w


def artifact_scan(codes: np.ndarray, offsets: np.ndarray, k: int,
                  start_hop: np.ndarray, byte_hops: np.ndarray,
                  table, phix_idx: int, n_threads: int = 0,
                  raw_ascii: bool = False):
    """Fused byte-hop artifact scan against a HashTable: per-read
    (value, min_hit, max_hit, was_phix) or None when unavailable.
    raw_ascii=True accepts the normalized ASCII sequence directly (bases
    map inline; non-ACGT scans as 'A'), skipping the caller's
    BASE_CODE gather + markup where over the whole chunk."""
    if k > 32 or table is None:
        return None
    lib = get_lib()
    if lib is None or not hasattr(lib, "artifact_scan"):
        return None
    n_threads = _threads(n_threads)
    n = len(offsets) - 1
    value = np.empty(n, np.int64)
    min_hit = np.empty(n, np.int64)
    max_hit = np.empty(n, np.int64)
    was_phix = np.empty(n, np.uint8)
    lib.artifact_scan(
        _ptr(np.ascontiguousarray(codes, np.uint8)),
        _ptr(np.ascontiguousarray(offsets, np.int64)),
        ctypes.c_long(n), ctypes.c_int(k),
        _ptr(np.ascontiguousarray(start_hop, np.int64)),
        _ptr(np.ascontiguousarray(byte_hops, np.int64)),
        _ptr(table.slots), ctypes.c_uint64(table.cap),
        ctypes.c_long(phix_idx),
        _ptr(value), _ptr(min_hit), _ptr(max_hit), _ptr(was_phix),
        ctypes.c_int(n_threads), ctypes.c_int(1 if raw_ascii else 0))
    return value, min_hit, max_hit, was_phix.view(bool)


def kmer_keys_from_seq(rs, k: int, n_threads: int = 0):
    """Canonical u64 window keys straight from the ReadSet's raw sequence
    bytes (no codes/markup temps); None when unavailable."""
    if k > 32:
        return None
    lib = get_lib()
    if lib is None or not hasattr(lib, "kmer_keys_raw"):
        return None
    n_threads = _threads(n_threads)
    from kmernator_tpu.io.reads import BASE_CODE
    seq = np.ascontiguousarray(rs.seq, dtype=np.uint8)
    offsets = np.ascontiguousarray(rs.offsets, dtype=np.int64)
    nw = np.maximum(offsets[1:] - offsets[:-1] - k + 1, 0)
    woff = np.concatenate([[0], np.cumsum(nw)]).astype(np.int64)
    N = int(woff[-1])
    keys = np.empty(N, dtype=np.uint64)
    lib.kmer_keys_raw.restype = ctypes.c_long
    got = lib.kmer_keys_raw(_ptr(seq), _ptr(offsets), _ptr(woff),
                            ctypes.c_long(len(offsets) - 1), ctypes.c_int(k),
                            _ptr(BASE_CODE), _ptr(keys),
                            ctypes.c_int(n_threads))
    if got != N:
        return None
    return keys


class HashTable:
    """Caller-owned open-addressing u64 -> i64 table (native probe loops).
    (key, val) interleave in one 16-byte slot so a probe costs one cache
    line, not two."""

    def __init__(self, keys: np.ndarray, vals: np.ndarray):
        lib = get_lib()
        if lib is None or not hasattr(lib, "hash_build2"):
            raise RuntimeError("native lib unavailable")
        m = len(keys)
        cap = 1
        while cap < max(2 * m, 16):
            cap <<= 1
        self.slots = np.empty(2 * cap, dtype=np.uint64)
        self.cap = cap
        if hasattr(lib, "hash_build2_mt"):
            lib.hash_build2_mt(_ptr(np.ascontiguousarray(keys, np.uint64)),
                               _ptr(np.ascontiguousarray(vals, np.int64)),
                               ctypes.c_long(m), _ptr(self.slots),
                               ctypes.c_uint64(cap),
                               ctypes.c_int(_threads(0)))
        else:
            lib.hash_build2(_ptr(np.ascontiguousarray(keys, np.uint64)),
                            _ptr(np.ascontiguousarray(vals, np.int64)),
                            ctypes.c_long(m), _ptr(self.slots),
                            ctypes.c_uint64(cap))

    @staticmethod
    def build_into(keys: np.ndarray, vals: np.ndarray, slots: np.ndarray):
        """Build the table into a caller-provided slots array (len = a
        power-of-two 2*cap, e.g. a writable memmap) — no intermediate
        allocation.  Raises RuntimeError when the native lib is missing."""
        lib = get_lib()
        if lib is None or not hasattr(lib, "hash_build2"):
            raise RuntimeError("native lib unavailable")
        m = len(keys)
        cap = len(slots) // 2
        if cap & (cap - 1) or cap < max(2 * m, 16):
            raise ValueError("slots must be 2*cap with pow2 cap >= 2m")
        if hasattr(lib, "hash_build2_mt"):
            lib.hash_build2_mt(_ptr(np.ascontiguousarray(keys, np.uint64)),
                               _ptr(np.ascontiguousarray(vals, np.int64)),
                               ctypes.c_long(m), _ptr(slots),
                               ctypes.c_uint64(cap),
                               ctypes.c_int(_threads(0)))
        else:
            lib.hash_build2(_ptr(np.ascontiguousarray(keys, np.uint64)),
                            _ptr(np.ascontiguousarray(vals, np.int64)),
                            ctypes.c_long(m), _ptr(slots),
                            ctypes.c_uint64(cap))

    @classmethod
    def from_slots(cls, slots: np.ndarray) -> "HashTable":
        """Wrap an existing slots array (e.g. a read-only memmap of a
        table another process built and .tofile'd) without rebuilding."""
        ht = cls.__new__(cls)
        ht.slots = slots
        ht.cap = len(slots) // 2
        return ht

    def lookup(self, query: np.ndarray, n_threads: int = 0) -> np.ndarray:
        lib = get_lib()
        n_threads = _threads(n_threads)
        q = np.ascontiguousarray(query, np.uint64)
        out = np.empty(len(q), dtype=np.int64)
        lib.hash_lookup2(_ptr(self.slots), ctypes.c_uint64(self.cap),
                         _ptr(q), _ptr(out), ctypes.c_long(len(q)),
                         ctypes.c_int(n_threads))
        return out


def make_hash(keys: np.ndarray, vals: np.ndarray):
    """HashTable or None (u64 keys only; wide 'S' keys use searchsorted)."""
    if keys.dtype != np.uint64 or get_lib() is None:
        return None
    try:
        return HashTable(keys, vals)
    except RuntimeError:
        return None


def quality_runs(phred: np.ndarray, has_quals: np.ndarray,
                 offsets: np.ndarray, min_quality: int, n_threads: int = 0):
    """Native per-read best/second-best quality runs; None if unavailable.
    Returns (best_off, best_len, sec_off, sec_len) int64 arrays."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "quality_runs"):
        return None
    n_threads = _threads(n_threads)
    n = len(offsets) - 1
    ph = np.ascontiguousarray(phred, np.int16)
    hq = np.ascontiguousarray(has_quals, np.uint8)
    off = np.ascontiguousarray(offsets, np.int64)
    outs = [np.empty(n, np.int64) for _ in range(4)]
    lib.quality_runs(_ptr(ph), _ptr(hq), _ptr(off), ctypes.c_long(n),
                     ctypes.c_int(int(min_quality)),
                     _ptr(outs[0]), _ptr(outs[1]), _ptr(outs[2]),
                     _ptr(outs[3]), ctypes.c_int(n_threads))
    return tuple(outs)


def artifact_keys(codes: np.ndarray, offsets: np.ndarray, k: int,
                  hmax: int, n_threads: int = 0):
    """Native canonical u64 keys at byte-aligned hops -> [n, hmax]
    (inactive cells = ~0, guaranteed table miss); None if unavailable."""
    if k > 32:
        return None
    lib = get_lib()
    if lib is None or not hasattr(lib, "artifact_keys"):
        return None
    n_threads = _threads(n_threads)
    n = len(offsets) - 1
    cd = np.ascontiguousarray(codes, np.uint8)
    off = np.ascontiguousarray(offsets, np.int64)
    out = np.empty((n, hmax), np.uint64)
    lib.artifact_keys(_ptr(cd), _ptr(off), ctypes.c_long(n),
                      ctypes.c_int(k), ctypes.c_long(hmax), _ptr(out),
                      ctypes.c_int(n_threads))
    return out


def spill_count(keys: np.ndarray, min_depth: int):
    """Native unweighted spill-part counting: hash-count + sorted uniques.
    Returns (keys u64 [m], counts i32 [m]) sorted by key, or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "spill_count") \
            or keys.dtype != np.uint64:
        return None
    n = len(keys)
    ok = np.empty(n, np.uint64)
    oc = np.empty(n, np.int32)
    lib.spill_count.restype = ctypes.c_long
    m = lib.spill_count(_ptr(np.ascontiguousarray(keys)), ctypes.c_long(n),
                        ctypes.c_int(int(min_depth)), _ptr(ok), _ptr(oc))
    if m < 0:
        return None
    return ok[:m].copy(), oc[:m].copy()


def compact_good(keys: np.ndarray, good: np.ndarray, weights=None,
                 out_keys: np.ndarray = None, out_w: np.ndarray = None):
    """Native keys[good] (and weights[good]) into reusable buffers —
    numpy's boolean fancy-index allocates a fresh array per chunk, which
    measured 9.9 core-s of page faults over a 1 GiB streaming pass 1.
    Returns (gk view, gw view | None) or None when unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "compact_good") \
            or keys.dtype != np.uint64:
        return None
    n = len(keys)
    if out_keys is None or len(out_keys) < n:
        out_keys = np.empty(n, np.uint64)
    has_w = weights is not None
    if has_w and (out_w is None or len(out_w) < n):
        out_w = np.empty(n, np.float32)
    lib.compact_good.restype = ctypes.c_long
    m = lib.compact_good(
        _ptr(np.ascontiguousarray(keys)),
        _ptr(np.ascontiguousarray(good, np.uint8)), ctypes.c_long(n),
        _ptr(np.ascontiguousarray(weights, np.float32)) if has_w else None,
        _ptr(out_keys), _ptr(out_w) if has_w else None)
    return out_keys[:m], (out_w[:m] if has_w else None), out_keys, out_w


class SharedCountTable:
    """Anonymous-shared-mmap CAS count table for the streaming pass 1:
    create in the parent BEFORE the pool forks, then every worker
    inserts into the ONE table (native shct_insert; the reference's
    shared bucket map, src/Kmer.h:2161-2299, re-done for fork workers).
    Empty cells are 0 ({key+1, count} slots), so the kernel's lazy zero
    pages are the initialized table — untouched slots cost no RSS.

    insert() returns the consumed prefix length; less than len(keys)
    means the table hit its load stop and the caller must divert the
    remainder to its private spill counter (exactness: the final table
    export merges with spilled partials)."""

    HDR = 8  # u64s reserved for {used, stop} + cacheline padding

    def __init__(self, cap_slots: int):
        lib = get_lib()
        if lib is None or not hasattr(lib, "shct_insert"):
            raise RuntimeError("native shared count table unavailable")
        self._lib = lib
        lib.shct_insert.restype = ctypes.c_long
        lib.shct_export.restype = ctypes.c_long
        cap = 1 << 14
        while cap < cap_slots:
            cap <<= 1
        self.cap = cap
        import mmap
        self._mm = mmap.mmap(-1, (self.HDR + 2 * cap) * 8)
        self._arr = np.frombuffer(self._mm, dtype=np.uint64)
        self._hdr = self._arr[:self.HDR]
        self._slots = self._arr[self.HDR:]
        self._hdr[1] = int(cap * 0.60)  # load stop

    def used(self) -> int:
        return int(self._hdr[0])

    def insert(self, keys: np.ndarray) -> int:
        return self._lib.shct_insert(
            _ptr(self._hdr), _ptr(self._slots), ctypes.c_ulonglong(self.cap),
            _ptr(np.ascontiguousarray(keys, np.uint64)),
            ctypes.c_long(len(keys)))

    def export(self, n_threads: int = 0):
        """(keys u64 [m], counts u32 [m]) over all occupied slots,
        range-scanned in parallel."""
        import threading
        n_threads = max(1, _threads(n_threads))
        n = self.used() + 64  # claimed-but-mid-increment slack
        bounds = [self.cap * t // n_threads for t in range(n_threads + 1)]
        outs = [None] * n_threads

        def scan(t):
            lo, hi = bounds[t], bounds[t + 1]
            ko = np.empty(min(n, hi - lo), np.uint64)
            co = np.empty(min(n, hi - lo), np.uint32)
            m = self._lib.shct_export(
                _ptr(self._slots), ctypes.c_ulonglong(lo),
                ctypes.c_ulonglong(hi), _ptr(ko), _ptr(co))
            outs[t] = (ko[:m], co[:m])

        if n_threads == 1:
            scan(0)
        else:
            ts = [threading.Thread(target=scan, args=(t,))
                  for t in range(n_threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        return (np.concatenate([o[0] for o in outs]),
                np.concatenate([o[1] for o in outs]))

    def close(self):
        if self._mm is not None:
            self._arr = self._hdr = self._slots = None
            self._mm.close()
            self._mm = None


class ObservationAggregator:
    """Persistent native open-addressing aggregator for the streaming
    pass-1: key -> (count u32, wsum f64).  insert() consumes a key batch
    until the load cap, signalling the caller to flush via export()
    (exact counts: flushed partials re-merge at finalize).  Mirrors the
    reference's spill-under-pressure build
    (ref: src/KmerSpectrum.h:1818-1902)."""

    def __init__(self, cap_slots: int, track_weights: bool,
                 zero_empty: bool = False):
        """zero_empty=True stores key+1 with 0 = empty so the table is
        born initialized from lazy zero pages (no eager sentinel fill).
        Only valid when keys can never be ~0ULL — canonical k <= 31
        keys are < 2^62, so their +1 never wraps to the sentinel."""
        lib = get_lib()
        if lib is None or not hasattr(lib, "agg_create"):
            raise RuntimeError("native aggregator unavailable")
        self._lib = lib
        lib.agg_create.restype = ctypes.c_void_p
        lib.agg_insert.restype = ctypes.c_long
        lib.agg_export.restype = ctypes.c_long
        lib.agg_used.restype = ctypes.c_long
        if zero_empty and hasattr(lib, "agg_create2"):
            lib.agg_create2.restype = ctypes.c_void_p
            self._h = ctypes.c_void_p(lib.agg_create2(
                ctypes.c_long(int(cap_slots)),
                ctypes.c_int(1 if track_weights else 0), ctypes.c_int(1)))
        else:
            zero_empty = False
            self._h = ctypes.c_void_p(lib.agg_create(
                ctypes.c_long(int(cap_slots)),
                ctypes.c_int(1 if track_weights else 0)))
        self.zero_empty = zero_empty
        self.track_weights = track_weights
        # cap at 65% load: linear probing stays short and export slack
        # is deterministic
        cap = 1 << 14
        while cap < cap_slots:
            cap <<= 1
        self.cap = cap
        self.stop_used = int(cap * 0.65)

    def insert(self, keys: np.ndarray, weights=None) -> int:
        """Insert a prefix of keys; returns how many were consumed.  When
        the return is < len(keys), export() then re-insert the rest."""
        n = len(keys)
        w = np.ascontiguousarray(weights, np.float32) \
            if (weights is not None and self.track_weights) \
            else np.zeros(0, np.float32)
        return self._lib.agg_insert(
            self._h, _ptr(np.ascontiguousarray(keys)), _ptr(w),
            ctypes.c_long(n), ctypes.c_long(self.stop_used))

    def insert_bucketed(self, keys: np.ndarray) -> int:
        """Radix-bucketed insert (no-weights tables only): keys must be a
        PRIVATE writable u64 array.  Returns how many keys remain
        unconsumed — they are compacted to keys[:rem]; export() then
        re-call with keys[:rem].  Falls back to -1 when unavailable.

        Measured NEGATIVE on the dev host (260 MiB L3 keeps the table
        cache-resident already — see native agg_insert_bucketed); kept
        with unit coverage, not wired into the spill path."""
        if self.track_weights or not hasattr(self._lib,
                                             "agg_insert_bucketed"):
            return -1
        self._lib.agg_insert_bucketed.restype = ctypes.c_long
        return self._lib.agg_insert_bucketed(
            self._h, _ptr(keys), ctypes.c_long(len(keys)),
            ctypes.c_long(self.stop_used))

    def insert_counted(self, keys: np.ndarray, cnts: np.ndarray,
                       wsums=None):
        """Merge pre-aggregated (key, count[, wsum]) records with no load
        stop — used to migrate a smaller table's export when growing."""
        if self.track_weights and wsums is None:
            # a 0-length array's non-NULL data pointer would defeat the
            # C side's `wsums ? wsums[i] : 0.0` guard and read OOB
            w_ptr = ctypes.c_void_p(None)
        else:
            w = np.ascontiguousarray(wsums, np.float64) \
                if (wsums is not None and self.track_weights) \
                else np.zeros(0, np.float64)
            w_ptr = _ptr(w)
        self._lib.agg_insert_counted(
            self._h, _ptr(np.ascontiguousarray(keys)),
            _ptr(np.ascontiguousarray(cnts, np.uint32)), w_ptr,
            ctypes.c_long(len(keys)))

    def used(self) -> int:
        return self._lib.agg_used(self._h)

    def export(self):
        """(keys u64 [m], counts u32 [m], wsums f64 [m]|None), clearing
        the table."""
        m_cap = self.used()
        ko = np.empty(m_cap, np.uint64)
        co = np.empty(m_cap, np.uint32)
        wo = np.empty(m_cap, np.float64) if self.track_weights \
            else np.zeros(0, np.float64)
        m = self._lib.agg_export(self._h, _ptr(ko), _ptr(co), _ptr(wo))
        return (ko[:m], co[:m],
                (wo[:m] if self.track_weights else None))

    def close(self):
        if self._h:
            self._lib.agg_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def spill_route_agg(keys: np.ndarray, cnts: np.ndarray, wsums,
                    splitters: np.ndarray):
    """Native range-partition routing of aggregated (key, count[, wsum])
    records (8+4[+8] bytes).  Returns (rec_bytes u8, part_off i64 [P+1])
    or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "spill_route_agg") \
            or keys.dtype != np.uint64:
        return None
    n = len(keys)
    P = len(splitters) + 1
    has_w = wsums is not None
    rb = 20 if has_w else 12
    out = np.empty(n * rb, np.uint8)
    part_off = np.empty(P + 1, np.int64)
    warr = np.ascontiguousarray(wsums, np.float64) if has_w else \
        np.zeros(0, np.float64)
    lib.spill_route_agg.restype = ctypes.c_long
    lib.spill_route_agg(_ptr(np.ascontiguousarray(keys)),
                        _ptr(np.ascontiguousarray(cnts, np.uint32)),
                        _ptr(warr), ctypes.c_int(1 if has_w else 0),
                        ctypes.c_long(n),
                        _ptr(np.ascontiguousarray(splitters, np.uint64)),
                        ctypes.c_int(P), _ptr(out), _ptr(part_off))
    return out, part_off


def spill_count_agg(keys: np.ndarray, cnts: np.ndarray, min_depth: int):
    """Native hash-merge of aggregated (key, count) records.  Returns
    (keys u64 [m], counts i32 [m]) sorted by key, or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "spill_count_agg") \
            or keys.dtype != np.uint64:
        return None
    n = len(keys)
    ok = np.empty(n, np.uint64)
    oc = np.empty(n, np.int32)
    lib.spill_count_agg.restype = ctypes.c_long
    m = lib.spill_count_agg(_ptr(np.ascontiguousarray(keys)),
                            _ptr(np.ascontiguousarray(cnts, np.uint32)),
                            ctypes.c_long(n), ctypes.c_int(int(min_depth)),
                            _ptr(ok), _ptr(oc))
    if m < 0:
        return None
    return ok[:m].copy(), oc[:m].copy()


def radix_sort_kcw(keys: np.ndarray, cnts: np.ndarray, wsums=None):
    """In-place LSD radix sort of aggregated (key u64, count u32[,
    wsum f64]) records by key.  Arrays must be contiguous and writable.
    Returns True, or False when the native lib is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "radix_sort_kcw") \
            or keys.dtype != np.uint64:
        return False
    n = len(keys)
    has_w = wsums is not None
    tk = np.empty(n, np.uint64)
    tc = np.empty(n, np.uint32)
    tw = np.empty(n if has_w else 0, np.float64)
    lib.radix_sort_kcw(_ptr(keys), _ptr(cnts),
                       _ptr(wsums) if has_w else _ptr(tw),
                       ctypes.c_long(n), ctypes.c_int(1 if has_w else 0),
                       _ptr(tk), _ptr(tc), _ptr(tw))
    return True


def merge_sum_runs(runs, min_depth: int, track_weights: bool):
    """Merge R sorted unique-keyed runs [(k, c, w|None), ...], summing
    counts/wsums of equal keys and dropping summed counts < min_depth.
    Returns (keys u64, counts i32, wsums f64|None) or None when the
    native lib is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "merge_sum_runs") or not runs:
        return None
    R = len(runs)
    ks = [np.ascontiguousarray(r[0], np.uint64) for r in runs]
    cs = [np.ascontiguousarray(r[1], np.uint32) for r in runs]
    ws = [np.ascontiguousarray(r[2], np.float64) if track_weights
          else np.zeros(0, np.float64) for r in runs]
    lens = np.array([len(a) for a in ks], np.int64)
    total = int(lens.sum())
    kp = (ctypes.c_void_p * R)(*[a.ctypes.data for a in ks])
    cp = (ctypes.c_void_p * R)(*[a.ctypes.data for a in cs])
    wp = (ctypes.c_void_p * R)(*[a.ctypes.data for a in ws])
    ko = np.empty(total, np.uint64)
    co = np.empty(total, np.int32)
    wo = np.empty(total if track_weights else 0, np.float64)
    lib.merge_sum_runs.restype = ctypes.c_long
    m = lib.merge_sum_runs(kp, cp, wp, _ptr(lens), ctypes.c_int(R),
                           ctypes.c_int(int(min_depth)),
                           ctypes.c_int(1 if track_weights else 0),
                           _ptr(ko), _ptr(co), _ptr(wo))
    if m < 0:
        return None
    return (ko[:m].copy(), co[:m].copy(),
            wo[:m].copy() if track_weights else None)


def spill_route(keys: np.ndarray, weights, splitters: np.ndarray):
    """Native range-partition routing: records grouped by part (input
    order preserved within parts).  Returns (rec_bytes ndarray u8,
    part_off i64 [P+1]) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "spill_route") \
            or keys.dtype != np.uint64:
        return None
    n = len(keys)
    P = len(splitters) + 1
    has_w = weights is not None
    rb = 12 if has_w else 8
    out = np.empty(n * rb, np.uint8)
    part_off = np.empty(P + 1, np.int64)
    warr = np.ascontiguousarray(weights, np.float32) if has_w else \
        np.zeros(0, np.float32)
    lib.spill_route.restype = ctypes.c_long
    lib.spill_route(_ptr(np.ascontiguousarray(keys)), _ptr(warr),
                    ctypes.c_int(1 if has_w else 0), ctypes.c_long(n),
                    _ptr(np.ascontiguousarray(splitters, np.uint64)),
                    ctypes.c_int(P), _ptr(out), _ptr(part_off))
    return out, part_off


_SCORE_TYPES = {"MEDIAN": 0, "MIN": 1, "MAX": 2, "SUM": 3}


def score_trim(counts: np.ndarray, woff: np.ndarray, nk: np.ndarray,
               min_score: float, scoring_type: str, n_threads: int = 0):
    """Native longest-run trim + run score; None if unavailable or the
    scoring type needs numpy's fp summation order (AVG)."""
    lib = get_lib()
    t = _SCORE_TYPES.get(scoring_type)
    if lib is None or not hasattr(lib, "score_trim") or t is None:
        return None
    n_threads = _threads(n_threads)
    n = len(woff) - 1
    off = np.empty(n, np.int64)
    ln = np.empty(n, np.int64)
    sc = np.empty(n, np.float64)
    lib.score_trim(_ptr(np.ascontiguousarray(counts, np.int64)),
                   _ptr(np.ascontiguousarray(woff, np.int64)),
                   ctypes.c_long(n),
                   _ptr(np.ascontiguousarray(nk, np.int64)),
                   ctypes.c_double(float(min_score)), ctypes.c_int(t),
                   _ptr(off), _ptr(ln), _ptr(sc), ctypes.c_int(n_threads))
    return off, ln, sc


def format_fastq(rs, idxs, toff, tlen, hdrs, output_base: int, fastq: bool,
                 n_threads: int = 0):
    """Native FASTQ/FASTA record assembly for format_reads_batch.
    hdrs: list of per-record header bytes, or a prebuilt
    (hdr_flat u8 array, hlen i64 array) pair.  Returns bytes or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "format_fastq"):
        return None
    n_threads = _threads(n_threads)
    n = len(idxs)
    idxs = np.ascontiguousarray(idxs, np.int64)
    off0 = rs.offsets[idxs]
    L = rs.offsets[idxs + 1] - off0
    to = np.ascontiguousarray(toff, np.int64)
    tl0 = np.ascontiguousarray(tlen, np.int64)
    tl = np.minimum(tl0, L - to)
    use_n = rs.discarded[idxs] | (tl0 <= 1) | (tl <= 1)
    blen = np.where(use_n, 1, tl)
    if isinstance(hdrs, tuple):
        hdr_flat, hlen = hdrs
    else:
        hlen = np.fromiter((len(h) for h in hdrs), np.int64, n)
        hdr_flat = np.frombuffer(b"".join(hdrs), np.uint8)
    hdr_off = np.concatenate([[0], np.cumsum(hlen)]).astype(np.int64)
    rec_len = 3 + hlen + blen + ((3 + blen) if fastq else 0)
    out_off = np.concatenate([[0], np.cumsum(rec_len)]).astype(np.int64)
    out = np.empty(int(out_off[-1]), np.uint8)
    lib.format_fastq(
        _ptr(np.ascontiguousarray(rs.seq)),
        _ptr(np.ascontiguousarray(rs.phred(), np.int16)),
        _ptr(np.ascontiguousarray(rs.offsets, np.int64)),
        _ptr(idxs), ctypes.c_long(n),
        _ptr(to), _ptr(tl0),
        _ptr(np.ascontiguousarray(rs.discarded[idxs], np.uint8)),
        _ptr(np.ascontiguousarray(rs.has_quals[idxs], np.uint8)),
        _ptr(hdr_off), _ptr(np.ascontiguousarray(hdr_flat, np.uint8)),
        _ptr(out_off), ctypes.c_int(int(output_base)),
        ctypes.c_int(1 if fastq else 0), _ptr(out),
        ctypes.c_int(n_threads))
    return out.tobytes()


class ByteRows:
    """Columnar list-of-bytes: flat u8 buffer + [n+1] offsets.  Quacks like
    a list of bytes via __getitem__ (compat for scalar consumers) while the
    hot paths use .flat/.off directly."""

    __slots__ = ("flat", "off")

    def __init__(self, flat: np.ndarray, off: np.ndarray):
        self.flat = flat
        self.off = off

    def __len__(self):
        return len(self.off) - 1

    def __getitem__(self, i):
        return self.flat[self.off[i]:self.off[i + 1]].tobytes()

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other):
        if isinstance(other, ByteRows):
            return (np.array_equal(self.off, other.off)
                    and np.array_equal(self.flat[:self.off[-1]],
                                       other.flat[:other.off[-1]]))
        try:
            if len(other) != len(self):
                return False
            return all(a == b for a, b in zip(self, other))
        except TypeError:
            return NotImplemented

    __hash__ = None

    def lengths(self) -> np.ndarray:
        return self.off[1:] - self.off[:-1]

    def gather(self, idxs: np.ndarray) -> "ByteRows":
        idxs = np.asarray(idxs, np.int64)
        lens = (self.off[idxs + 1] - self.off[idxs]).astype(np.int64)
        out_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        out = gather_ragged(self.flat, self.off[idxs].astype(np.int64), lens)
        if out is None:  # numpy fallback
            src = (np.arange(int(out_off[-1])) - np.repeat(out_off[:-1], lens)
                   + np.repeat(self.off[idxs], lens))
            out = self.flat[src]
        return ByteRows(out, out_off)


def render_labels(t_off: np.ndarray, t_len: np.ndarray, int_sc: np.ndarray,
                  was_trimmed: np.ndarray, discarded: np.ndarray,
                  slabel: bytes):
    """Native per-read trim-label rendering -> ByteRows, or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "render_labels"):
        return None
    n = len(t_off)
    lflat = np.empty(n * (len(slabel) + 64), np.uint8)
    loff = np.empty(n + 1, np.int64)
    sl = np.frombuffer(slabel, np.uint8)
    lib.render_labels.restype = ctypes.c_long
    total = lib.render_labels(
        ctypes.c_long(n),
        _ptr(np.ascontiguousarray(t_off, np.int64)),
        _ptr(np.ascontiguousarray(t_len, np.int64)),
        _ptr(np.ascontiguousarray(int_sc, np.int64)),
        _ptr(np.ascontiguousarray(was_trimmed, np.uint8)),
        _ptr(np.ascontiguousarray(discarded, np.uint8)),
        _ptr(sl), ctypes.c_int(len(slabel)), _ptr(lflat), _ptr(loff))
    return ByteRows(lflat[:total].copy(), loff)


def build_headers(idxs: np.ndarray, nm2d: np.ndarray, nlen: np.ndarray,
                  cm2d, clen, labels_sel: ByteRows, n_threads: int = 0):
    """Native header assembly (name [+ ' ' + comment] [+ ' ' + label]) for
    the selected records -> (hdr_flat u8, hlen i64), or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "build_headers"):
        return None
    n_threads = _threads(n_threads)
    idxs = np.ascontiguousarray(idxs, np.int64)
    n = len(idxs)
    nlen = np.ascontiguousarray(nlen, np.int64)
    llen = labels_sel.lengths()
    hlen = nlen[idxs] + np.where(llen > 0, llen + 1, 0)
    if cm2d is not None:
        clen = np.ascontiguousarray(clen, np.int64)
        hlen = hlen + np.where(clen[idxs] > 0, clen[idxs] + 1, 0)
    hdr_off = np.concatenate([[0], np.cumsum(hlen)]).astype(np.int64)
    hdr_flat = np.empty(int(hdr_off[-1]), np.uint8)
    lib.build_headers(
        ctypes.c_long(n), _ptr(idxs),
        _ptr(np.ascontiguousarray(nm2d)), ctypes.c_long(nm2d.shape[1]),
        _ptr(nlen),
        _ptr(np.ascontiguousarray(cm2d)) if cm2d is not None else None,
        ctypes.c_long(cm2d.shape[1] if cm2d is not None else 0),
        _ptr(clen) if cm2d is not None else None,
        _ptr(labels_sel.flat), _ptr(labels_sel.off),
        _ptr(hdr_off), _ptr(hdr_flat), ctypes.c_int(n_threads))
    return hdr_flat, hlen.astype(np.int64)


def gather_ragged(data: np.ndarray, offs: np.ndarray, lens: np.ndarray,
                  n_threads: int = 0):
    """Concatenate data[offs[i] : offs[i]+lens[i]] natively; None if the
    lib is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "gather_ragged"):
        return None
    n_threads = _threads(n_threads)
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    out_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    out = np.empty(int(out_off[-1]), np.uint8)
    lib.gather_ragged(_ptr(np.ascontiguousarray(data, np.uint8)),
                      _ptr(offs), _ptr(lens), ctypes.c_long(len(offs)),
                      _ptr(out_off), _ptr(out), ctypes.c_int(n_threads))
    return out


def gather_ragged_map(data: np.ndarray, offs: np.ndarray, lens: np.ndarray,
                      table: np.ndarray):
    """gather_ragged with a 256-entry byte map fused into the copy (the
    FASTQ parser's base normalization); None if unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "gather_ragged_map"):
        return None
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    out = np.empty(int(lens.sum()), np.uint8)
    lib.gather_ragged_map(_ptr(np.ascontiguousarray(data, np.uint8)),
                          _ptr(offs), _ptr(lens), ctypes.c_long(len(offs)),
                          _ptr(np.ascontiguousarray(table, np.uint8)),
                          _ptr(out))
    return out


def find_newlines(buf: np.ndarray):
    """Positions of '\\n' in buf (i64) via memchr — the numpy
    flatnonzero(buf == 0x0a) scan costs ~150 ms per 16 MB chunk; this is
    ~10 ms.  None if the lib is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "find_newlines"):
        return None
    buf = np.ascontiguousarray(buf, np.uint8)
    lib.find_newlines.restype = ctypes.c_long
    # FASTQ lines are tens of bytes; size for 1-in-16 density and retry
    # exact only if the scan filled the buffer (possible truncation)
    for cap in (len(buf) // 16 + 16, len(buf) + 1):
        out = np.empty(cap, np.int64)
        m = lib.find_newlines(_ptr(buf), ctypes.c_long(len(buf)),
                              _ptr(out), ctypes.c_long(cap))
        if m < cap:
            return out[:m]
    return out[:m]

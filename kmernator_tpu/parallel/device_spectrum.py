"""Device k-mer spectrum pipeline.

The hot path of the framework: canonical k-mer window extraction, quality
weighting, and counting as ONE jitted XLA program over dense padded batches.
This replaces the reference's per-read scalar hot loop
(KmerArrayPair::build + KmerSpectrum::append,
ref: src/Kmer.h:1323-1375, src/KmerSpectrum.h:1578-1668) with:

  pack16 shifts  ->  [B, NW, W] window words   (bit ops)
  revcomp/min    ->  canonical keys            (bit ops)
  log-prob cumsum->  window weights            (scan)
  multi-key sort ->  runs of equal keys        (XLA sort)
  segment sums   ->  counts                    (scans)
  scatter        ->  per-window counts back in read order

Everything is fixed-shape: invalid (padding) windows carry the sentinel key
(0xFFFFFFFF per word) and sort to the end.

The weight fast path uses float32 log-probabilities (sliding sums); the
discard rule w > min is evaluated in log space.  This is count-equivalent to
the reference's double recurrence for all practical data; the bit-exact host
recurrence (ops/weights.py) remains the golden-test path.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from kmernator_tpu.ops.kmer import (last_word_mask, nwords, pack16,
                                    revcomp_words, shift_left_words, words_less)

SENTINEL = np.uint32(0xFFFFFFFF)


# --------------------------------------------------------------------------
# batch packing (host -> device layout)
# --------------------------------------------------------------------------

MESH_BATCH_READS = 2048


def auto_mesh_batch() -> int:
    """Reads per device batch for the streaming/mesh pipelines:
    KMTPU_MESH_BATCH when set, else 2048 on every backend.  On an H100
    (700 W) 2048 reads counted 1.6x the k-mers/s of the power-of-two
    aligned batch (1092) at L=150 and 3% fewer than it (1872) at L=100:
    the rate follows the windows per batch, not the sort's padding."""
    import os
    env = os.environ.get("KMTPU_MESH_BATCH", "")
    return int(env) if env else MESH_BATCH_READS


def pack_readset(rs, L: int, min_quality: int, output_base: int):
    """ReadSet -> (codes [B, L] uint8, logp [B, L] f32, lengths [B] i32).

    logp is log2(P(correct)) with -inf (here: -1e30) for zero-probability
    bases; markup positions also get -inf so windows covering them weigh 0
    (ref: KmerReadUtils.h:214-219).
    """
    from kmernator_tpu.io.reads import BASE_CODE
    from kmernator_tpu.ops.weights import probability_table

    B = rs.n
    codes = np.zeros((B, L), dtype=np.uint8)
    logp = np.full((B, L), np.float32(-1e30), dtype=np.float32)
    lengths = rs.lengths().astype(np.int32)
    tab = probability_table(min_quality, output_base)
    with np.errstate(divide="ignore"):
        ltab = np.where(tab > 0, np.log2(tab, where=tab > 0), -1e30).astype(np.float32)
    ph = rs.phred()
    hq = np.repeat(rs.has_quals, rs.lengths())
    ch = np.clip(ph + output_base, 0, 255)
    lp_flat = np.where(hq, ltab[ch], np.float32(0.0)).astype(np.float32)
    c_raw = BASE_CODE[rs.seq]
    markup = c_raw == 4
    c_flat = np.where(markup, 0, c_raw).astype(np.uint8)
    lp_flat = np.where(markup, np.float32(-1e30), lp_flat)
    dis = np.repeat(rs.discarded, rs.lengths())
    lp_flat = np.where(dis, np.float32(-1e30), lp_flat)
    lens = np.diff(rs.offsets)
    rows = np.repeat(np.arange(B), lens)
    cols = np.arange(int(rs.offsets[-1])) - np.repeat(rs.offsets[:-1], lens)
    codes[rows, cols] = c_flat
    logp[rows, cols] = lp_flat
    return codes, logp, lengths


# --------------------------------------------------------------------------
# jitted device steps
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("k",))
def extract_canonical(codes: jax.Array, lengths: jax.Array, k: int):
    """[B, L] codes -> (canon [B, NW, W] u32, is_fwd [B, NW], valid [B, NW])."""
    B, L = codes.shape
    W = nwords(k)
    NW = L - k + 1
    p16 = pack16(jnp, codes.astype(jnp.uint32))
    parts = []
    for w in range(W):
        start = 16 * w
        if start + NW <= L:
            sl = jax.lax.dynamic_slice_in_dim(p16, start, NW, axis=1)
        else:
            pad = jnp.zeros((B, start + NW - L), dtype=jnp.uint32)
            sl = jnp.concatenate([p16[:, start:], pad], axis=1)
        parts.append(sl)
    fwd = jnp.stack(parts, axis=-1)
    fwd = fwd.at[..., W - 1].set(fwd[..., W - 1] & np.uint32(last_word_mask(k)))
    rc = revcomp_words(jnp, fwd, k)
    fwd_le = ~words_less(jnp, rc, fwd)
    canon = jnp.where(fwd_le[..., None], fwd, rc)
    pos = jnp.arange(NW, dtype=jnp.int32)[None, :]
    valid = pos <= (lengths[:, None] - k)
    canon = jnp.where(valid[..., None], canon, SENTINEL)
    return canon, fwd_le, valid


@functools.partial(jax.jit, static_argnames=("k", "log2_min_weight"))
def window_good(logp: jax.Array, lengths: jax.Array, k: int,
                log2_min_weight: float):
    """Window weight (log2) and goodness test via sliding sums."""
    B, L = logp.shape
    NW = L - k + 1
    cs = jnp.cumsum(logp.astype(jnp.float32), axis=1)
    zero = jnp.zeros((B, 1), dtype=jnp.float32)
    cs = jnp.concatenate([zero, cs], axis=1)
    wsum = cs[:, k:] - cs[:, :-k]  # [B, NW]
    pos = jnp.arange(NW, dtype=jnp.int32)[None, :]
    valid = pos <= (lengths[:, None] - k)
    good = (wsum > jnp.float32(log2_min_weight)) & valid
    return wsum, good


def _flatten_keys(canon):
    B, NW, W = canon.shape
    return canon.reshape(B * NW, W)


def _shift_left_cols(cols, s_bases: int):
    """shift_left_words over a list of word columns (structure-of-arrays)."""
    Wn = len(cols)
    word_shift, bit = divmod(s_bases, 16)
    z = jnp.zeros_like(cols[0])
    if word_shift:
        cols = list(cols[word_shift:]) + [z] * word_shift
    if bit:
        out = []
        for i in range(Wn):
            nxt = cols[i + 1] if i + 1 < Wn else z
            out.append((cols[i] << jnp.uint32(2 * bit)) |
                       (nxt >> jnp.uint32(32 - 2 * bit)))
        cols = out
    return cols


@functools.partial(jax.jit, static_argnames=("k",))
def extract_canonical_cols(codes: jax.Array, lengths: jax.Array, k: int):
    """Structure-of-arrays twin of extract_canonical: returns the canonical
    key as W separate [B, NW] u32 arrays instead of one [B, NW, W] stack,
    so no array has the tiny W axis as its minor dimension."""
    B, L = codes.shape
    W = nwords(k)
    NW = L - k + 1
    from kmernator_tpu.ops.kmer import _reverse_bases_u32
    p16 = pack16(jnp, codes.astype(jnp.uint32))
    fwd = []
    for w in range(W):
        start = 16 * w
        if start + NW <= L:
            sl = jax.lax.dynamic_slice_in_dim(p16, start, NW, axis=1)
        else:
            pad = jnp.zeros((B, start + NW - L), dtype=jnp.uint32)
            sl = jnp.concatenate([p16[:, start:], pad], axis=1)
        fwd.append(sl)
    mask = np.uint32(last_word_mask(k))
    fwd[W - 1] = fwd[W - 1] & mask
    rc = [_reverse_bases_u32(jnp, (~fwd[w]) & jnp.uint32(0xFFFFFFFF))
          for w in range(W - 1, -1, -1)]
    rc = _shift_left_cols(rc, 16 * W - k)
    rc[W - 1] = rc[W - 1] & mask
    lt = rc[W - 1] < fwd[W - 1]
    for w in range(W - 2, -1, -1):
        lt = jnp.where(rc[w] == fwd[w], lt, rc[w] < fwd[w])
    fwd_le = ~lt
    pos = jnp.arange(NW, dtype=jnp.int32)[None, :]
    valid = pos <= (lengths[:, None] - k)
    canon = [jnp.where(valid, jnp.where(fwd_le, fwd[w], rc[w]), SENTINEL)
             for w in range(W)]
    return canon, fwd_le, valid


def _run_counts_scan(skeys, sgood):
    """Per-element count of good observations in the element's key run,
    using only scans over the sorted order (no scatter/gather).

    Returns (boundary, cnt) where cnt[i] = total good in the run containing
    sorted position i."""
    N, W = skeys.shape
    neq = jnp.zeros(N - 1, dtype=jnp.bool_)
    for w in range(W):
        neq = neq | (skeys[1:, w] != skeys[:-1, w])
    boundary = jnp.concatenate([jnp.ones(1, jnp.bool_), neq])
    gcum = jnp.cumsum(sgood.astype(jnp.int32))          # inclusive
    gexcl = gcum - sgood.astype(jnp.int32)              # exclusive
    # good-count before the run start: gexcl at boundaries is nondecreasing,
    # so a running max broadcasts it through the run without a gather
    run_base = jax.lax.cummax(jnp.where(boundary, gexcl, jnp.int32(-1)))
    # total good in run = (gcum at run end) - run_base; the run end's gcum
    # broadcasts backward via a reverse cummin of (gcum at last-of-run)
    is_end = jnp.concatenate([boundary[1:], jnp.ones(1, jnp.bool_)])
    run_total = jax.lax.cummin(
        jnp.where(is_end, gcum, jnp.iinfo(jnp.int32).max), reverse=True)
    cnt = run_total - run_base
    return boundary, cnt


@functools.partial(jax.jit, static_argnames=("k", "min_count"))
def count_and_score(canon: jax.Array, good: jax.Array, k: int,
                    min_count: int = 2):
    """Count good observations per canonical key and return per-window counts
    (0 below min_count — the weak-map purge semantics,
    ref: KmerSpectrum::purgeMinDepth + ReadSelector::getValue).

    canon: [B, NW, W] u32 (padding windows = sentinel)
    good:  [B, NW] bool
    Returns: counts [B, NW] int32 (count of the window's key, regardless of
             the window's own goodness),
             sorted (keys [N, W], boundary, seg, run_counts — run-length
             layout for spectrum compaction; run_counts is per sorted
             position).
    """
    B, NW, W = canon.shape
    N = B * NW
    keys = _flatten_keys(canon)
    g = good.reshape(N)
    idx = jnp.arange(N, dtype=jnp.int32)
    ops = [keys[:, w] for w in range(W)] + [g.astype(jnp.int32), idx]
    sorted_ops = jax.lax.sort(ops, num_keys=W, is_stable=False)
    skeys = jnp.stack(sorted_ops[:W], axis=-1)
    sgood = sorted_ops[W]
    sidx = sorted_ops[W + 1]
    boundary, cnt_sorted = _run_counts_scan(skeys, sgood)
    counts = jnp.zeros(N, dtype=jnp.int32).at[sidx].set(cnt_sorted)
    counts = jnp.where(counts >= min_count, counts, 0)
    # zero out sentinel windows
    is_sent = jnp.ones(N, dtype=jnp.bool_)
    for w in range(W):
        is_sent = is_sent & (keys[:, w] == SENTINEL)
    counts = jnp.where(is_sent, 0, counts)
    seg = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    return counts.reshape(B, NW), (skeys, boundary, seg, cnt_sorted)


def _use_sort1() -> bool:
    """Route the 2-word count sort through the 1-key variant when
    KMTPU_SORT1=1: sort on the hi word only (the lo word rides as payload)
    then repair the rare equal-hi runs with odd-even cleanup sweeps.
    Exact: counting only needs equal (hi, lo) keys contiguous, and the
    cleanup loop runs until no adjacent (hi==hi, lo>lo) inversion remains.
    Expected inversions per batch ~ N^2/2^33 (distinct keys colliding on
    the hi word), so the while_loop typically runs 1-2 sweeps.  Off by
    default: it has not been timed against the 2-key lax.sort on a GPU."""
    import os
    return os.environ.get("KMTPU_SORT1", "0") in ("1", "on", "true")


def _sort2_via_1key(hi: jax.Array, lo: jax.Array):
    s = jax.lax.sort([hi, lo], num_keys=1, is_stable=False)
    hi, lo = s

    def one_parity(l, h, parity):
        n1 = h.shape[0] - 1
        at = (jnp.arange(n1, dtype=jnp.int32) & 1) == parity
        sw = at & (h[:-1] == h[1:]) & (l[:-1] > l[1:])
        swl = jnp.concatenate([sw, jnp.zeros(1, jnp.bool_)])
        swr = jnp.concatenate([jnp.zeros(1, jnp.bool_), sw])
        l_next = jnp.concatenate([l[1:], l[-1:]])
        l_prev = jnp.concatenate([l[:1], l[:-1]])
        return jnp.where(swl, l_next, jnp.where(swr, l_prev, l))

    def body(state):
        h, l = state
        l = one_parity(l, h, 0)
        l = one_parity(l, h, 1)
        return h, l

    def cond(state):
        h, l = state
        return jnp.any((h[:-1] == h[1:]) & (l[:-1] > l[1:]))

    hi, lo = jax.lax.while_loop(cond, body, (hi, lo))
    return [hi, lo]


@functools.partial(jax.jit, static_argnames=("min_count",))
def count_batch(keys: jax.Array, good: jax.Array, min_count: int = 1):
    """Spectrum-build-only counting (no per-window scatter-back): the lean
    kernel for the streaming pipeline and the benchmark.

    keys: [N, W] u32 OR a list/tuple of W [N] u32 columns (the SoA fast
    path — no [N, W] stack is ever materialized before the sort).
    Returns run-length table (sorted keys [N, W], counts-at-run [N] —
    count > 0 only at run starts) and the number of unique keys at or
    above min_count."""
    if isinstance(keys, (list, tuple)):
        cols, W = list(keys), len(keys)
        N = cols[0].shape[0]
    else:
        N, W = keys.shape
        cols = [keys[:, w] for w in range(W)]
    # pre-mask bad windows to the sentinel so only good observations count
    masked = [jnp.where(good, c, SENTINEL) for c in cols]
    if W == 2 and _use_sort1():
        s = _sort2_via_1key(masked[0], masked[1])
    else:
        s = jax.lax.sort(masked, num_keys=W, is_stable=False)
    neq = jnp.zeros(N - 1, dtype=jnp.bool_)
    for w in range(W):
        neq = neq | (s[w][1:] != s[w][:-1])
    boundary = jnp.concatenate([jnp.ones(1, jnp.bool_), neq])
    gcum = jnp.arange(1, N + 1, dtype=jnp.int32)
    is_end = jnp.concatenate([boundary[1:], jnp.ones(1, jnp.bool_)])
    run_total = jax.lax.cummin(
        jnp.where(is_end, gcum, jnp.iinfo(jnp.int32).max), reverse=True)
    # counts are only consumed AT run starts, where the run base is the
    # position itself (gcum - 1) — no cummax broadcast needed (one scan,
    # not two)
    cnt = run_total - (gcum - 1)
    is_sent = jnp.ones(N, dtype=jnp.bool_)
    for w in range(W):
        is_sent = is_sent & (s[w] == SENTINEL)
    table_counts = jnp.where(boundary & ~is_sent & (cnt >= min_count), cnt, 0)
    keep = table_counts > 0
    out_keys = jnp.stack([jnp.where(keep, c, SENTINEL) for c in s], axis=-1)
    n_unique = jnp.sum(keep)
    return out_keys, table_counts, n_unique


@jax.jit
def compact_spectrum(skeys: jax.Array, boundary: jax.Array, seg: jax.Array,
                     run_counts: jax.Array):
    """Run-length-encoded sorted keys -> sorted unique table of the same
    (fixed) size, unique rows leading, sentinel padding trailing.
    run_counts[i] is the good count of the run holding sorted position i
    (count_and_score's layout)."""
    N, W = skeys.shape
    keep = boundary & ~_is_sentinel_rows(skeys) & (run_counts > 0)
    out_keys = jnp.where(keep[:, None], skeys, SENTINEL)
    out_counts = jnp.where(keep, run_counts, 0)
    ops = [out_keys[:, w] for w in range(W)] + [out_counts]
    s = jax.lax.sort(ops, num_keys=W, is_stable=False)
    n_unique = jnp.sum(keep)
    return jnp.stack(s[:W], axis=-1), s[W], n_unique


def _is_sentinel_rows(keys):
    s = jnp.ones(keys.shape[0], dtype=jnp.bool_)
    for w in range(keys.shape[1]):
        s = s & (keys[:, w] == SENTINEL)
    return s


@jax.jit
def merge_tables(keys_a, counts_a, keys_b, counts_b):
    """Merge two fixed-capacity sorted spectrum tables (streaming builds).
    Output capacity = len(a) + len(b), caller may re-compact."""
    keys = jnp.concatenate([keys_a, keys_b])
    counts = jnp.concatenate([counts_a, counts_b])
    N, W = keys.shape
    ops = [keys[:, w] for w in range(W)] + [counts]
    s = jax.lax.sort(ops, num_keys=W, is_stable=False)
    scounts = s[W]
    neq = jnp.zeros(N - 1, dtype=jnp.bool_)
    for w in range(W):
        neq = neq | (s[w][1:] != s[w][:-1])
    boundary = jnp.concatenate([jnp.ones(1, jnp.bool_), neq])
    is_end = jnp.concatenate([neq, jnp.ones(1, jnp.bool_)])
    # per-run count totals via monotone scans (no segment_sum/gather;
    # see _run_counts_scan)
    cum = jnp.cumsum(scounts)
    excl = cum - scounts
    total = jax.lax.cummin(
        jnp.where(is_end, cum, jnp.iinfo(jnp.int32).max), reverse=True)
    # run totals are only consumed at run starts (keep ⊆ boundary below),
    # where the run's exclusive-prefix base is just `excl` at that row —
    # no cummax broadcast needed (one scan, not two)
    run_total = (total - excl).astype(counts.dtype)
    sent = jnp.ones(N, dtype=jnp.bool_)
    for w in range(W):
        sent = sent & (s[w] == SENTINEL)
    keep = boundary & ~sent
    out_cols = [jnp.where(keep, c, SENTINEL) for c in s[:W]]
    out_counts = jnp.where(keep, run_total, 0)
    # re-sort so unique rows lead and sentinels trail
    s2 = jax.lax.sort(out_cols + [out_counts], num_keys=W, is_stable=False)
    return jnp.stack(s2[:W], axis=-1), s2[W]


@functools.partial(jax.jit, static_argnames=("k", "min_count", "log2_min_weight"))
def spectrum_step(codes: jax.Array, logp: jax.Array, lengths: jax.Array,
                  k: int, min_count: int = 2, log2_min_weight: float = -3.3219281):
    """The flagship fused step: codes/quals -> per-window spectrum counts.

    This is what `__graft_entry__.entry()` compiles: one batch in, canonical
    extraction + weighting + counting + score lookup out.
    """
    canon, is_fwd, valid = extract_canonical(codes, lengths, k)
    wsum, good = window_good(logp, lengths, k, log2_min_weight)
    counts, sorted_state = count_and_score(canon, good, k, min_count)
    return counts, canon, good


# --------------------------------------------------------------------------
# table lookup (sort-merge join) for cross-batch scoring
# --------------------------------------------------------------------------

@jax.jit
def lookup_join(table_keys: jax.Array, table_counts: jax.Array,
                query_keys: jax.Array):
    """counts per query key via sort-merge join (0 for absent).

    table_keys: [M, W] sorted unique (sentinel padded); query_keys: [Q, W].
    """
    M, W = table_keys.shape
    Q = query_keys.shape[0]
    keys = jnp.concatenate([table_keys, query_keys])
    is_q = jnp.concatenate([jnp.zeros(M, jnp.int32), jnp.ones(Q, jnp.int32)])
    payload = jnp.concatenate([table_counts, jnp.zeros(Q, jnp.int32)])
    qidx = jnp.concatenate([jnp.zeros(M, jnp.int32), jnp.arange(Q, dtype=jnp.int32)])
    ops = [keys[:, w] for w in range(W)] + [is_q, payload, qidx]
    s = jax.lax.sort(ops, num_keys=W + 1, is_stable=False)  # table rows before queries per key
    skeys = jnp.stack(s[:W], axis=-1)
    s_isq, s_payload, s_qidx = s[W], s[W + 1], s[W + 2]
    N = M + Q
    neq = jnp.zeros(N - 1, dtype=jnp.bool_)
    for w in range(W):
        neq = neq | (skeys[1:, w] != skeys[:-1, w])
    boundary = jnp.concatenate([jnp.ones(1, jnp.bool_), neq])
    # Broadcast each key-run's first value forward with monotone scans
    # (no scatter/gather — the repo's standard idiom; table keys are unique
    # so the run's first row is its table row iff one exists, else a query
    # carrying 0).  first_of_run[i] = A[i] - (A just before the run began).
    P = jnp.where(s_isq == 0, s_payload, 0)
    A = jnp.cumsum(P)
    base = jax.lax.cummax(
        jnp.where(boundary, A - P, jnp.iinfo(jnp.int32).min))
    filled = A - base
    # per-query counts in original order: queries lead, ordered by qidx
    s4 = jax.lax.sort([1 - s_isq, s_qidx, filled], num_keys=2, is_stable=False)
    return s4[2][:Q]


def ragged_to_padded(flat: np.ndarray, nw: np.ndarray, width: int,
                     fill=0) -> np.ndarray:
    """Vectorized scatter of ragged per-read values (read i owns
    flat[woff[i]:woff[i]+nw[i]]) into a padded [B, width] matrix."""
    B = len(nw)
    out = np.full((B, width), fill, dtype=flat.dtype)
    rows = np.repeat(np.arange(B), nw)
    cols = np.arange(int(nw.sum())) - np.repeat(
        np.concatenate([[0], np.cumsum(nw)[:-1]]), nw)
    out[rows, cols] = flat
    return out


def padded_to_ragged(padded: np.ndarray, nw: np.ndarray) -> np.ndarray:
    """Inverse of ragged_to_padded: gather the first nw[i] entries of each
    row back into one flat ragged array."""
    B = len(nw)
    rows = np.repeat(np.arange(B), nw)
    cols = np.arange(int(nw.sum())) - np.repeat(
        np.concatenate([[0], np.cumsum(nw)[:-1]]), nw)
    return padded[rows, cols]

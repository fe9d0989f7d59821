"""Streaming spectrum build: FASTQ batches -> running device table.

The scalable counting engine (the reference's buildKmerSpectrumInParts /
streaming MPI build, ref: src/KmerSpectrum.h:1818-1902): each batch is
extracted/weighted/sorted on device and merged into a bounded running table
with sort-merge compaction, so arbitrarily large inputs stream through a
fixed device footprint.
"""
from __future__ import annotations

import functools
from typing import Iterable, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from kmernator_tpu.parallel.device_spectrum import (SENTINEL, count_batch,
                                                    extract_canonical_cols,
                                                    merge_tables, window_good)


class StreamingSpectrum:
    """Running (keys, counts) device table built by merging batch tables."""

    def __init__(self, k: int, capacity: int, min_weight: float = 0.10,
                 drain_threshold: int = 0):
        self.k = k
        self.capacity = capacity
        # staged rows before a merge: smaller = lower peak memory (the
        # drain sorts capacity+staged rows), larger = fewer sorts.  The
        # default caps the transient at 1.5x the table.
        self.drain_threshold = drain_threshold or max(capacity // 2, 1 << 16)
        from kmernator_tpu.ops.kmer import nwords
        W = nwords(k)
        self.keys = jnp.full((capacity, W), SENTINEL, dtype=jnp.uint32)
        self.counts = jnp.zeros(capacity, dtype=jnp.int32)
        self.log2_min_weight = float(np.log2(min_weight)) if min_weight > 0 else -1e30
        self.total_windows = 0
        self.total_good = 0

    _pending_keys: list = None
    _pending_counts: list = None
    _pending_rows: int = 0

    def add_batch(self, codes, logp, lengths, qual_table=None):
        """Count one batch and stage its compacted table; merges into the
        main table are amortized (one big sort per ~capacity staged rows
        instead of per batch).

        `logp` may instead be RAW quality bytes (uint8) with `qual_table`
        a 256-entry f32 log2-probability table — the lookup then runs on
        device, shrinking the host->device transfer 4x per base."""
        if self._pending_keys is None:
            self._pending_keys, self._pending_counts = [], []
        codes = jnp.asarray(codes)
        lengths = jnp.asarray(lengths)
        if logp.dtype == np.uint8:
            if qual_table is None:
                raise ValueError("raw-qual batches need qual_table")
            L = logp.shape[1]  # qual carries the true padded length
            if codes.shape[1] != L:  # 2-bit packed codes
                bkeys, bcounts, n_unique = _batch_table_from_2bit(
                    codes, jnp.asarray(logp), lengths,
                    jnp.asarray(qual_table), self.k, self.log2_min_weight, L)
            else:
                bkeys, bcounts, n_unique = _batch_table_from_qual(
                    codes, jnp.asarray(logp), lengths,
                    jnp.asarray(qual_table), self.k, self.log2_min_weight)
        else:
            bkeys, bcounts, n_unique = _batch_table(
                codes, jnp.asarray(logp), lengths, self.k,
                self.log2_min_weight)
        counts = None
        self._pending_keys.append(bkeys)
        self._pending_counts.append(bcounts)
        self._pending_rows += bkeys.shape[0]
        if self._pending_rows >= self.drain_threshold:
            self._drain()
        L_eff = (logp.shape[1] if logp.dtype == np.uint8 else codes.shape[1])
        self.total_windows += int(codes.shape[0]) * (L_eff - self.k + 1)
        return counts

    def add_table(self, keys_words: np.ndarray, counts: np.ndarray):
        """Stage a pre-counted host table (per-chunk unique keys [N, W] u32
        + counts) into the running merge — the entry point for the chunked
        host FilterReads path, whose goodness mask comes from the bit-exact
        host weight recurrence.  Padded to powers of two so XLA compiles
        O(log N) merge variants."""
        if self._pending_keys is None:
            self._pending_keys, self._pending_counts = [], []
        N, W = keys_words.shape
        Np = 1 << max(int(np.ceil(np.log2(max(N, 1)))), 6)
        pk = np.full((Np, W), SENTINEL, np.uint32)
        pk[:N] = keys_words
        pc = np.zeros(Np, np.int32)
        pc[:N] = counts
        self._pending_keys.append(jnp.asarray(pk))
        self._pending_counts.append(jnp.asarray(pc))
        self._pending_rows += Np
        if self._pending_rows >= self.drain_threshold:
            self._drain()

    purged_singletons: int = 0

    def _drain(self):
        if not self._pending_keys:
            return
        pk = jnp.concatenate([self.keys] + self._pending_keys)
        pc = jnp.concatenate([self.counts] + self._pending_counts)
        # merge_tables with an empty second input just sorts+reduces pk
        mk, mc = merge_tables(pk, pc, pk[:0], pc[:0])
        n_real, n_solid = (int(x) for x in _occupancy(mc))
        if n_solid > self.capacity:
            raise RuntimeError(
                "streaming table overflow: %d kmers with count>=2 exceed "
                "capacity %d — raise capacity" % (n_solid, self.capacity))
        if n_real > self.capacity:
            # singletons beyond capacity are purged, as the reference does
            # under memory pressure (ref: KmerSpectrum.h:1794 purge cycle);
            # a re-observed purged kmer restarts at 1 (undercount by 1)
            self.purged_singletons += n_real - self.capacity
            kk, kc, _, _ = _purge_compact(mk, mc, self.capacity)
            self.keys, self.counts = kk, kc
        else:
            # merge output is sorted with sentinel padding last: plain
            # truncation keeps every real row
            self.keys = mk[:self.capacity]
            self.counts = mc[:self.capacity]
        self._pending_keys, self._pending_counts = [], []
        self._pending_rows = 0

    def finalize(self, min_depth: int = 2):
        self._drain()
        keys = np.asarray(self.keys)
        counts = np.asarray(self.counts)
        real = ~(keys == 0xFFFFFFFF).all(axis=1) & (counts >= min_depth)
        return keys[real], counts[real]


@functools.partial(jax.jit, static_argnames=("k", "log2_min_weight"))
def _batch_table(codes, logp, lengths, k, log2_min_weight):
    cols, is_fwd, valid = extract_canonical_cols(codes, lengths, k)
    wsum, good = window_good(logp, lengths, k, log2_min_weight)
    return count_batch([c.reshape(-1) for c in cols],
                       (good & valid).reshape(-1), 1)


@functools.partial(jax.jit, static_argnames=("k", "log2_min_weight"))
def _batch_table_from_qual(codes, qual, lengths, table, k, log2_min_weight):
    logp = table[qual]  # 256-entry gather, fused into the count step
    cols, is_fwd, valid = extract_canonical_cols(codes, lengths, k)
    wsum, good = window_good(logp, lengths, k, log2_min_weight)
    return count_batch([c.reshape(-1) for c in cols],
                       (good & valid).reshape(-1), 1)


def unpack_2bit(codes2, L: int):
    """[B, ceil(L/4)] 2-bit packed -> [B, L] u8 codes (device)."""
    planes = [(codes2 >> jnp.uint8(6 - 2 * j)) & jnp.uint8(3)
              for j in range(4)]
    return jnp.stack(planes, axis=-1).reshape(codes2.shape[0], -1)[:, :L]


@functools.partial(jax.jit, static_argnames=("k", "log2_min_weight", "L"))
def _batch_table_from_2bit(codes2, qual, lengths, table, k,
                           log2_min_weight, L):
    codes = unpack_2bit(codes2, L)
    logp = table[qual]
    cols, is_fwd, valid = extract_canonical_cols(codes, lengths, k)
    wsum, good = window_good(logp, lengths, k, log2_min_weight)
    return count_batch([c.reshape(-1) for c in cols],
                       (good & valid).reshape(-1), 1)


@jax.jit
def _occupancy(counts):
    return jnp.sum(counts > 0), jnp.sum(counts >= 2)


@functools.partial(jax.jit, static_argnames=("capacity",))
def _purge_compact(keys, counts, capacity: int):
    """Keep count>=2 rows first, then singletons, up to `capacity` rows
    (sorted by priority then key; sentinels last).  Returns the compacted
    [capacity] table plus (n_real, n_solid) occupancy scalars."""
    N, W = keys.shape
    real = counts > 0
    solid = counts >= 2
    prio = jnp.where(solid, 0, jnp.where(real, 1, 2)).astype(jnp.int32)
    ops = [prio] + [keys[:, w] for w in range(W)] + [counts]
    s = jax.lax.sort(ops, num_keys=W + 1, is_stable=False)
    out_keys = jnp.stack(s[1:W + 1], axis=-1)[:capacity]
    out_counts = s[W + 1][:capacity]
    # rows beyond capacity are dropped: null out any that were padding anyway
    kept_real = out_counts > 0
    out_keys = jnp.where(kept_real[:, None], out_keys, SENTINEL)
    return (out_keys, jnp.where(kept_real, out_counts, 0),
            jnp.sum(real), jnp.sum(solid))


def build_streaming(batches: Iterable, k: int, capacity: int,
                    min_weight: float = 0.10, min_depth: int = 2,
                    prefetch: int = 2):
    """Stream batches into a StreamingSpectrum with host-side prefetch: a
    background thread runs the (CPU-bound) parse/pack iterator while the
    device works on the previous batch — the reference's comm-thread /
    worker-thread split (ref: DistributedFunctions.h:376-382) recast as
    IO/compute overlap."""
    sp = StreamingSpectrum(k, capacity, min_weight)
    src = batches  # raw-qual streams expose .device_table once iterating
    for codes, logp, lengths in _prefetched(batches, prefetch):
        sp.add_batch(codes, logp, lengths,
                     qual_table=getattr(src, "device_table", None))
    return sp.finalize(min_depth)


def _prefetched(iterable: Iterable, depth: int):
    if depth <= 0:
        yield from iterable
        return
    import queue
    import threading
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    err = []

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        yield item
    t.join()
    if err:
        raise err[0]

"""Streaming sharded spectrum: batches -> persistent per-device shard tables.

This composes the two halves that round 1 left separate: the all_to_all
owner routing of parallel/mesh.py and the running-table sort-merge of
parallel/pipeline.py.  It is the device form of the reference's
streaming distributed build (ref: src/DistributedFunctions.h:333-458 —
8192-read batches routed through MPI_Alltoallv and appended into per-rank
maps) plus the ReqResp lookup RPC used for read scoring afterwards
(ref: src/DistributedFunctions.h:749-1062, _batchKmerLookup :877-902).

Design (all fixed-shape jitted shard_map programs over a 1-D mesh):

  build batch:  mask non-good windows to the sentinel, bucket-scatter keys
                by owner = hash % D, all_to_all; the received raw
                observations (count=1 rows) are STAGED per device — no
                per-batch sort at all.
  drain:        when staged rows reach the shard capacity, one per-device
                sort-merge folds (table + staged observations) into the
                sorted shard table; singletons beyond capacity are purged,
                exactly the reference's purge-under-memory-pressure policy
                (ref: src/KmerSpectrum.h:1794) applied per shard.
  lookup batch: route ALL valid query windows to owners, binary-search the
                sorted shard table (log2(cap) probes over the key word
                planes), counts ride the reverse all_to_all back to the
                source windows.

The shard tables live as [D, cap] arrays sharded P('d', None): they never
leave device memory between batches, so arbitrarily large inputs stream
through a bounded per-device footprint.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kmernator_tpu.ops.kmer import nwords
from kmernator_tpu.parallel.device_spectrum import (SENTINEL,
                                                    extract_canonical_cols)
from kmernator_tpu.parallel.mesh import (shard_map, make_mesh,
                                         owner_hash_cols,
                                         _bucket_scatter_cols)


# --------------------------------------------------------------------------
# jitted steps (built per (mesh, k, shape) and cached)
# --------------------------------------------------------------------------
#
# Wire format: base codes cross the host->device link 2-bit packed and
# window masks bit-packed (~12x fewer bytes than u8 codes and bool masks);
# devices unpack with shift masks at step entry.  Weights transfer as f32 only when actually
# tracked — untracked builds route a constant 1.0.


def pack_codes_host(codes: np.ndarray) -> np.ndarray:
    """[B, L] u8 base codes -> [B, ceil(L/4)] u8, base i at bits 2*(i%4)."""
    B, L = codes.shape
    L4 = -(-L // 4) * 4
    if L4 != L:
        codes = np.concatenate(
            [codes, np.zeros((B, L4 - L), np.uint8)], axis=1)
    c = codes.reshape(B, L4 // 4, 4).astype(np.uint16)
    packed = c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) \
        | (c[:, :, 3] << 6)
    return packed.astype(np.uint8)


def pack_bits_host(mask: np.ndarray) -> np.ndarray:
    """[B, NW] bool -> [B, ceil(NW/8)] u8 (little-endian bit order)."""
    return np.packbits(mask, axis=1, bitorder="little")


def _unpack_codes_dev(packed: jax.Array, L: int) -> jax.Array:
    B = packed.shape[0]
    shifts = jnp.arange(0, 8, 2, dtype=jnp.uint8)
    codes = (packed[:, :, None] >> shifts[None, None, :]) & jnp.uint8(3)
    return codes.reshape(B, -1)[:, :L]


def _unpack_bits_dev(packed: jax.Array, NW: int) -> jax.Array:
    B = packed.shape[0]
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (packed[:, :, None] >> shifts[None, None, :]) & jnp.uint8(1)
    return bits.reshape(B, -1)[:, :NW].astype(jnp.bool_)


@functools.lru_cache(maxsize=None)
def _route_build_fn(mesh: Mesh, k: int, C: int, L: int, has_w: bool):
    """Batch route step for the streaming build: packed codes/good,
    lengths [, weights] -> received key planes (W x [D, C] per device,
    sentinel = no observation) + a received weight plane + overflow count.
    Only good windows are routed (count=1 rows); the float window weight
    rides along (when tracked) so owners can accumulate weightedCount
    (ref: StoreKmerMessageHeader carries the weight,
    src/DistributedFunctions.h:274-303)."""
    D = mesh.devices.size
    axis = mesh.axis_names[0]
    NW = L - k + 1

    def step(codes_p, good_p, lengths, *wts):
        codes = _unpack_codes_dev(codes_p, L)
        good_in = _unpack_bits_dev(good_p, NW)
        cols, is_fwd, valid = extract_canonical_cols(codes, lengths, k)
        B, NW_ = valid.shape
        N = B * NW_
        g = good_in.reshape(N) & valid.reshape(N)
        # pre-mask: non-good windows are dropped before routing (the build
        # only counts good observations; ref: DistributedFunctions.h:429
        # discards below-min-weight kmers before buffering)
        key_cols = [jnp.where(g, c.reshape(N), SENTINEL) for c in cols]
        owner = (owner_hash_cols(key_cols) % jnp.uint32(D)).astype(jnp.int32)
        send_cols, _, win_slot, overflow = _bucket_scatter_cols(
            key_cols, g, owner, D, C)
        wflat = wts[0].reshape(N).astype(jnp.float32) if has_w \
            else jnp.ones(N, jnp.float32)
        tgt = jnp.where(win_slot >= 0, win_slot, D * C)
        wbuf = jnp.zeros(D * C + 1, jnp.float32)
        send_w = wbuf.at[tgt].set(
            jnp.where(win_slot >= 0, wflat, 0.0))[:D * C].reshape(D, C)
        a2a = lambda x: jax.lax.all_to_all(x, axis, split_axis=0,
                                           concat_axis=0)
        recv = [a2a(c).reshape(1, D * C) for c in send_cols]
        recv_w = a2a(send_w).reshape(1, D * C)
        return tuple(recv) + (recv_w, overflow[None])

    in_specs = [P(axis, None), P(axis, None), P(axis)]
    if has_w:
        in_specs.append(P(axis, None))
    smapped = shard_map(
        step, mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=tuple([P(axis, None)] * (nwords(k) + 1)) + (P(axis),))
    return jax.jit(smapped)


@functools.lru_cache(maxsize=None)
def _drain_fn(mesh: Mesh, W: int, cap: int, R: int):
    """Per-shard sort-merge of (table rows + staged observation rows) back
    into a sorted [cap] table.  R = total input rows per device.

    Returns (key planes [D, cap] x W, counts [D, cap], weights [D, cap],
    purged [D] — the number of singleton rows dropped under capacity
    pressure).  Output is KEY-SORTED with sentinels trailing, so the
    lookup step can binary-search it directly."""
    axis = mesh.axis_names[0]
    FMAX = jnp.float32(3.4e38)

    def step(*args):
        key_cols = [a.reshape(-1) for a in args[:W]]
        counts = args[W].reshape(-1)
        weights = args[W + 1].reshape(-1)
        # 1) sort by key, run-total counts/weights via monotone scans
        s = jax.lax.sort(key_cols + [counts, weights], num_keys=W, is_stable=False)
        sc, sw = s[W], s[W + 1]
        neq = jnp.zeros(R - 1, dtype=jnp.bool_)
        for w in range(W):
            neq = neq | (s[w][1:] != s[w][:-1])
        boundary = jnp.concatenate([jnp.ones(1, jnp.bool_), neq])
        is_end = jnp.concatenate([neq, jnp.ones(1, jnp.bool_)])
        cum = jnp.cumsum(sc)
        excl = cum - sc
        base = jax.lax.cummax(jnp.where(boundary, excl, jnp.int32(-1)))
        total = jax.lax.cummin(
            jnp.where(is_end, cum, jnp.iinfo(jnp.int32).max), reverse=True)
        run_total = total - base
        wcum = jnp.cumsum(sw)
        wexcl = wcum - sw
        wbase = jax.lax.cummax(jnp.where(boundary, wexcl, -FMAX))
        wtotal = jax.lax.cummin(
            jnp.where(is_end, wcum, FMAX), reverse=True)
        wrun = wtotal - wbase
        sent = jnp.ones(R, dtype=jnp.bool_)
        for w in range(W):
            sent = sent & (s[w] == SENTINEL)
        keep = boundary & ~sent
        mk = [jnp.where(keep, c, SENTINEL) for c in s[:W]]
        mc = jnp.where(keep, run_total, 0)
        mw = jnp.where(keep, wrun, 0.0)
        # 2) priority compaction to [cap]: solid (count>=2) rows first, then
        # singletons; beyond-capacity singletons are purged (ref: the
        # reference's periodic singleton purge under memory pressure)
        prio = jnp.where(mc >= 2, 0, jnp.where(mc > 0, 1, 2)).astype(jnp.int32)
        s2 = jax.lax.sort([prio] + mk + [mc, mw], num_keys=1 + W, is_stable=False)
        kept_counts = s2[W + 1][:cap]
        kept_w = s2[W + 2][:cap]
        kept_real = kept_counts > 0
        filled = jnp.sum(kept_real.astype(jnp.int32))
        purged = jnp.sum((s2[W + 1] > 0).astype(jnp.int32)) - filled
        out_cols = [jnp.where(kept_real, c[:cap], SENTINEL) for c in s2[1:W + 1]]
        # 3) re-sort by key so the table stays binary-searchable
        s3 = jax.lax.sort(out_cols + [jnp.where(kept_real, kept_counts, 0),
                                      jnp.where(kept_real, kept_w, 0.0)],
                          num_keys=W, is_stable=False)
        return (tuple(a[None, :] for a in s3[:W])
                + (s3[W][None, :], s3[W + 1][None, :], purged[None],
                   filled[None]))

    smapped = shard_map(
        step, mesh=mesh,
        in_specs=tuple([P(axis, None)] * (W + 2)),
        out_specs=tuple([P(axis, None)] * (W + 2)) + (P(axis), P(axis)))
    return jax.jit(smapped)


@functools.lru_cache(maxsize=None)
def _pad_table_fn(mesh: Mesh, W: int, pad: int):
    """Append `pad` sentinel/zero columns to every shard plane — the
    table-growth step.  Sentinel keys sort last, and the existing table
    is key-sorted with sentinels already trailing, so appending more
    keeps the binary-search invariant without a re-sort."""
    axis = mesh.axis_names[0]

    def step(*planes):
        out = [jnp.pad(planes[w], ((0, 0), (0, pad)),
                       constant_values=SENTINEL) for w in range(W)]
        out.append(jnp.pad(planes[W], ((0, 0), (0, pad))))
        out.append(jnp.pad(planes[W + 1], ((0, 0), (0, pad))))
        return tuple(out)

    smapped = shard_map(
        step, mesh=mesh,
        in_specs=tuple([P(axis, None)] * (W + 2)),
        out_specs=tuple([P(axis, None)] * (W + 2)))
    return jax.jit(smapped)


@functools.lru_cache(maxsize=None)
def _lookup_fn(mesh: Mesh, k: int, C: int, cap: int, min_count: int,
               L: int):
    """Sharded-table lookup (the ReqResp RPC analogue): every valid query
    window routes to its owner, the owner binary-searches its sorted shard
    table, counts ride the reverse all_to_all back.

    Inputs:  packed codes [B, ceil(L/4)], packed valid_q [B, ceil(NW/8)]
             (which windows want counts), lengths [B], table key planes
             [D, cap] x W, table counts [D, cap]
    Outputs: counts [B, NW] i32 (0 if absent or below min_count), overflow.
    """
    D = mesh.devices.size
    axis = mesh.axis_names[0]
    W = nwords(k)
    probes = int(np.ceil(np.log2(max(cap, 2)))) + 1
    NW_in = L - k + 1

    def step(codes_p, want_p, lengths, *table):
        tk = [t.reshape(-1) for t in table[:W]]
        tc = table[W].reshape(-1)
        codes = _unpack_codes_dev(codes_p, L)
        want = _unpack_bits_dev(want_p, NW_in)
        cols, is_fwd, valid = extract_canonical_cols(codes, lengths, k)
        B, NW = valid.shape
        N = B * NW
        q = want.reshape(N) & valid.reshape(N)
        key_cols = [jnp.where(q, c.reshape(N), SENTINEL) for c in cols]
        owner = (owner_hash_cols(key_cols) % jnp.uint32(D)).astype(jnp.int32)
        send_cols, _, win_slot, overflow = _bucket_scatter_cols(
            key_cols, q, owner, D, C)
        a2a = lambda x: jax.lax.all_to_all(x, axis, split_axis=0,
                                           concat_axis=0)
        recv = [a2a(c).reshape(D * C) for c in send_cols]
        # lexicographic binary search of the received keys in the sorted
        # shard table (generalizes dist_match.py:119-134 to SoA planes)
        Q = D * C
        lo = jnp.zeros(Q, dtype=jnp.int32)
        hi = jnp.full(Q, cap, dtype=jnp.int32)
        for _ in range(probes):
            mid = (lo + hi) // 2
            cmid = jnp.clip(mid, 0, cap - 1)
            less = jnp.zeros(Q, dtype=jnp.bool_)
            eq = jnp.ones(Q, dtype=jnp.bool_)
            for w in range(W):
                mk = tk[w][cmid]
                less = less | (eq & (mk < recv[w]))
                eq = eq & (mk == recv[w])
            lo = jnp.where(less, mid + 1, lo)
            hi = jnp.where(less, hi, mid)
        pos = jnp.clip(lo, 0, cap - 1)
        hit = jnp.ones(Q, dtype=jnp.bool_)
        for w in range(W):
            hit = hit & (tk[w][pos] == recv[w])
        sent = jnp.ones(Q, dtype=jnp.bool_)
        for w in range(W):
            sent = sent & (recv[w] == SENTINEL)
        cnt = jnp.where(hit & ~sent, tc[pos], 0)
        cnt = jnp.where(cnt >= min_count, cnt, 0)
        cnt_back = a2a(cnt.reshape(D, C)).reshape(D * C)
        counts = jnp.where(win_slot >= 0, cnt_back[jnp.maximum(win_slot, 0)], 0)
        return counts.reshape(B, NW), overflow[None]

    smapped = shard_map(
        step, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis))
        + tuple([P(axis, None)] * (W + 1)),
        out_specs=(P(axis, None), P(axis)))
    return jax.jit(smapped)


def _shell_cols(cols, k: int):
    """SoA hamming-1 shell on device: W [N] u32 key-word planes -> W
    [N, 4k] canonical substituted-key planes (jnp twin of
    parallel/spectrum.hamming_shell_batch, including identity rows)."""
    from kmernator_tpu.ops.kmer import _reverse_bases_u32, last_word_mask
    from kmernator_tpu.parallel.device_spectrum import _shift_left_cols
    W = len(cols)
    M = 4 * k
    j = jnp.arange(M)
    pj = (j // 4).astype(jnp.int32)
    nb = (j % 4).astype(jnp.uint32)
    shift = (jnp.uint32(30) - jnp.uint32(2) * (pj % 16).astype(jnp.uint32))
    fwd = []
    for w in range(W):
        in_w = ((pj // 16) == w)[None, :]
        cleared = cols[w][:, None] & ~(jnp.uint32(3) << shift)[None, :]
        sub = cleared | (nb << shift)[None, :]
        fwd.append(jnp.where(in_w, sub, cols[w][:, None]))
    mask = np.uint32(last_word_mask(k))
    fwd[W - 1] = fwd[W - 1] & mask
    rc = [_reverse_bases_u32(jnp, (~fwd[w]) & jnp.uint32(0xFFFFFFFF))
          for w in range(W - 1, -1, -1)]
    rc = _shift_left_cols(rc, 16 * W - k)
    rc[W - 1] = rc[W - 1] & mask
    lt = rc[W - 1] < fwd[W - 1]
    for w in range(W - 2, -1, -1):
        lt = jnp.where(rc[w] == fwd[w], lt, rc[w] < fwd[w])
    return [jnp.where(lt, rc[w], fwd[w]) for w in range(W)]


@functools.lru_cache(maxsize=None)
def _purge_round_fn(mesh: Mesh, k: int, S: int, edit_distance: int, C: int,
                    cap: int, sigmas: float, min_var: float):
    """One source-chunk of the fully on-mesh variant purge
    (ref: PurgeVariantKmerMessage alltoall, src/DistributedFunctions.h:
    607-747): each shard takes its active sources [s0, s0+S), generates
    hamming shells on device (dist 1..edit_distance, expansion without
    dedup — duplicates re-test the same victim, harmless), routes
    candidate keys + per-candidate thresholds to owner shards by hash,
    and owners mark victims (0 < vals0 < thr) in their purge plane.
    No host table materialization at any point."""
    D = mesh.devices.size
    axis = mesh.axis_names[0]
    W = nwords(k)
    probes = int(np.ceil(np.log2(max(cap, 2)))) + 1

    def binsearch(tk, recv):
        Q = recv[0].shape[0]
        lo = jnp.zeros(Q, dtype=jnp.int32)
        hi = jnp.full(Q, cap, dtype=jnp.int32)
        for _ in range(probes):
            mid = (lo + hi) // 2
            cmid = jnp.clip(mid, 0, cap - 1)
            less = jnp.zeros(Q, dtype=jnp.bool_)
            eq = jnp.ones(Q, dtype=jnp.bool_)
            for w in range(W):
                mk = tk[w][cmid]
                less = less | (eq & (mk < recv[w]))
                eq = eq & (mk == recv[w])
            lo = jnp.where(less, mid + 1, lo)
            hi = jnp.where(less, hi, mid)
        pos = jnp.clip(lo, 0, cap - 1)
        hit = jnp.ones(Q, dtype=jnp.bool_)
        for w in range(W):
            hit = hit & (tk[w][pos] == recv[w])
        return pos, hit

    def step(s0, *planes):
        tk = [p.reshape(-1) for p in planes[:W]]
        vals0 = planes[W].reshape(-1)
        active = planes[W + 1].reshape(-1)
        marks = planes[W + 2].reshape(-1)
        # compact active row indices, take this chunk
        iota = jnp.arange(cap, dtype=jnp.int32)
        order = jax.lax.sort([jnp.where(active, iota, jnp.int32(cap))],
                             num_keys=1, is_stable=False)[0]
        sel = jax.lax.dynamic_slice_in_dim(order, s0[0], S)
        real = sel < cap
        idx = jnp.minimum(sel, cap - 1)
        v = vals0[idx]
        thr_base = v - jnp.sqrt(jnp.maximum(v, 0.0)) * jnp.float32(sigmas)
        d = jnp.full(S, edit_distance, jnp.int32)
        for _ in range(max(edit_distance - 1, 0)):
            lim = jnp.float32(min_var) * (jnp.int32(20) ^ d).astype(
                jnp.float32)
            shrink = (d > 1) & ~(v > lim)
            d = jnp.where(shrink, d - 1, d)
        src = [jnp.where(real, tk[w][idx], SENTINEL) for w in range(W)]
        frontier = [c.reshape(-1) for c in _shell_cols(src, k)]
        fthr = jnp.repeat(thr_base, 4 * k)
        fd = jnp.repeat(d, 4 * k)
        freal = jnp.repeat(real, 4 * k)
        overflow_total = jnp.zeros((), jnp.int32)
        a2a = lambda x: jax.lax.all_to_all(x, axis, split_axis=0,
                                           concat_axis=0)
        for dist in range(1, edit_distance + 1):
            ok = freal & (fd >= dist)
            key_cols = [jnp.where(ok, c, SENTINEL) for c in frontier]
            owner = (owner_hash_cols(key_cols)
                     % jnp.uint32(D)).astype(jnp.int32)
            send_cols, _, slot, overflow = _bucket_scatter_cols(
                key_cols, ok, owner, D, C)
            overflow_total = overflow_total + overflow
            thr_dist = fthr / jnp.float32(20 ^ (dist - 1))
            tgt = jnp.where(slot >= 0, slot, D * C)
            tbuf = jnp.full(D * C + 1, jnp.float32(3.4e38))
            send_thr = tbuf.at[tgt].set(
                jnp.where(slot >= 0, thr_dist,
                          jnp.float32(3.4e38)))[:D * C].reshape(D, C)
            recv = [a2a(c).reshape(D * C) for c in send_cols]
            recv_thr = a2a(send_thr).reshape(D * C)
            pos, hit = binsearch(tk, recv)
            sent = jnp.ones(D * C, dtype=jnp.bool_)
            for w in range(W):
                sent = sent & (recv[w] == SENTINEL)
            victim = (hit & ~sent & (vals0[pos] > 0.0)
                      & (vals0[pos] < recv_thr))
            mbuf = jnp.concatenate([marks, jnp.zeros(1, jnp.bool_)])
            marks = mbuf.at[jnp.where(victim, pos, cap)].set(True)[:cap]
            if dist < edit_distance:
                # expand the whole dist shell (no dedup; duplicate
                # candidates only repeat the same test)
                frontier = [c.reshape(-1)
                            for c in _shell_cols(frontier, k)]
                fthr = jnp.repeat(fthr, 4 * k)
                fd = jnp.repeat(fd, 4 * k)
                freal = jnp.repeat(freal, 4 * k)
        return marks[None, :], overflow_total[None]

    smapped = shard_map(
        step, mesh=mesh,
        in_specs=(P(axis),) + tuple([P(axis, None)] * (W + 3)),
        out_specs=(P(axis, None), P(axis)))
    return jax.jit(smapped)


@functools.lru_cache(maxsize=None)
def _apply_purge_fn(mesh: Mesh, W: int, cap: int, min_depth: int):
    """Zero marked rows, drop below-min-depth rows to the sentinel, and
    re-sort each shard so it stays binary-searchable."""
    axis = mesh.axis_names[0]

    def step(*planes):
        tk = [p.reshape(-1) for p in planes[:W]]
        counts = planes[W].reshape(-1)
        weights = planes[W + 1].reshape(-1)
        marks = planes[W + 2].reshape(-1)
        counts = jnp.where(marks, 0, counts)
        weights = jnp.where(marks, 0.0, weights)
        drop = counts < min_depth
        tk = [jnp.where(drop, SENTINEL, c) for c in tk]
        counts = jnp.where(drop, 0, counts)
        weights = jnp.where(drop, 0.0, weights)
        s = jax.lax.sort(tk + [counts, weights], num_keys=W,
                         is_stable=False)
        n_purged = jnp.sum(marks.astype(jnp.int32))
        return (tuple(a[None, :] for a in s[:W])
                + (s[W][None, :], s[W + 1][None, :], n_purged[None]))

    smapped = shard_map(
        step, mesh=mesh,
        in_specs=tuple([P(axis, None)] * (W + 3)),
        out_specs=tuple([P(axis, None)] * (W + 2)) + (P(axis),))
    return jax.jit(smapped)


# --------------------------------------------------------------------------
# host-side driver
# --------------------------------------------------------------------------

class MeshStreamingSpectrum:
    """Persistent hash-sharded spectrum built by streaming batches through
    the mesh — the DistributedKmerSpectrum analogue
    (ref: src/DistributedFunctions.h:102-747).

    capacity = per-DEVICE shard table rows.  Batches must be padded to a
    row count divisible by the mesh size (add_batch handles it).
    """

    def __init__(self, mesh: Mesh, k: int, capacity: int,
                 capacity_factor: float = 0.0, drain_threshold: int = 0,
                 max_capacity: int = 0):
        """max_capacity > capacity enables GROW-ON-PRESSURE: the table
        grows in 4x steps whenever a drain could overfill it, so
        per-device memory tracks the UNIQUE key population instead of the
        raw stream size, and the singleton purge only fires at the hard
        ceiling or under >2x hash skew (counts stay exact otherwise;
        purged_singletons reports any loss).  max_capacity == 0 keeps
        the fixed-capacity purge-under-pressure behavior (the explicit
        --streaming-parts override)."""
        from kmernator_tpu.parallel import multihost as mh
        self._mh = mh
        self.mesh = mesh
        self.k = k
        self.W = nwords(k)
        self.cap = int(capacity)
        self.max_capacity = int(max_capacity)
        self._user_threshold = bool(drain_threshold)
        # all_to_all bucket headroom over the balanced share: with a single
        # device there is no hash imbalance at all, so buckets can be tight
        if capacity_factor <= 0.0:
            capacity_factor = 1.0 if mesh.devices.size == 1 else 2.0
        self.capacity_factor = capacity_factor
        # staged rows per device that trigger a merge back into the table;
        # smaller = smaller peak sort (the drain sorts cap+staged rows),
        # larger = fewer sorts
        self.drain_threshold = int(drain_threshold) or self.cap // 2
        D = mesh.devices.size
        self.D = D
        # in multi-process runs each controller contributes only its local
        # block of every global array (ref: per-rank table shards,
        # src/DistributedFunctions.h:102-163)
        self.D_local = sum(1 for d in mesh.devices.flat
                           if d.process_index == jax.process_index())
        self.axis = axis = mesh.axis_names[0]
        self.table_cols = [
            mh.to_global(mesh, P(axis, None),
                         np.full((self.D_local, self.cap), SENTINEL,
                                 np.uint32))
            for _ in range(self.W)]
        self.table_counts = mh.to_global(
            mesh, P(axis, None), np.zeros((self.D_local, self.cap), np.int32))
        self.table_weights = mh.to_global(
            mesh, P(axis, None), np.zeros((self.D_local, self.cap),
                                          np.float32))
        self._staged: List[Tuple] = []   # list of (W recv planes [D, C])
        self._staged_rows = 0            # per-device staged row count
        self._staged_real = 0   # exact real (good) observations staged
        self._last_filled = 0   # global max shard fill after last drain
        self.purged_singletons = 0
        self.overflow_retries = 0
        self.total_batches = 0

    def _pad(self, codes, good2d, lengths):
        B = codes.shape[0]
        pad = (-B) % self.D_local
        if pad:
            codes = np.concatenate([codes, np.zeros((pad,) + codes.shape[1:],
                                                    codes.dtype)])
            good2d = np.concatenate(
                [good2d, np.zeros((pad,) + good2d.shape[1:], good2d.dtype)])
            lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
        return codes, good2d, lengths

    def add_batch(self, codes, good2d, lengths, weights2d=None):
        """codes [B, L] u8, good2d [B, NW] bool (exact goodness incl. the
        min-weight discard), lengths [B] i32, optional weights2d [B, NW]
        f32 window weights (default 1.0 per good window).  Routes + stages;
        drains when the staged observations reach the shard capacity.

        In multi-process runs every process must call this the same number
        of times with the same LOCAL batch shape (pad with empty
        batches)."""
        mh = self._mh
        codes, good2d, lengths = self._pad(np.asarray(codes),
                                           np.asarray(good2d),
                                           np.asarray(lengths))
        B, L = codes.shape
        NW = L - self.k + 1
        has_w = weights2d is not None
        if has_w and weights2d.shape[0] != B:
            weights2d = np.concatenate(
                [weights2d, np.zeros((B - weights2d.shape[0], NW),
                                     np.float32)])
        # 2-bit/1-bit wire packing: the host->device link carries ~12x
        # fewer bytes (devices unpack with shift masks)
        codes_p = pack_codes_host(codes)
        good_p = pack_bits_host(good2d)
        N = B * NW // self.D_local   # per-device window count
        C = int(np.ceil(N / self.D * self.capacity_factor))
        axis = self.axis
        while True:
            fn = _route_build_fn(self.mesh, self.k, C, L, has_w)
            args = [mh.to_global(self.mesh, P(axis, None), codes_p),
                    mh.to_global(self.mesh, P(axis, None), good_p),
                    mh.to_global(self.mesh, P(axis), lengths)]
            if has_w:
                args.append(mh.to_global(self.mesh, P(axis, None),
                                         weights2d.astype(np.float32)))
            out = fn(*args)
            recv, overflow = out[:self.W + 1], out[self.W + 1]
            if int(mh.allgather_host(overflow).sum()) == 0:
                break
            C *= 2
            self.overflow_retries += 1
            if C > 64 * N:
                raise RuntimeError("mesh bucket overflow even at C=%d" % C)
        self._staged.append(recv)  # W key planes + weight plane, [D, D*C]
        self._staged_rows += self.D * C
        self._staged_real += int(good2d.sum())
        self.total_batches += 1
        if self._staged_rows >= self.drain_threshold:
            self._drain()

    def _drain(self):
        if not self._staged:
            return
        # PRE-grow so this merge cannot purge below the hard ceiling
        # unless the owner hash skews >2x over uniform (measured 0.2%
        # on real data; a skew purge is the reference's own backstop and
        # purged_singletons reports it): worst case every real staged
        # observation is a new unique, spread per-shard at 2x the
        # uniform share.  The bound must be agreed across processes
        # (same growth steps everywhere), hence the max-reduce.
        if self.max_capacity > self.cap:
            staged = self._mh.allreduce_max_int(self._staged_real)
            need = self._last_filled + (2 * staged) // self.D + 1
            self._maybe_grow(need, headroom=1)
        cols = []
        for w in range(self.W):
            cols.append(jnp.concatenate(
                [self.table_cols[w]] + [s[w] for s in self._staged], axis=1))
        staged_counts = [jnp.ones(s[0].shape, jnp.int32) for s in self._staged]
        counts = jnp.concatenate([self.table_counts] + staged_counts, axis=1)
        weights = jnp.concatenate(
            [self.table_weights] + [s[self.W] for s in self._staged], axis=1)
        R = self.cap + self._staged_rows
        fn = _drain_fn(self.mesh, self.W, self.cap, R)
        out = fn(*cols, counts, weights)
        self.table_cols = list(out[:self.W])
        self.table_counts = out[self.W]
        self.table_weights = out[self.W + 1]
        self.purged_singletons += int(
            self._mh.allgather_host(out[self.W + 2]).sum())
        self._staged = []
        self._staged_rows = 0
        self._staged_real = 0
        filled = int(self._mh.allgather_host(out[self.W + 3]).max())
        self._last_filled = filled
        self._maybe_grow(filled)

    def _maybe_grow(self, rows: int, headroom: int = 2):
        """Grow the per-shard table (4x steps) while rows * headroom >
        cap, up to max_capacity.  Called post-drain with the global max
        shard fill (headroom 2: stay under half full) and pre-drain with
        the worst-case merge size (headroom 1: the drain cannot purge
        below the hard ceiling short of >2x hash skew).  Globally-agreed
        inputs drive the decision, so every process of a multi-host run
        grows in lockstep."""
        while (self.max_capacity > self.cap
               and rows * headroom > self.cap):
            # 4x steps: every distinct cap compiles a fresh drain/pad
            # program, so fewer, larger steps beat tight sizing — the
            # <=4x-of-fill overshoot is still far under the old
            # raw-stream-estimate sizing
            pad = min(3 * self.cap, self.max_capacity - self.cap)
            fn = _pad_table_fn(self.mesh, self.W, pad)
            out = fn(*self.table_cols, self.table_counts, self.table_weights)
            self.table_cols = list(out[:self.W])
            self.table_counts = out[self.W]
            self.table_weights = out[self.W + 1]
            self.cap += pad
            if not self._user_threshold:
                self.drain_threshold = self.cap // 2
            from kmernator_tpu.utils.logging import Log
            Log.debug(1, "mesh shard table grew to %d rows/device "
                      "(driving rows %d x%d)" % (self.cap, rows, headroom))

    # -------------------- lookup (pass 2) --------------------

    def lookup_batch(self, codes, good2d, lengths, min_count: int = 2):
        """Per-window counts for one padded batch against the built shard
        tables.  good2d here marks which windows WANT counts (normally all
        valid windows — counts return regardless of the window's own
        build-goodness, matching host window_count_lookup)."""
        self._drain()
        mh = self._mh
        codes, good2d, lengths = self._pad(np.asarray(codes),
                                           np.asarray(good2d),
                                           np.asarray(lengths))
        B, L = codes.shape
        NW = L - self.k + 1
        codes_p = pack_codes_host(codes)
        good_p = pack_bits_host(good2d)
        N = B * NW // self.D_local
        C = int(np.ceil(N / self.D * self.capacity_factor))
        axis = self.axis
        while True:
            fn = _lookup_fn(self.mesh, self.k, C, self.cap, min_count, L)
            counts2d, overflow = fn(
                mh.to_global(self.mesh, P(axis, None), codes_p),
                mh.to_global(self.mesh, P(axis, None), good_p),
                mh.to_global(self.mesh, P(axis), lengths),
                *self.table_cols, self.table_counts)
            if int(mh.allgather_host(overflow).sum()) == 0:
                # each process gets back the rows it fed (its local block)
                return mh.to_local(self.mesh, P(axis, None), counts2d)
            C *= 2
            self.overflow_retries += 1
            if C > 64 * N:
                raise RuntimeError("mesh lookup bucket overflow at C=%d" % C)

    # -------------------- on-mesh variant purge --------------------

    def purge_variants_mesh(self, variant_sigmas: float,
                            edit_distance: int = 2,
                            min_variant_kmer_depth: float = 512,
                            use_weighted: bool = True, min_depth: int = 2,
                            chunk: int = 128) -> int:
        """Distributed variant purge with no host table materialization
        (ref: src/DistributedFunctions.h:607-747): hamming-shell candidates
        route to owner shards over the same all_to_all fabric as counting;
        the purged-sources-don't-purge fixpoint re-runs rounds until the
        global purge set stabilizes (identical semantics to the host
        KmerSpectrum.purge_variants, thresholds in f32 instead of f64 —
        differences only at exact float boundaries)."""
        if variant_sigmas <= 0.0:
            return 0
        self._drain()
        mh = self._mh
        axis = self.axis
        W, cap, D = self.W, self.cap, self.D
        dist = max(int(edit_distance), 1)
        if use_weighted:
            vals0 = self.table_weights
        else:
            vals0 = self.table_counts.astype(jnp.float32)
        active0 = (vals0 > jnp.float32(min_variant_kmer_depth)) \
            & (self.table_counts > 0)
        zeros = mh.to_global(
            self.mesh, P(axis, None),
            np.zeros((self.D_local, cap), bool))
        prev = zeros
        # all_to_all candidate bucket capacity: per-device candidates per
        # chunk spread over D owners, with the usual skew headroom
        n_cand = chunk * (4 * self.k) ** dist
        C = int(np.ceil(n_cand / D * self.capacity_factor))
        n_purged = 0
        for _ in range(32):
            active = jnp.logical_and(active0, jnp.logical_not(prev))
            n_src = int(mh.allgather_host(
                jnp.sum(active, axis=1).astype(jnp.int32)).max())
            marks = zeros
            for s0 in range(0, max(n_src, 1), chunk):
                while True:
                    fn = _purge_round_fn(self.mesh, self.k, chunk, dist, C,
                                         cap, float(variant_sigmas),
                                         float(min_variant_kmer_depth))
                    s0g = mh.to_global(
                        self.mesh, P(axis),
                        np.full(self.D_local, s0, np.int32))
                    out_marks, overflow = fn(s0g, *self.table_cols, vals0,
                                             active, marks)
                    if int(mh.allgather_host(overflow).sum()) == 0:
                        marks = out_marks
                        break
                    C *= 2
                    self.overflow_retries += 1
                    if C > 256 * n_cand:
                        raise RuntimeError("purge bucket overflow")
            changed = int(mh.allgather_host(
                jnp.sum(marks != prev, axis=1).astype(jnp.int32)).sum())
            prev = marks
            if changed == 0:
                break
        n_purged = int(mh.allgather_host(
            jnp.sum(prev, axis=1).astype(jnp.int32)).sum())
        fn = _apply_purge_fn(self.mesh, W, cap, max(min_depth, 1))
        out = fn(*self.table_cols, self.table_counts, self.table_weights,
                 prev)
        self.table_cols = list(out[:W])
        self.table_counts = out[W]
        self.table_weights = out[W + 1]
        return n_purged

    def purge_min_depth(self, min_depth: int) -> None:
        """Physically drop below-min-depth rows from the shard tables
        (the mesh analogue of KmerSpectrum.purge_min_depth).  Must run
        BEFORE purge_variants_mesh for parity with the host purge order —
        the host path removes singletons from the table first, so they are
        never variant-purge candidates (ref: src/KmerSpectrum.h purge
        order used by apps/FilterReads.cpp:196)."""
        if min_depth <= 1:
            return
        self._drain()
        zeros = self._mh.to_global(
            self.mesh, P(self.axis, None),
            np.zeros((self.D_local, self.cap), bool))
        fn = _apply_purge_fn(self.mesh, self.W, self.cap, min_depth)
        out = fn(*self.table_cols, self.table_counts, self.table_weights,
                 zeros)
        self.table_cols = list(out[:self.W])
        self.table_counts = out[self.W]
        self.table_weights = out[self.W + 1]

    # -------------------- host extraction --------------------

    def finalize(self, min_depth: int = 2, with_weights: bool = False):
        """Gather shard tables to host: (keys [M, W] u32 sorted, counts
        [, weights]).  In multi-process runs every process receives the
        full table."""
        self._drain()
        ks = [self._mh.allgather_host(c).reshape(-1) for c in self.table_cols]
        cnt = self._mh.allgather_host(self.table_counts).reshape(-1)
        wt = self._mh.allgather_host(self.table_weights).reshape(-1)
        real = cnt >= min_depth
        keys = np.stack([c[real] for c in ks], axis=-1)
        counts = cnt[real]
        weights = wt[real]
        from kmernator_tpu.parallel.spectrum import pack_keys
        packed = pack_keys(keys)
        order = np.argsort(packed, kind="stable")
        if with_weights:
            return (keys[order], counts[order].astype(np.int64),
                    weights[order].astype(np.float64))
        return keys[order], counts[order].astype(np.int64)

    def to_host_spectrum(self, min_depth: int = 2):
        from kmernator_tpu.parallel.spectrum import KmerSpectrum, pack_keys
        keys, counts, weights = self.finalize(min_depth, with_weights=True)
        sp = KmerSpectrum(k=self.k)
        sp.keys = pack_keys(keys) if len(keys) else np.zeros(0, np.uint64)
        sp.counts = counts
        sp.weighted = weights
        return sp

    def set_table(self, keys: np.ndarray, counts: np.ndarray,
                  weights: np.ndarray = None):
        """Replace the shard tables from a host (keys [M, W], counts [M])
        table — used to push back a host-side transform (e.g. variant
        purge) before the lookup pass.  Keys are re-sharded by owner hash
        and re-sorted per shard.  In multi-process runs every process must
        call this with the SAME (replicated) host table."""
        from kmernator_tpu.parallel.mesh import owner_hash
        axis = self.mesh.axis_names[0]
        D, cap, W = self.D, self.cap, self.W
        kcols = np.full((W, D, cap), SENTINEL, np.uint32)
        ccols = np.zeros((D, cap), np.int32)
        wcols = np.zeros((D, cap), np.float32)
        if len(keys):
            if weights is None:
                weights = counts.astype(np.float32)
            own = (owner_hash(jnp.asarray(keys)) % np.uint32(D))
            own = np.asarray(own).astype(np.int64)
            for d in range(D):
                sel = np.flatnonzero(own == d)
                if len(sel) > cap:
                    raise RuntimeError("shard %d overflows capacity" % d)
                kcols[:, d, :len(sel)] = keys[sel].T
                ccols[d, :len(sel)] = counts[sel]
                wcols[d, :len(sel)] = weights[sel]
            # per-shard key sort (host; tables are small vs the stream)
            from kmernator_tpu.parallel.spectrum import pack_keys
            for d in range(D):
                packed = pack_keys(np.ascontiguousarray(kcols[:, d, :].T))
                order = np.argsort(packed, kind="stable")
                kcols[:, d, :] = kcols[:, d, order]
                ccols[d, :] = ccols[d, order]
                wcols[d, :] = wcols[d, order]
        # feed each process its local device rows of the global table
        local = np.array([i for i, d in enumerate(self.mesh.devices.flat)
                          if d.process_index == jax.process_index()])
        mh = self._mh
        self.table_cols = [
            mh.to_global(self.mesh, P(axis, None), kcols[w][local])
            for w in range(W)]
        self.table_counts = mh.to_global(self.mesh, P(axis, None),
                                         ccols[local])
        self.table_weights = mh.to_global(self.mesh, P(axis, None),
                                          wcols[local])
        self._staged = []
        self._staged_rows = 0

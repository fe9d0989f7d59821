"""Multi-device sharded k-mer spectrum over a jax.sharding.Mesh.

Replacement for the reference's MPI layer: the hash-sharded
distributed k-mer table (ref: src/DistributedFunctions.h:102-747) becomes a
per-device table shard addressed by a hash of the canonical key, and the
MPIAllToAllMessageBuffer transport (ref: src/MPIBuffer.h:412-1074) becomes
`jax.lax.all_to_all` inside a `shard_map`:

  reads are data-parallel over the 'd' mesh axis
  each device extracts canonical kmers from its shard of reads
  kmers are bucketed by owner = hash(key) % D and exchanged (all_to_all)
  each owner counts its received kmers (sort + segment-sum)
  counts ride the reverse all_to_all back to the source windows

This mirrors the reference's routing exactly (hash bits -> owner rank,
ref: src/Kmer.h:2284-2298) but with XLA collectives over the device
interconnect instead of MPI_Alltoallv, and with fixed-capacity padded buckets instead of dynamic
message buffers (the reference pads its TransmitBuffer per-rank too;
ref: src/MPIBuffer.h:509-600).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from kmernator_tpu.ops.kmer import nwords
from kmernator_tpu.parallel.device_spectrum import (SENTINEL, extract_canonical,
                                                    extract_canonical_cols,
                                                    window_good)


def make_mesh(n_devices: int = None, axis: str = "d") -> Mesh:
    """1-D mesh over the first `n_devices` devices (all by default).
    Raises ValueError unless 1 <= n_devices <= the devices present."""
    devs = jax.devices()
    if n_devices is not None:
        if not 1 <= n_devices <= len(devs):
            raise ValueError("mesh of %d devices requested, %d present"
                             % (n_devices, len(devs)))
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def owner_hash(keys: jax.Array) -> jax.Array:
    """Cheap avalanche mix over the key words -> u32 (murmur3-style
    finalizer).  Plays the role of the reference's lookup3 high-bit rank
    partition (ref: src/Kmer.h:183-268); outputs are decomposition-
    invariant so the hash need not match the reference's."""
    W = keys.shape[-1]
    return owner_hash_cols([keys[..., w] for w in range(W)])


def owner_hash_cols(key_cols) -> jax.Array:
    h = jnp.uint32(0x9E3779B9)
    for col in key_cols:
        h = h ^ col
        h = h * jnp.uint32(0x85EBCA6B)
        h = h ^ (h >> jnp.uint32(13))
        h = h * jnp.uint32(0xC2B2AE35)
        h = h ^ (h >> jnp.uint32(16))
    return h


def _bucket_scatter(keys, good, owner, D: int, C: int):
    """Scatter local windows into a [D, C] padded send buffer.

    Returns (send_keys [D, C, W], send_good [D, C], win_slot [N] int32 — the
    flat slot each window landed in, or -1 if dropped on bucket overflow).
    """
    N, W = keys.shape
    cols, send_good, win_slot, overflow = _bucket_scatter_cols(
        [keys[:, w] for w in range(W)], good, owner, D, C)
    return (jnp.stack(cols, axis=-1), send_good, win_slot, overflow)


def _bucket_scatter_cols(key_cols, good, owner, D: int, C: int):
    """SoA twin of _bucket_scatter: per-word [N] columns in, per-word
    [D, C] send planes out (keeps every vector op off the tiny W minor
    axis).

    Sentinel keys (invalid/pre-masked windows — e.g. every window of a
    read shorter than k) are NOT routed: they would all hash to one owner
    and overflow its bucket.  They are dropped here (win_slot -1 -> count
    0) and do not count as overflow."""
    N = key_cols[0].shape[0]
    sent = jnp.ones(N, dtype=jnp.bool_)
    for col in key_cols:
        sent = sent & (col == SENTINEL)
    # sort dropped rows to the end of each owner run so real rows never
    # overflow because of them
    owner = jnp.where(sent, jnp.int32(D), owner)
    idx = jnp.arange(N, dtype=jnp.int32)
    sowner, sidx = jax.lax.sort([owner, idx], num_keys=1, is_stable=False)
    # rank within each owner run (sorted): i - first_index_of(owner[i])
    first = jnp.searchsorted(sowner, sowner, side="left").astype(jnp.int32)
    pos_in_run = jnp.arange(N, dtype=jnp.int32) - first
    ok = (pos_in_run < C) & (sowner < D)
    slot = sowner * C + pos_in_run
    # extra dummy slot absorbs overflow writes
    tgt = jnp.where(ok, slot, D * C)
    send_cols = []
    for col in key_cols:
        buf = jnp.full(D * C + 1, SENTINEL, dtype=jnp.uint32)
        send_cols.append(
            buf.at[tgt].set(jnp.where(ok, col[sidx], SENTINEL))[:D * C]
            .reshape(D, C))
    send_good = jnp.zeros(D * C + 1, dtype=jnp.int32)
    send_good = send_good.at[tgt].max(
        jnp.where(ok, good[sidx].astype(jnp.int32), 0))[:D * C].reshape(D, C)
    win_slot = jnp.full(N, -1, dtype=jnp.int32)
    win_slot = win_slot.at[sidx].set(jnp.where(ok, slot, -1))
    overflow = jnp.sum((~ok & (sowner < D)).astype(jnp.int32))
    return send_cols, send_good, win_slot, overflow


def _count_received(keys2d, good2d, min_count: int):
    """Count good observations per key over the received [DC] entries.
    Returns (count per received entry, run-length shard table)."""
    DC, W = keys2d.shape
    return _count_received_cols([keys2d[:, w] for w in range(W)], good2d,
                                min_count)


def _count_received_cols(key_cols, good2d, min_count: int):
    """SoA count over received entries using the gather-free monotone-scan
    run totals."""
    W = len(key_cols)
    DC = key_cols[0].shape[0]
    idx = jnp.arange(DC, dtype=jnp.int32)
    s = jax.lax.sort(list(key_cols) + [good2d, idx], num_keys=W, is_stable=False)
    sgood, sidx = s[W], s[W + 1]
    neq = jnp.zeros(DC - 1, dtype=jnp.bool_)
    for w in range(W):
        neq = neq | (s[w][1:] != s[w][:-1])
    boundary = jnp.concatenate([jnp.ones(1, jnp.bool_), neq])
    is_end = jnp.concatenate([neq, jnp.ones(1, jnp.bool_)])
    gcum = jnp.cumsum(sgood.astype(jnp.int32))
    gexcl = gcum - sgood.astype(jnp.int32)
    base = jax.lax.cummax(jnp.where(boundary, gexcl, jnp.int32(-1)))
    total = jax.lax.cummin(
        jnp.where(is_end, gcum, jnp.iinfo(jnp.int32).max), reverse=True)
    run_total = total - base
    cnt = jnp.where(run_total >= min_count, run_total, 0)
    sent_sorted = jnp.ones(DC, dtype=jnp.bool_)
    for w in range(W):
        sent_sorted = sent_sorted & (s[w] == SENTINEL)
    out = jnp.zeros(DC, dtype=jnp.int32).at[sidx].set(
        jnp.where(sent_sorted, 0, cnt))
    keep = boundary & ~sent_sorted & (run_total > 0)
    shard_keys = jnp.stack(
        [jnp.where(keep, c, SENTINEL) for c in s[:W]], axis=-1)
    shard_counts = jnp.where(boundary, run_total, 0)
    return out, shard_keys, shard_counts


def distributed_spectrum_fn(mesh: Mesh, k: int, capacity_factor: float = 2.0,
                            min_count: int = 2,
                            log2_min_weight: float = float(np.log2(0.10))):
    """Build the jitted multi-device spectrum step over `mesh`.

    Input (sharded over 'd' on the batch axis):
      codes [B, L] uint8, logp [B, L] f32, lengths [B] i32
    Output:
      counts [B, NW] int32 — per-window spectrum counts (weak-map purged),
      shard_keys [B-shards..] / shard_counts — per-device table shards.
    """
    D = mesh.devices.size
    axis = mesh.axis_names[0]

    def step(codes, logp, lengths):
        cols, is_fwd, valid = extract_canonical_cols(codes, lengths, k)
        wsum, good = window_good(logp, lengths, k, log2_min_weight)
        B, NW = valid.shape
        N = B * NW
        key_cols = [c.reshape(N) for c in cols]
        g = good.reshape(N) & valid.reshape(N)
        owner = (owner_hash_cols(key_cols) % jnp.uint32(D)).astype(jnp.int32)
        C = int(np.ceil(N / D * capacity_factor))
        send_cols, send_good, win_slot, overflow = _bucket_scatter_cols(
            key_cols, g, owner, D, C)
        a2a = lambda x: jax.lax.all_to_all(x, axis, split_axis=0,
                                           concat_axis=0)
        recv_cols = [a2a(c).reshape(D * C) for c in send_cols]
        recv_good = a2a(send_good)
        cnt_recv, shard_keys, shard_counts = _count_received_cols(
            recv_cols, recv_good.reshape(D * C), min_count)
        cnt_back = a2a(cnt_recv.reshape(D, C))
        flat_back = cnt_back.reshape(D * C)
        counts = jnp.where(win_slot >= 0, flat_back[jnp.maximum(win_slot, 0)], 0)
        counts = jnp.where(valid.reshape(N), counts, 0)
        return counts.reshape(B, NW), shard_keys, shard_counts, overflow[None]

    smapped = shard_map(
        step, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis, None), P(axis), P(axis)))
    return jax.jit(smapped)


def _window_extensions_device(codes, lengths, is_fwd, ext_ok, k):
    """Device-side left/right extension codes per window (mirrors
    ops/extensions.py; ref: src/KmerReadUtils.h:200-236).
    codes [B, L] int32, ext_ok [B, L] bool, is_fwd [B, NW]."""
    B, L = codes.shape
    NW = L - k + 1
    pos = jnp.arange(NW, dtype=jnp.int32)[None, :]
    c = codes.astype(jnp.int32)
    left_codes = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), c[:, :NW - 1]], axis=1)
    left_ok = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.bool_), ext_ok[:, :NW - 1]], axis=1)
    left = jnp.where(pos == 0, 5,
                     jnp.where(left_ok, left_codes, -1))
    # right neighbor of window i is base i+k: a shifted slice (the last
    # window's neighbor is off the end -> padded)
    rc_codes = jnp.concatenate([c[:, k:], jnp.zeros((B, 1), jnp.int32)], axis=1)
    rc_ok = jnp.concatenate([ext_ok[:, k:], jnp.zeros((B, 1), jnp.bool_)], axis=1)
    in_read = (pos + k) < lengths[:, None]
    right = jnp.where(~in_read, 5, jnp.where(rc_ok, rc_codes, -1))

    def comp(e):
        return jnp.where((e >= 0) & (e < 4), 3 - e, e)

    out_left = jnp.where(is_fwd, left, comp(right))
    out_right = jnp.where(is_fwd, right, comp(left))
    return out_left.astype(jnp.int32), out_right.astype(jnp.int32)


def _count_received_ext(keys2d, good2d, el2d, er2d, min_count: int):
    """Like _count_received but also sums 2x6 extension counters per key run
    using the same gather-free monotone-scan trick."""
    DC, W = keys2d.shape
    ops = ([keys2d[:, w] for w in range(W)]
           + [good2d, el2d, er2d])
    s = jax.lax.sort(ops, num_keys=W, is_stable=False)
    skeys = jnp.stack(s[:W], axis=-1)
    sgood, sel, ser = s[W], s[W + 1], s[W + 2]
    neq = jnp.zeros(DC - 1, dtype=jnp.bool_)
    for w in range(W):
        neq = neq | (skeys[1:, w] != skeys[:-1, w])
    boundary = jnp.concatenate([jnp.ones(1, jnp.bool_), neq])
    is_end = jnp.concatenate([boundary[1:], jnp.ones(1, jnp.bool_)])

    def run_sum(col):
        cum = jnp.cumsum(col.astype(jnp.int32))
        excl = cum - col.astype(jnp.int32)
        base = jax.lax.cummax(jnp.where(boundary, excl, jnp.int32(-1)))
        total = jax.lax.cummin(
            jnp.where(is_end, cum, jnp.iinfo(jnp.int32).max), reverse=True)
        return total - base

    cnt = run_sum(sgood)
    ext_cols = []
    for code in range(6):
        ext_cols.append(run_sum(sgood.astype(jnp.bool_) & (sel == code)))
    for code in range(6):
        ext_cols.append(run_sum(sgood.astype(jnp.bool_) & (ser == code)))
    ext = jnp.stack(ext_cols, axis=-1)  # [DC, 12]
    sent = jnp.ones(DC, dtype=jnp.bool_)
    for w in range(W):
        sent = sent & (skeys[:, w] == SENTINEL)
    keep = boundary & ~sent & (cnt >= min_count)
    shard_keys = jnp.where(keep[:, None], skeys, SENTINEL)
    shard_counts = jnp.where(keep, cnt, 0)
    shard_ext = jnp.where(keep[:, None], ext, 0)
    return shard_keys, shard_counts, shard_ext


def distributed_extension_fn(mesh: Mesh, k: int, capacity_factor: float = 2.0,
                             min_count: int = 2):
    """Distributed extension-tracking spectrum (the MeraculousCounter mesh
    path): kmers + their left/right extension observations route to owner
    shards via all_to_all; owners produce (key, count, 2x6 extension
    counters) table shards.  Inputs take precomputed exact good masks and
    extension eligibility (phred >= 20) so outputs are golden-faithful."""
    D = mesh.devices.size
    axis = mesh.axis_names[0]

    def step(codes, good_in, ext_ok, lengths):
        canon, is_fwd, valid = extract_canonical(codes, lengths, k)
        el, er = _window_extensions_device(codes, lengths, is_fwd, ext_ok, k)
        B, NW, W = canon.shape
        N = B * NW
        keys = canon.reshape(N, W)
        g = good_in.reshape(N) & valid.reshape(N)
        keys = jnp.where(g[:, None], keys, SENTINEL)
        owner = (owner_hash(keys) % jnp.uint32(D)).astype(jnp.int32)
        C = int(np.ceil(N / D * capacity_factor))
        el_f = el.reshape(N)
        er_f = er.reshape(N)
        # bucket-scatter keys + payload columns; sentinel (masked) rows are
        # dropped instead of routed — they would all land on one owner
        sent = jnp.ones(N, dtype=jnp.bool_)
        for w in range(W):
            sent = sent & (keys[:, w] == SENTINEL)
        owner = jnp.where(sent, jnp.int32(D), owner)
        idx = jnp.arange(N, dtype=jnp.int32)
        sowner, sidx = jax.lax.sort([owner, idx], num_keys=1, is_stable=False)
        first = jnp.searchsorted(sowner, sowner, side="left").astype(jnp.int32)
        pos_in_run = jnp.arange(N, dtype=jnp.int32) - first
        ok = (pos_in_run < C) & (sowner < D)
        overflow = jnp.sum((~ok & (sowner < D)).astype(jnp.int32))
        slot = jnp.where(ok, sowner * C + pos_in_run, D * C)

        def scatter(col, fill):
            buf = jnp.full(D * C + 1, fill, dtype=col.dtype)
            return buf.at[slot].set(jnp.where(ok, col[sidx], fill))[:D * C]

        send_keys = jnp.stack([scatter(keys[:, w], SENTINEL) for w in range(W)],
                              axis=-1).reshape(D, C, W)
        send_good = scatter(g.astype(jnp.int32), jnp.int32(0)).reshape(D, C)
        send_el = scatter(el_f, jnp.int32(-1)).reshape(D, C)
        send_er = scatter(er_f, jnp.int32(-1)).reshape(D, C)
        a2a = lambda x: jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0)
        rk, rg, rl, rr = a2a(send_keys), a2a(send_good), a2a(send_el), a2a(send_er)
        out = _count_received_ext(rk.reshape(D * C, W), rg.reshape(D * C),
                                  rl.reshape(D * C), rr.reshape(D * C),
                                  min_count)
        return out + (overflow[None],)

    smapped = shard_map(
        step, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis), P(axis, None), P(axis)))
    return jax.jit(smapped)


def distributed_count_fn(mesh: Mesh, k: int, capacity_factor: float = 2.0,
                         min_count: int = 2):
    """Like distributed_spectrum_fn but takes a precomputed per-window good
    mask (e.g. the bit-exact host weight recurrence) instead of deriving it
    from log-probabilities — the golden-faithful multi-device path used by the
    FilterReads --mesh mode (the FilterReads-P analogue)."""
    D = mesh.devices.size
    axis = mesh.axis_names[0]

    def step(codes, good_in, lengths):
        cols, is_fwd, valid = extract_canonical_cols(codes, lengths, k)
        B, NW = valid.shape
        N = B * NW
        key_cols = [c.reshape(N) for c in cols]
        g = good_in.reshape(N) & valid.reshape(N)
        owner = (owner_hash_cols(key_cols) % jnp.uint32(D)).astype(jnp.int32)
        C = int(np.ceil(N / D * capacity_factor))
        send_cols, send_good, win_slot, overflow = _bucket_scatter_cols(
            key_cols, g, owner, D, C)
        a2a = lambda x: jax.lax.all_to_all(x, axis, split_axis=0,
                                           concat_axis=0)
        recv_cols = [a2a(c).reshape(D * C) for c in send_cols]
        recv_good = a2a(send_good)
        cnt_recv, shard_keys, shard_counts = _count_received_cols(
            recv_cols, recv_good.reshape(D * C), min_count)
        cnt_back = a2a(cnt_recv.reshape(D, C))
        flat_back = cnt_back.reshape(D * C)
        counts = jnp.where(win_slot >= 0, flat_back[jnp.maximum(win_slot, 0)], 0)
        counts = jnp.where(valid.reshape(N), counts, 0)
        return counts.reshape(B, NW), overflow[None]

    smapped = shard_map(
        step, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis)))
    return jax.jit(smapped)

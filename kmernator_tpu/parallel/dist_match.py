"""Distributed kmer -> read-id matching over the mesh.

The reference's KmerMatch + MatcherInterface::exchangeGlobalReads
(ref: src/KmerMatch.h:93-186, src/MatcherInterface.h:352-578) builds a
distributed spectrum whose values are full (readId, pos) lists and resolves
contig edge-kmer queries with an all-to-all request/response.  Here:

  build: each device extracts (kmer, global_read_id) observations from its
         read shard, routes them to owner shards (all_to_all), and keeps a
         sorted per-shard index of capped read-id lists
  match: query kmers route to owners (all_to_all), owners gather up to
         MAX_IDS read ids per query, responses ride the reverse all_to_all

Fixed capacities everywhere (the reference caps matches too — maxReadMatches
sampling, ref: MatcherInterface.h:259).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from kmernator_tpu.parallel.mesh import shard_map, owner_hash
from kmernator_tpu.parallel.device_spectrum import SENTINEL, extract_canonical


def _shard_map_unchecked(fn, **kw):
    """shard_map with replication checking off (the matcher's pmax merge is
    replicated by construction)."""
    return shard_map(fn, **kw, check_vma=False)


def build_index_fn(mesh: Mesh, k: int, capacity_factor: float = 2.0):
    """Jitted builder: (codes [B,L], good [B,NW], read_base [B]) ->
    per-shard (keys [C, W], ids [C, max_ids] i32 (-1 pad)).

    read_base carries each read's GLOBAL index so ids are global
    (ref: ReadSet::getGlobalReadIdx)."""
    D = mesh.devices.size
    axis = mesh.axis_names[0]

    def step(codes, good_in, lengths, read_global):
        canon, is_fwd, valid = extract_canonical(codes, lengths, k)
        B, NW, W = canon.shape
        N = B * NW
        keys = canon.reshape(N, W)
        g = good_in.reshape(N) & valid.reshape(N)
        keys = jnp.where(g[:, None], keys, SENTINEL)
        rid = jnp.broadcast_to(read_global[:, None], (B, NW)).reshape(N)
        rid = jnp.where(g, rid, -1)
        owner = (owner_hash(keys) % jnp.uint32(D)).astype(jnp.int32)
        # sentinel (masked) rows are dropped, not routed — they would all
        # hash to one owner and overflow its bucket
        sent = jnp.ones(N, dtype=jnp.bool_)
        for w in range(W):
            sent = sent & (keys[:, w] == SENTINEL)
        owner = jnp.where(sent, jnp.int32(D), owner)
        C = int(np.ceil(N / D * capacity_factor))
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
        send_rid = scatter(rid, jnp.int32(-1)).reshape(D, C)
        a2a = lambda x: jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0)
        rk = a2a(send_keys).reshape(D * C, W)
        rr = a2a(send_rid).reshape(D * C)
        # sort received observations by key; read-id becomes the payload
        ops = [rk[:, w] for w in range(W)] + [rr]
        # rid participates as a key: run contents come out rid-sorted, so
        # max_ids truncation in match_fn is deterministic and independent
        # of sort stability / routing order
        s = jax.lax.sort(ops, num_keys=W + 1, is_stable=False)
        skeys = jnp.stack(s[:W], axis=-1)
        srid = s[W]
        return skeys, srid, overflow[None]

    smapped = shard_map(
        step, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis), P(axis)),
        out_specs=(P(axis, None), P(axis), P(axis)))
    return jax.jit(smapped)


def match_fn(mesh: Mesh, k: int, max_ids: int = 16, min_depth: int = 0):
    """Jitted matcher: queries [Q, W] (replicated) against the sharded
    sorted index -> read ids [Q, max_ids] (global, -1 pad).

    Each device answers the queries it owns; a pmax merge assembles the
    full answer (queries are replicated so no reverse all_to_all is
    needed).  min_depth > 1 suppresses hits whose observation run is
    shorter (the KmerMatch purgeMinDepth gate, ref: src/KmerMatch.h:100)."""
    D = mesh.devices.size
    axis = mesh.axis_names[0]
    eff_min = max(int(min_depth), 1)

    def step(queries, index_keys, index_rid):
        Q, W = queries.shape
        C = index_keys.shape[0]
        me = jax.lax.axis_index(axis)
        owner = (owner_hash(queries) % jnp.uint32(D)).astype(jnp.int32)
        mine = owner == me
        # lexicographic binary search for the run's [start, end) in the
        # sorted shard index (searchsorted left/right over W-word keys)
        def search(side_right):
            lo = jnp.zeros(Q, dtype=jnp.int32)
            hi = jnp.full(Q, C, dtype=jnp.int32)
            for _ in range(int(np.ceil(np.log2(max(C, 2)))) + 1):
                mid = (lo + hi) // 2
                mk = index_keys[jnp.clip(mid, 0, C - 1)]
                less = jnp.zeros(Q, dtype=jnp.bool_)
                eq = jnp.ones(Q, dtype=jnp.bool_)
                for w in range(W):
                    less = less | (eq & (mk[:, w] < queries[:, w]))
                    eq = eq & (mk[:, w] == queries[:, w])
                go_right = (less | eq) if side_right else less
                lo = jnp.where(go_right, mid + 1, lo)
                hi = jnp.where(go_right, hi, mid)
            return lo

        start, end = search(False), search(True)
        nmatch = end - start  # true run length, even beyond max_ids
        # one batched gather of the whole capped run per query
        pos = start[:, None] + jnp.arange(max_ids, dtype=jnp.int32)[None, :]
        valid = (pos < end[:, None]) & mine[:, None]
        if eff_min > 1:
            valid = valid & (nmatch >= eff_min)[:, None]
        rid = index_rid[jnp.clip(pos, 0, C - 1)]
        out = jnp.where(valid, rid, -1)
        # merge across shards: only the owner wrote non-(-1); take the max
        out = jax.lax.pmax(out, axis)
        return out

    smapped = _shard_map_unchecked(
        step, mesh=mesh,
        in_specs=(P(None, None), P(axis, None), P(axis)),
        out_specs=P(None, None))
    return jax.jit(smapped)


class MeshReadIndex:
    """Drop-in mesh-backed replacement for ops.match.KmerReadIndex: the
    read index lives sharded across the device mesh; contig edge-kmer
    queries resolve with one jitted collective call per batch
    (the MatcherInterface::match analogue, ref: src/MatcherInterface.h:150).

    Query batches are padded to powers of two so XLA compiles O(log Q)
    variants, not one per contig count."""

    def __init__(self, mesh, rs, k: int, min_depth: int = 2,
                 min_quality: int = 3, output_base: int = 33,
                 min_kmer_quality: float = 0.10, max_ids: int = 4096,
                 capacity_factor: float = 2.0):
        import jax.numpy as jnp
        from kmernator_tpu.io.reads import BASE_CODE
        from kmernator_tpu.ops.weights import window_weights, good_kmer_mask
        from kmernator_tpu.parallel.device_spectrum import pack_readset

        self.k = k
        self.mesh = mesh
        self.max_ids = max_ids
        D = mesh.devices.size
        L = max(rs.max_length(), k)
        codes, _, lengths = pack_readset(rs, L, min_quality, output_base)
        B = codes.shape[0]
        NW = L - k + 1
        codes_raw = BASE_CODE[rs.seq]
        markup = codes_raw == 4
        p = rs.base_probabilities(min_quality, output_base)
        w = window_weights(p, rs.offsets, markup, k)
        exact_good = good_kmer_mask(w, min_kmer_quality)
        lens = rs.lengths()
        nw = np.maximum(lens - k + 1, 0)
        from kmernator_tpu.parallel.device_spectrum import ragged_to_padded
        good2d = ragged_to_padded(exact_good, nw, NW, fill=False)
        good2d &= ~rs.discarded[:, None]
        pad = (-B) % D
        if pad:
            codes = np.concatenate([codes, np.zeros((pad, L), codes.dtype)])
            good2d = np.concatenate([good2d, np.zeros((pad, NW), bool)])
            lengths = np.concatenate([lengths, np.zeros(pad, np.int32)])
        read_global = np.arange(codes.shape[0], dtype=np.int32)
        cap = capacity_factor
        while True:
            bfn = build_index_fn(mesh, k, cap)
            self._ikeys, self._irid, overflow = bfn(
                jnp.asarray(codes), jnp.asarray(good2d),
                jnp.asarray(lengths), jnp.asarray(read_global))
            if int(np.asarray(overflow).sum()) == 0:
                break
            cap *= 2.0  # hash-skewed reads: double bucket capacity
            if cap > 32.0:
                raise RuntimeError("matcher index bucket overflow even at "
                                   "capacity %g" % cap)
        self._mfn = match_fn(mesh, k, max_ids=max_ids, min_depth=min_depth)
        self.W = int(np.asarray(self._ikeys).shape[-1])

    def match_queries(self, queries: np.ndarray):
        """queries [Q, W] canonical words -> list of Q python sets."""
        import jax.numpy as jnp
        Q = len(queries)
        if Q == 0:
            return []
        Qp = 1 << int(np.ceil(np.log2(max(Q, 1))))
        if Qp > Q:
            pad = np.full((Qp - Q, queries.shape[1]), SENTINEL, np.uint32)
            queries = np.concatenate([queries, pad])
        ids = np.asarray(self._mfn(jnp.asarray(queries), self._ikeys,
                                   self._irid))[:Q]
        return [set(int(x) for x in row if x >= 0) for row in ids]


def mesh_match_pools(index: MeshReadIndex, contigs,
                     max_positions_from_edge: int = 500,
                     max_hits: int = 10000):
    """match_pools over the mesh index: one collective query batch for ALL
    contigs' edge kmers (vs per-contig searchsorted on the host)."""
    from kmernator_tpu.io.reads import BASE_CODE
    from kmernator_tpu.ops.kmer import extract_kmers_flat

    k = index.k
    qrows, owner_contig = [], []
    for ci in range(contigs.n):
        codes_raw = BASE_CODE[np.frombuffer(contigs.get_seq(ci), np.uint8)]
        codes = np.where(codes_raw == 4, 0, codes_raw).astype(np.uint8)
        L = len(codes)
        if L < k:
            continue
        canon, _, _, _ = extract_kmers_flat(codes, np.array([0, L]), k)
        nwq = len(canon)
        max_kmers = max_positions_from_edge - k + 1
        pos = np.arange(nwq)
        sel = (pos <= max_kmers) | (pos >= (nwq - max_kmers if nwq > max_kmers
                                            else 0))
        canon = canon[sel]
        qrows.append(canon)
        owner_contig.extend([ci] * len(canon))
    pools = [set() for _ in range(contigs.n)]
    if not qrows:
        return pools
    queries = np.concatenate(qrows)
    hits = index.match_queries(queries)
    for qi, ci in enumerate(owner_contig):
        pools[ci] |= hits[qi]
    rng = np.random.default_rng(0)
    for ci in range(contigs.n):
        out = pools[ci]
        if max_hits and len(out) > 2 * max_hits:
            frac = (2.0 * max_hits) / len(out)
            pools[ci] = {r for r in out if rng.random() < frac}
    return pools

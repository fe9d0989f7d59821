"""Multi-host runtime: process lifecycle + partitioned IO + gathered output.

Plays the role of ScopedMPIComm + DistributedOfstreamMap
(ref: src/MPIUtils.h:257-391, src/DistributedOfstreamMap.h:67-412) for
multi-process runs: `jax.distributed.initialize`, a global mesh spanning
every process's devices, per-process byte-range input partitions with
pair-preserving resync, and rank-ordered output concatenation (rank 0
first — the reference's append ordering, apps/FilterReads-P.cpp:190-197).

Single-host sessions degrade gracefully (process_count == 1).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None):
    """ref: ScopedMPIComm ctor.  No-op when running single-process.

    The processes of one run share one host, one process per GPU: process
    i opens only GPU i (`local_device_ids`), so no process reserves memory
    on another's card."""
    import jax
    if num_processes is None:
        num_processes = int(os.environ.get("KMERNATOR_TPU_NPROCS", "1"))
    if num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id,
                                   local_device_ids=[process_id])
    os.environ["KMERNATOR_TPU_RANK"] = str(jax.process_index())
    return jax.process_index(), jax.process_count()


def global_mesh(axis: str = "d"):
    """Mesh over every device of every process.  shard_map collectives over
    this mesh are the reference's MPI_Alltoallv equivalent."""
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()), (axis,))


def my_partition(n_items: int) -> slice:
    import jax
    rank, size = jax.process_index(), jax.process_count()
    per = (n_items + size - 1) // size
    return slice(rank * per, min((rank + 1) * per, n_items))


def load_partitioned_reads(paths: List[str], fastq_base_quality: int = 33,
                           output_base_quality: int = 33,
                           comment_stored: bool = True):
    """Each process parses its byte range of every input file
    (ref: ReadSet::appendAllFiles(files, rank, size))."""
    import jax
    from kmernator_tpu.io.reads import load_reads
    rank, size = jax.process_index(), jax.process_count()
    return load_reads(paths, fastq_base_quality, output_base_quality,
                      comment_stored,
                      byte_range=(rank, size) if size > 1 else None)


def to_global(mesh, spec, x):
    """Process-local block -> global sharded array (identity-equivalent in
    single-process runs).  The multi-controller input feed: every process
    contributes its rows of the global batch
    (ref: each MPI rank parsing its own file partition then exchanging,
    src/DistributedFunctions.h:333-458)."""
    import jax
    if jax.process_count() == 1:
        from jax.sharding import NamedSharding
        return jax.device_put(x, NamedSharding(mesh, spec))
    from jax.experimental import multihost_utils
    return multihost_utils.host_local_array_to_global_array(
        np.asarray(x), mesh, spec)


def to_local(mesh, spec, x):
    """Global sharded array -> this process's local block (np)."""
    import jax
    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(
        multihost_utils.global_array_to_host_local_array(x, mesh, spec))


def allgather_host(x) -> np.ndarray:
    """Full (replicated) host copy of a global sharded array."""
    import jax
    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def allreduce_max_int(v: int) -> int:
    """Host-level max across processes (to agree on loop trip counts —
    every process must issue the same collectives)."""
    import jax
    if jax.process_count() == 1:
        return int(v)
    from jax.experimental import multihost_utils
    vals = multihost_utils.process_allgather(np.array([v], np.int64))
    return int(np.max(vals))


def allgather_ints(vals) -> np.ndarray:
    """[P, len(vals)] int64 matrix of every process's small int vector —
    the per-round handshake of the lockstep streaming build (has-data
    flags, padded lengths; ref: the empty-cycle consensus of
    MPIAllToAllMessageBuffer::finalize, src/MPIBuffer.h:922)."""
    import jax
    a = np.asarray(vals, np.int64)
    if jax.process_count() == 1:
        return a[None]
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(a))


def allgather_strings(items: List[str], max_bytes: int = 1 << 16) -> List[str]:
    """Sorted union of string lists across processes (the reference's
    getGlobalKeySet, ref: src/DistributedOfstreamMap.h:149-168) — so every
    process opens the same output files in the same order."""
    import jax
    if jax.process_count() == 1:
        return sorted(set(items))
    from jax.experimental import multihost_utils
    blob = "\n".join(items).encode()
    if len(blob) > max_bytes:
        raise ValueError("key set too large for allgather buffer")
    buf = np.zeros(max_bytes, np.uint8)
    buf[:len(blob)] = np.frombuffer(blob, np.uint8)
    gathered = np.asarray(multihost_utils.process_allgather(buf))
    out = set()
    for row in gathered.reshape(jax.process_count(), max_bytes):
        s = row.tobytes().rstrip(b"\x00").decode()
        out.update(p for p in s.split("\n") if p)
    return sorted(out)


def allgather_blobs(local: bytes, max_bytes: int = 1 << 20) -> List[bytes]:
    """Every process's byte blob, rank-ordered, delivered to all processes
    (a fixed-size allgather; oversized blobs keep their tail)."""
    import jax
    if jax.process_count() == 1:
        return [local]
    from jax.experimental import multihost_utils
    if len(local) > max_bytes - 8:
        local = local[-(max_bytes - 8):]
    buf = np.zeros(max_bytes, np.uint8)
    buf[:8] = np.frombuffer(np.int64(len(local)).tobytes(), np.uint8)
    buf[8:8 + len(local)] = np.frombuffer(local, np.uint8)
    g = np.asarray(multihost_utils.process_allgather(buf)).reshape(
        jax.process_count(), max_bytes)
    out = []
    for row in g:
        n = int(np.frombuffer(row[:8].tobytes(), np.int64)[0])
        out.append(row[8:8 + n].tobytes())
    return out


def write_gathered_file(path: str, local_part: Optional[str]):
    """File-backed write_gathered: rank-ordered concatenation of per-rank
    part FILES, bounded memory for outputs too large to hold as bytes
    (the streaming x distributed output path; ref: DistributedOfstreamMap
    ::concatenateMPI, src/DistributedOfstreamMap.h:118).  Every process
    must call this for the same `path`; `local_part` may be None for a
    rank with no data (an empty part)."""
    import jax
    rank, size = jax.process_index(), jax.process_count()
    if size == 1:
        if local_part is None:
            open(path, "wb").close()
        else:
            os.replace(local_part, path)
        return
    part = "%s--part-%05d" % (path, rank)
    if local_part is None:
        open(part, "wb").close()
    else:
        os.replace(local_part, part)
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices("kmtpu_write_gathered_file:" + path)
    if rank == 0:
        with open(path, "wb") as out:
            for r in range(size):
                p = "%s--part-%05d" % (path, r)
                with open(p, "rb") as f:
                    while True:
                        buf = f.read(8 << 20)
                        if not buf:
                            break
                        out.write(buf)
                os.unlink(p)
    multihost_utils.sync_global_devices("kmtpu_write_gathered_file_done:"
                                        + path)


def write_gathered(path: str, local_data: bytes):
    """Rank-ordered concatenated output: each process writes a rank temp
    file; process 0 concatenates in rank order (ref: DistributedOfstreamMap
    ::concatenateMPI + the rank0-overwrite-then-append ordering)."""
    import jax
    rank, size = jax.process_index(), jax.process_count()
    if size == 1:
        with open(path, "wb") as f:
            f.write(local_data)
        return
    part = "%s--part-%05d" % (path, rank)
    with open(part, "wb") as f:
        f.write(local_data)
    # all processes must finish writing before rank 0 concatenates
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices("kmernator_write_gathered")
    if rank == 0:
        with open(path, "wb") as out:
            for r in range(size):
                p = "%s--part-%05d" % (path, r)
                with open(p, "rb") as f:
                    out.write(f.read())
                os.unlink(p)
    multihost_utils.sync_global_devices("kmernator_write_gathered_done")

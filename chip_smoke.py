"""Device smoke: the k-mer engine's main path on an NVIDIA GPU, checked
against the host oracle.

Usage:
  python chip_smoke.py              phases 1-6 on one GPU
  python chip_smoke.py --cards 4    phases 1, 2 and 4 with --mesh 4

Phases (each prints its lines and seconds; any failure exits non-zero):
  1 device      card name and power limit, JAX version, XLA_FLAGS and the
                compile cache; fails unless JAX's devices are GPUs
  2 native      builds and loads the native IO library for this host
  3 count       count_batch, the extension columns and lookup_join at k=31,
                L=100 against numpy oracles (exact); memory_analysis() of
                count_batch and of the streaming-mesh route, drain and
                lookup programs at phase 4's capacities
  4 filter      FilterReads --streaming --mesh N on a seeded 256 MB FASTQ,
                every output byte-compared with a host run; reads/s and
                peak device bytes
  5 meraculous  MeraculousCounter --mesh 1 -k 21 on a seeded 16 MB FASTQ,
                mercount/mergraph sorted-identical to a host run
  6 assemble    the nucleating assembler --mesh 1 on seeded PhiX174 reads
                and seeds, contigs byte-identical to a host run

This process is the only one that opens the GPU: the apps' device runs
call their `run(argv)` entry here, and every host-oracle run is a child
process with JAX_PLATFORMS=cpu and CUDA_VISIBLE_DEVICES=''.  Work files go
to smoke_out/ beside this script.  The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

from bench import (E2E_FLAGS, LOG2_MIN_WEIGHT, _env,  # noqa: E402
                   _np_good_windows, fastq_reads, golden_logp)
from kmernator_tpu.io.synth import (phix_paired_fastq, phix_seeds_fasta,  # noqa: E402
                                    random_genome_fastq)

K = 31
L = 100
FILTER_MB = 256
MERACULOUS_MB = 16
MERACULOUS_FLAGS = ["--min-kmer-quality", "0", "--min-quality-score", "2",
                    "--kmer-size", "21"]
ASSEMBLE_FLAGS = ["--max-iterations", "2"]


class SmokeFailure(Exception):
    pass


def result_line(platform: str, kind: str, count: int) -> str:
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": {"platform": platform,
                                              "kind": kind, "count": count}})


def compare_dirs(a: str, b: str, sort_lines: bool = False):
    """Differences between the files of directories a and b (names, then
    bytes, or sorted lines with `sort_lines`); empty when equal."""
    diffs = []
    na, nb = sorted(os.listdir(a)), sorted(os.listdir(b))
    if na != nb:
        diffs.append("file names differ: %s vs %s" % (na, nb))
    for name in sorted(set(na) & set(nb)):
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            x, y = fa.read(), fb.read()
        if sort_lines:
            x, y = sorted(x.splitlines()), sorted(y.splitlines())
        if x != y:
            diffs.append("%s differs" % name)
    return diffs


def _fresh(*parts) -> str:
    d = os.path.join(HERE, "smoke_out", *parts)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def run_host(module: str, argv, timeout: float = 900.0) -> float:
    """Host-oracle run of an app in a child that cannot see the GPU;
    returns its seconds."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", module] + list(argv),
                       env=_env(host=True), capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        raise SmokeFailure("host run of %s failed (rc %d):\n%s"
                           % (module, r.returncode, r.stderr[-3000:]))
    return time.perf_counter() - t0


def run_device(app_run, argv):
    """An app's run(argv) in this process on the GPU -> (seconds, seconds
    of backend compilation inside it)."""
    from jax import monitoring
    compiled = [0.0]

    def listen(name, secs, **kw):
        if name == "/jax/core/compile/backend_compile_duration":
            compiled[0] += secs
    monitoring.register_event_duration_secs_listener(listen)
    t0 = time.perf_counter()
    try:
        rc = app_run(list(argv))
    finally:
        monitoring.unregister_event_duration_listener(listen)
    dt = time.perf_counter() - t0
    if rc != 0:
        raise SmokeFailure("device run returned %d" % rc)
    return dt, compiled[0]


def check_equal(name: str, got, want):
    if not np.array_equal(np.asarray(got), np.asarray(want)):
        raise SmokeFailure("%s differs from the oracle" % name)


# ---------------------------------------------------------------- phases

def phase_device(cards: int):
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except OSError as e:
        raise SmokeFailure("no GPU: nvidia-smi unavailable (%s)" % e)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise SmokeFailure("no GPU: nvidia-smi rc %d %s"
                           % (smi.returncode, smi.stderr.strip()))
    print(smi.stdout.strip())
    import jax
    from kmernator_tpu.utils.jaxconfig import (compilation_cache_dir,
                                               enable_compilation_cache)
    enable_compilation_cache()
    print("jax %s; XLA_FLAGS=%r; compile cache %s"
          % (jax.__version__, os.environ.get("XLA_FLAGS", ""),
             compilation_cache_dir()))
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeFailure("no GPU: JAX found %s" % devs)
    if len(devs) < cards:
        raise SmokeFailure("%d GPUs requested, JAX found %d"
                           % (cards, len(devs)))
    print("devices: %d x %s" % (len(devs), devs[0].device_kind))
    return devs[0].platform, devs[0].device_kind, len(devs)


def phase_native():
    import ctypes
    from kmernator_tpu.io.native import build_native, get_lib
    path = build_native("io_native", shared=True)
    ctypes.CDLL(path)
    if get_lib() is None:
        raise SmokeFailure("native library did not load")
    print("native library %s" % os.path.relpath(path, HERE))


def _seeded_batch(b: int, seed: int = 5):
    """b reads of L bases from a random 5 Mbp genome; 1% hard-bad bases,
    10% of reads cut to K..L-1 bases."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 5_000_000, dtype=np.uint8)
    starts = rng.integers(0, len(genome) - L, b)
    codes = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    bad = rng.random((b, L)) < 0.01
    lengths = np.where(rng.random(b) < 0.1, rng.integers(K, L, b),
                       L).astype(np.int32)
    return codes, bad, lengths


def check_count(b: int):
    """Device count table, canonical keys, extension columns and
    lookup_join at batch b vs numpy oracles, exactly."""
    import jax.numpy as jnp
    from kmernator_tpu.ops.extensions import window_extensions
    from kmernator_tpu.ops.kmer import extract_kmers_flat
    from kmernator_tpu.parallel.device_spectrum import (
        count_batch, extract_canonical_cols, lookup_join, window_good)
    from kmernator_tpu.parallel.mesh import _window_extensions_device
    from kmernator_tpu.parallel.spectrum import pack_u64

    codes, bad, lengths = _seeded_batch(b)
    logp = golden_logp(bad)
    # host oracle over the ragged reads
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    flat = np.concatenate([codes[i, :n] for i, n in enumerate(lengths)])
    canon, is_fwd, _, _ = extract_kmers_flat(flat, offsets, K)
    okb = np.concatenate([~bad[i, :n] for i, n in enumerate(lengths)])
    el_h, er_h = window_extensions(flat, okb, offsets, K, is_fwd)
    valid = np.arange(L - K + 1)[None, :] <= (lengths[:, None] - K)
    good = _np_good_windows(logp, lengths, K)[valid]
    uk, uc = np.unique(pack_u64(canon[good]), return_counts=True)

    c, lg, ln = jnp.asarray(codes), jnp.asarray(logp), jnp.asarray(lengths)
    cols, fwd_d, valid_d = extract_canonical_cols(c, ln, K)
    _, good_d = window_good(lg, ln, K, LOG2_MIN_WEIGHT)
    g = (good_d & valid_d).reshape(-1)
    keys, counts, n_unique = count_batch([x.reshape(-1) for x in cols], g, 1)
    keys, counts = np.asarray(keys), np.asarray(counts)
    live = counts > 0
    check_equal("valid windows", np.asarray(valid_d), valid)
    check_equal("canonical keys", np.stack(
        [np.asarray(x)[valid] for x in cols], axis=-1), canon)
    check_equal("good windows", np.asarray(good_d)[valid], good)
    check_equal("table keys", pack_u64(keys[live]), uk)
    check_equal("table counts", counts[live], uc)
    check_equal("unique count", int(n_unique), len(uk))
    el, er = _window_extensions_device(c.astype(jnp.int32), ln, fwd_d,
                                       jnp.asarray(~bad), K)
    check_equal("left extensions", np.asarray(el)[valid], el_h)
    check_equal("right extensions", np.asarray(er)[valid], er_h)

    # lookup: every window's key (hits and misses) plus random keys
    rng = np.random.default_rng(b)
    table = np.stack([(uk >> np.uint64(32)).astype(np.uint32),
                      (uk & np.uint64(0xFFFFFFFF)).astype(np.uint32)], -1)
    queries = np.concatenate([canon, rng.integers(
        0, 2 ** 32 - 1, (len(canon) // 8, 2), dtype=np.uint32)])
    got = np.asarray(lookup_join(jnp.asarray(table),
                                 jnp.asarray(uc.astype(np.int32)),
                                 jnp.asarray(queries)))
    q64 = pack_u64(queries)
    pos = np.clip(np.searchsorted(uk, q64), 0, len(uk) - 1)
    want = np.where(uk[pos] == q64, uc[pos], 0)
    check_equal("lookup_join", got, want)
    print("count b=%d: %d windows, %d good, %d unique, %d lookups: exact"
          % (b, int(valid.sum()), int(good.sum()), len(uk), len(queries)))


def _memory(name: str, fn, *args):
    t0 = time.perf_counter()
    m = fn.lower(*args).compile().memory_analysis()
    print("memory %s: arguments %d, outputs %d, temporaries %d, aliased %d "
          "bytes (compile %.1f s)" % (
              name, m.argument_size_in_bytes, m.output_size_in_bytes,
              m.temp_size_in_bytes, m.alias_size_in_bytes,
              time.perf_counter() - t0))


def mesh_programs_memory(fastq: str, n_devices: int):
    """memory_analysis() of the streaming-mesh programs at the shapes a
    FilterReads --streaming --mesh run over `fastq` uses."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from kmernator_tpu.apps.filter_reads import streaming_mesh_capacity
    from kmernator_tpu.ops.kmer import nwords
    from kmernator_tpu.parallel.device_spectrum import auto_mesh_batch
    from kmernator_tpu.parallel.mesh import make_mesh
    from kmernator_tpu.parallel.mesh_stream import (_drain_fn, _lookup_fn,
                                                    _route_build_fn)
    mesh = make_mesh(n_devices)
    D, W = n_devices, nwords(K)
    Lp = -(-L // 32) * 32          # the app's bucketed pad length
    nw = Lp - K + 1
    b = auto_mesh_batch()
    b += (-b) % D
    cap = streaming_mesh_capacity([fastq], K, D)
    C = int(np.ceil(b * nw / D / D * (1.0 if D == 1 else 2.0)))
    staged = D * C
    R = cap + -(-(cap // 2) // staged) * staged
    print("mesh shapes: %d devices, batch %d reads, L %d, capacity %d "
          "rows/device, drain rows %d" % (D, b, Lp, cap, R))

    def spec(shape, dtype, *axes):
        return jax.ShapeDtypeStruct(shape, dtype, sharding=NamedSharding(
            mesh, P(*axes)))
    batch = (spec((b, Lp // 4), jnp.uint8, "d", None),
             spec((b, -(-nw // 8)), jnp.uint8, "d", None),
             spec((b,), jnp.int32, "d"))
    _memory("route", _route_build_fn(mesh, K, C, Lp, False), *batch)
    _memory("drain", _drain_fn(mesh, W, cap, R),
            *([spec((D, R), jnp.uint32, "d", None)] * W),
            spec((D, R), jnp.int32, "d", None),
            spec((D, R), jnp.float32, "d", None))
    _memory("lookup", _lookup_fn(mesh, K, C, cap, 2, Lp), *batch,
            *([spec((D, cap), jnp.uint32, "d", None)] * W),
            spec((D, cap), jnp.int32, "d", None))


def phase_count(filter_fastq: str):
    import jax
    import jax.numpy as jnp
    from kmernator_tpu.parallel.device_spectrum import (auto_mesh_batch,
                                                        count_batch)
    b0 = auto_mesh_batch()
    for b in (b0, 8192):
        check_count(b)
    n = b0 * (L - K + 1)
    _memory("count_batch b=%d" % b0, count_batch,
            [jax.ShapeDtypeStruct((n,), jnp.uint32)] * 2,
            jax.ShapeDtypeStruct((n,), jnp.bool_))
    mesh_programs_memory(filter_fastq, 1)


def phase_filter(fastq: str, mesh: int, card: str):
    import jax
    from kmernator_tpu.apps import filter_reads
    n_reads = fastq_reads(fastq)
    host, dev = _fresh("filter", "host"), _fresh("filter", "device")
    args = E2E_FLAGS + ["31", fastq]
    t_host = run_host("kmernator_tpu.apps.filter_reads",
                      ["--jax-platform", "cpu", "--out",
                       os.path.join(host, "out")] + args, timeout=1200)
    t_dev, t_compile = run_device(filter_reads.run, [
        "--mesh", str(mesh), "--out", os.path.join(dev, "out")] + args)
    diffs = compare_dirs(dev, host)
    if diffs:
        raise SmokeFailure("filter --mesh %d vs host: %s" % (mesh, diffs))
    stats = jax.devices()[0].memory_stats() or {}
    print("filter --mesh %d: %d reads, %d output files byte-identical to the "
          "host run" % (mesh, n_reads, len(os.listdir(dev))))
    print("filter --mesh %d: device run %.1f s (%.1f s of it compiling), "
          "%.0f reads/s; host run %.1f s; peak device bytes %s (process "
          "peak so far; %s)" % (mesh, t_dev, t_compile, n_reads / t_dev,
                                 t_host, stats.get("peak_bytes_in_use"),
                                 card))


def phase_meraculous(fastq: str):
    from kmernator_tpu.apps import meraculous_counter
    host, dev = _fresh("meraculous", "host"), _fresh("meraculous", "device")
    t_host = run_host("kmernator_tpu.apps.meraculous_counter",
                      MERACULOUS_FLAGS + ["--out", os.path.join(host, "mc"),
                                          fastq])
    t_dev, t_compile = run_device(meraculous_counter.run, [
        "--mesh", "1"] + MERACULOUS_FLAGS + ["--out", os.path.join(dev, "mc"),
                                             fastq])
    diffs = compare_dirs(dev, host, sort_lines=True)
    if diffs:
        raise SmokeFailure("meraculous --mesh 1 vs host: %s" % diffs)
    print("meraculous --mesh 1: %s sorted-identical to the host run; device "
          "%.1f s (%.1f s compiling), host %.1f s"
          % (sorted(os.listdir(dev)), t_dev, t_compile, t_host))


def phase_assemble(reads: str, seeds: str):
    from kmernator_tpu.apps import nucleating_assembler
    host, dev = _fresh("assemble", "host"), _fresh("assemble", "device")
    args = ["--contig-file", seeds] + ASSEMBLE_FLAGS
    t_host = run_host("kmernator_tpu.apps.nucleating_assembler", args + [
        "--out", os.path.join(host, "contigs.fa"), "25", reads])
    t_dev, t_compile = run_device(nucleating_assembler.run, args + [
        "--mesh", "1", "--out", os.path.join(dev, "contigs.fa"), "25", reads])
    diffs = compare_dirs(dev, host)
    if diffs:
        raise SmokeFailure("assembler --mesh 1 vs host: %s" % diffs)
    with open(os.path.join(dev, "contigs.fa"), "rb") as f:
        n = f.read().count(b">")
    print("assemble --mesh 1: %d contigs byte-identical to the host run; "
          "device %.1f s (%.1f s compiling), host %.1f s"
          % (n, t_dev, t_compile, t_host))


def _phase(name: str, fn, *args):
    print("== phase %s" % name, flush=True)
    t0 = time.perf_counter()
    out = fn(*args)
    print("== phase %s ok: %.1f s" % (name, time.perf_counter() - t0),
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: phases 1, 2 and 4 with --mesh 4")
    args = ap.parse_args(argv)
    platform, kind, count = _phase("device", phase_device, args.cards)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    _phase("native", phase_native)
    inputs = _fresh("inputs")
    t0 = time.perf_counter()
    fastq = random_genome_fastq(os.path.join(inputs, "e2e-%dmb.fastq"
                                             % FILTER_MB), FILTER_MB)
    print("generated %s (%d bytes) in %.1f s" % (
        os.path.basename(fastq), os.path.getsize(fastq),
        time.perf_counter() - t0))
    if args.cards == 1:
        _phase("count", phase_count, fastq)
    _phase("filter", phase_filter, fastq, args.cards, card)
    if args.cards == 1:
        mc = random_genome_fastq(os.path.join(inputs, "mc.fastq"),
                                 MERACULOUS_MB, genome_bp=500_000, seed=5)
        _phase("meraculous", phase_meraculous, mc)
        reads = phix_paired_fastq(os.path.join(inputs, "phix.fastq"),
                                  n_pairs=2000, seed=3)
        seeds = phix_seeds_fasta(os.path.join(inputs, "seeds.fa"))
        _phase("assemble", phase_assemble, reads, seeds)
    shutil.rmtree(os.path.join(HERE, "smoke_out"), ignore_errors=True)
    print(result_line(platform, kind, count), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print("FAILED: %s" % e, file=sys.stderr, flush=True)
        sys.exit(1)

"""Real multi-process (jax.distributed over localhost, Gloo collectives)
validation of the multihost runtime — the analogue of the reference's
`mpirun -np N` sweeps (ref: test/runFilterTests.sh:93-128).

Each test spawns N subprocesses with a shared coordinator; every process
holds its own byte-range partition of the input and its own local CPU
devices; the spectrum is sharded over the GLOBAL mesh; output is written
with rank-ordered gathered concatenation."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REF = "/root/reference/test"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(nprocs, argv_fn, devs_per_proc=4, timeout=420):
    port = _free_port()
    procs = []
    for pid in range(nprocs):
        env = dict(os.environ, PYTHONPATH=REPO,
                   XLA_FLAGS="--xla_force_host_platform_device_count=%d"
                   % devs_per_proc)
        env.pop("JAX_PLATFORMS", None)
        procs.append(subprocess.Popen(
            argv_fn(pid, port), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, err.decode()[-3000:]
    return outs


def test_two_process_filter_reads_golden(tmp_path):
    """FilterReads --distributed at 2 processes x 4 devices: gathered
    output must be byte-identical to the reference golden (the
    decomposition-invariance contract)."""
    out = str(tmp_path / "out")

    def argv(pid, port):
        return [sys.executable, "-m", "kmernator_tpu.apps.filter_reads",
                "--jax-platform", "cpu",
                "--distributed", "127.0.0.1:%d" % port,
                "--nprocs", "2", "--procid", str(pid),
                "--mesh-batch", "256",
                "--kmer-scoring-type", "MEDIAN", "--mask-simple-repeats", "0",
                "--artifact-edit-distance", "1",
                "--fastq-output-base-quality", "64",
                "--min-read-length", "25",
                "--out", out, "31", os.path.join(REF, "1000.fastq")]

    _spawn(2, argv)
    mine = open(out + "-MinDepth2-1000.fastq", "rb").read()
    want = open(os.path.join(REF, "1000-Filtered.fastq"), "rb").read()
    assert mine == want


_PRIM = r"""
import os, sys
pid, nprocs, port, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
import jax
jax.config.update("jax_platforms", "cpu")
from kmernator_tpu.parallel import multihost
rank, size = multihost.initialize("127.0.0.1:" + port, nprocs, pid)
assert (rank, size) == (pid, nprocs)
# partitioned load: union of partitions covers every read exactly once
rs = multihost.load_partitioned_reads(["%s/1000.fastq" % "{REF}"])
import numpy as np
from jax.experimental import multihost_utils
counts = multihost_utils.process_allgather(np.array([rs.n], np.int64))
assert int(np.sum(counts)) == 1000, counts
# global mesh + sharded streaming spectrum across processes
mesh = multihost.global_mesh()
assert mesh.devices.size == jax.device_count()
from kmernator_tpu.parallel.mesh_stream import MeshStreamingSpectrum
from kmernator_tpu.io.reads import BASE_CODE
from kmernator_tpu.parallel.device_spectrum import pack_readset
K = 31
L = multihost.allreduce_max_int(max(rs.max_length(), K))
codes, _, lengths = pack_readset(rs, L, 3, 33)
NW = L - K + 1
# SPMD: every process must feed the same LOCAL batch shape — pad the
# shorter partition with empty reads
B = multihost.allreduce_max_int(rs.n)
pad = B - rs.n
codes = np.concatenate([codes, np.zeros((pad, L), codes.dtype)])
lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
good = np.ones((B, NW), dtype=bool)
sp = MeshStreamingSpectrum(mesh, K, capacity=16384)
sp.add_batch(codes, good, lengths)
keys, cnts = sp.finalize(min_depth=1)
total = int(cnts.sum())
# every process sees the same finalized table
totals = multihost_utils.process_allgather(np.array([total], np.int64))
assert (totals == total).all()
# gathered write: rank-ordered concatenation
multihost.write_gathered(tmp + "/gathered.txt",
                         ("rank%d\n" % rank).encode())
multihost_utils.sync_global_devices("test_done")
if rank == 0:
    data = open(tmp + "/gathered.txt").read()
    assert data == "rank0\nrank1\n", repr(data)
    # stash the spectrum total for the host-side check
    open(tmp + "/total.txt", "w").write(str(total))
print("PRIM-OK", rank)
"""


def test_two_process_primitives(tmp_path):
    """initialize / load_partitioned_reads / global mesh streaming build /
    write_gathered all exercised at process_count == 2."""
    script = tmp_path / "prim.py"
    script.write_text(_PRIM.replace("{REF}", REF))

    def argv(pid, port):
        return [sys.executable, str(script), str(pid), "2", str(port),
                str(tmp_path)]

    outs = _spawn(2, argv, devs_per_proc=2)
    for rc, out, err in outs:
        assert b"PRIM-OK" in out
    # cross-check against the single-process oracle: total good windows
    total = int((tmp_path / "total.txt").read_text())
    from kmernator_tpu.io.reads import load_reads
    from kmernator_tpu.ops.kmer import extract_kmers_flat
    from kmernator_tpu.io.reads import BASE_CODE
    rs = load_reads([REF + "/1000.fastq"])
    codes_raw = BASE_CODE[rs.seq]
    codes = np.where(codes_raw == 4, 0, codes_raw).astype(np.uint8)
    canon, _, _, _ = extract_kmers_flat(codes, rs.offsets, 31)
    assert total == len(canon)


def test_two_process_bam_sort(tmp_path):
    """Distributed BamSort (record exchange over the device mesh) must
    produce the same sorted record stream as the single-process sort on
    10k.bam, plus matching unmapped extractions."""
    single = str(tmp_path / "single.bam")
    dist = str(tmp_path / "dist.bam")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    subprocess.run(
        [sys.executable, "-m", "kmernator_tpu.apps.bam_sort",
         "--unmapped-reads", str(tmp_path / "s-un.fastq.gz"),
         "--unmapped-read-pairs", str(tmp_path / "s-pairs.fastq.gz"),
         single, REF + "/10k.bam"],
        check=True, env=env, capture_output=True)

    def argv(pid, port):
        return [sys.executable, "-m", "kmernator_tpu.apps.bam_sort",
                "--jax-platform", "cpu",
                "--distributed", "127.0.0.1:%d" % port,
                "--nprocs", "2", "--procid", str(pid),
                "--unmapped-reads", str(tmp_path / "d-un.fastq.gz"),
                "--unmapped-read-pairs", str(tmp_path / "d-pairs.fastq.gz"),
                dist, REF + "/10k.bam"]

    _spawn(2, argv, devs_per_proc=2)

    from kmernator_tpu.io.bam import load_alignments
    from kmernator_tpu.parallel.bam_exchange import sort_key
    a = load_alignments(single)
    b = load_alignments(dist)
    assert a.header_text == b.header_text and a.ref_names == b.ref_names
    assert a.n == b.n
    # same record multiset, both in nondecreasing coordinate order
    assert sorted(a.records) == sorted(b.records)
    kb = sort_key(b)
    assert (np.diff(kb) >= 0).all()
    import gzip
    for nm in ("un", "pairs"):
        sa = sorted(l for l in gzip.open(
            str(tmp_path / ("s-%s.fastq.gz" % nm))).read().split(b"\n") if l)
        sb = sorted(l for l in gzip.open(
            str(tmp_path / ("d-%s.fastq.gz" % nm))).read().split(b"\n") if l)
        assert sa == sb


def test_gathered_logs_two_process(tmp_path):
    """--gathered-logs: every rank's buffered log lines are emitted
    rank-ordered by process 0 only (ref: src/Log.h:79, Options.h:382)."""
    out = str(tmp_path / "out")

    def argv(pid, port):
        return [sys.executable, "-m", "kmernator_tpu.apps.filter_reads",
                "--jax-platform", "cpu",
                "--distributed", "127.0.0.1:%d" % port,
                "--nprocs", "2", "--procid", str(pid),
                "--mesh-batch", "256", "--verbose", "1",
                "--gathered-logs", "1",
                "--kmer-scoring-type", "MEDIAN", "--mask-simple-repeats", "0",
                "--artifact-edit-distance", "1",
                "--fastq-output-base-quality", "64",
                "--min-read-length", "25",
                "--out", out, "31", os.path.join(REF, "1000.fastq")]

    outs = _spawn(2, argv)
    err0 = outs[0][2].decode()
    err1 = outs[1][2].decode()
    # both ranks' "loaded N reads" lines appear on rank 0, in rank order
    assert err0.count("loaded") == 2
    assert err0.index("[0]") < err0.index("[1]")
    assert "VERBOSE" not in err1


def test_two_process_streaming_distributed_golden(tmp_path):
    """--streaming --distributed at 2 processes (the reference's flagship
    composition: rank-partitioned streaming input feeding the distributed
    table, ref: src/DistributedFunctions.h:333-458): gathered output must
    be byte-identical to BOTH the single-process streaming run and the
    reference golden.  Tiny chunks force multiple chunks per rank; a
    small mesh batch forces multiple lockstep rounds per chunk."""
    ref_in = os.path.join(REF, "1000.fastq")
    flags = ["--kmer-scoring-type", "MEDIAN", "--mask-simple-repeats", "0",
             "--artifact-edit-distance", "1",
             "--fastq-output-base-quality", "64",
             "--min-read-length", "25"]
    single = str(tmp_path / "single")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    subprocess.run([sys.executable, "-m", "kmernator_tpu.apps.filter_reads",
                    "--jax-platform", "cpu", "--streaming",
                    "--streaming-chunk-mb", "0.05", "--threads", "1"]
                   + flags + ["--out", single, "31", ref_in],
                   check=True, env=env, capture_output=True)

    out = str(tmp_path / "dist")

    def argv(pid, port):
        return [sys.executable, "-m", "kmernator_tpu.apps.filter_reads",
                "--jax-platform", "cpu", "--streaming",
                "--streaming-chunk-mb", "0.05",
                "--distributed", "127.0.0.1:%d" % port,
                "--nprocs", "2", "--procid", str(pid),
                "--mesh-batch", "64"] + flags + ["--out", out, "31", ref_in]

    _spawn(2, argv)
    mine = open(out + "-MinDepth2-1000.fastq", "rb").read()
    sgl = open(single + "-MinDepth2-1000.fastq", "rb").read()
    want = open(os.path.join(REF, "1000-Filtered.fastq"), "rb").read()
    assert mine == sgl
    assert mine == want


@pytest.mark.skipif(not os.environ.get("KMTPU_BIG_TESTS"),
                    reason="~10 CPU-min: set KMTPU_BIG_TESTS=1 to run")
def test_streaming_distributed_bounded_rss_512mb(tmp_path):
    """>=512 MB synthetic input through --streaming --distributed at 2
    processes: byte-identical to the single-process streaming engine, and
    per-process peak RSS stays O(chunk + table/P) — far below the 3x-input
    rule the in-memory reference design needs (ref: README.md:112-113).
    Measured on this host (2026-08-19): 2.2 GB/process for a 508 MB input
    (254 MB partition each), flat in input size; the CPU backend charges
    the virtual devices' 'HBM' (shard tables + sort workspace) to host
    RSS, which a real accelerator would not."""
    path = str(tmp_path / "big.fastq")
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 5_000_000, dtype=np.uint8)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    L, n_reads = 100, int(512e6 / 215)
    with open(path, "wb") as f:
        done = 0
        while done < n_reads:
            b = min(200000, n_reads - done)
            starts = rng.integers(0, len(genome) - L, b)
            codes = genome[starts[:, None] + np.arange(L)[None, :]]
            q = np.clip(rng.normal(37, 3, (b, L)), 10, 40).astype(np.uint8) + 33
            f.write(b"".join(
                b"@r%d\n%s\n+\n%s\n" % (done + i, s, qq)
                for i, (s, qq) in enumerate(zip(acgt[codes], q))))
            done += b
    # the generator targets 512e6 bytes and lands ~508 MB (the docstring's
    # measured point); the old `500 << 20` (MiB) bound was a latent unit
    # bug that only surfaced when the gated test actually ran
    assert os.path.getsize(path) >= 500e6

    runner = tmp_path / "runner.py"
    runner.write_text(
        "import resource, sys\n"
        "from kmernator_tpu.apps import filter_reads\n"
        "rc = filter_reads.run(sys.argv[1:])\n"
        "print('MAXRSS_MB=%d'\n"
        "      % (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss"
        " // 1024))\n"
        "sys.exit(rc)\n")
    flags = ["--skip-artifact-filter", "1", "--kmer-scoring-type", "MEDIAN",
             "--min-read-length", "25", "--streaming",
             "--streaming-chunk-mb", "16"]
    # --streaming-parts means DIFFERENT things per engine: mesh-table
    # rows/device for the distributed runs vs spill PART COUNT for the
    # host engine — sharing 1500000 made the reference run build 1.5M
    # part files (hours of file churn; this test had never actually run
    # to completion behind its env gate).  The distributed capacity
    # stays explicit; the host run auto-sizes its parts.
    dist_flags = flags + ["--streaming-parts", "1500000"]

    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    single = str(tmp_path / "single")
    subprocess.run([sys.executable, "-m", "kmernator_tpu.apps.filter_reads",
                    "--jax-platform", "cpu"] + flags +
                   ["--out", single, "31", path],
                   check=True, env=env, capture_output=True)

    out = str(tmp_path / "dist")

    def argv(pid, port):
        return [sys.executable, str(runner), "--jax-platform", "cpu",
                "--distributed", "127.0.0.1:%d" % port,
                "--nprocs", "2", "--procid", str(pid),
                "--mesh-batch", "8192"] + dist_flags + \
               ["--out", out, "31", path]

    outs = _spawn(2, argv, timeout=1800)
    for rc, o, err in outs:
        m = [ln for ln in o.decode().splitlines()
             if ln.startswith("MAXRSS_MB=")]
        assert m, o.decode()[-500:]
        rss = int(m[0].split("=")[1])
        # bounded: table shards + chunk + jax runtime, NOT the partition's
        # 3x-parse footprint (the in-memory rule of README.md:112-113
        # would need ~1.5 GB of parse arrays alone on top)
        assert rss < 2800, "per-process RSS %d MB not bounded" % rss
    base = os.path.basename(path)
    mine = open(out + "-MinDepth2-" + base, "rb").read()
    sgl = open(single + "-MinDepth2-" + base, "rb").read()
    assert mine == sgl

"""Benchmark: canonical 31-mer counting and streaming FilterReads on one GPU.

Usage: python bench.py   (needs an NVIDIA GPU; fails without one)

Stages, each on its own clock:

  count     the device counting path — canonical window extraction,
            log-space quality weighting, and the sort/scan spectrum count
            (parallel/device_spectrum.py) — over synthetic reads at k=31,
            L=100.  The timed loop is ONE dispatch (lax.fori_loop, each step
            counting a distinct dynamic slice of a rolled batch); the single
            readback of the accumulated count forces completion before the
            clock stops.  Before timing, two scalar digests of the device
            count table and of the extension columns are checked against
            the host oracles (GOLDEN, GOLDEN2).
  baseline  native/baseline_count.cpp, a multithreaded C++ open-addressing
            counter standing in for the reference's single-node hot loop,
            over the same workload shape (vs_baseline).
  e2e       FilterReads `--streaming` on a seeded FASTQ (KMTPU_E2E_MB,
            default 256): the host engine (reads/s, beside the C++
            baseline_filter stand-in) and the device engine `--mesh 1`
            on the GPU, whose outputs must equal the host run's bytes.

The device work runs in child processes, one at a time, so one process
holds the GPU; this process never imports JAX.  Host runs hide the GPU
(JAX_PLATFORMS=cpu, CUDA_VISIBLE_DEVICES='').  Prints one JSON line with
the device's platform, kind and count and the card's name and power limit.
"""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

K = 31
L = 100
GENOME = 2_000_000
COVERAGE = 20
STEPS = 1280          # timed fori_loop steps of one batch each
GOLDEN_B = 64         # tiny golden batch

HERE = os.path.dirname(os.path.abspath(__file__))
E2E_MB = int(os.environ.get("KMTPU_E2E_MB", "256"))
E2E_FLAGS = ["--streaming", "--kmer-scoring-type", "MEDIAN",
             "--mask-simple-repeats", "0", "--artifact-edit-distance", "1",
             "--min-read-length", "25"]


def _env(host: bool = False) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    if host:
        env.update(JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    return env


def gpu_identity() -> str:
    """`name, power.limit` of each GPU as nvidia-smi reports them.
    Raises RuntimeError when there is no GPU to query."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError("no GPU: nvidia-smi unavailable (%s)" % e)
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError("no GPU: nvidia-smi rc=%d %s"
                           % (r.returncode, r.stderr.strip()))
    return r.stdout.strip()


def _bench_batch(b: int, l: int = L):
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, GENOME, dtype=np.uint8)
    starts = rng.integers(0, GENOME - l, b)
    return genome[starts[:, None] + np.arange(l)[None, :]]


def _golden_batch(b: int = GOLDEN_B):
    """Small distinct batch for the golden digests: random reads plus
    sprinkled hard-bad bases so the good-window mask is exercised.  The
    margins are huge (-9 per bad base vs the -3.32 window threshold), so
    float-accumulation-order differences between numpy and XLA cumsum
    cannot flip a window."""
    rng = np.random.default_rng(23)
    genome = rng.integers(0, 4, 200_000, dtype=np.uint8)
    starts = rng.integers(0, 200_000 - L, b)
    codes = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    bad = rng.random((b, L)) < 0.01
    lengths = np.full(b, L, dtype=np.int32)
    return codes, bad, lengths


LOG2_MIN_WEIGHT = -3.3219281   # log2(0.1): the MEDIAN-config good threshold
LOGP_GOOD = np.float32(-0.00144)   # ~phred-35 per-base log2 prob
LOGP_BAD = np.float32(-9.0)        # forces any containing window bad


def golden_logp(bad: np.ndarray) -> np.ndarray:
    return np.where(bad, LOGP_BAD, LOGP_GOOD).astype(np.float32)


def _np_good_windows(logp: np.ndarray, lengths: np.ndarray, k: int):
    """numpy twin of device_spectrum.window_good (sliding log2-sum test)."""
    b, l = logp.shape
    cs = np.concatenate([np.zeros((b, 1), np.float32),
                         np.cumsum(logp.astype(np.float32), axis=1)], axis=1)
    wsum = cs[:, k:] - cs[:, :-k]
    pos = np.arange(l - k + 1)[None, :]
    valid = pos <= (lengths[:, None] - k)
    return (wsum > np.float32(LOG2_MIN_WEIGHT)) & valid


# Seeds for the two independent 32-bit table digests (see _digest_np).
_DIGEST_SEEDS = (0x9E3779B9, 0x85EBCA6B)


def _mix32_np(x):
    """splitmix-style 32-bit finalizer (numpy u32, overflow wraps)."""
    x = x.astype(np.uint32, copy=True)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x846CA68B)
        x ^= x >> np.uint32(16)
    return x


def _digest_np(hi, lo, val, seed):
    """Order-insensitive multiset digest over (hi, lo, val) u32 rows:
    mix(mix(mix(val ^ seed) ^ lo) ^ hi) summed mod 2^32.  Insensitive to
    row ORDER (the device table is unsorted with interleaved sentinel
    rows — callers pass only live rows here, the device sums a masked
    version of the same expression) but sensitive to every key bit, the
    value, and multiplicity: a split count (2+3 vs one 5) moves the sum
    because mix is nonlinear.  Two seeds give an effective 64-bit
    comparison from two scalars read back."""
    with np.errstate(over="ignore"):
        h = _mix32_np(np.asarray(val).astype(np.uint32) ^ np.uint32(seed))
        h = _mix32_np(h ^ np.asarray(lo).astype(np.uint32))
        h = _mix32_np(h ^ np.asarray(hi).astype(np.uint32))
        return int(h.sum(dtype=np.uint32))


def _host_count_digests(codes, logp, lengths):
    """Digests of the unique (canonical key, good-count) table via the
    host path (ops/kmer.extract_kmers_flat), the oracle the unit tests
    trust (ref semantics: src/Kmer.h:2161-2299 spectrum counting)."""
    from kmernator_tpu.ops.kmer import extract_kmers_flat
    from kmernator_tpu.parallel.spectrum import pack_u64
    b, l = codes.shape
    flat = codes.reshape(-1).astype(np.uint8)
    offsets = np.arange(b + 1, dtype=np.int64) * l
    canon, _, _, _ = extract_kmers_flat(flat, offsets, K)
    good = _np_good_windows(logp, lengths, K).reshape(-1)
    keys = pack_u64(canon[good])
    uk, uc = np.unique(keys, return_counts=True)
    hi = (uk >> np.uint64(32)).astype(np.uint32)
    lo = (uk & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return [_digest_np(hi, lo, uc, s) for s in _DIGEST_SEEDS]


def _host_ext_digests(codes, logp, lengths):
    """Digests of the multiset of (canonical key, left-ext, right-ext)
    over good windows via the host extension path (ops/extensions.py;
    ref semantics: src/KmerTrackingData.h:153-230 ExtensionTracking)."""
    from kmernator_tpu.ops.extensions import window_extensions
    from kmernator_tpu.ops.kmer import extract_kmers_flat
    b, l = codes.shape
    flat = codes.reshape(-1).astype(np.uint8)
    offsets = np.arange(b + 1, dtype=np.int64) * l
    canon, is_fwd, _, _ = extract_kmers_flat(flat, offsets, K)
    el, er = window_extensions(flat, np.ones(len(flat), bool), offsets, K,
                               is_fwd)
    good = _np_good_windows(logp, lengths, K).reshape(-1)
    val = el.astype(np.int32) * 8 + er.astype(np.int32)
    return [_digest_np(canon[good, 0], canon[good, 1], val[good], s)
            for s in _DIGEST_SEEDS]


def _build_count(codes, logp, lengths, k=K):
    from kmernator_tpu.parallel.device_spectrum import (count_batch,
                                                       extract_canonical_cols,
                                                       window_good)
    cols, is_fwd, valid = extract_canonical_cols(codes, lengths, k)
    wsum, good = window_good(logp, lengths, k, LOG2_MIN_WEIGHT)
    g = (good & valid).reshape(-1)
    return count_batch([c.reshape(-1) for c in cols], g, 1)


def golden_digests():
    """(device, host) digest pairs for the count table and the extension
    columns, computed on JAX's default device."""
    import jax
    import jax.numpy as jnp
    from kmernator_tpu.parallel.device_spectrum import (extract_canonical_cols,
                                                       window_good)
    from kmernator_tpu.parallel.mesh import _window_extensions_device

    def _mix32(x):
        x = x.astype(jnp.uint32)
        x = x ^ (x >> jnp.uint32(16))
        x = x * jnp.uint32(0x7FEB352D)
        x = x ^ (x >> jnp.uint32(15))
        x = x * jnp.uint32(0x846CA68B)
        return x ^ (x >> jnp.uint32(16))

    def _digest_dev(hi, lo, val, live, seed):
        h = _mix32(val.astype(jnp.uint32) ^ jnp.uint32(seed))
        h = _mix32(h ^ lo.astype(jnp.uint32))
        h = _mix32(h ^ hi.astype(jnp.uint32))
        return jnp.sum(jnp.where(live, h, jnp.uint32(0)), dtype=jnp.uint32)

    @jax.jit
    def count_digests(codes, bad, lengths):
        logp = jnp.where(bad, LOGP_BAD, LOGP_GOOD).astype(jnp.float32)
        keys, counts, _ = _build_count(codes, logp, lengths)
        live = counts > 0
        return jnp.stack([_digest_dev(keys[:, 0], keys[:, 1], counts, live, s)
                          for s in _DIGEST_SEEDS])

    @jax.jit
    def ext_digests(codes, bad, lengths):
        logp = jnp.where(bad, LOGP_BAD, LOGP_GOOD).astype(jnp.float32)
        cols, is_fwd, valid = extract_canonical_cols(codes, lengths, K)
        _, good = window_good(logp, lengths, K, LOG2_MIN_WEIGHT)
        g = good & valid
        ext_ok = jnp.ones(codes.shape, dtype=jnp.bool_)
        el, er = _window_extensions_device(codes.astype(jnp.int32), lengths,
                                           is_fwd, ext_ok, K)
        return jnp.stack([_digest_dev(cols[0], cols[1], el * 8 + er, g, s)
                          for s in _DIGEST_SEEDS])

    codes, bad, lengths = _golden_batch()
    args = [jnp.asarray(a) for a in (codes, bad, lengths)]
    logp = golden_logp(bad)
    return ([int(x) for x in np.asarray(count_digests(*args))],
            _host_count_digests(codes, logp, lengths),
            [int(x) for x in np.asarray(ext_digests(*args))],
            _host_ext_digests(codes, logp, lengths))


def count_rate(b: int, l: int = L, steps: int = STEPS):
    """(k-mers/s, compile+first-run seconds) of the device count path at
    batch `b`, read length `l`, k=31: `steps` distinct batches in one
    dispatch, timed with the readback of their summed unique counts."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def run_steps(big_codes, logp, lengths, n):
        def body(i, acc):
            c = lax.dynamic_slice_in_dim(big_codes, i, b, 0)
            return acc + _build_count(c, logp, lengths)[2]
        return lax.fori_loop(0, n, body, jnp.int32(0))

    codes = jnp.asarray(_bench_batch(b, l))
    logp = jnp.full((b, l), LOGP_GOOD, dtype=jnp.float32)
    lengths = jnp.full((b,), l, dtype=jnp.int32)
    # steps extra rows so step i counts rows [i, i+b): distinct work every
    # iteration, immune to loop-invariant hoisting; tiled on the device
    reps = -(-(b + steps) // b)
    big_codes = jnp.concatenate([codes] * reps, axis=0)[:b + steps]
    n_windows = b * (l - K + 1)
    t0 = time.perf_counter()
    warm = int(run_steps(big_codes, logp, lengths, np.int32(2)))
    t_compile = time.perf_counter() - t0
    if not 0 < warm <= 2 * n_windows:
        raise RuntimeError("warm-up count out of range: %d" % warm)
    t0 = time.perf_counter()
    total = int(run_steps(big_codes, logp, lengths, np.int32(steps)))
    dt = time.perf_counter() - t0
    if not 0 < total <= steps * n_windows:
        raise RuntimeError("count out of range: %d" % total)
    return n_windows * steps / dt, t_compile


def device_child(steps: int = STEPS):
    """The device stage (a child process of main, or a test on the CPU):
    prints DEVICE=<json>, GOLDEN=ok|mismatch, GOLDEN2=ok|mismatch and
    RATE=<k-mers/s> at the auto-selected batch."""
    from kmernator_tpu.utils.jaxconfig import enable_compilation_cache
    enable_compilation_cache()
    import jax
    from kmernator_tpu.parallel.device_spectrum import auto_mesh_batch
    d = jax.devices()[0]
    print("DEVICE=" + json.dumps({"platform": d.platform,
                                  "kind": d.device_kind,
                                  "count": len(jax.devices())}), flush=True)
    dev, host, dev2, host2 = golden_digests()
    print("GOLDEN=%s" % ("ok" if dev == host else "mismatch"), flush=True)
    print("GOLDEN2=%s" % ("ok" if dev2 == host2 else "mismatch"), flush=True)
    b = auto_mesh_batch()
    rate, t_compile = count_rate(b, L, steps)
    print("BATCH=%d" % b, flush=True)
    print("COMPILE_S=%.3f" % t_compile, flush=True)
    print("RATE=%.1f" % rate, flush=True)


def _child_lines(code: str, timeout: float) -> dict:
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError("device child failed rc=%d:\n%s"
                           % (r.returncode, r.stderr[-4000:]))
    out = {}
    for line in r.stdout.splitlines():
        if "=" in line:
            key, val = line.split("=", 1)
            out[key] = val
    return out


def baseline_kmers_per_sec() -> float:
    from kmernator_tpu.io.native import build_native
    exe = build_native("baseline_count")
    n_reads = GENOME * COVERAGE // L
    r = subprocess.run([exe, str(n_reads), str(L), str(K), "4", str(GENOME)],
                       capture_output=True, text=True, timeout=120, check=True)
    for line in r.stdout.splitlines():
        if line.startswith("kmers_per_sec="):
            return float(line.split("=")[1])
    raise RuntimeError("baseline produced no rate: %r" % r.stdout)


def fastq_reads(path: str) -> int:
    """Number of records in a FASTQ file (four lines each)."""
    with open(path, "rb") as f:
        return sum(blk.count(b"\n") for blk in iter(
            lambda: f.read(1 << 24), b"")) // 4


def _filter(out_prefix: str, path: str, device: bool) -> float:
    """One timed FilterReads run (host engine, or the device engine with
    --mesh 1) -> seconds."""
    extra = ["--mesh", "1"] if device else ["--jax-platform", "cpu"]
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "kmernator_tpu.apps.filter_reads"]
                   + extra + E2E_FLAGS + ["--out", out_prefix, "31", path],
                   env=_env(host=not device), check=True, capture_output=True,
                   timeout=1800)
    return time.perf_counter() - t0


def e2e(rec: dict, mb: int = E2E_MB):
    from chip_smoke import compare_dirs
    from kmernator_tpu.io.native import build_native
    from kmernator_tpu.io.synth import random_genome_fastq
    work = os.path.join(HERE, "smoke_out", "bench_e2e")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "host"))
    os.makedirs(os.path.join(work, "device"))
    path = random_genome_fastq(os.path.join(HERE, "smoke_out",
                                            "e2e-%dmb.fastq" % mb), mb)
    n_reads = fastq_reads(path)
    t_host = _filter(os.path.join(work, "host", "out"), path, device=False)
    exe = build_native("baseline_filter")
    r = subprocess.run([exe, path, "31", "4", "2",
                        os.path.join(work, "baseline.fastq")],
                       capture_output=True, text=True, timeout=1200,
                       check=True)
    base = [float(l.split("=")[1]) for l in r.stdout.splitlines()
            if l.startswith("reads_per_sec=")][0]
    t_dev = _filter(os.path.join(work, "device", "out"), path, device=True)
    equal = not compare_dirs(os.path.join(work, "host"),
                             os.path.join(work, "device"))
    rec.update({
        "e2e_mb": mb, "e2e_reads": n_reads,
        "e2e_host_reads_per_s": n_reads / t_host,
        "e2e_host_vs_baseline": n_reads / t_host / base,
        "e2e_device_reads_per_s": n_reads / t_dev,
        "e2e_device_equal_host": equal,
    })
    shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    rec = {"card": gpu_identity()}
    lines = _child_lines("import bench; bench.device_child()", 1800)
    rec["device"] = json.loads(lines["DEVICE"])
    if rec["device"]["platform"] != "gpu":
        raise RuntimeError("no GPU: JAX runs on %s" % rec["device"])
    rec["chip_golden_ok"] = lines["GOLDEN"] == "ok"
    rec["chip_golden_ext_ok"] = lines["GOLDEN2"] == "ok"
    rec.update({"metric": "canonical 31-mers counted/sec/device",
                "value": float(lines["RATE"]), "unit": "kmers/s",
                "batch_reads": int(lines["BATCH"]),
                "compile_s": float(lines["COMPILE_S"])})
    rec["vs_baseline"] = rec["value"] / baseline_kmers_per_sec()
    e2e(rec)
    print(json.dumps(rec), flush=True)
    return 0 if (rec["chip_golden_ok"] and rec["chip_golden_ext_ok"]
                 and rec["e2e_device_equal_host"]) else 1


if __name__ == "__main__":
    sys.exit(main())

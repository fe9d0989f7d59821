// Single-node canonical k-mer counting baseline.
//
// Stands in for the reference's single-node hot loop (KmerArrayPair::build
// + KmerSpectrum::append over an open-hash map) as the CPU baseline that
// bench.py compares the device pipeline against.  Independently implemented:
// packs reads 2-bit, extracts canonical (min of forward/revcomp) k-mers and
// counts them in an open-addressing hash table, multithreaded with
// per-thread ownership of hash ranges (the reference's thread partitioning
// strategy).
//
// Usage: baseline_count <n_reads> <read_len> <k> <threads>
// Prints: kmers_per_sec=<float>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <cmath>
#include <random>
#include <thread>
#include <vector>

static inline uint64_t mix64(uint64_t h) {
  h ^= h >> 33; h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33; h *= 0xc4ceb9fe1a85ec53ULL;
  h ^= h >> 33; return h;
}

struct Table {
  // (key, count, weightedCount) — the reference tracks a float weighted
  // count alongside every integer count (ref TrackingData semantics)
  std::vector<uint64_t> keys;
  std::vector<uint32_t> counts;
  std::vector<float> weighted;
  uint64_t mask;
  explicit Table(size_t cap_pow2) : keys(cap_pow2, ~0ULL), counts(cap_pow2, 0),
                                    weighted(cap_pow2, 0.f),
                                    mask(cap_pow2 - 1) {}
  inline void add(uint64_t key, float w) {
    uint64_t h = mix64(key) & mask;
    while (true) {
      if (keys[h] == key) { counts[h]++; weighted[h] += w; return; }
      if (keys[h] == ~0ULL) { keys[h] = key; counts[h] = 1; weighted[h] = w; return; }
      h = (h + 1) & mask;
    }
  }
};

static inline uint64_t revcomp_k(uint64_t x, int k) {
  // complement then reverse 2-bit groups of the low 2k bits
  x = ~x;
  x = ((x & 0x3333333333333333ULL) << 2) | ((x >> 2) & 0x3333333333333333ULL);
  x = ((x & 0x0F0F0F0F0F0F0F0FULL) << 4) | ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL);
  x = __builtin_bswap64(x);
  return x >> (64 - 2 * k);
}

int main(int argc, char** argv) {
  long n_reads = argc > 1 ? atol(argv[1]) : 200000;
  int L = argc > 2 ? atoi(argv[2]) : 100;
  int k = argc > 3 ? atoi(argv[3]) : 31;
  int threads = argc > 4 ? atoi(argv[4]) : (int)std::thread::hardware_concurrency();
  long genome_size = argc > 5 ? atol(argv[5]) : 0;

  std::vector<uint8_t> bases((size_t)n_reads * L);
  std::mt19937_64 rng(42);
  if (genome_size > 0) {
    // reads sampled from a synthetic genome (realistic coverage profile)
    std::vector<uint8_t> genome(genome_size);
    for (auto& b : genome) b = rng() & 3;
    for (long r = 0; r < n_reads; r++) {
      long s = rng() % (genome_size - L);
      memcpy(&bases[(size_t)r * L], &genome[s], L);
    }
  } else {
    for (auto& b : bases) b = rng() & 3;
  }

  long windows_per_read = L - k + 1;
  long total = n_reads * windows_per_read;
  size_t cap = 1; while ((long)cap < total * 2) cap <<= 1;

  auto t0 = std::chrono::steady_clock::now();
  std::vector<Table*> tables(threads);
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) {
    pool.emplace_back([&, t]() {
      // per-thread table over hash-partitioned keys: every thread scans all
      // reads but only inserts keys it owns (the reference's re-scan
      // strategy, lock-free by construction)
      Table* tab = new Table(cap / threads * 2);
      tables[t] = tab;
      const uint64_t kmask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
      // per-base P(correct) as the reference computes for every window
      // (quality product with incremental update, ref KmerReadUtils)
      double ptable[64];
      for (int q = 0; q < 64; q++) ptable[q] = 1.0 - pow(10.0, -q / 10.0);
      for (long r = 0; r < n_reads; r++) {
        const uint8_t* p = &bases[(size_t)r * L];
        uint64_t fwd = 0;
        double weight = 1.0;
        for (int i = 0; i < L; i++) {
          fwd = ((fwd << 2) | p[i]) & kmask;
          double pb = ptable[30 + (p[i] & 7)];
          if (i < k) weight *= pb;
          else weight *= pb / ptable[30 + (p[i - k] & 7)];
          if (i >= k - 1) {
            uint64_t rc = revcomp_k(fwd, k);
            uint64_t canon = fwd < rc ? fwd : rc;
            if ((int)(mix64(canon) % threads) == t && weight > 0.1)
              tab->add(canon, (float)weight);
          }
        }
      }
    });
  }
  for (auto& th : pool) th.join();
  auto t1 = std::chrono::steady_clock::now();
  double secs = std::chrono::duration<double>(t1 - t0).count();
  printf("kmers_per_sec=%.0f\n", total / secs);
  uint64_t uniq = 0;
  for (auto* tab : tables)
    for (size_t i = 0; i < tab->keys.size(); i++)
      if (tab->keys[i] != ~0ULL) uniq++;
  fprintf(stderr, "unique=%llu total=%ld secs=%.3f\n",
          (unsigned long long)uniq, total, secs);
  return 0;
}

// Native IO kernels for the host-side input pipeline.
//
// Replacement for the reference's mmap FASTQ parser hot path
// (ref: src/ReadFileReader.h FastqStreamParser): a single-pass index over
// the raw buffer producing columnar record offsets, plus a packer that
// scatters ragged reads into the dense padded [B, L] device-feed tensors.
// Exposed as a C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libkmernator_io.so io_native.cpp
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>
#include <sys/mman.h>

extern "C" {

// Index 4-line FASTQ records.
// outputs (pre-allocated, capacity records):
//   name_off/name_len: read name (after '@', before first whitespace)
//   comment_off/comment_len: after first whitespace (0-length if none)
//   seq_off/seq_len, qual_off
// returns number of records parsed, or -1 on malformed input.
long fastq_index(const char* data, long size, long capacity,
                 long* name_off, long* name_len,
                 long* comment_off, long* comment_len,
                 long* seq_off, long* seq_len, long* qual_off) {
  long n = 0;
  const char* p = data;
  const char* end = data + size;
  while (p < end && n < capacity) {
    if (*p != '@') return -1;
    const char* nl1 = (const char*)memchr(p, '\n', end - p);
    if (!nl1) break;
    const char* seq = nl1 + 1;
    const char* nl2 = (const char*)memchr(seq, '\n', end - seq);
    if (!nl2) break;
    const char* plus = nl2 + 1;
    if (plus >= end || *plus != '+') return -1;
    const char* nl3 = (const char*)memchr(plus, '\n', end - plus);
    if (!nl3) break;
    const char* qual = nl3 + 1;
    const char* nl4 = (const char*)memchr(qual, '\n', end - qual);
    const char* qend = nl4 ? nl4 : end;
    long slen = nl2 - seq;
    if (qend - qual != slen) return -1;
    // split name/comment at first space/tab/CR
    const char* name = p + 1;
    const char* sp = name;
    while (sp < nl1 && *sp != ' ' && *sp != '\t' && *sp != '\r') sp++;
    name_off[n] = name - data;
    name_len[n] = sp - name;
    if (sp < nl1 && (nl1 - sp) >= 2) {
      comment_off[n] = sp + 1 - data;
      long cl = nl1 - (sp + 1);
      while (cl > 0 && (data[comment_off[n] + cl - 1] == '\r')) cl--;
      comment_len[n] = cl;
    } else {
      comment_off[n] = 0;
      comment_len[n] = 0;
    }
    seq_off[n] = seq - data;
    seq_len[n] = slen;
    qual_off[n] = qual - data;
    n++;
    p = nl4 ? nl4 + 1 : end;
  }
  return n;
}

// Normalize bases in place-ish: acgt -> ACGT, '.' -> 'N' (writes to out).
void normalize_bases(const unsigned char* in, long size, unsigned char* out) {
  static unsigned char table[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; i++) table[i] = (unsigned char)i;
    table['a'] = 'A'; table['c'] = 'C'; table['g'] = 'G'; table['t'] = 'T';
    table['.'] = 'N';
    init = true;
  }
  for (long i = 0; i < size; i++) out[i] = table[in[i]];
}

// Scatter ragged reads into dense padded [B, L] tensors:
//   codes: 0..3 (non-ACGT -> 0), logp: log2 P(correct) from a 256-entry
//   per-char table (markup positions forced to logp_floor).
void pack_batch(const unsigned char* seq, const unsigned char* qual,
                const long* offsets, long n_reads, long L,
                const double* logp_table /*256, indexed by qual char*/,
                float logp_floor,
                unsigned char* codes_out /*B*L*/, float* logp_out /*B*L*/,
                int* lengths_out /*B*/) {
  static signed char code_table[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; i++) code_table[i] = -1;
    code_table['A'] = 0; code_table['C'] = 1; code_table['G'] = 2;
    code_table['T'] = 3;
    code_table['a'] = 0; code_table['c'] = 1; code_table['g'] = 2;
    code_table['t'] = 3;
    init = true;
  }
  for (long r = 0; r < n_reads; r++) {
    long s = offsets[r], e = offsets[r + 1];
    long len = e - s;
    if (len > L) len = L;
    lengths_out[r] = (int)len;
    unsigned char* crow = codes_out + r * L;
    float* lrow = logp_out + r * L;
    for (long i = 0; i < len; i++) {
      signed char c = code_table[seq[s + i]];
      if (c < 0) {
        crow[i] = 0;
        lrow[i] = logp_floor;
      } else {
        crow[i] = (unsigned char)c;
        lrow[i] = (float)logp_table[qual[s + i]];
      }
    }
    for (long i = len; i < L; i++) {
      crow[i] = 0;
      lrow[i] = logp_floor;
    }
  }
}

// Pack straight from the raw FASTQ buffer using the index arrays —
// no intermediate ragged gather.
void pack_batch_idx(const unsigned char* data,
                    const long* seq_off, const long* qual_off,
                    const long* seq_len, long n_reads, long L,
                    const double* logp_table, float logp_floor,
                    unsigned char* codes_out, float* logp_out,
                    int* lengths_out) {
  static signed char code_table[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; i++) code_table[i] = -1;
    code_table['A'] = 0; code_table['C'] = 1; code_table['G'] = 2;
    code_table['T'] = 3;
    code_table['a'] = 0; code_table['c'] = 1; code_table['g'] = 2;
    code_table['t'] = 3;
    init = true;
  }
  for (long r = 0; r < n_reads; r++) {
    const unsigned char* seq = data + seq_off[r];
    const unsigned char* qual = data + qual_off[r];
    long len = seq_len[r];
    if (len > L) len = L;
    lengths_out[r] = (int)len;
    unsigned char* crow = codes_out + r * L;
    float* lrow = logp_out + r * L;
    for (long i = 0; i < len; i++) {
      signed char c = code_table[seq[i]];
      if (c < 0) {
        crow[i] = 0;
        lrow[i] = logp_floor;
      } else {
        crow[i] = (unsigned char)c;
        lrow[i] = (float)logp_table[qual[i]];
      }
    }
    for (long i = len; i < L; i++) {
      crow[i] = 0;
      lrow[i] = logp_floor;
    }
  }
}

// Find the start of the next plausible FASTQ record at or after p
// (line starting '@' whose +2 line starts '+' and whose qual length matches
// the seq length) — the record-boundary resync the reference uses to split
// one file across ranks (ref: src/ReadFileReader.h:657-740).
static const char* next_record_start(const char* p, const char* end) {
  while (p < end) {
    if (*p == '@') {
      const char* nl1 = (const char*)memchr(p, '\n', end - p);
      if (!nl1) return end;
      const char* seq = nl1 + 1;
      const char* nl2 = (const char*)memchr(seq, '\n', end - seq);
      if (!nl2) return end;
      const char* plus = nl2 + 1;
      if (plus < end && *plus == '+') {
        const char* nl3 = (const char*)memchr(plus, '\n', end - plus);
        if (!nl3) return end;
        const char* qual = nl3 + 1;
        const char* nl4 = (const char*)memchr(qual, '\n', end - qual);
        const char* qe = nl4 ? nl4 : end;
        if (qe - qual == nl2 - seq) return p;
      }
    }
    const char* nl = (const char*)memchr(p, '\n', end - p);
    if (!nl) return end;
    p = nl + 1;
  }
  return end;
}

// Multithreaded index: chunk the buffer at validated record boundaries,
// index each region into scratch vectors, then concatenate in order.
long fastq_index_mt(const char* data, long size, long capacity,
                    long* name_off, long* name_len,
                    long* comment_off, long* comment_len,
                    long* seq_off, long* seq_len, long* qual_off,
                    int n_threads) {
  if (n_threads <= 1 || size < (8L << 20)) {
    return fastq_index(data, size, capacity, name_off, name_len,
                       comment_off, comment_len, seq_off, seq_len, qual_off);
  }
  const char* end = data + size;
  std::vector<const char*> starts(n_threads + 1);
  starts[0] = data;
  for (int t = 1; t < n_threads; t++) {
    const char* guess = data + (size / n_threads) * t;
    starts[t] = next_record_start(guess, end);
  }
  starts[n_threads] = end;
  struct Cols { std::vector<long> a[7]; long n = 0; bool bad = false; };
  std::vector<Cols> parts(n_threads);
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; t++) {
    ts.emplace_back([&, t]() {
      const char* s = starts[t];
      const char* e = starts[t + 1];
      if (s >= e) return;
      long lines = 0;  // exact line count -> tight scratch capacity
      for (const char* q = s;
           (q = (const char*)memchr(q, '\n', e - q)) != nullptr; q++) lines++;
      long cap = lines / 4 + 2;
      Cols& c = parts[t];
      for (int i = 0; i < 7; i++) c.a[i].resize(cap);
      long n = fastq_index(s, e - s, cap, c.a[0].data(), c.a[1].data(),
                           c.a[2].data(), c.a[3].data(), c.a[4].data(),
                           c.a[5].data(), c.a[6].data());
      if (n < 0) { c.bad = true; return; }
      c.n = n;
      long base = s - data;  // offsets are region-relative; lengths are not
      for (int i : {0, 2, 4, 6}) {
        // comment_off of 0 means "no comment" — keep it 0
        for (long j = 0; j < n; j++)
          if (i != 2 || c.a[i][j] != 0) c.a[i][j] += base;
      }
    });
  }
  for (auto& th : ts) th.join();
  long total = 0;
  for (int t = 0; t < n_threads; t++) {
    if (parts[t].bad) return -1;
    total += parts[t].n;
  }
  if (total > capacity) return -1;
  long* outs[7] = {name_off, name_len, comment_off, comment_len,
                   seq_off, seq_len, qual_off};
  long at = 0;
  for (int t = 0; t < n_threads; t++) {
    long n = parts[t].n;
    for (int i = 0; i < 7; i++)
      memcpy(outs[i] + at, parts[t].a[i].data(), n * sizeof(long));
    at += n;
  }
  return total;
}

// Pack codes + RAW quality bytes (device-side logp conversion): the qual
// byte is the transfer format (1B/base instead of a 4B float), with 0
// forced at markup/pad positions so the device table maps them to the
// -inf floor.
void pack_batch_qual(const unsigned char* data,
                     const long* seq_off, const long* qual_off,
                     const long* seq_len, long n_reads, long L,
                     unsigned char* codes_out, unsigned char* qual_out,
                     int* lengths_out) {
  static signed char code_table[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; i++) code_table[i] = -1;
    code_table['A'] = 0; code_table['C'] = 1; code_table['G'] = 2;
    code_table['T'] = 3;
    code_table['a'] = 0; code_table['c'] = 1; code_table['g'] = 2;
    code_table['t'] = 3;
    init = true;
  }
  for (long r = 0; r < n_reads; r++) {
    const unsigned char* seq = data + seq_off[r];
    const unsigned char* qual = data + qual_off[r];
    long len = seq_len[r];
    if (len > L) len = L;
    lengths_out[r] = (int)len;
    unsigned char* crow = codes_out + r * L;
    unsigned char* qrow = qual_out + r * L;
    for (long i = 0; i < len; i++) {
      signed char c = code_table[seq[i]];
      crow[i] = c < 0 ? 0 : (unsigned char)c;
      qrow[i] = c < 0 ? 0 : qual[i];
    }
    for (long i = len; i < L; i++) { crow[i] = 0; qrow[i] = 0; }
  }
}

// 2-bit packed codes (4 bases/byte, base j in bits 6-2*(j%4) — the
// reference's TwoBitSequence wire format, ref: src/TwoBitSequence.h) +
// raw qual bytes.  codes2 row stride is (L+3)/4.
void pack_batch_2bit_qual(const unsigned char* data,
                          const long* seq_off, const long* qual_off,
                          const long* seq_len, long n_reads, long L,
                          unsigned char* codes2_out, unsigned char* qual_out,
                          int* lengths_out) {
  static signed char code_table[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; i++) code_table[i] = -1;
    code_table['A'] = 0; code_table['C'] = 1; code_table['G'] = 2;
    code_table['T'] = 3;
    code_table['a'] = 0; code_table['c'] = 1; code_table['g'] = 2;
    code_table['t'] = 3;
    init = true;
  }
  long Lb = (L + 3) / 4;
  for (long r = 0; r < n_reads; r++) {
    const unsigned char* seq = data + seq_off[r];
    const unsigned char* qual = data + qual_off[r];
    long len = seq_len[r];
    if (len > L) len = L;
    lengths_out[r] = (int)len;
    unsigned char* crow = codes2_out + r * Lb;
    unsigned char* qrow = qual_out + r * L;
    memset(crow, 0, Lb);
    for (long i = 0; i < len; i++) {
      signed char c = code_table[seq[i]];
      unsigned char cc = c < 0 ? 0 : (unsigned char)c;
      crow[i >> 2] |= cc << (6 - 2 * (i & 3));
      qrow[i] = c < 0 ? 0 : qual[i];
    }
    for (long i = len; i < L; i++) qrow[i] = 0;
  }
}

void pack_batch_2bit_qual_mt(const unsigned char* data,
                             const long* seq_off, const long* qual_off,
                             const long* seq_len, long n_reads, long L,
                             unsigned char* codes2_out, unsigned char* qual_out,
                             int* lengths_out, int n_threads) {
  if (n_threads <= 1 || n_reads < 4096) {
    pack_batch_2bit_qual(data, seq_off, qual_off, seq_len, n_reads, L,
                         codes2_out, qual_out, lengths_out);
    return;
  }
  long Lb = (L + 3) / 4;
  std::vector<std::thread> ts;
  long chunk = (n_reads + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk;
    long e = s + chunk < n_reads ? s + chunk : n_reads;
    if (s >= e) break;
    ts.emplace_back([=]() {
      pack_batch_2bit_qual(data, seq_off + s, qual_off + s, seq_len + s,
                           e - s, L, codes2_out + s * Lb, qual_out + s * L,
                           lengths_out + s);
    });
  }
  for (auto& th : ts) th.join();
}

void pack_batch_qual_mt(const unsigned char* data,
                        const long* seq_off, const long* qual_off,
                        const long* seq_len, long n_reads, long L,
                        unsigned char* codes_out, unsigned char* qual_out,
                        int* lengths_out, int n_threads) {
  if (n_threads <= 1 || n_reads < 4096) {
    pack_batch_qual(data, seq_off, qual_off, seq_len, n_reads, L,
                    codes_out, qual_out, lengths_out);
    return;
  }
  std::vector<std::thread> ts;
  long chunk = (n_reads + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk;
    long e = s + chunk < n_reads ? s + chunk : n_reads;
    if (s >= e) break;
    ts.emplace_back([=]() {
      pack_batch_qual(data, seq_off + s, qual_off + s, seq_len + s, e - s, L,
                      codes_out + s * L, qual_out + s * L, lengths_out + s);
    });
  }
  for (auto& th : ts) th.join();
}

// Multithreaded pack: reads are independent rows, so split the batch
// across worker threads (the reference's OpenMP read loop,
// ref: src/KmerSpectrum.h:1932-2075, recast as a packer).
void pack_batch_idx_mt(const unsigned char* data,
                       const long* seq_off, const long* qual_off,
                       const long* seq_len, long n_reads, long L,
                       const double* logp_table, float logp_floor,
                       unsigned char* codes_out, float* logp_out,
                       int* lengths_out, int n_threads) {
  if (n_threads <= 1 || n_reads < 4096) {
    pack_batch_idx(data, seq_off, qual_off, seq_len, n_reads, L,
                   logp_table, logp_floor, codes_out, logp_out, lengths_out);
    return;
  }
  std::vector<std::thread> ts;
  long chunk = (n_reads + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk;
    long e = s + chunk < n_reads ? s + chunk : n_reads;
    if (s >= e) break;
    ts.emplace_back([=]() {
      pack_batch_idx(data, seq_off + s, qual_off + s, seq_len + s, e - s, L,
                     logp_table, logp_floor, codes_out + s * L,
                     logp_out + s * L, lengths_out + s);
    });
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Meraculous dump formatter (ref: src/Meraculous.h:107-133): decodes the
// canonical u64 key AND its reverse complement and emits both lines with a
// single-pass itoa — the reference's per-kmer ostream loop, minus the
// streams and the host-side string materialization.  Threaded via a length
// pre-pass so each worker writes its own byte range.
// ---------------------------------------------------------------------------

static inline int u64_digits(unsigned long long v) {
  int d = 1;
  while (v >= 10) { v /= 10; d++; }
  return d;
}

static inline unsigned char* write_u64(unsigned char* p, unsigned long long v) {
  int d = u64_digits(v);
  for (int i = d - 1; i >= 0; i--) { p[i] = '0' + (v % 10); v /= 10; }
  return p + d;
}

static const char BASES[4] = {'A', 'C', 'G', 'T'};

// base i of a canonical key packed like ops/kmer.py pack_u64:
// code(i) = (key >> (62 - 2*i)) & 3
static inline void decode_fwd(unsigned long long key, int k, unsigned char* b) {
  for (int i = 0; i < k; i++) b[i] = BASES[(key >> (62 - 2 * i)) & 3];
}

static inline void decode_rc(unsigned long long key, int k, unsigned char* b) {
  for (int i = 0; i < k; i++)
    b[i] = BASES[3 - ((key >> (62 - 2 * (k - 1 - i))) & 3)];
}

// Writes, per kmer, the forward line with cols_f and the revcomp line with
// cols_r (row-major [M, ncols] each).  tail_zero appends the mergraph
// " ... 0" trailing counter.  Returns bytes written from start_byte.
static long mer_range(const unsigned long long* keys, int k,
                      const long long* cols_f, const long long* cols_r,
                      int ncols, int tail_zero, unsigned char* out,
                      long start_byte, long s, long e) {
  unsigned char* p = out + start_byte;
  for (long i = s; i < e; i++) {
    for (int strand = 0; strand < 2; strand++) {
      if (strand == 0) decode_fwd(keys[i], k, p);
      else decode_rc(keys[i], k, p);
      p += k;
      *p++ = '\t';
      const long long* cols = strand == 0 ? cols_f : cols_r;
      for (int c = 0; c < ncols; c++) {
        long long v = cols[i * ncols + c];
        p = write_u64(p, (unsigned long long)(v < 0 ? 0 : v));
        if (c + 1 < ncols || tail_zero) *p++ = ' ';
      }
      if (tail_zero) *p++ = '0';
      *p++ = '\n';
    }
  }
  return (long)(p - (out + start_byte));
}

static long mer_range_bytes(int k, const long long* cols_f,
                            const long long* cols_r, int ncols,
                            int tail_zero, long s, long e) {
  long bytes = 0;
  for (long i = s; i < e; i++) {
    for (int strand = 0; strand < 2; strand++) {
      const long long* cols = strand == 0 ? cols_f : cols_r;
      bytes += k + 2 + (tail_zero ? 1 : 0);
      for (int c = 0; c < ncols; c++) {
        long long v = cols[i * ncols + c];
        bytes += u64_digits((unsigned long long)(v < 0 ? 0 : v));
        if (c + 1 < ncols || tail_zero) bytes++;
      }
    }
  }
  return bytes;
}

extern "C" {

long format_mer_lines(const unsigned long long* keys, long M, int k,
                      const long long* cols_f, const long long* cols_r,
                      int ncols, int tail_zero, unsigned char* out,
                      int n_threads) {
  if (n_threads <= 1 || M < (1 << 15)) {
    return mer_range(keys, k, cols_f, cols_r, ncols, tail_zero, out, 0, 0, M);
  }
  long chunk = (M + n_threads - 1) / n_threads;
  std::vector<long> sizes(n_threads, 0);
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk, e = s + chunk < M ? s + chunk : M;
    if (s >= e) break;
    ts.emplace_back([=, &sizes]() {
      sizes[t] = mer_range_bytes(k, cols_f, cols_r, ncols, tail_zero, s, e);
    });
  }
  for (auto& th : ts) th.join();
  ts.clear();
  std::vector<long> offs(n_threads + 1, 0);
  for (int t = 0; t < n_threads; t++) offs[t + 1] = offs[t] + sizes[t];
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk, e = s + chunk < M ? s + chunk : M;
    if (s >= e) break;
    long base = offs[t];
    ts.emplace_back([=]() {
      mer_range(keys, k, cols_f, cols_r, ncols, tail_zero, out, base, s, e);
    });
  }
  for (auto& th : ts) th.join();
  return offs[n_threads];
}

}  // extern "C"

// ---- canonical k-mer observation kernel (k <= 32) ----
//
// Native fast path of apps/filter_reads._chunk_observations: canonical
// window keys (u64, matching ops/kmer.extract_kmers_flat + pack_keys: base
// 0 in the top 2 bits, pad bits zero) and bit-exact window weights
// (ops/weights.window_weights — the reference's incremental product with
// 1024-window resync, ref: src/KmerReadUtils.h:176-248).  Threads own read
// ranges; output slices are disjoint by construction.

static inline uint64_t ko_revcomp(uint64_t x, int k) {
  x = ~x;
  x = ((x & 0x3333333333333333ULL) << 2) | ((x >> 2) & 0x3333333333333333ULL);
  x = ((x & 0x0F0F0F0F0F0F0F0FULL) << 4) | ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL);
  x = __builtin_bswap64(x);
  return x >> (64 - 2 * k);
}

static void ko_range(const uint8_t* codes, const uint8_t* markup,
                     const double* p, const int64_t* offsets,
                     const int64_t* woff, long r0, long r1, int k,
                     uint64_t* keys_out, double* w_out) {
  const uint64_t kmask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
  const int up = 64 - 2 * k;
  for (long r = r0; r < r1; r++) {
    const long s = offsets[r];
    const long L = offsets[r + 1] - s;
    const long nw = L - k + 1;
    if (nw <= 0) continue;
    uint64_t* ko = keys_out + woff[r];
    double* wo = w_out + woff[r];
    // prime the first window's rolling forward code
    uint64_t fwd = 0;
    for (int j = 0; j < k - 1; j++) fwd = (fwd << 2) | codes[s + j];
    double w = 0.0;
    bool prev_bad = false;
    for (long i = 0; i < nw; i++) {
      fwd = ((fwd << 2) | codes[s + i + k - 1]) & kmask;
      uint64_t rc = ko_revcomp(fwd, k);
      uint64_t canon = fwd < rc ? fwd : rc;
      ko[i] = canon << up;
      bool bad = false;
      if (i == 0 || (i & 1023) == 0 || prev_bad) {
        w = 1.0;  // seed: sequential product, matching np.cumprod order
        for (int j = 0; j < k; j++) w = w * p[s + i + j];
      } else {
        double ratio = p[s + i + k - 1] / p[s + i - 1];
        w = w * ratio;
      }
      // bad = window contains a zero-probability base or a markup base
      // (the numpy path derives this from prefix sums; here scan only when
      // plausible: w==0 implies a zero base; markup needs the flag scan)
      if (w == 0.0) bad = true;
      bool marked = false;
      for (int j = 0; j < k; j++) {
        if (markup[s + i + j]) { marked = true; break; }
      }
      if (marked) { bad = true; w = 0.0; wo[i] = 0.0; }
      else wo[i] = w;
      prev_bad = bad;
      if (marked) w = 0.0;
    }
  }
}

extern "C" {

// codes: [total] 0..3 (markup bases pre-zeroed), markup: [total] 0/1,
// p: [total] f64 P(correct), offsets: [n+1], woff: [n+1] window output
// offsets.  keys_out/w_out sized woff[n].  Returns total windows written.
long kmer_observe(const uint8_t* codes, const uint8_t* markup,
                  const double* p, const int64_t* offsets,
                  const int64_t* woff, long n_reads, int k,
                  uint64_t* keys_out, double* w_out, int n_threads) {
  if (k < 1 || k > 32) return -1;
  if (n_threads <= 1 || n_reads < 1024) {
    ko_range(codes, markup, p, offsets, woff, 0, n_reads, k, keys_out, w_out);
    return woff[n_reads];
  }
  std::vector<std::thread> ts;
  long chunk = (n_reads + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk, e = s + chunk < n_reads ? s + chunk : n_reads;
    if (s >= e) break;
    ts.emplace_back([=]() {
      ko_range(codes, markup, p, offsets, woff, s, e, k, keys_out, w_out);
    });
  }
  for (auto& th : ts) th.join();
  return woff[n_reads];
}

}  // extern "C"

static void kk_range(const uint8_t* codes, const int64_t* offsets,
                     const int64_t* woff, long r0, long r1, int k,
                     uint64_t* keys_out) {
  const uint64_t kmask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
  const int up = 64 - 2 * k;
  for (long r = r0; r < r1; r++) {
    const long s = offsets[r];
    const long nw = offsets[r + 1] - s - k + 1;
    if (nw <= 0) continue;
    uint64_t* ko = keys_out + woff[r];
    uint64_t fwd = 0;
    for (int j = 0; j < k - 1; j++) fwd = (fwd << 2) | codes[s + j];
    for (long i = 0; i < nw; i++) {
      fwd = ((fwd << 2) | codes[s + i + k - 1]) & kmask;
      uint64_t rc = ko_revcomp(fwd, k);
      ko[i] = (fwd < rc ? fwd : rc) << up;
    }
  }
}

extern "C" {

// keys-only variant of kmer_observe (scoring passes need no weights)
long kmer_keys(const uint8_t* codes, const int64_t* offsets,
               const int64_t* woff, long n_reads, int k,
               uint64_t* keys_out, int n_threads) {
  if (k < 1 || k > 32) return -1;
  if (n_threads <= 1 || n_reads < 1024) {
    kk_range(codes, offsets, woff, 0, n_reads, k, keys_out);
    return woff[n_reads];
  }
  std::vector<std::thread> ts;
  long chunk = (n_reads + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk, e = s + chunk < n_reads ? s + chunk : n_reads;
    if (s >= e) break;
    ts.emplace_back([=]() {
      kk_range(codes, offsets, woff, s, e, k, keys_out);
    });
  }
  for (auto& th : ts) th.join();
  return woff[n_reads];
}

}  // extern "C"

// ---- open-addressing u64->i64 count table for spectrum lookups ----
//
// Native fast path of KmerSpectrum.lookup_counts: a sorted-array binary
// search costs ~24 dependent cache misses per query at 10^7 keys; a
// linear-probe hash costs ~1.  The table lives in caller-owned numpy
// arrays (tkeys u64 cap, tvals i64 cap), cap a power of two, EMPTY =
// ~0ULL (canonical keys shifted left never equal ~0).

static inline uint64_t ht_mix(uint64_t h) {
  h ^= h >> 33; h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33; h *= 0xc4ceb9fe1a85ec53ULL;
  h ^= h >> 33; return h;
}

extern "C" {

void hash_build(const uint64_t* keys, const int64_t* vals, long m,
                uint64_t* tkeys, int64_t* tvals, uint64_t cap) {
  const uint64_t mask = cap - 1;
  for (uint64_t i = 0; i < cap; i++) tkeys[i] = ~0ULL;
  for (long i = 0; i < m; i++) {
    uint64_t h = ht_mix(keys[i]) & mask;
    while (tkeys[h] != ~0ULL) h = (h + 1) & mask;
    tkeys[h] = keys[i];
    tvals[h] = vals[i];
  }
}

static void hl_range(const uint64_t* tkeys, const int64_t* tvals,
                     uint64_t mask, const uint64_t* q, int64_t* out,
                     long s, long e) {
  // software-prefetch the probe line ~16 queries ahead: at tables far
  // beyond L2 every first probe is a DRAM miss, and the loop is otherwise
  // fully latency-bound
  const long AHEAD = 16;
  for (long i = s; i < e; i++) {
    if (i + AHEAD < e) {
      uint64_t hp = ht_mix(q[i + AHEAD]) & mask;
      __builtin_prefetch(&tkeys[hp]);
      __builtin_prefetch(&tvals[hp]);
    }
    uint64_t h = ht_mix(q[i]) & mask;
    while (true) {
      if (tkeys[h] == q[i]) { out[i] = tvals[h]; break; }
      if (tkeys[h] == ~0ULL) { out[i] = 0; break; }
      h = (h + 1) & mask;
    }
  }
}

void hash_lookup(const uint64_t* tkeys, const int64_t* tvals, uint64_t cap,
                 const uint64_t* q, int64_t* out, long n, int n_threads) {
  const uint64_t mask = cap - 1;
  if (n_threads <= 1 || n < (1 << 16)) {
    hl_range(tkeys, tvals, mask, q, out, 0, n);
    return;
  }
  std::vector<std::thread> ts;
  long chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk, e = s + chunk < n ? s + chunk : n;
    if (s >= e) break;
    ts.emplace_back([=]() { hl_range(tkeys, tvals, mask, q, out, s, e); });
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"

// ---- artifact-filter scan kernels ----
//
// Native fast paths of ops/artifact.ArtifactFilter.scan_all: per-read
// best/second-best quality runs (ref: applyFilterToRead :407-442) and
// canonical k-mer keys at byte-aligned hop positions over the 2-bit
// padded read (ref: applyFilterToRead :446-490).  Semantics match the
// scalar _quality_runs / _scan_read transcriptions exactly.

extern "C" {

// phred: int16 per base; good = (phred >= min_quality) | !has_quals
void quality_runs(const int16_t* phred, const uint8_t* has_quals,
                  const int64_t* offsets, long n, int min_quality,
                  int64_t* best_off, int64_t* best_len,
                  int64_t* sec_off, int64_t* sec_len, int n_threads) {
  auto range = [=](long r0, long r1) {
    for (long r = r0; r < r1; r++) {
      const long s = offsets[r], L = offsets[r + 1] - s;
      long b0 = 0, b1 = 0, s0 = 0, s1 = 0, t0 = 0;
      if (!has_quals[r]) {
        b1 = L;
      } else {
        for (long i = 0; i <= L; i++) {
          if (i == L || phred[s + i] < min_quality) {
            long u0 = t0, u1 = i;
            if (u1 - u0 > b1 - b0) {
              long tmp0 = b0, tmp1 = b1;
              b0 = u0; b1 = u1; u0 = tmp0; u1 = tmp1;
            }
            if (u1 - u0 > s1 - s0) { s0 = u0; s1 = u1; }
            t0 = i + 1;
          }
        }
      }
      best_off[r] = b0; best_len[r] = b1 - b0;
      sec_off[r] = s0; sec_len[r] = s1 - s0;
    }
  };
  if (n_threads <= 1 || n < 4096) { range(0, n); return; }
  std::vector<std::thread> ts;
  long chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk, e = s + chunk < n ? s + chunk : n;
    if (s >= e) break;
    ts.emplace_back([=]() { range(s, e); });
  }
  for (auto& th : ts) th.join();
}

// canonical u64 keys at byte-aligned hops h = 0..Hmax-1 (pos = 4h) over
// each read's zero-padded 2-bit buffer; inactive cells get ~0 (a value no
// canonical key can take, so table lookups miss).
void artifact_keys(const uint8_t* codes, const int64_t* offsets, long n,
                   int k, long Hmax, uint64_t* keys_out, int n_threads) {
  const uint64_t kmask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
  const int up = 64 - 2 * k;
  auto range = [=](long r0, long r1) {
    for (long r = r0; r < r1; r++) {
      const long s = offsets[r], L = offsets[r + 1] - s;
      const long Lp = 4 * ((L + 3) / 4);
      uint64_t* ko = keys_out + r * Hmax;
      for (long h = 0; h < Hmax; h++) ko[h] = ~0ULL;
      if (Lp < k) continue;
      const long NWp = Lp - k + 1;
      // rolling forward over padded bases (pad reads as code 0 == 'A')
      uint64_t fwd = 0;
      for (long i = 0; i < k - 1; i++)
        fwd = (fwd << 2) | (i < L ? codes[s + i] : 0);
      for (long pos = 0; pos < NWp; pos++) {
        const long i = pos + k - 1;
        fwd = ((fwd << 2) | (i < L ? codes[s + i] : 0)) & kmask;
        if ((pos & 3) == 0 && pos / 4 < Hmax) {
          uint64_t rc = ko_revcomp(fwd, k);
          ko[pos / 4] = (fwd < rc ? fwd : rc) << up;
        }
      }
    }
  };
  if (n_threads <= 1 || n < 4096) { range(0, n); return; }
  std::vector<std::thread> ts;
  long chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk, e = s + chunk < n ? s + chunk : n;
    if (s >= e) break;
    ts.emplace_back([=]() { range(s, e); });
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"

// ---- spill-part counting (unweighted): hash-count + sort uniques ----
//
// Native fast path of parallel/spill.count_one_part for the common
// track_weights=False case: counting needs grouping, not a full sort of
// all observations — open-address count (one linear pass), then sort the
// unique keys only (~5-20x fewer), preserving the globally-sorted-concat
// property of range-partitioned parts (ref: buildKmerSpectrumInParts,
// src/KmerSpectrum.h:1818-1902).
#include <algorithm>

extern "C" {

// returns number of unique keys with count >= min_depth; out arrays are
// caller-allocated with capacity n.
long spill_count(const uint64_t* keys, long n, int min_depth,
                 uint64_t* out_keys, int32_t* out_counts) {
  if (n == 0) return 0;
  // at real coverage uniques are a small fraction of observations —
  // start the table at ~n/2 slots (the memset of an obs-sized table
  // dominated this kernel) and grow on load factor > 0.7 (rare)
  size_t cap = 1 << 14;
  while ((long)cap < n / 2) cap <<= 1;
  static thread_local std::vector<uint64_t> tk;
  static thread_local std::vector<uint32_t> tc;
  long used;
restart:
  // grow-only arenas: a fresh 100MB-scale vector per part mmap/munmap-
  // churns; reuse keeps the pages resident (one memset is still required)
  if (tk.size() < cap) { tk.resize(cap); tc.resize(cap); }
  memset(tk.data(), 0xff, cap * sizeof(uint64_t));
  memset(tc.data(), 0, cap * sizeof(uint32_t));
  used = 0;
  {
    const uint64_t mask = cap - 1;
    const long AHEAD = 16;  // hide the first-probe DRAM miss
    for (long i = 0; i < n; i++) {
      if (i + AHEAD < n)
        __builtin_prefetch(&tk[ht_mix(keys[i + AHEAD]) & mask], 1);
      uint64_t key = keys[i];
      uint64_t h = ht_mix(key) & mask;
      while (true) {
        if (tk[h] == key) { tc[h]++; break; }
        if (tk[h] == ~0ULL) {
          tk[h] = key; tc[h] = 1;
          if (++used * 10 > (long)cap * 7) { cap <<= 1; goto restart; }
          break;
        }
        h = (h + 1) & mask;
      }
    }
  }
  long m = 0;
  for (size_t i = 0; i < cap; i++) {
    if (tk[i] != ~0ULL && (int)tc[i] >= min_depth) {
      out_keys[m] = tk[i];
      out_counts[m] = (int32_t)tc[i];
      m++;
    }
  }
  // sort the survivors by key, counts alongside (pair sort via index)
  std::vector<long> idx(m);
  for (long i = 0; i < m; i++) idx[i] = i;
  std::sort(idx.begin(), idx.end(), [&](long a, long b) {
    return out_keys[a] < out_keys[b];
  });
  std::vector<uint64_t> sk(m);
  std::vector<int32_t> sc(m);
  for (long i = 0; i < m; i++) { sk[i] = out_keys[idx[i]]; sc[i] = out_counts[idx[i]]; }
  memcpy(out_keys, sk.data(), m * sizeof(uint64_t));
  memcpy(out_counts, sc.data(), m * sizeof(int32_t));
  return m;
}

}  // extern "C"

// ---- spill routing: counting-sort records into range parts ----
//
// Native fast path of SpillCounter.add: one pass to bin each key by the
// range splitters (upper_bound), one pass to scatter (key[,weight])
// records grouped by part.  Replaces a searchsorted + P boolean-mask
// gathers in numpy (ref: the hash-partitioned spill of
// buildKmerSpectrumInParts, src/KmerSpectrum.h:1840-1861).

extern "C" {

long spill_route(const uint64_t* keys, const float* w, int has_w, long n,
                 const uint64_t* splitters, int P,
                 uint8_t* out_rec, int64_t* part_off) {
  const int rb = has_w ? 12 : 8;
  static thread_local std::vector<int32_t> part;
  if ((long)part.size() < n) part.resize(n);
  std::vector<int64_t> cnt(P + 1, 0);
  // top-16-bit direct router: radix[t] = first part whose range can hold a
  // key with top bits t; most radix cells map to a single part, so the
  // upper_bound loop usually starts converged (P is small, keys ~uniform)
  std::vector<int32_t> radix(1 << 16);
  {
    int p = 0;
    for (long t = 0; t < (1 << 16); t++) {
      while (p < P - 1 && (splitters[p] >> 48) < (uint64_t)t) p++;
      radix[t] = p;
    }
  }
  for (long i = 0; i < n; i++) {
    uint64_t k = keys[i];
    uint64_t t = k >> 48;
    // [radix[t], radix[t+1]] brackets the upper_bound: parts below the
    // cell have splitters < t<<48 <= k; parts above start beyond t
    int lo = radix[t];
    int hi = t < 65535 ? radix[t + 1] : P - 1;
    while (lo < hi) {
      int mid = (lo + hi) / 2;
      if (splitters[mid] <= k) lo = mid + 1; else hi = mid;
    }
    part[i] = lo;
    cnt[lo + 1]++;
  }
  for (int p = 0; p < P; p++) cnt[p + 1] += cnt[p];
  for (int p = 0; p <= P; p++) part_off[p] = cnt[p];
  std::vector<int64_t> cursor(cnt.begin(), cnt.end() - 1);
  for (long i = 0; i < n; i++) {
    int64_t pos = cursor[part[i]]++;
    uint8_t* dst = out_rec + pos * rb;
    memcpy(dst, &keys[i], 8);
    if (has_w) memcpy(dst + 8, &w[i], 4);
  }
  return n;
}

}  // extern "C"

// ---- read scoring: longest passing run + run score over ragged counts ----
//
// Native fast path of ops/trim._score_and_trim_vectorized (the reference's
// ReadSelector::scoreAndTrimReads, src/ReadSelector.h:1182-1209): per read,
// the FIRST longest run of window counts >= min_score among the first
// nk windows, then the run's score.  type: 0=MEDIAN (lower median, exact)
// 1=MIN 2=MAX 3=SUM(run length).  AVG stays in numpy (fp summation order).

extern "C" {

void score_trim(const int64_t* counts, const int64_t* woff, long n,
                const int64_t* nk, double min_score, int type,
                int64_t* off_out, int64_t* len_out, double* score_out,
                int n_threads) {
  auto range = [=](long r0, long r1) {
    std::vector<int64_t> run;
    for (long r = r0; r < r1; r++) {
      const int64_t* c = counts + woff[r];
      long m = nk[r];
      long best = 0, best_s = 0, cur = 0, cur_s = 0;
      for (long i = 0; i <= m; i++) {
        if (i < m && (double)c[i] >= min_score) {
          if (!cur) cur_s = i;
          cur++;
        } else {
          if (cur > best) { best = cur; best_s = cur_s; }
          cur = 0;
        }
      }
      off_out[r] = best ? best_s : 0;
      len_out[r] = best;
      if (!best) { score_out[r] = -1.0; continue; }
      double sc;
      if (type == 0) {
        run.assign(c + best_s, c + best_s + best);
        std::nth_element(run.begin(), run.begin() + best / 2, run.end());
        sc = (double)run[best / 2];
      } else if (type == 1) {
        int64_t v = c[best_s];
        for (long i = 1; i < best; i++) v = std::min(v, c[best_s + i]);
        sc = (double)v;
      } else if (type == 2) {
        int64_t v = c[best_s];
        for (long i = 1; i < best; i++) v = std::max(v, c[best_s + i]);
        sc = (double)v;
      } else {
        sc = (double)best;
      }
      score_out[r] = sc;
    }
  };
  if (n_threads <= 1 || n < 4096) { range(0, n); return; }
  std::vector<std::thread> ts;
  long chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk, e = s + chunk < n ? s + chunk : n;
    if (s >= e) break;
    ts.emplace_back([=]() { range(s, e); });
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"

// ---- FASTQ record assembly ----
//
// Native fast path of io/reads.format_reads_batch's body/qual scatter:
// given per-record header bytes and trim windows, assemble the final
// FASTQ byte stream in one pass (ref: Read::toFastq, src/Sequence.cpp:
// 761-779, including the 'N' + qual(base+1) placeholder).

extern "C" {

// seq: normalized base bytes; phred: int16 per base; idxs/toff/tlen/disc/
// hq per record; hdr_flat+hdr_off: concatenated header bytes.  out must
// hold out_off[n] bytes (caller computes exact record lengths).
void format_fastq(const uint8_t* seq, const int16_t* phred,
                  const int64_t* offsets, const int64_t* idxs, long n,
                  const int64_t* toff, const int64_t* tlen,
                  const uint8_t* disc, const uint8_t* hq,
                  const int64_t* hdr_off, const uint8_t* hdr_flat,
                  const int64_t* out_off, int output_base, int fastq,
                  uint8_t* out, int n_threads) {
  auto range = [=](long r0, long r1) {
    for (long r = r0; r < r1; r++) {
      long i = idxs[r];
      const long s = offsets[i], L = offsets[i + 1] - s;
      long to = toff[r];
      long tl = tlen[r] < L - to ? tlen[r] : L - to;
      bool use_n = disc[r] || tlen[r] <= 1 || tl <= 1;
      uint8_t* p = out + out_off[r];
      *p++ = fastq ? '@' : '>';
      long hl = hdr_off[r + 1] - hdr_off[r];
      memcpy(p, hdr_flat + hdr_off[r], hl); p += hl;
      *p++ = '\n';
      if (use_n) {
        *p++ = 'N';
        *p++ = '\n';
        if (fastq) {
          *p++ = '+'; *p++ = '\n';
          *p++ = (uint8_t)(output_base + 1);
          *p++ = '\n';
        }
        continue;
      }
      memcpy(p, seq + s + to, tl); p += tl;
      *p++ = '\n';
      if (fastq) {
        *p++ = '+'; *p++ = '\n';
        if (hq[r]) {
          for (long j = 0; j < tl; j++)
            *p++ = (uint8_t)(phred[s + to + j] + output_base);
        } else {
          memset(p, 103, tl);  // PRINT_REF_QUAL
          p += tl;
        }
        *p++ = '\n';
      }
    }
  };
  if (n_threads <= 1 || n < 8192) { range(0, n); return; }
  std::vector<std::thread> ts;
  long chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk, e = s + chunk < n ? s + chunk : n;
    if (s >= e) break;
    ts.emplace_back([=]() { range(s, e); });
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"

// ---- ragged gather: concat data[off[i] : off[i]+len[i]] ----
extern "C" {

void gather_ragged(const uint8_t* data, const int64_t* offs,
                   const int64_t* lens, long n, const int64_t* out_off,
                   uint8_t* out, int n_threads) {
  auto range = [=](long r0, long r1) {
    for (long r = r0; r < r1; r++)
      memcpy(out + out_off[r], data + offs[r], lens[r]);
  };
  if (n_threads <= 1 || n < 8192) { range(0, n); return; }
  std::vector<std::thread> ts;
  long chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk, e = s + chunk < n ? s + chunk : n;
    if (s >= e) break;
    ts.emplace_back([=]() { range(s, e); });
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"

// ---- fused chunk observation: raw seq/qual -> canonical keys + good ----
//
// Native fast path of the WHOLE of apps/filter_reads._chunk_observations:
// bases code through code_tab (ACGT -> 0..3, everything else 4 = markup,
// encoding as 0 in 2-bit space, ref: src/TwoBitSequence.cpp:255-260),
// probabilities gather from a caller-built 256-entry table indexed by the
// RAW quality byte (ref: src/Sequence.cpp:522-540), window weights follow
// the reference's incremental product with 1024-window resync
// (ref: src/KmerReadUtils.h:176-248), and goodness is the reference's
// float-cast threshold (float)w > (float)min_kq
// (ref: src/KmerTrackingData.h:353-364) AND NOT discarded[read].
// The per-window markup test is a rolling counter (O(1) per window)
// instead of kmer_observe's k-wide scan.

static void oc_range(const uint8_t* seq, const uint8_t* qual,
                     const int64_t* offsets, const int64_t* woff,
                     const uint8_t* discarded, const uint8_t* has_quals,
                     long r0, long r1, int k,
                     const uint8_t* code_tab, const double* prob_tab,
                     float min_kq,
                     uint64_t* keys_out, uint8_t* good_out, float* w_out) {
  const uint64_t kmask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
  const int up = 64 - 2 * k;
  for (long r = r0; r < r1; r++) {
    const long s = offsets[r];
    const long L = offsets[r + 1] - s;
    const long nw = L - k + 1;
    if (nw <= 0) continue;
    uint64_t* ko = keys_out + woff[r];
    uint8_t* go = good_out + woff[r];
    float* wo = w_out ? w_out + woff[r] : nullptr;
    const bool hq = has_quals[r] != 0;
    const bool disc = discarded[r] != 0;
    uint64_t fwd = 0;
    int marked_cnt = 0;
    for (int j = 0; j < k - 1; j++) {
      uint8_t c = code_tab[seq[s + j]];
      marked_cnt += (c == 4);
      fwd = (fwd << 2) | (c & 3);
    }
    double w = 0.0;
    bool prev_bad = false;
    for (long i = 0; i < nw; i++) {
      uint8_t cin = code_tab[seq[s + i + k - 1]];
      marked_cnt += (cin == 4);
      fwd = ((fwd << 2) | (cin & 3)) & kmask;
      uint64_t rc = ko_revcomp(fwd, k);
      uint64_t canon = fwd < rc ? fwd : rc;
      ko[i] = canon << up;
      bool bad = false;
      if (i == 0 || (i & 1023) == 0 || prev_bad) {
        w = 1.0;  // seed: sequential product, matching np.cumprod order
        if (hq) for (int j = 0; j < k; j++) w = w * prob_tab[qual[s + i + j]];
      } else if (hq) {
        w = w * (prob_tab[qual[s + i + k - 1]] / prob_tab[qual[s + i - 1]]);
      }
      if (w == 0.0) bad = true;
      float wf;
      if (marked_cnt > 0) { bad = true; w = 0.0; wf = 0.0f; }
      else wf = (float)w;
      if (wo) wo[i] = wf;
      go[i] = (wf > min_kq && !disc) ? 1 : 0;
      prev_bad = bad;
      marked_cnt -= (code_tab[seq[s + i]] == 4);
    }
  }
}

extern "C" {

// seq/qual: [total] raw bytes; offsets/woff: [n+1]; discarded/has_quals:
// [n] u8; code_tab: [256] byte -> 0..4; prob_tab: [256] raw qual byte ->
// P(correct).  keys_out/good_out sized woff[n]; w_out nullable (same
// size, f32).  Returns total windows written, -1 on bad k.
long observe_chunk(const uint8_t* seq, const uint8_t* qual,
                   const int64_t* offsets, const int64_t* woff,
                   const uint8_t* discarded, const uint8_t* has_quals,
                   long n_reads, int k,
                   const uint8_t* code_tab, const double* prob_tab,
                   float min_kq,
                   uint64_t* keys_out, uint8_t* good_out, float* w_out,
                   int n_threads) {
  if (k < 1 || k > 32) return -1;
  if (n_threads <= 1 || n_reads < 1024) {
    oc_range(seq, qual, offsets, woff, discarded, has_quals, 0, n_reads, k,
             code_tab, prob_tab, min_kq, keys_out, good_out, w_out);
    return woff[n_reads];
  }
  std::vector<std::thread> ts;
  long chunk = (n_reads + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk, e = s + chunk < n_reads ? s + chunk : n_reads;
    if (s >= e) break;
    ts.emplace_back([=]() {
      oc_range(seq, qual, offsets, woff, discarded, has_quals, s, e, k,
               code_tab, prob_tab, min_kq, keys_out, good_out, w_out);
    });
  }
  for (auto& th : ts) th.join();
  return woff[n_reads];
}

}  // extern "C"

// ---- trim-label rendering + header assembly ----
//
// Native fast path of the per-read Python in trim._score_and_trim_vectorized
// (labels "Trim:%d+%d <S>:%d" / "<S>:%d", ref: ReadSelector trim comments,
// src/ReadSelector.h:219-247) and of format_reads_batch's header concat
// (name [+ ' ' + comment] [+ ' ' + label], ref: Read::toFastq,
// src/Sequence.cpp:761-779).

extern "C" {

// Renders per-read labels into lflat/loff: "" for discarded,
// "Trim:<off>+<len> <slabel><score>" when trimmed, "<slabel><score>"
// otherwise.  slabel: e.g. "MedianScore:".  Returns total bytes (caller
// sizes lflat at n * (slen + 64)).
long render_labels(long n, const int64_t* t_off, const int64_t* t_len,
                   const int64_t* int_sc, const uint8_t* was_trimmed,
                   const uint8_t* discarded, const uint8_t* slabel, int slen,
                   uint8_t* lflat, int64_t* loff) {
  uint8_t* p = lflat;
  loff[0] = 0;
  for (long i = 0; i < n; i++) {
    if (!discarded[i]) {
      if (was_trimmed[i]) {
        memcpy(p, "Trim:", 5); p += 5;
        p = write_u64(p, (unsigned long long)t_off[i]);
        *p++ = '+';
        p = write_u64(p, (unsigned long long)t_len[i]);
        *p++ = ' ';
      }
      memcpy(p, slabel, slen); p += slen;
      long long sc = int_sc[i];
      if (sc < 0) { *p++ = '-'; sc = -sc; }
      p = write_u64(p, (unsigned long long)sc);
    }
    loff[i + 1] = p - lflat;
  }
  return p - lflat;
}

// Assembles selected-record headers: name [+ ' ' + comment] [+ ' ' +
// label].  Names/comments come as fixed-width ('S' dtype) planes with
// per-row used lengths; labels as a flat+offsets pair already gathered to
// the selection order.  hdr_off is precomputed by the caller (prefix sum
// of hlen); this just scatters the bytes.
void build_headers(long n, const int64_t* idxs,
                   const uint8_t* nm2d, long nm_w, const int64_t* nlen,
                   const uint8_t* cm2d, long cm_w, const int64_t* clen,
                   const uint8_t* lflat, const int64_t* loff,
                   const int64_t* hdr_off, uint8_t* hdr_flat,
                   int n_threads) {
  auto range = [=](long r0, long r1) {
    for (long r = r0; r < r1; r++) {
      long i = idxs[r];
      uint8_t* p = hdr_flat + hdr_off[r];
      memcpy(p, nm2d + i * nm_w, nlen[i]); p += nlen[i];
      if (cm2d && clen[i] > 0) {
        *p++ = ' ';
        memcpy(p, cm2d + i * cm_w, clen[i]); p += clen[i];
      }
      long ll = loff[r + 1] - loff[r];
      if (ll > 0) {
        *p++ = ' ';
        memcpy(p, lflat + loff[r], ll);
      }
    }
  };
  if (n_threads <= 1 || n < 8192) { range(0, n); return; }
  std::vector<std::thread> ts;
  long chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk, e = s + chunk < n ? s + chunk : n;
    if (s >= e) break;
    ts.emplace_back([=]() { range(s, e); });
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"

// keys-only variant of observe_chunk: canonical u64 window keys straight
// from raw sequence bytes (code_tab maps bytes; markup bases encode as 0,
// matching extract_kmers_flat on pre-zeroed codes).
static void kr_range(const uint8_t* seq, const int64_t* offsets,
                     const int64_t* woff, long r0, long r1, int k,
                     const uint8_t* code_tab, uint64_t* keys_out) {
  const uint64_t kmask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
  const int up = 64 - 2 * k;
  for (long r = r0; r < r1; r++) {
    const long s = offsets[r];
    const long nw = offsets[r + 1] - s - k + 1;
    if (nw <= 0) continue;
    uint64_t* ko = keys_out + woff[r];
    uint64_t fwd = 0;
    for (int j = 0; j < k - 1; j++)
      fwd = (fwd << 2) | (code_tab[seq[s + j]] & 3);
    for (long i = 0; i < nw; i++) {
      fwd = ((fwd << 2) | (code_tab[seq[s + i + k - 1]] & 3)) & kmask;
      uint64_t rc = ko_revcomp(fwd, k);
      ko[i] = (fwd < rc ? fwd : rc) << up;
    }
  }
}

extern "C" {

long kmer_keys_raw(const uint8_t* seq, const int64_t* offsets,
                   const int64_t* woff, long n_reads, int k,
                   const uint8_t* code_tab, uint64_t* keys_out,
                   int n_threads) {
  if (k < 1 || k > 32) return -1;
  if (n_threads <= 1 || n_reads < 1024) {
    kr_range(seq, offsets, woff, 0, n_reads, k, code_tab, keys_out);
    return woff[n_reads];
  }
  std::vector<std::thread> ts;
  long chunk = (n_reads + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk, e = s + chunk < n_reads ? s + chunk : n_reads;
    if (s >= e) break;
    ts.emplace_back([=]() {
      kr_range(seq, offsets, woff, s, e, k, code_tab, keys_out);
    });
  }
  for (auto& th : ts) th.join();
  return woff[n_reads];
}

}  // extern "C"

// Interleaved-entry variant of the lookup hash: (key, val) share one
// 16-byte slot so a probe costs ONE cache line, not two (the split-plane
// layout pays a second DRAM miss per query on tvals).
extern "C" {

void hash_build2(const uint64_t* keys, const int64_t* vals, long m,
                 uint64_t* slots /*2*cap*/, uint64_t cap) {
  const uint64_t mask = cap - 1;
  for (uint64_t i = 0; i < cap; i++) slots[2 * i] = ~0ULL;
  for (long i = 0; i < m; i++) {
    uint64_t h = ht_mix(keys[i]) & mask;
    while (slots[2 * h] != ~0ULL) h = (h + 1) & mask;
    slots[2 * h] = keys[i];
    slots[2 * h + 1] = (uint64_t)vals[i];
  }
}

static void hl2_range(const uint64_t* slots, uint64_t mask,
                      const uint64_t* q, int64_t* out, long s, long e) {
  if (mask < (1 << 15)) {
    // table fits cache: the prefetch (and its second ht_mix) is pure
    // overhead — tight loop instead
    for (long i = s; i < e; i++) {
      uint64_t h = ht_mix(q[i]) & mask;
      while (true) {
        if (slots[2 * h] == q[i]) { out[i] = (int64_t)slots[2 * h + 1]; break; }
        if (slots[2 * h] == ~0ULL) { out[i] = 0; break; }
        h = (h + 1) & mask;
      }
    }
    return;
  }
  const long AHEAD = 16;
  for (long i = s; i < e; i++) {
    if (i + AHEAD < e)
      __builtin_prefetch(&slots[2 * (ht_mix(q[i + AHEAD]) & mask)]);
    uint64_t h = ht_mix(q[i]) & mask;
    while (true) {
      if (slots[2 * h] == q[i]) { out[i] = (int64_t)slots[2 * h + 1]; break; }
      if (slots[2 * h] == ~0ULL) { out[i] = 0; break; }
      h = (h + 1) & mask;
    }
  }
}

void hash_lookup2(const uint64_t* slots, uint64_t cap, const uint64_t* q,
                  int64_t* out, long n, int n_threads) {
  const uint64_t mask = cap - 1;
  if (n_threads <= 1 || n < (1 << 16)) {
    hl2_range(slots, mask, q, out, 0, n);
    return;
  }
  std::vector<std::thread> ts;
  long chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk, e = s + chunk < n ? s + chunk : n;
    if (s >= e) break;
    ts.emplace_back([=]() { hl2_range(slots, mask, q, out, s, e); });
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"

// Parallel build of the interleaved hash: spectrum keys are UNIQUE, so a
// CAS on the key word claims a slot exactly once and the value write
// races with nothing (no readers during build).
extern "C" {

void hash_build2_mt(const uint64_t* keys, const int64_t* vals, long m,
                    uint64_t* slots, uint64_t cap, int n_threads) {
  const uint64_t mask = cap - 1;
  if (n_threads <= 1 || m < (1 << 16)) {
    hash_build2(keys, vals, m, slots, cap);
    return;
  }
  {
    std::vector<std::thread> ts;
    long zc = ((long)cap + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
      long s = t * zc, e = s + zc < (long)cap ? s + zc : (long)cap;
      if (s >= e) break;
      ts.emplace_back([=]() {
        for (long i = s; i < e; i++) slots[2 * i] = ~0ULL;
      });
    }
    for (auto& th : ts) th.join();
  }
  std::vector<std::thread> ts;
  long chunk = (m + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk, e = s + chunk < m ? s + chunk : m;
    if (s >= e) break;
    ts.emplace_back([=]() {
      for (long i = s; i < e; i++) {
        uint64_t h = ht_mix(keys[i]) & mask;
        while (true) {
          uint64_t cur = __atomic_load_n(&slots[2 * h], __ATOMIC_RELAXED);
          if (cur == ~0ULL) {
            uint64_t expect = ~0ULL;
            if (__atomic_compare_exchange_n(&slots[2 * h], &expect, keys[i],
                                            false, __ATOMIC_ACQ_REL,
                                            __ATOMIC_RELAXED)) {
              slots[2 * h + 1] = (uint64_t)vals[i];
              break;
            }
            continue;  // lost the race; re-examine this slot
          }
          h = (h + 1) & mask;
        }
      }
    });
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"

// Fused artifact scan: rolling canonical windows probed at byte-aligned
// positions directly against the (small, interleaved) artifact hash — no
// [n, H] key plane or mask algebra on the Python side
// (ref: FilterKnownOddities::applyFilterToRead byte-hop scan,
// src/FilterKnownOddities.h:446-490).
extern "C" {

void artifact_scan(const uint8_t* codes, const int64_t* offsets, long n,
                   int k, const int64_t* start_hop, const int64_t* byte_hops,
                   const uint64_t* slots, uint64_t cap, long phix_idx,
                   int64_t* value, int64_t* min_hit, int64_t* max_hit,
                   uint8_t* was_phix, int n_threads, int raw_ascii) {
  const uint64_t kmask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
  const int up = 64 - 2 * k;
  const uint64_t hmask = cap - 1;
  // raw_ascii: codes is the normalized ASCII sequence; map bases inline
  // (markup/'N' scans as 'A', matching BASE_CODE==4 -> 0 on the py side)
  // so the caller skips two full passes (gather + where) over the chunk
  uint8_t bc[256];
  memset(bc, 0, sizeof(bc));
  bc['C'] = 1; bc['G'] = 2; bc['T'] = 3;
  auto range = [=](long r0, long r1) {
    for (long r = r0; r < r1; r++) {
      value[r] = 0;
      min_hit[r] = INT64_MAX;
      max_hit[r] = -1;
      was_phix[r] = 0;
      const long s = offsets[r], L = offsets[r + 1] - s;
      const long Lp = 4 * ((L + 3) / 4);
      if (Lp < k || L < k) continue;
      const long NWp = Lp - k + 1;
      long h0 = start_hop[r] > 0 ? start_hop[r] : 0;
      long h1 = byte_hops[r];
      if ((NWp - 1) / 4 < h1) h1 = (NWp - 1) / 4;
      if (h1 < h0) continue;
      uint64_t fwd = 0;
      for (long j = 4 * h0; j < 4 * h0 + k - 1; j++)
        fwd = (fwd << 2)
            | (j < L ? (raw_ascii ? bc[codes[s + j]] : codes[s + j]) : 0);
      // iterate positions 4*h0 .. 4*h1 rolling one base at a time
      for (long pos = 4 * h0; pos <= 4 * h1; pos++) {
        const long i = pos + k - 1;
        fwd = ((fwd << 2)
               | (i < L ? (raw_ascii ? bc[codes[s + i]] : codes[s + i]) : 0))
            & kmask;
        if ((pos & 3) != 0) continue;
        uint64_t rc = ko_revcomp(fwd, k);
        uint64_t key = (fwd < rc ? fwd : rc) << up;
        uint64_t h = ht_mix(key) & hmask;
        long v = 0;
        while (true) {
          if (slots[2 * h] == key) { v = (long)slots[2 * h + 1]; break; }
          if (slots[2 * h] == ~0ULL) break;
          h = (h + 1) & hmask;
        }
        if (v > 0) {
          value[r] = v;
          if (pos < min_hit[r]) min_hit[r] = pos;
          if (pos > max_hit[r]) max_hit[r] = pos;
          if (v == phix_idx) was_phix[r] = 1;
        }
      }
      if (was_phix[r]) value[r] = phix_idx;
    }
  };
  if (n_threads <= 1 || n < 4096) { range(0, n); return; }
  std::vector<std::thread> ts;
  long chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    long s = t * chunk, e = s + chunk < n ? s + chunk : n;
    if (s >= e) break;
    ts.emplace_back([=]() { range(s, e); });
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"

// ---- persistent observation aggregator (cross-chunk spill compression) --
//
// The streaming engine's pass-1 used to spill every good observation as a
// raw (key[,weight]) record: ~12 B x raw_good_kmers of spill IO, all
// re-hashed at finalize.  This open-addressing aggregator lives across
// chunks inside each pool worker and spills (key, count[, wsum]) records
// only when the table reaches its memory cap — the reference's
// purge-under-pressure idea (ref: src/KmerSpectrum.h:1818-1902 spill
// parts; src/Kmer.h:2161-2299 bucket map) applied to the spill stream,
// with EXACT final counts because flushed partials re-merge at finalize.

extern "C" {

typedef struct {
  uint64_t* tk;  // split-plane keys (weights-tracked layout), else NULL
  uint32_t* tc;
  double* tw;    // NULL when weights are untracked
  uint64_t* ti;  // interleaved {key, count} 16B slots (no-weights layout):
                 // ONE cache line per probe instead of two (tk + tc)
  uint64_t cap;  // power of two
  long used;
  int has_w;
  uint64_t empty;  // empty-slot sentinel in the key field
  uint64_t kofs;   // stored key = key + kofs (1 in zero-empty mode)
} kmt_agg;

// zero_empty: store key+1 with 0 = empty, so the table is born
// initialized from the kernel's lazy zero pages — no eager 256 MB
// sentinel fill, no resident pages for never-probed slots (the same
// trick the shared CAS table below uses).  Callers may only enable it
// when keys can never be ~0ULL (canonical k <= 31 keys are < 2^62).
void* agg_create2(long cap_slots, int has_w, int zero_empty) {
  uint64_t cap = 1 << 14;
  while ((long)cap < cap_slots) cap <<= 1;
  kmt_agg* a = new kmt_agg();
  a->cap = cap;
  a->has_w = has_w;
  a->used = 0;
  a->empty = zero_empty ? 0 : ~0ULL;
  a->kofs = zero_empty ? 1 : 0;
  if (has_w) {
    if (zero_empty) {
      a->tk = (uint64_t*)calloc(cap, sizeof(uint64_t));
    } else {
      a->tk = (uint64_t*)malloc(cap * sizeof(uint64_t));
      memset(a->tk, 0xff, cap * sizeof(uint64_t));
    }
    a->tc = (uint32_t*)malloc(cap * sizeof(uint32_t));
    a->tw = (double*)malloc(cap * sizeof(double));
    a->ti = NULL;
  } else {
    a->tk = NULL;
    a->tc = NULL;
    a->tw = NULL;
    // NOTE (measured negative): MADV_HUGEPAGE here looked like a free
    // dTLB win for the big tables, but the host runs THP defrag in
    // madvise mode, so every fault attempted synchronous compaction —
    // the 1 GiB FilterReads run went 13 s -> 150-200 s.  Plain pages it
    // is.
    if (zero_empty) {
      a->ti = (uint64_t*)calloc(cap * 2, sizeof(uint64_t));
    } else {
      a->ti = (uint64_t*)aligned_alloc(64, cap * 2 * sizeof(uint64_t));
      for (uint64_t i = 0; i < cap; i++) a->ti[2 * i] = ~0ULL;
    }
  }
  return a;
}

void* agg_create(long cap_slots, int has_w) {
  return agg_create2(cap_slots, has_w, 0);
}

// Insert keys[0..n) (with optional f32 weights) until the table's used
// count would pass stop_used; returns the number of keys consumed.  The
// caller flushes (agg_export) and re-calls with the remainder.
long agg_insert(void* ap, const uint64_t* keys, const float* w, long n,
                long stop_used) {
  kmt_agg* a = (kmt_agg*)ap;
  const uint64_t mask = a->cap - 1;
  const uint64_t EMPTY = a->empty, KOFS = a->kofs;
  const long AHEAD = 16;
  long i = 0;
  if (!a->has_w) {
    uint64_t* ti = a->ti;
    for (; i < n; i++) {
      if (a->used >= stop_used) break;
      if (i + AHEAD < n)
        __builtin_prefetch(&ti[2 * (ht_mix(keys[i + AHEAD]) & mask)], 1);
      uint64_t key = keys[i] + KOFS;
      uint64_t h = ht_mix(keys[i]) & mask;
      while (true) {
        uint64_t* s = &ti[2 * h];
        if (s[0] == key) { s[1]++; break; }
        if (s[0] == EMPTY) {
          s[0] = key; s[1] = 1;
          a->used++;
          break;
        }
        h = (h + 1) & mask;
      }
    }
    return i;
  }
  for (; i < n; i++) {
    if (a->used >= stop_used) break;
    if (i + AHEAD < n)
      __builtin_prefetch(&a->tk[ht_mix(keys[i + AHEAD]) & mask], 1);
    uint64_t key = keys[i] + KOFS;
    uint64_t h = ht_mix(keys[i]) & mask;
    while (true) {
      if (a->tk[h] == key) {
        a->tc[h]++;
        a->tw[h] += (double)w[i];
        break;
      }
      if (a->tk[h] == EMPTY) {
        a->tk[h] = key;
        a->tc[h] = 1;
        a->tw[h] = (double)w[i];
        a->used++;
        break;
      }
      h = (h + 1) & mask;
    }
  }
  return i;
}

// Dump all occupied slots (unordered) and clear the table.
long agg_export(void* ap, uint64_t* keys_out, uint32_t* cnt_out,
                double* w_out) {
  kmt_agg* a = (kmt_agg*)ap;
  const uint64_t EMPTY = a->empty, KOFS = a->kofs;
  long m = 0;
  if (!a->has_w) {
    uint64_t* ti = a->ti;
    for (uint64_t i = 0; i < a->cap; i++) {
      if (ti[2 * i] != EMPTY) {
        keys_out[m] = ti[2 * i] - KOFS;
        cnt_out[m] = (uint32_t)ti[2 * i + 1];
        m++;
        ti[2 * i] = EMPTY;
      }
    }
    a->used = 0;
    return m;
  }
  for (uint64_t i = 0; i < a->cap; i++) {
    if (a->tk[i] != EMPTY) {
      keys_out[m] = a->tk[i] - KOFS;
      cnt_out[m] = a->tc[i];
      if (w_out) w_out[m] = a->tw[i];
      m++;
    }
  }
  if (KOFS)
    memset(a->tk, 0, a->cap * sizeof(uint64_t));
  else
    memset(a->tk, 0xff, a->cap * sizeof(uint64_t));
  a->used = 0;
  return m;
}

long agg_used(void* ap) { return ((kmt_agg*)ap)->used; }

// Compact keys[good] (and optionally weights) into caller buffers in one
// sequential pass — numpy's boolean fancy-index was 9.9 core-s of a
// 1 GiB FilterReads pass 1 (fresh 40 MB allocation + page faults per
// chunk under worker contention); this is allocation-free at memcpy
// speed into a reused buffer.
long compact_good(const uint64_t* keys, const uint8_t* good, long n,
                  const float* w_in, uint64_t* keys_out, float* w_out) {
  long m = 0;
  if (w_in && w_out) {
    for (long i = 0; i < n; i++) {
      keys_out[m] = keys[i];
      w_out[m] = w_in[i];
      m += good[i] != 0;
    }
  } else {
    for (long i = 0; i < n; i++) {
      keys_out[m] = keys[i];
      m += good[i] != 0;
    }
  }
  return m;
}

// Merge pre-aggregated (key, count[, wsum]) records into the table with
// no load-factor stop — the caller guarantees capacity.  Used when the
// aggregator GROWS: the old table's export re-inserts here, preserving
// exact counts (ref: the reference's KmerMap resize,
// src/Kmer.h:2161-2299).
void agg_insert_counted(void* ap, const uint64_t* keys,
                        const uint32_t* cnts, const double* wsums, long n) {
  kmt_agg* a = (kmt_agg*)ap;
  const uint64_t mask = a->cap - 1;
  const uint64_t EMPTY = a->empty, KOFS = a->kofs;
  const long AHEAD = 16;
  if (!a->has_w) {
    uint64_t* ti = a->ti;
    for (long i = 0; i < n; i++) {
      if (i + AHEAD < n)
        __builtin_prefetch(&ti[2 * (ht_mix(keys[i + AHEAD]) & mask)], 1);
      uint64_t key = keys[i] + KOFS;
      uint64_t h = ht_mix(keys[i]) & mask;
      while (true) {
        uint64_t* s = &ti[2 * h];
        if (s[0] == key) { s[1] += cnts[i]; break; }
        if (s[0] == EMPTY) {
          s[0] = key; s[1] = cnts[i];
          a->used++;
          break;
        }
        h = (h + 1) & mask;
      }
    }
    return;
  }
  for (long i = 0; i < n; i++) {
    if (i + AHEAD < n)
      __builtin_prefetch(&a->tk[ht_mix(keys[i + AHEAD]) & mask], 1);
    uint64_t key = keys[i] + KOFS;
    uint64_t h = ht_mix(keys[i]) & mask;
    while (true) {
      if (a->tk[h] == key) {
        a->tc[h] += cnts[i];
        a->tw[h] += wsums ? wsums[i] : 0.0;
        break;
      }
      if (a->tk[h] == EMPTY) {
        a->tk[h] = key;
        a->tc[h] = cnts[i];
        a->tw[h] = wsums ? wsums[i] : 0.0;
        a->used++;
        break;
      }
      h = (h + 1) & mask;
    }
  }
}

// ---- shared CAS count table (cross-process pass-1 aggregation) ----
//
// One anonymous-shared mmap table ALL pool workers insert into, the
// reference's shared OpenMP bucket map re-done for fork workers
// (ref: src/Kmer.h:2161-2299 + DistributedFunctions.h thread-sharded
// appends).  vs per-worker private tables this stores the dataset's
// repeated working set ONCE — the ~20x-coverage genome keys become
// shared L3-resident lines instead of 4 private DRAM-resident copies —
// and removes growth migrations and pressure flushes entirely when the
// unique count fits.  Layout: slot = {key+1, count} u64 pairs, empty
// cell = 0 so the kernel's lazy zero pages ARE the initialized table
// (no 2 GB memset, no resident pages for untouched slots).  Valid
// canonical keys for k <= 31 are < 2^62, so key+1 never collides with
// the sentinel.  hdr[0] = used (atomic), hdr[1] = stop.
//
// Exactness: every observation performs exactly one relaxed fetch_add
// on its slot's count; claims go through CAS, and a worker that sees
// used >= stop BEFORE claiming returns its consumed prefix so the
// caller diverts the remainder to its private spill counter — final
// counts are the shared export merged with the spilled partials.

long shct_insert(uint64_t* hdr, uint64_t* slots, uint64_t cap,
                 const uint64_t* keys, long n) {
  const uint64_t mask = cap - 1;
  const uint64_t stop = hdr[1];
  const long AHEAD = 16;
  for (long i = 0; i < n; i++) {
    if (i + AHEAD < n)
      __builtin_prefetch(&slots[2 * (ht_mix(keys[i + AHEAD]) & mask)], 1);
    const uint64_t k1 = keys[i] + 1;
    uint64_t h = ht_mix(keys[i]) & mask;
    while (true) {
      uint64_t cur = __atomic_load_n(&slots[2 * h], __ATOMIC_RELAXED);
      if (cur == k1) {
        __atomic_fetch_add(&slots[2 * h + 1], 1ULL, __ATOMIC_RELAXED);
        break;
      }
      if (cur == 0) {
        if (__atomic_load_n(&hdr[0], __ATOMIC_RELAXED) >= stop)
          return i;  // pressure: caller spills the rest privately
        if (__atomic_compare_exchange_n(&slots[2 * h], &cur, k1, false,
                                        __ATOMIC_RELAXED,
                                        __ATOMIC_RELAXED)) {
          __atomic_fetch_add(&slots[2 * h + 1], 1ULL, __ATOMIC_RELAXED);
          __atomic_fetch_add(&hdr[0], 1ULL, __ATOMIC_RELAXED);
          break;
        }
        continue;  // lost the race; cur was reloaded — re-examine slot
      }
      h = (h + 1) & mask;
    }
  }
  return n;
}

// Export occupied slots in [s_lo, s_hi) -> (key, u32 count) arrays.
// Counts larger than u32 clamp (the spill record format is u32; a
// single k-mer observed 4 billion times is beyond any real input).
long shct_export(const uint64_t* slots, uint64_t s_lo, uint64_t s_hi,
                 uint64_t* keys_out, uint32_t* cnt_out) {
  long m = 0;
  for (uint64_t i = s_lo; i < s_hi; i++) {
    uint64_t k1 = slots[2 * i];
    if (k1) {
      keys_out[m] = k1 - 1;
      uint64_t c = slots[2 * i + 1];
      cnt_out[m] = c > 0xFFFFFFFFULL ? 0xFFFFFFFFu : (uint32_t)c;
      m++;
    }
  }
  return m;
}

// Bucketed insert (no-weights layout): radix-partition the batch by the
// probe slot's high bits so each bucket's probes land in one ~1 MB table
// region that stays cache-resident while the bucket drains.
//
// MEASURED NEGATIVE RESULT on the dev host (kept, with unit coverage,
// as the record): the host's L3 is 260 MiB, so a 64 MB table is already
// L3-resident and the prefetched linear agg_insert hits ~48 Mkeys/s;
// the partition passes are pure overhead there (18 Mk/s bucketed vs
// 48 Mk/s linear, single-thread; 35-42 Mk/s linear under 4-way
// contention).  The production fix for the observed 12.9 core-s flush
// cost was adaptive table growth (agg_insert_counted) instead.  On a
// small-L3 part this path may still win; it is correct and exact.
//
// Contract differs from agg_insert: buckets are processed in region
// order, so consumption is NOT a prefix.  Keys not consumed when the
// table crosses stop_used are compacted to the FRONT of the caller's
// (writable) keys buffer; returns how many remain (0 = all consumed).
long agg_insert_bucketed(void* ap, uint64_t* keys, long n, long stop_used) {
  kmt_agg* a = (kmt_agg*)ap;
  if (a->has_w) return -1;  // weights path keeps the prefix contract
  const uint64_t mask = a->cap - 1;
  uint64_t* ti = a->ti;
  // region = 1 MB of interleaved slots (64K slots); >=8 regions or the
  // partition is pure overhead
  uint64_t nb = a->cap >> 16;
  if (nb < 8 || n < (1 << 15)) {
    long consumed = agg_insert(ap, keys, NULL, n, stop_used);
    long rem = n - consumed;
    if (rem > 0) memmove(keys, keys + consumed, rem * sizeof(uint64_t));
    return rem;
  }
  if (nb > 256) nb = 256;
  const int rshift = __builtin_ctzll(a->cap / nb);  // slot -> region
  static thread_local std::vector<uint64_t> hs;      // ht_mix per key
  static thread_local std::vector<uint64_t> pk;      // (hash, key) pairs
  static thread_local std::vector<int64_t> boff;
  if ((long)hs.size() < n) hs.resize(n);
  if ((long)pk.size() < 2 * n) pk.resize(2 * n);
  if ((long)boff.size() < (long)nb + 1) boff.resize(nb + 1);
  int64_t* off = boff.data();
  memset(off, 0, (nb + 1) * sizeof(int64_t));
  for (long i = 0; i < n; i++) {
    uint64_t h = ht_mix(keys[i]) & mask;
    hs[i] = h;
    off[(h >> rshift) + 1]++;
  }
  for (uint64_t b = 0; b < nb; b++) off[b + 1] += off[b];
  {
    static thread_local std::vector<int64_t> cur;
    if ((long)cur.size() < (long)nb) cur.resize(nb);
    memcpy(cur.data(), off, nb * sizeof(int64_t));
    for (long i = 0; i < n; i++) {
      int64_t p = cur[hs[i] >> rshift]++;
      pk[2 * p] = hs[i];
      pk[2 * p + 1] = keys[i];
    }
  }
  const uint64_t EMPTY = a->empty, KOFS = a->kofs;
  const long AHEAD = 8;
  for (uint64_t b = 0; b < nb; b++) {
    if (a->used >= stop_used) {
      // compact the untouched buckets back to the caller's buffer
      long rem = n - off[b];
      uint64_t* dst = keys;
      for (long i = off[b]; i < n; i++) *dst++ = pk[2 * i + 1];
      return rem;
    }
    const long s = off[b], e = off[b + 1];
    for (long i = s; i < e; i++) {
      if (i + AHEAD < e) __builtin_prefetch(&ti[2 * pk[2 * (i + AHEAD)]], 1);
      uint64_t h = pk[2 * i];
      const uint64_t key = pk[2 * i + 1] + KOFS;
      while (true) {
        uint64_t* sl = &ti[2 * h];
        if (sl[0] == key) { sl[1]++; break; }
        if (sl[0] == EMPTY) {
          sl[0] = key; sl[1] = 1;
          a->used++;
          break;
        }
        h = (h + 1) & mask;
      }
    }
  }
  return 0;
}

void agg_free(void* ap) {
  kmt_agg* a = (kmt_agg*)ap;
  if (a->tk) free(a->tk);
  if (a->tc) free(a->tc);
  if (a->tw) free(a->tw);
  if (a->ti) free(a->ti);
  delete a;
}

// Route aggregated (key, count[, wsum]) triples into range parts — the
// aggregated-record sibling of spill_route (record: 8+4[+8] bytes).
long spill_route_agg(const uint64_t* keys, const uint32_t* cnts,
                     const double* w, int has_w, long n,
                     const uint64_t* splitters, int P,
                     uint8_t* out_rec, int64_t* part_off) {
  const int rb = has_w ? 20 : 12;
  static thread_local std::vector<int32_t> part;
  if ((long)part.size() < n) part.resize(n);
  std::vector<int64_t> cnt(P + 1, 0);
  std::vector<int32_t> radix(1 << 16);
  {
    int p = 0;
    for (long t = 0; t < (1 << 16); t++) {
      while (p < P - 1 && (splitters[p] >> 48) < (uint64_t)t) p++;
      radix[t] = p;
    }
  }
  for (long i = 0; i < n; i++) {
    uint64_t k = keys[i];
    uint64_t t = k >> 48;
    int lo = radix[t];
    int hi = t < 65535 ? radix[t + 1] : P - 1;
    while (lo < hi) {
      int mid = (lo + hi) / 2;
      if (splitters[mid] <= k) lo = mid + 1; else hi = mid;
    }
    part[i] = lo;
    cnt[lo + 1]++;
  }
  for (int p = 0; p < P; p++) cnt[p + 1] += cnt[p];
  for (int p = 0; p <= P; p++) part_off[p] = cnt[p];
  std::vector<int64_t> cursor(cnt.begin(), cnt.end() - 1);
  for (long i = 0; i < n; i++) {
    int64_t pos = cursor[part[i]]++;
    uint8_t* dst = out_rec + pos * rb;
    memcpy(dst, &keys[i], 8);
    memcpy(dst + 8, &cnts[i], 4);
    if (has_w) memcpy(dst + 12, &w[i], 8);
  }
  return n;
}

// Hash-merge aggregated (key, count) records for one part: like
// spill_count but each record carries a pre-summed count.
long spill_count_agg(const uint64_t* keys, const uint32_t* cnts, long n,
                     int min_depth, uint64_t* out_keys,
                     int32_t* out_counts) {
  if (n == 0) return 0;
  size_t cap = 1 << 14;
  while ((long)cap < n) cap <<= 1;  // aggregated records are mostly unique
  // interleaved {key, count} 16B slots: one cache line per probe
  static thread_local std::vector<uint64_t> ti;
  long used;
restart:
  if (ti.size() < 2 * cap) ti.resize(2 * cap);
  for (size_t i = 0; i < cap; i++) ti[2 * i] = ~0ULL;
  used = 0;
  {
    const uint64_t mask = cap - 1;
    const long AHEAD = 16;
    for (long i = 0; i < n; i++) {
      if (i + AHEAD < n)
        __builtin_prefetch(&ti[2 * (ht_mix(keys[i + AHEAD]) & mask)], 1);
      uint64_t key = keys[i];
      uint64_t h = ht_mix(key) & mask;
      while (true) {
        uint64_t* s = &ti[2 * h];
        if (s[0] == key) { s[1] += cnts[i]; break; }
        if (s[0] == ~0ULL) {
          s[0] = key; s[1] = cnts[i];
          if (++used * 10 > (long)cap * 7) { cap <<= 1; goto restart; }
          break;
        }
        h = (h + 1) & mask;
      }
    }
  }
  long m = 0;
  for (size_t i = 0; i < cap; i++) {
    if (ti[2 * i] != ~0ULL && (int)(uint32_t)ti[2 * i + 1] >= min_depth) {
      out_keys[m] = ti[2 * i];
      out_counts[m] = (int32_t)(uint32_t)ti[2 * i + 1];
      m++;
    }
  }
  std::vector<long> idx(m);
  for (long i = 0; i < m; i++) idx[i] = i;
  std::sort(idx.begin(), idx.end(), [&](long a, long b) {
    return out_keys[a] < out_keys[b];
  });
  std::vector<uint64_t> sk(m);
  std::vector<int32_t> sc(m);
  for (long i = 0; i < m; i++) { sk[i] = out_keys[idx[i]]; sc[i] = out_counts[idx[i]]; }
  memcpy(out_keys, sk.data(), m * sizeof(uint64_t));
  memcpy(out_counts, sc.data(), m * sizeof(int32_t));
  return m;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sorted-run spill: worker-side radix sort of an aggregator export + linear
// R-way merge-sum at finalize.  Replaces the route-to-part-files gather and
// the per-part hash re-count with one LSD radix sort per flush (sequential
// slice appends) and a streaming merge (each run has unique keys, so a key
// appears at most R times across runs).  The reference reaches its final
// sorted maps through per-part std::sort at restore time
// (ref: src/KmerSpectrum.h:1818-1902); this is the same dataflow with the
// sort moved into the (parallel) workers.
// ---------------------------------------------------------------------------

extern "C" {

// LSD radix sort by 64-bit key, 4 passes x 16 bits, SoA payload:
// counts u32 always, wsums f64 when has_w.  tk/tc/tw are caller-provided
// scratch arrays of the same length.  Passes whose key digit is constant
// across all records are skipped (k < 31 keys never touch the high bits).
void radix_sort_kcw(uint64_t* k, uint32_t* c, double* w, long n, int has_w,
                    uint64_t* tk, uint32_t* tc, double* tw) {
  if (n <= 1) return;
  uint64_t* ka = k; uint32_t* ca = c; double* wa = w;
  uint64_t* kb = tk; uint32_t* cb = tc; double* wb = tw;
  static const int R = 1 << 16;
  std::vector<long> hist(R);
  for (int pass = 0; pass < 4; pass++) {
    const int shift = pass * 16;
    std::fill(hist.begin(), hist.end(), 0L);
    for (long i = 0; i < n; i++) hist[(ka[i] >> shift) & 0xffff]++;
    // constant digit -> nothing to move this pass
    if (hist[(ka[0] >> shift) & 0xffff] == n) continue;
    long sum = 0;
    for (int d = 0; d < R; d++) { long h = hist[d]; hist[d] = sum; sum += h; }
    if (has_w) {
      for (long i = 0; i < n; i++) {
        long dst = hist[(ka[i] >> shift) & 0xffff]++;
        kb[dst] = ka[i]; cb[dst] = ca[i]; wb[dst] = wa[i];
      }
    } else {
      for (long i = 0; i < n; i++) {
        long dst = hist[(ka[i] >> shift) & 0xffff]++;
        kb[dst] = ka[i]; cb[dst] = ca[i];
      }
    }
    std::swap(ka, kb); std::swap(ca, cb);
    if (has_w) std::swap(wa, wb);
  }
  if (ka != k) {
    memcpy(k, ka, n * sizeof(uint64_t));
    memcpy(c, ca, n * sizeof(uint32_t));
    if (has_w) memcpy(w, wa, n * sizeof(double));
  }
}

// Merge R sorted runs of unique-keyed (key, count[, wsum]) records,
// summing duplicates across runs and dropping keys with summed count
// < min_depth.  Returns the output row count; out arrays must hold
// sum(lens).  Small-R linear head scan (R is the flush count, <= ~32).
long merge_sum_runs(const uint64_t** ks, const uint32_t** cs,
                    const double** ws, const long* lens, int R,
                    int min_depth, int has_w,
                    uint64_t* ko, int32_t* co, double* wo) {
  std::vector<long> pos(R, 0);
  long m = 0;
  while (true) {
    uint64_t best = ~0ULL;
    bool any = false;
    for (int r = 0; r < R; r++) {
      if (pos[r] < lens[r]) {
        uint64_t v = ks[r][pos[r]];
        if (!any || v < best) { best = v; any = true; }
      }
    }
    if (!any) break;
    long cnt = 0;
    double wsum = 0.0;
    for (int r = 0; r < R; r++) {
      long p = pos[r];
      if (p < lens[r] && ks[r][p] == best) {
        cnt += (long)cs[r][p];
        if (has_w) wsum += ws[r][p];
        pos[r] = p + 1;
      }
    }
    if (cnt >= min_depth) {
      ko[m] = best;
      co[m] = (int32_t)cnt;
      if (has_w) wo[m] = wsum;
      m++;
    }
  }
  return m;
}

}  // extern "C"

extern "C" {

// memchr newline scan -> positions.  np.flatnonzero(buf == 0x0a) costs
// ~150 ms per 16 MB chunk (bool temp + nonzero pass); this is ~10 ms.
long find_newlines(const uint8_t* buf, long n, int64_t* out, long cap) {
  long m = 0;
  const char* p = (const char*)buf;
  const char* end = p + n;
  while (p < end && m < cap) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    if (!nl) break;
    out[m++] = nl - (const char*)buf;
    p = nl + 1;
  }
  return m;
}

// gather_ragged with a 256-entry byte map applied on the fly (the FASTQ
// parser's base normalization fused into the copy).
void gather_ragged_map(const uint8_t* data, const int64_t* offs,
                       const int64_t* lens, long n, const uint8_t* map,
                       uint8_t* out) {
  long pos = 0;
  for (long i = 0; i < n; i++) {
    const uint8_t* src = data + offs[i];
    const long L = lens[i];
    for (long j = 0; j < L; j++) out[pos + j] = map[src[j]];
    pos += L;
  }
}

}  // extern "C"

// Native host-side hot loops for hysortk_tpu, exposed as a C ABI shared
// library consumed via ctypes (io/native.py).
//
// These are this build's equivalents of the reference's host hot loops:
//   * ASCII -> 2-bit packing        (reference DnaSeq::compress, src/dnaseq.cpp:9-80)
//   * FASTA newline-strip + pack    (reference FastaIndex::getmydna, src/fastaindex.cpp:248-293)
//   * packed-key -> ASCII decode    (reference Kmer::GetString, include/kmer.hpp:147-163)
//   * k-mer validity mask building
//
// All loops are OpenMP-parallel; the Python layer keeps bit-identical numpy
// fallbacks that double as the semantics oracle in tests.

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#ifdef _OPENMP
#include <omp.h>
#else
// Built without OpenMP (no OpenMP runtime on the host): the pragmas are
// ignored and every loop runs on one thread.
static inline int omp_get_max_threads() { return 1; }
#endif
#endif

extern "C" {

// ASCII -> 2-bit code, A/a=0 C/c=1 G/g=2 T/t=3, everything else 0.
static uint8_t g_code_lut[256];

static bool init_lut() {
  for (int i = 0; i < 256; ++i) g_code_lut[i] = 0;
  g_code_lut['A'] = g_code_lut['a'] = 0;
  g_code_lut['C'] = g_code_lut['c'] = 1;
  g_code_lut['G'] = g_code_lut['g'] = 2;
  g_code_lut['T'] = g_code_lut['t'] = 3;
  return true;
}
static const bool g_lut_ready = init_lut();

void hk_pack_codes(const uint8_t *ascii, int64_t n, uint8_t *out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) out[i] = g_code_lut[ascii[i]];
}

// Strip line breaks of FASTA records and pack codes in one pass.
// raw: the byte range read from the file; for record r, the sequence starts at
// raw_off[r] (relative to raw) and has seq_len[r] bases laid out in lines of
// line_bases[r] bases every line_width[r] bytes. Output is the concatenated
// code stream; out_off[r] gives each record's output offset.
void hk_strip_and_pack(const uint8_t *raw, const int64_t *raw_off,
                       const int64_t *seq_len, const int64_t *line_bases,
                       const int64_t *line_width, const int64_t *out_off,
                       int64_t nrecs, uint8_t *out) {
#pragma omp parallel for schedule(dynamic, 8)
  for (int64_t r = 0; r < nrecs; ++r) {
    const int64_t lb = line_bases[r] > 0 ? line_bases[r] : seq_len[r];
    const int64_t lw = line_width[r] > 0 ? line_width[r] : lb + 1;
    const uint8_t *src = raw + raw_off[r];
    uint8_t *dst = out + out_off[r];
    int64_t remaining = seq_len[r];
    while (remaining > 0) {
      const int64_t take = remaining < lb ? remaining : lb;
      for (int64_t i = 0; i < take; ++i) dst[i] = g_code_lut[src[i]];
      dst += take;
      src += lw;
      remaining -= take;
    }
  }
}

// Packed canonical keys -> ASCII. keys is row-major (n, w) uint32; out gets
// n*k chars (no separators).
void hk_decode_keys(const uint32_t *keys, int64_t n, int32_t w, int32_t k,
                    char *out) {
  static const char bases[4] = {'A', 'C', 'G', 'T'};
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t *key = keys + i * w;
    char *dst = out + i * k;
    for (int32_t j = 0; j < k; ++j) {
      const uint32_t word = key[j >> 4];
      dst[j] = bases[(word >> (2 * (15 - (j & 15)))) & 3u];
    }
  }
}

// Validity mask: valid[i] = 1 iff a k-mer starting at flat position i fits
// inside its read. lens/offsets describe the concatenated read layout.
void hk_build_valid(const int64_t *lens, int64_t nreads, int64_t k,
                    uint8_t *valid /* size = sum(lens) */) {
  int64_t off = 0;
  for (int64_t r = 0; r < nreads; ++r) {
    const int64_t n_valid = lens[r] - k + 1;
    for (int64_t i = 0; i < lens[r]; ++i) valid[off + i] = i < n_valid;
    off += lens[r];
  }
}

// 2-bit wire pack: 16 base codes per uint32 word, base b at bit shift
// 30 - 2*(b%16) (the host side of ops/wire.py; density of the reference's
// supermer payload, src/kmerops.cpp:1096-1107). n must be a multiple of 16
// (callers zero-pad).
void hk_pack_2bit(const uint8_t *codes, int64_t n, uint32_t *out) {
  const int64_t words = n / 16;
#pragma omp parallel for schedule(static)
  for (int64_t wi = 0; wi < words; ++wi) {
    const uint8_t *c = codes + wi * 16;
    uint32_t v = 0;
    for (int j = 0; j < 16; ++j) v |= (uint32_t)(c[j] & 3u) << (30 - 2 * j);
    out[wi] = v;
  }
}

// Render "kmer\tcount\n" lines for the output writer. counts are int32.
// Returns the number of bytes written; out must have n * (k + 12) capacity.
// Parallel in two passes (the reference writes per-rank files concurrently,
// src/hysortk.cpp:138-164; single-rank runs need thread parallelism here —
// this formatter measured 60.8 s single-threaded on the 512 Mb e2e run):
// pass 1 computes per-chunk byte totals (count digit widths are the only
// variable), a sequential scan places the chunks, pass 2 fills them.
int64_t hk_format_output(const uint32_t *keys, const int32_t *counts,
                         int64_t n, int32_t w, int32_t k, char *out) {
  static const char bases[4] = {'A', 'C', 'G', 'T'};
  if (n == 0) return 0;
  int64_t nchunks = 4;
#if defined(_OPENMP)
  nchunks = (int64_t)omp_get_max_threads() * 4;
#endif
  if (nchunks > n) nchunks = n;
  const int64_t rows_per = (n + nchunks - 1) / nchunks;
  nchunks = (n + rows_per - 1) / rows_per;
  std::vector<int64_t> chunk_off(nchunks + 1);
#pragma omp parallel for schedule(static)
  for (int64_t c = 0; c < nchunks; ++c) {
    const int64_t lo = c * rows_per;
    const int64_t hi = lo + rows_per < n ? lo + rows_per : n;
    int64_t b = 0;
    for (int64_t i = lo; i < hi; ++i) {
      int32_t v = counts[i];
      int32_t d = 1;  // c <= 0 renders as the single digit '0'
      while (v >= 10) { v /= 10; ++d; }
      b += (int64_t)k + 2 + d;
    }
    chunk_off[c + 1] = b;
  }
  for (int64_t c = 0; c < nchunks; ++c) chunk_off[c + 1] += chunk_off[c];
#pragma omp parallel for schedule(static)
  for (int64_t c = 0; c < nchunks; ++c) {
    const int64_t lo = c * rows_per;
    const int64_t hi = lo + rows_per < n ? lo + rows_per : n;
    int64_t pos = chunk_off[c];
    for (int64_t i = lo; i < hi; ++i) {
      const uint32_t *key = keys + i * w;
      for (int32_t j = 0; j < k; ++j) {
        const uint32_t word = key[j >> 4];
        out[pos++] = bases[(word >> (2 * (15 - (j & 15)))) & 3u];
      }
      out[pos++] = '\t';
      char tmp[12];
      int32_t cval = counts[i], len = 0;
      if (cval <= 0) tmp[len++] = '0';
      while (cval > 0) { tmp[len++] = (char)('0' + cval % 10); cval /= 10; }
      while (len > 0) out[pos++] = tmp[--len];
      out[pos++] = '\n';
    }
  }
  return chunk_off[nchunks];
}

// Supermer run decomposition of the flat k-mer stream (the reference's
// SupermerEncoder boundary rule, src/kmerops.cpp:1096-1148): a run is a
// maximal stretch of consecutive valid k-mer starts sharing a destination,
// split every max_kmers starts (the 250-base cap). One sequential pass
// (each boundary depends on the previous position — the numpy formulation
// instead pays ~8 full-array passes); fills out_start (flat index of the
// run's first k-mer), out_kmers and out_dest; returns the run count.
// Output buffers must hold n entries.
int64_t hk_run_boundaries(const uint8_t *valid, const int32_t *dest,
                          int64_t n, int64_t max_kmers,
                          int64_t *out_start, int64_t *out_kmers,
                          int32_t *out_dest) {
  int64_t runs = 0;
  int64_t prev = -2;        // last valid flat position
  int64_t run_pos = 0;      // k-mers since the UNCAPPED run's start
  int32_t cur_dest = -1;
  for (int64_t i = 0; i < n; ++i) {
    if (!valid[i]) continue;
    const int32_t d = dest[i];
    const bool new_run = (i != prev + 1) || (d != cur_dest);
    if (new_run) run_pos = 0;
    if (new_run || (run_pos % max_kmers) == 0) {
      out_start[runs] = i;
      out_kmers[runs] = 0;
      out_dest[runs] = d;
      ++runs;
    }
    ++out_kmers[runs - 1];
    ++run_pos;
    prev = i;
    cur_dest = d;
  }
  return runs;
}

// Concatenate per-run code slices codes[start .. start+bases) at the given
// output offsets (caller prefix-sums the lengths) — the gather behind
// per-bucket supermer streams (io/supermer.encode_supermer_streams).
void hk_gather_runs(const int8_t *codes, const int64_t *starts,
                    const int64_t *bases, const int64_t *out_off,
                    int64_t n_runs, int8_t *out) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n_runs; ++r) {
    memcpy(out + out_off[r], codes + starts[r], (size_t)bases[r]);
  }
}

}  // extern "C"

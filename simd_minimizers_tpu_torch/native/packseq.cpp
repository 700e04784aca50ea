// Host byte work of the port, built at first use by native/__init__.py
// (g++ -O3, a plain C interface loaded with ctypes).
//
// The port's own copy of what it needs of the JAX package's
// native/packseq.cpp: the ASCII fold (`pack_ascii`), the 2-bit packer
// (`pack_2bit`), the one-pass FASTA scan (`fasta_scan`, with
// `fasta_headers` to size its record table) and the value extractor
// (`kmer_values_u64`). The TPU's striped packers are not needed: the
// kernels read the plain byte stream.
//
// Codes are the reference's (the crate's src/lib.rs:121-128): A=00, C=01,
// T=10, G=11 via (c >> 1) & 3 in both cases; any byte but ACGTacgt is
// ambiguous. Lengths are size_t: inputs reach 2^32 chars and more.

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// Branchless per-byte transform that g++ vectorises: the ambiguity test is
// four compares on the case-folded byte, not a table gather.
static inline void transform_span(const uint8_t* p, size_t n, uint8_t* codes,
                                  uint8_t* amb) {
  for (size_t j = 0; j < n; j++) {
    uint8_t c = p[j];
    uint8_t lc = (uint8_t)(c | 0x20);
    codes[j] = (uint8_t)((c >> 1) & 3);
    amb[j] = (uint8_t)(1 - ((lc == 'a') | (lc == 'c') | (lc == 'g') | (lc == 't')));
  }
}

// codes[i] = (ascii[i] >> 1) & 3; amb[i] = 1 iff ascii[i] is not ACGTacgt.
void pack_ascii(const uint8_t* ascii, size_t n, uint8_t* codes, uint8_t* amb) {
  transform_span(ascii, n, codes, amb);
}

// 2-bit codes 4 to a byte: base i at bits 2 * (i % 4) of out[i / 4]; the
// last byte's unused bits are 0. Codes are taken as they are (0..3), as the
// JAX package's packer takes them.
void pack_2bit(const uint8_t* codes, size_t n, uint8_t* out) {
  size_t nb = n / 4;
  for (size_t b = 0; b < nb; b++) {
    const uint8_t* c = codes + 4 * b;
    out[b] = (uint8_t)(c[0] | c[1] << 2 | c[2] << 4 | c[3] << 6);
  }
  if (n % 4) {
    uint8_t v = 0;
    for (size_t i = 4 * nb; i < n; i++) v |= (uint8_t)(codes[i] << (2 * (i % 4)));
    out[nb] = v;
  }
}

// Lines of buf that start with '>': the headers fasta_scan counts as
// records (it may add one more, the implicit record 0 of sequence before
// the first header).
int64_t fasta_headers(const uint8_t* buf, size_t len) {
  int64_t count = 0;
  size_t i = 0;
  while (i < len) {
    const uint8_t* gt = (const uint8_t*)memchr(buf + i, '>', len - i);
    if (!gt) break;
    size_t j = (size_t)(gt - buf);
    if (j == 0 || buf[j - 1] == '\n') count++;
    i = j + 1;
  }
  return count;
}

// Line-oriented FASTA scan: every record's sequence lines, concatenated
// into codes/amb (transform_span). A line that starts with '>' opens a
// record; a '\r' is dropped only before the line's '\n' (or the end);
// blank lines add nothing; sequence before the first header opens an
// implicit record 0. starts[r] is record r's first char in codes and
// starts[nrec] the total. Returns nrec, or -1 if more than max_recs
// records would be needed (starts holds max_recs + 1 entries).
int64_t fasta_scan(const uint8_t* buf, size_t len, uint8_t* codes, uint8_t* amb,
                   int64_t* starts, int64_t max_recs) {
  int64_t nrec = 0;
  size_t w = 0;
  size_t i = 0;
  while (i < len) {
    const uint8_t* nl = (const uint8_t*)memchr(buf + i, '\n', len - i);
    size_t e = nl ? (size_t)(nl - buf) : len;
    if (buf[i] == '>') {
      if (nrec >= max_recs) return -1;
      starts[nrec++] = (int64_t)w;
    } else {
      size_t n = e - i;
      if (n && buf[e - 1] == '\r') n--;
      if (n && nrec == 0) {
        if (max_recs < 1) return -1;
        starts[nrec++] = 0;
      }
      transform_span(buf + i, n, codes + w, amb + w);
      w += n;
    }
    i = e + 1;
  }
  starts[nrec] = (int64_t)w;
  return nrec;
}

// Host k-mer value extraction (the reference's Output::values_u64, the
// crate's src/lib.rs:598-612): value = 2-bit codes packed with char i at
// bits 2*i; canonical = min(fwd, revcomp), complement = c ^ 2. One pass per
// position (~2 cache lines of codes each) instead of the NumPy (m, k)
// index-matrix gather.
void kmer_values_u64(const uint8_t* codes, const uint32_t* pos, int64_t m,
                     int64_t k, int canonical, uint64_t* out) {
  for (int64_t i = 0; i < m; i++) {
    const uint8_t* p = codes + pos[i];
    uint64_t v = 0;
    for (int64_t j = 0; j < k; j++) v |= (uint64_t)p[j] << (2 * j);
    if (canonical) {
      uint64_t r = 0;
      for (int64_t j = 0; j < k; j++)
        r |= (uint64_t)(p[k - 1 - j] ^ 2) << (2 * j);
      if (r < v) v = r;
    }
    out[i] = v;
  }
}

}  // extern "C"

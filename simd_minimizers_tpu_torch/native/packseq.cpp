// Host k-mer value extraction of the port, built at first use by
// native/__init__.py (g++ -O3, a plain C interface loaded with ctypes).
//
// The port's own copy of the value extractor of the JAX package's
// native/packseq.cpp (`kmer_values_u64`); the TPU packers and the FASTA
// scan of that file are not needed by the port.
//
// The reference's Output::values_u64 (the crate's src/lib.rs:598-612):
// value = 2-bit codes packed with char i at bits 2*i; canonical = min(fwd,
// revcomp), complement = c ^ 2. One pass per position (~2 cache lines of
// codes each) instead of the NumPy (m, k) index-matrix gather.

#include <cstdint>

extern "C" {

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

// k-mer values at minimizer positions, on Hopper (sm_90a).
//
// Counterpart of simd_minimizers_tpu/ops/device_values.py
// `values_limbs_jnp`, which the JAX package runs as plain XLA (gathers and
// shifts, no Pallas kernel): the value of the k-mer at each position, first
// base in the lowest bits, 2 bits a base, as L = ceil(2k / 32) u32 limbs
// (limb j holds value bits [32j, 32j + 32)); with `canonical` the least of
// the forward value and the reverse complement's, compared from the top
// limb down (the crate's src/lib.rs:598-612; the complement of a code is
// c ^ 2).
//
// The input is the sequence the sketch read, as it lies on the card:
//   - the 2-bit byte stream (base i at bits 2 * (i % 4) of byte i / 4, so
//     its little-endian u32 words hold base i at bit 2 * (i % 16) of word
//     i / 16);
//   - with `byte_codes`, one 2-bit code a byte (the FASTA reader's codes,
//     of which the low two bits count, as minimizer_tiles reads them).
// Both are read as the 4-byte words of the aligned buffer around `chars`
// (whose address need not be a multiple of 4: the first word's bytes
// before it never reach a value). Bytes past the buffer read as 0 (the
// port uploads no pad words; the JAX code pads four and clips), and no word
// past the buffer's last is loaded. Bits past the k-mer never reach a
// value: the lower limbs lie inside it and the top limb is masked to
// 2k - 32 (L - 1) bits. Positions are u32, up to 2^32 - 1, in any order
// (the kernel assumes nothing of neighbouring positions), and m may pass
// 2^31 / L.
//
// The reverse complement: complement each limb (^ 0xAAAAAAAA, the odd bit
// of every code), mask the top limb, reverse the 2-bit groups of each limb
// (`__brev`, then swap the two bits of each group) in reversed limb order,
// which leaves the value in the top 2k of the 32L bits, and realign it with
// a funnel shift by S = 32L - 2k (S = 0 at k = 16, 32, 48, 64).
//
// Bound: bytes. At 1e8 bases, canonical k=21 w=11 (m = 1.67e7 positions)
// it reads 67 MB of positions and the 25 MB stream once and writes 133 MB
// of limbs: about 0.067 ms at 3.35 TB/s. What the design does for it:
//   - A row's L limbs stored as L stores of 4 bytes at a 4L-byte stride
//     would fill 1/L of the sectors each warp-wide store touches, so a row
//     is one store of 4L bytes where L = 2 or 4 (`store_row`).
//   - Code bytes read one byte a load would take k load instructions a
//     position. The words covering the k-mer (ceil((k + 3) / 4) at most)
//     are loaded instead and four codes packed from each with an and and a
//     multiply ((x & 0x03030303) * 0x01041040 leaves c0 | c1 << 2 | c2 << 4
//     | c3 << 6 in the top byte: the ten partial products fall on distinct
//     bit pairs) and byte permutes; one funnel shift a limb realigns them.
//   - A thread takes two positions (one at L = 4) and issues the gathers
//     of both before it assembles a value; a k-mer whose words lie inside
//     the buffer loads them with no per-word bounds check (32-bit indices).
// Its loads and stores are all a warp's consecutive rows, so what is left
// is the card's rate for reads and writes mixed (PERF.md). The
// stream of a 1e8-base sequence (25 MB) or a chromosome's code bytes
// (47 MB for chr21) lies in the 50 MB L2, so where positions rise (the
// sketch's order) neighbouring gathers hit it; positions in a random order
// gather a sector of their own each. One instance per L (1..4), so the
// limbs live in registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int VALUES_THREADS = 256;
constexpr long long VALUES_MAX_BLOCKS = 1 << 20;  // a grid-stride loop covers the rest

// The input as the 4-byte words of the aligned buffer around it. Word
// indices fit 32 bits: a buffer has at most 2^32 + 3 bytes.
struct Words {
  const uint32_t* w;   // the 4-byte-aligned address at or below chars
  uint32_t lead;       // chars - w, in bytes (0..3)
  uint32_t last;       // the last word that holds a byte of the buffer
  uint32_t tail_mask;  // the bits of that word's bytes inside the buffer
};

__device__ __forceinline__ Words words_of(const uint8_t* chars, long long nbytes) {
  Words s;
  s.lead = (uint32_t)(reinterpret_cast<uintptr_t>(chars) & 3);
  s.w = reinterpret_cast<const uint32_t*>(chars - s.lead);
  s.last = (uint32_t)((s.lead + nbytes - 1) >> 2);
  const uint32_t tail = (uint32_t)(s.lead + nbytes - 4 * (long long)s.last);  // 1..4 bytes
  s.tail_mask = tail == 4 ? 0xFFFFFFFFu : (1u << (8 * tail)) - 1;
  return s;
}

// Word q of the aligned buffer, its bytes past the buffer 0; no load past
// the buffer's last word. Only a k-mer that reaches the last word takes
// this; the others load their words as they are.
__device__ __forceinline__ uint32_t load_word(const Words& s, uint32_t q) {
  if (q > s.last) return 0;
  const uint32_t v = __ldg(s.w + q);
  return q == s.last ? v & s.tail_mask : v;
}

// The sixteen 2-bit groups of x in reverse order (each group kept).
__device__ __forceinline__ uint32_t rev2(uint32_t x) {
  x = __brev(x);
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// Four code bytes (the low two bits of each) in the top byte, in order.
__device__ __forceinline__ uint32_t pack4_top(uint32_t x) {
  return (x & 0x03030303u) * 0x01041040u;
}

// The forward limbs of the k-mer at p of the 2-bit byte stream: bit
// 8 lead + 2p of the aligned buffer is the k-mer's first, bit sh of word q.
template <int L>
__device__ __forceinline__ void stream_gather(const Words& s, uint32_t p, uint32_t (&g)[L + 1],
                                              uint32_t& sh) {
  const uint32_t bit = 8 * s.lead + 2 * (p & 15);
  const uint32_t q = (p >> 4) + (bit >> 5);
  sh = bit & 31;
  if (q + L < s.last) {
#pragma unroll
    for (int j = 0; j <= L; ++j) g[j] = __ldg(s.w + q + j);
  } else {
#pragma unroll
    for (int j = 0; j <= L; ++j) g[j] = load_word(s, q + j);
  }
}

template <int L>
__device__ __forceinline__ void stream_limbs(const uint32_t (&g)[L + 1], uint32_t sh,
                                             uint32_t (&f)[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) f[j] = __funnelshift_r(g[j], g[j + 1], sh);
}

// The words of code bytes that the k-mer at p covers: byte lead + p of the
// aligned buffer is its first, byte sh / 2 of word q; g[i] is word q + i,
// loaded where it holds a byte of the k-mer.
template <int L>
__device__ __forceinline__ void code_gather(const Words& s, uint32_t p, int k,
                                            uint32_t (&g)[4 * L + 1], uint32_t& sh) {
  const uint32_t e = (p & 3) + s.lead;
  const uint32_t q = (p >> 2) + (e >> 2);
  sh = 2 * (e & 3);
  const int need = ((int)(e & 3) + k + 3) >> 2;
  if (q + 4 * L < s.last) {
#pragma unroll
    for (int i = 0; i <= 4 * L; ++i) g[i] = i < need ? __ldg(s.w + q + i) : 0;
  } else {
#pragma unroll
    for (int i = 0; i <= 4 * L; ++i) g[i] = i < need ? load_word(s, q + i) : 0;
  }
}

template <int L>
__device__ __forceinline__ void code_limbs(const uint32_t (&g)[4 * L + 1], uint32_t sh,
                                           uint32_t (&f)[L]) {
  uint32_t packed[L + 1];  // 16 codes a word, from the aligned word e / 4 on
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t lo = __byte_perm(pack4_top(g[4 * j]), pack4_top(g[4 * j + 1]), 0x0073);
    const uint32_t hi = __byte_perm(pack4_top(g[4 * j + 2]), pack4_top(g[4 * j + 3]), 0x0073);
    packed[j] = __byte_perm(lo, hi, 0x5410);
  }
  packed[L] = pack4_top(g[4 * L]) >> 24;
#pragma unroll
  for (int j = 0; j < L; ++j) f[j] = __funnelshift_r(packed[j], packed[j + 1], sh);
}

// The top limb masked to the k-mer, then with `canonical` the least of the
// value and its reverse complement's.
template <int L>
__device__ __forceinline__ void finish(uint32_t (&f)[L], uint32_t top_mask, int S,
                                       bool canonical) {
  f[L - 1] &= top_mask;
  if (!canonical) return;
  uint32_t r[L + 1];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    uint32_t c = f[L - 1 - j] ^ 0xAAAAAAAAu;
    if (j == 0) c &= top_mask;
    r[j] = rev2(c);
  }
  r[L] = 0;
  bool take = false, eq = true;
  uint32_t rc[L];
#pragma unroll
  for (int j = L - 1; j >= 0; --j) {
    rc[j] = __funnelshift_r(r[j], r[j + 1], S);
    take = take || (eq && rc[j] < f[j]);
    eq = eq && rc[j] == f[j];
  }
  if (take) {
#pragma unroll
    for (int j = 0; j < L; ++j) f[j] = rc[j];
  }
}

// Row i's L limbs to out: one store of 4L bytes for L = 1, 2, 4, so a
// warp's stores of its 32 consecutive rows fill whole sectors; L = 3 as
// three 4-byte stores (a warp's rows staged in shared memory and stored
// 16 bytes a lane took longer on the H100; PERF.md).
template <int L>
__device__ __forceinline__ void store_row(uint32_t* __restrict__ out, long long i,
                                          const uint32_t (&f)[L], bool vec) {
  uint32_t* o = out + L * i;
  if constexpr (L == 2) {
    if (vec) {
      *reinterpret_cast<uint2*>(o) = make_uint2(f[0], f[1]);
      return;
    }
  } else if constexpr (L == 4) {
    if (vec) {
      *reinterpret_cast<uint4*>(o) = make_uint4(f[0], f[1], f[2], f[3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < L; ++j) o[j] = f[j];
}

// Positions a thread takes, VALUES_THREADS apart (so that each load and
// store instruction of a warp covers consecutive rows): two, but one at
// L = 4, whose 2-bit gathers and limbs of two positions cost more in
// occupancy than they win in loads in flight (PERF.md).
__host__ __device__ constexpr int per_thread(int L) { return L == 4 ? 1 : 2; }

template <int L>
__global__ void __launch_bounds__(VALUES_THREADS)
kmer_values(const uint8_t* __restrict__ chars, long long nbytes,
            const uint32_t* __restrict__ positions, long long m, int k, int canonical,
            int byte_codes, uint32_t* __restrict__ out) {
  constexpr int P = per_thread(L);
  constexpr int CHUNK = VALUES_THREADS * P;
  const Words s = words_of(chars, nbytes);
  const int top_bits = 2 * k - 32 * (L - 1);  // 1..32 bits of the top limb
  const uint32_t top_mask = top_bits == 32 ? 0xFFFFFFFFu : (1u << top_bits) - 1;
  const int S = 32 * L - 2 * k;  // 0..30: the reverse complement's realignment
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (long long c = blockIdx.x; c * CHUNK < m; c += gridDim.x) {
    const long long i0 = c * CHUNK + threadIdx.x;  // rows i0 + VALUES_THREADS e
    uint32_t p[P];
#pragma unroll
    for (int e = 0; e < P; ++e) {
      const long long i = i0 + (long long)VALUES_THREADS * e;
      p[e] = i < m ? __ldg(positions + i) : 0;
    }
    uint32_t f[P][L];
    if (byte_codes) {
      uint32_t g[P][4 * L + 1], sh[P];
#pragma unroll
      for (int e = 0; e < P; ++e) code_gather<L>(s, p[e], k, g[e], sh[e]);
#pragma unroll
      for (int e = 0; e < P; ++e) code_limbs<L>(g[e], sh[e], f[e]);
    } else {
      uint32_t g[P][L + 1], sh[P];
#pragma unroll
      for (int e = 0; e < P; ++e) stream_gather<L>(s, p[e], g[e], sh[e]);
#pragma unroll
      for (int e = 0; e < P; ++e) stream_limbs<L>(g[e], sh[e], f[e]);
    }
#pragma unroll
    for (int e = 0; e < P; ++e) {
      const long long i = i0 + (long long)VALUES_THREADS * e;
      finish<L>(f[e], top_mask, S, canonical != 0);
      if (i < m) store_row<L>(out, i, f[e], vec);
    }
  }
}

}  // namespace

extern "C" {

// Values of the k-mers (1 <= k <= 64) at the m u32 positions, into out,
// m * ceil(2k / 32) u32 limbs, row by row. chars: the 2-bit byte stream of
// nbytes bytes, or with byte_codes one 2-bit code a byte. Returns a CUDA
// error code (0 = success): cudaGetLastError() after the launch.
int smt_kmer_values(int device, const void* chars, long long nbytes, const void* positions,
                    long long m, int k, int canonical, int byte_codes, void* out,
                    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (k < 1 || k > 64 || m < 1 || nbytes < 1) return (int)cudaErrorInvalidValue;
  const int L = (2 * k + 31) / 32;
  const long long rows = (long long)VALUES_THREADS * per_thread(L);  // a block's, at a time
  long long blocks = (m + rows - 1) / rows;
  if (blocks > VALUES_MAX_BLOCKS) blocks = VALUES_MAX_BLOCKS;
  const auto* c = (const uint8_t*)chars;
  const auto* p = (const uint32_t*)positions;
  auto* o = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  void (*kern)(const uint8_t*, long long, const uint32_t*, long long, int, int, int,
               uint32_t*) = nullptr;
  switch (L) {
    case 1: kern = kmer_values<1>; break;
    case 2: kern = kmer_values<2>; break;
    case 3: kern = kmer_values<3>; break;
    default: kern = kmer_values<4>; break;
  }
  kern<<<blocks, VALUES_THREADS, 0, s>>>(c, nbytes, p, m, k, canonical, byte_codes, o);
  return (int)cudaGetLastError();
}

}  // extern "C"

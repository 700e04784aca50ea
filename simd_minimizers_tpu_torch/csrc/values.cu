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
// One thread a position, no shared memory. The input is the sequence the
// sketch read, as it lies on the card:
//   - the 2-bit byte stream (base i at bits 2 * (i % 4) of byte i / 4, so
//     its little-endian u32 words hold base i at bit 2 * (i % 16) of word
//     i / 16): the thread gathers words p / 16 .. p / 16 + L and
//     funnel-shifts them by 2 * (p % 16) (`__funnelshift_r` is defined for
//     a shift of 0, which the JAX code guards with a `where`);
//   - with `byte_codes`, one 2-bit code a byte (the FASTA reader's codes,
//     of which the low two bits count, as minimizer_tiles reads them): the
//     thread reads the k bytes at p.
// Words and bytes past the buffer read as 0 (the port uploads no pad
// words; the JAX code pads four and clips). Bits past the k-mer never
// reach a value: the lower limbs lie inside it and the top limb is masked
// to 2k - 32 (L - 1) bits. Positions are u32, up to 2^32 - 1.
//
// The reverse complement: complement each limb (^ 0xAAAAAAAA, the odd bit
// of every code), mask the top limb, reverse the 2-bit groups of each limb
// (`__brev`, then swap the two bits of each group) in reversed limb order,
// which leaves the value in the top 2k of the 32L bits, and realign it with
// a funnel shift by S = 32L - 2k (S = 0 at k = 16, 32, 48, 64).
//
// Bound: bytes. At 1e8 bases, canonical k=21 w=11 (m = 1.67e7 positions)
// it reads 67 MB of positions and the 25 MB stream once and writes 133 MB
// of limbs: about 0.067 ms at 3.35 TB/s. The design keeps that traffic
// minimal: positions are read coalesced, the gathers of neighbouring
// threads hit the same or adjacent words (positions rise), the stream of a
// 1e8-base sequence fits the 50 MB L2, and each thread writes its L limbs
// once. It launches L instances (1..4) so the limbs live in registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int VALUES_THREADS = 256;
constexpr long long VALUES_MAX_BLOCKS = 1 << 20;  // a grid-stride loop covers the rest

// The sixteen 2-bit groups of x in reverse order (each group kept).
__device__ __forceinline__ uint32_t rev2(uint32_t x) {
  x = __brev(x);
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// Word wi of the 2-bit byte stream (bytes 4 wi .. 4 wi + 3, little-endian);
// bytes past nbytes read as 0.
__device__ __forceinline__ uint32_t stream_word(const uint8_t* chars, long long nbytes,
                                                long long wi, bool aligned) {
  const long long b = wi * 4;
  if (aligned && b + 4 <= nbytes) return __ldg(reinterpret_cast<const uint32_t*>(chars + b));
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (b + i < nbytes) v |= uint32_t(__ldg(chars + b + i)) << (8 * i);
  return v;
}

template <int L>
__global__ void __launch_bounds__(VALUES_THREADS)
kmer_values(const uint8_t* __restrict__ chars, long long nbytes,
            const uint32_t* __restrict__ positions, long long m, int k, int canonical,
            int byte_codes, uint32_t* __restrict__ out) {
  const bool aligned = (reinterpret_cast<uintptr_t>(chars) & 3) == 0;
  const int top_bits = 2 * k - 32 * (L - 1);  // 1..32 bits of the top limb
  const uint32_t top_mask = top_bits == 32 ? 0xFFFFFFFFu : (1u << top_bits) - 1;
  const int S = 32 * L - 2 * k;  // 0..30: the reverse complement's realignment
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride) {
    const uint32_t p = positions[i];
    uint32_t f[L];
    if (byte_codes) {
#pragma unroll
      for (int j = 0; j < L; ++j) f[j] = 0;
#pragma unroll
      for (int c = 0; c < 16 * L; ++c) {
        const long long b = (long long)p + c;
        if (c < k && b < nbytes) f[c >> 4] |= uint32_t(__ldg(chars + b) & 3) << (2 * (c & 15));
      }
    } else {
      const long long wi = p >> 4;
      const uint32_t sh = 2 * (p & 15);
      uint32_t g[L + 1];
#pragma unroll
      for (int j = 0; j <= L; ++j) g[j] = stream_word(chars, nbytes, wi + j, aligned);
#pragma unroll
      for (int j = 0; j < L; ++j) f[j] = __funnelshift_r(g[j], g[j + 1], sh);
      f[L - 1] &= top_mask;
    }
    if (canonical) {
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
#pragma unroll
    for (int j = 0; j < L; ++j) out[i * L + j] = f[j];
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
  long long blocks = (m + VALUES_THREADS - 1) / VALUES_THREADS;
  if (blocks > VALUES_MAX_BLOCKS) blocks = VALUES_MAX_BLOCKS;
  const auto* c = (const uint8_t*)chars;
  const auto* p = (const uint32_t*)positions;
  auto* o = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  void (*kern)(const uint8_t*, long long, const uint32_t*, long long, int, int, int,
               uint32_t*) = nullptr;
  switch ((2 * k + 31) / 32) {
    case 1: kern = kmer_values<1>; break;
    case 2: kern = kmer_values<2>; break;
    case 3: kern = kmer_values<3>; break;
    default: kern = kmer_values<4>; break;
  }
  kern<<<blocks, VALUES_THREADS, 0, s>>>(c, nbytes, p, m, k, canonical, byte_codes, o);
  return (int)cudaGetLastError();
}

}  // extern "C"

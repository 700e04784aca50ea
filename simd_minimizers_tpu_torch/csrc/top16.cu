// kmer_top16: the top 16 bits of the hash of every k-mer, on Hopper (sm_90a).
//
// The pre-pass of minimizer_tiles' large-w route (csrc/minimizers.cu). It
// replaces, on that route, the hash stage of the one Pallas TPU kernel of
// the JAX package: simd_minimizers_tpu/ops/fused.py `_hash_windows` (B2),
// which the TPU kernel runs on its large-halo geometry over every column of
// a block. The large-w route used to hash w + T k-mers per T windows (9 to
// 16 hashes a window at w = 32,767 and 61,439, each a rolling step with two
// table lookups); it now reads the 16-bit tops this kernel writes once per
// k-mer, and hashes nothing.
//
// Output: out[i] = top 16 bits of the hash of k-mer i (chars i .. i + k - 1)
// for i in [0, n - k], as minimizer_tiles' `hash_cols` computes it: the nt /
// mul fold XOR_i rotl(F[c_i], i + rot) over per-char forward values F, XORed
// with the reverse complement's XOR_i rotl(R[c_i], k - 1 - i + rot) when
// CANONICAL; or antilex, the complement of the first min(k, 16) chars packed
// MSB-first (canonical: XOR the same of the reverse complement). There is no
// sentinel: 0xFFFF is a real top, and the reader tests validity by index.
// The input is the same as minimizer_tiles': the plain 2-bit byte stream
// (base i at bits 2 * (i % 4) of byte i / 4), 2-bit codes one per byte (only
// the low two bits count) or text bytes; n from `meta` on the card when it
// is given (a CUDA-graph capture), the tables, `rot` and the antilex flag
// block-uniform.
//
// What bounds it on the H100: bytes. It reads 0.25 B per char of 2-bit
// input (1 B of code bytes or text) and writes 2 B per k-mer: 0.225 GB at
// 1e8 chars, 0.067 ms at 3.35 TB/s. The function needs about 10 integer
// operations per k-mer canonical (decode 2, a rolling step per strand 3,
// the XOR of the strands and the shift to the top bits), 0.060 ms at the
// card's int32 rate, so the two bounds are close and the design keeps the
// hash O(1) per k-mer and every global access coalesced:
// - one block per KMERS = 8,192 k-mers reads its KMERS + k - 1 chars once
//   into shared memory, one char per byte (2-bit input: 16 chars per 32-bit
//   load, spread to four shared words);
// - thread t hashes the RUN = 32 consecutive k-mers from RUN * t, the first
//   in O(k) (O(min(k, 16)) for antilex), the others by the rolling update
//   (2-bit input: one lookup of the char pair's rotated values per strand;
//   text: two lookups of each table), reading its chars as 32-bit words (a
//   byte a lane at the runs' 32-char stride is an 8-way bank conflict; the
//   first build, which did that, took 0.338 ms at 1e8 chars on an H100),
//   and keeps the 32 tops in 16 registers;
// - after a barrier the chars are dead and their space stages the tops, run
//   t at word 17 t (an odd stride: the 32 lanes' stores hit 32 banks), so
//   the block writes them out as 32-bit words, consecutive lanes on
//   consecutive k-mers.
// Its shared memory, max(KMERS + k - 1 chars, the staging) plus the tables,
// is less than the bound of ops/fused.fused_supported on the large-w route
// (`_halo_bytes`: the tile's TILE + k + w + 2 chars and its keys) at every
// geometry it admits, so the pre-pass never narrows the gate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 32;                  // consecutive k-mers a thread hashes
constexpr int KMERS = THREADS * RUN;     // k-mers per block
constexpr int STAGE_WORDS = RUN / 2 + 1; // 32-bit words per staged run (odd: no bank conflict)
constexpr int CODES = 4;                 // per-char table entries of 2-bit input
constexpr int TEXT_CHARS = 256;          // per-char table entries of text (bytes)

// Shared memory: the block's chars (then the staged tops), 16-byte aligned,
// then the fold's forward and complement tables (none for antilex).
// 16 chars of slack: a run's realigned char streams read a word past their end.
__host__ __device__ inline int block_chars(int k) { return (KMERS + k - 1 + 16 + 15) / 16 * 16; }
__host__ __device__ inline int stage_bytes() { return THREADS * STAGE_WORDS * 4; }
__host__ __device__ inline int table_offset(int k) {
  return block_chars(k) > stage_bytes() ? block_chars(k) : stage_bytes();
}
__host__ __device__ inline int table_words(bool text, bool antilex) {
  return antilex ? 0 : 2 * (text ? TEXT_CHARS : CODES);
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }
__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) { return __funnelshift_r(x, x, r); }

// The four 2-bit codes of byte b, one per byte of the result.
__device__ __forceinline__ uint32_t spread(uint32_t b) {
  return (b & 3u) | ((b >> 2) & 3u) << 8 | ((b >> 4) & 3u) << 16 | ((b >> 6) & 3u) << 24;
}

template <bool CANONICAL>
__global__ void __launch_bounds__(THREADS)
kmer_top16(const uint8_t* __restrict__ words, long long nbytes, int n_arg, int k, int bytes_in,
           int text, int antilex, const long long* __restrict__ table, int rot,
           const int* __restrict__ meta, uint16_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  // 2-bit input: the rolling step's value of each (outgoing, incoming) char
  // pair, both rotated, per strand
  __shared__ uint32_t s_roll[2][CODES * CODES];

  const int tid = threadIdx.x;
  const int n = meta ? meta[0] : n_arg;  // a captured launch reads its length on the card
  const long long b0 = (long long)blockIdx.x * KMERS;  // the block's first k-mer
  const long long nk = (long long)n - k + 1;
  if (b0 >= nk) return;  // past a captured launch's length: the whole block
  const int m = (int)min((long long)KMERS, nk - b0);  // k-mers the block writes
  const int nchars = block_chars(k);
  uint8_t* s_c = smem;  // s_c[s] = code of char b0 + s
  uint32_t* tF = reinterpret_cast<uint32_t*>(smem + table_offset(k));
  uint32_t* tR = tF + (text ? TEXT_CHARS : CODES);
  for (int i = tid; i < table_words(text, antilex); i += THREADS) tF[i] = (uint32_t)table[i];
  if (!text && !antilex && tid < CODES * CODES) {
    const int a = tid / CODES, b = tid % CODES;
    s_roll[0][tid] = rotl((uint32_t)table[a], rot) ^ rotl((uint32_t)table[b], k + rot);
    s_roll[1][tid] = rotl((uint32_t)table[CODES + a], k - 1 + rot) ^
                     rotl((uint32_t)table[CODES + b], rot - 1);
  }

  // the chars, one per shared byte, those outside the input reading as 0
  // (they reach only k-mers past m, which are not written)
  if (bytes_in) {
    const bool aligned = (reinterpret_cast<uintptr_t>(words) & 3) == 0;
    const uint32_t keep = text ? 0xFFFFFFFFu : 0x03030303u;
    for (int i = tid; i < nchars / 4; i += THREADS) {
      const long long g = b0 + 4LL * i;
      uint32_t x = 0;
      if (aligned && g + 4 <= nbytes) {
        x = __ldg(reinterpret_cast<const uint32_t*>(words + g));
      } else {
        for (int q = 0; q < 4; ++q)
          if (g + q < nbytes) x |= (uint32_t)words[g + q] << (8 * q);
      }
      reinterpret_cast<uint32_t*>(s_c)[i] = x & keep;
    }
  } else {
    const bool aligned = (reinterpret_cast<uintptr_t>(words) & 3) == 0;
    for (int i = tid; i < nchars / 16; i += THREADS) {
      const long long g = b0 / 4 + 4LL * i;  // 16 chars: 4 packed bytes
      uint32_t x = 0;
      if (aligned && g + 4 <= nbytes) {
        x = __ldg(reinterpret_cast<const uint32_t*>(words + g));
      } else {
        for (int q = 0; q < 4; ++q)
          if (g + q < nbytes) x |= (uint32_t)words[g + q] << (8 * q);
      }
      reinterpret_cast<uint4*>(s_c)[i] =
          make_uint4(spread(x & 0xFFu), spread((x >> 8) & 0xFFu), spread((x >> 16) & 0xFFu),
                     spread(x >> 24));
    }
  }
  __syncthreads();

  // the run of k-mers j0 .. j0 + RUN - 1 (block-local; k-mer j starts at
  // s_c[j]), two tops to a register word. Runs start RUN = 32 chars apart,
  // so a byte load of one char per lane would be an 8-way bank conflict:
  // the chars come as 32-bit words instead, the run's own (word-aligned)
  // and, for the char entering each step, a stream realigned from any char
  // by a funnel shift of two words. Step q (k-mer j0 + q to j0 + q + 1)
  // takes char j0 + q + o1 from stream 1 (o1 = 0: the outgoing char; antilex
  // J: the char entering la) and char j0 + q + k from stream 2.
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(s_c);
  const int j0 = tid * RUN;
  const int J = min(k, 16);  // antilex: the chars packed
  const int p1 = j0 + (antilex ? J : 0), p2 = j0 + k;
  const int sh1 = 8 * (p1 & 3), sh2 = 8 * (p2 & 3);
  int i1 = p1 >> 2, i2 = p2 >> 2;
  uint32_t lo1 = s32[i1], lo2 = s32[i2], cur1 = 0, cur2 = 0;
  uint32_t v[RUN / 2];
  if (antilex) {
    // ~ of the first J chars & 3 packed MSB-first (la); canonical XORs in
    // the same of the reverse complement, the complemented last J chars
    // reversed (ra): ~la ^ ~ra = la ^ ra
    const int lo = 32 - 2 * J;
    const uint32_t topJ = ~((1u << lo) - 1u);
    uint32_t la = 0, ra = 0;
    for (int q = 0; q < J; ++q) {
      la |= (uint32_t)(s_c[j0 + q] & 3) << (30 - 2 * q);
      if (CANONICAL) ra |= (uint32_t)((s_c[j0 + k - 1 - q] & 3) ^ 2) << (30 - 2 * q);
    }
#pragma unroll
    for (int q = 0; q < RUN; ++q) {
      const uint32_t top = (CANONICAL ? la ^ ra : ~la) >> 16;
      v[q / 2] = q & 1 ? v[q / 2] | top << 16 : top;
      if (q + 1 < RUN) {
        if (q % 4 == 0) {
          const uint32_t hi1 = s32[++i1], hi2 = s32[++i2];
          cur1 = __funnelshift_r(lo1, hi1, sh1), cur2 = __funnelshift_r(lo2, hi2, sh2);
          lo1 = hi1, lo2 = hi2;
        }
        const uint32_t c1 = (cur1 >> (8 * (q % 4))) & 3u, c2 = (cur2 >> (8 * (q % 4))) & 3u;
        la = la << 2 | c1 << lo;
        if (CANONICAL) ra = (ra >> 2 | (c2 ^ 2u) << 30) & topJ;
      }
    }
  } else {
    uint32_t h = 0, r = 0;
    for (int i = 0; i < k; i += 4) {
      const uint32_t x = s32[(j0 + i) >> 2];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (i + b < k) {
          const int c = (x >> (8 * b)) & 0xFF;
          h ^= rotl(tF[c], i + b + rot);
          if (CANONICAL) r ^= rotl(tR[c], k - 1 - i - b + rot);
        }
    }
#pragma unroll
    for (int q = 0; q < RUN; ++q) {
      const uint32_t top = (CANONICAL ? h ^ r : h) >> 16;
      v[q / 2] = q & 1 ? v[q / 2] | top << 16 : top;
      if (q + 1 < RUN) {
        if (q % 4 == 0) {
          const uint32_t hi1 = s32[++i1], hi2 = s32[++i2];
          cur1 = __funnelshift_r(lo1, hi1, sh1), cur2 = __funnelshift_r(lo2, hi2, sh2);
          lo1 = hi1, lo2 = hi2;
        }
        const int c_out = (cur1 >> (8 * (q % 4))) & 0xFF, c_in = (cur2 >> (8 * (q % 4))) & 0xFF;
        if (!text) {
          h = rotr(h ^ s_roll[0][4 * c_out + c_in], 1);
          if (CANONICAL) r = rotl(r ^ s_roll[1][4 * c_out + c_in], 1);
        } else {
          h = rotr(h ^ rotl(tF[c_out], rot) ^ rotl(tF[c_in], k + rot), 1);
          if (CANONICAL) r = rotl(r ^ rotl(tR[c_out], k - 1 + rot) ^ rotl(tR[c_in], rot - 1), 1);
        }
      }
    }
  }
  __syncthreads();  // every char read: their space stages the tops

  uint32_t* stage = reinterpret_cast<uint32_t*>(smem);
#pragma unroll
  for (int i = 0; i < RUN / 2; ++i) stage[tid * STAGE_WORDS + i] = v[i];
  __syncthreads();
  // k-mers 2p, 2p + 1 of the block: one 32-bit store where both are written
  // and the output is aligned (b0 is even), else one 16-bit store each
  const bool aligned_out = (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  for (int p = tid; 2 * p < m; p += THREADS) {
    const int i = 2 * p;
    const uint32_t two = stage[(i / RUN) * STAGE_WORDS + (i % RUN) / 2];
    if (aligned_out && i + 1 < m) {
      reinterpret_cast<uint32_t*>(out + b0)[p] = two;
    } else {
      out[b0 + i] = (uint16_t)two;
      if (i + 1 < m) out[b0 + i + 1] = (uint16_t)(two >> 16);
    }
  }
}

using Top16Kernel = void (*)(const uint8_t*, long long, int, int, int, int, int,
                             const long long*, int, const int*, uint16_t*);

Top16Kernel top16_instance(bool canonical) {
  return canonical ? &kmer_top16<true> : &kmer_top16<false>;
}

}  // namespace

extern "C" {

// Every function below works on card `device` and returns a CUDA error
// code (0 = success); a launch returns cudaGetLastError() after it.

// Once per card: let both instances use all the shared memory a block may
// opt into, less their static shared memory (a large k).
int smt_top16_init(int device) {
  cudaError_t e = cudaSetDevice(device);
  int smem_max = 0;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  for (int c = 0; c < 2; ++c) {
    cudaFuncAttributes attr;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, top16_instance(c));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(top16_instance(c), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_max - (int)attr.sharedSizeBytes);
  }
  return (int)e;
}

// The tops of k-mers 0 .. n - k of the first n chars of `words` (nbytes
// bytes) into out (n - k + 1 16-bit words, 2-byte aligned). bytes_in: one
// char per byte (text bytes, or 2-bit codes without text), else the 2-bit
// byte stream; text: the tables hold 256 entries, else 4; antilex: no
// table. meta: null, or n on the card (meta[0], at most the n given here,
// which sizes the launch).
int smt_kmer_top16(int device, const void* words, long long nbytes, int n, int k, int canonical,
                   int bytes_in, int text, int antilex, const void* table, int rot,
                   const void* meta, void* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (k < 1 || n < k || (table == nullptr && !antilex) || (text && !bytes_in) ||
      out == nullptr || (reinterpret_cast<uintptr_t>(out) & 1))
    return (int)cudaErrorInvalidValue;
  const long long nk = (long long)n - k + 1;
  const int blocks = (int)((nk + KMERS - 1) / KMERS);
  const size_t smem = (size_t)table_offset(k) + 4 * (size_t)table_words(text, antilex);
  top16_instance(canonical != 0)<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)words, nbytes, n, k, bytes_in, text, antilex, (const long long*)table, rot,
      (const int*)meta, (uint16_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

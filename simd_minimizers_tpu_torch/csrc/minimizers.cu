// Minimizer positions, super-k-mers and syncmers of 2-bit packed DNA, of
// 2-bit codes one per byte, and of general text on Hopper (sm_90a).
//
// Replaces the one Pallas TPU kernel of the JAX package:
// simd_minimizers_tpu/ops/fused.py `_make_kernel.kernel`, launched through
// `_invoke_pallas` (stages B1-B4, B5 skip-ambiguous windows, the B6 keep
// mask of every mode, B7, B8 and the B9 super-k-mer index plane). The
// semantics are those of ops/oracle.py: top-16-bit hash comparison,
// leftmost (and, for the canonical right arm, rightmost) tie-breaks, strict
// majority strand rule on bit 1 of each char, SKIPPED for a window that
// holds an ambiguous char, adjacent dedup on the raw stream (SKIPPED
// included) with SKIPPED dropped after it, syncmer predicates without dedup.
//
// Three launches:
//   1. minimizer_tiles<CANONICAL, MODE, AMB>: one block per tile of TILE
//      windows. It reads the tile's chars (plus an l+3 char halo) straight
//      from the plain 2-bit byte stream, or one char per byte (`bytes_in`):
//      the raw bytes of text (`text`; the TPU's byte-striped `striped8`
//      input and the decode of `lane_matrix_from`) or 2-bit codes, of which
//      only the low two bits are read (the code bytes that the FASTA reader
//      and the batch engine produce, shipped without host packing), one
//      char per shared byte either way, and with AMB the ambiguity bits of
//      the same chars from a 1-bit plane; hashes
//      every k-mer with an O(1) rolling update per thread run, takes the
//      packed (top16 | column) sliding minima, the strand blend, the
//      SKIPPED mask and the keep mask of MODE (recomputing the sel of the
//      window before the tile for the dedup, so no state crosses blocks),
//      and left-packs the kept values with a popc + block scan: positions
//      (MINIMIZERS), positions and window indices (SUPERKMERS, two planes)
//      or window indices (SYNCMERS), each plus the launch's u32 `offset`
//      (the TPU kernel's offset bits: a span's first char in its sequence),
//      added after every comparison so that those stay launch-local. Plane
//      p of tile t goes to scratch[(p * ntiles + t) * TILE], the tile's
//      count to counts[t].
//      The hash (the TPU's `_hash_windows`) is one of two block-uniform
//      branches: nt and mul are one fold, XOR_i rotl(F[c_i], i + rot), over
//      per-char forward and complement values F and R that the host builds
//      (4 words each for 2-bit codes, 256 each for text bytes, in dynamic
//      shared memory behind the tile's other data); antilex (`antilex`) reads
//      no table and packs the low two bits of the first min(k, 16) chars with
//      a rolling shift on each strand.
//   2. tile_offsets: one block takes the exclusive scan of the counts and
//      writes the total behind them (the running total the TPU kept in SMEM).
//   3. tile_append: copies each tile's run of each plane to its global offset.
// Each has its own C entry point (and Python wrapper, ops/fused.py); the
// shared-memory limit of every minimizer_tiles instance is raised once per
// card (smt_init). All 12 strand x mode x ambiguity-plane instances are built
// (tiles_instance): super-k-mers with a plane are the batch engine's padding
// plane and the skip-ambiguous super-k-mers of backend.sketch. Input kind
// and hasher are kernel arguments, not template parameters, so they add no
// instance to the build. The instances do not add up in build time: nvcc
// optimises them in parallel (--split-compile, ops/_build.py).
//
// What bounds it on the H100: it reads 0.25 B/char of 2-bit input or 1
// B/char of code bytes or text (plus 0.125 B/char of ambiguity bits) and
// writes about 4 B per kept value twice (scratch, then output) plus 4 B
// reread, so at the density 2/(w+1) of random input it moves under 3 B/char
// per plane: far below the card's 3.35 TB/s. The work is integer ALU: per
// k-mer two table lookups in shared memory and a few funnel shifts (rolling
// hash, both strands; antilex: two shifts and an or per strand), per window
// 2w unsigned mins and a sliding T/G count. The function itself needs about
// 29 operations per window canonical and 14 forward at k=21 (chip_smoke.py's
// bound, with an O(1) sliding minimum); the w mins per arm are the main
// excess over it (ROADMAP A3, large w). The design keeps every
// intermediate in shared memory or registers, makes the hash O(1) per k-mer
// instead of O(k), and launches enough blocks (one per 4096 windows) to
// fill all SMs. An ambiguity plane costs a clean tile one block vote
// (__syncthreads_or, the counterpart of the TPU's per-block amb_any flags);
// only a tile with an ambiguous char in its span counts them per window, by
// popc for the first window of each thread and a sliding count after it.
// Unlike the TPU's text path, whose halo stops at l - 1 <= 1024, text takes
// any w the shared memory admits (ops/fused.fused_supported), as DNA does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 4096;               // windows per block
constexpr int THREADS = 256;             // threads per block
constexpr int WPT = TILE / THREADS;      // windows per thread
constexpr int SCAN_THREADS = 1024;
constexpr uint32_t INVALID = 0xFFFFFFFFu;
constexpr uint32_t SKIPPED = 0xFFFFFFFEu;
constexpr uint32_t TOP16 = 0xFFFF0000u;
constexpr int CODES = 4;         // per-char table entries of 2-bit input
constexpr int TEXT_CHARS = 256;  // per-char table entries of text (bytes)

// Modes of minimizer_tiles: what is kept and which planes are written.
constexpr int MINIMIZERS = 0;  // sel where it differs from the previous window's sel
constexpr int SUPERKMERS = 1;  // the same, plus the window index as a second plane
constexpr int SYNCMERS = 2;    // the window index gw where sel - gw is sync_lo or sync_hi

// Shared-memory layout of minimizer_tiles. Chars cover positions
// [t0 - 4, t0 + TILE + l - 1) of the tile starting at window t0, rounded up
// to whole packed bytes; k-mer keys cover k-mers t0 - 1 .. t0 + TILE + w - 2,
// and their space also stages the compacted planes (TILE words each); with
// AMB, ambiguity bits cover chars t0 - 32 .. in whole 32-bit words; the
// fold's forward and complement values of each char follow (2 * 4 words for
// 2-bit codes, 2 * 256 for text bytes, none for antilex).
__host__ __device__ inline int tile_chars(int l) { return (TILE + l + 3 + 3) / 4 * 4; }
__host__ __device__ inline int key_offset(int l) { return (tile_chars(l) + 15) / 16 * 16; }
__host__ __device__ inline int tile_kmers(int w) { return TILE + w; }
__host__ __device__ inline int key_words(int w, bool canonical, int mode) {
  const int keys = (canonical ? 2 : 1) * tile_kmers(w);
  const int staged = (mode == SUPERKMERS ? 2 : 1) * TILE;
  return keys > staged ? keys : staged;
}
__host__ __device__ inline int amb_words(int l) { return (TILE + l + 62) / 32; }
__host__ __device__ inline int table_words(bool text, bool antilex) {
  return antilex ? 0 : 2 * (text ? TEXT_CHARS : CODES);
}

inline size_t tile_smem_bytes(int k, int w, bool canonical, int mode, bool amb, bool text,
                              bool antilex) {
  const int l = k + w - 1;
  return (size_t)key_offset(l) + 4 * (size_t)key_words(w, canonical, mode) +
         (amb ? 4 * (size_t)amb_words(l) : 0) + 4 * (size_t)table_words(text, antilex);
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }
__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) { return __funnelshift_r(x, x, r); }

// Inclusive scan across a block; every thread gets its own prefix and the
// block total. warp_sums holds one int per warp.
template <int NTHREADS>
__device__ __forceinline__ int block_inclusive_scan(int x, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < NTHREADS / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < NTHREADS / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  *total = warp_sums[NTHREADS / 32 - 1];
  return x + (warp ? warp_sums[warp - 1] : 0);
}

template <bool CANONICAL, int MODE, bool AMB>
__global__ void __launch_bounds__(THREADS)
minimizer_tiles(const uint8_t* __restrict__ words, long long nbytes, int n, int k, int w,
                int bytes_in, int text, int antilex, const long long* __restrict__ table,
                int rot, const uint8_t* __restrict__ amb, long long amb_nbytes, int sync_lo,
                int sync_hi, uint32_t offset, int* __restrict__ scratch,
                int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[THREADS / 32];

  const int tid = threadIdx.x;
  const int l = k + w - 1;
  const long long nw = (long long)n - l + 1;
  const long long t0 = (long long)blockIdx.x * TILE;  // first window of the tile
  const int nchars = tile_chars(l);
  const int nk = tile_kmers(w);
  uint8_t* s_c = smem;                                 // s_c[s] = code of char t0 - 4 + s
  uint32_t* s_kl = reinterpret_cast<uint32_t*>(smem + key_offset(l));  // s_kl[j]: k-mer t0 - 1 + j
  uint32_t* s_kr = s_kl + nk;
  uint32_t* s_amb = s_kl + key_words(w, CANONICAL, MODE);  // bit b: char t0 - 32 + b
  // the fold's per-char values: forward tF[c], complement tR[c]
  uint32_t* tF = s_amb + (AMB ? amb_words(l) : 0);
  uint32_t* tR = tF + (text ? TEXT_CHARS : CODES);
  for (int i = tid; i < table_words(text, antilex); i += THREADS) tF[i] = (uint32_t)table[i];

  // B1: one char per shared byte. 2-bit input: decode whole packed bytes
  // (base i at bits 2 * (i % 4)), chars outside [0, nbytes * 4) reading as
  // 0. One char per byte: copy the bytes, four at a time where they are
  // aligned and in range, chars outside [0, nbytes) reading as 0, and keep
  // the low two bits of a code byte (its table has 4 entries). Such chars
  // only reach k-mers and windows masked below.
  if (bytes_in) {
    const long long g0 = t0 - 4;  // a multiple of 4
    const bool aligned = (reinterpret_cast<uintptr_t>(words) & 3) == 0;
    const uint32_t keep = text ? 0xFFFFFFFFu : 0x03030303u;
    for (int bi = tid; bi < nchars / 4; bi += THREADS) {
      const long long gb = g0 + 4LL * bi;
      uint32_t x = 0;
      if (aligned && gb >= 0 && gb + 4 <= nbytes) {
        x = __ldg(reinterpret_cast<const uint32_t*>(words + gb));
      } else {
        for (int j = 0; j < 4; ++j)
          if (gb + j >= 0 && gb + j < nbytes) x |= (uint32_t)words[gb + j] << (8 * j);
      }
      reinterpret_cast<uint32_t*>(s_c)[bi] = x & keep;
    }
  } else {
    const long long b0 = t0 / 4 - 1;
    for (int bi = tid; bi < nchars / 4; bi += THREADS) {
      const long long gb = b0 + bi;
      const uint32_t b = (gb >= 0 && gb < nbytes) ? words[gb] : 0u;
      reinterpret_cast<uint32_t*>(s_c)[bi] =
          (b & 3u) | ((b >> 2) & 3u) << 8 | ((b >> 4) & 3u) << 16 | ((b >> 6) & 3u) << 24;
    }
  }
  // B5 input: the ambiguity bits (base i at bit i % 8 of byte i / 8) of
  // chars t0 - 32 .., four bytes to a shared word, bytes outside the plane
  // reading as 0; and the block's vote on whether any is set.
  bool dirty = false;
  if (AMB) {
    const long long a0 = t0 / 8 - 4;
    uint32_t any = 0;
    for (int i = tid; i < amb_words(l); i += THREADS) {
      uint32_t x = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long gb = a0 + 4 * i + j;
        if (gb >= 0 && gb < amb_nbytes) x |= (uint32_t)amb[gb] << (8 * j);
      }
      s_amb[i] = x;
      any |= x;
    }
    dirty = __syncthreads_or(any != 0u);
  } else {
    __syncthreads();
  }

  // B2 + B3 keys: each thread hashes a contiguous run of k-mers, the first
  // in O(k) (O(min(k, 16)) for antilex), the rest by the rolling update.
  // Keys pack the top 16 hash bits with the column j (leftmost arm) or
  // 0xFFFF - j (rightmost arm); k-mers outside [0, n - k] get INVALID on
  // both arms. Column j's k-mer starts at s_c[j + 3].
  {
    const int per = (nk + THREADS - 1) / THREADS;
    const int j0 = tid * per;
    const int j1 = min(j0 + per, nk);
    auto put = [&](int j, uint32_t hash) {
      const long long kp = t0 - 1 + j;
      const bool ok = kp >= 0 && kp <= (long long)n - k;
      const uint32_t top = hash & TOP16;
      s_kl[j] = ok ? (top | (uint32_t)j) : INVALID;
      if (CANONICAL) s_kr[j] = ok ? (top | (0xFFFFu - (uint32_t)j)) : INVALID;
    };
    if (j0 < j1 && antilex) {
      // antilex: ~ of the first J = min(k, 16) chars & 3 packed MSB-first
      // (la); canonical XORs in the same of the reverse complement, i.e. of
      // the complemented last J chars, reversed (ra): ~la ^ ~ra = la ^ ra.
      // la shifts in the char at i + J - 1 at bit lo = 32 - 2J; ra shifts
      // right, takes the complement of the char at i + k - 1 at the top and
      // keeps its top 2J bits.
      const int J = min(k, 16), lo = 32 - 2 * J;
      const uint32_t topJ = ~((1u << lo) - 1u);
      uint32_t la = 0, ra = 0;
      for (int q = 0; q < J; ++q) {
        la |= (uint32_t)(s_c[j0 + 3 + q] & 3) << (30 - 2 * q);
        if (CANONICAL) ra |= (uint32_t)((s_c[j0 + 2 + k - q] & 3) ^ 2) << (30 - 2 * q);
      }
      for (int j = j0;;) {
        put(j, CANONICAL ? la ^ ra : ~la);
        if (++j >= j1) break;
        la = la << 2 | (uint32_t)(s_c[j + 2 + J] & 3) << lo;
        if (CANONICAL) ra = (ra >> 2 | (uint32_t)((s_c[j + 2 + k] & 3) ^ 2) << 30) & topJ;
      }
    } else if (j0 < j1) {
      // nt and mul: the forward hash XOR_i rotl(F[c_i], i + rot), the
      // reverse-complement one XOR_i rotl(R[c_i], k - 1 - i + rot).
      uint32_t h = 0, r = 0;
      for (int i = 0; i < k; ++i) {
        const int c = s_c[j0 + 3 + i];
        h ^= rotl(tF[c], i + rot);
        if (CANONICAL) r ^= rotl(tR[c], k - 1 - i + rot);
      }
      for (int j = j0;;) {
        put(j, CANONICAL ? h ^ r : h);
        if (++j >= j1) break;
        const int c_out = s_c[j + 2], c_in = s_c[j + 2 + k];
        h = rotr(h ^ rotl(tF[c_out], rot) ^ rotl(tF[c_in], k + rot), 1);
        if (CANONICAL)
          r = rotl(r ^ rotl(tR[c_out], k - 1 + rot) ^ rotl(tR[c_in], rot - 1), 1);
      }
    }
  }
  __syncthreads();

  // B3/B4/B5/B6: thread tid owns windows v = tid * WPT .. + WPT - 1
  // (tile-local) and first recomputes window v - 1, the dedup predecessor.
  // Window v covers k-mers j in [v + 1, v + w], chars s in [v + 4, v + 4 + l)
  // and ambiguity bits [v + 32, v + 32 + l).
  const uint32_t pos0 = (uint32_t)(t0 - 1);  // position of k-mer column 0 (wraps for tile 0)
  auto window_sel = [&](int v, int cnt, bool skipped) -> uint32_t {
    const long long wi = t0 + v;
    if (wi < 0 || wi >= nw) return INVALID;  // validity wins over SKIPPED, as on the TPU
    if (AMB && skipped) return SKIPPED;
    uint32_t ml = INVALID, mr = INVALID;
    for (int j = v + 1; j <= v + w; ++j) {
      ml = min(ml, s_kl[j]);
      if (CANONICAL) mr = min(mr, s_kr[j]);
    }
    const uint32_t lpos = pos0 + (ml & 0xFFFFu);
    if (!CANONICAL) return lpos;
    const uint32_t rpos = pos0 + (0xFFFFu - (mr & 0xFFFFu));
    return 2 * cnt > l ? lpos : rpos;
  };

  const int vp = tid * WPT - 1;
  // B5: bit q of `skip` is set where window vp + q holds an ambiguous base.
  unsigned skip = 0;
  if (AMB && dirty) {
    const int a = vp + 32, e = vp + 31 + l;  // first and last bit of window vp
    int cnt = 0;
    for (int i = a >> 5; i <= e >> 5; ++i) {
      uint32_t m = s_amb[i];
      if (i == a >> 5) m &= 0xFFFFFFFFu << (a & 31);
      if (i == e >> 5) m &= 0xFFFFFFFFu >> (31 - (e & 31));
      cnt += __popc(m);
    }
    skip = cnt > 0;
    auto bit = [&](int b) -> int { return (s_amb[b >> 5] >> (b & 31)) & 1; };
#pragma unroll
    for (int q = 1; q <= WPT; ++q) {
      cnt += bit(vp + q + 31 + l) - bit(vp + q + 31);
      skip |= (unsigned)(cnt > 0) << q;
    }
  }

  int cnt = 0;
  if (CANONICAL)
    for (int i = 0; i < l; ++i) cnt += (s_c[vp + 4 + i] >> 1) & 1;
  uint32_t prev = MODE == SYNCMERS ? INVALID : window_sel(vp, cnt, skip & 1u);
  uint32_t sel[WPT];
  unsigned keep = 0;
#pragma unroll
  for (int q = 0; q < WPT; ++q) {
    const int v = vp + 1 + q;
    if (CANONICAL) cnt += ((s_c[v + 3 + l] >> 1) & 1) - ((s_c[v + 3] >> 1) & 1);
    sel[q] = window_sel(v, cnt, (skip >> (q + 1)) & 1u);
    if (MODE == SYNCMERS) {
      // SKIPPED and INVALID never equal gw + sync_*: gw + w - 1 < n < 2^31
      // (values are launch-local here; `offset` is added at emission)
      const uint32_t gw = (uint32_t)(t0 + v);
      if (t0 + v < nw && (sel[q] == gw + sync_lo || sel[q] == gw + sync_hi)) keep |= 1u << q;
    } else {
      if (t0 + v < nw && sel[q] != prev && (!AMB || sel[q] != SKIPPED)) keep |= 1u << q;
      prev = sel[q];
    }
  }

  // B7 (+ B9): left-pack the kept values of the tile in window order, one
  // staging plane of TILE words each, each value plus `offset` (u32 bits in
  // an int). The first barrier of the scan also ends every read of the
  // keys, so the staging planes may reuse their space.
  const int mine = __popc(keep);
  int total;
  int at = block_inclusive_scan<THREADS>(mine, s_warp, &total) - mine;
  int* s_out = reinterpret_cast<int*>(s_kl);
  int* s_idx = s_out + TILE;  // SUPERKMERS: the window indices
#pragma unroll
  for (int q = 0; q < WPT; ++q)
    if ((keep >> q) & 1u) {
      const uint32_t gw = (uint32_t)(t0 + vp + 1 + q);
      s_out[at] = (int)((MODE == SYNCMERS ? gw : sel[q]) + offset);
      if (MODE == SUPERKMERS) s_idx[at] = (int)(gw + offset);
      ++at;
    }
  __syncthreads();
  int* dst = scratch + (long long)blockIdx.x * TILE;
  for (int i = tid; i < total; i += THREADS) dst[i] = s_out[i];
  if (MODE == SUPERKMERS) {
    int* dst_idx = dst + (long long)gridDim.x * TILE;
    for (int i = tid; i < total; i += THREADS) dst_idx[i] = s_idx[i];
  }
  if (tid == 0) counts[blockIdx.x] = total;
}

// B8, part 1: offsets[t] = sum of counts[0..t), offsets[ntiles] = total.
__global__ void __launch_bounds__(SCAN_THREADS)
tile_offsets(const int* __restrict__ counts, int ntiles, int* __restrict__ offsets) {
  __shared__ int s_warp[SCAN_THREADS / 32];
  const int per = (ntiles + SCAN_THREADS - 1) / SCAN_THREADS;
  const int a = min((int)threadIdx.x * per, ntiles), b = min(a + per, ntiles);
  int sum = 0;
  for (int i = a; i < b; ++i) sum += counts[i];
  int total;
  int run = block_inclusive_scan<SCAN_THREADS>(sum, s_warp, &total) - sum;
  for (int i = a; i < b; ++i) {
    offsets[i] = run;
    run += counts[i];
  }
  if (threadIdx.x == 0) offsets[ntiles] = total;
}

// B8, part 2: tile blockIdx.x's run of plane blockIdx.y to its global
// offset; plane p of the output starts at p * total.
__global__ void __launch_bounds__(THREADS)
tile_append(const int* __restrict__ scratch, const int* __restrict__ counts,
            const int* __restrict__ offsets, int* __restrict__ out) {
  const int c = counts[blockIdx.x];
  const int o = offsets[blockIdx.x];
  const long long total = offsets[gridDim.x];
  const int* src = scratch + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * TILE;
  int* dst = out + blockIdx.y * total + o;
  for (int i = threadIdx.x; i < c; i += THREADS) dst[i] = src[i];
}

using TilesKernel = void (*)(const uint8_t*, long long, int, int, int, int, int, int,
                             const long long*, int, const uint8_t*, long long, int, int,
                             uint32_t, int*, int*);

// The instances built; null for a mode that has none.
template <bool C>
TilesKernel tiles_instance(int mode, bool amb) {
  switch (mode) {
    case MINIMIZERS:
      return amb ? &minimizer_tiles<C, MINIMIZERS, true> : &minimizer_tiles<C, MINIMIZERS, false>;
    case SUPERKMERS:
      return amb ? &minimizer_tiles<C, SUPERKMERS, true> : &minimizer_tiles<C, SUPERKMERS, false>;
    case SYNCMERS:
      return amb ? &minimizer_tiles<C, SYNCMERS, true> : &minimizer_tiles<C, SYNCMERS, false>;
    default:
      return nullptr;
  }
}

TilesKernel tiles_instance(bool canonical, int mode, bool amb) {
  return canonical ? tiles_instance<true>(mode, amb) : tiles_instance<false>(mode, amb);
}

}  // namespace

extern "C" {

int smt_tile_windows() { return TILE; }

// Every function below works on card `device` and returns a CUDA error
// code (0 = success); a launch returns cudaGetLastError() after it.

// Once per card: let every minimizer_tiles instance use all the shared
// memory a block may opt into, less its static shared memory.
int smt_init(int device) {
  cudaError_t e = cudaSetDevice(device);
  int smem_max = 0;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  for (int c = 0; c < 2; ++c)
    for (int mode = MINIMIZERS; mode <= SYNCMERS; ++mode)
      for (int amb = 0; amb < 2; ++amb) {
        const TilesKernel kern = tiles_instance(c, mode, amb);
        if (kern == nullptr) continue;
        cudaFuncAttributes attr;
        if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kern);
        if (e == cudaSuccess)
          e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_max - (int)attr.sharedSizeBytes);
      }
  return (int)e;
}

// mode: 0 minimizers, 1 super-k-mers, 2 syncmers (kept where sel - gw is
// sync_lo or sync_hi). bytes_in: one char per byte (text bytes, or 2-bit
// codes without text), else the 2-bit byte stream; text: the tables hold
// 256 entries, else 4. amb: the 1-bit ambiguity plane of amb_nbytes bytes,
// or null for none. offset: added (mod 2^32) to every emitted value.
// scratch holds ntiles * TILE ints per plane (two for super-k-mers).
int smt_minimizer_tiles(int device, const void* words, long long nbytes, int n, int k, int w,
                        int canonical, int mode, int bytes_in, int text, int antilex,
                        const void* table, int rot, const void* amb, long long amb_nbytes,
                        int sync_lo, int sync_hi, unsigned int offset, void* scratch,
                        void* counts, int ntiles, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const TilesKernel kern = tiles_instance(canonical != 0, mode, amb != nullptr);
  if (kern == nullptr || (table == nullptr && !antilex) || (text && !bytes_in))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      tile_smem_bytes(k, w, canonical != 0, mode, amb != nullptr, text != 0, antilex != 0);
  kern<<<ntiles, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)words, nbytes, n, k, w, bytes_in, text, antilex,
      (const long long*)table, rot, (const uint8_t*)amb, amb_nbytes, sync_lo, sync_hi,
      (uint32_t)offset, (int*)scratch, (int*)counts);
  return (int)cudaGetLastError();
}

int smt_tile_offsets(int device, const void* counts, int ntiles, void* offsets, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  tile_offsets<<<1, SCAN_THREADS, 0, (cudaStream_t)stream>>>((const int*)counts, ntiles,
                                                             (int*)offsets);
  return (int)cudaGetLastError();
}

// planes: 1, or 2 for super-k-mers; out holds planes * total ints.
int smt_tile_append(int device, const void* scratch, const void* counts, const void* offsets,
                    int ntiles, int planes, void* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  tile_append<<<dim3(ntiles, planes), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)scratch, (const int*)counts, (const int*)offsets, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

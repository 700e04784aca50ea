// Minimizer positions, super-k-mers and syncmers of 2-bit packed DNA on
// Hopper (sm_90a).
//
// Replaces the one Pallas TPU kernel of the JAX package:
// simd_minimizers_tpu/ops/fused.py `_make_kernel.kernel`, launched through
// `_invoke_pallas` (stages B1-B4, B5 skip-ambiguous windows, the B6 keep
// mask of every mode, B7, B8 and the B9 super-k-mer index plane, for the nt
// hasher). The semantics are those of ops/oracle.py: top-16-bit hash
// comparison, leftmost (and, for the canonical right arm, rightmost)
// tie-breaks, strict T/G majority strand rule, SKIPPED for a window that
// holds an ambiguous base, adjacent dedup on the raw stream (SKIPPED
// included) with SKIPPED dropped after it, syncmer predicates without dedup.
//
// Three launches:
//   1. minimizer_tiles<CANONICAL, MODE, AMB>: one block per tile of TILE
//      windows. It reads the tile's chars (plus an l+3 char halo) straight
//      from the plain 2-bit byte stream, and with AMB the ambiguity bits of
//      the same chars from a 1-bit plane; hashes every k-mer with an O(1)
//      rolling update per thread run, takes the packed (top16 | column)
//      sliding minima, the strand blend, the SKIPPED mask and the keep mask
//      of MODE (recomputing the sel of the window before the tile for the
//      dedup, so no state crosses blocks), and left-packs the kept values
//      with a popc + block scan: positions (MINIMIZERS), positions and
//      window indices (SUPERKMERS, two planes) or window indices
//      (SYNCMERS). Plane p of tile t goes to scratch[(p * ntiles + t) *
//      TILE], the tile's count to counts[t].
//   2. tile_offsets: one block takes the exclusive scan of the counts and
//      writes the total behind them (the running total the TPU kept in SMEM).
//   3. tile_append: copies each tile's run of each plane to its global offset.
// Each has its own C entry point (and Python wrapper, ops/fused.py); the
// shared-memory limit of every minimizer_tiles instance is raised once per
// card (smt_init). Only the instances the Python side can reach are built
// (tiles_instance): super-k-mers never carry an ambiguity plane (the
// reference cannot express it), so no SUPERKMERS instance has AMB. The
// instances do not add up in build time: nvcc optimises them in parallel
// (--split-compile, ops/_build.py).
//
// What bounds it on the H100: it reads 0.25 B/bp (plus 0.125 B/bp of
// ambiguity bits) and writes about 4 B per kept value twice (scratch, then
// output) plus 4 B reread, so at the density 2/(w+1) of random DNA it moves
// under 2 B/bp per plane: far below the card's 3.35 TB/s. The work is
// integer ALU: per k-mer two table lookups and a few funnel shifts (rolling
// hash, both strands), per window 2w unsigned mins and a sliding T/G count.
// The design keeps every intermediate in shared memory or registers, makes
// the hash O(1) per k-mer instead of O(k), and launches enough blocks (one
// per 4096 windows) to fill all SMs. An ambiguity plane costs a clean tile
// one block vote (__syncthreads_or, the counterpart of the TPU's per-block
// amb_any flags); only a tile with an ambiguous base in its span counts
// them per window, by popc for the first window of each thread and a
// sliding count after it.

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

// Modes of minimizer_tiles: what is kept and which planes are written.
constexpr int MINIMIZERS = 0;  // sel where it differs from the previous window's sel
constexpr int SUPERKMERS = 1;  // the same, plus the window index as a second plane
constexpr int SYNCMERS = 2;    // the window index gw where sel - gw is sync_lo or sync_hi

// Shared-memory layout of minimizer_tiles. Chars cover positions
// [t0 - 4, t0 + TILE + l - 1) of the tile starting at window t0, rounded up
// to whole packed bytes; k-mer keys cover k-mers t0 - 1 .. t0 + TILE + w - 2,
// and their space also stages the compacted planes (TILE words each); with
// AMB, ambiguity bits cover chars t0 - 32 .. in whole 32-bit words.
__host__ __device__ inline int tile_chars(int l) { return (TILE + l + 3 + 3) / 4 * 4; }
__host__ __device__ inline int key_offset(int l) { return (tile_chars(l) + 15) / 16 * 16; }
__host__ __device__ inline int tile_kmers(int w) { return TILE + w; }
__host__ __device__ inline int key_words(int w, bool canonical, int mode) {
  const int keys = (canonical ? 2 : 1) * tile_kmers(w);
  const int staged = (mode == SUPERKMERS ? 2 : 1) * TILE;
  return keys > staged ? keys : staged;
}
__host__ __device__ inline int amb_words(int l) { return (TILE + l + 62) / 32; }

inline size_t tile_smem_bytes(int k, int w, bool canonical, int mode, bool amb) {
  const int l = k + w - 1;
  return (size_t)key_offset(l) + 4 * (size_t)key_words(w, canonical, mode) +
         (amb ? 4 * (size_t)amb_words(l) : 0);
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
                const long long* __restrict__ table, int rot, const uint8_t* __restrict__ amb,
                long long amb_nbytes, int sync_lo, int sync_hi, int* __restrict__ scratch,
                int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t s_tab[4];
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

  if (tid < 4) s_tab[tid] = (uint32_t)table[tid];

  // B1: decode whole packed bytes (base i at bits 2 * (i % 4)) into one
  // code per shared byte. Chars outside [0, nbytes * 4) read as 0; they only
  // reach k-mers and windows masked below.
  const long long b0 = t0 / 4 - 1;
  for (int bi = tid; bi < nchars / 4; bi += THREADS) {
    const long long gb = b0 + bi;
    const uint32_t b = (gb >= 0 && gb < nbytes) ? words[gb] : 0u;
    reinterpret_cast<uint32_t*>(s_c)[bi] =
        (b & 3u) | ((b >> 2) & 3u) << 8 | ((b >> 4) & 3u) << 16 | ((b >> 6) & 3u) << 24;
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
  // in O(k), the rest by the rolling update. The forward hash is
  // XOR_i rotl(T[c_i], i + rot), the reverse-complement one
  // XOR_i rotl(T[c_i ^ 2], k - 1 - i + rot). Keys pack the top 16 hash bits
  // with the column j (leftmost arm) or 0xFFFF - j (rightmost arm); k-mers
  // outside [0, n - k] get INVALID on both arms.
  {
    const int per = (nk + THREADS - 1) / THREADS;
    const int j0 = tid * per;
    const int j1 = min(j0 + per, nk);
    if (j0 < j1) {
      uint32_t h = 0, r = 0;
      for (int i = 0; i < k; ++i) {
        const int c = s_c[j0 + 3 + i];
        h ^= rotl(s_tab[c], i + rot);
        if (CANONICAL) r ^= rotl(s_tab[c ^ 2], k - 1 - i + rot);
      }
      for (int j = j0;;) {
        const long long kp = t0 - 1 + j;
        const bool ok = kp >= 0 && kp <= (long long)n - k;
        const uint32_t top = (CANONICAL ? h ^ r : h) & TOP16;
        s_kl[j] = ok ? (top | (uint32_t)j) : INVALID;
        if (CANONICAL) s_kr[j] = ok ? (top | (0xFFFFu - (uint32_t)j)) : INVALID;
        if (++j >= j1) break;
        const int c_out = s_c[j + 2], c_in = s_c[j + 2 + k];
        h = rotr(h ^ rotl(s_tab[c_out], rot) ^ rotl(s_tab[c_in], k + rot), 1);
        if (CANONICAL)
          r = rotl(r ^ rotl(s_tab[c_out ^ 2], k - 1 + rot) ^ rotl(s_tab[c_in ^ 2], rot - 1), 1);
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
      const uint32_t gw = (uint32_t)(t0 + v);
      if (t0 + v < nw && (sel[q] == gw + sync_lo || sel[q] == gw + sync_hi)) keep |= 1u << q;
    } else {
      if (t0 + v < nw && sel[q] != prev && (!AMB || sel[q] != SKIPPED)) keep |= 1u << q;
      prev = sel[q];
    }
  }

  // B7 (+ B9): left-pack the kept values of the tile in window order, one
  // staging plane of TILE words each. The first barrier of the scan also
  // ends every read of the keys, so the staging planes may reuse their
  // space.
  const int mine = __popc(keep);
  int total;
  int at = block_inclusive_scan<THREADS>(mine, s_warp, &total) - mine;
  int* s_out = reinterpret_cast<int*>(s_kl);
  int* s_idx = s_out + TILE;  // SUPERKMERS: the window indices
#pragma unroll
  for (int q = 0; q < WPT; ++q)
    if ((keep >> q) & 1u) {
      const int gw = (int)(t0 + vp + 1 + q);
      s_out[at] = MODE == SYNCMERS ? gw : (int)sel[q];
      if (MODE == SUPERKMERS) s_idx[at] = gw;
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

using TilesKernel = void (*)(const uint8_t*, long long, int, int, int, const long long*, int,
                             const uint8_t*, long long, int, int, int*, int*);

// The instances built; null for a combination that has none.
template <bool C>
TilesKernel tiles_instance(int mode, bool amb) {
  switch (mode) {
    case MINIMIZERS:
      return amb ? &minimizer_tiles<C, MINIMIZERS, true> : &minimizer_tiles<C, MINIMIZERS, false>;
    case SUPERKMERS:
      return amb ? nullptr : &minimizer_tiles<C, SUPERKMERS, false>;
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
// sync_lo or sync_hi). amb: the 1-bit ambiguity plane of amb_nbytes bytes,
// or null for none. scratch holds ntiles * TILE ints per plane (two for
// super-k-mers).
int smt_minimizer_tiles(int device, const void* words, long long nbytes, int n, int k, int w,
                        int canonical, int mode, const void* table, int rot, const void* amb,
                        long long amb_nbytes, int sync_lo, int sync_hi, void* scratch,
                        void* counts, int ntiles, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const TilesKernel kern = tiles_instance(canonical != 0, mode, amb != nullptr);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = tile_smem_bytes(k, w, canonical != 0, mode, amb != nullptr);
  kern<<<ntiles, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)words, nbytes, n, k, w, (const long long*)table, rot, (const uint8_t*)amb,
      amb_nbytes, sync_lo, sync_hi, (int*)scratch, (int*)counts);
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

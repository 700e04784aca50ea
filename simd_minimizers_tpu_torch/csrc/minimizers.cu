// Minimizer positions of 2-bit packed DNA on Hopper (sm_90a).
//
// Replaces the one Pallas TPU kernel of the JAX package:
// simd_minimizers_tpu/ops/fused.py `_make_kernel.kernel`, launched through
// `_invoke_pallas` (stages B1-B4, the B6 validity + dedup mask, B7 and B8,
// for the nt hasher in minimizer mode). The semantics are those of
// ops/oracle.py: top-16-bit hash comparison, leftmost (and, for the
// canonical right arm, rightmost) tie-breaks, strict T/G majority strand
// rule, adjacent dedup.
//
// Three launches:
//   1. minimizer_tiles<CANONICAL>: one block per tile of TILE windows. It
//      reads the tile's chars (plus an l+3 char halo) straight from the
//      plain 2-bit byte stream, hashes every k-mer with an O(1) rolling
//      update per thread run, takes the packed (top16 | column) sliding
//      minima, the strand blend and the dedup mask (recomputing the sel of
//      the window before the tile, so no state crosses blocks), and
//      left-packs the kept positions with a popc + block scan. Kept
//      positions go to scratch[tile * TILE], their count to counts[tile].
//   2. tile_offsets: one block takes the exclusive scan of the counts and
//      writes the total behind them (the running total the TPU kept in SMEM).
//   3. tile_append: copies each tile's run to its global offset.
// Each has its own C entry point (and Python wrapper, ops/fused.py); the
// shared-memory limit of minimizer_tiles is raised once per card (smt_init).
//
// What bounds it on the H100: it reads 0.25 B/bp and writes about 4 B per
// kept position twice (scratch, then output) plus 4 B reread, so at the
// density 2/(w+1) of random DNA it moves under 2 B/bp: far below the card's
// 3.35 TB/s. The work is integer ALU: per k-mer two table lookups and a
// few funnel shifts (rolling hash, both strands), per window 2w unsigned
// mins and a sliding T/G count. The design keeps every intermediate in
// shared memory or registers, makes the hash O(1) per k-mer instead of
// O(k), and launches enough blocks (one per 4096 windows) to fill all SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 4096;               // windows per block
constexpr int THREADS = 256;             // threads per block
constexpr int WPT = TILE / THREADS;      // windows per thread
constexpr int SCAN_THREADS = 1024;
constexpr uint32_t INVALID = 0xFFFFFFFFu;
constexpr uint32_t TOP16 = 0xFFFF0000u;

// Shared-memory layout of minimizer_tiles. Chars cover positions
// [t0 - 4, t0 + TILE + l - 1) of the tile starting at window t0, rounded up
// to whole packed bytes; k-mer keys cover k-mers t0 - 1 .. t0 + TILE + w - 2.
__host__ __device__ inline int tile_chars(int l) { return (TILE + l + 3 + 3) / 4 * 4; }
__host__ __device__ inline int key_offset(int l) { return (tile_chars(l) + 15) / 16 * 16; }
__host__ __device__ inline int tile_kmers(int w) { return TILE + w; }

inline size_t tile_smem_bytes(int k, int w, bool canonical) {
  const int l = k + w - 1;
  return (size_t)key_offset(l) + (canonical ? 2 : 1) * (size_t)tile_kmers(w) * 4;
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

template <bool CANONICAL>
__global__ void __launch_bounds__(THREADS)
minimizer_tiles(const uint8_t* __restrict__ words, long long nbytes, int n, int k, int w,
                const long long* __restrict__ table, int rot, int* __restrict__ scratch,
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
  __syncthreads();

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

  // B3/B4/B6: thread tid owns windows v = tid * WPT .. + WPT - 1 (tile-local)
  // and first recomputes window v - 1, the dedup predecessor. Window v
  // covers k-mers j in [v + 1, v + w] and chars s in [v + 4, v + 4 + l).
  const uint32_t pos0 = (uint32_t)(t0 - 1);  // position of k-mer column 0 (wraps for tile 0)
  auto window_sel = [&](int v, int cnt) -> uint32_t {
    const long long wi = t0 + v;
    if (wi < 0 || wi >= nw) return INVALID;
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
  int cnt = 0;
  if (CANONICAL)
    for (int i = 0; i < l; ++i) cnt += (s_c[vp + 4 + i] >> 1) & 1;
  uint32_t prev = window_sel(vp, cnt);
  uint32_t sel[WPT];
  unsigned keep = 0;
#pragma unroll
  for (int q = 0; q < WPT; ++q) {
    const int v = vp + 1 + q;
    if (CANONICAL) cnt += ((s_c[v + 3 + l] >> 1) & 1) - ((s_c[v + 3] >> 1) & 1);
    sel[q] = window_sel(v, cnt);
    if (t0 + v < nw && sel[q] != prev) keep |= 1u << q;
    prev = sel[q];
  }

  // B7: left-pack the kept positions of the tile in window order. The
  // first barrier of the scan also ends every read of the keys, so the
  // staging buffer may reuse their space.
  const int mine = __popc(keep);
  int total;
  int at = block_inclusive_scan<THREADS>(mine, s_warp, &total) - mine;
  int* s_out = reinterpret_cast<int*>(s_kl);
#pragma unroll
  for (int q = 0; q < WPT; ++q)
    if ((keep >> q) & 1u) s_out[at++] = (int)sel[q];
  __syncthreads();
  int* dst = scratch + (long long)blockIdx.x * TILE;
  for (int i = tid; i < total; i += THREADS) dst[i] = s_out[i];
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

// B8, part 2: each tile's packed run to its global offset.
__global__ void __launch_bounds__(THREADS)
tile_append(const int* __restrict__ scratch, const int* __restrict__ counts,
            const int* __restrict__ offsets, int* __restrict__ out) {
  const int c = counts[blockIdx.x];
  const int o = offsets[blockIdx.x];
  const int* src = scratch + (long long)blockIdx.x * TILE;
  for (int i = threadIdx.x; i < c; i += THREADS) out[o + i] = src[i];
}

}  // namespace

extern "C" {

int smt_tile_windows() { return TILE; }

// Every function below works on card `device` and returns a CUDA error
// code (0 = success); a launch returns cudaGetLastError() after it.

// Once per card: let both minimizer_tiles instances use all the shared
// memory a block may opt into, less their static shared memory.
int smt_init(int device) {
  cudaError_t e = cudaSetDevice(device);
  int smem_max = 0;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  for (auto kern : {&minimizer_tiles<true>, &minimizer_tiles<false>}) {
    cudaFuncAttributes attr;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kern);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_max - (int)attr.sharedSizeBytes);
  }
  return (int)e;
}

int smt_minimizer_tiles(int device, const void* words, long long nbytes, int n, int k, int w,
                        int canonical, const void* table, int rot, void* scratch, void* counts,
                        int ntiles, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = tile_smem_bytes(k, w, canonical != 0);
  auto kern = canonical ? &minimizer_tiles<true> : &minimizer_tiles<false>;
  kern<<<ntiles, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)words, nbytes, n, k, w, (const long long*)table, rot, (int*)scratch,
      (int*)counts);
  return (int)cudaGetLastError();
}

int smt_tile_offsets(int device, const void* counts, int ntiles, void* offsets, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  tile_offsets<<<1, SCAN_THREADS, 0, (cudaStream_t)stream>>>((const int*)counts, ntiles,
                                                             (int*)offsets);
  return (int)cudaGetLastError();
}

int smt_tile_append(int device, const void* scratch, const void* counts, const void* offsets,
                    int ntiles, void* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  tile_append<<<ntiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)scratch, (const int*)counts, (const int*)offsets, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// Three launches (four on the large-w route, kmer_top16 first):
//   1. minimizer_tiles<CANONICAL, MODE, AMB>: one block per tile of TILE
//      windows. It reads the tile's chars (plus an l+3 char halo; on the
//      large-w route only their T/G bits, canonical) straight
//      from the plain 2-bit byte stream, or one char per byte (`bytes_in`):
//      the raw bytes of text (`text`; the TPU's byte-striped `striped8`
//      input and the decode of `lane_matrix_from`) or 2-bit codes, of which
//      only the low two bits are read (the code bytes that the FASTA reader
//      and the batch engine produce, shipped without host packing), one
//      char per shared byte either way, and with AMB the ambiguity bits of
//      the same chars from a 1-bit plane; hashes
//      every k-mer with an O(1) rolling update per thread run (on the
//      large-w route it reads kmer_top16's 16-bit tops instead), takes the
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
//   2. tile_offsets: one block per SCAN_BLOCK counts takes the exclusive
//      scan of the counts in a single pass (a decoupled look-back) and
//      writes the total behind them (the running total the TPU kept in SMEM).
//   3. tile_append: copies each tile's run of each plane to its global offset
//      (a persistent grid of warps; see below).
// Each has its own C entry point (and Python wrapper, ops/fused.py); the
// shared-memory limit of every minimizer_tiles instance is raised once per
// card (smt_init). All 12 strand x mode x ambiguity-plane instances are built
// (tiles_instance): super-k-mers with a plane are the batch engine's padding
// plane and the skip-ambiguous super-k-mers of backend.sketch. Input kind
// and hasher are kernel arguments, not template parameters, so they add no
// instance to the build. The instances do not add up in build time: nvcc
// optimises them in parallel (--split-compile, ops/_build.py).
//
// What bounds minimizer_tiles on the H100: it reads 0.25 B/char of 2-bit
// input or 1 B/char of code bytes or text (plus 0.125 B/char of ambiguity
// bits) and writes about 4 B per kept value twice (scratch, then output)
// plus 4 B reread, so at the density 2/(w+1) of random input it moves under
// 3 B/char per plane: far below the card's 3.35 TB/s. The work is integer
// ALU and shared memory: per k-mer a table lookup of the char pair (2-bit
// input; two lookups and funnel shifts for text) and a funnel shift
// (rolling hash, both strands; antilex: two shifts and an or per strand;
// on the large-w route one 16-bit load of kmer_top16's array instead),
// per window a sliding minimum per arm and a sliding T/G count. The function
// itself needs about 29 operations per window canonical and 14 forward at
// k=21 (chip_smoke.py's bound, with an O(1) sliding minimum). The design
// keeps every intermediate in shared memory or registers, makes the hash
// O(1) per k-mer instead of O(k), and launches enough blocks (one per 4096
// windows) to fill all SMs. An ambiguity plane costs a clean tile one block
// vote (__syncthreads_or, the counterpart of the TPU's per-block amb_any
// flags); only a tile with an ambiguous char in its span counts them per
// window, by popc for the first window of each thread and a sliding count
// after it, from 16 bits of the plane in a register. Unlike the TPU's text
// path, whose halo stops at l - 1 <= 1024, text takes any w the shared
// memory admits (ops/fused.fused_supported), as DNA does.
//
// Two routes for the sliding minimum, chosen per launch by the block-uniform
// `sub_tile` (ops/fused.sub_tile):
// - The stored route (sub_tile 0) keeps the keys of the tile's TILE + w
//   k-mers in shared memory. Thread t owns the 16 contiguous windows from
//   16t, so with keys at their column, the 32 lanes of a warp that read
//   column 16t + c for one c hit two of the 32 banks: every key load was a
//   16-way bank conflict, and with w of them per window and arm it was the
//   kernel's cost (3.80 / 1.38 ms per 1e8 chars canonical / forward at
//   w = 11 before; PERF.md). Keys now sit at kidx(j) = j ^ ((j >> 5) & 15),
//   a permutation within each 32-word row: the 16-column stride of the
//   window reads and the consecutive columns of the passes below both fall
//   in distinct banks (the hash stores, at the run stride TILE / THREADS + 1,
//   take about two wavefronts). Then `passes` doubling passes turn column
//   j's key into the least key of columns [j, j + p), p = 2^passes: the
//   first two in registers as the hash runs produce the keys (a run keeps
//   its last four), the others one column per thread at a time (read both
//   into registers, barrier, write); a window takes ceil(w / p) loads per
//   arm: m[v + 1], m[v + 1 + p], ..., m[v + w - p + 1], overlapping where
//   p does not divide w (min is idempotent, and the column in the low 16
//   bits already breaks ties). So
//   a window costs O(log w) accesses instead of w, each conflict-free;
//   ops/fused.min_passes picks the count from the card's measurements. The
//   strand count reads 16 T/G bits a thread from a bit plane built from the
//   chars (bit 1 of each) instead of 32 byte loads at a 16-byte stride (a
//   4-way conflict), and the first window's count is a popc over it.
// - The large-w route (sub_tile T, a power of two <= min(w, TILE)) keeps
//   two blocks of T keys per arm and one least key per window, so its
//   shared memory does not grow with w in keys: every w with TILE + w <=
//   2^16 (the 16-bit column) fits. It hashes nothing: the pre-pass
//   kmer_top16 (csrc/top16.cu, launched first by ops/fused.minimizer_tiles)
//   writes the top 16 hash bits of every k-mer of the launch once, and the
//   route reads the w + T of them that each block of T windows covers, as
//   coalesced 16-byte loads of eight tops (consecutive threads on
//   consecutive columns; the resident tiles' columns stay in L2), and
//   packs each into the (top16 | column) key of its arm, INVALID where the
//   column's k-mer lies outside [0, n - k]. It takes three mins per window
//   (a suffix of block 0, the core's least key, a prefix of block 1), and
//   counts the first window of each thread by a block scan instead of O(l)
//   per thread; it reads no table and keeps no chars. Three things set its
//   pace on the H100, and the design answers each: the blocks' scans
//   (block_min_scans: a run per thread at a padded index, so that no
//   access conflicts, where a run at the plain index is a 16-way conflict,
//   and two barriers for all four arrays); a byte per char in shared
//   memory, which would hold a canonical tile at w = 32,767 to one block
//   per SM for the strand count alone (it reads the T/G bit plane of the
//   stored route instead, an eighth of the bytes, built from the input's
//   words; forward instances load no chars); and latency, which more
//   blocks per SM hide (ops/fused.tiles_occupancy: 2 canonical at
//   w = 32,767, 3 forward at w = 61,439 with a mask, 4 forward at 32,767).
//
// tile_offsets is bound by latency, not by bytes: at 1e8 chars it scans
// 24,415 counts (98 KB, 0.06 us of the card's bandwidth both ways), and one
// block of threads keeps too few loads in flight to hide their latency. So
// the scan is one pass over many blocks: each block loads 1024 counts as
// int4 (4 a thread, coalesced), sums them with a warp-shuffle block scan,
// publishes its sum and looks back over its predecessors' published sums
// and prefixes, 32 at a time with one warp (the decoupled look-back of a
// single-pass scan), then writes its offsets as int4. A block takes its
// place in the scan from an atomic ticket, so it waits only on blocks that
// have started (none on a block that other kernels keep off the SMs), and
// the last block to finish zeroes the status words: a launch needs no
// memset, eager or in a CUDA graph, and the card keeps one set of words
// (ops/fused.tile_offsets).
//
// tile_append moves 8 B per kept value and plane (the run read once,
// written once): 0.040 ms at 1e8 chars canonical, w = 11. A block per tile
// and plane would spend more on its three dependent loads and on block
// turnover than on the copy: 24,415 blocks (48,830 with two planes) of 256
// threads that copy about 683 ints canonical, 372 for open syncmers. So a
// persistent grid (the SMs times the blocks an SM holds, from the occupancy
// query; ops/fused.append_grid) of warps walks the tiles, warp g of G
// taking tiles g, g + G, ...: its lanes load the counts and offsets of its
// next 32 tiles with one load each, and a tile's run (16-byte aligned in
// the scratch) is read 16 bytes a lane, six loads a lane in flight before
// any store, so that a warp takes a typical run (683 ints canonical) in one
// round trip: a short sequence's one or two tiles wait on no second one
// (four loads took 2% longer on the short replay; PERF.md). The
// destination offset is any int, and the stores stay four bytes: stores
// realigned to 16 bytes by a warp shuffle take as long on the H100. What
// is left is the card's rate for reads and writes mixed: torch's own
// device copy of as many bytes takes 0.90-0.97 of the time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 4096;               // windows per block
constexpr int THREADS = 256;             // threads per block
constexpr int WPT = TILE / THREADS;      // windows per thread
constexpr int SCAN_THREADS = 256;
constexpr int APPEND_THREADS = 256;
constexpr int APPEND_WARPS = APPEND_THREADS / 32;  // tiles a block of tile_append copies at once
constexpr int APPEND_UNROLL = 6;  // 16-byte loads a lane keeps in flight
constexpr int SCAN_VECS = 1;                              // int4 loads per thread
constexpr int SCAN_BLOCK = 4 * SCAN_VECS * SCAN_THREADS;  // counts per block of tile_offsets
constexpr unsigned long long SCAN_AGG = 1ull << 32;  // status: the block's sum in the low word
constexpr unsigned long long SCAN_PRE = 2ull << 32;  // status: counts up to the block's end
constexpr int PASS_COLS = 17;  // columns a thread holds per pass group: 17 * THREADS > TILE + 255
constexpr uint32_t INVALID = 0xFFFFFFFFu;
constexpr uint32_t SKIPPED = 0xFFFFFFFEu;
constexpr uint32_t TOP16 = 0xFFFF0000u;
constexpr int CODES = 4;         // per-char table entries of 2-bit input
constexpr int TEXT_CHARS = 256;  // per-char table entries of text (bytes)

// Modes of minimizer_tiles: what is kept and which planes are written.
constexpr int MINIMIZERS = 0;  // sel where it differs from the previous window's sel
constexpr int SUPERKMERS = 1;  // the same, plus the window index as a second plane
constexpr int SYNCMERS = 2;    // the window index gw where sel - gw is sync_lo or sync_hi

// Shared-memory layout of minimizer_tiles. On the stored route, chars
// cover positions [t0 - 4, t0 + TILE + l - 1) of the tile starting at
// window t0, rounded up to whole packed bytes (the large-w route keeps no
// chars); then the key space, which also stages the compacted planes (TILE
// words each); with AMB, ambiguity bits cover chars t0 - 32 .. in whole
// 32-bit words; canonical, the T/G bit (bit 1) of each char of the tile,
// bit b of word i for char t0 - 4 + 32 i + b; on the stored route the
// fold's forward and complement values of each char follow (2 * 4 words
// for 2-bit codes, 2 * 256 for text bytes, none for antilex).
// The key space of the stored route (sub_tile 0): the keys of k-mers
// t0 - 1 .. t0 + TILE + w - 2 (columns 0 .. TILE + w - 1), per arm, at
// kidx(column) in an array of whole 32-word rows. Of the large-w route
// (sub_tile T, a power of two <= w and <= TILE): per arm the minimum key of
// each of the TILE + 1 windows, then two blocks of scan_words(T): T keys at
// sidx (one pad word after each thread's run of the scan), then the scan's
// THREADS / 32 warp totals.
__host__ __device__ inline int tile_chars(int l) { return (TILE + l + 3 + 3) / 4 * 4; }
__host__ __device__ inline int key_offset(int l, int sub_tile) {
  return sub_tile ? 0 : (tile_chars(l) + 15) / 16 * 16;
}
__host__ __device__ inline int tile_kmers(int w) { return TILE + w; }
__host__ __device__ inline int stored_arm_words(int w) { return (tile_kmers(w) + 31) / 32 * 32; }
__host__ __device__ inline int scan_words(int sub_tile) {
  return sub_tile + (sub_tile > THREADS ? THREADS : 0) + THREADS / 32;
}
__host__ __device__ inline int key_words(int w, bool canonical, int mode, int sub_tile) {
  const int per_arm = sub_tile ? TILE + 1 + 2 * scan_words(sub_tile) : stored_arm_words(w);
  const int keys = (canonical ? 2 : 1) * per_arm;
  const int staged = (mode == SUPERKMERS ? 2 : 1) * TILE;
  return keys > staged ? keys : staged;
}
__host__ __device__ inline int amb_words(int l) { return (TILE + l + 62) / 32; }
__host__ __device__ inline int tg_words(int l, bool canonical) {
  return canonical ? (tile_chars(l) + 31) / 32 : 0;
}
__host__ __device__ inline int table_words(bool text, bool antilex, int sub_tile) {
  return antilex || sub_tile ? 0 : 2 * (text ? TEXT_CHARS : CODES);
}

inline size_t tile_smem_bytes(int k, int w, bool canonical, int mode, bool amb, bool text,
                              bool antilex, int sub_tile) {
  const int l = k + w - 1;
  return (size_t)key_offset(l, sub_tile) + 4 * (size_t)key_words(w, canonical, mode, sub_tile) +
         (amb ? 4 * (size_t)amb_words(l) : 0) + 4 * (size_t)tg_words(l, canonical) +
         4 * (size_t)table_words(text, antilex, sub_tile);
}

// The stored route's index of column j: its low four bits XOR its 32-word
// row, so that 32 lanes reading columns 16 t + c (one c) or 32 consecutive
// columns from a multiple of 32 hit 32 distinct banks.
__device__ __forceinline__ int kidx(int j) { return j ^ ((j >> 5) & 15); }

// The set bits of plane word i within bits [a, e], and of all of [a, e].
__device__ __forceinline__ int word_bits(const uint32_t* plane, int a, int e, int i) {
  uint32_t m = plane[i];
  if (i == a >> 5) m &= 0xFFFFFFFFu << (a & 31);
  if (i == e >> 5) m &= 0xFFFFFFFFu >> (31 - (e & 31));
  return __popc(m);
}
__device__ __forceinline__ int count_bits(const uint32_t* plane, int a, int e) {
  int cnt = 0;
  for (int i = a >> 5; i <= e >> 5; ++i) cnt += word_bits(plane, a, e, i);
  return cnt;
}

// Bits b .. b + 15 of a plane, bit q for bit b + q; reads no word past the
// one that holds bit b + 15.
__device__ __forceinline__ uint32_t bits16(const uint32_t* plane, int b) {
  const int i = b >> 5, s = b & 31;
  uint32_t x = plane[i] >> s;
  if (s > 16) x |= plane[i + 1] << (32 - s);
  return x & 0xFFFFu;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }
__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) { return __funnelshift_r(x, x, r); }

// Bytes gb .. gb + 3 (gb a multiple of 4) of the nbytes at p as a
// little-endian word, one load where p is 4-byte aligned (`aligned`) and all
// four lie in [0, nbytes); bytes outside it read as 0.
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ p, long long nbytes,
                                              long long gb, bool aligned) {
  if (aligned && gb >= 0 && gb + 4 <= nbytes)
    return __ldg(reinterpret_cast<const uint32_t*>(p + gb));
  uint32_t x = 0;
  for (int j = 0; j < 4; ++j)
    if (gb + j >= 0 && gb + j < nbytes) x |= (uint32_t)p[gb + j] << (8 * j);
  return x;
}

// The odd bits of x (bit 2 j + 1 to bit j): the T/G bits of 16 packed chars.
__device__ __forceinline__ uint32_t odd_bits(uint32_t x) {
  x = (x >> 1) & 0x55555555u;
  x = (x | x >> 1) & 0x33333333u;
  x = (x | x >> 2) & 0x0F0F0F0Fu;
  x = (x | x >> 4) & 0x00FF00FFu;
  return (x | x >> 8) & 0xFFFFu;
}

// Bit 1 of each of the 4 bytes of x, gathered to bits 0 .. 3 by a multiply
// (bits 0, 8, 16, 24 of y land on 24 .. 27, the cross terms below 20).
__device__ __forceinline__ uint32_t byte_tg4(uint32_t x) {
  return (((x >> 1) & 0x01010101u) * 0x01020408u) >> 24;
}

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

// The least of x over the block, in every thread. warp_buf holds one word
// per warp; the first barrier keeps it from a previous use.
__device__ __forceinline__ uint32_t block_min(uint32_t x, int* warp_buf) {
#pragma unroll
  for (int d = 16; d; d >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, d));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) warp_buf[threadIdx.x >> 5] = (int)x;
  __syncthreads();
  x = INVALID;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) x = min(x, (uint32_t)warp_buf[i]);
  return x;
}

// The large-w route's index of key p of a block of T keys: one pad word
// after each thread's run of T / THREADS keys in block_min_scans (sh =
// log2 of the run; 31, no pad, where T <= THREADS and a run is one key).
__device__ __forceinline__ int sidx(int p, int sh) { return p + (p >> sh); }

// In place, NA arrays of m keys (m a power of two <= TILE), array x at
// a + stride x, key p at sidx(p, sh), with its THREADS / 32 warp totals in
// its last words: an even x gets its suffix minima (a[p] = min(a[p..m))),
// an odd x its prefix minima (min(a[0..p])). Thread t scans the run r in
// [t per, (t + 1) per) of each array (per = m / THREADS, or 1; r counts
// from the end for a suffix), a warp-shuffle scan combines the runs of a
// warp, and after one barrier each thread takes the least of the warps
// before it. Conflict-free by construction: the pad puts run t at index
// t (per + 1) (or t (per + 1) counted down from the end), and per + 1 is
// odd, so the 32 lanes of a warp, each at word r of its run, hit 32
// distinct banks; where per = 1 they touch 32 consecutive words; a warp
// total is written by one lane and read as a broadcast. Two barriers for
// all NA arrays; the caller's barriers end the stores that fill them.
template <int NA>
__device__ __forceinline__ void block_min_scans(uint32_t* a, int stride, int m, int sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (m + THREADS - 1) / THREADS;
  const int r0 = min((int)threadIdx.x * per, m), r1 = min(r0 + per, m);
  uint32_t before[NA];
#pragma unroll
  for (int x = 0; x < NA; ++x) {
    uint32_t* ax = a + x * stride;
    uint32_t run = INVALID;
    for (int r = r0; r < r1; ++r) {
      const int i = sidx(x & 1 ? r : m - 1 - r, sh);
      run = min(run, ax[i]);
      ax[i] = run;
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {  // inclusive min over the warp's runs
      const uint32_t y = __shfl_up_sync(0xffffffffu, run, d);
      if (lane >= d) run = min(run, y);
    }
    before[x] = __shfl_up_sync(0xffffffffu, run, 1);
    if (lane == 0) before[x] = INVALID;
    if (lane == 31) ax[stride - THREADS / 32 + warp] = run;
  }
  __syncthreads();
#pragma unroll
  for (int x = 0; x < NA; ++x) {
    uint32_t* ax = a + x * stride;
    for (int i = 0; i < warp; ++i) before[x] = min(before[x], ax[stride - THREADS / 32 + i]);
    for (int r = r0; r < r1; ++r) {
      const int i = sidx(x & 1 ? r : m - 1 - r, sh);
      ax[i] = min(ax[i], before[x]);
    }
  }
  __syncthreads();
}

// Launch bounds: canonical instances at most 64 registers a thread (4
// blocks per SM), forward at most 51 (5), the stored route's occupancy at
// w = 11 (37.7 / 20.7 KB of shared memory a block). Without the canonical
// bound ptxas gives those instances 72-80 registers for the large-w route's
// code (3 blocks per SM, and the canonical w = 11 paths 6% slower on an
// H100); forward instances take 46-48 without a bound (66-68 with a bound
// of 1 block). At 64 the masked canonical super-k-mer and syncmer instances
// spill 4 B.
template <bool CANONICAL, int MODE, bool AMB>
__global__ void __launch_bounds__(THREADS, CANONICAL ? 4 : 5)
minimizer_tiles(const uint8_t* __restrict__ words, long long nbytes, int n_arg, int k, int w,
                int bytes_in, int text, int antilex, const long long* __restrict__ table,
                int rot, const uint8_t* __restrict__ amb, long long amb_nbytes, int sync_lo,
                int sync_hi, uint32_t offset_arg, const int* __restrict__ meta, int sub_tile,
                int passes, const uint16_t* __restrict__ top16, int* __restrict__ scratch,
                int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[THREADS / 32];

  const int tid = threadIdx.x;
  // a launch captured in a CUDA graph reads its length and offset from the
  // card (meta: n, offset bits), so that one capture serves every length
  const int n = meta ? meta[0] : n_arg;
  const uint32_t offset = meta ? (uint32_t)meta[1] : offset_arg;
  const int l = k + w - 1;
  const long long nw = (long long)n - l + 1;
  const long long t0 = (long long)blockIdx.x * TILE;  // first window of the tile
  // tile-local bounds, so that the per-column and per-window tests stay in
  // 32 bits: column j holds a k-mer (k-mer t0 - 1 + j in [0, n - k]) iff
  // j_lo <= j <= j_hi; window v (window t0 + v in [0, nw)) iff v_lo <= v < v_hi
  const int j_lo = t0 == 0 ? 1 : 0;
  const int j_hi = (int)max(-1LL, min((long long)TILE + w, (long long)n - k + 1 - t0));
  const int v_lo = t0 == 0 ? 0 : -1;
  const int v_hi = (int)max(-1LL, min((long long)TILE, nw - t0));
  const int nchars = tile_chars(l);
  const int nk = tile_kmers(w);
  const int T = sub_tile;  // 0: the stored route; else the large-w route's block of columns
  uint8_t* s_c = smem;  // stored route: s_c[s] = code of char t0 - 4 + s
  // stored route: s_kl[kidx(j)] is the key of k-mer t0 - 1 + j (column j);
  // large-w route: s_kl[a] is the least key of window a - 1 (columns a ..
  // a + w - 1)
  uint32_t* s_kl = reinterpret_cast<uint32_t*>(smem + key_offset(l, T));
  uint32_t* s_kr = s_kl + (T ? TILE + 1 : stored_arm_words(w));
  uint32_t* s_amb = s_kl + key_words(w, CANONICAL, MODE, T);  // bit b: char t0 - 32 + b
  uint32_t* s_tg = s_amb + (AMB ? amb_words(l) : 0);  // bit s: bit 1 of char t0 - 4 + s
  // stored route: the fold's per-char values, forward tF[c], complement tR[c]
  uint32_t* tF = s_tg + tg_words(l, CANONICAL);
  uint32_t* tR = tF + (text ? TEXT_CHARS : CODES);
  for (int i = tid; i < table_words(text, antilex, T); i += THREADS) tF[i] = (uint32_t)table[i];
  // 2-bit input: the rolling step's value of each (outgoing, incoming)
  // char pair, both rotated, per strand (`hash_cols`)
  __shared__ uint32_t s_roll[2][CODES * CODES];
  if (!T && !text && !antilex && tid < CODES * CODES) {
    const int a = tid / CODES, b = tid % CODES;
    s_roll[0][tid] = rotl((uint32_t)table[a], rot) ^ rotl((uint32_t)table[b], k + rot);
    s_roll[1][tid] = rotl((uint32_t)table[CODES + a], k - 1 + rot) ^
                     rotl((uint32_t)table[CODES + b], rot - 1);
  }

  // B1, stored route: one char per shared byte. 2-bit input: decode whole
  // packed bytes (base i at bits 2 * (i % 4)), chars outside [0, nbytes * 4)
  // reading as 0. One char per byte: copy the bytes, four at a time where
  // they are aligned and in range, chars outside [0, nbytes) reading as 0,
  // and keep the low two bits of a code byte (its table has 4 entries). Such
  // chars only reach k-mers and windows masked below.
  // Large-w route: no chars in shared memory; canonical builds the T/G plane
  // (bit s: bit 1 of char t0 - 4 + s, chars outside the input reading as 0)
  // from the input's 32-bit words, word i from chars t0 - 4 + 32 i ..: of
  // 2-bit input the odd bits of 16 packed chars a load (word a of the input
  // holds chars 16 a .., and t0 is a multiple of 16: three loads); of bytes
  // bit 1 of each, gathered by a multiply (eight loads).
  const bool words_aligned = (reinterpret_cast<uintptr_t>(words) & 3) == 0;
  auto word_at = [&](long long gb) { return load_word(words, nbytes, gb, words_aligned); };
  if (T) {
    if (CANONICAL)
      for (int i = tid; i < tg_words(l, true); i += THREADS) {
        uint32_t x = 0;
        if (bytes_in) {
          const long long g = t0 - 4 + 32LL * i;
          if (words_aligned && g >= 0 && g + 32 <= nbytes) {  // eight loads in flight
            const uint32_t* p = reinterpret_cast<const uint32_t*>(words + g);
#pragma unroll
            for (int q = 0; q < 8; ++q) x |= byte_tg4(__ldg(p + q)) << (4 * q);
          } else {  // the input's ends, or unaligned: rolled (see the launch bounds)
#pragma unroll 1
            for (int q = 0; q < 8; ++q) x |= byte_tg4(word_at(g + 4 * q)) << (4 * q);
          }
        } else {
          const long long a = t0 / 16 + 2LL * i;  // chars 16 a - 4 .. 16 a + 27
          x = odd_bits(word_at(4 * (a - 1))) >> 12 | odd_bits(word_at(4 * a)) << 4 |
              odd_bits(word_at(4 * (a + 1))) << 20;
        }
        s_tg[i] = x;
      }
  } else if (bytes_in) {
    const long long g0 = t0 - 4;  // a multiple of 4
    const uint32_t keep = text ? 0xFFFFFFFFu : 0x03030303u;
    for (int bi = tid; bi < nchars / 4; bi += THREADS)
      reinterpret_cast<uint32_t*>(s_c)[bi] = word_at(g0 + 4LL * bi) & keep;
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

  // B2 + B3 keys of the stored route: each thread hashes a contiguous run
  // of k-mers, the first in O(k) (O(min(k, 16)) for antilex), the rest by
  // the rolling update (with `pairs`, one lookup of s_roll per strand and
  // step), and hands each hash to put(column, hash). Keys pack the top 16 hash bits
  // with the column j (leftmost arm) or 0xFFFF - j (rightmost arm); k-mers
  // outside [0, n - k] get INVALID on both arms. Column j's k-mer starts at
  // s_c[j + 3].
  auto hash_cols = [&](int j0, int j1, bool pairs, auto&& put) {
    if (j0 >= j1) return;
    if (antilex) {
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
    } else {
      // nt and mul: the forward hash XOR_i rotl(F[c_i], i + rot), the
      // reverse-complement one XOR_i rotl(R[c_i], k - 1 - i + rot).
      uint32_t h = 0, r = 0;
      for (int i = 0; i < k; ++i) {
        const int c = s_c[j0 + 3 + i];
        h ^= rotl(tF[c], i + rot);
        if (CANONICAL) r ^= rotl(tR[c], k - 1 - i + rot);
      }
      // the rolling step XORs in both chars' rotated values: with `pairs`
      // (2-bit chars) one lookup of s_roll at 4 c_out + c_in, else two of
      // each table
      for (int j = j0;;) {
        put(j, CANONICAL ? h ^ r : h);
        if (++j >= j1) break;
        const int c_out = s_c[j + 2], c_in = s_c[j + 2 + k];
        if (pairs) {
          h = rotr(h ^ s_roll[0][4 * c_out + c_in], 1);
          if (CANONICAL) r = rotl(r ^ s_roll[1][4 * c_out + c_in], 1);
        } else {
          h = rotr(h ^ rotl(tF[c_out], rot) ^ rotl(tF[c_in], k + rot), 1);
          if (CANONICAL)
            r = rotl(r ^ rotl(tR[c_out], k - 1 + rot) ^ rotl(tR[c_in], rot - 1), 1);
        }
      }
    }
  };
  auto key_l = [&](int j, uint32_t hash) -> uint32_t {
    return j >= j_lo && j <= j_hi ? (hash & TOP16) | (uint32_t)j : INVALID;
  };
  auto key_r = [&](int j, uint32_t hash) -> uint32_t {
    return j >= j_lo && j <= j_hi ? (hash & TOP16) | (0xFFFFu - (uint32_t)j) : INVALID;
  };

  if (!T) {
    // stored route: the keys of all TILE + w columns, the first rp =
    // min(passes, 2) doubling passes taken in registers as they are hashed:
    // a run keeps its last four keys (k*0 of column j, k*1 of j - 1, ...)
    // and stores the least of the pr = 2^rp ending at j for column
    // j - pr + 1, hashing pr - 1 columns past its own so that its last
    // columns get theirs. Then (canonical) the T/G plane: word i from the
    // 32 chars of s_c words 8i .. 8i + 7 (byte_tg4).
    const int per = (nk + THREADS - 1) / THREADS;
    const int j0 = tid * per;
    const int rp = min(passes, 2), pr = 1 << rp;
    uint32_t kl0 = INVALID, kl1 = INVALID, kl2 = INVALID, kl3 = INVALID;
    uint32_t kr0 = INVALID, kr1 = INVALID, kr2 = INVALID, kr3 = INVALID;
    hash_cols(j0, min(j0 + per + pr - 1, nk), !text, [&](int j, uint32_t hash) {
      kl3 = kl2, kl2 = kl1, kl1 = kl0, kl0 = key_l(j, hash);
      if (CANONICAL) kr3 = kr2, kr2 = kr1, kr1 = kr0, kr0 = key_r(j, hash);
      const int c = j - pr + 1;
      if (c < j0) return;
      s_kl[kidx(c)] = rp == 0 ? kl0 : rp == 1 ? min(kl0, kl1) : min(min(kl0, kl1), min(kl2, kl3));
      if (CANONICAL)
        s_kr[kidx(c)] =
            rp == 0 ? kr0 : rp == 1 ? min(kr0, kr1) : min(min(kr0, kr1), min(kr2, kr3));
    });
    if (CANONICAL) {
      const uint32_t* c4 = reinterpret_cast<const uint32_t*>(s_c);
      for (int i = tid; i < tg_words(l, true); i += THREADS) {
        uint32_t x = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (8 * i + q < nchars / 4) x |= byte_tg4(c4[8 * i + q]) << (4 * q);
        s_tg[i] = x;
      }
    }
    __syncthreads();
    // the other doubling passes: after pass i, column j holds the least key
    // of columns [j, j + 2^(i+1)) for every j <= nk - 2^(i+1) (the columns
    // past it, which no window reads, hold anything). Each group of PASS_COLS *
    // THREADS columns reads its pairs into registers, then writes after a
    // barrier; a later group neither reads nor writes the columns that an
    // earlier one wrote, so one barrier per group and one per pass suffice.
    for (int i = rp; i < passes; ++i) {
      const int d = 1 << i;
      for (int g0 = 0; g0 + d < nk; g0 += PASS_COLS * THREADS) {
        uint32_t al[PASS_COLS], ar[PASS_COLS];
#pragma unroll
        for (int r = 0; r < PASS_COLS; ++r) {
          const int j = g0 + r * THREADS + tid;
          if (j + d < nk) {
            al[r] = min(s_kl[kidx(j)], s_kl[kidx(j + d)]);
            if (CANONICAL) ar[r] = min(s_kr[kidx(j)], s_kr[kidx(j + d)]);
          }
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < PASS_COLS; ++r) {
          const int j = g0 + r * THREADS + tid;
          if (j + d < nk) {
            s_kl[kidx(j)] = al[r];
            if (CANONICAL) s_kr[kidx(j)] = ar[r];
          }
        }
      }
      __syncthreads();
    }
  } else {
    // large-w route (Gil-Werman / van Herk with a core): the windows a - 1
    // for a in [c0, c0 + T] all cover the core columns [c0 + T, c0 + w).
    // Window a - 1 covers columns [a, a + w - 1] = the suffix from a of
    // block 0 ([c0, c0 + T)), the core, and the first a - c0 columns of
    // block 1 ([c0 + w, c0 + w + T)). The blocks' keys are stored and
    // scanned, the core's are reduced and never stored: per block of T
    // windows w + T tops read from kmer_top16's array, and three mins per
    // window. Column j's top is top16[t0 - 1 + j] (the launch's k-mer
    // index; the u32 offset is added at emission only). A thread reads the
    // tops of 8 columns from a k-mer index that is a multiple of 8 (t0 is
    // one, so from a column j = 1 mod 8) as one 16-byte load, consecutive
    // threads on consecutive columns. Block keys sit at sidx (the scan's
    // padded index), in arrays of scan_words(T) words.
    const int S = scan_words(T);
    const int sh = T > THREADS ? __ffs(T / THREADS) - 1 : 31;
    uint32_t* b0l = s_kl + (CANONICAL ? 2 : 1) * (TILE + 1);
    uint32_t* b1l = b0l + S;
    uint32_t* b0r = b1l + S;
    uint32_t* b1r = b0r + S;
    const uint16_t* tops = top16 + t0;  // tops[j - 1] = top16[t0 - 1 + j]: column j's top
    const bool aligned = (reinterpret_cast<uintptr_t>(top16) & 15) == 0;
    // the tops of columns jp .. jp + 7, two to a word (column jp + q in half
    // q & 1 of word q / 2), 0 for a column whose k-mer lies outside [0, n - k]
    auto load8 = [&](int jp) -> uint4 {
      if (aligned && jp >= j_lo && jp + 7 <= j_hi)
        return __ldg(reinterpret_cast<const uint4*>(tops + jp - 1));
      uint32_t x[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (jp + q >= j_lo && jp + q <= j_hi)
          x[q / 2] |= (uint32_t)tops[jp + q - 1] << (q & 1 ? 16 : 0);
      return make_uint4(x[0], x[1], x[2], x[3]);
    };
    for (int c0 = 0; c0 < TILE; c0 += T) {
      const int end = c0 + w + T;  // columns [c0, end)
      uint32_t cl = INVALID, cr = INVALID;
      // the keys of columns jp .. jp + 7: all of them in the core and live,
      // only mins; else each to its block or the core, INVALID where the
      // column's k-mer lies outside [0, n - k]
      auto put8 = [&](int jp, uint4 v) {
        auto top_of = [&](int q) -> uint32_t {  // column jp + q's top in bits 16..31
          const uint32_t x = q < 4 ? (q < 2 ? v.x : v.y) : (q < 6 ? v.z : v.w);
          return q & 1 ? x & TOP16 : x << 16;
        };
        if (jp - c0 >= T && jp + 7 - c0 < w && jp >= j_lo && jp + 7 <= j_hi) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const uint32_t top = top_of(q);
            cl = min(cl, top | (uint32_t)(jp + q));
            if (CANONICAL) cr = min(cr, top | (0xFFFFu - (uint32_t)(jp + q)));
          }
          return;
        }
        // not unrolled: unrolled, the masked instances took 77 registers instead of
        // 64 (canonical) and their w = 11 paths ran up to 8% slower on an H100
#pragma unroll 1
        for (int q = 0; q < 8; ++q) {
          const int j = jp + q, r = j - c0;
          if (r < 0 || r >= w + T) continue;
          const bool live = j >= j_lo && j <= j_hi;
          const uint32_t top = top_of(q);
          const uint32_t kl = live ? top | (uint32_t)j : INVALID;
          const uint32_t kr = CANONICAL && live ? top | (0xFFFFu - (uint32_t)j) : INVALID;
          if (r < T) {
            b0l[sidx(r, sh)] = kl;
            if (CANONICAL) b0r[sidx(r, sh)] = kr;
          } else if (r < w) {
            cl = min(cl, kl);
            if (CANONICAL) cr = min(cr, kr);
          } else {
            b1l[sidx(r - w, sh)] = kl;
            if (CANONICAL) b1r[sidx(r - w, sh)] = kr;
          }
        }
      };
      const int js = c0 - ((c0 - 1) & 7);  // the column = 1 mod 8 at or just before c0
      for (int jp = js + 8 * tid; jp < end; jp += 8 * THREADS) put8(jp, load8(jp));
      cl = block_min(cl, s_warp);  // its barriers also end the block stores
      if (CANONICAL) cr = block_min(cr, s_warp);
      block_min_scans<CANONICAL ? 4 : 2>(b0l, S, T, sh);  // suffixes of b0*, prefixes of b1*
      for (int i = tid; i <= T; i += THREADS) {
        s_kl[c0 + i] = min(min(i < T ? b0l[sidx(i, sh)] : INVALID, cl),
                           i ? b1l[sidx(i - 1, sh)] : INVALID);
        if (CANONICAL)
          s_kr[c0 + i] = min(min(i < T ? b0r[sidx(i, sh)] : INVALID, cr),
                             i ? b1r[sidx(i - 1, sh)] : INVALID);
      }
      __syncthreads();
    }
  }

  // B3/B4/B5/B6: thread tid owns windows v = tid * WPT .. + WPT - 1
  // (tile-local) and first recomputes window v - 1, the dedup predecessor.
  // Window v covers k-mers j in [v + 1, v + w], chars s in [v + 4, v + 4 + l)
  // and ambiguity bits [v + 32, v + 32 + l).
  const uint32_t pos0 = (uint32_t)(t0 - 1);  // position of k-mer column 0 (wraps for tile 0)
  const int p = 1 << passes;                 // stored route: columns per pass-reduced key
  auto window_sel = [&](int v, int cnt, bool skipped) -> uint32_t {
    if (v < v_lo || v >= v_hi) return INVALID;  // validity wins over SKIPPED, as on the TPU
    if (AMB && skipped) return SKIPPED;
    uint32_t ml, mr = INVALID;
    if (T) {
      ml = s_kl[v + 1];
      if (CANONICAL) mr = s_kr[v + 1];
    } else {
      // columns [v + 1, v + w] as blocks of p from v + 1, the last one ending
      // at v + w (it overlaps the one before where p does not divide w)
      const int last = v + w - p + 1;
      ml = s_kl[kidx(last)];
      if (CANONICAL) mr = s_kr[kidx(last)];
      for (int j = v + 1; j < last; j += p) {
        ml = min(ml, s_kl[kidx(j)]);
        if (CANONICAL) mr = min(mr, s_kr[kidx(j)]);
      }
    }
    const uint32_t lpos = pos0 + (ml & 0xFFFFu);
    if (!CANONICAL) return lpos;
    const uint32_t rpos = pos0 + (0xFFFFu - (mr & 0xFFFFu));
    return 2 * cnt > l ? lpos : rpos;
  };
  // The large-w route's count for window vp of every thread, in O(l /
  // THREADS + WPT) each: window -1's count (`part` summed over the block)
  // plus the slides `step` of the threads before (an exclusive block scan).
  auto first_count = [&](int part, int step) -> int {
    int base;
    __syncthreads();
    block_inclusive_scan<THREADS>(part, s_warp, &base);
    __syncthreads();
    int total;
    const int before = block_inclusive_scan<THREADS>(step, s_warp, &total) - step;
    __syncthreads();
    return base + before;
  };

  const int vp = tid * WPT - 1;
  // B5: bit q of `skip` is set where window vp + q holds an ambiguous base.
  // Window vp + q (q = 1 .. WPT) gains bit vp + 31 + l + q of the plane and
  // loses bit vp + 31 + q: bit q - 1 of `in` and of `out`.
  unsigned skip = 0;
  if (AMB && dirty) {
    const uint32_t in = bits16(s_amb, vp + 32 + l), out = bits16(s_amb, vp + 32);
    int cnt;
    if (T) {
      int part = 0;  // window -1's bits [31, 30 + l], a word a thread
      for (int i = (31 >> 5) + tid; i <= (30 + l) >> 5; i += THREADS)
        part += word_bits(s_amb, 31, 30 + l, i);
      cnt = first_count(part, __popc(in) - __popc(out));
    } else {
      cnt = count_bits(s_amb, vp + 32, vp + 31 + l);  // the bits of window vp
    }
    skip = cnt > 0;
#pragma unroll
    for (int q = 1; q <= WPT; ++q) {
      cnt += (int)((in >> (q - 1)) & 1u) - (int)((out >> (q - 1)) & 1u);
      skip |= (unsigned)(cnt > 0) << q;
    }
  }

  // the strand count: window vp + 1 + q gains char vp + 4 + l + q of the
  // T/G plane and loses char vp + 4 + q, bit q of tg_in and of tg_out
  int cnt = 0;
  uint32_t tg_in = 0, tg_out = 0;
  if (CANONICAL) {
    tg_in = bits16(s_tg, vp + 4 + l);
    tg_out = bits16(s_tg, vp + 4);
    if (T) {
      int part = 0;  // window -1's chars [3, 2 + l], a word a thread
      for (int i = tid; i <= (2 + l) >> 5; i += THREADS) part += word_bits(s_tg, 3, 2 + l, i);
      cnt = first_count(part, __popc(tg_in) - __popc(tg_out));
    } else {
      cnt = count_bits(s_tg, vp + 4, vp + 3 + l);
    }
  }
  uint32_t prev = MODE == SYNCMERS ? INVALID : window_sel(vp, cnt, skip & 1u);
  uint32_t sel[WPT];
  unsigned keep = 0;
#pragma unroll
  for (int q = 0; q < WPT; ++q) {
    const int v = vp + 1 + q;
    if (CANONICAL) cnt += (int)((tg_in >> q) & 1u) - (int)((tg_out >> q) & 1u);
    sel[q] = window_sel(v, cnt, (skip >> (q + 1)) & 1u);
    if (MODE == SYNCMERS) {
      // SKIPPED and INVALID never equal gw + sync_*: gw + w - 1 < n < 2^31
      // (values are launch-local here; `offset` is added at emission)
      const uint32_t gw = (uint32_t)(t0 + v);
      if (v < v_hi && (sel[q] == gw + sync_lo || sel[q] == gw + sync_hi)) keep |= 1u << q;
    } else {
      if (v < v_hi && sel[q] != prev && (!AMB || sel[q] != SKIPPED)) keep |= 1u << q;
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
// status: a ticket counter, a finished-block counter, then one word per
// block, all zero at the start of a launch and again at its end. A block
// takes its index b from the ticket counter (so every block before b has
// started, whatever order the card starts blocks in and whatever else runs
// beside them) and scans counts [b SCAN_BLOCK, (b + 1) SCAN_BLOCK): thread
// x loads its 4 as an int4 (scalar loads and stores where a pointer is not
// 16-byte aligned or the counts end), the block sums them and publishes
// its sum in its word (SCAN_AGG); then its first warp looks back over the
// 32 blocks before it at once (a lane each), waits until each has
// published, and adds the sums up to the nearest block that has published
// its inclusive prefix (SCAN_PRE), 32 blocks further back if none has; it
// publishes its own prefix and the block writes its offsets. The last block
// to finish zeroes the status for the next launch.
__global__ void __launch_bounds__(SCAN_THREADS)
tile_offsets(const int* __restrict__ counts, int ntiles, int* __restrict__ offsets,
             unsigned long long* status) {
  __shared__ int s_warp[SCAN_THREADS / 32];
  __shared__ int s_b, s_before;
  __shared__ bool s_last;
  if (threadIdx.x == 0) s_b = (int)atomicAdd(status, 1ull);
  __syncthreads();
  const int b = s_b;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(counts) | reinterpret_cast<uintptr_t>(offsets)) & 15) == 0;
  const int base = b * SCAN_BLOCK + 4 * SCAN_VECS * (int)threadIdx.x;
  int4 x[SCAN_VECS];
#pragma unroll
  for (int u = 0; u < SCAN_VECS; ++u) {
    const int i = base + 4 * u;
    if (vec && i + 3 < ntiles) {
      x[u] = __ldg(reinterpret_cast<const int4*>(counts + i));
    } else {
      x[u].x = i < ntiles ? counts[i] : 0;
      x[u].y = i + 1 < ntiles ? counts[i + 1] : 0;
      x[u].z = i + 2 < ntiles ? counts[i + 2] : 0;
      x[u].w = i + 3 < ntiles ? counts[i + 3] : 0;
    }
  }
  int sum = 0;
#pragma unroll
  for (int u = 0; u < SCAN_VECS; ++u) sum += x[u].x + x[u].y + x[u].z + x[u].w;
  int total;
  const int incl = block_inclusive_scan<SCAN_THREADS>(sum, s_warp, &total);
  if (threadIdx.x < 32) {
    volatile unsigned long long* st = status + 2;
    const int lane = threadIdx.x;
    int before = 0;
    if (b == 0) {
      if (lane == 0) st[0] = SCAN_PRE | (uint32_t)total;
    } else {
      if (lane == 0) st[b] = SCAN_AGG | (uint32_t)total;
      for (int end = b - 1;; end -= 32) {
        const int j = end - lane;
        unsigned long long v = SCAN_PRE;  // before block 0: a prefix of 0
        if (j >= 0) {
          do {
            v = st[j];
          } while (v == 0);
        }
        const unsigned pre = __ballot_sync(0xFFFFFFFFu, (v & SCAN_PRE) != 0);
        const int first = __ffs(pre) - 1;  // the nearest block with a prefix, or -1
        int add = first < 0 || lane <= first ? (int)(uint32_t)v : 0;
#pragma unroll
        for (int d = 16; d; d >>= 1) add += __shfl_xor_sync(0xFFFFFFFFu, add, d);
        before += add;
        if (first >= 0) break;
      }
      if (lane == 0) st[b] = SCAN_PRE | (uint32_t)(before + total);
    }
    if (lane == 0) {
      s_before = before;
      if (b == (int)gridDim.x - 1) offsets[ntiles] = before + total;
    }
  }
  __syncthreads();
  int run = s_before + incl - sum;
#pragma unroll
  for (int u = 0; u < SCAN_VECS; ++u) {
    const int i = base + 4 * u;
    const int4 o = make_int4(run, run + x[u].x, run + x[u].x + x[u].y,
                             run + x[u].x + x[u].y + x[u].z);
    run = o.w + x[u].w;
    if (vec && i + 3 < ntiles) {
      *reinterpret_cast<int4*>(offsets + i) = o;
    } else {
      if (i < ntiles) offsets[i] = o.x;
      if (i + 1 < ntiles) offsets[i + 1] = o.y;
      if (i + 2 < ntiles) offsets[i + 2] = o.z;
      if (i + 3 < ntiles) offsets[i + 3] = o.w;
    }
  }
  // every read and write of the status by this block is done (the barrier
  // after the look-back); the fence orders its word before the count
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(status + 1, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    for (int i = threadIdx.x; i < (int)gridDim.x + 2; i += SCAN_THREADS) status[i] = 0;
  }
}

// B8, part 2: each tile's run of each plane to its global offset; plane p
// of the output starts at p * total, total = offsets[ntiles] (read on the
// card, so that a CUDA-graph capture need not know it). See the header for
// the design: a persistent grid of warps, one tile at a time per warp.

// One warp copies c ints from src (16-byte aligned: a tile's run) to dst
// (any int address): 16-byte loads, APPEND_UNROLL a lane in flight, and
// each unit's four ints stored one at a time (the warp's stores of a row of
// units cover 512 contiguous bytes, which L2 merges into whole sectors).
__device__ __forceinline__ void append_run(const int* __restrict__ src, int* __restrict__ dst,
                                           int c, int lane) {
  const int4* in = reinterpret_cast<const int4*>(src);
  const int units = (c + 3) >> 2;
  for (int u0 = 0; u0 < units; u0 += 32 * APPEND_UNROLL) {
    int4 v[APPEND_UNROLL];
#pragma unroll
    for (int r = 0; r < APPEND_UNROLL; ++r) {
      const int u = u0 + 32 * r + lane;
      v[r] = u < units ? __ldg(in + u) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int r = 0; r < APPEND_UNROLL; ++r) {
      const int u = u0 + 32 * r + lane;
      if (u >= units) break;
      int* d = dst + 4 * u;
      if (4 * u < c) d[0] = v[r].x;
      if (4 * u + 1 < c) d[1] = v[r].y;
      if (4 * u + 2 < c) d[2] = v[r].z;
      if (4 * u + 3 < c) d[3] = v[r].w;
    }
  }
}

// Warp g of the grid's G copies tiles g, g + G, g + 2G, ...; its lanes
// load the counts and offsets of its next 32 tiles at once.
__global__ void __launch_bounds__(APPEND_THREADS)
tile_append(const int* __restrict__ scratch, const int* __restrict__ counts,
            const int* __restrict__ offsets, int ntiles, int planes, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * APPEND_WARPS;
  const long long total = __ldg(offsets + ntiles);
  for (long long t0 = (long long)blockIdx.x * APPEND_WARPS + (threadIdx.x >> 5); t0 < ntiles;
       t0 += 32 * warps) {
    const long long t = t0 + lane * warps;
    int c = 0, o = 0;
    if (t < ntiles) {
      c = __ldg(counts + t);
      o = __ldg(offsets + t);
    }
    for (int j = 0; j < 32 && t0 + j * warps < ntiles; ++j) {
      const int cj = __shfl_sync(0xFFFFFFFFu, c, j);
      const int oj = __shfl_sync(0xFFFFFFFFu, o, j);
      if (cj == 0) continue;
      const long long tj = t0 + j * warps;
      for (int p = 0; p < planes; ++p)
        append_run(scratch + ((long long)p * ntiles + tj) * TILE, out + p * total + oj, cj, lane);
    }
  }
}

using TilesKernel = void (*)(const uint8_t*, long long, int, int, int, int, int, int,
                             const long long*, int, const uint8_t*, long long, int, int,
                             uint32_t, const int*, int, int, const uint16_t*, int*, int*);

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

// The dynamic shared memory of a minimizer_tiles launch (the bytes that
// ops/fused._smem_bytes mirrors).
long long smt_tile_smem_bytes(int k, int w, int canonical, int mode, int amb, int text,
                              int antilex, int sub_tile) {
  return (long long)tile_smem_bytes(k, w, canonical != 0, mode, amb != 0, text != 0,
                                    antilex != 0, sub_tile);
}

// The blocks of the minimizer_tiles instance (canonical, mode, amb) that
// one SM of card `device` holds at once with `smem` bytes of dynamic shared
// memory a block, in *blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// after smt_init).
int smt_tiles_blocks_per_sm(int device, int canonical, int mode, int amb, long long smem,
                            int* blocks) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const TilesKernel kern = tiles_instance(canonical != 0, mode, amb != 0);
  if (kern == nullptr || blocks == nullptr || smem < 0) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, THREADS, (size_t)smem);
}

// mode: 0 minimizers, 1 super-k-mers, 2 syncmers (kept where sel - gw is
// sync_lo or sync_hi). bytes_in: one char per byte (text bytes, or 2-bit
// codes without text), else the 2-bit byte stream; text: the tables hold
// 256 entries, else 4. amb: the 1-bit ambiguity plane of amb_nbytes bytes,
// or null for none. offset: added (mod 2^32) to every emitted value. meta:
// null, or two ints on the card, n and the offset's bits, read in place of
// n and offset (a CUDA-graph capture's launch, n at most the n given here).
// sub_tile: 0 for the stored route, else the large-w route's block of
// columns, a power of two <= min(w, TILE). passes: the stored route's
// doubling passes, 2^passes <= w (0 on the large-w route). top16: on the
// large-w route kmer_top16's tops of k-mers 0 .. n - k of the same chars
// (csrc/top16.cu), required (null returns an error: the route never hashes);
// null on the stored route. scratch holds ntiles * TILE ints per plane (two
// for super-k-mers).
int smt_minimizer_tiles(int device, const void* words, long long nbytes, int n, int k, int w,
                        int canonical, int mode, int bytes_in, int text, int antilex,
                        const void* table, int rot, const void* amb, long long amb_nbytes,
                        int sync_lo, int sync_hi, unsigned int offset, const void* meta,
                        int sub_tile, int passes, const void* top16, void* scratch, void* counts,
                        int ntiles, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const TilesKernel kern = tiles_instance(canonical != 0, mode, amb != nullptr);
  if (kern == nullptr || (table == nullptr && !antilex) || (text && !bytes_in) ||
      sub_tile < 0 || sub_tile > TILE || (sub_tile & (sub_tile - 1)) || sub_tile > w ||
      passes < 0 || passes > 30 || (sub_tile ? passes != 0 : (1 << passes) > w) ||
      (sub_tile != 0) != (top16 != nullptr) || (reinterpret_cast<uintptr_t>(top16) & 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tile_smem_bytes(k, w, canonical != 0, mode, amb != nullptr, text != 0,
                                      antilex != 0, sub_tile);
  kern<<<ntiles, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)words, nbytes, n, k, w, bytes_in, text, antilex,
      (const long long*)table, rot, (const uint8_t*)amb, amb_nbytes, sync_lo, sync_hi,
      (uint32_t)offset, (const int*)meta, sub_tile, passes, (const uint16_t*)top16,
      (int*)scratch, (int*)counts);
  return (int)cudaGetLastError();
}

// status: status_words zeroed words of 8 bytes, at least 2 + (ntiles +
// SCAN_BLOCK - 1) / SCAN_BLOCK, that no other launch uses at the same
// time; each launch leaves them zeroed.
int smt_tile_offsets(int device, const void* counts, int ntiles, void* offsets, void* status,
                     long long status_words, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (ntiles + SCAN_BLOCK - 1) / SCAN_BLOCK;
  if (ntiles < 1 || status_words < 2 + blocks) return (int)cudaErrorInvalidValue;
  tile_offsets<<<blocks, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)counts, ntiles, (int*)offsets, (unsigned long long*)status);
  return (int)cudaGetLastError();
}

// *blocks_per_sm: the blocks of tile_append that one SM of card `device`
// holds at once (the occupancy query); *warps_per_block: the tiles each
// block copies at once. ops/fused.append_grid sizes the persistent grid
// from them.
int smt_append_occupancy(int device, int* blocks_per_sm, int* warps_per_block) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (blocks_per_sm == nullptr || warps_per_block == nullptr) return (int)cudaErrorInvalidValue;
  *warps_per_block = APPEND_WARPS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, tile_append,
                                                            APPEND_THREADS, 0);
}

// planes: 1, or 2 for super-k-mers; out holds planes * total ints; scratch
// is 16-byte aligned; blocks: the grid (ops/fused.append_grid), any
// count >= 1 copies every tile.
int smt_tile_append(int device, const void* scratch, const void* counts, const void* offsets,
                    int ntiles, int planes, int blocks, void* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (ntiles < 1 || planes < 1 || planes > 2 || blocks < 1 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) || (reinterpret_cast<uintptr_t>(out) & 3))
    return (int)cudaErrorInvalidValue;
  tile_append<<<blocks, APPEND_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)scratch, (const int*)counts, (const int*)offsets, ntiles, planes, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

// The slots of a batch of ASCII reads, on Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the card's side of what the JAX package
// does in NumPy on the host before its batch kernel runs. Given a (B, L)
// uint8 matrix of reads as the caller holds it, the JAX builder folds each
// row with `as_seq` (simd_minimizers_tpu/api.py `_builder_run_batch`: an
// all-ACGT row becomes 2-bit codes, any other row stays raw text bytes),
// and the batch engine lays the rows end to end at a stride with zero
// padding and flags every padding char in a 1-bit plane
// (simd_minimizers_tpu/ops/batch.py `_fill_slots`). Here one launch does
// all of it for a range of rows, bit for bit as the port's host route
// (`np.where(acgt, (b >> 1) & 3, b)`, `batch._fill_slots`,
// `convert.padding_plane`):
//   - row r's slot is out[r * stride, r * stride + stride): the row's L
//     bytes, folded to (b >> 1) & 3 if every byte of the row is one of
//     ACGTacgt and raw otherwise, then stride - L zero bytes;
//   - plane bit i (byte i / 8, bit i % 8) is set where char i is padding
//     (column >= L), where the row's own flag amb[r * L + column] is not 0
//     (if flags are given), and past the last slot up to a whole byte;
//   - *dna is cleared if any row is not all ACGT (one word for the whole
//     call: a launch only ever clears it, so launches share it).
//
// Bound: bytes. 1,000,000 x 150 bp at stride 160 reads 150 MB and writes
// 160 MB of slots and 20 MB of plane: 0.0985 ms at 3.35 TB/s. What the
// design does for it:
//   - Each lane takes a 16-byte chunk of the output (16-byte aligned in
//     the output buffer) and stores it whole where the chunk lies inside
//     the row's slot, byte by byte only at a slot's edges (never where
//     stride is a multiple of 16, as 160 is). A row's lanes lie in one
//     warp, so its ACGT vote is one `__ballot_sync`. A slot of at most 16
//     chunks leaves a warp room for more than one row: it takes 32 /
//     chunks rows (3 of 150 bp, 30 lanes busy; one row a warp left 10 of
//     32 busy and took 5.4 times the bound, held by instruction
//     throughput).
//   - The row's input starts at r * L, which lies at another offset modulo
//     4 than its slot: a lane loads the five 4-byte words around its
//     chunk's 16 source bytes and realigns them with funnel shifts. A
//     warp's loads cover one contiguous span, so each sector is fetched
//     once.
//   - Slots of up to 32 chunks (stride <= 497 at any offset, 512 on 16
//     bytes) keep their bytes in registers between the vote and the
//     stores; a longer row is read twice, the second time mostly from L2.
//   - The vote, the fold and the plane bits are SIMD in a word: `| 0x20`
//     and four `__vcmpeq4` test four bytes against acgt, `(x >> 1) &
//     0x03030303` folds four, and a chunk's 16 plane bits are one 2-byte
//     store. A plane byte shared by two slots (stride not a multiple of 8)
//     is computed whole by both warps from the positions alone and stored
//     by both with the same value.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SLOTS_THREADS = 256;  // 8 warps a block
constexpr int ROW_CHUNKS = 32;      // a slot of up to this many chunks stays in registers

struct Rows {
  const uint8_t* in;   // (rows, L) ASCII bytes, 4-byte aligned
  const uint8_t* amb;  // (rows, L) flags, 4-byte aligned, or null
  long long nin;       // rows * L
  long long n;         // rows * stride: the launch's chars
  int rows, L, stride;
};

// Word w (4 bytes, little-endian) of a 4-byte-aligned buffer of nbytes
// bytes; bytes outside the buffer read as 0 and are never loaded.
__device__ __forceinline__ uint32_t word_at(const uint8_t* buf, long long nbytes, long long w) {
  const long long b = 4 * w;
  if (w < 0 || b >= nbytes) return 0;
  if (b + 4 <= nbytes) return __ldg(reinterpret_cast<const uint32_t*>(buf) + w);
  uint32_t x = 0;
  for (int i = 0; b + i < nbytes; ++i) x |= (uint32_t)__ldg(buf + b + i) << (8 * i);
  return x;
}

// The 16 bytes buf[p .. p + 15] (p may be negative or unaligned) as 4 words.
__device__ __forceinline__ void bytes16(const uint8_t* buf, long long nbytes, long long p,
                                        uint32_t x[4]) {
  const long long w = p >> 2;  // floor, p may be negative
  const uint32_t sh = 8u * (uint32_t)(p & 3);
  uint32_t v[5];
  if (w >= 0 && 4 * (w + 5) <= nbytes) {  // inside the buffer: no checks
    const uint32_t* words = reinterpret_cast<const uint32_t*>(buf) + w;
#pragma unroll
    for (int k = 0; k < 5; ++k) v[k] = __ldg(words + k);
  } else {
#pragma unroll
    for (int k = 0; k < 5; ++k) v[k] = word_at(buf, nbytes, w + k);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = __funnelshift_r(v[k], v[k + 1], sh);
}

// The bits j of [lo, hi) that lie in 0..15.
__device__ __forceinline__ uint32_t span16(long long lo, long long hi) {
  lo = lo < 0 ? 0 : lo;
  hi = hi > 16 ? 16 : hi;
  return hi <= lo ? 0u : ((1u << hi) - 1) & ~((1u << lo) - 1);
}

// Bits 4k .. 4k + 3 of a 16-bit mask as a byte mask: 0xFF where set.
__device__ __forceinline__ uint32_t byte_mask(uint32_t m16, int k) {
  const uint32_t nib = (m16 >> (4 * k)) & 0xFu;
  return ((nib * 0x00204081u) & 0x01010101u) * 0xFFu;
}

// 0xFF for each byte of x that is one of ACGTacgt.
__device__ __forceinline__ uint32_t acgt_bytes(uint32_t x) {
  const uint32_t y = x | 0x20202020u;  // b | 0x20 is acgt exactly when b is ACGTacgt
  return __vcmpeq4(y, 0x61616161u) | __vcmpeq4(y, 0x63636363u) | __vcmpeq4(y, 0x67676767u) |
         __vcmpeq4(y, 0x74747474u);
}

// One bit for each byte of x that is not 0, byte k at bit k.
__device__ __forceinline__ uint32_t nonzero_bits(uint32_t x) {
  const uint32_t m = __vcmpne4(x, 0u) & 0x01010101u;
  return ((m * 0x01020408u) >> 24) & 0xFu;  // the four partial products meet in bits 24..27
}

// Plane bit of char o of the launch, from the positions (and the flags) alone.
__device__ __forceinline__ uint32_t plane_bit(const Rows& R, long long o) {
  if (o >= R.n) return 1;
  const long long r = o / R.stride, col = o - r * R.stride;
  if (col >= R.L) return 1;
  return R.amb != nullptr && __ldg(R.amb + r * R.L + col) != 0;
}

// Chunk c of the output (chars 16c .. 16c + 15) as row r sees it.
struct Chunk {
  long long col0;  // the column of the chunk's first char in row r's slot
  uint32_t code;   // bits of the chars in columns 0 .. L - 1
  uint32_t row;    // bits of the chars in columns 0 .. stride - 1
};

__device__ __forceinline__ Chunk chunk_of(const Rows& R, long long r, long long c) {
  Chunk ch;
  ch.col0 = 16 * c - r * R.stride;
  ch.code = span16(-ch.col0, R.L - ch.col0);
  ch.row = span16(-ch.col0, R.stride - ch.col0);
  return ch;
}

// The chunk's 16 source bytes (row r's bytes at its code bits; 0 where none).
__device__ __forceinline__ void load_chunk(const Rows& R, long long r, const Chunk& ch,
                                           uint32_t x[4]) {
  x[0] = x[1] = x[2] = x[3] = 0;
  if (ch.code) bytes16(R.in, R.nin, r * R.L + ch.col0, x);
}

__device__ __forceinline__ bool chunk_acgt(const Chunk& ch, const uint32_t x[4]) {
  uint32_t all = 0xFFFFFFFFu;
#pragma unroll
  for (int k = 0; k < 4; ++k) all &= acgt_bytes(x[k]) | ~byte_mask(ch.code, k);
  return all == 0xFFFFFFFFu;
}

// Store row r's bytes of chunk c and the chunk's 16 plane bits.
__device__ __forceinline__ void store_chunk(const Rows& R, long long r, long long c,
                                            const Chunk& ch, const uint32_t x[4], bool acgt,
                                            uint8_t* out, uint8_t* plane) {
  uint32_t y[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    y[k] = (acgt ? (x[k] >> 1) & 0x03030303u : x[k]) & byte_mask(ch.code, k);
  uint8_t* o = out + 16 * c;
  if (ch.row == 0xFFFFu) {
    *reinterpret_cast<uint4*>(o) = make_uint4(y[0], y[1], y[2], y[3]);
    uint32_t bits = ~ch.code & 0xFFFFu;  // padding
    if (R.amb != nullptr && ch.code) {
      uint32_t f[4];
      bytes16(R.amb, R.nin, r * R.L + ch.col0, f);
      uint32_t flagged = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) flagged |= nonzero_bits(f[k]) << (4 * k);
      bits |= flagged & ch.code;
    }
    *reinterpret_cast<uint16_t*>(plane + 2 * c) = (uint16_t)bits;
    return;
  }
  // a slot's edge: this row's bytes one at a time, the plane bytes whole
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if ((ch.row >> j) & 1u) o[j] = (uint8_t)(y[j >> 2] >> (8 * (j & 3)));
  uint32_t bits = 0;
  for (int j = 0; j < 16; ++j) bits |= plane_bit(R, 16 * c + j) << j;
  const long long nplane = (R.n + 7) / 8;
  if (2 * c < nplane) plane[2 * c] = (uint8_t)bits;
  if (2 * c + 1 < nplane) plane[2 * c + 1] = (uint8_t)(bits >> 8);
}

// `chunks`: the most 16-byte chunks a slot spans; a warp takes `group` =
// 32 / chunks rows (one where chunks > 32), `chunks` lanes each.
__global__ void __launch_bounds__(SLOTS_THREADS)
    ascii_slots(Rows R, int chunks, int group, uint8_t* __restrict__ out,
                uint8_t* __restrict__ plane, int* __restrict__ dna) {
  const long long warp = ((long long)blockIdx.x * SLOTS_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp * group >= R.rows) return;  // whole warps: SLOTS_THREADS is a multiple of 32
  if (chunks <= ROW_CHUNKS) {
    // lane i of group g: chunk c0 + i of row warp * group + g
    const int g = lane / chunks, i = lane - g * chunks;
    const long long r = warp * group + g;
    const bool live = g < group && r < R.rows;
    const long long s = r * R.stride;
    const long long c = (s >> 4) + i;
    const bool mine = live && c <= (s + R.stride - 1) >> 4;
    Chunk ch;
    uint32_t x[4];
    if (mine) {
      ch = chunk_of(R, r, c);
      load_chunk(R, r, ch, x);
    }
    const uint32_t ok = __ballot_sync(0xFFFFFFFFu, !mine || chunk_acgt(ch, x));
    if (!live) return;
    const uint32_t lanes = (chunks == 32 ? 0xFFFFFFFFu : (1u << chunks) - 1) << (g * chunks);
    const bool acgt = (ok & lanes) == lanes;  // the vote of the row's lanes
    if (mine) store_chunk(R, r, c, ch, x, acgt, out, plane);
    if (!acgt && i == 0) atomicAnd(dna, 0);
    return;
  }
  // a long row, one a warp: the vote over every chunk, then each chunk again
  const long long r = warp;
  const long long s = r * R.stride;
  const long long c0 = s >> 4, c1 = (s + R.stride - 1) >> 4;  // the slot's chunks
  bool ok = true;
  for (long long c = c0 + lane; c <= c1 && ok; c += 32) {
    const Chunk ch = chunk_of(R, r, c);
    uint32_t x[4];
    load_chunk(R, r, ch, x);
    ok = chunk_acgt(ch, x);
  }
  const bool acgt = __all_sync(0xFFFFFFFFu, ok);
  for (long long c = c0 + lane; c <= c1; c += 32) {
    const Chunk ch = chunk_of(R, r, c);
    uint32_t x[4];
    load_chunk(R, r, ch, x);
    store_chunk(R, r, c, ch, x, acgt, out, plane);
  }
  if (!acgt && lane == 0) atomicAnd(dna, 0);
}

}  // namespace

extern "C" {

// The slots of `rows` ASCII reads of L bytes (in: rows * L bytes; amb: as
// many flags, or null) at `stride` > L chars a slot: out (rows * stride
// bytes, 16-byte aligned) and plane ((rows * stride + 7) / 8 bytes, 2-byte
// aligned); *dna (an int on the card) is set to 0 if a row is not all
// ACGT, and left as it is otherwise. Returns a CUDA error code (0 =
// success): cudaGetLastError() after the launch.
int smt_ascii_slots(int device, const void* in, const void* amb, int rows, int L, int stride,
                    void* out, void* plane, void* dna, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (rows < 1 || L < 0 || stride <= L || (long long)rows * stride >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Rows R;
  R.in = (const uint8_t*)in;
  R.amb = (const uint8_t*)amb;
  R.nin = (long long)rows * L;
  R.n = (long long)rows * stride;
  R.rows = rows;
  R.L = L;
  R.stride = stride;
  // the most chunks a slot spans: stride / 16 where slots start on 16 bytes
  const int chunks = stride % 16 == 0 ? stride / 16 : (stride + 14) / 16 + 1;
  const int group = chunks <= ROW_CHUNKS ? ROW_CHUNKS / chunks : 1;
  const long long warps = ((long long)rows + group - 1) / group;
  const unsigned blocks = (unsigned)((warps + SLOTS_THREADS / 32 - 1) / (SLOTS_THREADS / 32));
  ascii_slots<<<blocks, SLOTS_THREADS, 0, (cudaStream_t)stream>>>(
      R, chunks, group, (uint8_t*)out, (uint8_t*)plane, (int*)dna);
  return (int)cudaGetLastError();
}

}  // extern "C"

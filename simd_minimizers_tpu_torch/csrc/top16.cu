// kmer_top16: the top 16 bits of the hash of every k-mer, on Hopper (sm_90a).
//
// The pre-pass of minimizer_tiles' large-w route (csrc/minimizers.cu). It
// replaces, on that route, the hash stage of the one Pallas TPU kernel of
// the JAX package: simd_minimizers_tpu/ops/fused.py `_hash_windows` (B2),
// which the TPU kernel runs on its large-halo geometry over every column of
// a block. The route reads the 16-bit tops this kernel writes once per
// k-mer, and hashes nothing.
//
// Output: out[i] = top 16 bits of the hash of k-mer i (chars i .. i + k - 1)
// for i in [0, n - k], as minimizer_tiles' `hash_cols` computes it: the nt /
// mul fold XOR_j rotl(F[c_{i+j}], j + rot) over per-char forward values F,
// XORed with the reverse complement's XOR_j rotl(R[c_{i+j}], k - 1 - j + rot)
// when CANONICAL; or antilex, the complement of the first min(k, 16) chars
// packed MSB-first (canonical: XOR the same of the reverse complement).
// There is no sentinel: 0xFFFF is a real top, and the reader tests validity
// by index. The input is minimizer_tiles': the plain 2-bit byte stream (base
// i at bits 2 * (i % 4) of byte i / 4), 2-bit codes one per byte (only the
// low two bits count) or text bytes; n from `meta` on the card when it is
// given (a CUDA-graph capture), the tables, `rot` and the antilex flag
// block-uniform.
//
// What bounds it on the H100: bytes, then integer issue. It reads 0.25 B
// per char of 2-bit input (1 B of code bytes or text) and writes 2 B per
// k-mer: 0.225 GB at 1e8 chars, 0.067 ms at 3.35 TB/s. The fold is a
// prefix XOR, so every top is O(1) work whatever k:
//   h_i = rotr(G_{i+k} ^ G_i, i),      G_j = XOR_{p<j} rotl(F[c_p], p + rot)
//   r_i = rotl(H_{i+k} ^ H_i, i),      H_j = XOR_{p<j} rotl(R[c_p], k - 1 + rot - p)
// (rotations mod 32, p and i from the launch's first char), so with
// S_i = G_{i+k} ^ G_i, S_{i+1} = S_i ^ T_i where T_i = rotl(Fa[c_i] ^
// Fb[c_{i+k}], i), Fa = rotl(F, rot), Fb = rotl(F, k + rot) (the complement
// strand alike: rotr(Ra[c_i] ^ Rb[c_{i+k}], i), Ra = rotl(R, k - 1 + rot),
// Rb = rotl(R, rot - 1)). For 2-bit codes both strands' T_i come from one
// 8-byte shared load of a table indexed by (i mod 32, c_i, c_{i+k}), 4 KiB,
// built in the block's prologue; text takes a load of two 256-entry tables
// and a rotation per strand. About 11 integer operations a k-mer
// canonical, 6 forward (tests/test_torch_kmer_top16.py holds a NumPy model
// of this arithmetic against the plain version). The design:
// - a persistent grid, (SMs x resident blocks) of 256 threads; block b
//   walks the contiguous chunks [C b / G, C (b + 1) / G) of CHUNK = 8,192
//   k-mers (C from the length on the card, so a captured launch balances
//   too), and carries S from one chunk to the next: the only O(k) work is
//   S at its first chunk, XOR_{p<k} of the terms, k / 256 per thread;
// - thread t hashes the RUN = 32 consecutive k-mers of the chunk from
//   32 t: the exclusive prefix XOR of its 32 T in registers, then a warp
//   and a block scan of the run totals give each run its S;
// - each chunk's chars come in by 1-D bulk copies (cp.async.bulk, Hopper's
//   TMA without a tensor map) completing on an mbarrier, double-buffered:
//   thread 0 starts chunk j + 1's copy when chunk j's has landed, so the
//   block hashes one chunk while the next arrives. The chars stay as they
//   lie (2-bit: 0.25 B a char; a run takes its codes with shifts and
//   masks of 32-bit words); the outgoing stream from the chunk's first
//   char, the incoming one from the 64-char boundary below c + k (one copy
//   for both when that is the same region). A chars view that is not
//   16-byte aligned, and a chunk whose region runs past the input, takes
//   plain loads into the same buffers instead;
// - the chunk's tops are staged in shared memory (two buffers) and leave
//   by one bulk store, issued after the next chunk's barrier: a thread's
//   own 64 bytes stored from its registers (16-byte stores at a 64-byte
//   stride) cost 0.06-0.09 ms at 1e8 chars on the H100 that the compute
//   did not hide (PERF.md, the pre-pass's ablation), as one coalesced stream
//   they hide.
// One barrier a chunk. Antilex needs no state: a top is the chars i .. i + 7
// read from the packed stream (reversed into MSB-first order), and
// canonical XORs in chars i + k - 8 .. i + k - 1 (below k = 8: the k chars,
// masked). Shared memory is fixed whatever k (`layout`: 45-49 KB of 2-bit
// input, 58-74 KB of code bytes or text), so the pre-pass never narrows
// ops/fused.fused_supported.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RUN = 32;                   // consecutive k-mers a thread hashes per chunk
constexpr int CHUNK = THREADS * RUN;      // k-mers per chunk
constexpr int REGION_CHARS = CHUNK + 128; // chars of a stream's region (runs read 48 chars)
constexpr int STAGES = 2;
constexpr int CODES = 4;                  // per-char table entries of 2-bit codes
constexpr int TEXT_CHARS = 256;           // per-char table entries of text (bytes)
constexpr int MAX_DEVICES = 64;

// The block's dynamic shared memory, in bytes from its start (each part a
// multiple of 16): the bulk copies' mbarriers, the scan's warp totals (by
// chunk parity), the 2-bit pair table (T of (i mod 32, c_i, c_{i+k}), both
// strands), the per-char Fa, Ra, Fb, Rb tables (256 entries of text, 4 of
// codes, one array each so that a strand's lookups spread over all 32
// banks), two chunks' tops staged for their bulk stores, and STAGES regions
// of the outgoing stream (then of the incoming one, where it is a region of
// its own), 0.25 B a char of 2-bit input, 1 B of code bytes or text.
struct Layout {
  int bar, warp, pair, tables, stage, out, in, region, total;
};

__host__ __device__ inline int incoming_offset(int k, bool antilex) {
  return antilex ? (k >= 8 ? k - 8 : 0) : k;  // antilex: the reverse complement's first chars
}

__host__ __device__ inline Layout layout(int k, bool canonical, bool bytes_in, bool antilex) {
  Layout l;
  const bool two = (incoming_offset(k, antilex) & ~63) != 0 && !(antilex && !canonical);
  l.region = bytes_in ? REGION_CHARS : REGION_CHARS / 4;
  l.bar = 0;
  l.warp = l.bar + 16 * ((8 * STAGES + 15) / 16);
  l.pair = l.warp + 2 * WARPS * 8;
  l.tables = l.pair + RUN * CODES * CODES * 8;
  l.stage = l.tables + 4 * TEXT_CHARS * 4;
  l.out = l.stage + 2 * CHUNK * 2;
  l.in = l.out + STAGES * l.region;
  l.total = l.in + (two ? STAGES * l.region : 0);
  return l;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }
__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) { return __funnelshift_r(x, x, r); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// wait for the phase of `parity` to complete; a copy that never lands traps
// (a launch error) instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 28)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// one thread: arrive on the stage's mbarrier, expecting `bytes` of bulk copies
__device__ __forceinline__ void bulk_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// one thread: a bulk store of `bytes` of shared memory (written by the
// block before a fence.proxy.async and a barrier) to dst, in a bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the issuing thread: its bulk stores have read their shared memory
__device__ __forceinline__ void bulk_store_read_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` bytes (a multiple of 4) of src from byte g into dst, those past
// nbytes reading as 0 (they reach only k-mers that are not written): the
// kernel's path for a view that is not 16-byte aligned and for the regions
// at the end of the input
__device__ void copy_plain(uint8_t* dst, const uint8_t* src, long long g, int bytes,
                           long long nbytes) {
  const int a = (int)((reinterpret_cast<uintptr_t>(src) + g) & 3);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(src + g - a);
  for (int i = threadIdx.x; i < bytes / 4; i += THREADS) {
    const long long e = g + 4LL * i;
    uint32_t x = 0;
    if (e - a >= 0 && e - a + 8 <= nbytes) {
      x = __funnelshift_r(__ldg(w + i), __ldg(w + i + 1), 8 * a);
    } else {
      for (int q = 0; q < 4; ++q)
        if (e + q >= 0 && e + q < nbytes) x |= (uint32_t)src[e + q] << (8 * q);
    }
    reinterpret_cast<uint32_t*>(dst)[i] = x;
  }
}

// The 2-bit codes of 16 code bytes (low two bits of each), char j at bits 2 j.
__device__ __forceinline__ uint32_t pack16(uint4 b) {
  // (x & 0x03030303) * 0x01041040: the four codes of x in its top byte, no carries
  const uint32_t m0 = (b.x & 0x03030303u) * 0x01041040u, m1 = (b.y & 0x03030303u) * 0x01041040u;
  const uint32_t m2 = (b.z & 0x03030303u) * 0x01041040u, m3 = (b.w & 0x03030303u) * 0x01041040u;
  return __byte_perm(__byte_perm(m0, m1, 0x0073), __byte_perm(m2, m3, 0x0073), 0x5410);
}

// NW words of 16 2-bit codes from char ch + shift / 2 of a region (ch a
// multiple of 16): the region's 2-bit words, or its code bytes packed
template <int NW>
__device__ __forceinline__ void codes_at(const uint8_t* region, bool packed, int ch, int shift,
                                         uint32_t (&w)[NW]) {
  uint32_t raw[NW + 1];
  if (packed) {
    const uint32_t* r = reinterpret_cast<const uint32_t*>(region) + ch / 16;
#pragma unroll
    for (int i = 0; i <= NW; ++i) raw[i] = r[i];
  } else {
    const uint4* r = reinterpret_cast<const uint4*>(region + ch);
#pragma unroll
    for (int i = 0; i <= NW; ++i) raw[i] = pack16(r[i]);
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = __funnelshift_r(raw[i], raw[i + 1], shift);
}

// 8 words of text bytes from byte OFF * 4 + sh / 8 of raw
template <int OFF>
__device__ __forceinline__ void realign8(const uint32_t (&raw)[12], int sh, uint32_t (&w)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = __funnelshift_r(raw[OFF + i], raw[OFF + i + 1], sh);
}

// 2-bit pairs reversed: char j at bits 31 - 2 j .. 30 - 2 j (MSB-first)
__device__ __forceinline__ uint32_t msb_first(uint32_t x) {
  const uint32_t r = __brev(x);
  return ((r >> 1) & 0x55555555u) | ((r & 0x55555555u) << 1);
}

template <bool CANONICAL>
__global__ void __launch_bounds__(THREADS, CANONICAL ? 2 : 3)
kmer_top16(const uint8_t* __restrict__ words, long long nbytes, int n_arg, int k, int bytes_in,
           int text, int antilex, const long long* __restrict__ table, int rot,
           const int* __restrict__ meta, uint16_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(k, CANONICAL, bytes_in != 0, antilex != 0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint2* warp_totals = reinterpret_cast<uint2*>(smem + L.warp);  // [chunk parity][warp]
  uint2* pair = reinterpret_cast<uint2*>(smem + L.pair);
  uint32_t* fa = reinterpret_cast<uint32_t*>(smem + L.tables);
  uint32_t* ra = fa + TEXT_CHARS;
  uint32_t* fb = ra + TEXT_CHARS;
  uint32_t* rb = fb + TEXT_CHARS;
  uint4* stage = reinterpret_cast<uint4*>(smem + L.stage);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = meta ? meta[0] : n_arg;  // a captured launch reads its length on the card
  const long long nk = (long long)n - k + 1;
  const long long nchunks = nk > 0 ? (nk + CHUNK - 1) / CHUNK : 0;
  const long long c0 = nchunks * blockIdx.x / gridDim.x;
  const long long c1 = nchunks * (blockIdx.x + 1) / gridDim.x;
  if (c0 >= c1) return;  // past a captured launch's length: the whole block

  const bool packed = !bytes_in;
  const bool fold_text = text && !antilex;  // text antilex reads the low two bits, as code bytes
  if (!antilex) {
    const int E = fold_text ? TEXT_CHARS : CODES;
    for (int c = tid; c < E; c += THREADS) {
      const uint32_t f = (uint32_t)table[c], r = (uint32_t)table[E + c];
      fa[c] = rotl(f, rot), ra[c] = rotl(r, k - 1 + rot);
      fb[c] = rotl(f, k + rot), rb[c] = rotl(r, rot - 1);
    }
  }
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (!antilex && !fold_text) {
    for (int e = tid; e < RUN * CODES * CODES; e += THREADS) {
      const int q = e / 16, a = (e / 4) % 4, b = e % 4;
      pair[e] = make_uint2(rotl(fa[a] ^ fb[b], q), rotr(ra[a] ^ rb[b], q));
    }
  }

  // S (and the complement strand's) at the block's first k-mer: the only
  // O(k) work of the block, k / THREADS terms a thread, then a block XOR
  uint32_t A = 0, Y = 0;
  if (!antilex) {
    const long long b0 = c0 * CHUNK;
    for (long long p = b0 + tid; p < b0 + k; p += THREADS) {
      const int c = packed ? (words[p >> 2] >> (2 * (p & 3))) & 3
                           : words[p] & (fold_text ? 0xFF : 3);
      A ^= rotl(fa[c], (int)(p & 31));
      if (CANONICAL) Y ^= rotr(ra[c], (int)(p & 31));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      A ^= __shfl_xor_sync(0xFFFFFFFFu, A, o);
      if (CANONICAL) Y ^= __shfl_xor_sync(0xFFFFFFFFu, Y, o);
    }
    if (lane == 0) warp_totals[WARPS + warp] = make_uint2(A, Y);  // parity 1: first written in chunk 1
  }
  __syncthreads();
  if (!antilex) {
    A = Y = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) A ^= warp_totals[WARPS + i].x, Y ^= warp_totals[WARPS + i].y;
  }

  // the streams: the outgoing one from the chunk's first char; the incoming
  // one (fold: char c + k; antilex canonical: the last 8 chars' first, or
  // the k-mer's own below k = 8) from the 64-char boundary below it, skew d
  const int kin = incoming_offset(k, antilex);
  const int d = kin & 63;
  const bool two_regions = L.total > L.in;
  const int region_bytes = L.region;
  const bool aligned = (reinterpret_cast<uintptr_t>(words) & 15) == 0;
  auto out_at = [&](long long b0) { return packed ? b0 / 4 : b0; };
  auto in_at = [&](long long b0) {
    const long long ch = b0 + (kin & ~63);
    return packed ? ch / 4 : ch;
  };
  auto bulk = [&](long long b0) {
    return aligned && out_at(b0) + region_bytes <= nbytes &&
           (!two_regions || in_at(b0) + region_bytes <= nbytes);
  };
  auto region_out = [&](int st) { return smem + L.out + st * region_bytes; };
  auto region_in = [&](int st) { return smem + L.in + st * region_bytes; };
  auto start_copy = [&](int st, long long b0) {  // thread 0
    fence_proxy_async();
    bulk_expect(&bars[st], (two_regions ? 2 : 1) * region_bytes);
    bulk_copy(region_out(st), words + out_at(b0), region_bytes, &bars[st]);
    if (two_regions) bulk_copy(region_in(st), words + in_at(b0), region_bytes, &bars[st]);
  };
  // antilex: the last min(k, 16) chars' mask, and the shift that puts the
  // reverse complement's chars at the top
  const uint32_t keep = k >= 16 ? 0xFFFFFFFFu : ~0u << (32 - 2 * k);
  const int ra_shift = k >= 8 ? 16 : 32 - 2 * k;

  if (tid == 0)  // the first STAGES - 1 chunks' copies
    for (int i = 0; i < STAGES - 1 && c0 + i < c1; ++i)
      if (bulk((c0 + i) * CHUNK)) start_copy(i, (c0 + i) * CHUNK);
  uint32_t parity = 0;  // bit st: the phase stage st's mbarrier completes next
  long long pending = -1;  // the chunk (its first k-mer) whose staged tops await their store
  for (long long c = c0; c < c1; ++c) {
    const int j = (int)(c - c0), st = j % STAGES;
    const long long b0 = c * CHUNK;
    if (bulk(b0)) {
      mbar_wait(&bars[st], (parity >> st) & 1);
      parity ^= 1u << st;
    } else {
      copy_plain(region_out(st), words, out_at(b0), region_bytes, nbytes);
      if (two_regions) copy_plain(region_in(st), words, in_at(b0), region_bytes, nbytes);
      __syncthreads();
    }
    // chunk c + STAGES - 1's copy, into the stage chunk c - 1 read before its barrier
    const long long ahead = b0 + (long long)(STAGES - 1) * CHUNK;
    if (tid == 0 && c + STAGES - 1 < c1 && bulk(ahead)) start_copy((j + STAGES - 1) % STAGES, ahead);
    const uint8_t* ro = region_out(st);
    const uint8_t* ri = two_regions ? region_in(st) : ro;

    uint32_t v[RUN / 2];  // the run's tops, two to a word
    uint32_t P[RUN], Q[RUN], tf = 0, tr = 0, ef = 0, er = 0;
    if (antilex) {
      uint32_t o[3], rv[3];
      codes_at<3>(ro, packed, RUN * tid, 0, o);
#pragma unroll
      for (int h = 0; h < 3; ++h) rv[h] = msb_first(o[h]);
      uint32_t ic[3];
      if (CANONICAL) {
        codes_at<3>(ri, packed, RUN * tid + (d & 48), 2 * (d & 15), ic);
#pragma unroll
        for (int h = 0; h < 3; ++h) ic[h] ^= 0xAAAAAAAAu;  // complemented codes
      }
#pragma unroll
      for (int q = 0; q < RUN; ++q) {
        const int h = q / 16, sh = 2 * (q % 16);
        const uint32_t la = sh ? __funnelshift_l(rv[h + 1], rv[h], sh) : rv[h];
        uint32_t top;
        if (CANONICAL) {
          const uint32_t ra = __funnelshift_r(ic[h], ic[h + 1], sh) << ra_shift;
          top = (la ^ ra) & keep;
        } else {
          top = ~(la & keep);
        }
        v[q / 2] = q & 1 ? __byte_perm(v[q / 2], top, 0x7632) : top;
      }
    } else {
      if (fold_text) {
        uint32_t ob[8], ib[8], raw[12];
        const uint4* r4 = reinterpret_cast<const uint4*>(ro + RUN * tid);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint4 x = r4[i];
          ob[4 * i] = x.x, ob[4 * i + 1] = x.y, ob[4 * i + 2] = x.z, ob[4 * i + 3] = x.w;
        }
        r4 = reinterpret_cast<const uint4*>(ri + RUN * tid + (d & 48));
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const uint4 x = r4[i];
          raw[4 * i] = x.x, raw[4 * i + 1] = x.y, raw[4 * i + 2] = x.z, raw[4 * i + 3] = x.w;
        }
        const int sh = 8 * (d & 3);
        switch ((d & 15) >> 2) {
          case 0: realign8<0>(raw, sh, ib); break;
          case 1: realign8<1>(raw, sh, ib); break;
          case 2: realign8<2>(raw, sh, ib); break;
          default: realign8<3>(raw, sh, ib); break;
        }
#pragma unroll
        for (int q = 0; q < RUN; ++q) {
          P[q] = tf, Q[q] = tr;
          const int co = (ob[q / 4] >> (8 * (q % 4))) & 0xFF;
          const int ci = (ib[q / 4] >> (8 * (q % 4))) & 0xFF;
          tf ^= rotl(fa[co] ^ fb[ci], q);
          if (CANONICAL) tr ^= rotr(ra[co] ^ rb[ci], q);
        }
      } else {
        uint32_t o[2], iw[2], even[2], odd[2];
        codes_at<2>(ro, packed, RUN * tid, 0, o);
        codes_at<2>(ri, packed, RUN * tid + (d & 48), 2 * (d & 15), iw);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // nibble j: (c_out << 2 | c_in) of step 2 j (+ 1)
          even[h] = ((o[h] << 2) & 0xCCCCCCCCu) | (iw[h] & 0x33333333u);
          odd[h] = (o[h] & 0xCCCCCCCCu) | ((iw[h] >> 2) & 0x33333333u);
        }
#pragma unroll
        for (int q = 0; q < RUN; ++q) {
          P[q] = tf, Q[q] = tr;
          const uint32_t word = q & 1 ? odd[q / 16] : even[q / 16];
          const uint32_t nib = (word >> (4 * ((q % 16) / 2))) & 15;
          const uint2 t = pair[CODES * CODES * q + nib];
          tf ^= t.x;
          if (CANONICAL) tr ^= t.y;
        }
      }
      // the run totals' exclusive prefix: in the warp, then the warps'
      ef = tf, er = tr;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t a = __shfl_up_sync(0xFFFFFFFFu, ef, o);
        const uint32_t b = CANONICAL ? __shfl_up_sync(0xFFFFFFFFu, er, o) : 0;
        if (lane >= o) ef ^= a, er ^= b;
      }
      if (lane == 31) warp_totals[(j & 1) * WARPS + warp] = make_uint2(ef, er);
      ef ^= tf, er ^= tr;
    }
    if (tid == 0) bulk_store_read_wait();  // chunk c - 2's store has read its staged tops
    __syncthreads();  // the warp totals are in; every thread has read the stage
    // chunk c - 1's tops, staged and fenced by every thread before this barrier
    if (tid == 0 && pending >= 0) bulk_store(out + pending, stage + (j + 1) % 2 * (CHUNK / 8), CHUNK * 2);
    if (!antilex) {
      uint32_t wf = 0, wr = 0, bf = 0, br = 0;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) {
        const uint2 x = warp_totals[(j & 1) * WARPS + i];
        if (i < warp) wf ^= x.x, wr ^= x.y;
        bf ^= x.x, br ^= x.y;
      }
      const uint32_t X = A ^ wf ^ ef, Xr = Y ^ wr ^ er;  // S at the run's first k-mer
      A ^= bf, Y ^= br;                                  // and at the next chunk's
#pragma unroll
      for (int q = 0; q < RUN; ++q) {
        uint32_t top = rotr(X ^ P[q], q);
        if (CANONICAL) top ^= rotl(Xr ^ Q[q], q);
        v[q / 2] = q & 1 ? __byte_perm(v[q / 2], top, 0x7632) : top;
      }
    }

    // the chunk's tops: staged in shared memory (two buffers, by chunk
    // parity) for one bulk store after the next barrier; the last chunk of
    // the input, partial, by 16-bit stores
    const int m = (int)min((long long)CHUNK, nk - b0);
    const int j0 = RUN * tid;
    pending = -1;
    if (m == CHUNK) {
      // a thread's 64 bytes at a 64-byte stride put every other lane of a
      // quarter warp on the same 16-byte bank group (a 4-way conflict);
      // lanes 2 and 3 of each 4 store their pieces in the order 1 2 3 0,
      // which halves it (a full rotation costs 32 selects and was slower)
      uint4* dst = stage + (j % 2) * (CHUNK / 8) + RUN / 8 * tid;
      const int rr = (tid >> 1) & 1;
      const uint4 a0 = make_uint4(v[0], v[1], v[2], v[3]), a1 = make_uint4(v[4], v[5], v[6], v[7]);
      const uint4 a2 = make_uint4(v[8], v[9], v[10], v[11]);
      const uint4 a3 = make_uint4(v[12], v[13], v[14], v[15]);
      dst[rr] = rr ? a1 : a0;
      dst[rr + 1] = rr ? a2 : a1;
      dst[(rr + 2) & 3] = rr ? a3 : a2;
      dst[(rr + 3) & 3] = rr ? a0 : a3;
      fence_proxy_async();
      pending = b0;
    } else {
#pragma unroll
      for (int q = 0; q < RUN; ++q)
        if (j0 + q < m) out[b0 + j0 + q] = (uint16_t)(v[q / 2] >> (16 * (q & 1)));
    }
  }
  __syncthreads();
  if (tid == 0) {
    if (pending >= 0) bulk_store(out + pending, stage + (c1 - 1 - c0) % 2 * (CHUNK / 8), CHUNK * 2);
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

using Top16Kernel = void (*)(const uint8_t*, long long, int, int, int, int, int,
                             const long long*, int, const int*, uint16_t*);

Top16Kernel top16_instance(bool canonical) {
  return canonical ? &kmer_top16<true> : &kmer_top16<false>;
}

int g_sms[MAX_DEVICES];  // per card: its SMs (0: not yet known)

// The persistent grid of a launch: SMs x the blocks of this layout that fit
// an SM (the occupancy query: registers and shared memory).
cudaError_t persistent_grid(int device, bool canonical, int smem, int* grid) {
  int sms = device >= 0 && device < MAX_DEVICES ? g_sms[device] : 0;
  cudaError_t e = cudaSuccess;
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess && device >= 0 && device < MAX_DEVICES) g_sms[device] = sms;
  }
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, top16_instance(canonical), THREADS,
                                                      smem);
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  return e;
}

}  // namespace

extern "C" {

// Every function below works on card `device` and returns a CUDA error
// code (0 = success); a launch returns cudaGetLastError() after it.

// Once per card, before any CUDA-graph capture: let both instances use the
// largest layout (code bytes or text with two regions, above the 48 KB of
// shared memory a block gets without opting in) and note the card's SMs.
int smt_top16_init(int device) {
  cudaError_t e = cudaSetDevice(device);
  int grid = 0;
  const int most = layout(1 << 20, true, true, false).total;
  for (int c = 0; c < 2 && e == cudaSuccess; ++c) {
    e = cudaFuncSetAttribute(top16_instance(c), cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e == cudaSuccess) e = persistent_grid(device, c, most, &grid);
  }
  return (int)e;
}

// *grid = the persistent grid of a launch at (k, canonical, input kind,
// antilex): the blocks a launch of at least that many chunks of CHUNK
// k-mers starts; *smem = the dynamic shared memory of each.
int smt_top16_grid(int device, int k, int canonical, int bytes_in, int antilex, int* grid,
                   int* smem) {
  cudaError_t e = cudaSetDevice(device);
  *smem = layout(k, canonical != 0, bytes_in != 0, antilex != 0).total;
  if (e == cudaSuccess) e = persistent_grid(device, canonical != 0, *smem, grid);
  return (int)e;
}

// The tops of k-mers 0 .. n - k of the first n chars of `words` (nbytes
// bytes) into out (n - k + 1 16-bit words, 16-byte aligned). bytes_in: one
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
      out == nullptr || (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  const int smem = layout(k, canonical != 0, bytes_in != 0, antilex != 0).total;
  int grid = 0;
  e = persistent_grid(device, canonical != 0, smem, &grid);
  if (e != cudaSuccess) return (int)e;
  const long long chunks = ((long long)n - k + 1 + CHUNK - 1) / CHUNK;
  top16_instance(canonical != 0)<<<(int)(chunks < grid ? chunks : grid), THREADS, smem,
                                   (cudaStream_t)stream>>>(
      (const uint8_t*)words, nbytes, n, k, bytes_in, text, antilex, (const long long*)table, rot,
      (const int*)meta, (uint16_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

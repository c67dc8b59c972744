// Monotonic alignment search (MAS) for Hopper (sm_90a): K2.
//
// Replaces tts_tpu/ops/mas.py::maximum_path (:29; the forward scan :45-57,
// the backtrack :66-76). In the JAX package it is device code, two
// lax.scans, not a Pallas kernel; the reference runs it as Cython on the
// host (TTS/tts/utils/monotonic_align/core.pyx) with a device round trip
// every training step. No torch op computes it, and eager PyTorch would
// launch a few kernels per mel frame (~2 x 861 a VITS step).
//
// What it computes, per batch item b, on value and mask [T_x, T_y] (tokens
// x, mel frames j), in fp32:
//   v[x] = 0; for j = 0 .. T_y-1:
//     v0[x] = v[x-1] (-1e9 at x = 0); stay[x] = v[x] >= v0[x] (ties stay);
//     v[x] = x <= j ? (stay ? v[x] : v0[x]) + value[x,j]*mask[x,j] : -1e9;
//     dir[x,j] = mask[x,j] > 0 ? stay[x] : stay (forced outside the mask);
//   then from x = sum(mask[:, 0]) - 1, for j = T_y-1 .. 0: path[x, j] =
//   mask[x, j]; x += dir[x, j] - 1. An empty item (start -1) stays zero;
//   the walk stops where x leaves [0, T_x), as the JAX one-hot then writes
//   nothing. The path is returned in value's type.
// The operations are the JAX package's, in its order: one product by the
// mask (exact: the mask is 0 or 1), a compare, a select and one add, each
// rounded on its own (__fmul_rn / __fadd_rn: nothing fuses), so ties fall
// as they do there and the paths are identical, not close.
//
// What bounds it: the T_y dependent steps of the forward pass. The bytes
// are value and mask read once and the path written once (~126 MB at the
// VITS recipe's B=32, T_x=381, T_y=861 in fp32: ~38 us at 3.35 TB/s), but
// step j needs step j-1's scores from every neighbour, so each item is one
// block walking its frames in order, on one SM.
//
// Two kernels:
//
// mas_ring_kernel (texts whose ring of two 8-frame tiles fits in shared
// memory: 1,536 tokens on an H100; fp32 value and mask, the wrapper widens
// other types first), one block an item:
//   * W "scoring" warps hold the scores in registers: lane l of warp w owns
//     the K consecutive tokens x = (32 w + l) K + k. A lane gets v[x-1]
//     from itself, or from lane l-1 by one __shfl_up_sync; only a warp's
//     first lane reads the previous warp's last score, through shared
//     memory, behind one named barrier of the scoring warps a frame (none
//     when W = 1, the plan up to 512 tokens). A cell is six instructions
//     (the direction bit or'ed in by one predicated instruction) with no
//     memory access in the frames' dependent chain, and the frames run in
//     chunks of 8 without a branch (a branch waits ~13 cycles on its
//     predicate);
//   * P "copying" warps stream value and mask into a ring of S tiles of F
//     (8, 16 or 32) frames in shared memory, ahead of the scoring warps, by
//     4-byte cp.async (a row of the recipe's [B*T_x, T_y] view is 3,444
//     bytes, so neither TMA's 16-byte strides nor 16-byte cp.async apply),
//     signalled through an mbarrier a tile each way (full:
//     cp.async.mbarrier.arrive; empty: the scoring threads' arrive). A copy
//     instruction reads F consecutive frames (up to 32: 128 bytes of a row)
//     of 32/F rows; a copying thread keeps one frame offset and walks one
//     scoring lane's K tokens, rows vsx apart. Tile slots follow the scoring
//     layout (slot w*32K + k*32 + l holds token (32 w + l) K + k), so a
//     scoring warp reads 32 consecutive words, and a frame's row is padded
//     so that a copy instruction's 32 stores fall on 32 banks;
//   * the copying warps also zero the item's path, a slice a tile, while
//     the scores are computed;
//   * the directions are one bit a cell: each lane gathers 32 frames of a
//     token in a register and stores the word in the token's column,
//     [ceil(T_y/32)][W*32*K] words (41.5 KB for 381 x 861), in shared
//     memory after the ring, or in a global scratch buffer where they do
//     not fit beside it (the plan), then copied into the freed ring for the
//     walk where they fit there;
//   * the start count is a reduction over the scoring lanes of frame 0's
//     mask. It is exact in any order for the 0/1 masks the contract takes
//     (integers below 2^24 in fp32);
//   * the walk back runs on warp 0 (every lane alike, so its branches stay
//     uniform) and reads only the bit words: a word holds 32 frames of one
//     token, so a token visited takes one word, the frame where the walk
//     moves down found by a count of leading zeros; it records each token's
//     first frame in the freed ring;
//   * then the block writes the path's ones, mask[x, j] at each frame's
//     token x, a frame a thread (x by a binary search of those first
//     frames): the only mask reads after the forward pass.
//   One launch a call. The wrapper's plan (tts_tpu_torch/ops/mas.py,
//   ring_plan) picks K, W, P, F, S, the padded row and where the bits go.
//
// mas_columns_kernel, the first design (texts longer than the ring kernel
// takes, any value and mask types): one block an item, a thread a token
// (several passes a frame above 1024 tokens), the scores in shared memory,
// a block barrier a frame, the bits made by __ballot_sync [T_y][T_x/32],
// value and mask read in place through their strides a column a frame
// (each element its own 32-byte sector, the next 7 frames from L1), the
// path zeroed by the block, then one thread walking back through global
// loads of the mask.
//
// Both take an optional stamps buffer: block 0 then records clock64 and
// %globaltimer at the boundaries of its parts (scripts/k2_probes.py,
// chip_smoke.py phase 21).
//
// Measured: see PERF.md (chip_smoke.py phase 21, scripts/k2_probes.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;  // the JAX package's _NEG, exact in fp32
constexpr int kMaxThreads = 1024;  // the columns kernel
constexpr int kRingThreads = 384;  // the ring kernel's bound: W + P <= 12 warps
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(uint8_t v) { return v ? 1.0f : 0.0f; }  // bool

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

// ---- shared-memory plumbing --------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];" : "=l"(state) : "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// the barrier's phase completes (as one of its counted arrivals) once every
// cp.async this thread issued before has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}
// 4 bytes into shared memory; on an L2 miss the L2 fetches the 256 bytes
// around them, so the next tiles of the same row find them there
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global.L2::256B [%0], [%1], 4;" ::"r"(dst), "l"(src)
               : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// zero bytes [lo, hi) of p, the threads of a group each taking its share
__device__ __forceinline__ void zero_bytes(char* p, size_t lo, size_t hi, int t, int n) {
  if (lo >= hi) return;
  char* a = p + lo;
  const size_t len = hi - lo;
  size_t head = (16 - (reinterpret_cast<uintptr_t>(a) & 15)) & 15;
  if (head > len) head = len;
  const size_t quads = (len - head) >> 4;
  for (size_t i = t; i < head; i += n) a[i] = 0;
  uint4* q = reinterpret_cast<uint4*>(a + head);
  for (size_t i = t; i < quads; i += n) q[i] = make_uint4(0, 0, 0, 0);
  for (size_t i = head + (quads << 4) + t; i < len; i += n) a[i] = 0;
}

// =========================================================================
// The ring kernel
// =========================================================================

struct RingArgs {
  const float* value;  // [B, T_x, T_y] through vs
  const float* mask;   // [B, T_x, T_y] through ms
  void* path;          // [B, T_x, T_y] contiguous, fp32 (out_bf16 = 0) or bf16
  uint32_t* bits;      // scratch [B][words][slots] when the bits are not in shared memory
  long long* stamps;   // null, or 16 words for block 0's clock64 / globaltimer stamps
  long long vsb, vsx, vsy, msb, msx, msy;
  int T_x, T_y;
  int W, P, F, S, pad;  // scoring warps, copying warps, frames a tile, tiles, padded row
  int bits_shared, bits_copied, out_bf16;
};

// The layout of the dynamic shared memory, from the plan: the same sums as
// _smem_bytes and ring_plan's bits_copied in tts_tpu_torch/ops/mas.py.
struct RingLayout {
  int bars, edge, count, ring, walk_bytes, bits, total;  // byte offsets, sizes
  __host__ __device__ RingLayout(int W, int S, int F, int pad, int slots, int T_x, int T_y,
                                 int bits_shared) {
    bars = 0;                           // full[S], empty[S]: 8 bytes each
    edge = 16 * S;                      // 8 x W floats: the warps' last scores
    count = edge + 32 * W;              // W floats: frame 0's mask sums
    ring = (count + 4 * W + 15) & ~15;  // S x (value, mask) x F x pad floats; after the
    walk_bytes = (4 * (T_x + 2) + 15) & ~15;  // forward pass 2 + T_x ints, then any bits
    bits = ring + S * 2 * F * pad * 4;  // ceil(T_y/32) x slots words
    total = bits + (bits_shared ? ((T_y + 31) >> 5) * slots * 4 : 0);
  }
};

constexpr int kChunk = 8;  // frames a scoring warp runs without a branch; tiles hold a multiple

// The state of a scoring thread.
template <int K>
struct Scorer {
  float v[K];        // scores of this lane's tokens after the last frame
  uint32_t acc[K];   // direction bits of the current 32 frames
  const float* row;  // the value row, at this lane's slot, of the first frame of the chunk
  int s, ph;         // its ring tile, the parity of that tile's round
};

// Everything a scoring thread reads but does not change.
struct ScoreCtx {
  const float* ring;
  float* edge;     // [8][W]: the scoring warps' last scores, a row a frame mod 8
  uint32_t* bits;  // [ceil(T_y/32)][slots] words
  int moff;        // floats from a tile's value rows to its mask rows
  int slots, slot0, x0, w, lane;
  uint32_t bar0;
};

// One cell: from the scores v (token x) and v0 (token x-1) of the last
// frame, the new score (v >= v0 ? v : v0) + val, each operation rounded on
// its own; the direction bit (stay, or forced outside the mask: !(m > 0))
// or'ed into acc by one predicated instruction.
__device__ __forceinline__ float cell(float v, float v0, float val, float m, uint32_t bit,
                                      uint32_t& acc) {
  float r;
  asm("{\n .reg .pred s, d;\n .reg .f32 t;\n"
      " setp.ge.f32 s, %2, %3;\n"
      " selp.f32 t, %2, %3, s;\n"
      " add.rn.f32 %0, t, %4;\n"
      " setp.leu.or.f32 d, %5, 0f00000000, s;\n"
      " @d or.b32 %1, %1, %6;\n}"
      : "=f"(r), "+r"(acc)
      : "f"(v), "f"(v0), "f"(val), "f"(m), "r"(bit));
  return r;
}

template <int K>
__device__ __forceinline__ void load_frame(const float* row, int moff, float (&v)[K],
                                           float (&m)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = row[32 * k];
    m[k] = row[moff + 32 * k];
  }
}

// The scores of frame j from its value and mask (cv, cm). CHECK: some token
// may lie past the frame. MULTI: several scoring warps, whose first lanes
// take the previous warp's last score through shared memory.
template <int K, bool CHECK, bool MULTI>
__device__ __forceinline__ void score_cells(Scorer<K>& st, int j, const float (&cv)[K],
                                            const float (&cm)[K], const RingArgs& a,
                                            const ScoreCtx& c) {
  const uint32_t bit = 1u << (j & 31);
  const int ahead = c.x0 - j;  // token x0 + k lies past the frame when ahead + k > 0
  float up = __shfl_up_sync(kFull, st.v[K - 1], 1);  // v[x-1] of this lane's first token
  if (c.lane == 0) up = kNeg;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    if (MULTI && k == 0) {  // this frame's last score out, the previous warp's in
      if (c.lane == 31) c.edge[((j + 1) & 7) * a.W + c.w] = st.v[K - 1];
      named_sync(1, 32 * a.W);
      if (c.lane == 0 && c.w > 0) up = c.edge[(j & 7) * a.W + c.w - 1];
    }
    float r = cell(st.v[k], k ? st.v[k - 1] : up, __fmul_rn(cv[k], cm[k]), cm[k], bit,
                   st.acc[k]);
    if (CHECK && ahead + k > 0) r = kNeg;
    st.v[k] = r;
  }
}

// The 32 frames' bits of each token to its column (token order: the walk
// steps from column x to x-1); once every 32 frames, so the lanes' K-word
// stride costs little.
template <int K>
__device__ __forceinline__ void store_bits(Scorer<K>& st, int j, const ScoreCtx& c) {
  uint32_t* p = c.bits + (size_t)(j >> 5) * c.slots + c.x0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    p[k] = st.acc[k];
    st.acc[k] = 0;
  }
}

// Frames j .. j+7 (j a multiple of 8, all in the current tile; A holds
// frame j's value and mask), prefetching each next frame into the other
// buffer; the last prefetch (frame j+8, when there is one) may cross into
// the next tile: this one is freed and that one awaited. A then holds
// frame j+8.
template <int K, bool CHECK, bool MULTI>
__device__ __forceinline__ void score_chunk(Scorer<K>& st, int j, float (&av)[K],
                                            float (&am)[K], float (&bv)[K], float (&bm)[K],
                                            const RingArgs& a, const ScoreCtx& c) {
#pragma unroll
  for (int f = 0; f < kChunk; f += 2) {
    load_frame<K>(st.row + (f + 1) * a.pad, c.moff, bv, bm);
    score_cells<K, CHECK, MULTI>(st, j + f, av, am, a, c);
    if (f + 2 < kChunk) {
      load_frame<K>(st.row + (f + 2) * a.pad, c.moff, av, am);
    } else if (j + kChunk < a.T_y) {
      if (((j + kChunk) & (a.F - 1)) == 0) {  // the next chunk starts the next tile
        mbar_arrive(c.bar0 + 8 * (a.S + st.s));  // empty[s]: done with this one
        if (++st.s == a.S) {
          st.s = 0;
          st.ph ^= 1;
        }
        mbar_wait(c.bar0 + 8 * st.s, st.ph);  // full[s]
        st.row = c.ring + (size_t)st.s * 2 * c.moff + c.slot0;
      } else {
        st.row += kChunk * a.pad;
      }
      load_frame<K>(st.row, c.moff, av, am);
    }
    score_cells<K, CHECK, MULTI>(st, j + f + 1, bv, bm, a, c);
  }
  if (((j + kChunk) & 31) == 0 || j + kChunk == a.T_y) store_bits<K>(st, j, c);
}

template <int K, bool MULTI>
__device__ __forceinline__ void score(const RingArgs& a, const ScoreCtx& c, float* count) {
  Scorer<K> st;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    st.v[k] = 0.0f;
    st.acc[k] = 0;
  }
  st.row = c.ring + c.slot0;
  st.s = 0;
  st.ph = 0;
  float av[K], am[K], bv[K], bm[K];
  mbar_wait(c.bar0, 0);  // full[0]
  load_frame<K>(st.row, c.moff, av, am);
  float n = 0.0f;  // frame 0's mask over this lane's tokens: the start count
#pragma unroll
  for (int k = 0; k < K; ++k) n += c.x0 + k < a.T_x ? am[k] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
  if (c.lane == 0) count[c.w] = n;
  const int whole = a.T_y & ~(kChunk - 1);
  int j = 0;
  for (; j < whole; j += kChunk) {
    if (j < a.T_x - 1)  // frames before T_x - 1 hold tokens past the frame
      score_chunk<K, true, MULTI>(st, j, av, am, bv, bm, a, c);
    else
      score_chunk<K, false, MULTI>(st, j, av, am, bv, bm, a, c);
  }
  if (j < a.T_y) {  // the last frames, fewer than a chunk, in the current tile
    for (int f = 0; j + f < a.T_y; ++f) {
      if (f > 0) load_frame<K>(st.row + f * a.pad, c.moff, av, am);
      score_cells<K, true, MULTI>(st, j + f, av, am, a, c);
    }
    store_bits<K>(st, a.T_y - 1, c);
  }
}

// The copying warps: tile t of frames [t F, t F + F) into ring tile t % S,
// once the scoring warps have freed it; a slice of the path zeroed a tile.
// A copying thread keeps one frame offset f0 and one scoring lane l of a
// block of `group` lanes, and walks that lane's K tokens (rows vsx apart,
// slots 32 apart): a copy instruction reads `run` consecutive frames of
// `group` rows.
template <int K>
__device__ __forceinline__ void copy_tiles(const RingArgs& a, float* ring, int b,
                                           uint32_t bar0) {
  const int t0 = threadIdx.x - 32 * a.W;  // 0 .. 32 P - 1
  const int lane = t0 & 31, pw = t0 >> 5;
  const int run = a.F < 32 ? a.F : 32;
  const int group = 32 / run;
  const int f0 = lane % run, d = lane / run;
  const int blocks = a.W * run;  // (scoring warp, block of `group` lanes) pairs
  const float* vb = a.value + b * a.vsb;
  const float* mb = a.mask + b * a.msb;
  const int tiles = (a.T_y + a.F - 1) / a.F;
  const size_t out_bytes = (size_t)a.T_x * a.T_y * (a.out_bf16 ? 2 : 4);
  char* out = static_cast<char*>(a.path) + (size_t)b * out_bytes;
  const size_t slice = ((out_bytes + tiles - 1) / tiles + 15) & ~(size_t)15;
  const uint32_t ring0 = smem_addr(ring);
  const uint32_t moff = (uint32_t)(a.F * a.pad * 4);
  for (int t = 0; t < tiles; ++t) {
    const int s = t % a.S, round = t / a.S;
    if (round > 0) mbar_wait(bar0 + 8 * (a.S + s), (round - 1) & 1);  // empty[s]
    const int j0 = t * a.F;
    const int frames = a.T_y - j0 < a.F ? a.T_y - j0 : a.F;
    const uint32_t tile = ring0 + 2 * (uint32_t)s * moff;
    for (int p = pw; p < blocks; p += a.P) {
      const int w = p / run, l = (p - w * run) * group + d;
      const int x0 = (w * 32 + l) * K;  // this lane's first token
      const int kn = a.T_x - x0 < K ? a.T_x - x0 : K;
      if (kn <= 0) continue;
      const float* pv = vb + x0 * a.vsx + (long long)(j0 + f0) * a.vsy;
      const float* pm = mb + x0 * a.msx + (long long)(j0 + f0) * a.msy;
      uint32_t dst = tile + (uint32_t)((f0 * a.pad + w * 32 * K + l) * 4);
      for (int f = f0; f < frames; f += run) {
        const float* qv = pv;
        const float* qm = pm;
        if (kn == K) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            cp_async4(dst + 128 * k, qv);
            cp_async4(dst + 128 * k + moff, qm);
            qv += a.vsx;
            qm += a.msx;
          }
        } else {  // the text ends inside this lane's tokens
          for (int k = 0; k < kn; ++k) {
            cp_async4(dst + 128 * k, qv);
            cp_async4(dst + 128 * k + moff, qm);
            qv += a.vsx;
            qm += a.msx;
          }
        }
        pv += run * a.vsy;
        pm += run * a.msy;
        dst += (uint32_t)(run * a.pad * 4);
      }
    }
    cp_async_arrive(bar0 + 8 * s);  // full[s], once this thread's copies land
    const size_t lo = (size_t)t * slice;
    zero_bytes(out, lo < out_bytes ? lo : out_bytes, lo + slice < out_bytes ? lo + slice : out_bytes,
               t0, 32 * a.P);
  }
}

// The walk back from token top at the last frame, through the direction
// bits [ceil(T_y/32)][slots] (a word: 32 frames of one token): lo[x] gets
// the first frame of each token on the path. A word read finds the frame
// where the walk moves down with a count of leading zeros, so a token
// visited takes one word (and 32 frames without a move one more). A step
// has one branch, its exit: on the card a branch waits ~13 cycles for its
// predicate. Returns the lowest token with frames (the walk ends at frame
// 0 or past token 0).
template <typename Bits>
__device__ __forceinline__ int walk_back(Bits bits, int top, int slots, int T_y,
                                         int* __restrict__ lo) {
  int x = top, j = T_y - 1;
  while (true) {
    const uint32_t word = bits[(size_t)(j >> 5) * slots + x];
    // frames (j & ~31) .. j of token x where the walk moves down (direction 0)
    const uint32_t down = ~word & (kFull >> (31 - (j & 31)));
    const int f = (j & ~31) + 31 - __clz(down);  // (j & ~31) - 1 when none does
    const int moved = down != 0;
    // 32 frames without a move leave f = their first - 1 here, replaced by
    // a later step; at frame 0 they leave 0
    lo[x] = max(f, 0);
    if (f <= 0 || (moved && x == 0)) return x;
    x -= moved;
    j = f - moved;
  }
}

template <int K, bool MULTI>
__global__ void __launch_bounds__(kRingThreads, 1) mas_ring_kernel(const RingArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int slots = a.W * 32 * K;
  const RingLayout lay(a.W, a.S, a.F, a.pad, slots, a.T_x, a.T_y, a.bits_shared);
  const uint32_t bar0 = smem_addr(smem + lay.bars);
  float* edge = reinterpret_cast<float*>(smem + lay.edge);
  float* count = reinterpret_cast<float*>(smem + lay.count);
  float* ring = reinterpret_cast<float*>(smem + lay.ring);
  const int words = (a.T_y + 31) >> 5;
  uint32_t* bits = a.bits_shared ? reinterpret_cast<uint32_t*>(smem + lay.bits)
                                 : a.bits + (size_t)b * words * slots;
  const bool probe = a.stamps && b == 0;
  long long c0 = 0, g0 = 0;
  if (probe) {
    c0 = clock64();  // the SM's counter: every thread's start is within a few cycles
    g0 = global_ns();
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.S; ++s) {
      mbar_init(bar0 + 8 * s, 32 * a.P);           // full: one arrival a copying thread
      mbar_init(bar0 + 8 * (a.S + s), 32 * a.W);   // empty: one a scoring thread
    }
  }
  for (int i = threadIdx.x; i < 8 * a.W; i += blockDim.x) edge[i] = 0.0f;  // frame -1's scores
  __syncthreads();

  // ---- the forward pass ---------------------------------------------------
  if (threadIdx.x < 32 * a.W) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const ScoreCtx c{ring, edge, bits, a.F * a.pad, slots, w * 32 * K + lane, (w * 32 + lane) * K,
                     w, lane, bar0};
    score<K, MULTI>(a, c, count);
    if (probe && threadIdx.x == 0) a.stamps[1] = clock64() - c0;
  } else {
    copy_tiles<K>(a, ring, b, bar0);
    if (probe && threadIdx.x == 32 * a.W) a.stamps[2] = clock64() - c0;
  }
  __syncthreads();  // the bits, the counts and the path's zeros are all written
  if (probe && threadIdx.x == 0) a.stamps[3] = clock64() - c0;

  // ---- the walk back ------------------------------------------------------
  // In the freed ring: the top and the lowest token of the path, then
  // lo[x], the first frame of token x on it; then any scratch bits.
  int* span = reinterpret_cast<int*>(ring);
  int* lo = span + 2;
  // the bits in shared memory (after the ring, or copied into it)
  const uint32_t* shared_bits =
      reinterpret_cast<const uint32_t*>(smem + (a.bits_copied ? lay.ring + lay.walk_bytes : lay.bits));
  if (a.bits_copied) {
    for (int i = threadIdx.x; i < words * slots; i += blockDim.x)
      cp_async4(smem_addr(shared_bits + i), bits + i);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
  }
  if (threadIdx.x < 32) {  // warp 0, every lane alike: its branches stay uniform
    if (probe && threadIdx.x == 0) a.stamps[4] = clock64() - c0;
    float n = 0.0f;
    for (int w = 0; w < a.W; ++w) n = __fadd_rn(n, count[w]);
    const int top = (int)n - 1;  // truncated, as astype(int32)
    int low = 0;
    if (top >= 0 && top < a.T_x) {
      if (a.bits_shared || a.bits_copied)  // known to be shared: the loads are LDS
        low = walk_back(shared_bits, top, slots, a.T_y, lo);
      else
        low = walk_back(static_cast<const uint32_t*>(bits), top, slots, a.T_y, lo);
    }
    if (threadIdx.x == 0) {
      span[0] = top >= 0 && top < a.T_x ? top : -1;  // -1: no token, the path stays zero
      span[1] = low;
      if (probe) a.stamps[5] = clock64() - c0;
    }
  }
  __syncthreads();

  // ---- the path's ones: mask[x, j] at each frame's token -------------------
  // A thread takes frames tid, tid + blockDim, ...: eight at once, each
  // token found by a binary search of lo[low .. top] (lo rises with x), the
  // eight mask loads in flight together.
  const int top = span[0], low = span[1];
  if (top >= 0) {
    const float* mb = a.mask + b * a.msb;
    const size_t cells = (size_t)a.T_x * a.T_y;
    const int first = lo[low];  // frames before it lie past the walk's end
    for (int j0 = threadIdx.x; j0 < a.T_y; j0 += 8 * blockDim.x) {
      int xs[8];
      float ms[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = j0 + u * blockDim.x;
        int x = -1;
        if (j < a.T_y && j >= first) {
          int l = low, h = top;  // the last x with lo[x] <= j
          while (l < h) {
            const int mid = (l + h + 1) >> 1;
            if (lo[mid] <= j)
              l = mid;
            else
              h = mid - 1;
          }
          x = l;
        }
        xs[u] = x;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (xs[u] >= 0) ms[u] = mb[xs[u] * a.msx + (long long)(j0 + u * blockDim.x) * a.msy];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (xs[u] < 0) continue;
        const size_t at = (size_t)b * cells + (size_t)xs[u] * a.T_y + j0 + u * blockDim.x;
        if (a.out_bf16)
          static_cast<__nv_bfloat16*>(a.path)[at] = __float2bfloat16_rn(ms[u]);
        else
          static_cast<float*>(a.path)[at] = ms[u];
      }
    }
  }
  if (probe) {
    __syncthreads();
    if (threadIdx.x == 0) {
      a.stamps[6] = clock64() - c0;
      a.stamps[7] = global_ns() - g0;
      a.stamps[0] = 1;  // the ring kernel
    }
  }
}

template <int K>
cudaError_t launch_ring(const RingArgs& a, int B, int smem_bytes, cudaStream_t st) {
  auto kernel = a.W > 1 ? mas_ring_kernel<K, true> : mas_ring_kernel<K, false>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, 32 * (a.W + a.P), smem_bytes, st>>>(a);
  return cudaGetLastError();
}

// =========================================================================
// The columns kernel (texts longer than the ring kernel takes)
// =========================================================================

// dirs_global: [B][T_y][words] scratch, or null to keep the bits in dynamic
// shared memory after the scores.
template <typename TV, typename TM>
__global__ void __launch_bounds__(kMaxThreads)
    mas_columns_kernel(const TV* __restrict__ value, const TM* __restrict__ mask,
                       TV* __restrict__ path, uint32_t* __restrict__ dirs_global,
                       long long* stamps, int T_x, int T_y, long long vsb, long long vsx,
                       long long vsy, long long msb, long long msx, long long msy) {
  extern __shared__ uint32_t smem_cols[];
  const int b = blockIdx.x;
  const int words = (T_x + 31) >> 5;
  float* scores = reinterpret_cast<float*>(smem_cols);  // [2][T_x]
  uint32_t* dirs = dirs_global ? dirs_global + (size_t)b * T_y * words : smem_cols + 2 * T_x;
  const TV* vb = value + b * vsb;
  const TM* mb = mask + b * msb;
  TV* pb = path + (size_t)b * T_x * T_y;
  const int lane = threadIdx.x & 31;
  const int passes = (T_x + blockDim.x - 1) / blockDim.x;
  const bool probe = stamps && b == 0 && threadIdx.x == 0;
  long long c0 = 0, g0 = 0;
  if (probe) {
    c0 = clock64();
    g0 = global_ns();
  }

  for (int x = threadIdx.x; x < T_x; x += blockDim.x) scores[x] = 0.0f;
  __syncthreads();

  // ---- forward pass over the frames --------------------------------------
  for (int j = 0; j < T_y; ++j) {
    const float* old = scores + (j & 1) * T_x;
    float* cur = scores + ((j & 1) ^ 1) * T_x;
    for (int p = 0; p < passes; ++p) {
      const int x = p * blockDim.x + threadIdx.x;
      bool stay = true;
      if (x < T_x) {
        const float m = to_f32(mb[x * msx + j * msy]);
        const float val = __fmul_rn(to_f32(vb[x * vsx + j * vsy]), m);
        const float v = old[x];
        const float v0 = x > 0 ? old[x - 1] : kNeg;
        const bool s = v >= v0;
        cur[x] = x <= j ? __fadd_rn(s ? v : v0, val) : kNeg;
        stay = s || !(m > 0.0f);
      }
      const uint32_t word = __ballot_sync(kFull, stay);
      if (lane == 0 && x < T_x) dirs[(size_t)j * words + (x >> 5)] = word;
    }
    __syncthreads();
  }
  if (probe) stamps[1] = clock64() - c0;

  // ---- the path: zeros, then the walk back -------------------------------
  const long long cells = (long long)T_x * T_y;
  const TV zero = from_f32<TV>(0.0f);
  for (long long i = threadIdx.x; i < cells; i += blockDim.x) pb[i] = zero;
  __syncthreads();
  if (threadIdx.x == 0) {
    if (probe) stamps[2] = clock64() - c0;
    float count = 0.0f;  // sum(mask[:, 0]), in token order
    for (int x = 0; x < T_x; ++x) count = __fadd_rn(count, to_f32(mb[x * msx]));
    int x = (int)count - 1;  // truncated, as astype(int32)
    if (probe) stamps[3] = clock64() - c0;
    for (int j = T_y - 1; j >= 0 && x >= 0; --j) {
      pb[(long long)x * T_y + j] = from_f32<TV>(to_f32(mb[x * msx + j * msy]));
      const uint32_t word = dirs[(size_t)j * words + (x >> 5)];
      x += (int)((word >> (x & 31)) & 1u) - 1;
    }
    if (probe) {
      stamps[4] = clock64() - c0;
      stamps[7] = global_ns() - g0;
      stamps[0] = 2;  // the columns kernel
    }
  }
}

template <typename TV, typename TM>
cudaError_t launch_columns(const void* value, const void* mask, void* path, void* scratch,
                           long long* stamps, int B, int T_x, int T_y, const long long* vs,
                           const long long* ms, cudaStream_t st) {
  const int words = (T_x + 31) >> 5;
  size_t smem = 2 * (size_t)T_x * sizeof(float);
  if (!scratch) smem += (size_t)T_y * words * sizeof(uint32_t);
  auto kernel = mas_columns_kernel<TV, TM>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // a hint: as little shared memory as the launch needs, the rest of the
  // SM's 256 KB as L1, which serves the strided column reads
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxL1);
  if (err != cudaSuccess) return err;
  int threads = ((T_x + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  kernel<<<B, threads, smem, st>>>(static_cast<const TV*>(value), static_cast<const TM*>(mask),
                                   static_cast<TV*>(path), static_cast<uint32_t*>(scratch),
                                   stamps, T_x, T_y, vs[0], vs[1], vs[2], ms[0], ms[1], ms[2]);
  return cudaGetLastError();
}

template <typename TV>
cudaError_t launch_columns_mask(int mask_type, const void* value, const void* mask, void* path,
                                void* scratch, long long* stamps, int B, int T_x, int T_y,
                                const long long* vs, const long long* ms, cudaStream_t st) {
  switch (mask_type) {
    case 0:
      return launch_columns<TV, float>(value, mask, path, scratch, stamps, B, T_x, T_y, vs, ms,
                                       st);
    case 1:
      return launch_columns<TV, __nv_bfloat16>(value, mask, path, scratch, stamps, B, T_x, T_y,
                                               vs, ms, st);
    case 2:
      return launch_columns<TV, uint8_t>(value, mask, path, scratch, stamps, B, T_x, T_y, vs,
                                         ms, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block may opt into on `device`.
int tts_maximum_path_shared_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return 0;
  return bytes;
}

// The ring kernel. path [B, T_x, T_y] (contiguous; fp32, or bf16 when
// out_bf16) = MAS of fp32 value and mask [B, T_x, T_y], read through their
// element strides vs / ms (batch, token, frame). plan: {K, W, P, F, S, pad,
// bits_shared, bits_copied, smem_bytes} from the wrapper's ring_plan.
// bits: B * ceil(T_y/32) * W*32*K words when not bits_shared, else null;
// stamps: null or 16 int64 on the device. Launches on
// `stream`; returns cudaGetLastError() after the launch.
int tts_maximum_path(const float* value, const float* mask, void* path, void* bits,
                     long long* stamps, int B, int T_x, int T_y, const long long* vs,
                     const long long* ms, const int* plan, int out_bf16, int device,
                     void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int K = plan[0], W = plan[1], P = plan[2], F = plan[3], S = plan[4], pad = plan[5];
  const int bits_shared = plan[6], bits_copied = plan[7], smem_bytes = plan[8];
  if (B < 1 || T_x < 1 || T_y < 1 || W < 1 || P < 1 || W + P > kRingThreads / 32 || S < 1 ||
      F < kChunk || (F & (F - 1)) || F > 32 || pad < W * 32 * K || (!bits_shared && !bits))
    return (int)cudaErrorInvalidValue;
  const RingLayout lay(W, S, F, pad, W * 32 * K, T_x, T_y, bits_shared);
  if (T_x > W * 32 * K || lay.total != smem_bytes ||
      (bits_copied && lay.walk_bytes + ((T_y + 31) >> 5) * W * 32 * K * 4 > lay.bits - lay.ring))
    return (int)cudaErrorInvalidValue;
  RingArgs a{value, mask, path, static_cast<uint32_t*>(bits), stamps,
             vs[0], vs[1], vs[2], ms[0], ms[1], ms[2], T_x, T_y, W, P, F, S, pad,
             bits_shared, bits_copied, out_bf16};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (K) {
    case 2: return (int)launch_ring<2>(a, B, smem_bytes, st);
    case 3: return (int)launch_ring<3>(a, B, smem_bytes, st);
    case 4: return (int)launch_ring<4>(a, B, smem_bytes, st);
    case 6: return (int)launch_ring<6>(a, B, smem_bytes, st);
    case 8: return (int)launch_ring<8>(a, B, smem_bytes, st);
    case 12: return (int)launch_ring<12>(a, B, smem_bytes, st);
    case 16: return (int)launch_ring<16>(a, B, smem_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The columns kernel: the same contract for any value type (0 fp32, 1
// bf16) and mask type (0 fp32, 1 bf16, 2 bool); scratch: null (the bits in
// shared memory) or B * T_y * ceil(T_x / 32) words.
int tts_maximum_path_columns(const void* value, const void* mask, void* path, void* scratch,
                             long long* stamps, int B, int T_x, int T_y, const long long* vs,
                             const long long* ms, int value_type, int mask_type, int device,
                             void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || T_x < 1 || T_y < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (value_type == 0)
    err = launch_columns_mask<float>(mask_type, value, mask, path, scratch, stamps, B, T_x, T_y,
                                     vs, ms, st);
  else if (value_type == 1)
    err = launch_columns_mask<__nv_bfloat16>(mask_type, value, mask, path, scratch, stamps, B,
                                             T_x, T_y, vs, ms, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* tts_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

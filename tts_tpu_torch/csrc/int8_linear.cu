// K4: weight-only int8 linear (W8A16) for Hopper (sm_90a).
//
// y[M, N] = (x[M, K] . q[N, K]^T) * scale[N] (+ bias[N]): x fp32 or bf16 (the
// model's working type; rows may be strided, the last dim is contiguous), q
// int8 with each output channel's K bytes contiguous, scale fp32, the sum in
// fp32, y in x's type.
//
// K4 replaces no Pallas kernel. The JAX package stores the int8 weights and
// dequantizes them inside its jitted steps (tts_tpu/ops/quant.py:56,
// maybe_dequantize :103), where XLA fuses convert(int8) * scale into the
// consuming dot, so the weights stream from device memory as int8. Eager
// PyTorch does not fuse: dequantize + F.linear would read 3x the int8 bytes
// and build a float copy of every weight at every decode step. K4 is that
// fusion written out.
//
// Three kernels; the host function picks one by M, K and q's alignment
// ("vec": K % 16 == 0 and q on 16 bytes):
//
//   * k4_gemv, M = 1 with vec (a decode step at one stream: bf16 in XTTS,
//     fp32 in Bark), and fp32 with M K <= 4096 (M <= 4 at K = 1024, where it
//     measured 0.5-1.2 us under k4_skinny; no served path has such M). Bound
//     by the N * K weight bytes (3.1 MB for a 1024 x 3072 c_attn, 0.94 us at
//     3.35 TB/s), at this size by latency. CUDA cores: a warp owns R output
//     channels, each lane loads 16 weight bytes at a time, 4 loads in
//     flight, and rereads the block's staged rows (as fp32) for every 16 k
//     of each channel, which makes it grow with M; int8 -> fp32 is exact by
//     placing the byte, its sign flipped, in the mantissa of 2^23 (one
//     byte_perm and one add). Its other instances (M up to 16) are the
//     "gemv" variant, timed beside k4_skinny by chip_smoke.py.
//
//   * k4_skinny, 2 <= M <= 16 with vec (XTTS at 2-4 streams, Tortoise's 16
//     candidates). Bound by the weight bytes. Tensor cores,
//     mma.sync.m16n8k16 bf16 with fp32 sums, the weight as the wide operand:
//     A (16 output channels x 16 k) comes straight from a lane's 16-byte
//     global loads, converted to bf16 in registers (int8 is exact in bf16),
//     and x's rows are the narrow operand B (n = 8 columns a tile). K is
//     permuted inside each 64-wide chunk so that the 16 bytes a lane loads
//     are exactly its A fragments for 4 mma steps (lane (g, t) loads k 16t
//     .. 16t+15 of channels g and g+8); B is read from shared memory under the
//     same permutation. x is staged once a block as bf16 columns; fp32 x is
//     split exactly into three bf16 parts, hi = bf16(x), mid = bf16(x - hi),
//     lo = bf16(x - hi - mid), which sum to x (barring underflow below
//     ~2^-110 and overflow within 2^-8 of FLT_MAX): each part's products
//     with int8 are exact in fp32, so 3M columns give an fp32 product at
//     tensor-core rates. A block of 4 warps owns 64 channels; up to 4 chunks
//     of weight loads are in flight a warp, issued before x is staged. Each
//     64-k chunk's 4 mma steps start from zero and are added to the fp32
//     sums (round to nearest) once a chunk, which bounds the tensor cores'
//     truncating accumulation. K is cut across the blocks of a thread-block
//     cluster (1-8 along grid x): each block pushes its partial sums of the
//     channels another rank owns into that rank's shared memory
//     (distributed shared memory), one cluster barrier, then each rank sums
//     its slots in rank order and applies scale and bias. The barrier and
//     the pushes cost ~0.9 us of its ~6.0 us at M = 4 on an H100 (measured by
//     cutting them, scripts/k4_probes.py); the loads' latency and the launch
//     take the rest.
//
//   * k4_tile, everything else (M > 16: prefills, Bark's 513/887-row prompts
//     and 1024-frame fine windows; and any K or q alignment: the
//     conditioning encoders' K = 80, the perceiver's 2730, a sliced q).
//     Bound by the 2 M N K operations at large M (3x that in fp32, the same
//     exact split), by the weight bytes below ~300 rows. Tensor cores,
//     mma.sync.m16n8k16: a 64 (M) x 128 (N) output tile a block of 4 warps,
//     each warp 64 x 32; K in steps of 64 through a ring of 3 shared-memory
//     stages filled by cp.async (zero-filled past N, M and K; loads and
//     stores where rows do not lie on 16 bytes). Each warp converts its 32
//     channels' int8 bytes to bf16 as it builds its B fragments (each weight
//     byte once a block); x's A fragments come by ldmatrix, fp32 x split
//     once a block into three bf16 planes first. fp32 chains lo, mid, hi for
//     each 16 k and adds the result to the sums once. Where the tiles fill
//     less than one wave of the multiprocessors (prefills of a few dozen
//     rows, the perceiver's K = 2730), K is cut over a cluster of up to 8
//     blocks along grid z, reduced as in k4_skinny (partial rows pushed into
//     their owner's shared memory over its finished stages, between two
//     cluster barriers, summed in rank order). Measured with clock64 probes
//     (scripts/k4_probes.py) on an H100: a 64-k stage costs 450-750 cycles
//     of cp.async issue (the load path, not the wait) and 1200-1800 of the
//     rest at one warp a scheduler, so it reaches ~120-190 TFLOP/s in bf16
//     (mma.sync alone: ~620); TMA loads and more warps a tile are the next
//     step.
//
// mma.sync rather than wgmma: the weight needs converting in registers
// anyway (wgmma reads B from shared memory only), and mma.sync's fragment
// layout lets k4_skinny's global loads feed A with no shared-memory pass.
// Every kernel sums each output in a fixed order (no atomics; the cluster
// reduction runs over ranks in order): repeated calls give the same bits.
// None allocates; the wrapper owns every buffer. ptxas (sm_90a, nvcc 12.9,
// printed by chip_smoke.py's build phase): k4_gemv 40 (M = 1) to 139
// registers; k4_skinny 80-90 (bf16) and 80-136 (fp32) registers, 20 bytes
// spilled in the fp32 instances of 3 and 4 n-tiles; k4_tile 122 (bf16) and
// 159 (fp32) registers; all shared memory dynamic: k4_skinny up to 109 KB
// (fp32, 6 n-tiles), k4_tile 57 KB (bf16) and 111 KB (fp32).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------- helpers

template <typename T>
struct Parts {  // bf16 parts an activation is staged as
  static constexpr int value = 1;
};
template <>
struct Parts<float> {
  static constexpr int value = 3;  // hi, mid, lo
};

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The 4 signed bytes of w (lowest address first) as 4 exact floats: byte b,
// sign bit flipped, is b + 128 in 0..255; placed in the low mantissa byte
// of 2^23 it makes the float 2^23 + b + 128, from which 2^23 + 128 is taken.
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.0f;
}

// Two floats as a bf16x2 register, the first in the low half (the lower k
// index, as mma and memory order want it).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 4 signed bytes as two bf16x2 registers (bytes 0-1, bytes 2-3), exactly.
__device__ __forceinline__ void int8x4_to_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  float f[4];
  int8x4_to_float(w, f);
  lo = pack_bf16(f[0], f[1]);
  hi = pack_bf16(f[2], f[3]);
}

// v = hi + mid + lo exactly, each a bf16 value (returned as floats): each
// remainder is exact in fp32, and the last has at most 8 significant bits.
__device__ __forceinline__ void split3(float v, float& hi, float& mid, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(v));
  const float r = v - hi;
  mid = __bfloat162float(__float2bfloat16_rn(r));
  lo = r - mid;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ int swizzle(int c) { return c ^ ((c >> 3) & 3); }

template <typename T>
__device__ __forceinline__ void store_out(T* out, int N, int m, int n, float acc,
                                          const float* scale, const T* bias) {
  float y = acc * scale[n];
  if (bias != nullptr) y += to_float(bias[n]);
  out[(long long)m * N + n] = from_float<T>(y);
}

// d = a . b + c for one m16n8k16 tile: a 16 x 16 (row), b 16 x 8 (col),
// bf16 operands, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

// The cluster barrier in halves: arrive (relaxed, or releasing this
// thread's writes) and wait (acquiring the others').
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes global -> shared without registers; bytes past `valid` (0..16)
// are zero-filled, and none is read from global memory.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int valid) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(gmem), "r"(valid)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 8 activations x[m][k .. k+8) as Parts<T> bf16 uint4s (zeros past M or K):
// one 16-byte load (bf16) or two (fp32) where aligned and whole.
__device__ __forceinline__ void load_x8(const __nv_bfloat16* x, long long x_rs, int M, int K,
                                        int m, int k, bool xvec, uint4 (&o)[1]) {
  o[0] = make_uint4(0u, 0u, 0u, 0u);
  if (m >= M) return;
  const __nv_bfloat16* src = x + (long long)m * x_rs + k;
  if (xvec && k + 8 <= K) {
    o[0] = *reinterpret_cast<const uint4*>(src);
    return;
  }
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = k + i < K ? __bfloat16_as_ushort(src[i]) : 0u;
  o[0] = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16, h[6] | h[7] << 16);
}

// 8 floats (two float4) as their hi, mid and lo parts, 8 bf16 each.
__device__ __forceinline__ void split8(const float4& a, const float4& b, uint4 (&o)[3]) {
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t p[3][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float h0, m0, l0, h1, m1, l1;
    split3(v[2 * j], h0, m0, l0);
    split3(v[2 * j + 1], h1, m1, l1);
    p[0][j] = pack_bf16(h0, h1);
    p[1][j] = pack_bf16(m0, m1);
    p[2][j] = pack_bf16(l0, l1);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = make_uint4(p[i][0], p[i][1], p[i][2], p[i][3]);
}

__device__ __forceinline__ void load_x8(const float* x, long long x_rs, int M, int K, int m,
                                        int k, bool xvec, uint4 (&o)[3]) {
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = 0.0f;
  if (m < M) {
    const float* src = x + (long long)m * x_rs + k;
    if (xvec && k + 8 <= K) {
      const float4 a = reinterpret_cast<const float4*>(src)[0];
      const float4 b = reinterpret_cast<const float4*>(src)[1];
      split8(a, b, o);
      return;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (k + i < K) v[i] = src[i];
  }
  split8(make_float4(v[0], v[1], v[2], v[3]), make_float4(v[4], v[5], v[6], v[7]), o);
}

// 16 bytes of a row of x from element k, element by element (zeros past K,
// or everywhere if !ok): the path for rows that do not lie on 16 bytes.
__device__ __forceinline__ uint4 gather16(const __nv_bfloat16* row, int k, int K, bool ok) {
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = ok && k + i < K ? __bfloat16_as_ushort(row[k + i]) : 0u;
  return make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16, h[6] | h[7] << 16);
}
__device__ __forceinline__ uint4 gather16(const float* row, int k, int K, bool ok) {
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = ok && k + i < K ? __float_as_uint(row[k + i]) : 0u;
  return make_uint4(f[0], f[1], f[2], f[3]);
}

// ------------------------------------------------------------ k4_gemv (M = 1)

constexpr int kGemvWarps = 4;
constexpr int kStageFloats = 8192;  // 32 KB of staged activations a block
constexpr int kSmallM = 16;         // the largest M of k4_gemv and k4_skinny

// grid (ceil(N / (kGemvWarps * R)), ceil(M / MT)), kGemvWarps * 32 threads,
// MT * KC * 4 bytes of dynamic shared memory (KC: the K chunk, a multiple of
// 16, and of 512 when K is cut). The block stages its rows of x as fp32,
// float4 c stored at c ^ ((c >> 3) & 3) so that a quarter warp's reads hit 8
// distinct bank groups.
template <typename T, int MT, int R, int U>
__global__ void __launch_bounds__(kGemvWarps * 32)
k4_gemv(const T* __restrict__ x, long long x_rs, const int8_t* __restrict__ q,
        const float* __restrict__ scale, const T* __restrict__ bias, T* __restrict__ out,
        int M, int N, int K, int KC) {
  extern __shared__ float4 xs[];  // [MT][KC / 4], swizzled within each row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.x * kGemvWarps + warp) * R;
  const int m0 = blockIdx.y * MT;
  const int row4 = KC / 4;
  float acc[MT][R];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[m][r] = 0.0f;

  for (int kc0 = 0; kc0 < K; kc0 += KC) {
    const int klen = min(KC, K - kc0);  // a multiple of 16
    const int len4 = klen / 4;
    for (int i = threadIdx.x; i < MT * len4; i += kGemvWarps * 32) {
      const int m = i / len4, c = i - m * len4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (m0 + m < M) {
        const T* src = x + (long long)(m0 + m) * x_rs + kc0 + 4 * c;
        v = make_float4(to_float(src[0]), to_float(src[1]), to_float(src[2]), to_float(src[3]));
      }
      xs[m * row4 + swizzle(c)] = v;
    }
    __syncthreads();
    for (int k = lane * 16; k < klen; k += 512 * U) {
      uint4 w[U][R];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int kk = k + u * 512;
          w[u][r] = make_uint4(0, 0, 0, 0);
          if (n0 + r < N && kk < klen)
            w[u][r] = __ldg(reinterpret_cast<const uint4*>(q + (long long)(n0 + r) * K + kc0 + kk));
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = k + u * 512;
        if (kk < klen) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = kk / 4 + j;
            float f[R][4];
#pragma unroll
            for (int r = 0; r < R; ++r) int8x4_to_float(word(w[u][r], j), f[r]);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float4 xv = xs[m * row4 + swizzle(c)];
#pragma unroll
              for (int r = 0; r < R; ++r)
                acc[m][r] += f[r][0] * xv.x + f[r][1] * xv.y + f[r][2] * xv.z + f[r][3] * xv.w;
            }
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v = acc[m][r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[m][r] = v;
    }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (m0 + m < M && n0 + r < N) store_out(out, N, m0 + m, n0 + r, acc[m][r], scale, bias);
  }
}

// ------------------------------------------------------- k4_skinny (M <= 16)

constexpr int kSkinnyWarps = 4;
constexpr int kSkinnyRows = 16 * kSkinnyWarps;  // output channels a block
constexpr int kChunk = 64;                      // k a warp takes per step: 4 mma of depth 16
constexpr int kSkinnyLoads = 4;                 // chunks of weight loads in flight a warp
constexpr int kSkinnyMaxStage = 1024;           // k values of x staged a round
constexpr int kMaxCluster = 8;

// 16 weight bytes of channel n at k (k % 16 == 0 and K % 16 == 0, q on 16
// bytes), zeros past N or K.
__device__ __forceinline__ uint4 load_w16(const int8_t* q, int N, int K, int n, int k) {
  return n < N && k < K ? __ldg(reinterpret_cast<const uint4*>(q + (long long)n * K + k))
                        : make_uint4(0u, 0u, 0u, 0u);
}

// grid (cluster size, ceil(N / 64)) with clusters (cluster size, 1, 1),
// kSkinnyWarps * 32 threads. NT: n-tiles of 8 columns, the columns being
// x's M rows (bf16) or the hi, mid and lo parts of each (fp32: column
// p * M + m). KS: the k values staged a round (a multiple of 64). Dynamic
// shared memory: the staged columns [NT * 8][KS + 8] bf16, then the
// partial sums this block receives [cluster size][NT * 8][64 / cluster
// size] fp32.
template <typename T, int NT>
__global__ void __launch_bounds__(kSkinnyWarps * 32)
k4_skinny(const T* __restrict__ x, long long x_rs, const int8_t* __restrict__ q,
          const float* __restrict__ scale, const T* __restrict__ bias, T* __restrict__ out,
          int M, int N, int K, int KS, bool xvec) {
  constexpr int P = Parts<T>::value;
  constexpr int kCols = NT * 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* recv = reinterpret_cast<float*>(smem + kCols * (KS + 8) * 2);
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // this block has started: the others may write into it

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nb = blockIdx.y * kSkinnyRows;
  const int n_lo = nb + warp * 16 + g, n_hi = n_lo + 8;  // this lane's two weight rows
  const int rank = blockIdx.x, ranks = gridDim.x;       // the block's place in its cluster
  const int nch = (K + kChunk - 1) / kChunk;
  const int c_begin = (int)((long long)nch * rank / ranks);
  const int c_end = (int)((long long)nch * (rank + 1) / ranks);
  const int pitch = KS + 8;  // bf16 elements a staged column: 16 bytes over 128, no bank conflicts
  const int chunks_a_round = KS / kChunk;

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int s0 = c_begin; s0 < c_end; s0 += chunks_a_round) {
    const int s1 = min(c_end, s0 + chunks_a_round);
    // the first chunks' weights in flight before x is staged
    uint4 wl[kSkinnyLoads], wh[kSkinnyLoads];
#pragma unroll
    for (int u = 0; u < kSkinnyLoads; ++u) {
      const int k = (s0 + u) * kChunk + 16 * t;
      const bool in = s0 + u < s1;
      wl[u] = in ? load_w16(q, N, K, n_lo, k) : make_uint4(0u, 0u, 0u, 0u);
      wh[u] = in ? load_w16(q, N, K, n_hi, k) : make_uint4(0u, 0u, 0u, 0u);
    }
    // x's columns for k in [s0 * 64, s1 * 64), zeros past K; pad columns 0
    const int groups = (s1 - s0) * kChunk / 8;
    const int kbase = s0 * kChunk;
    for (int i = threadIdx.x; i < M * groups; i += blockDim.x) {
      const int m = i / groups, gi = i - m * groups;
      uint4 parts[P];
      load_x8(x, x_rs, M, K, m, kbase + gi * 8, xvec, parts);
#pragma unroll
      for (int p = 0; p < P; ++p)
        *reinterpret_cast<uint4*>(xs + (p * M + m) * pitch + gi * 8) = parts[p];
    }
    for (int i = threadIdx.x; i < (kCols - P * M) * groups; i += blockDim.x) {
      const int c = P * M + i / groups, gi = i % groups;
      *reinterpret_cast<uint4*>(xs + c * pitch + gi * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();

    for (int c = s0; c < s1; c += kSkinnyLoads) {
#pragma unroll
      for (int u = 0; u < kSkinnyLoads; ++u) {
        if (c + u < s1) {
          // A for the 4 mma steps of this chunk: step j takes word j of each
          // row's 16 bytes (physical k 16t + 4j .. +3 standing for the
          // fragment's k 2t, 2t+1, 2t+8, 2t+9)
          uint32_t a[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            int8x4_to_bf16x2(word(wl[u], j), a[j][0], a[j][2]);
            int8x4_to_bf16x2(word(wh[u], j), a[j][1], a[j][3]);
          }
          const int next = c + u + kSkinnyLoads;
          if (next < s1) {
            wl[u] = load_w16(q, N, K, n_lo, next * kChunk + 16 * t);
            wh[u] = load_w16(q, N, K, n_hi, next * kChunk + 16 * t);
          }
          const int kk = (c + u - s0) * kChunk + 16 * t;
          uint4 b[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint4* src = reinterpret_cast<const uint4*>(xs + (nt * 8 + g) * pitch + kk);
            b[nt][0] = src[0];
            b[nt][1] = src[1];
          }
          // the n-tiles' chains interleaved (each the chunk's 4 steps from
          // zero, then one rounded add into the sums)
          float tmp[NT][4];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) tmp[nt][e] = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_bf16(tmp[nt], a[j], word(b[nt][j >> 1], 2 * (j & 1)),
                       word(b[nt][j >> 1], 2 * (j & 1) + 1), tmp[nt]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] += tmp[nt][e];
        }
      }
    }
    if (s0 + chunks_a_round < c_end) __syncthreads();  // the next round restages x
  }

  // Each block reduces and stores `share` of the 64 channels: every block
  // pushes its partial sums of those channels into the owner's receive
  // area (one slot a sending rank), then one cluster barrier, then each
  // owner sums its slots in rank order from its own shared memory.
  const int share = kSkinnyRows / ranks;
  cluster_wait();  // every block of the cluster has started
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ch = warp * 16 + g + 8 * h;
    const int owner = ch / share;
    float* dst = cluster.map_shared_rank(recv, owner) + rank * kCols * share + (ch - owner * share);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * t + e;
        if (col < P * M) dst[col * share] = acc[nt][2 * h + e];
      }
  }
  cluster_arrive();
  cluster_wait();
  for (int i = threadIdx.x; i < share * M; i += blockDim.x) {
    const int m = i / share, c = i - m * share;
    const int n = nb + rank * share + c;
    if (n >= N) continue;
    float s = 0.0f;
    for (int r = 0; r < ranks; ++r) {
      const float* pr = recv + r * kCols * share + c;
      float v = pr[m * share];
      if (P == 3) v += pr[(M + m) * share] + pr[(2 * M + m) * share];
      s += v;
    }
    store_out(out, N, m, n, s, scale, bias);
  }
}

// ------------------------------------------------------------ k4_tile (any)

constexpr int kTileWarps = 4;               // along N, each a 64 x 32 output tile
constexpr int kTileM = 64, kTileN = 32 * kTileWarps, kTileK = 64, kTileStages = 3;
constexpr int kTileThreads = kTileWarps * 32;
constexpr int kTileWPitch = kTileK + 16;    // bytes a weight row: conflict-free 2-byte reads

// k4_tile's shared memory: kTileStages stages, each the int8 weight tile
// [128][kTileK + 16 bytes] then x's tile as it lies in memory [64][kTileK +
// 8 elements] (rows padded so that ldmatrix and the 2-byte weight reads hit
// distinct banks); for fp32, x's three bf16 parts [3][64][kTileK + 8] after
// the stages.
template <typename T>
struct TileSmem {
  static constexpr int kXPitch = (kTileK + 8) * (int)sizeof(T);  // bytes a row of x
  static constexpr int kPartPitch = (kTileK + 8) * 2;            // bytes a row of a part
  static constexpr int kW = kTileN * kTileWPitch;
  static constexpr int kStage = kW + kTileM * kXPitch;
  static constexpr int kParts = kTileStages * kStage;
  static constexpr int kBytes = kParts + (Parts<T>::value == 1 ? 0 : 3 * kTileM * kPartPitch);
};

// Two adjacent int8 weights (the low byte first) as a bf16x2 register.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t h) {
  const uint32_t u = h ^ 0x8080u;
  return pack_bf16(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f,
                   __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f);
}

// grid (ceil(N / 128), ceil(M / 64), cluster size) with clusters (1, 1,
// cluster size), kTileThreads threads, TileSmem<T>::kBytes of dynamic
// shared memory. A cluster of more than one block cuts K: each block then
// pushes its partial sums of the rows another rank owns into that rank's
// shared memory (over its finished stages) between two cluster barriers,
// and each rank sums its rows in rank order. Each warp owns 32 output
// channels over all 64 rows: it converts its channels' weight bytes to bf16
// as it builds the B fragments (each weight byte once a block), and reads
// x's A fragments with ldmatrix (fp32 x split once a block into its three
// bf16 parts first).
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
k4_tile(const T* __restrict__ x, long long x_rs, const int8_t* __restrict__ q,
        const float* __restrict__ scale, const T* __restrict__ bias, T* __restrict__ out,
        int M, int N, int K, bool xvec, bool qvec) {
  using L = TileSmem<T>;
  constexpr int P = Parts<T>::value;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mb = blockIdx.y * kTileM, nb = blockIdx.x * kTileN;

  // tile kt's copies into stage `stage`, 16 bytes a piece: a thread takes
  // the pieces of weight rows w_row + i * kWStep and of x rows x_row + i *
  // kXStep at fixed columns; cp.async where the rows lie on 16 bytes
  // (zero-filled past N, M and K), else loads and stores
  constexpr int kWPerRow = kTileK / 16, kXPerRow = kTileK * (int)sizeof(T) / 16;
  constexpr int kWPieces = kTileN * kWPerRow / kTileThreads;
  constexpr int kXPieces = kTileM * kXPerRow / kTileThreads;
  constexpr int kWStep = kTileThreads / kWPerRow, kXStep = kTileThreads / kXPerRow;
  const int w_row = tid / kWPerRow, w_k = (tid % kWPerRow) * 16;
  const int x_row = tid / kXPerRow, x_k = (tid % kXPerRow) * (16 / (int)sizeof(T));
  // this thread's first rows (where they exist); piece i is kWStep (kXStep)
  // rows further
  const int8_t* wsrc = q + (long long)(nb + w_row) * K + w_k;
  const T* xsrc = x + (long long)(mb + x_row) * x_rs + x_k;
  const long long w_step = (long long)kWStep * K, x_step = (long long)kXStep * x_rs;
  auto issue = [&](int kt, int stage) {
    unsigned char* raw = smem + stage * L::kStage;
    const int k0 = kt * kTileK;
#pragma unroll
    for (int i = 0; i < kWPieces; ++i) {
      const bool row_ok = nb + w_row + kWStep * i < N;
      const int kw = k0 + w_k;
      unsigned char* dst = raw + (w_row + kWStep * i) * kTileWPitch + w_k;
      const int8_t* src = wsrc + i * w_step + k0;
      if (qvec && row_ok && kw + 16 <= K) {
        cp_async16(dst, src);
      } else if (qvec) {  // past N or K: zeros (K % 16 == 0 here)
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (row_ok && kw + b < K) v[b >> 2] |= (uint32_t)(uint8_t)src[b] << (8 * (b & 3));
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < kXPieces; ++i) {
      const bool row_ok = mb + x_row + kXStep * i < M;
      const int k = k0 + x_k;
      unsigned char* dst = raw + L::kW + (x_row + kXStep * i) * L::kXPitch + x_k * (int)sizeof(T);
      const T* src = xsrc + i * x_step + k0;
      if (xvec && row_ok && k + 16 / (int)sizeof(T) <= K) {
        cp_async16(dst, src);
      } else if (xvec) {  // the ragged edge: the valid bytes, zeros after
        const int valid = row_ok ? max(0, min(16, (K - k) * (int)sizeof(T))) : 0;
        cp_async16(dst, valid > 0 ? src : x, valid);
      } else {
        *reinterpret_cast<uint4*>(dst) = gather16(src - k, k, K, row_ok);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int rank = blockIdx.z, ranks = gridDim.z;  // this block's share of K
  const int nkt_all = (K + kTileK - 1) / kTileK;
  const int kt0 = nkt_all * rank / ranks, nkt = nkt_all * (rank + 1) / ranks - kt0;
#pragma unroll
  for (int s = 0; s < kTileStages - 1; ++s) {
    if (s < nkt) issue(kt0 + s, s);
    cp_async_commit();  // one group a tile, empty past the last
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<kTileStages - 2>();  // this thread's copies of tile kt have landed
    __syncthreads();  // everyone's; and every warp is done with the stage refilled below
    if (kt + kTileStages - 1 < nkt)
      issue(kt0 + kt + kTileStages - 1, (kt + kTileStages - 1) % kTileStages);
    cp_async_commit();
    const unsigned char* raw = smem + (kt % kTileStages) * L::kStage;
    const unsigned char* wrows = raw + (warp * 32 + g) * kTileWPitch;
    const unsigned char* xs = raw + L::kW;  // the A operand: x's tile (bf16) or its parts
    int xpitch = L::kXPitch;
    if constexpr (P == 3) {  // split x's tile once: 8 floats a thread at a time
      constexpr int kGroups = kTileM * kTileK / 8;
#pragma unroll
      for (int i = 0; i < kGroups / kTileThreads; ++i) {
        const int grp = tid + i * kTileThreads;
        const int row = grp / (kTileK / 8), col = (grp % (kTileK / 8)) * 8;
        const float4* src = reinterpret_cast<const float4*>(xs + row * L::kXPitch + col * 4);
        uint4 parts[3];
        split8(src[0], src[1], parts);
#pragma unroll
        for (int p = 0; p < 3; ++p)
          *reinterpret_cast<uint4*>(smem + L::kParts + (p * kTileM + row) * L::kPartPitch +
                                    col * 2) = parts[p];
      }
      __syncthreads();
      xs = smem + L::kParts;
      xpitch = L::kPartPitch;
    }
#pragma unroll
    for (int ks = 0; ks < kTileK; ks += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const unsigned char* w = wrows + nt * 8 * kTileWPitch + ks + 2 * t;
        b[nt][0] = int8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(w));
        b[nt][1] = int8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(w + 8));
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[P][4];
#pragma unroll
        for (int p = 0; p < P; ++p)
          ldmatrix_x4(a[p], xs + (p * kTileM + mt * 16 + (lane & 15)) * xpitch +
                                (ks + (lane >> 4) * 8) * 2);
        if constexpr (P == 1) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[mt][nt], a[0], b[nt][0], b[nt][1], acc[mt][nt]);
        } else {  // lo, mid, hi of these 16 k, the n-tiles' chains interleaved, then one add
          float tmp[4][4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) tmp[nt][e] = 0.0f;
#pragma unroll
          for (int p = P - 1; p >= 0; --p)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_bf16(tmp[nt], a[p], b[nt][0], b[nt][1], tmp[nt]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += tmp[nt][e];
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  if (ranks == 1) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mb + mt * 16 + g + 8 * h;
          const int n = nb + warp * 32 + nt * 8 + 2 * t;
          if (m < M) {
            if (n < N) store_out(out, N, m, n, acc[mt][nt][2 * h], scale, bias);
            if (n + 1 < N) store_out(out, N, m, n + 1, acc[mt][nt][2 * h + 1], scale, bias);
          }
        }
    return;
  }
  // rank r owns rows [r * share, (r + 1) * share) of the tile; its receive
  // area [ranks][share][128] fp32 lies over its stages, free once every
  // block of the cluster has passed the first barrier
  const int share = kTileM / ranks;
  float* recv = reinterpret_cast<float*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();
  cluster_wait();
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + g + 8 * h, owner = row / share;
      float* dst =
          cluster.map_shared_rank(recv, owner) + (rank * share + row - owner * share) * kTileN;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = warp * 32 + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(dst + col) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  cluster_arrive();
  cluster_wait();
  for (int i = tid; i < share * kTileN; i += kTileThreads) {
    const int r = i / kTileN, col = i - r * kTileN;
    const int m = mb + rank * share + r, n = nb + col;
    if (m >= M || n >= N) continue;
    float sum = 0.0f;
    for (int src = 0; src < ranks; ++src) sum += recv[(src * share + r) * kTileN + col];
    store_out(out, N, m, n, sum, scale, bias);
  }
}

// ------------------------------------------------------------------ host

int sm_count(int device) {
  static std::atomic<int> counts[64];
  std::atomic<int>& c = counts[device & 63];
  int n = c.load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || n <= 0)
      n = 132;
    c.store(n, std::memory_order_relaxed);
  }
  return n;
}

// Lift a kernel's dynamic shared-memory limit to `bytes`, once a device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int device,
                       std::atomic<unsigned long long>& done) {
  const unsigned long long bit = 1ull << (device & 63);
  if (bytes <= 48 * 1024 || (done.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <typename T>
struct Call {
  const T* x;
  long long x_rs;
  const int8_t* q;
  const float* scale;
  const T* bias;
  T* out;
  int M, N, K;
  bool xvec, qvec;
  int device;
  cudaStream_t st;
};

template <typename T, int MT, int R, int U>
cudaError_t launch_gemv(const Call<T>& c) {
  // the whole K in one chunk where it fits, else chunks of a multiple of 512
  const int cap = (kStageFloats / MT) / 512 * 512;
  const int KC = c.K <= cap ? c.K : cap;
  const dim3 grid((c.N + kGemvWarps * R - 1) / (kGemvWarps * R), (c.M + MT - 1) / MT);
  k4_gemv<T, MT, R, U><<<grid, kGemvWarps * 32, MT * KC * sizeof(float), c.st>>>(
      c.x, c.x_rs, c.q, c.scale, c.bias, c.out, c.M, c.N, c.K, KC);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gemv_m(const Call<T>& c) {
  if (c.M == 1) return launch_gemv<T, 1, 1, 4>(c);
  if (c.M == 2) return launch_gemv<T, 2, 1, 4>(c);
  if (c.M <= 4) return launch_gemv<T, 4, 2, 2>(c);
  if (c.M <= 8) return launch_gemv<T, 8, 4, 2>(c);
  return launch_gemv<T, 16, 4, 1>(c);
}

template <typename T, int NT>
cudaError_t launch_skinny(const Call<T>& c) {
  constexpr int kMaxSmem = NT * 8 * (kSkinnyMaxStage + 8) * 2 + NT * 8 * kSkinnyRows * 4;
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = allow_smem(k4_skinny<T, NT>, kMaxSmem, c.device, ready);
  if (err != cudaSuccess) return err;
  // K cut over a cluster of up to 8 blocks while the grid holds under two
  // blocks a multiprocessor and each block keeps at least 2 chunks of 64 (4
  // with more than 2 n-tiles, whose chunks cost more than their loads'
  // latency: fewer, longer blocks measured faster there on an H100)
  const int tiles = (c.N + kSkinnyRows - 1) / kSkinnyRows;
  const int nch = (c.K + kChunk - 1) / kChunk;
  const int sms = sm_count(c.device);
  const int min_chunks = NT > 2 ? 4 : 2;
  int cs = 1;
  while (cs < kMaxCluster && tiles * cs < 2 * sms && nch >= 2 * min_chunks * cs) cs *= 2;
  const int per_rank = (nch + cs - 1) / cs;
  const int ks = std::min(per_rank, kSkinnyMaxStage / kChunk) * kChunk;
  const int smem = NT * 8 * (ks + 8) * 2 + NT * 8 * kSkinnyRows * 4;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, tiles, 1);
  cfg.blockDim = dim3(kSkinnyWarps * 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = c.st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, k4_skinny<T, NT>, c.x, c.x_rs, c.q, c.scale, c.bias, c.out,
                            c.M, c.N, c.K, ks, c.xvec);
}

template <typename T>
cudaError_t launch_skinny_m(const Call<T>& c) {
  const int nt = (Parts<T>::value * c.M + 7) / 8;
  if constexpr (Parts<T>::value == 3) {
    switch (nt) {
      case 1: return launch_skinny<T, 1>(c);
      case 2: return launch_skinny<T, 2>(c);
      case 3: return launch_skinny<T, 3>(c);
      case 4: return launch_skinny<T, 4>(c);
      case 5: return launch_skinny<T, 5>(c);
      default: return launch_skinny<T, 6>(c);
    }
  } else {
    return nt == 1 ? launch_skinny<T, 1>(c) : launch_skinny<T, 2>(c);
  }
}

template <typename T>
cudaError_t launch_tile(const Call<T>& c) {
  constexpr int smem = TileSmem<T>::kBytes;
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t err = allow_smem(k4_tile<T>, smem, c.device, ready);
  if (err != cudaSuccess) return err;
  // K cut over a cluster of up to 8 blocks while the tiles fill under one
  // wave of the multiprocessors and each block keeps at least 4 steps of K
  const int tiles = ((c.N + kTileN - 1) / kTileN) * ((c.M + kTileM - 1) / kTileM);
  const int nkt = (c.K + kTileK - 1) / kTileK;
  const int sms = sm_count(c.device);
  int cs = 1;
  while (cs < kMaxCluster && tiles * cs < sms && nkt >= 8 * cs) cs *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((c.N + kTileN - 1) / kTileN, (c.M + kTileM - 1) / kTileM, cs);
  cfg.blockDim = dim3(kTileThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = c.st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cs;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, k4_tile<T>, c.x, c.x_rs, c.q, c.scale, c.bias, c.out, c.M, c.N,
                            c.K, c.xvec, c.qvec);
}

enum Variant { kAuto = 0, kGemv = 1, kSkinny = 2, kTile = 3 };
constexpr int kFlagBf16 = 1;  // flags: bit 0 bf16 activations, bits 1-2 the variant

template <typename T>
cudaError_t dispatch(const Call<T>& c, int variant) {
  const bool small = c.M <= kSmallM && c.qvec;
  // k4_gemv at M = 1, and for fp32 wherever its re-reads of the staged rows
  // (M K floats a channel) stay cheaper than k4_skinny's fixed cost
  const bool gemv = c.M == 1 || (Parts<T>::value == 3 && c.M * c.K <= 4096);
  if (variant == kAuto) variant = small ? (gemv ? kGemv : kSkinny) : kTile;
  if (variant != kTile && !small) return cudaErrorInvalidValue;
  if (variant == kGemv) return launch_gemv_m(c);
  if (variant == kSkinny) return launch_skinny_m(c);
  return launch_tile(c);
}

}  // namespace

extern "C" {

// One weight's constants, filled once by the wrapper (ops/quant.py's
// _Desc mirrors it field for field).
struct Desc {
  const void* q;      // int8 [N, K], rows contiguous
  const void* scale;  // fp32 [N]
  const void* bias;   // [N] of x's type, or null
  int N;
  int K;
  int flags;   // bit 0: bf16 activations; bits 1-2: 0 auto, 1 gemv, 2 skinny, 3 tile
  int device;  // the CUDA device the tensors live on
};

// y = x . q^T * scale (+ bias) on `stream` (a cudaStream_t, 0 for the legacy
// default stream): x [M, K] with rows x_rs elements apart (the last dim
// contiguous), out a contiguous [M, N] buffer of x's type. Returns the
// launch's CUDA error code (0 on success); a forced variant that cannot take
// the shape returns cudaErrorInvalidValue.
int tts_int8_linear(const Desc* d, const void* x, long long x_rs, void* out, int M,
                    void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != d->device && (err = cudaSetDevice(d->device)) != cudaSuccess) return (int)err;
  const bool bf16 = (d->flags & kFlagBf16) != 0;
  const int variant = (d->flags >> 1) & 3;
  const bool qvec = d->K % 16 == 0 && (reinterpret_cast<uintptr_t>(d->q) & 15) == 0;
  const bool xvec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                    (x_rs * (bf16 ? 2 : 4)) % 16 == 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    const Call<T> c{static_cast<const T*>(x), x_rs, static_cast<const int8_t*>(d->q),
                    static_cast<const float*>(d->scale), static_cast<const T*>(d->bias),
                    static_cast<T*>(out), M, d->N, d->K, xvec, qvec, d->device, st};
    err = dispatch(c, variant);
  } else {
    const Call<float> c{static_cast<const float*>(x), x_rs, static_cast<const int8_t*>(d->q),
                        static_cast<const float*>(d->scale), static_cast<const float*>(d->bias),
                        static_cast<float*>(out), M, d->N, d->K, xvec, qvec, d->device, st};
    err = dispatch(c, variant);
  }
  if (current != d->device) cudaSetDevice(current);  // the caller's device back
  return (int)err;
}

int tts_int8_linear_desc_bytes() { return (int)sizeof(Desc); }

const char* tts_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

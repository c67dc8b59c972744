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
// What bounds it: at small M (a decode step: M = 1 for one stream, 4 for
// four, 16 for Tortoise's candidates) the int8 weight bytes, N * K, which
// every call reads once: 3.1 MB for XTTS's 1024 x 3072 c_attn, 0.94 us at
// 3.35 TB/s. At large M (prefills of a few hundred tokens, Bark's 1024-frame
// fine windows) the 2 M N K operations.
//
// Two kernels, picked by the host function:
//   * k4_gemv (M <= 16, K a multiple of 16 and q 16-byte aligned): a warp
//     owns R output channels for all of a block's MT rows; each lane loads 16
//     bytes of each channel's weights at a time (16 k values; a warp covers
//     512 along K per load), U loads in flight per channel before it
//     computes. The block stages its rows of x in shared memory as fp32
//     (bf16 widened exactly), K cut into chunks of at most 32 KB; a lane's 4
//     float4 reads per 16 k values are swizzled (float4 c stored at
//     c ^ ((c >> 3) & 3)) so that the 8 lanes of a quarter warp hit 8
//     distinct bank groups. int8 -> fp32 is exact by placing the byte, its
//     sign flipped, in the mantissa of 2^23 (one byte_perm and one add, in
//     place of a quarter-rate I2F). The warp's partial sums are reduced by
//     shuffles; the epilogue applies scale and bias.
//   * k4_tiled (everything else): a 64 x 64 output tile per block of 256
//     threads, 4 x 4 per thread, K in steps of 16 through shared memory
//     (x and the int8 weights widened to fp32), scalar loads with bounds on
//     every edge, so any M, N and K (the conditioning encoders' K = 80 and
//     the perceiver's 2730) are taken. CUDA cores, no tensor cores: a
//     simple kernel that is right; wgmma is later work.
// Both sum each output in a fixed order (no atomics): repeated calls give
// the same bits. Neither allocates; the wrapper owns every buffer.
//
// Measured (chip_smoke.py phase 20; H100 80GB HBM3, 700 W): 4.38 us at bf16
// M=1 for 1024 x 3072, 22 % of the bound and 1.2x faster than F.linear on
// the bf16 weight; at M=16 and in the tiled kernel far from the bound and
// slower than F.linear (PERF.md §6). ptxas (sm_90a, nvcc 12.9): k4_gemv 40
// (MT=1) to 139 (MT=16) registers, k4_tiled 64 and 8704 bytes of static
// shared memory, no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGemvWarps = 4;
constexpr int kGemvMaxM = 16;
constexpr int kStageFloats = 8192;  // 32 KB of staged activations a block
constexpr int kTileM = 64, kTileN = 64, kTileK = 16, kTilePad = 4;

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

// Small M: grid (ceil(N / (kGemvWarps * R)), ceil(M / MT)), kGemvWarps * 32
// threads, MT * KC * 4 bytes of dynamic shared memory (KC: the K chunk, a
// multiple of 16, and of 512 when K is cut).
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

// Any shape: grid (ceil(N / 64), ceil(M / 64)), 256 threads.
template <typename T>
__global__ void __launch_bounds__(256)
k4_tiled(const T* __restrict__ x, long long x_rs, const int8_t* __restrict__ q,
         const float* __restrict__ scale, const T* __restrict__ bias, T* __restrict__ out,
         int M, int N, int K) {
  __shared__ __align__(16) float xs[kTileK][kTileM + kTilePad];  // x tile, [k][m]
  __shared__ __align__(16) float ws[kTileK][kTileN + kTilePad];  // weight tile, [k][n]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int mb = blockIdx.y * kTileM, nb = blockIdx.x * kTileN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    // 64 rows x 16 k of each operand, 4 elements a thread; neighbouring
    // threads take neighbouring k of one row
    for (int i = threadIdx.x; i < kTileM * kTileK; i += 256) {
      const int row = i / kTileK, k = i - row * kTileK;
      const int gk = k0 + k, gm = mb + row, gn = nb + row;
      xs[k][row] = (gm < M && gk < K) ? to_float(x[(long long)gm * x_rs + gk]) : 0.0f;
      ws[k][row] = (gn < N && gk < K) ? (float)q[(long long)gn * K + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = mb + ty * 4 + i, n = nb + tx * 4 + j;
      if (m < M && n < N) store_out(out, N, m, n, acc[i][j], scale, bias);
    }
}

template <typename T, int MT, int R, int U>
void launch_gemv(const T* x, long long x_rs, const int8_t* q, const float* scale,
                 const T* bias, T* out, int M, int N, int K, cudaStream_t st) {
  // the whole K in one chunk where it fits, else chunks of a multiple of 512
  const int cap = (kStageFloats / MT) / 512 * 512;
  const int KC = K <= cap ? K : cap;
  const dim3 grid((N + kGemvWarps * R - 1) / (kGemvWarps * R), (M + MT - 1) / MT);
  k4_gemv<T, MT, R, U><<<grid, kGemvWarps * 32, MT * KC * sizeof(float), st>>>(
      x, x_rs, q, scale, bias, out, M, N, K, KC);
}

template <typename T>
void launch(const T* x, long long x_rs, const int8_t* q, const float* scale, const T* bias,
            T* out, int M, int N, int K, bool vec, cudaStream_t st) {
  if (!vec || M > kGemvMaxM) {
    const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
    k4_tiled<T><<<grid, 256, 0, st>>>(x, x_rs, q, scale, bias, out, M, N, K);
  } else if (M == 1) {
    launch_gemv<T, 1, 1, 4>(x, x_rs, q, scale, bias, out, M, N, K, st);
  } else if (M == 2) {
    launch_gemv<T, 2, 1, 4>(x, x_rs, q, scale, bias, out, M, N, K, st);
  } else if (M <= 4) {
    launch_gemv<T, 4, 2, 2>(x, x_rs, q, scale, bias, out, M, N, K, st);
  } else if (M <= 8) {
    launch_gemv<T, 8, 4, 2>(x, x_rs, q, scale, bias, out, M, N, K, st);
  } else {
    launch_gemv<T, 16, 4, 1>(x, x_rs, q, scale, bias, out, M, N, K, st);
  }
}

enum Arg {
  kX, kXRowStride, kQ, kScale, kBias, kOut, kM, kN, kK, kIsBf16, kVec, kDevice, kStream, kNumArgs
};

template <typename T>
T* ptr(const long long* a, Arg i) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(a[i]));
}

}  // namespace

extern "C" {

// Launch on a[kStream] (a cudaStream_t, 0 for the legacy default stream).
// a[kX] is x [M, K] with rows a[kXRowStride] elements apart (the last dim
// contiguous); a[kQ] the contiguous int8 [N, K] weight; a[kScale] fp32 [N];
// a[kBias] a [N] vector of x's type, or 0 for none; a[kOut] a contiguous
// [M, N] buffer of x's type. a[kVec] != 0 says K % 16 == 0 and q is 16-byte
// aligned, which the small-M kernel needs. Returns cudaGetLastError() after
// the launch.
int tts_int8_linear(const long long* a) {
  const int device = (int)a[kDevice];
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(static_cast<uintptr_t>(a[kStream]));
  const int M = (int)a[kM], N = (int)a[kN], K = (int)a[kK];
  const bool vec = a[kVec] != 0;
  if (a[kIsBf16]) {
    using T = __nv_bfloat16;
    launch<T>(ptr<const T>(a, kX), a[kXRowStride], ptr<const int8_t>(a, kQ),
              ptr<const float>(a, kScale), ptr<const T>(a, kBias), ptr<T>(a, kOut), M, N, K,
              vec, st);
  } else {
    launch<float>(ptr<const float>(a, kX), a[kXRowStride], ptr<const int8_t>(a, kQ),
                  ptr<const float>(a, kScale), ptr<const float>(a, kBias), ptr<float>(a, kOut),
                  M, N, K, vec, st);
  }
  return (int)cudaGetLastError();
}

int tts_int8_linear_num_args() { return kNumArgs; }

const char* tts_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

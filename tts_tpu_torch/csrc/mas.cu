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
// x, mel frames j), in fp32 whatever the input types:
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
// block walking its columns in order, a block barrier a step.
//
// Design (simple and right first):
//   * one block per item, a thread per token (x = pass * blockDim + tid,
//     blockDim a multiple of 32 up to 1024; longer texts take several
//     passes a step, uniform over the block);
//   * the scores in shared memory, two buffers used in turns, so a step
//     needs one barrier;
//   * the directions one bit a cell, made by __ballot_sync (a warp's 32
//     tokens are one word), [T_y][ceil(T_x/32)] words: 41.3 KB for
//     381 x 861, in dynamic shared memory. An item whose bits do not fit
//     (the card's opt-in limit less the scores) keeps them in a global
//     scratch buffer that the wrapper allocates, [B][T_y][words]; the same
//     code runs on either through a generic pointer;
//   * value and mask are read in place through their strides, a column
//     per step: the column's elements are T_y apart, so each is its own
//     32-byte sector, whose next 7 steps then hit L1 (a block's working set
//     is T_x sectors per input, ~12 KB each at the recipe's T_x). No tile
//     is staged through shared memory;
//   * the path is zeroed by the whole block (coalesced), then one thread
//     walks back through the bits and writes the ones; no host sync.
//
// Measured: see PERF.md (chip_smoke.py phase 21).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;  // the JAX package's _NEG, exact in fp32
constexpr int kMaxThreads = 1024;

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

// dirs_global: [B][T_y][words] scratch, or null to keep the bits in dynamic
// shared memory after the scores.
template <typename TV, typename TM>
__global__ void __launch_bounds__(kMaxThreads)
    maximum_path_kernel(const TV* __restrict__ value, const TM* __restrict__ mask,
                        TV* __restrict__ path, uint32_t* __restrict__ dirs_global, int T_x,
                        int T_y, long long vsb, long long vsx, long long vsy, long long msb,
                        long long msx, long long msy) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  const int words = (T_x + 31) >> 5;
  float* scores = reinterpret_cast<float*>(smem);  // [2][T_x]
  uint32_t* dirs = dirs_global ? dirs_global + (size_t)b * T_y * words : smem + 2 * T_x;
  const TV* vb = value + b * vsb;
  const TM* mb = mask + b * msb;
  TV* pb = path + (size_t)b * T_x * T_y;
  const int lane = threadIdx.x & 31;
  const int passes = (T_x + blockDim.x - 1) / blockDim.x;

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
      const uint32_t word = __ballot_sync(0xffffffffu, stay);
      if (lane == 0 && x < T_x) dirs[(size_t)j * words + (x >> 5)] = word;
    }
    __syncthreads();
  }

  // ---- the path: zeros, then the walk back -------------------------------
  const long long cells = (long long)T_x * T_y;
  const TV zero = from_f32<TV>(0.0f);
  for (long long i = threadIdx.x; i < cells; i += blockDim.x) pb[i] = zero;
  __syncthreads();
  if (threadIdx.x == 0) {
    float count = 0.0f;  // sum(mask[:, 0]), in token order
    for (int x = 0; x < T_x; ++x) count = __fadd_rn(count, to_f32(mb[x * msx]));
    int x = (int)count - 1;  // truncated, as astype(int32)
    for (int j = T_y - 1; j >= 0 && x >= 0; --j) {
      pb[(long long)x * T_y + j] = from_f32<TV>(to_f32(mb[x * msx + j * msy]));
      const uint32_t word = dirs[(size_t)j * words + (x >> 5)];
      x += (int)((word >> (x & 31)) & 1u) - 1;
    }
  }
}

template <typename TV, typename TM>
cudaError_t launch(const void* value, const void* mask, void* path, void* scratch, int B,
                   int T_x, int T_y, const long long* vs, const long long* ms,
                   cudaStream_t st) {
  const int words = (T_x + 31) >> 5;
  size_t smem = 2 * (size_t)T_x * sizeof(float);
  if (!scratch) smem += (size_t)T_y * words * sizeof(uint32_t);
  auto kernel = maximum_path_kernel<TV, TM>;
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
                                   T_x, T_y, vs[0], vs[1], vs[2], ms[0], ms[1], ms[2]);
  return cudaGetLastError();
}

template <typename TV>
cudaError_t launch_mask(int mask_type, const void* value, const void* mask, void* path,
                        void* scratch, int B, int T_x, int T_y, const long long* vs,
                        const long long* ms, cudaStream_t st) {
  switch (mask_type) {
    case 0: return launch<TV, float>(value, mask, path, scratch, B, T_x, T_y, vs, ms, st);
    case 1:
      return launch<TV, __nv_bfloat16>(value, mask, path, scratch, B, T_x, T_y, vs, ms, st);
    case 2: return launch<TV, uint8_t>(value, mask, path, scratch, B, T_x, T_y, vs, ms, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block may opt into on `device` (the
// wrapper keeps the direction bits there when they fit beside the scores).
int tts_maximum_path_shared_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return 0;
  return bytes;
}

// path [B, T_x, T_y] (contiguous, value's type) = MAS of value and mask
// [B, T_x, T_y], read through their element strides vs / ms (batch, token,
// frame). value_type: 0 fp32, 1 bf16; mask_type: 0 fp32, 1 bf16, 2 bool.
// scratch: null (the direction bits in shared memory) or B * T_y *
// ceil(T_x / 32) uint32 words. Launches on `stream`; returns
// cudaGetLastError() after the launch.
int tts_maximum_path(const void* value, const void* mask, void* path, void* scratch, int B,
                     int T_x, int T_y, const long long* vs, const long long* ms, int value_type,
                     int mask_type, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || T_x < 1 || T_y < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (value_type == 0)
    err = launch_mask<float>(mask_type, value, mask, path, scratch, B, T_x, T_y, vs, ms, st);
  else if (value_type == 1)
    err = launch_mask<__nv_bfloat16>(mask_type, value, mask, path, scratch, B, T_x, T_y, vs,
                                     ms, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* tts_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

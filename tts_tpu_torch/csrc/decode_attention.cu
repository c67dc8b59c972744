// Single-token KV-cache decode attention for Hopper (sm_90a): one-launch
// split-K (flash-decoding).
//
// Replaces tts_tpu/ops/pallas_attention.py::decode_attention (:52; kernel
// body _decode_attn_kernel :30-49, pl.pallas_call :78). Per (batch row b,
// head h): s = q . K / sqrt(dh); positions >= cache_len[b] masked; softmax
// over S; p . V. The output is fp32 [B, H, dh]; the cache is fp32 or bf16;
// accumulation is fp32.
//
// What bounds it: bytes. A call reads the valid prefix of K and V once,
// 2 * B * n * H * dh * sizeof(T) bytes, and does ~4 flops per element (a
// multiply-add for q.k, one for p.v), far under the card's ~295 flops/byte.
// Each (b, h) has one query row and its own K/V (no grouped heads), so this
// is a matrix-vector product: no tensor cores (wgmma would have one useful
// row of 64). At XTTS v2's served shapes (H=16, dh=64, n=685) the bound at
// 3.35 TB/s is 0.84 us in bf16 at B=1 (2.8 MB), 3.36 us at B=4, and 1.68 /
// 6.71 us in fp32.
//
// The first version ran one block per (b, h): 16 blocks at B=1 on 132 SMs,
// at most ~0.5 MB of loads in flight, 13.0 us. This one:
//   * cuts the keys into splits across blocks, grid (splits, H, B). The
//     split plan (ops/decode_attention.py split_plan, shared with the plain
//     split version) puts at most one block on each of the card's SMs (the
//     wrapper reads their count from the device): on an H100 SXM's 132, B=1
//     gets 8 splits of 86 keys, 128 blocks of 256 threads. A grid just over
//     one block per SM (9 splits) leaves two blocks on a few SMs and
//     measured slower. A host-int length (the decode loop's case) sizes
//     the plan, so short caches get few splits and no empty block; a cache of
//     at most 96 keys is not split at all. Per-row device lengths size it from
//     S, and a block past its row's length writes an empty partial (l = 0)
//     without reading K/V. The host is never asked for a length.
//   * loads with plain 16-byte register loads (each lane 16 bytes of a key
//     row, dh/8 lanes per bf16 row), kUnroll keys per lane per pass, and the
//     next pass's loads issued before the current one is computed. A pass of
//     a block is 128 bf16 keys (32 KB of K and V), which covers a whole split
//     at B=1, so all of a call's K/V is requested in one wave, ~22 KB per SM.
//     A cp.async / TMA ring would put the same bytes in flight through shared
//     memory; with one or two passes per block there is no pipeline for it
//     to fill, and registers measured sufficient.
//   * reads the [B, S, H, dh] caches in place through their strides, loads q
//     with the keys and uses it after them, and reads nothing past the valid
//     length (the Pallas -1e9 mask gives those positions exactly zero weight).
//   * keeps scores in base-2 units (log2 e folded into the scale), an online
//     softmax per key group updated once per pass, then merges the groups of
//     a warp by shuffles and the warps in shared memory: the split's partial
//     (m, l, acc[dh]).
//   * merges in the same launch: each block writes its partial to a
//     workspace and bumps its (b, h)'s counter with one acq_rel atomic after a
//     barrier (CUTLASS's semaphore pattern, in place of __threadfence()); the
//     block that brings it to `splits` folds all partials in split order, so
//     the result is deterministic whichever block is last, and resets the
//     counter to 0, so the next launch needs no memset. One split writes the
//     output directly. The wrapper allocates the workspace and counters once
//     per device and stream; the kernel allocates nothing.
//
// Measured (chip_smoke.py phase 3; H100 80GB HBM3, 700 W): 5.9 us at bf16
// B=1 n=685, 14 % of the bound, against 13.0 us for the one-block-per-head
// version. How that time splits between the launch floor, the merge's
// round trips through L2 and the loads is not measured yet; see PERF.md.
//
// ptxas (sm_90a, nvcc 12.9, printed by chip_smoke.py's build phase): bf16
// instance 119 registers, fp32 92, no spills, 8257 / 4161 bytes of static
// shared memory; at 256 threads that allows two blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
// the last block loads this many splits' partials at once, then folds them
constexpr int kMergeBatch = 8;

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void to_float(const uint4& r, float* f) {
    const float* p = reinterpret_cast<const float*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = p[i];
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void to_float(const uint4& r, float* f) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(p[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

// One pass of a key group's loads: key s0 + u * stride for u < kUnroll, 16
// bytes of K and of V each, zeros past `end`.
template <typename T, int kUnroll>
__device__ __forceinline__ void load_pass(const T* kb, const T* vb, long long k_ss,
                                          long long v_ss, int s0, int stride, int end,
                                          uint4* kr, uint4* vr) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int s = s0 + u * stride;
    if (s < end) {
      kr[u] = *reinterpret_cast<const uint4*>(kb + s * k_ss);
      vr[u] = *reinterpret_cast<const uint4*>(vb + s * v_ss);
    } else {
      kr[u] = make_uint4(0, 0, 0, 0);
      vr[u] = make_uint4(0, 0, 0, 0);
    }
  }
}

// atomicAdd with release and acquire semantics at GPU scope
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// Fold partial softmax states (ms[j], ls[j], os[j]), j < count, into the
// running (m, l, o): the new max first, then the weighted sums in order. A
// state with ls == 0 saw no key and adds nothing. The plain split version
// (decode_attention_split_torch) merges the splits by the same rule.
template <int kCount>
__device__ __forceinline__ void fold_states(float& m, float& l, float& o, const float* ms,
                                            const float* ls, const float* os) {
  float mn = m;
#pragma unroll
  for (int j = 0; j < kCount; ++j)
    if (ls[j] > 0.f) mn = fmaxf(mn, ms[j]);
  if (mn == -INFINITY) return;  // nothing seen yet
  const float a = exp2f(m - mn);  // 0 while m is -inf (l and o are 0 then)
  l *= a;
  o *= a;
#pragma unroll
  for (int j = 0; j < kCount; ++j) {
    if (ls[j] > 0.f) {
      const float w = exp2f(ms[j] - mn);
      l = fmaf(ls[j], w, l);
      o = fmaf(os[j], w, o);
    }
  }
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lens, long long lens_stride, int len_scalar,
    float* __restrict__ out, int S, int H, int dh, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, int splits, int chunk, float* __restrict__ ws_ml,
    float* __restrict__ ws_acc, int* __restrict__ counters) {
  constexpr int N = Vec16<T>::N;
  // one softmax state per warp: head rows of up to 32 * N elements
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps * 32 * N];
  __shared__ bool sm_last;

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const int lpk = dh / N;  // lanes per key, a power of two <= 32 (wrapper checks)
  const int kpw = 32 / lpk;  // keys a warp covers at once
  const int n_groups = kWarps * kpw;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % lpk;  // which N-wide slice of the head row this lane holds

  // q is loaded before the keys and first used after them
  const uint4 qr = *reinterpret_cast<const uint4*>(q + b * q_sb + h * q_sh + sub * N);

  int n = lens != nullptr ? lens[b * lens_stride] : len_scalar;
  // every position masked: the reference softmax sees S equal scores (-1e9)
  // and returns the mean of V over the whole cache
  const bool uniform = n <= 0;
  n = uniform ? S : min(n, S);
  const int start = split * chunk;
  const int end = min(start + chunk, n);  // start >= end: an empty split, nothing read

  const T* kb = k + b * k_sb + h * k_sh + sub * N;
  const T* vb = v + b * v_sb + h * v_sh + sub * N;

  float qf[N];
  float m = -INFINITY;
  float l = 0.f;
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;

  // each group of lpk lanes keeps an online softmax over its keys, updated
  // once per pass; the next pass's loads are issued before this pass is
  // computed. The loop bound is uniform over the warp, so every lane reaches
  // the shuffles.
  const int step = n_groups * kUnroll;
  uint4 kr[kUnroll], vr[kUnroll];
  load_pass<T, kUnroll>(kb, vb, k_ss, v_ss, start + warp * kpw + lane / lpk, n_groups, end, kr, vr);
  for (int base = start + warp * kpw; base < end; base += step) {
    uint4 kn[kUnroll], vn[kUnroll];
    if (base + step < end)
      load_pass<T, kUnroll>(kb, vb, k_ss, v_ss, base + step + lane / lpk, n_groups, end, kn, vn);
    // all of the pass's scores first, then one rescale: the only chain
    // between keys is the max
    Vec16<T>::to_float(qr, qf);
    float sc[kUnroll];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = base + (lane / lpk) + u * n_groups;
      float kf[N];
      Vec16<T>::to_float(kr[u], kf);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) dot = fmaf(qf[i], kf[i], dot);
      for (int off = lpk >> 1; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      sc[u] = s < end ? (uniform ? 0.f : dot * scale) : -INFINITY;
      mx = fmaxf(mx, sc[u]);
    }
    if (mx != -INFINITY) {  // else this group has seen no key yet
      const float corr = exp2f(m - mx);  // 2^-inf = 0 on the group's first keys
      l *= corr;
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] *= corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = exp2f(sc[u] - mx);  // 0 past the split's end
        float vf[N];
        Vec16<T>::to_float(vr[u], vf);
        l += p;
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
      }
      m = mx;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      kr[u] = kn[u];
      vr[u] = vn[u];
    }
  }

  // merge the key groups of each warp by shuffles (a fixed tree: both lanes
  // of a pair compute the same sums), then the warps in shared memory
  for (int off = lpk; off < 32; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    float a2[N];
#pragma unroll
    for (int i = 0; i < N; ++i) a2[i] = __shfl_xor_sync(0xffffffffu, acc[i], off);
    const float mn = fmaxf(l > 0.f ? m : -INFINITY, l2 > 0.f ? m2 : -INFINITY);
    if (mn != -INFINITY) {
      const float wa = l > 0.f ? exp2f(m - mn) : 0.f;
      const float wb = l2 > 0.f ? exp2f(m2 - mn) : 0.f;
      l = l * wa + l2 * wb;
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = acc[i] * wa + a2[i] * wb;
      m = mn;
    }
  }
  if (lane < lpk) {
    if (lane == 0) {
      sm_m[warp] = m;
      sm_l[warp] = l;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) sm_acc[warp * dh + sub * N + i] = acc[i];
  }
  __syncthreads();

  const long long part = (long long)bh * splits + split;
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float pm = -INFINITY, pl = 0.f, po = 0.f, os[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) os[w] = sm_acc[w * dh + d];
    fold_states<kWarps>(pm, pl, po, sm_m, sm_l, os);
    if (splits == 1) {
      out[(long long)bh * dh + d] = po / pl;
    } else {
      if (d == 0) {
        ws_ml[2 * part] = pm;
        ws_ml[2 * part + 1] = pl;
      }
      ws_acc[part * dh + d] = po;
    }
  }
  if (splits == 1) return;

  // the last block of this (b, h) to finish merges every split's partial.
  // The barrier orders the block's stores before thread 0's atomic, whose
  // release publishes them; its acquire, then the barrier, order the last
  // block's loads after every other block's stores (CUTLASS's semaphore
  // pattern; an acq_rel atomic in place of two sequentially consistent
  // __threadfence() calls).
  __syncthreads();
  if (threadIdx.x == 0) sm_last = atomic_add_acq_rel(&counters[bh], 1) == splits - 1;
  __syncthreads();
  if (!sm_last) return;

  const float* ml = ws_ml + 2 * (long long)bh * splits;
  const float* pa = ws_acc + (long long)bh * splits * dh;
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float fm = -INFINITY, fl = 0.f, fo = 0.f;
    for (int s0 = 0; s0 < splits; s0 += kMergeBatch) {
      // a batch of partials in flight at once; L2 loads (__ldcg), since
      // other blocks wrote them
      float ms[kMergeBatch], ls[kMergeBatch], os[kMergeBatch];
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        const int s = s0 + j;
        const bool in = s < splits;
        ms[j] = in ? __ldcg(ml + 2 * s) : -INFINITY;
        ls[j] = in ? __ldcg(ml + 2 * s + 1) : 0.f;
        os[j] = in ? __ldcg(pa + (long long)s * dh + d) : 0.f;
      }
      fold_states<kMergeBatch>(fm, fl, fo, ms, ls, os);
    }
    out[(long long)bh * dh + d] = fo / fl;
  }
  if (threadIdx.x == 0) counters[bh] = 0;  // ready for the next launch
}

// The launch's arguments, in this order in one int64 array: the Python
// wrapper fills a preallocated array and passes its address, since ctypes
// converts one argument much faster than 27 (the launch is host-bound).
enum Arg {
  kQ, kK, kV, kLens, kLensStride, kLenScalar, kOut, kB, kS, kH, kDh,
  kQsb, kQsh, kKsb, kKss, kKsh, kVsb, kVss, kVsh,
  kIsBf16, kSplits, kChunk, kWsMl, kWsAcc, kCounters, kDevice, kStream, kNumArgs
};

template <typename T>
T* ptr(const long long* a, Arg i) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(a[i]));
}

}  // namespace

extern "C" {

// Launch on a[kStream] (a cudaStream_t, 0 for the legacy default stream).
// a[kLens] is an int32 device pointer read at lens[b * lens_stride], or 0,
// in which case every row uses a[kLenScalar]. Strides are in elements; the
// last dim of q and of the caches is contiguous; a[kOut] is a contiguous
// [B, H, dh] fp32 buffer. The keys are cut into a[kSplits] splits of
// a[kChunk] keys; with more than one split, a[kWsMl] ([B*H*splits, 2]
// floats), a[kWsAcc] ([B*H*splits, dh] floats) and a[kCounters] ([B*H]
// int32, all 0, and left at 0) are the workspace of the merge, owned by the
// caller and used by no other stream meanwhile. Returns cudaGetLastError()
// after the launch.
int tts_decode_attention(const long long* a) {
  const int device = (int)a[kDevice];
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int S = (int)a[kS], H = (int)a[kH], dh = (int)a[kDh];
  const int splits = (int)a[kSplits], chunk = (int)a[kChunk];
  const dim3 grid(splits, H, (int)a[kB]);
  // scores in base-2 units: log2(e) folded into the scale, so every
  // exponential of the softmax is one exp2f
  const float scale = 1.4426950408889634f / sqrtf((float)dh);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(static_cast<uintptr_t>(a[kStream]));
  const int* lens = ptr<const int>(a, kLens);
  float* out = ptr<float>(a, kOut);
  float* ml = ptr<float>(a, kWsMl);
  float* acc = ptr<float>(a, kWsAcc);
  int* cnt = ptr<int>(a, kCounters);
  const int len_scalar = (int)a[kLenScalar];
  if (a[kIsBf16]) {
    using T = __nv_bfloat16;
    decode_attention_kernel<T><<<grid, kThreads, 0, st>>>(
        ptr<const T>(a, kQ), ptr<const T>(a, kK), ptr<const T>(a, kV), lens, a[kLensStride],
        len_scalar, out, S, H, dh, a[kQsb], a[kQsh], a[kKsb], a[kKss], a[kKsh], a[kVsb],
        a[kVss], a[kVsh], scale, splits, chunk, ml, acc, cnt);
  } else {
    decode_attention_kernel<float><<<grid, kThreads, 0, st>>>(
        ptr<const float>(a, kQ), ptr<const float>(a, kK), ptr<const float>(a, kV), lens,
        a[kLensStride], len_scalar, out, S, H, dh, a[kQsb], a[kQsh], a[kKsb], a[kKss],
        a[kKsh], a[kVsb], a[kVss], a[kVsh], scale, splits, chunk, ml, acc, cnt);
  }
  return (int)cudaGetLastError();
}

int tts_decode_attention_num_args() { return kNumArgs; }

const char* tts_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

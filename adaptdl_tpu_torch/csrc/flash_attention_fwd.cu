// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel adaptdl_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _fwd_pallas): exact attention softmax(q k^T * scale) v over
// [batch*heads, seq, head_dim], online softmax in f32, optional causal mask
// (NEG_INF = -1e30) with key tiles wholly above the diagonal skipped, and the
// per-row log-sum-exp m + log(max(l, 1e-30)) that the backward reads.
//
// What bounds it on the H100: at the training shape (B*H = 384, S = 512,
// D = 64, bf16, causal) the work is ~12.9 GFLOP against ~101 MB of traffic
// (q, k, v read once, o written once, plus the f32 lse), so with tensor cores
// it would sit near the memory bound (~30 us at 3.35 TB/s). This first
// version does its arithmetic in f32 on the CUDA cores (67 TFLOP/s peak, not
// the 989 of the tensor cores), so the FLOPs bound it. The design keeps the
// [seq, seq] score matrix out of device memory -- the point of the TPU
// kernel -- and keeps the f32 work cheap to feed:
//   * one thread block per (b*h, 64-row query tile); the TPU's sequential K
//     grid axis becomes a loop inside the block;
//   * four threads per query row, each owning an interleaved quarter of the
//     head dimension, so a warp's shared-memory reads of a K/V row are one
//     broadcast of contiguous 16-byte vectors (no bank conflicts), and the
//     partial dot products meet with two warp shuffles;
//   * K/V tiles of 64 keys staged through dynamic shared memory, converted to
//     f32 once per tile;
//   * the running (m, l, acc) triple and the tile's scores live in registers;
//   * causal blocks stop at their last visible tile, and the heaviest query
//     tiles are issued first so the causal tail does not idle the SMs.
// Tensor cores (mma/wgmma) and TMA staging are the next step.
//
// adaptdl-build: parts=8
// The build compiles this file as 8 objects in parallel, each with
// -DADAPTDL_PART=p instantiating the kernels of two head dims (8(p+1) and
// 136 - 8(p+1), so every object gets a similar load); object 0 also holds the
// C entry points. Without ADAPTDL_PART the file compiles on its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace adaptdl_flash {

constexpr int BLOCK_M = 64;              // query rows per thread block
constexpr int BLOCK_N = 64;              // keys per shared-memory tile
constexpr int TPR = 4;                   // threads per query row
constexpr int THREADS = BLOCK_M * TPR;   // 256
constexpr float NEG_INF = -1e30f;

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <>
struct Vec<float, 2> {
  __device__ static void load(const float* p, float* out) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(in[0], in[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(in[2], in[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned int*>(&a);
    raw.y = *reinterpret_cast<const unsigned int*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

template <>
struct Vec<__nv_bfloat16, 2> {
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x; out[1] = a.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(in[0], in[1]);
  }
};

// q/k/v/o: [bh, seq, D] contiguous; lse: [bh, seq] f32.
template <typename T, int D, int VEC>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int seq, int n_qtiles, int causal,
                 float scale) {
  constexpr int NV = D / VEC;   // vectors per row
  constexpr int NS = NV / TPR;  // vectors per thread
  static_assert(NV % TPR == 0, "head_dim must split over 4 threads");
  extern __shared__ float smem[];
  float* ks = smem;                // [BLOCK_N][D]
  float* vs = smem + BLOCK_N * D;  // [BLOCK_N][D]

  const int bh = blockIdx.x / n_qtiles;
  // Heaviest (last) query tiles first: under the causal mask they loop over
  // the most key tiles.
  const int qt = n_qtiles - 1 - (blockIdx.x % n_qtiles);
  const int q0 = qt * BLOCK_M;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int lane = tid % TPR;
  const int qi = q0 + row;
  const bool row_ok = qi < seq;
  const size_t base = static_cast<size_t>(bh) * seq * D;

  // This thread owns vectors lane, lane + TPR, ... of its row.
  float qr[NS][VEC];
  float acc[NS][VEC];
#pragma unroll
  for (int t = 0; t < NS; ++t) {
    if (row_ok) {
      Vec<T, VEC>::load(q + base + static_cast<size_t>(qi) * D +
                            (lane + t * TPR) * VEC,
                        qr[t]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[t][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qr[t][e] *= scale;
      acc[t][e] = 0.f;
    }
  }
  float m = NEG_INF;
  float l = 0.f;

  // Under the causal mask no row of this block sees a key past its last row.
  const int key_end = causal ? min(seq, q0 + BLOCK_M) : seq;
  const int n_ktiles = (key_end + BLOCK_N - 1) / BLOCK_N;

  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * BLOCK_N;
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < BLOCK_N * NV; idx += THREADS) {
      const int r = idx / NV;
      const int c = idx % NV;
      const int key = k0 + r;
      float kv[VEC];
      float vv[VEC];
      if (key < seq) {
        const size_t off = base + static_cast<size_t>(key) * D + c * VEC;
        Vec<T, VEC>::load(k + off, kv);
        Vec<T, VEC>::load(v + off, vv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kv[e] = vv[e] = 0.f;
      }
      Vec<float, VEC>::store(ks + r * D + c * VEC, kv);
      Vec<float, VEC>::store(vs + r * D + c * VEC, vv);
    }
    __syncthreads();

    float s[BLOCK_N];
    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < BLOCK_N; ++j) {
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        float kv[VEC];
        Vec<float, VEC>::load(ks + j * D + (lane + t * TPR) * VEC, kv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) part = fmaf(qr[t][e], kv[e], part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int key = k0 + j;
      const bool visible = key < seq && (!causal || key <= qi);
      s[j] = visible ? part : NEG_INF;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float rescale = expf(m - m_new);
    l *= rescale;
#pragma unroll
    for (int t = 0; t < NS; ++t) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[t][e] *= rescale;
    }
#pragma unroll
    for (int j = 0; j < BLOCK_N; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        float vv[VEC];
        Vec<float, VEC>::load(vs + j * D + (lane + t * TPR) * VEC, vv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[t][e] = fmaf(p, vv[e], acc[t][e]);
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float safe_l = fmaxf(l, 1e-30f);
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      float out[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[e] = acc[t][e] / safe_l;
      Vec<T, VEC>::store(
          o + base + static_cast<size_t>(qi) * D + (lane + t * TPR) * VEC, out);
    }
    if (lane == 0) {
      lse[static_cast<size_t>(bh) * seq + qi] = m + logf(safe_l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int seq, int causal, float scale,
                   cudaStream_t stream) {
  constexpr int VEC = (D % 16 == 0) ? 4 : 2;
  const auto kernel = flash_fwd_kernel<T, D, VEC>;
  const int smem = 2 * BLOCK_N * D * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (seq + BLOCK_M - 1) / BLOCK_M;
  kernel<<<bh * n_qtiles, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      seq, n_qtiles, causal, scale);
  return cudaGetLastError();
}

#define ADAPTDL_LAUNCH_PARAMS                                               \
  const void *, const void *, const void *, void *, void *, int, int, int, \
      float, cudaStream_t

#ifdef ADAPTDL_PART
// Every object sees every instantiation as external; each object then
// defines its own two head dims.
#define ADAPTDL_EXTERN(DIM)                                                 \
  extern template cudaError_t launch<float, DIM>(ADAPTDL_LAUNCH_PARAMS);    \
  extern template cudaError_t launch<__nv_bfloat16, DIM>(ADAPTDL_LAUNCH_PARAMS);
ADAPTDL_EXTERN(8) ADAPTDL_EXTERN(16) ADAPTDL_EXTERN(24) ADAPTDL_EXTERN(32)
ADAPTDL_EXTERN(40) ADAPTDL_EXTERN(48) ADAPTDL_EXTERN(56) ADAPTDL_EXTERN(64)
ADAPTDL_EXTERN(72) ADAPTDL_EXTERN(80) ADAPTDL_EXTERN(88) ADAPTDL_EXTERN(96)
ADAPTDL_EXTERN(104) ADAPTDL_EXTERN(112) ADAPTDL_EXTERN(120) ADAPTDL_EXTERN(128)
#undef ADAPTDL_EXTERN
#define ADAPTDL_DEFINE(DIM)                                          \
  template cudaError_t launch<float, DIM>(ADAPTDL_LAUNCH_PARAMS); \
  template cudaError_t launch<__nv_bfloat16, DIM>(ADAPTDL_LAUNCH_PARAMS);
ADAPTDL_DEFINE(8 * (ADAPTDL_PART + 1))
ADAPTDL_DEFINE(136 - 8 * (ADAPTDL_PART + 1))
#undef ADAPTDL_DEFINE
#endif

#if !defined(ADAPTDL_PART) || ADAPTDL_PART == 0

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int seq, int head_dim, int causal,
                     float scale, cudaStream_t stream) {
#define ADAPTDL_FLASH_CASE(DIM)                                            \
  case DIM:                                                                \
    return launch<T, DIM>(q, k, v, o, lse, bh, seq, causal, scale, stream);
  switch (head_dim) {
    ADAPTDL_FLASH_CASE(8)
    ADAPTDL_FLASH_CASE(16)
    ADAPTDL_FLASH_CASE(24)
    ADAPTDL_FLASH_CASE(32)
    ADAPTDL_FLASH_CASE(40)
    ADAPTDL_FLASH_CASE(48)
    ADAPTDL_FLASH_CASE(56)
    ADAPTDL_FLASH_CASE(64)
    ADAPTDL_FLASH_CASE(72)
    ADAPTDL_FLASH_CASE(80)
    ADAPTDL_FLASH_CASE(88)
    ADAPTDL_FLASH_CASE(96)
    ADAPTDL_FLASH_CASE(104)
    ADAPTDL_FLASH_CASE(112)
    ADAPTDL_FLASH_CASE(120)
    ADAPTDL_FLASH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef ADAPTDL_FLASH_CASE
}

}  // namespace adaptdl_flash

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = float32,
// 1 = bfloat16. Launches on `stream` and does not synchronise.
extern "C" int adaptdl_flash_attention_fwd(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int bh, int seq, int head_dim,
                                           int dtype, int causal, float scale,
                                           void* stream) {
  using adaptdl_flash::dispatch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, seq, head_dim,
                                           causal, scale, s)
                 : dispatch<float>(q, k, v, o, lse, bh, seq, head_dim, causal,
                                   scale, s);
  return static_cast<int>(err);
}

extern "C" const char* adaptdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#else
}  // namespace adaptdl_flash
#endif

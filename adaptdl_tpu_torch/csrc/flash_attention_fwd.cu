// Flash-attention forward for Hopper (sm_90a) on the tensor cores, at
// float32 accuracy: 3xTF32 mma.sync.
//
// Replaces the Pallas TPU kernel adaptdl_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _fwd_pallas): exact attention softmax(q k^T * scale) v over
// [batch*heads, seq, head_dim], online softmax in f32, optional causal mask
// (NEG_INF = -1e30) with key tiles wholly above the diagonal skipped, and the
// per-row log-sum-exp m + log(max(l, 1e-30)) that the backward reads. It takes
// float32 input, and bfloat16 at the head dims that flash_attention_fwd_sm90.cu
// does not (every multiple of 8 up to 128 but 64 and 128).
//
// What bounds it on the H100: at the main shape (B*H = 384, S = 512, D = 64,
// causal, f32) the two products are 12.91 GFLOP; in 3xTF32 that is 3 x 12.91
// at TF32's 495 TFLOP/s, 0.0782 ms. q, k, v and o in f32 plus the f32 lse move
// 202.11 MB, 0.0603 ms at 3.35 TB/s. So the operations bound it. mma.sync
// itself reaches only part of the 495 (chip_smoke.py measures its rate), so
// the design keeps the matrix unit fed and everything else off the issue
// slots:
//   * Matrix unit: warp-level mma.sync.m16n8k8 in TF32 with f32 accumulators.
//     (wgmma in TF32 wants both operands K-major in shared memory, which for
//     P V means transposing V while it is staged; the next step, for the
//     rate mma.sync leaves unused.)
//   * The 3xTF32 split keeps the f32 result (1xTF32 keeps 10 mantissa bits and
//     misses the 2e-5 tolerance by ~50x): x = big + small with
//     big = cvt.rna.tf32(x), and a product is small*big + big*small, then
//     big*big, into one f32 accumulator; small*small (~2^-22 relative) is
//     dropped. Q (once per block: into registers up to head_dim 64, above
//     that per k-step from f32 registers so head_dim 128 fits) and P (once
//     per tile, in registers) take small = cvt.rna.tf32(x - big). K and V are
//     split every time a warp reads a fragment, four times per element, so
//     they save an instruction: small = x - big is left as it is and the MMA
//     reads its top 19 bits (toward zero, as CUTLASS's fast-F32 GEMMs do),
//     |x - big - small| <= 2^-21 |x|. On bf16 input q, k and v are exact in
//     TF32 (small = 0), so Q K^T takes one MMA and P V two (only P is split).
//     Q is not scaled before the product: the scale (times log2 e) goes into
//     the exponent, exp2(s * c - m), so bf16 Q stays exact.
//   * Tiling: one block of 4 warps per (b*h, 64-row query tile), 16 rows a
//     warp; K/V tiles of 32 keys double-buffered through cp.async (16-byte
//     copies, zero-filled past seq) into shared memory whose row stride is
//     padded so that both fragment reads below are free of bank conflicts
//     (f32: D + 4 words; bf16: D + 8 or D + 16 halves, 4 mod 8 words). 32-key
//     tiles keep the scores at 16 registers, so up to head_dim 64 a thread
//     fits in 168 registers and three blocks (12 warps) share an SM.
//   * Each product is issued over all n-tiles of a k-step (in P V, up to 8
//     of them; 4 above head_dim 64) before the next product, so no MMA waits
//     on the one before it.
//   * Online softmax on the accumulator fragments: a thread holds two rows'
//     scores in each 8-key n-tile; a row's max meets across its quad with two
//     shuffles per tile, the row sums stay per thread until the end.
//     ex2.approx with log2 e folded into the scale; lse is written in natural
//     log. The mask is applied only on tiles that the diagonal or the ragged
//     end cross.
//   * P feeds P V from registers with no trip through shared memory. The
//     accumulator gives a thread keys (2t, 2t+1) of each n-tile, where the A
//     fragment wants k-slots (t, t+4); since the keys are summed over, V's B
//     fragment is read with the same permutation: key 2t goes to k-slot t and
//     key 2t+1 to k-slot t+4.
//   * The heaviest query tiles (most key tiles under the causal mask) are
//     issued first across the whole grid so the causal tail does not idle the
//     SMs.
//
// adaptdl-build: parts=8
// The build compiles this file as 8 objects in parallel, each with
// -DADAPTDL_PART=p instantiating the kernels of two head dims (8(p+1) and
// 136 - 8(p+1), so every object gets a similar load); object 0 also holds the
// C entry points. Without ADAPTDL_PART the file compiles on its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace adaptdl_flash {

constexpr int BLOCK_M = 64;         // query rows per block, 16 per warp
constexpr int BLOCK_N = 32;         // keys per shared-memory tile
constexpr int WARPS = BLOCK_M / 16;
constexpr int THREADS = WARPS * 32;  // 128
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both rounded to TF32: |x - big - small| <= 2^-22 |x|.
// For Q and P, split once and used by BLOCK_N / 8 or head_dim / 8 MMAs.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// The same for K and V, split each time a fragment is read: small = x - big
// (exact in f32) is left unrounded and the MMA reads its top 19 bits, i.e.
// rounds it toward zero: |x - big - small| <= 2^-21 |x|, one instruction less.
__device__ __forceinline__ void split_kv(float x, uint32_t& big,
                                         uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// 2^x on the special-function unit (~2 ulp; results below 2^-126 flush to 0,
// nothing beside a row sum >= 1).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d += a * b for one m16n8k8 TF32 tile (A row-major 16x8, B col-major 8x8).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; zero-filled when !valid (src is not read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int D>
struct Traits {
  static constexpr bool F32 = std::is_same<T, float>::value;
  // Row stride in elements: 4 mod 8 in 32-bit words, so the eight rows a
  // fragment read touches fall in distinct banks.
  static constexpr int STRIDE = F32 ? D + 4 : D + (D % 16 == 0 ? 8 : 16);
  static constexpr int TILE = BLOCK_N * STRIDE;  // elements of one K or V tile
  static constexpr int SMEM_BYTES = 2 * 2 * TILE * static_cast<int>(sizeof(T));
  static constexpr int KSTEPS = D / 8;
  // f32 Q split once into registers up to head_dim 64; above, split per use.
  static constexpr bool Q_PRESPLIT = F32 && D <= 64;
  // Up to head_dim 64, at most 168 registers so three blocks share an SM.
  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : 1;
  // P V issues its MMAs over up to this many n-tiles at a time (fewer above
  // head_dim 64, where the accumulators take more registers).
  static constexpr int PV_GROUP = KSTEPS <= 8 ? KSTEPS : 4;
};

// Q is staged through stage 1's K and V buffers, which hold BLOCK_M rows.
static_assert(BLOCK_M == 2 * BLOCK_N, "Q staging needs BLOCK_M = 2 BLOCK_N");

// Rows [row0, row0 + ROWS) of one [seq, D] matrix into shared memory (row
// stride STRIDE), rows past seq zero-filled.
template <typename T, int D, int ROWS = BLOCK_N>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int seq, int tid) {
  constexpr int PER_CHUNK = 16 / static_cast<int>(sizeof(T));
  constexpr int CHUNKS = D / PER_CHUNK;  // per row
  constexpr int TOTAL = ROWS * CHUNKS;
#pragma unroll
  for (int it = 0; it < (TOTAL + THREADS - 1) / THREADS; ++it) {
    const int idx = tid + it * THREADS;
    if (TOTAL % THREADS != 0 && idx >= TOTAL) break;
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    const bool valid = row0 + r < seq;
    const T* from =
        valid ? src + static_cast<size_t>(row0 + r) * D + c * PER_CHUNK : src;
    cp_async16(dst + r * Traits<T, D>::STRIDE + c * PER_CHUNK, from, valid);
  }
}

// q/k/v/o: [bh, seq, D] contiguous; lse: [bh, seq] f32.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, (Traits<T, D>::MIN_BLOCKS))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int bh_count, int seq, int n_qtiles,
                 int causal, float scale_log2) {
  using Tr = Traits<T, D>;
  constexpr int KS = Tr::KSTEPS;
  constexpr int STRIDE = Tr::STRIDE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  // Stage s holds K at smem + 2 s TILE and V right after it.

  // Heaviest (last) query tiles first across the whole grid.
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x) / bh_count;
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int q0 = qt * BLOCK_M;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row of the fragment (and g + 8)
  const int t = lane & 3;   // thread in the quad
  const int r0 = warp * 16 + g;
  const size_t base = static_cast<size_t>(bh) * seq * D;

  const int key_end = causal ? min(seq, q0 + BLOCK_M) : seq;
  const int n_ktiles = (key_end + BLOCK_N - 1) / BLOCK_N;

  // Q goes through stage 1's K and V buffers (free until tile 1 is
  // prefetched), tile 0 into stage 0.
  load_tile<T, D, BLOCK_M>(smem + 2 * Tr::TILE, q + base, q0, seq, tid);
  load_tile<T, D>(smem, k + base, 0, seq, tid);
  load_tile<T, D>(smem + Tr::TILE, v + base, 0, seq, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // A fragments of Q: a[0] = (r0, kk*8 + t), a[1] = (r0 + 8, kk*8 + t),
  // a[2] = (r0, kk*8 + t + 4), a[3] = (r0 + 8, kk*8 + t + 4).
  uint32_t qb[KS][4];
  uint32_t qs[Tr::Q_PRESPLIT ? KS : 1][4];
  float qf[Tr::Q_PRESPLIT ? 1 : KS][4];
  {
    const T* qsm = smem + 2 * Tr::TILE;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + (i & 1) * 8;
        const int col = kk * 8 + t + (i >> 1) * 4;
        const float x = to_float(qsm[row * STRIDE + col]);
        if constexpr (Tr::Q_PRESPLIT) {
          split(x, qb[kk][i], qs[kk][i]);
        } else if constexpr (Tr::F32) {
          qf[kk][i] = x;
        } else {
          qb[kk][i] = __float_as_uint(x);  // bf16 is exact in TF32
        }
      }
    }
  }
  __syncthreads();  // every warp has its Q before stage 1 is overwritten

  float acc[KS][4];  // O fragments: n-tile nd holds columns nd*8 + 2t, +1
#pragma unroll
  for (int nd = 0; nd < KS; ++nd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;
  }
  float m[2] = {NEG_INF, NEG_INF};  // rows r0 and r0 + 8, log2 units
  float l[2] = {0.f, 0.f};          // this thread's part of the row sums

  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * BLOCK_N;
    if (kt + 1 < n_ktiles) {
      T* next = smem + ((kt + 1) & 1) * 2 * Tr::TILE;
      load_tile<T, D>(next, k + base, k0 + BLOCK_N, seq, tid);
      load_tile<T, D>(next + Tr::TILE, v + base, k0 + BLOCK_N, seq, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = smem + (kt & 1) * 2 * Tr::TILE;
    const T* vs = ks + Tr::TILE;

    // S = Q K^T: s[j] is n-tile j (keys k0 + j*8 + 2t, +1; rows r0, r0 + 8).
    float s[BLOCK_N / 8][4];
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ab[4];
      uint32_t as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (Tr::Q_PRESPLIT) {
          ab[i] = qb[kk][i];
          as[i] = qs[kk][i];
        } else if constexpr (Tr::F32) {
          split(qf[kk][i], ab[i], as[i]);
        } else {
          ab[i] = qb[kk][i];
        }
      }
      // B fragments: b0 = K[j*8 + g][kk*8 + t], b1 = K[j*8 + g][kk*8 + t + 4].
      // Each of the three products is issued over every n-tile before the
      // next, so no MMA waits on the one just before it.
      uint32_t kb[BLOCK_N / 8][2];
      uint32_t ksm[BLOCK_N / 8][2];
#pragma unroll
      for (int j = 0; j < BLOCK_N / 8; ++j) {
        const T* kp = ks + (j * 8 + g) * STRIDE + kk * 8 + t;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = to_float(kp[4 * e]);
          if constexpr (Tr::F32) {
            split_kv(x, kb[j][e], ksm[j][e]);
          } else {
            kb[j][e] = __float_as_uint(x);
          }
        }
      }
      if constexpr (Tr::F32) {
#pragma unroll
        for (int j = 0; j < BLOCK_N / 8; ++j) mma(s[j], as, kb[j][0], kb[j][1]);
#pragma unroll
        for (int j = 0; j < BLOCK_N / 8; ++j) mma(s[j], ab, ksm[j][0], ksm[j][1]);
      }
#pragma unroll
      for (int j = 0; j < BLOCK_N / 8; ++j) mma(s[j], ab, kb[j][0], kb[j][1]);
    }

    // Mask only where the diagonal or the ragged end crosses this tile.
    if ((causal && k0 + BLOCK_N > q0) || k0 + BLOCK_N > seq) {
#pragma unroll
      for (int j = 0; j < BLOCK_N / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + j * 8 + 2 * t + (i & 1);
          const int qi = q0 + r0 + (i >> 1) * 8;
          if (key >= seq || (causal && key > qi)) s[j][i] = NEG_INF;
        }
      }
    }

    // Online softmax in log2 units: p = exp2(s * scale_log2 - m).
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BLOCK_N / 8; ++j) {
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * scale_log2);
      alpha[h] = exp2_approx(m[h] - m_new);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BLOCK_N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2_approx(fmaf(s[j][2 * h + e], scale_log2, -m_new));
          s[j][2 * h + e] = p;
          sum += p;
        }
      }
      l[h] = l[h] * alpha[h] + sum;
    }
#pragma unroll
    for (int nd = 0; nd < KS; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

    // O += P V. The A fragment of key step j takes P in the accumulator's
    // order: k-slot t <- key 2t, k-slot t + 4 <- key 2t + 1.
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j) {
      uint32_t pb[4];
      uint32_t ps[4];
      split(s[j][0], pb[0], ps[0]);  // (r0, key 2t)
      split(s[j][2], pb[1], ps[1]);  // (r0 + 8, key 2t)
      split(s[j][1], pb[2], ps[2]);  // (r0, key 2t + 1)
      split(s[j][3], pb[3], ps[3]);  // (r0 + 8, key 2t + 1)
      const T* vp = vs + (j * 8 + 2 * t) * STRIDE + g;
      constexpr int GROUP = Tr::PV_GROUP;
#pragma unroll
      for (int nd0 = 0; nd0 < KS; nd0 += GROUP) {
        // b0 = V[j*8 + 2t][nd*8 + g], b1 = V[j*8 + 2t + 1][nd*8 + g].
        uint32_t vb[GROUP][2];
        uint32_t vsm[GROUP][2];
        // (Indices are constants once unrolled: the n past KS vanish.)
#pragma unroll
        for (int n = 0; n < GROUP; ++n) {
          if (nd0 + n >= KS) break;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = to_float(vp[e * STRIDE + (nd0 + n) * 8]);
            if constexpr (Tr::F32) {
              split_kv(x, vb[n][e], vsm[n][e]);
            } else {
              vb[n][e] = __float_as_uint(x);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < GROUP; ++n) {
          if (nd0 + n >= KS) break;
          mma(acc[nd0 + n], ps, vb[n][0], vb[n][1]);
        }
        if constexpr (Tr::F32) {
#pragma unroll
          for (int n = 0; n < GROUP; ++n) {
            if (nd0 + n >= KS) break;
            mma(acc[nd0 + n], pb, vsm[n][0], vsm[n][1]);
          }
        }
#pragma unroll
        for (int n = 0; n < GROUP; ++n) {
          if (nd0 + n >= KS) break;
          mma(acc[nd0 + n], pb, vb[n][0], vb[n][1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before reuse
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int qi = q0 + r0 + h * 8;
    if (qi >= seq) continue;
    const float safe_l = fmaxf(l[h], 1e-30f);
    T* orow = o + base + static_cast<size_t>(qi) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < KS; ++nd) {
      store2(orow + nd * 8, acc[nd][2 * h] / safe_l,
             acc[nd][2 * h + 1] / safe_l);
    }
    if (t == 0) {
      lse[static_cast<size_t>(bh) * seq + qi] = m[h] * LN2 + logf(safe_l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int seq, int causal, float scale,
                   cudaStream_t stream) {
  const auto kernel = flash_fwd_kernel<T, D>;
  constexpr int smem = Traits<T, D>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (seq + BLOCK_M - 1) / BLOCK_M;
  kernel<<<bh * n_qtiles, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      bh, seq, n_qtiles, causal, scale * LOG2E);
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

template <typename T>
int smem_bytes(int head_dim) {
  switch (head_dim) {
#define ADAPTDL_FLASH_SMEM(DIM) \
  case DIM:                     \
    return Traits<T, DIM>::SMEM_BYTES;
    ADAPTDL_FLASH_SMEM(8) ADAPTDL_FLASH_SMEM(16) ADAPTDL_FLASH_SMEM(24)
    ADAPTDL_FLASH_SMEM(32) ADAPTDL_FLASH_SMEM(40) ADAPTDL_FLASH_SMEM(48)
    ADAPTDL_FLASH_SMEM(56) ADAPTDL_FLASH_SMEM(64) ADAPTDL_FLASH_SMEM(72)
    ADAPTDL_FLASH_SMEM(80) ADAPTDL_FLASH_SMEM(88) ADAPTDL_FLASH_SMEM(96)
    ADAPTDL_FLASH_SMEM(104) ADAPTDL_FLASH_SMEM(112) ADAPTDL_FLASH_SMEM(120)
    ADAPTDL_FLASH_SMEM(128)
#undef ADAPTDL_FLASH_SMEM
    default:
      return -1;
  }
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

// Dynamic shared memory of one block at `head_dim` (dtype as above), -1 for
// a head_dim the kernel does not take.
extern "C" int adaptdl_flash_attention_fwd_smem_bytes(int head_dim, int dtype) {
  return dtype == 1 ? adaptdl_flash::smem_bytes<__nv_bfloat16>(head_dim)
                    : adaptdl_flash::smem_bytes<float>(head_dim);
}

extern "C" const char* adaptdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#else
}  // namespace adaptdl_flash
#endif

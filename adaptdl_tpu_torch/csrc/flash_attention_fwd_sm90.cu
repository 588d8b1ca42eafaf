// Flash-attention forward on Hopper's tensor cores (sm_90a): bf16 wgmma,
// TMA-staged K/V, one producer warp and two consumer warpgroups.
//
// Replaces the Pallas TPU kernel adaptdl_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _fwd_pallas's pl.pallas_call at :148) for bf16 inputs with
// head_dim 64 or 128; flash_attention_fwd.cu keeps float32 and the other head
// dims. Same function: softmax(scale q k^T) v over [bh, seq, D] with the
// online softmax in f32, an optional causal mask (NEG_INF = -1e30), and the
// per-row log-sum-exp m + log(max(l, 1e-30)) that the backward reads.
//
// What bounds it on the H100: at the training shape (bh = 384, seq = 512,
// D = 64, causal) the work is 12.9 GFLOP, 13.1 us at 989 TFLOP/s, against
// 101.45 MB that must move (q, k, v read once, o written once, the f32 lse),
// 30.3 us at 3.35 TB/s. So bytes bound it, and the design keeps the tensor
// cores fed while tiles stream in:
//   * one block per (bh, 128-row query tile); the tiles of one head are
//     adjacent, so its K/V tiles are read from L2 by the other query tiles,
//     and the heaviest causal tile of each head goes first;
//   * warp 8 is the producer: one thread issues TMA copies of Q once and of
//     K and V tiles into a two-stage ring guarded by full/empty mbarriers, so
//     the next tile's copy runs under this tile's math and no thread spends
//     registers or instructions on addresses;
//   * warpgroups 0 and 1 each own 64 query rows, wgmma's M. S = Q K^T is
//     wgmma m64n64k16 with both operands in shared memory, K-major and
//     128-byte swizzled exactly as TMA wrote them. Products of bf16 values
//     are exact in f32, so S is the plain version's f32 score up to the
//     order of summation;
//   * the online softmax runs on the accumulator fragment in registers: row
//     max and sum across the 4 threads of a quad, exp2 with log2(e) folded
//     into the scale, the mask only on tiles that cross the diagonal or the
//     end of the sequence; tiles wholly above the diagonal are never loaded;
//   * O += P V: P, rounded to bf16 in registers, is wgmma's A operand as it
//     lies in the accumulator layout; V is an MN-major B operand (the
//     transpose flag), so neither P nor V is moved or transposed;
//   * the maps are 3-D, [bh, seq, D]: a box that runs past seq is filled with
//     zeros instead of reading the next head's rows;
//   * K/V tiles hold 64 keys, so at D = 64 a block needs 51,200 bytes of
//     shared memory and two blocks fit on an SM.
//
// adaptdl-build: parts=2
// The build compiles this file as 2 objects in parallel, each with
// -DADAPTDL_PART=p instantiating the head_dim 64 (p = 0) or 128 (p = 1)
// kernel; object 0 also holds the C entry points. Without ADAPTDL_PART it
// compiles on its own.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace adaptdl_flash_sm90 {

constexpr int BLOCK_M = 128;             // query rows per block, 64 per warpgroup
constexpr int BLOCK_N = 64;              // keys per K/V tile
constexpr int CONSUMERS = 256;           // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int STAGES = 2;                // K/V ring depth
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory of one block. Every tile is a stack of 64-column blocks
// [D / 64][rows][64] of bf16: one 128-byte row per matrix row, the layout of
// TMA's 128-byte swizzle, and every tile starts on a 1024-byte boundary (the
// swizzle's period), so wgmma descriptors need no base offset.
template <int D>
struct SharedStorage {
  alignas(1024) uint16_t q[D / 64][BLOCK_M][64];
  alignas(1024) uint16_t k[STAGES][D / 64][BLOCK_N][64];
  alignas(1024) uint16_t v[STAGES][D / 64][BLOCK_N][64];
  uint64_t q_full;
  uint64_t k_full[STAGES];
  uint64_t v_full[STAGES];
  uint64_t empty[STAGES];
};

template <int D>
constexpr int smem_bytes() {
  // The dynamic window is aligned up to 1024 bytes inside the kernel.
  return static_cast<int>(sizeof(SharedStorage<D>)) + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait for the completion of the phase of parity `parity`. A wait that
// cannot complete (a fault in the pipeline's bookkeeping) traps after 2^26
// polls, far beyond any launch's run time, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// ---- TMA ------------------------------------------------------------------

// One [rows, 64] box of the 3-D map [bh, seq, D] at (column, row, head) into
// `dst`; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(head)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand in shared memory: start address
// in 16-byte units, 8-row groups 1024 bytes apart (SBO), layout type 1
// (128-byte swizzle). LBO is unused by the K-major layout and by an
// MN-major operand of 64 columns (one swizzle atom wide), so it is 1.
// Stepping along K inside a 128-byte row adds the byte offset to the start
// address; the hardware applies the swizzle to the full address.
__device__ __forceinline__ uint64_t make_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of wgmma's registers across the
// asynchronous region.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ADAPTDL_ACC32(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

#define ADAPTDL_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B in shared memory, both
// K-major. `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ADAPTDL_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ADAPTDL_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers (four bf16 pairs a
// thread), B in shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ADAPTDL_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ADAPTDL_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The accumulator fragment of a 64 x 64 wgmma tile: thread t of the
// warpgroup (warp w = t / 32, lane l = t % 32) holds, for each 8-column
// chunk i, d[4i + e] at row 16w + l/4 + 8(e/2) and column 8i + 2(l%4) + e%2.

// q/k/v: [bh, seq, D] bf16 behind the maps; o: [bh, seq, D] bf16;
// lse: [bh, seq] f32.
template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 2 : 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int seq, int n_qtiles, int causal, float scale_log2) {
  constexpr int DB = D / 64;             // 64-column blocks of the head dim
  constexpr int KSTEPS = D / 16;         // wgmma k-steps of S = Q K^T
  constexpr int PSTEPS = BLOCK_N / 16;   // wgmma k-steps of O += P V
  using Storage = SharedStorage<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Storage& sm = *reinterpret_cast<Storage*>(smem_raw + pad);

  // Tiles of one head are adjacent; within a head the last (under the causal
  // mask the heaviest) query tile goes first.
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (n_qtiles - 1 - blockIdx.x % n_qtiles) * BLOCK_M;
  // Under the causal mask no row of the block sees a key past its last row.
  const int key_end = causal ? min(seq, q0 + BLOCK_M) : seq;
  const int n_tiles = (key_end + BLOCK_N - 1) / BLOCK_N;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // Producer warp: one thread issues every copy. Stage s of tile j is free
    // once all consumer threads released tile j - STAGES; the first wait
    // of each stage passes at once (parity of the phase before the first).
    if (tid == CONSUMERS) {
      constexpr uint32_t q_bytes = DB * BLOCK_M * 64 * 2;
      constexpr uint32_t kv_bytes = DB * BLOCK_N * 64 * 2;
      mbar_expect_tx(&sm.q_full, q_bytes);
#pragma unroll
      for (int c = 0; c < DB; ++c) {
        tma_load(sm.q[c], &q_map, &sm.q_full, c * 64, q0, bh);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(&sm.empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.k_full[s], kv_bytes);
#pragma unroll
        for (int c = 0; c < DB; ++c) {
          tma_load(sm.k[s][c], &k_map, &sm.k_full[s], c * 64, j * BLOCK_N, bh);
        }
        mbar_expect_tx(&sm.v_full[s], kv_bytes);
#pragma unroll
        for (int c = 0; c < DB; ++c) {
          tma_load(sm.v[s][c], &v_map, &sm.v_full[s], c * 64, j * BLOCK_N, bh);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. + 63 ----
  const int wg = tid / 128;
  const int t = tid % 128;
  const int lane = t % 32;
  const int wg_row = q0 + wg * 64;
  const int row0 = wg_row + (t / 32) * 16 + lane / 4;  // and row0 + 8
  const int col0 = 2 * (lane % 4);
  // Warpgroup 0 may need one key tile fewer than the block under the causal
  // mask. That tile is the block's last, so no copy waits for its release.
  const int wg_key_end = causal ? min(seq, wg_row + 64) : seq;
  const int wg_tiles = (wg_key_end + BLOCK_N - 1) / BLOCK_N;

  float acc[DB][32];
#pragma unroll
  for (int c = 0; c < DB; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  }
  float m[2] = {NEG_INF, NEG_INF};  // running row max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums

  mbar_wait(&sm.q_full, 0);
  for (int j = 0; j < wg_tiles; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    const int k0 = j * BLOCK_N;

    // S = Q K^T over this tile's keys.
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    mbar_wait(&sm.k_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint64_t da = make_desc(&sm.q[kk / 4][wg * 64][(kk % 4) * 16]);
      const uint64_t db = make_desc(&sm.k[s][kk / 4][0][(kk % 4) * 16]);
      wgmma_ss(sc, da, db, kk > 0);
    }
    wgmma_commit();
    fence_regs(sc);
    wgmma_wait_all();
    fence_regs(sc);

    // Scores in log2 units; keys past seq, and under the causal mask keys
    // past the row, get NEG_INF. Only tiles that reach past seq or past the
    // warpgroup's first row need the mask.
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
    if (k0 + BLOCK_N > seq || (causal && k0 + BLOCK_N - 1 > wg_row)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + (i / 4) * 8 + col0 + (i % 2);
        const int row = row0 + ((i / 2) % 2) * 8;
        if (key >= seq || (causal && key > row)) sc[i] = NEG_INF;
      }
    }

    // Online softmax on the fragment: rows row0 (h = 0) and row0 + 8 (h = 1)
    // are shared by the 4 threads of a quad.
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * h], sc[4 * i + 2 * h + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[h] = fast_exp2(m[h] - mx);
      m[h] = mx;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      const float p = fast_exp2(sc[i] - m[h]);
      sc[i] = p;
      l[h] += p;
    }
#pragma unroll
    for (int c = 0; c < DB; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i / 2) % 2];
    }

    // P in bf16 as wgmma's register A operand: for k-step kk (keys 16kk ..
    // 16kk + 15), register r holds the pair at accumulator entries
    // 8kk + 2r and + 1.
    uint32_t pf[PSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pf[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      }
    }

    // O += P V, one n64 wgmma per 64-column block of the head dim.
    mbar_wait(&sm.v_full[s], parity);
#pragma unroll
    for (int c = 0; c < DB; ++c) fence_regs(acc[c]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < DB; ++c) {
#pragma unroll
      for (int kk = 0; kk < PSTEPS; ++kk) {
        wgmma_rs(acc[c], pf[kk], make_desc(&sm.v[s][c][kk * 16][0]));
      }
    }
    wgmma_commit();
#pragma unroll
    for (int c = 0; c < DB; ++c) fence_regs(acc[c]);
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < DB; ++c) fence_regs(acc[c]);
    mbar_arrive(&sm.empty[s]);
  }

  // Epilogue: O / l in bf16 and the log-sum-exp, rows below seq only.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const size_t head = static_cast<size_t>(bh) * seq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row < seq) {
      const float safe_l = fmaxf(l[h], 1e-30f);
      const float inv = 1.f / safe_l;
      uint32_t* out = reinterpret_cast<uint32_t*>(
          o + (head + row) * D + col0);
#pragma unroll
      for (int c = 0; c < DB; ++c) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          out[(c * 64 + i * 8) / 2] = pack_bf16(acc[c][4 * i + 2 * h] * inv,
                                                acc[c][4 * i + 2 * h + 1] * inv);
        }
      }
      if (lane % 4 == 0) lse[head + row] = m[h] * LN2 + logf(safe_l);
    }
  }
}

template <int D>
cudaError_t launch(const CUtensorMap& q_map, const CUtensorMap& k_map,
                   const CUtensorMap& v_map, void* o, void* lse, int bh,
                   int seq, int causal, float scale, cudaStream_t stream) {
  const auto kernel = flash_fwd_sm90_kernel<D>;
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (seq + BLOCK_M - 1) / BLOCK_M;
  kernel<<<bh * n_qtiles, THREADS, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), seq, n_qtiles, causal, scale * LOG2E);
  return cudaGetLastError();
}

#define ADAPTDL_LAUNCH_PARAMS                                          \
  const CUtensorMap&, const CUtensorMap&, const CUtensorMap&, void*,   \
      void*, int, int, int, float, cudaStream_t

#ifdef ADAPTDL_PART
// Every object sees every instantiation as external; each object then
// defines its own.
extern template cudaError_t launch<64>(ADAPTDL_LAUNCH_PARAMS);
extern template cudaError_t launch<128>(ADAPTDL_LAUNCH_PARAMS);
template cudaError_t launch<64 * (ADAPTDL_PART + 1)>(ADAPTDL_LAUNCH_PARAMS);
#endif

#if !defined(ADAPTDL_PART) || ADAPTDL_PART == 0

// cuTensorMapEncodeTiled from the driver, found at run time so the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// Errors of the tensor maps, beside cudaError_t's positive codes.
constexpr int ERR_NO_ENCODE = -1;          // driver lacks cuTensorMapEncodeTiled
constexpr int ERR_TENSOR_MAP_BASE = -1000;  // minus the CUresult

// [bh, seq, D] bf16, contiguous; boxes of [rows, 64] with the 128-byte
// swizzle. Rows past seq read as zeros.
int make_map(CUtensorMap* map, const void* base, int bh, int seq, int d,
             int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(seq) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t element_strides[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP_BASE - static_cast<int>(res);
}

}  // namespace adaptdl_flash_sm90

// Returns 0 on success, a cudaError_t of the launch, or a negative tensor-map
// error (see adaptdl_cuda_error_string). q/k/v/o: [bh, seq, head_dim] bf16,
// contiguous, 16-byte aligned; lse: [bh, seq] f32. head_dim 64 or 128.
// Launches on `stream`, does not synchronise.
extern "C" int adaptdl_flash_attention_fwd_sm90(const void* q, const void* k,
                                                const void* v, void* o,
                                                void* lse, int bh, int seq,
                                                int head_dim, int causal,
                                                float scale, void* stream) {
  using namespace adaptdl_flash_sm90;
  if ((head_dim != 64 && head_dim != 128) || bh <= 0 || seq <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap q_map, k_map, v_map;
  int err = make_map(&q_map, q, bh, seq, head_dim, BLOCK_M);
  if (err == 0) err = make_map(&k_map, k, bh, seq, head_dim, BLOCK_N);
  if (err == 0) err = make_map(&v_map, v, bh, seq, head_dim, BLOCK_N);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t res =
      head_dim == 64
          ? launch<64>(q_map, k_map, v_map, o, lse, bh, seq, causal, scale, s)
          : launch<128>(q_map, k_map, v_map, o, lse, bh, seq, causal, scale, s);
  return static_cast<int>(res);
}

// Dynamic shared memory of one block of the head_dim kernel, in bytes; 0
// for a head_dim the library does not build.
extern "C" int adaptdl_flash_attention_fwd_sm90_smem_bytes(int head_dim) {
  using namespace adaptdl_flash_sm90;
  if (head_dim == 64) return smem_bytes<64>();
  if (head_dim == 128) return smem_bytes<128>();
  return 0;
}

extern "C" const char* adaptdl_cuda_error_string(int err) {
  using namespace adaptdl_flash_sm90;
  if (err == ERR_NO_ENCODE) {
    return "the CUDA driver has no cuTensorMapEncodeTiled";
  }
  if (err <= ERR_TENSOR_MAP_BASE) {
    return "cuTensorMapEncodeTiled refused the tensor map";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#else
}  // namespace adaptdl_flash_sm90
#endif

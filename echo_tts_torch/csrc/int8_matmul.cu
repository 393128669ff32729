// W8A8 matmul with dynamic per-row activation quantization (kernel C).
//
// Replaces echo_tts_tpu/ops/pallas/int8_matmul.py:44 `_kernel` (called
// through `_call` :59 and `int8_matmul_fused` :78).  The JAX package's
// production `int8_dot` (ops/quant.py:65) computes the same function with
// XLA; the port's `int8_dot` launches this kernel on the card.
//
// What it computes, for x (M, K) bf16, w (N, K) int8 (the port's
// nn.Linear layout: row n is output channel n) and w_scale (N,) fp32:
//   x_scale[m] = max(max_k |x[m, k]|, 1e-12) / 127          (all of K)
//   xq[m, k]   = clip(rint(x[m, k] / x_scale[m]), -127, 127)  (half to even)
//   acc[m, n]  = sum_k xq[m, k] * w[n, k]                    (exact, int32)
//   out[m, n]  = (float)acc * x_scale[m] * w_scale[n]         (in that order)
// then one round to the output type (fp32 or bf16).  The division is
// IEEE (the build has no --use_fast_math), never a multiply by the
// reciprocal, and rintf rounds half to even as torch.round and jnp.round
// do, so the int32 accumulator equals the plain version's exactly.
//
// What bounds it on the H100 at the main path's shapes: the int8
// tensor-core rate, 1979 TOPS.  At M = 1920, (K, N) = (2048, 5888):
// 2*M*K*N = 46.3 G ops, 23.4 us, against 42.5 MB of bytes (x bf16, w int8,
// out bf16), 12.7 us at 3.35 TB/s; at M = 640 the shapes sit within 2x of
// the byte bound.  Below those bounds, operands come from L2 once per
// tile: a 128 x 256 tile does 171 ops per byte it loads, so at the int8
// peak the 132 SMs would load about 11.6 TB/s from L2.  Larger tiles, or
// one load multicast to a cluster of blocks, would cut that (not done).
//
// Design: two launches from one entry point (one wrapper call, one
// counted launch).
//  1. `int8_quantize_rows_kernel`, a pre-pass: one block of four warps per
//     row takes the abs-max, then quantizes the row (held in registers for
//     K <= 6144, read again from L1/L2 beyond) and writes xq (M, K) int8
//     and x_scale (M,) fp32 into scratch the wrapper allocates.  Its own
//     bound is bytes: M*K*3 (bf16 in, int8 out), 3.5 us at M = 1920,
//     K = 2048.  Each row is quantized once, where the first version of
//     this kernel re-quantized it for each of the N/128 column tiles.
//  2. `int8_matmul_kernel`, the product: xq (M, K) and w (N, K) are both
//     K-major, the only form wgmma takes for 8-bit types, so neither is
//     transposed.  Output tiles of BM = 128 rows by BN = 256 or 128
//     columns; BK = 128 bytes of K per stage, loaded by TMA with the
//     128-byte swizzle into a ring of STAGES stages, each with a full and
//     an empty mbarrier.  One producer thread issues the loads; two
//     consumer warpgroups each run wgmma.m64n{BN}k32.s32.s8.s8 on their 64
//     rows, keep one group of wgmma in flight while they wait for the next
//     stage, and release a stage as soon as the wgmma that read it has
//     retired.  setmaxnreg moves registers from the producer to the
//     consumers.  The epilogue applies x_scale and w_scale to the int32
//     registers in the order above and stores straight to global memory.
//  The tile plan (ops/int8_matmul.py `_tile_plan`), one block per output
//  tile: 128 x 256, which reads the fewest operand bytes from L2 per
//  product, unless that gives fewer than 66 blocks, then 128 x 128.  The
//  registers of one 384-thread block fill an SM, so a plan with more
//  blocks than SMs runs in more than one wave.  Three main-path shapes
//  have fewer than 132 blocks and run in one partial wave: (M, N) =
//  (1920, 2048) has 120 tiles of 128 x 256, (640, 5888) 115, and (640,
//  2048) 80 of 128 x 128.  Halving the tile there would give more blocks
//  than SMs, so some SMs would run two half tiles, which take no less
//  time than one whole tile and read more operand bytes from L2; split-K
//  would add an int32 partial-sum pass over the output.  No split-K: each
//  output
//  element is one block's int32 sum.  Rows >= M, columns >= N and K
//  beyond its end are zero-filled by TMA and not stored; K must be a
//  multiple of 16 (16-byte rows for TMA) and N of 8 (the wrapper checks,
//  and `supported()` says so).
//
// The row-parallel instance (`echo_int8_matmul_partial`), for a K-slice
// of a tensor-parallel layer (wo, w2; echo_tts_torch/parallel/mesh.py):
// the row scale is given, taken over the whole K by the caller (an
// all-reduce MAX of the slices' abs-max, as GSPMD takes it), and the
// product writes the int32 sums without the rescale.  The caller sums the
// slices' int32 outputs (an all-reduce, exact) and rescales once, so the
// sharded layer equals the unsharded one bit for bit.  The same two
// kernels with the pre-pass's abs-max and the epilogue's rescale
// compiled out (template parameters GIVEN and OutT = int).
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;          // rows per block: two consumer warpgroups
constexpr int BK = 128;          // K per stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// clip(rint(v / s), -127, 127) as one byte
__device__ __forceinline__ uint32_t quant_byte(float v, float s) {
  const float q = fminf(fmaxf(rintf(v / s), -127.f), 127.f);
  return (uint32_t)(int)q & 0xFFu;
}

__device__ __forceinline__ float amax8(const uint4& v, float amax) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
  }
  return amax;
}

// 8 bf16 of x as 8 int8
__device__ __forceinline__ uint2 quant8(const uint4& v, float s) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  uint32_t word[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    word[i / 2] |= (quant_byte(f.x, s) << (16 * (i % 2))) |
                   (quant_byte(f.y, s) << (16 * (i % 2) + 8));
  }
  return make_uint2(word[0], word[1]);
}

// One block of 128 threads per row: abs-max, then clip(rint(x / scale)).
// A row is spread over four warps, so that enough warps are in flight to
// hide the latency of the per-element IEEE division.  With CH > 0 (K <=
// 1024 * CH) each thread loads its CH 16-byte chunks at once and keeps
// them in registers, so x is read once; CH == 0 takes any K and reads the
// row twice, the second time from L1/L2.  GIVEN reads the row's scale
// from x_scale instead of taking and writing it.
template <int CH, bool GIVEN>
__global__ void __launch_bounds__(128)
int8_quantize_rows_kernel(const __nv_bfloat16* __restrict__ x,
                          int8_t* __restrict__ xq, float* __restrict__ x_scale,
                          int K) {
  __shared__ float warp_max[4];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const __nv_bfloat16* xr = x + (long long)row * K;
  int8_t* qr = xq + (long long)row * K;
  constexpr int STEP = 128 * 8;   // elements per pass of the block
  uint4 v[CH > 0 ? CH : 1];
  if constexpr (CH > 0) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = i * STEP + tid * 8;
      v[i] = c < K ? *reinterpret_cast<const uint4*>(xr + c)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  float s;
  if constexpr (GIVEN) {
    s = x_scale[row];
  } else {
    float amax = 0.f;
    if constexpr (CH > 0) {
#pragma unroll
      for (int i = 0; i < CH; ++i) amax = amax8(v[i], amax);
    } else {
#pragma unroll 4
      for (int c = tid * 8; c < K; c += STEP)
        amax = amax8(*reinterpret_cast<const uint4*>(xr + c), amax);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (tid % 32 == 0) warp_max[tid / 32] = amax;
    __syncthreads();
    amax = fmaxf(fmaxf(warp_max[0], warp_max[1]),
                 fmaxf(warp_max[2], warp_max[3]));
    s = fmaxf(amax, 1e-12f) / 127.f;
    if (tid == 0) x_scale[row] = s;
  }
  if constexpr (CH > 0) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = i * STEP + tid * 8;
      if (c < K) *reinterpret_cast<uint2*>(qr + c) = quant8(v[i], s);
    }
  } else {
#pragma unroll 4
    for (int c = tid * 8; c < K; c += STEP)
      *reinterpret_cast<uint2*>(qr + c) =
          quant8(*reinterpret_cast<const uint4*>(xr + c), s);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(int* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

template <int BN>
struct GemmSmem {
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BAR_OFFSET = STAGES * STAGE_BYTES;
  // + 1024 to align the base by hand
  static constexpr int TOTAL = BAR_OFFSET + 2 * STAGES * 8 + 1024;
};

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&acc)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 256)
    wgmma_m64n256k32_s8_ss(acc, da, db, 1);
  else
    wgmma_m64n128k32_s8_ss(acc, da, db, 1);
}

// 384 threads: 168 registers each at entry; the producer gives back what
// the consumers take.
template <int BN, typename OutT>
__global__ void __launch_bounds__(384, 1)
int8_matmul_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b,
                   const float* __restrict__ x_scale,
                   const float* __restrict__ w_scale,
                   OutT* __restrict__ out, int M, int N, int K) {
  using L = GemmSmem<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_aligned_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFFSET);
  uint64_t* empty = full + STAGES;

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int n_k = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 4);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        uint8_t* a = smem + s * L::STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], L::STAGE_BYTES);
        tma_load_2d(a, &tm_a, &full[s], kt * BK, m0);
        tma_load_2d(a + L::A_BYTES, &tm_b, &full[s], kt * BK, n0);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x / 32) % 4;
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint8_t* a = smem + s * L::STAGE_BYTES + wg * 64 * BK;
      const uint8_t* b = smem + s * L::STAGE_BYTES + L::A_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8<BN>(acc, desc_sw128(a + kk * 32, 16, 1024),
                     desc_sw128(b + kk * 32, 16, 1024));
      wgmma_commit();
      // the previous stage's wgmma has retired once at most this one is
      // in flight: hand that stage back to the producer
      wgmma_wait<1>();
      fence_regs(acc);
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // epilogue: (float)acc * x_scale * w_scale, rounded once to OutT; the
    // int32 sums themselves for OutT = int
    const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
    const int r1 = r0 + 8;
    if constexpr (std::is_same_v<OutT, int>) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        if (col >= N) continue;
        if (r0 < M) store2(out + (long long)r0 * N + col, acc[4 * j],
                           acc[4 * j + 1]);
        if (r1 < M) store2(out + (long long)r1 * N + col, acc[4 * j + 2],
                           acc[4 * j + 3]);
      }
    } else {
      const float s0 = r0 < M ? x_scale[r0] : 0.f;
      const float s1 = r1 < M ? x_scale[r1] : 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        if (col >= N) continue;   // N % 8 == 0, so col + 1 < N as well
        const float ws0 = w_scale[col];
        const float ws1 = w_scale[col + 1];
        if (r0 < M)
          store2(out + (long long)r0 * N + col, (float)acc[4 * j] * s0 * ws0,
                 (float)acc[4 * j + 1] * s0 * ws1);
        if (r1 < M)
          store2(out + (long long)r1 * N + col,
                 (float)acc[4 * j + 2] * s1 * ws0,
                 (float)acc[4 * j + 3] * s1 * ws1);
      }
    }
  }
}

template <int BN, typename OutT>
int launch_gemm(const void* xq, const void* w, const float* xs,
                const float* ws, void* out, int M, int N, int K,
                cudaStream_t st) {
  using L = GemmSmem<BN>;
  static const int attr = allow_smem(int8_matmul_kernel<BN, OutT>, L::TOTAL);
  if (attr) return attr;
  CUtensorMap ta, tb;
  const uint64_t dims_a[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t dims_b[2] = {(uint64_t)K, (uint64_t)N};
  const uint64_t stride[1] = {(uint64_t)K};
  const uint32_t box_a[2] = {BK, BM};
  const uint32_t box_b[2] = {BK, BN};
  int rc;
  if ((rc = make_map(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, dims_a, stride,
                     box_a, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (rc = make_map(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dims_b, stride,
                     box_b, CU_TENSOR_MAP_SWIZZLE_128B)))
    return rc;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<BN, OutT><<<grid, 384, L::TOTAL, st>>>(
      ta, tb, xs, ws, reinterpret_cast<OutT*>(out), M, N, K);
  return (int)cudaGetLastError();
}

template <bool GIVEN>
int quantize_rows(const __nv_bfloat16* x, int8_t* xq, float* x_scale, int M,
                  int K, cudaStream_t st) {
  if (K <= 1024 * 2)
    int8_quantize_rows_kernel<2, GIVEN><<<M, 128, 0, st>>>(x, xq, x_scale, K);
  else if (K <= 1024 * 6)
    int8_quantize_rows_kernel<6, GIVEN><<<M, 128, 0, st>>>(x, xq, x_scale, K);
  else
    int8_quantize_rows_kernel<0, GIVEN><<<M, 128, 0, st>>>(x, xq, x_scale, K);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes (echo_tts_torch/ops/int8_matmul.py).
// x (M, K) bf16, w (N, K) int8, out (M, N) and the scratch xq (M, K) int8
// are contiguous and 16-byte aligned; w_scale and the scratch x_scale are
// (N,) and (M,) fp32; out is bf16 when out_bf16 != 0, else fp32.  K % 16
// == 0 and N % 8 == 0; bn (128 or 256) is the column tile of the wrapper's
// tile plan.  Launches the pre-pass and the product back to back on
// `stream`; returns 0 or the first cudaError_t.
extern "C" int echo_int8_matmul(const void* x, const void* w,
                                const void* w_scale, void* out, void* xq,
                                void* x_scale, int M, int N, int K,
                                int out_bf16, int bn, void* stream) {
  if (M < 1 || N < 8 || K < 16 || N % 8 || K % 16 || (bn != 128 && bn != 256))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  int8_t* xqb = reinterpret_cast<int8_t*>(xq);
  float* xsb = reinterpret_cast<float*>(x_scale);
  const int rc = quantize_rows<false>(xb, xqb, xsb, M, K, st);
  if (rc) return rc;
  const float* xs = reinterpret_cast<const float*>(x_scale);
  const float* ws = reinterpret_cast<const float*>(w_scale);
  if (bn == 256)
    return out_bf16
        ? launch_gemm<256, __nv_bfloat16>(xq, w, xs, ws, out, M, N, K, st)
        : launch_gemm<256, float>(xq, w, xs, ws, out, M, N, K, st);
  return out_bf16
      ? launch_gemm<128, __nv_bfloat16>(xq, w, xs, ws, out, M, N, K, st)
      : launch_gemm<128, float>(xq, w, xs, ws, out, M, N, K, st);
}

// The row-parallel instance: x (M, K) bf16 quantized with the given row
// scales x_scale (M,) fp32 into the scratch xq (M, K) int8, then out (M, N)
// int32 = xq @ w^T, not rescaled.  The same layouts and limits as above.
extern "C" int echo_int8_matmul_partial(const void* x, const void* w,
                                        const void* x_scale, void* out,
                                        void* xq, int M, int N, int K, int bn,
                                        void* stream) {
  if (M < 1 || N < 8 || K < 16 || N % 8 || K % 16 || (bn != 128 && bn != 256))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int rc = quantize_rows<true>(
      reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<int8_t*>(xq),
      const_cast<float*>(reinterpret_cast<const float*>(x_scale)), M, K, st);
  if (rc) return rc;
  return bn == 256
      ? launch_gemm<256, int>(xq, w, nullptr, nullptr, out, M, N, K, st)
      : launch_gemm<128, int>(xq, w, nullptr, nullptr, out, M, N, K, st);
}

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
// Design: one block of 8 warps per (128-row, 128-column) output tile;
// blockIdx.x walks N so that neighbouring blocks share their rows of x in
// L2.  The block first reads its 128 rows over all of K for the abs-max
// (K = 5888 int8 rows of 128 would not fit in shared memory, so the rows
// are read again per K tile rather than held).  It then walks K in tiles
// of 64: bf16 x is loaded, divided by its row scale, rounded, clipped and
// stored as int8 in shared memory; the int8 weight tile is copied as it
// is, since (N, K) row-major is exactly the "col" B operand of
// mma.sync.m16n8k32.s8.  Each warp owns a 64 x 32 tile of int32
// accumulators in registers.  Rows >= M and columns >= N are zero-filled
// and not stored; K must be a multiple of 16 and N of 8 (the wrapper
// checks, and `supported()` says so).
//
// Bound on the H100 at the main path's shapes: the int8 tensor-core rate,
// 1979 TOPS.  At M = 1920, (K, N) = (2048, 5888): 2*M*K*N = 46.3 G ops,
// 23.4 us, against 42.5 MB of bytes (x bf16, w int8, out bf16), 12.7 us at
// 3.35 TB/s.  This simple version is far from that: every block of a row
// panel re-reads and re-quantizes the same x rows (N/128 times over, from
// L2), loads are not overlapped with math (no cp.async or TMA ring), and
// mma.sync is not wgmma.  A pre-pass that quantizes x once, a TMA-fed
// wgmma s8 main loop and a persistent tile schedule are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;         // rows of x per block
constexpr int BN = 128;         // output columns per block
constexpr int BK = 64;          // K per tile (int8 bytes)
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int WM = 64;          // warp tile rows (2 warps over M)
constexpr int WN = 32;          // warp tile columns (4 warps over N)
constexpr int LDS = BK + 16;    // shared row stride in bytes: 16-B aligned,
                                // and the 8 rows of a fragment hit 8
                                // distinct 4-bank groups

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// clip(rint(v / s), -127, 127) as one byte
__device__ __forceinline__ uint32_t quant_byte(float v, float s) {
  const float q = fminf(fmaxf(rintf(v / s), -127.f), 127.f);
  return (uint32_t)(int)q & 0xFFu;
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename OutT>
__global__ void __launch_bounds__(NTHREADS)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ w_scale,
                   OutT* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  __shared__ float xs[BM];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;      // row within the 8-row group
  const int t = lane & 3;       // 4-byte column group within the quad
  const int wm = warp / (BN / WN);
  const int wn = warp % (BN / WN);

  // 1. the row scales, each from the abs-max over all of K
  for (int r = warp; r < BM; r += NWARPS) {
    const int gr = m0 + r;
    float amax = 0.f;
    if (gr < M) {
      const __nv_bfloat16* row = x + (long long)gr * K;
      for (int c = lane * 8; c < K; c += 32 * 8) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + c);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(h[i]);
          amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
        }
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) xs[r] = fmaxf(amax, 1e-12f) / 127.f;
  }
  __syncthreads();

  int acc[WM / 16][WN / 8][4];
#pragma unroll
  for (int mi = 0; mi < WM / 16; ++mi)
#pragma unroll
    for (int ni = 0; ni < WN / 8; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // 2. x tile: 8 bf16 a thread -> 8 int8 in shared memory
    for (int i = threadIdx.x; i < BM * (BK / 8); i += NTHREADS) {
      const int r = i / (BK / 8);
      const int c = (i % (BK / 8)) * 8;
      const int gr = m0 + r;
      const int gc = k0 + c;
      uint2 packed = make_uint2(0u, 0u);
      if (gr < M && gc < K) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(x + (long long)gr * K + gc);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
        const float s = xs[r];
        uint32_t word[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          word[j / 2] |= (quant_byte(f.x, s) << (16 * (j % 2))) |
                         (quant_byte(f.y, s) << (16 * (j % 2) + 8));
        }
        packed = make_uint2(word[0], word[1]);
      }
      *reinterpret_cast<uint2*>(As + r * LDS + c) = packed;
    }
    // 3. weight tile: 16 int8 a thread, copied as they are
    for (int i = threadIdx.x; i < BN * (BK / 16); i += NTHREADS) {
      const int r = i / (BK / 16);
      const int c = (i % (BK / 16)) * 16;
      const int gn = n0 + r;
      const int gc = k0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gn < N && gc < K)
        v = *reinterpret_cast<const uint4*>(w + (long long)gn * K + gc);
      *reinterpret_cast<uint4*>(Bs + r * LDS + c) = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[WM / 16][4];
      uint32_t b[WN / 8][2];
#pragma unroll
      for (int mi = 0; mi < WM / 16; ++mi) {
        const int8_t* p = As + (wm * WM + mi * 16 + g) * LDS + kk + 4 * t;
        a[mi][0] = ld32(p);
        a[mi][1] = ld32(p + 8 * LDS);
        a[mi][2] = ld32(p + 16);
        a[mi][3] = ld32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < WN / 8; ++ni) {
        const int8_t* p = Bs + (wn * WN + ni * 8 + g) * LDS + kk + 4 * t;
        b[ni][0] = ld32(p);
        b[ni][1] = ld32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < WM / 16; ++mi)
#pragma unroll
        for (int ni = 0; ni < WN / 8; ++ni)
          mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    __syncthreads();
  }

  // 4. epilogue: (float)acc * x_scale * w_scale, rounded once to OutT
#pragma unroll
  for (int ni = 0; ni < WN / 8; ++ni) {
    const int col = n0 + wn * WN + ni * 8 + 2 * t;
    if (col >= N) continue;   // N % 8 == 0, so col + 1 < N as well
    const float ws0 = w_scale[col];
    const float ws1 = w_scale[col + 1];
#pragma unroll
    for (int mi = 0; mi < WM / 16; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * WM + mi * 16 + g + 8 * half;
        const int gr = m0 + r;
        if (gr >= M) continue;
        const float s = xs[r];
        const float v0 = (float)acc[mi][ni][2 * half] * s * ws0;
        const float v1 = (float)acc[mi][ni][2 * half + 1] * s * ws1;
        store2(out + (long long)gr * N + col, v0, v1);
      }
    }
  }
}

}  // namespace

// C entry point, loaded with ctypes (echo_tts_torch/ops/int8_matmul.py).
// x (M, K) bf16, w (N, K) int8 and out (M, N) are contiguous and 16-byte
// aligned; w_scale is (N,) fp32; out is bf16 when out_bf16 != 0, else
// fp32.  K % 16 == 0 and N % 8 == 0.  Returns cudaGetLastError() after
// the launch.
extern "C" int echo_int8_matmul(const void* x, const void* w,
                                const void* w_scale, void* out, int M, int N,
                                int K, int out_bf16, void* stream) {
  if (M < 1 || N < 8 || K < 16 || N % 8 || K % 16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = reinterpret_cast<const __nv_bfloat16*>(x);
  const int8_t* wp = reinterpret_cast<const int8_t*>(w);
  const float* sp = reinterpret_cast<const float*>(w_scale);
  if (out_bf16)
    int8_matmul_kernel<__nv_bfloat16><<<grid, NTHREADS, 0, st>>>(
        xp, wp, sp, reinterpret_cast<__nv_bfloat16*>(out), M, N, K);
  else
    int8_matmul_kernel<float><<<grid, NTHREADS, 0, st>>>(
        xp, wp, sp, reinterpret_cast<float*>(out), M, N, K);
  return (int)cudaGetLastError();
}

// The S1-DAC codec's three dilated residual units, fused in one launch.
//
// Replaces echo_tts_tpu/ops/pallas/res_stack.py:_res_stack_kernel.
// For d in (1, 3, 9):  x += conv_k1(snake(conv_k7_dil_d(snake(x))))
// with the Pallas kernel's rounding points: snake in fp32 then cast to
// bf16; conv with fp32 accumulation, + bias, then cast; the residual add in
// bf16.  snake(v) = v + sin^2(a v) / (a + 1e-9), exact sinf (this file must
// not be built with --use_fast_math) or the sin2_poly polynomial.
//
// Design: one block per (L-tile of BL frames, batch row).  The block reads
// its own 78-frame left context (6 * (1 + 3 + 9)) straight from the input,
// since Hopper runs blocks in parallel and in no order; no halo array is
// precomputed.  The tile and its context live in shared memory as bf16
// (X), next to one buffer for snake1(X) (Y).  Unit u only recomputes the
// rows whose receptive field lies inside the buffer, so the valid region
// shrinks by 6*d per unit and exactly the tile is left after the third.
// Frames before the sequence start are loaded as zero and forced back to
// zero after each unit, which reproduces the causal left pad of every conv
// (a bias or a snake of zeros is not zero); this is the TPU kernel's
// "tile 0 zeroes the halo".
//
// Each warp owns 16 rows at a time.  The k7 conv runs as mma.sync with A
// fragments from Y and B fragments (bf16 weights, laid out (Cout, Cin) per
// tap) from global memory, where L2 keeps the 3 * 8 * C^2 weights (7.1 MB
// at C = 384, more than a block's 227 KB of shared memory).  Its output
// C fragments become, after bias, cast and snake, the A fragments of the
// k1 conv directly in registers, so the intermediate never touches memory;
// the k1 conv's output is added into X.
//
// Bound on the H100: ~48 C^2 FLOP per frame (2.9 TFLOP per decode of 640
// latents, 1.16 TFLOP alone in the C = 384 block), so the tensor-core rate
// bounds it; this first version reloads every weight fragment from L1/L2
// per 16 rows and recomputes the halo rows (1.75x the rows at C = 384),
// so it runs well below that bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HALO = 78;  // 6 * (1 + 3 + 9)
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;

// sin2_poly constants (echo_tts_torch/ops/activations.py)
constexpr float PI_HI = 3.140625f;
constexpr float PI_LO = 9.67653589793e-4f;  // float32(pi - 3.140625)
constexpr float INV_PI = 0.318309886183790672f;
constexpr float C0 = 9.869597907896603f, C1 = -32.46839063007976f,
                C2 = 42.686220577408491f, C3 = -29.642546184449031f,
                C4 = 10.952207549847412f;

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

template <bool APPROX>
__device__ __forceinline__ float sin2(float z) {
  if (APPROX) {
    const float k = rintf(z * INV_PI);
    const float r = (z - k * PI_HI) - k * PI_LO;
    const float u = r * INV_PI;
    const float v = u * u;
    return v * (C0 + v * (C1 + v * (C2 + v * (C3 + v * C4))));
  } else {
    const float s = sinf(z);
    return s * s;
  }
}

// fp32 snake of a bf16 value, rounded back to bf16
template <bool APPROX>
__device__ __forceinline__ __nv_bfloat16 snake(float v, float a) {
  return __float2bfloat16_rn(v + (1.0f / (a + 1e-9f)) * sin2<APPROX>(a * v));
}

template <int C, bool APPROX>
__global__ void __launch_bounds__(NTHREADS)
res_stack_kernel(const __nv_bfloat16* __restrict__ x,
                 __nv_bfloat16* __restrict__ out,
                 const __nv_bfloat16* __restrict__ w1,  // (3, 7, Cout, Cin)
                 const float* __restrict__ b1,          // (3, C)
                 const float* __restrict__ a1,          // (3, C)
                 const __nv_bfloat16* __restrict__ w2,  // (3, Cout, Cin)
                 const float* __restrict__ b2,          // (3, C)
                 const float* __restrict__ a2,          // (3, C)
                 int L, int BL) {
  constexpr int LD = C + PAD;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const int N = BL + HALO;
  __nv_bfloat16* Xs = smem;
  __nv_bfloat16* Ys = smem + N * LD;

  const int start = blockIdx.x * BL;  // position of buffer row HALO
  const int p0 = start - HALO;        // position of buffer row 0
  const long long base = (long long)blockIdx.y * L;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  for (int i = threadIdx.x; i < N * (C / 8); i += NTHREADS) {
    const int r = i / (C / 8);
    const int c = (i % (C / 8)) * 8;
    const int p = p0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (p >= 0 && p < L)
      v = *reinterpret_cast<const uint4*>(x + (base + p) * C + c);
    *reinterpret_cast<uint4*>(Xs + r * LD + c) = v;
  }
  __syncthreads();

  int v_prev = 0;
#pragma unroll 1
  for (int u = 0; u < 3; ++u) {
    const int d = (u == 0) ? 1 : (u == 1 ? 3 : 9);
    const int v_cur = v_prev + 6 * d;
    const float* a1u = a1 + u * C;
    const float* a2u = a2 + u * C;
    const float* b1u = b1 + u * C;
    const float* b2u = b2 + u * C;

    // Y = snake1(X) on the rows this unit reads
    for (int i = threadIdx.x; i < (N - v_prev) * (C / 2); i += NTHREADS) {
      const int r = v_prev + i / (C / 2);
      const int c = (i % (C / 2)) * 2;
      const __nv_bfloat162 xv =
          *reinterpret_cast<const __nv_bfloat162*>(Xs + r * LD + c);
      const __nv_bfloat16 y0 = snake<APPROX>(__bfloat162float(xv.x), a1u[c]);
      const __nv_bfloat16 y1 =
          snake<APPROX>(__bfloat162float(xv.y), a1u[c + 1]);
      *reinterpret_cast<uint32_t*>(Ys + r * LD + c) = pack2(y0, y1);
    }
    __syncthreads();

    // rows [v_cur, N) in 16-row chunks from the top; a chunk may reach
    // below v_cur (those rows are computed but not written)
    const int n_chunks = (N - v_cur + 15) / 16;
#pragma unroll 1
    for (int ci = warp; ci < n_chunks; ci += NWARPS) {
      const int r0 = N - 16 * (ci + 1);
      const int ra = r0 + g;
      const int rb = ra + 8;

      // conv k7 (dilation d) + b1 -> bf16 -> snake2 -> bf16, kept as the
      // A fragments of the k1 conv
      uint32_t zf[C / 16][4];
#pragma unroll
      for (int jg = 0; jg < C / 16; ++jg) {
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 1
        for (int tap = 0; tap < 7; ++tap) {
          const int sa = ra - 6 * d + tap * d;
          const int sb = sa + 8;
          const __nv_bfloat16* ya = Ys + sa * LD + 2 * t;
          const __nv_bfloat16* yb = Ys + sb * LD + 2 * t;
          const __nv_bfloat16* w0 =
              w1 + ((long long)(u * 7 + tap) * C + jg * 16 + g) * C + 2 * t;
          const __nv_bfloat16* w8 = w0 + 8 * C;
#pragma unroll 4
          for (int kk = 0; kk < C / 16; ++kk) {
            uint32_t a[4];
            a[0] = sa >= 0 ? ld32(ya + kk * 16) : 0u;
            a[1] = sb >= 0 ? ld32(yb + kk * 16) : 0u;
            a[2] = sa >= 0 ? ld32(ya + kk * 16 + 8) : 0u;
            a[3] = sb >= 0 ? ld32(yb + kk * 16 + 8) : 0u;
            mma16816(acc[0], a, ldg32(w0 + kk * 16), ldg32(w0 + kk * 16 + 8));
            mma16816(acc[1], a, ldg32(w8 + kk * 16), ldg32(w8 + kk * 16 + 8));
          }
        }
        __nv_bfloat16 zb[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ch = jg * 16 + nt * 8 + 2 * t + (i & 1);
            const float z = __bfloat162float(
                __float2bfloat16_rn(acc[nt][i] + b1u[ch]));
            zb[nt][i] = snake<APPROX>(z, a2u[ch]);
          }
        }
        zf[jg][0] = pack2(zb[0][0], zb[0][1]);
        zf[jg][1] = pack2(zb[0][2], zb[0][3]);
        zf[jg][2] = pack2(zb[1][0], zb[1][1]);
        zf[jg][3] = pack2(zb[1][2], zb[1][3]);
      }

      // conv k1 + b2 -> bf16, residual add into X (bf16)
#pragma unroll 1
      for (int nt = 0; nt < C / 8; ++nt) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        const __nv_bfloat16* wr =
            w2 + ((long long)u * C + nt * 8 + g) * C + 2 * t;
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk)
          mma16816(acc, zf[kk], ldg32(wr + kk * 16), ldg32(wr + kk * 16 + 8));
        const int ch = nt * 8 + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = half ? rb : ra;
          if (r < v_cur) continue;
          __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(Xs + r * LD + ch);
          __nv_bfloat162 nv = __floats2bfloat162_rn(0.f, 0.f);
          if (p0 + r >= 0) {
            const __nv_bfloat162 xv = *xp;
            const float z0 = __bfloat162float(
                __float2bfloat16_rn(acc[2 * half] + b2u[ch]));
            const float z1 = __bfloat162float(
                __float2bfloat16_rn(acc[2 * half + 1] + b2u[ch + 1]));
            nv = __floats2bfloat162_rn(__bfloat162float(xv.x) + z0,
                                       __bfloat162float(xv.y) + z1);
          }
          *xp = nv;
        }
      }
    }
    __syncthreads();
    v_prev = v_cur;
  }

  for (int i = threadIdx.x; i < BL * (C / 8); i += NTHREADS) {
    const int r = HALO + i / (C / 8);
    const int c = (i % (C / 8)) * 8;
    const int p = p0 + r;
    if (p < L)
      *reinterpret_cast<uint4*>(out + (base + p) * C + c) =
          *reinterpret_cast<const uint4*>(Xs + r * LD + c);
  }
}

template <int C, bool APPROX>
int launch(const void* x, void* out, const void* w1, const void* b1,
           const void* a1, const void* w2, const void* b2, const void* a2,
           int batch, int L, int BL, cudaStream_t st) {
  const size_t smem = (size_t)2 * (BL + HALO) * (C + PAD) * 2;
  auto kern = res_stack_kernel<C, APPROX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BL - 1) / BL, batch);
  kern<<<grid, NTHREADS, smem, st>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)out,
      (const __nv_bfloat16*)w1, (const float*)b1, (const float*)a1,
      (const __nv_bfloat16*)w2, (const float*)b2, (const float*)a2, L, BL);
  return (int)cudaGetLastError();
}

template <int C>
int launch_c(int approx, const void* x, void* out, const void* w1,
             const void* b1, const void* a1, const void* w2, const void* b2,
             const void* a2, int batch, int L, int BL, cudaStream_t st) {
  return approx ? launch<C, true>(x, out, w1, b1, a1, w2, b2, a2, batch, L,
                                  BL, st)
                : launch<C, false>(x, out, w1, b1, a1, w2, b2, a2, batch, L,
                                   BL, st);
}

}  // namespace

// C entry point, loaded with ctypes (echo_tts_torch/ops/res_stack.py).
// x/out: (batch, L, C) bf16 contiguous; w1 (3, 7, Cout, Cin) and
// w2 (3, Cout, Cin) bf16; biases and alphas (3, C) fp32.  C must be one of
// the instantiated widths.  Returns cudaGetLastError() after launch.
extern "C" int echo_res_stack_bf16(const void* x, void* out, const void* w1,
                                   const void* b1, const void* a1,
                                   const void* w2, const void* b2,
                                   const void* a2, int batch, int L, int C,
                                   int BL, int approx, void* stream) {
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (C) {
    case 64: return launch_c<64>(approx, x, out, w1, b1, a1, w2, b2, a2, batch, L, BL, st);
    case 96: return launch_c<96>(approx, x, out, w1, b1, a1, w2, b2, a2, batch, L, BL, st);
    case 128: return launch_c<128>(approx, x, out, w1, b1, a1, w2, b2, a2, batch, L, BL, st);
    case 192: return launch_c<192>(approx, x, out, w1, b1, a1, w2, b2, a2, batch, L, BL, st);
    case 256: return launch_c<256>(approx, x, out, w1, b1, a1, w2, b2, a2, batch, L, BL, st);
    case 384: return launch_c<384>(approx, x, out, w1, b1, a1, w2, b2, a2, batch, L, BL, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The DiT layer's fp32 norm islands in one pass (kernel D).
//
// No Pallas counterpart: a port-only fusion of the plain compositions in
// echo_tts_torch/ops/norms.py and ops/rope.py, which the JAX package
// leaves to XLA's fusion (echo_tts_tpu/ops/norms.py, ops/rope.py).  In
// PyTorch each of those islands is a chain of ATen kernels (upcast,
// square, mean, rsqrt, multiplies, casts, a stack and a cat for RoPE),
// each reading and writing the whole (GB * S, 2048) activation.  Per DiT
// layer and Euler step they move about 232 bytes an activation element;
// this kernel moves 16: each activation is read once in bf16 and written
// once, and every intermediate stays in registers.
//
// Two instances, one entry point each:
//
//  1. `dit_adaln_kernel` (echo_dit_adaln), the normalise-and-modulate of
//     low-rank AdaLN, twice a layer: for x (rows, M) bf16 with rows =
//     GB * S, and shift, scale (GB, M) bf16 (row r takes batch r / S),
//       xn  = x * rsqrt(mean(x * x) + eps)                (fp32)
//       out = bf16(xn * f32(bf16(scale + 1)) + shift)
//     where scale + 1 rounds to bf16 first, as the plain version adds it
//     in the conditioning dtype.  One warp a row: each lane loads its
//     ADALN_CH 16-byte chunks of the row at once (M <= 2048, the DiT's
//     width; chunks past M are masked), keeps them in registers while the
//     warp sums the squares, then modulates and stores them.  Four warps a
//     block, so that a lone request's 960 rows still give 240 blocks and
//     bulk's 15 360 rows 3840.
//  2. `dit_qk_rope_kernel` (echo_dit_qk_rope), once a layer: the Q and K
//     RMSNorm over each head's Dh = 128 values with the (H, Dh) weight,
//     the result rounded to bf16 (where the plain composition stores
//     rms_norm's output), then RoPE on the interleaved (even, odd) pairs
//     of the heads below n_rot in fp32, and one store in bf16.  q and k
//     (GB, S, H, Dh) bf16 in one launch: head rows [0, R) are q's and [R,
//     2R) k's, R = GB * S * H.  freqs (S, Dh / 2, 2) fp32 holds each query
//     position's (cos, sin) table rows as the forward gathered them, so a
//     block program's traced start needs nothing here.  Half a warp a
//     head row, 8 values a lane; each half-warp takes QK_ROWS consecutive
//     head rows and starts their loads together.
//
// What bounds it on the H100: bytes.  Both instances do a few operations a
// byte, far below the 295 FLOP a byte of the bf16 ridge: at bulk's q-batch
// (GB = 24, S = 640, M = 2048) an AdaLN call moves 126 MB (37.6 us at
// 3.35 TB/s) and a Q/K call 252 MB (75.1 us).  The design keeps the loads
// 16 bytes a lane and coalesced (a warp instruction reads 512 contiguous
// bytes), has each lane keep several loads in flight before it waits, and
// reads nothing twice from device memory: shift, scale, the norm weights
// and the RoPE table are a few KB per batch row or position and come from
// L1 and L2.
//
// Numerics: every product, sum and rounding of the plain versions, in
// their order and without contraction into fma (__fmul_rn, __fadd_rn),
// so the outputs differ from the plain versions' on the card only where
// the fp32 sum of squares is taken in another order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ADALN_WARPS = 4;   // rows per block of the AdaLN instance
constexpr int ADALN_CH = 8;      // 16-byte chunks a lane: rows of <= 2048
constexpr int QK_THREADS = 128;  // 8 half-warps
constexpr int QK_ROWS = 4;       // head rows per half-warp
constexpr int HEAD_DIM = 128;    // 16 lanes x 8 values

__device__ __forceinline__ void unpack8(const uint4& v, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float f[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ float sum_squares8(const uint4& v, float acc) {
  float f[8];
  unpack8(v, f);
#pragma unroll
  for (int j = 0; j < 8; ++j) acc = __fadd_rn(acc, __fmul_rn(f[j], f[j]));
  return acc;
}

__global__ void __launch_bounds__(ADALN_WARPS * 32)
dit_adaln_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ shift,
                 const __nv_bfloat16* __restrict__ scale,
                 __nv_bfloat16* __restrict__ out, int rows, int S, int M,
                 float eps) {
  const int row = blockIdx.x * ADALN_WARPS + threadIdx.x / 32;
  if (row >= rows) return;   // a whole warp: the shuffles below stay full
  const int lane = threadIdx.x % 32;
  const long long base = (long long)row * M;
  const long long cond = (long long)(row / S) * M;
  uint4 v[ADALN_CH];
#pragma unroll
  for (int i = 0; i < ADALN_CH; ++i) {
    const int c = (i * 32 + lane) * 8;
    v[i] = c < M ? load16(x + base + c) : make_uint4(0u, 0u, 0u, 0u);
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < ADALN_CH; ++i) ss = sum_squares8(v[i], ss);
#pragma unroll
  for (int o = 16; o; o >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / (float)M), eps));
#pragma unroll
  for (int i = 0; i < ADALN_CH; ++i) {
    const int c = (i * 32 + lane) * 8;
    if (c >= M) continue;
    float f[8], sc[8], sh[8];
    unpack8(v[i], f);
    unpack8(load16(scale + cond + c), sc);
    unpack8(load16(shift + cond + c), sh);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float s1 = round_bf16(__fadd_rn(sc[j], 1.f));
      f[j] = __fadd_rn(__fmul_rn(__fmul_rn(f[j], r), s1), sh[j]);
    }
    *reinterpret_cast<uint4*>(out + base + c) = pack8(f);
  }
}

__global__ void __launch_bounds__(QK_THREADS)
dit_qk_rope_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ wq,
                   const __nv_bfloat16* __restrict__ wk,
                   const float* __restrict__ freqs,
                   __nv_bfloat16* __restrict__ q_out,
                   __nv_bfloat16* __restrict__ k_out, long long R, int S,
                   int H, int n_rot, float eps) {
  const long long first =
      ((long long)blockIdx.x * QK_THREADS + threadIdx.x) / 16 * QK_ROWS;
  const int sub = threadIdx.x % 16;   // the lane's 8 values: sub * 8 ...
  uint4 v[QK_ROWS];
#pragma unroll
  for (int i = 0; i < QK_ROWS; ++i) {
    const long long hr = first + i;
    const __nv_bfloat16* src = hr < R ? q + hr * HEAD_DIM
                                      : k + (hr - R) * HEAD_DIM;
    v[i] = hr < 2 * R ? load16(src + sub * 8) : make_uint4(0u, 0u, 0u, 0u);
  }
  // rows past 2R are zeros that no lane stores; every lane stays for the
  // half-warp's shuffles
#pragma unroll
  for (int i = 0; i < QK_ROWS; ++i) {
    const long long hr = first + i;
    const bool is_k = hr >= R;
    const long long t = is_k ? hr - R : hr;   // (gb, s, h) row of q or k
    const int h = (int)(t % H);
    const int s = (int)(t / H % S);
    float ss = sum_squares8(v[i], 0.f);
#pragma unroll
    for (int o = 8; o; o >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
    if (hr >= 2 * R) continue;
    const float r =
        rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / (float)HEAD_DIM), eps));
    float f[8], w[8];
    unpack8(v[i], f);
    unpack8(load16((is_k ? wk : wq) + h * HEAD_DIM + sub * 8), w);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      f[j] = round_bf16(__fmul_rn(__fmul_rn(f[j], r), w[j]));
    if (h < n_rot) {
      // pairs sub * 4 .. sub * 4 + 3 of position s: (cos, sin) each
      const float4* tab = reinterpret_cast<const float4*>(
          freqs + (long long)s * HEAD_DIM + sub * 8);
      const float4 a = tab[0], b = tab[1];
      const float cs[4] = {a.x, a.z, b.x, b.z};
      const float sn[4] = {a.y, a.w, b.y, b.w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float e = f[2 * p], o = f[2 * p + 1];
        f[2 * p] = __fsub_rn(__fmul_rn(e, cs[p]), __fmul_rn(o, sn[p]));
        f[2 * p + 1] = __fadd_rn(__fmul_rn(o, cs[p]), __fmul_rn(e, sn[p]));
      }
    }
    *reinterpret_cast<uint4*>((is_k ? k_out : q_out) + t * HEAD_DIM +
                              sub * 8) = pack8(f);
  }
}

}  // namespace

// AdaLN: x, out (rows, M) bf16 with rows = GB * S; shift, scale (GB, M)
// bf16; every base 16-byte aligned.  M a multiple of 8, at most 2048.
extern "C" int echo_dit_adaln(const void* x, const void* shift,
                              const void* scale, void* out, int rows, int S,
                              int M, float eps, void* stream) {
  if (rows < 1 || S < 1 || rows % S || M < 8 || M % 8 ||
      M > ADALN_CH * 32 * 8)
    return (int)cudaErrorInvalidValue;
  dit_adaln_kernel<<<(rows + ADALN_WARPS - 1) / ADALN_WARPS, ADALN_WARPS * 32,
                     0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(x),
      reinterpret_cast<const __nv_bfloat16*>(shift),
      reinterpret_cast<const __nv_bfloat16*>(scale),
      reinterpret_cast<__nv_bfloat16*>(out), rows, S, M, eps);
  return (int)cudaGetLastError();
}

// Q/K norm + RoPE: q, k, q_out, k_out (GB, S, H, 128) bf16 contiguous; wq,
// wk (H, 128) bf16; freqs (S, 64, 2) fp32; heads below n_rot rotated.
extern "C" int echo_dit_qk_rope(const void* q, const void* k, const void* wq,
                                const void* wk, const void* freqs,
                                void* q_out, void* k_out, int GB, int S,
                                int H, int Dh, int n_rot, float eps,
                                void* stream) {
  if (GB < 1 || S < 1 || H < 1 || Dh != HEAD_DIM || n_rot < 0 || n_rot > H)
    return (int)cudaErrorInvalidValue;
  const long long R = (long long)GB * S * H;
  const long long per_block = QK_THREADS / 16 * QK_ROWS;
  const long long blocks = (2 * R + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dit_qk_rope_kernel<<<(unsigned)blocks, QK_THREADS, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(q),
      reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(wq),
      reinterpret_cast<const __nv_bfloat16*>(wk),
      reinterpret_cast<const float*>(freqs),
      reinterpret_cast<__nv_bfloat16*>(q_out),
      reinterpret_cast<__nv_bfloat16*>(k_out), R, S, H, n_rot, eps);
  return (int)cudaGetLastError();
}

// Joint attention over [self K/V | static K/V] for the EchoDiT sampler.
//
// Replaces the two Pallas kernels of echo_tts_tpu/ops/pallas/joint_attention.py:
// `_kernel` (whole-row, grid (GB, H)) and `_flash_kernel` (online softmax,
// grid (GB, H, n_q, n_kv)).  The whole-row form exists on the TPU only
// because a (S, T) fp32 logits block fits its 16 MB VMEM; on Hopper a block
// has 227 KB of shared memory, so one tiled online-softmax kernel serves
// every shape.
//
// What it computes, per query row of (gb, h):
//   self logits   = (q . k_self) * sm_scale                (columns < S)
//   static logits = (q . k_st[b]) * sm_scale * scale + bias   (b = gb % B)
//   one softmax over [self | static]; the static weights are multiplied by
//   the same column scale AFTER they are summed into the denominator; e is
//   cast to bf16 before PV, which accumulates in fp32; out = acc / denom.
// bias is 0 where the (GB, T) bool mask attends and MASK_VALUE elsewhere;
// the column scale is one (T,) fp32 vector for every head (the speaker-KV
// scale), or 1 when none is given.  Both are read here as they are, so the
// wrapper builds no bias or per-head scale table per call.
// The GB axis is G-major (gb = g*B + b), so the CFG branches share the
// static K/V rows without a copy.  Masked and ragged columns carry the
// finite MASK_VALUE, so a fully masked tile cannot produce NaN.
//
// Design: one block of 4 warps per (q-tile of 64 rows, h, gb).  Each warp
// owns 16 query rows, keeps Q in registers as mma.sync A fragments and the
// running (m, l, acc) in registers (FlashAttention-2 layout).  K/V tiles of
// 64 rows go through shared memory; tensors are read through their
// (batch, seq, head) strides, so no transposes are needed.
//
// Bound on the H100 at the main-path shape (GB=3, S=640, T=778, H=16,
// Dh=128): 4*GB*H*S*(S+T)*Dh = 22.3 GFLOP against ~38 MB moved, so the
// bf16 tensor-core rate bounds it (22.6 us at 989 TFLOP/s; the bytes alone
// take 11.3 us at 3.35 TB/s).  This simple kernel (mma.sync, no
// TMA/wgmma, K/V reloaded per q-tile and per CFG branch, no overlap of
// loads with math) is far from that bound.
//
// int8 static K/V (a second instance, KV8 = true; entry point
// echo_joint_attention_kv8): the counterpart of the Pallas kernels' int8
// form, `fused_joint_attention(..., kv_scales=(ks, vs))`
// (joint_attention.py:437-521; the casts at :68-69 and :168-169).  Static
// K/V arrive int8 (B, T, H, D) with fp32 dequant scales ks, vs (B, T, H).
// Each 16-byte row chunk is loaded as int8 and converted to bf16 in
// shared memory (exact: |v| <= 127), so the static K/V cross HBM at half
// the width.  The per-column scales are one fp32 product each,
// col_scale[t] * ks[b, t, h] on the logits and col_scale[t] * vs[b, t, h]
// on the weights, after they joined the denominator and before the cast
// to bf16; without a column scale they are ks and vs themselves.  At the
// main-path shape (GB=3, S=640, T=778) the tensor-core rate still bounds
// it (the same 22.3 GFLOP; the int8 K/V save 6.4 MB of the ~38 MB), so
// this simple form does nothing more about it than the bf16 one: the
// conversion costs a few ALU instructions per element per q-tile, and the
// scales are read per tile as the column scale is.  The bf16 instance is
// compiled from the same source with KV8 = false and is unchanged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float MASK_VALUE = -1e30f;
constexpr int BQ = 64;     // query rows per block
constexpr int BK = 64;     // key rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;     // bf16 elements of padding per shared-memory row

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// rows [row0, row0 + BK) of a (rows, D) matrix with row stride `rs`
// (elements) into shared memory; rows >= n_rows are zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* sm,
                                          const __nv_bfloat16* g, long long rs,
                                          int row0, int n_rows) {
  constexpr int PER_ROW = D / 8;
  for (int i = threadIdx.x; i < BK * PER_ROW; i += NTHREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 8;
    const int gr = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr < n_rows) v = *reinterpret_cast<const uint4*>(g + gr * rs + c);
    *reinterpret_cast<uint4*>(sm + r * (D + PAD) + c) = v;
  }
}

// The same rows of an int8 (rows, D) matrix, converted to bf16 (exact)
// as they land in shared memory; rows >= n_rows are zero.
template <int D>
__device__ __forceinline__ void load_tile_i8(__nv_bfloat16* sm,
                                             const int8_t* g, long long rs,
                                             int row0, int n_rows) {
  constexpr int PER_ROW = D / 16;
  for (int i = threadIdx.x; i < BK * PER_ROW; i += NTHREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 16;
    const int gr = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr < n_rows) v = *reinterpret_cast<const uint4*>(g + gr * rs + c);
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
    uint32_t p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      p[j] = pack_bf16((float)b[2 * j], (float)b[2 * j + 1]);
    __nv_bfloat16* dst = sm + r * (D + PAD) + c;
    *reinterpret_cast<uint4*>(dst) = make_uint4(p[0], p[1], p[2], p[3]);
    *reinterpret_cast<uint4*>(dst + 8) = make_uint4(p[4], p[5], p[6], p[7]);
  }
}

// KV8: static K/V are int8 and k_deq/v_deq hold their (B, T, H) fp32
// scales; otherwise static K/V are bf16 and k_deq/v_deq are unused.
template <int D, bool KV8>
__global__ void __launch_bounds__(NTHREADS)
joint_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_self,
                       const __nv_bfloat16* __restrict__ v_self,
                       const void* __restrict__ k_st,
                       const void* __restrict__ v_st,
                       const bool* __restrict__ mask,        // (GB, T)
                       const float* __restrict__ col_scale,  // (T,) or null
                       const float* __restrict__ k_deq,      // (B, T, H)
                       const float* __restrict__ v_deq,      // (B, T, H)
                       __nv_bfloat16* __restrict__ out,
                       int S, int B, int T,
                       long long sb, long long ss, long long sh,
                       long long tb, long long ts, long long th,
                       float sm_scale) {
  constexpr int LD = D + PAD;
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BK * LD];
  __shared__ float col_s[BK], col_b[BK];
  // the V-side column scale; the bf16 form uses col_s on both sides
  __shared__ float col_v[KV8 ? BK : 1];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int gb = blockIdx.z;
  const int b = gb % B;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // row within the 8-row group
  const int t = lane & 3;    // column pair within the quad

  const long long self_off = gb * sb + h * sh;
  const long long st_off = b * tb + h * th;

  // Q tile through shared memory (Ks is free before the loop).
  load_tile<D>(Ks, q + self_off, ss, q0, S);
  __syncthreads();
  uint32_t qf[D / 16][4];
  {
    const __nv_bfloat16* r0 = Ks + (warp * 16 + g) * LD;
    const __nv_bfloat16* r1 = r0 + 8 * LD;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = ld32(r0 + kk * 16 + 2 * t);
      qf[kk][1] = ld32(r1 + kk * 16 + 2 * t);
      qf[kk][2] = ld32(r0 + kk * 16 + 2 * t + 8);
      qf[kk][3] = ld32(r1 + kk * 16 + 2 * t + 8);
    }
  }

  float m[2] = {MASK_VALUE, MASK_VALUE};
  float l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const int n_self = (S + BK - 1) / BK;
  const int n_tiles = n_self + (T + BK - 1) / BK;

  for (int j = 0; j < n_tiles; ++j) {
    const bool is_self = j < n_self;
    const int col0 = (is_self ? j : j - n_self) * BK;
    __syncthreads();  // previous tile (or the Q staging) is done with Ks/Vs
    if (is_self) {
      load_tile<D>(Ks, k_self + self_off, ss, col0, S);
      load_tile<D>(Vs, v_self + self_off, ss, col0, S);
    } else if constexpr (KV8) {
      load_tile_i8<D>(Ks, static_cast<const int8_t*>(k_st) + st_off, ts,
                      col0, T);
      load_tile_i8<D>(Vs, static_cast<const int8_t*>(v_st) + st_off, ts,
                      col0, T);
      const int H = gridDim.y;
      for (int c = threadIdx.x; c < BK; c += NTHREADS) {
        const int col = col0 + c;
        const bool ok = col < T;
        const long long si = ((long long)b * T + col) * H + h;
        const float cs = ok && col_scale ? col_scale[col] : 1.f;
        col_b[c] = ok && mask[(long long)gb * T + col] ? 0.f : MASK_VALUE;
        col_s[c] = ok ? cs * k_deq[si] : 0.f;
        col_v[c] = ok ? cs * v_deq[si] : 0.f;
      }
    } else {
      load_tile<D>(Ks, static_cast<const __nv_bfloat16*>(k_st) + st_off, ts,
                   col0, T);
      load_tile<D>(Vs, static_cast<const __nv_bfloat16*>(v_st) + st_off, ts,
                   col0, T);
      for (int c = threadIdx.x; c < BK; c += NTHREADS) {
        const int col = col0 + c;
        const bool ok = col < T;
        col_b[c] = ok && mask[(long long)gb * T + col] ? 0.f : MASK_VALUE;
        col_s[c] = ok ? (col_scale ? col_scale[col] : 1.f) : 0.f;
      }
    }
    __syncthreads();

    // logits: (16 rows) x (BK cols) per warp
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const __nv_bfloat16* kr = Ks + (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma16816(s[n], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    float mx[2] = {MASK_VALUE, MASK_VALUE};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cl = n * 8 + 2 * t + (i & 1);
        float x = s[n][i] * sm_scale;
        if (is_self) {
          if (col0 + cl >= S) x = MASK_VALUE;
        } else {
          x = x * col_s[cl] + col_b[cl];
        }
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(s[n][i] - m[i >> 1]);
        rsum[i >> 1] += e;
        // the column scale multiplies e after e joined the denominator
        const int cl = n * 8 + 2 * t + (i & 1);
        s[n][i] = is_self ? e : e * (KV8 ? col_v[cl] : col_s[cl]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l[r] = l[r] * alpha[r] + rsum[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // acc += bf16(e) @ V: the C fragments of two adjacent n-tiles of the
    // logits are exactly one A fragment of the PV product.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* v0 = Vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vp = v0 + n * 8;
        const uint32_t b0 = pack_raw(vp[0], vp[LD]);
        const uint32_t b1 = pack_raw(vp[8 * LD], vp[9 * LD]);
        mma16816(o[n], pa, b0, b1);
      }
    }
  }

  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const float inv_a = 1.f / l[0];
  const float inv_b = 1.f / l[1];
  __nv_bfloat16* out_h = out + self_off;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(out_h + row_a * ss + c) =
          pack_bf16(o[n][0] * inv_a, o[n][1] * inv_a);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(out_h + row_b * ss + c) =
          pack_bf16(o[n][2] * inv_b, o[n][3] * inv_b);
  }
}

template <bool KV8>
int launch(const void* q, const void* k_self, const void* v_self,
           const void* k_st, const void* v_st, const void* mask,
           const void* col_scale, const void* k_deq, const void* v_deq,
           void* out, int GB, int S, int H, int D, int B, int T,
           long long sb, long long ss, long long sh, long long tb,
           long long ts, long long th, float sm_scale, void* stream) {
  if (D != 128) return (int)cudaErrorInvalidValue;  // the DiT's head dim
  const dim3 grid((S + BQ - 1) / BQ, H, GB);
  joint_attention_kernel<128, KV8>
      <<<grid, NTHREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_self,
          (const __nv_bfloat16*)v_self, k_st, v_st, (const bool*)mask,
          (const float*)col_scale, (const float*)k_deq, (const float*)v_deq,
          (__nv_bfloat16*)out, S, B, T, sb, ss, sh, tb, ts, th, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, loaded with ctypes (echo_tts_torch/ops/joint_attention.py).
// q/k_self/v_self/out share the (GB, S, H, D) strides (sb, ss, sh); the
// static K/V share (B, T, H, D) strides (tb, ts, th); all in elements with
// the head dimension contiguous.  mask is (GB, T) bool, contiguous;
// col_scale is (T,) fp32 or null.  Each returns cudaGetLastError() after
// the launch.
extern "C" int echo_joint_attention_bf16(
    const void* q, const void* k_self, const void* v_self, const void* k_st,
    const void* v_st, const void* mask, const void* col_scale, void* out,
    int GB, int S, int H, int D, int B, int T,
    long long sb, long long ss, long long sh, long long tb, long long ts,
    long long th, float sm_scale, void* stream) {
  return launch<false>(q, k_self, v_self, k_st, v_st, mask, col_scale,
                       nullptr, nullptr, out, GB, S, H, D, B, T, sb, ss, sh,
                       tb, ts, th, sm_scale, stream);
}

// Static K/V int8, with their dequant scales k_deq/v_deq (B, T, H) fp32,
// contiguous.
extern "C" int echo_joint_attention_kv8(
    const void* q, const void* k_self, const void* v_self, const void* k_st,
    const void* v_st, const void* mask, const void* col_scale,
    const void* k_deq, const void* v_deq, void* out,
    int GB, int S, int H, int D, int B, int T,
    long long sb, long long ss, long long sh, long long tb, long long ts,
    long long th, float sm_scale, void* stream) {
  return launch<true>(q, k_self, v_self, k_st, v_st, mask, col_scale, k_deq,
                      v_deq, out, GB, S, H, D, B, T, sb, ss, sh, tb, ts, th,
                      sm_scale, stream);
}

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
// finite MASK_VALUE, so a fully masked tile cannot produce NaN.  The
// softmax runs in base 2 (logits times log2 e, ex2), the same function.
//
// int8 static K/V (a second instance, KV8 = true; entry point
// echo_joint_attention_kv8): the counterpart of the Pallas kernels' int8
// form, `fused_joint_attention(..., kv_scales=(ks, vs))`
// (joint_attention.py:437-521; the casts at :68-69 and :168-169).  Static
// K/V arrive int8 (B, T, H, D) with fp32 dequant scales ks, vs (B, T, H);
// the per-column scales are one fp32 product each, col_scale[t] *
// ks[b, t, h] on the logits and col_scale[t] * vs[b, t, h] on the weights,
// after they joined the denominator and before the cast to bf16.
//
// What bounds it on the H100 at the main-path shape (GB=3, S=640, T=778,
// H=16, Dh=128): 4*GB*H*S*(S+T)*Dh = 22.3 GFLOP against ~38 MB moved, so
// the bf16 tensor-core rate (22.6 us at 989 TFLOP/s; the bytes alone take
// 11.3 us at 3.35 TB/s).  The design is FlashAttention-3's shape:
//  - One block per (q-tile of BQ = 128 rows, h, gb): two consumer
//    warpgroups of 64 query rows and one producer warpgroup.  The
//    consumers take turns to issue their Q K^T (named barriers 2 and 3,
//    FA3's ping-pong), so that one's softmax can run while the other's
//    product holds the tensor cores.
//  - Filling 132 SMs (ops/joint_attention.py `_tile_plan`): the registers
//    of one 384-thread block fill an SM, so one block runs on each.  At
//    GB = 1, S = 640 the plan gives 80 blocks, one partial wave.  64-row
//    blocks would give 160, more than the SMs: some SMs would run two of
//    them one after the other, no sooner than one 128-row block, and each
//    with one consumer warpgroup, whose softmax no other warpgroup's
//    product overlaps.  Splitting the key range would need a second pass
//    to merge the partial softmaxes.
//  - Q (loaded once by TMA) and the K/V tiles of BKV = 128 rows sit in
//    shared memory with the 128-byte swizzle, each (rows, 128) bf16 tile
//    as two 64-column boxes; K/V go through a ring of STAGES stages with a
//    full and an empty mbarrier each.  q/k_self/v_self and the static K/V
//    each have a 4-d tensor map (D, seq, H, batch) over the strides the
//    wrapper passes, so no transposes; the static maps are read at batch
//    gb % B.  TMA zero-fills rows past S or T.
//  - S = Q K^T is wgmma.m64n128k16 with both operands in shared memory
//    (K-major); P stays in registers as the A operand of the PV wgmma,
//    whose B (V, N-major) is read transposed from shared memory.
//  - The producer writes each static tile's column factors beside it (one
//    column a thread): the logit factor sm_scale * scale * log2 e, the
//    bias, and the V-side scale.  Columns >= T get a zero scale and the
//    mask bias.
//  - int8 K/V: TMA copies the int8 tiles (D = 128 bytes: one row) into a
//    staging buffer; the producer warpgroup converts them to bf16 (exact,
//    |v| <= 127) into the swizzled stage while the consumers work on the
//    previous stage, so the consumers run the same code as for bf16.
//  Each block loads its static tiles for itself; the G CFG branches of one
//  (q-tile, h) are separate blocks and share the tiles through L2, and
//  each converts them for itself (one block holding the G branches' rows
//  would need G times the registers for its softmax state and output).
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float MASK_VALUE = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int D = 128;         // head dim: the DiT's, the only one taken
constexpr int BKV = 128;       // key rows per tile
constexpr int STAGES = 2;
constexpr int HALF = BKV * 128;        // one 64-column bf16 box of a tile
constexpr int KV_TILE = 2 * HALF;      // a (BKV, 128) bf16 tile
constexpr int BQ = 128;        // query rows per block: two consumer warpgroups
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;   // 2 * 224 + 56 = 3 * 168, the entry count

template <bool KV8>
struct AttnSmem {
  static constexpr int Q_HALF = BQ * 128;
  static constexpr int Q = 0;                                  // 2 boxes
  static constexpr int K = Q + 2 * Q_HALF;                     // [STAGES]
  static constexpr int V = K + STAGES * KV_TILE;               // [STAGES]
  static constexpr int K8 = V + STAGES * KV_TILE;              // int8 staging
  static constexpr int V8 = K8 + (KV8 ? BKV * D : 0);
  static constexpr int COLS = V8 + (KV8 ? BKV * D : 0);        // [STAGES][3][BKV]
  static constexpr int BARS = COLS + STAGES * 3 * BKV * 4;
  // full[STAGES], empty[STAGES], q, staging; + 1024 to align the base
  static constexpr int TOTAL = BARS + (2 * STAGES + 2) * 8 + 1024;
};


// 2^x, one MUFU op; subnormal results flush to zero (their weights are
// below 2^-126 of the row's largest and vanish in bf16 P anyway)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four int8 (one 32-bit word) as four bf16 (two words), exactly: each
// byte, offset to unsigned, becomes the low mantissa byte of the float
// 2^23 + u, from which 2^23 + 128 is subtracted (all exact in fp32, and
// |v| <= 128 is exact in bf16).  Byte permutes and adds, where a
// conversion instruction per element would run at a quarter of the rate.
__device__ __forceinline__ uint2 i8x4_to_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float bias = 8388736.f;   // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - bias;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - bias;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - bias;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - bias;
  return make_uint2(pack_bf16(f0, f1), pack_bf16(f2, f3));
}

// The int8 (BKV, 128) tile at `src` (plain rows) as bf16 into the two
// swizzled 64-column boxes at `dst`, 128 producer threads.
__device__ __forceinline__ void convert_tile(uint8_t* dst, const int8_t* src,
                                            int ptid) {
#pragma unroll 2
  for (int i = ptid; i < BKV * 8; i += 128) {
    const int r = i >> 3;        // row
    const int q = i & 7;         // 16-byte chunk of int8: columns 16q..16q+15
    const uint4 v = *reinterpret_cast<const uint4*>(src + r * D + q * 16);
    const uint2 p0 = i8x4_to_bf16x4(v.x), p1 = i8x4_to_bf16x4(v.y);
    const uint2 p2 = i8x4_to_bf16x4(v.z), p3 = i8x4_to_bf16x4(v.w);
    uint8_t* row = dst + (q >> 2) * HALF + r * 128;
    const int c0 = 2 * (q & 3);
    *reinterpret_cast<uint4*>(row + ((c0 ^ (r & 7)) << 4)) =
        make_uint4(p0.x, p0.y, p1.x, p1.y);
    *reinterpret_cast<uint4*>(row + (((c0 + 1) ^ (r & 7)) << 4)) =
        make_uint4(p2.x, p2.y, p3.x, p3.y);
  }
}

// KV8: static K/V are int8 and k_deq/v_deq hold their (B, T, H) fp32
// scales; otherwise static K/V are bf16 and k_deq/v_deq are unused.
template <bool KV8>
__global__ void __launch_bounds__(384, 1)
joint_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_kt,
                       const __grid_constant__ CUtensorMap tm_vt,
                       const bool* __restrict__ mask,        // (GB, T)
                       const float* __restrict__ col_scale,  // (T,) or null
                       const float* __restrict__ k_deq,      // (B, T, H)
                       const float* __restrict__ v_deq,      // (B, T, H)
                       __nv_bfloat16* __restrict__ out,
                       int S, int B, int T, int H,
                       long long sb, long long ss, long long sh,
                       float sm_scale) {
  using L = AttnSmem<KV8>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_aligned_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* q_bar = empty + STAGES;
  uint64_t* stage_bar = q_bar + 1;
  float* cols = reinterpret_cast<float*>(smem + L::COLS);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int gb = blockIdx.z;
  const int b = gb % B;
  const int wg = threadIdx.x / 128;
  const int n_self = (S + BKV - 1) / BKV;
  const int n_tiles = n_self + (T + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 4);   // one arrival per consumer warp
    }
    mbar_init(q_bar, 1);
    mbar_init(stage_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer warpgroup ----------------
    setmaxnreg_dec<PRODUCER_REGS>();
    const int ptid = threadIdx.x - 256;
    if (ptid == 0) {
      mbar_arrive_expect_tx(q_bar, 2 * L::Q_HALF);
      tma_load_4d(smem + L::Q, &tm_q, q_bar, 0, q0, h, gb);
      tma_load_4d(smem + L::Q + L::Q_HALF, &tm_q, q_bar, 64, q0, h, gb);
    }
    uint32_t staged = 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      uint8_t* kb = smem + L::K + s * KV_TILE;
      uint8_t* vb = smem + L::V + s * KV_TILE;
      mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      if (j < n_self) {
        if (ptid == 0) {
          const int r0 = j * BKV;
          mbar_arrive_expect_tx(&full[s], 2 * KV_TILE);
          tma_load_4d(kb, &tm_k, &full[s], 0, r0, h, gb);
          tma_load_4d(kb + HALF, &tm_k, &full[s], 64, r0, h, gb);
          tma_load_4d(vb, &tm_v, &full[s], 0, r0, h, gb);
          tma_load_4d(vb + HALF, &tm_v, &full[s], 64, r0, h, gb);
        }
        continue;
      }
      const int col0 = (j - n_self) * BKV;
      if (ptid == 0) {
        if constexpr (KV8) {
          mbar_arrive_expect_tx(stage_bar, 2 * BKV * D);
          tma_load_4d(smem + L::K8, &tm_kt, stage_bar, 0, col0, h, b);
          tma_load_4d(smem + L::V8, &tm_vt, stage_bar, 0, col0, h, b);
        } else {
          mbar_expect_tx(&full[s], 2 * KV_TILE);
          tma_load_4d(kb, &tm_kt, &full[s], 0, col0, h, b);
          tma_load_4d(kb + HALF, &tm_kt, &full[s], 64, col0, h, b);
          tma_load_4d(vb, &tm_vt, &full[s], 0, col0, h, b);
          tma_load_4d(vb + HALF, &tm_vt, &full[s], 64, col0, h, b);
        }
      }
      // the tile's column factors, one column a thread (BKV == 128)
      {
        const int col = col0 + ptid;
        const bool ok = col < T;
        const float cs = ok && col_scale ? col_scale[col] : 1.f;
        float ks = ok ? cs : 0.f, vs = ks;
        if constexpr (KV8) {
          const long long si = ((long long)b * T + col) * H + h;
          ks = ok ? cs * k_deq[si] : 0.f;
          vs = ok ? cs * v_deq[si] : 0.f;
        }
        float* c = cols + s * 3 * BKV;
        c[ptid] = ks * (sm_scale * LOG2E);
        c[BKV + ptid] =
            (ok && mask[(long long)gb * T + col] ? 0.f : MASK_VALUE) * LOG2E;
        c[2 * BKV + ptid] = vs;
      }
      if constexpr (KV8) {
        mbar_wait(stage_bar, staged & 1);
        ++staged;
        convert_tile(kb, reinterpret_cast<const int8_t*>(smem + L::K8), ptid);
        convert_tile(vb, reinterpret_cast<const int8_t*>(smem + L::V8), ptid);
        fence_proxy_async();
      }
      named_sync(1, 128);   // factors (and converted tiles) written
      if (ptid == 0) mbar_arrive(&full[s]);
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    setmaxnreg_inc<CONSUMER_REGS>();
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x / 32) % 4;
    const int t2 = 2 * (lane % 4);
    const float self_mul = sm_scale * LOG2E;
    const uint8_t* qa = smem + L::Q + wg * 64 * 128;

    float m[2] = {MASK_VALUE * LOG2E, MASK_VALUE * LOG2E};
    float l[2] = {0.f, 0.f};
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;

    // Ping-pong: the two warpgroups take turns to issue their S = Q K^T
    // (named barriers 2 and 3), so that one's softmax runs while the
    // other's product holds the tensor cores.  Warpgroup 0 goes first.
    if (wg == 1) named_arrive(2, 256);
    mbar_wait(q_bar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const uint8_t* kb = smem + L::K + s * KV_TILE;
      const uint8_t* vb = smem + L::V + s * KV_TILE;
      mbar_wait(&full[s], (j / STAGES) & 1);

      float sc[64];
      named_sync(2 + wg, 256);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk >> 2) * L::Q_HALF + (kk & 3) * 32;
        const int koff = (kk >> 2) * HALF + (kk & 3) * 32;
        wgmma_m64n128k16_bf16_ss<0>(sc, desc_sw128(qa + off, 16, 1024),
                                    desc_sw128(kb + koff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      // the other's turn; warpgroup 0 waits as often as 1 arrives
      if (wg == 0 || j + 1 < n_tiles) named_arrive(3 - wg, 256);
      wgmma_wait<0>();
      fence_regs(sc);

      const bool is_self = j < n_self;
      const int col0 = is_self ? j * BKV : 0;
      const float* c = cols + s * 3 * BKV;
      float mx[2] = {MASK_VALUE * LOG2E, MASK_VALUE * LOG2E};
      if (is_self) {
        const bool ragged = col0 + BKV > S;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float x = sc[4 * n + i] * self_mul;
            if (ragged && col0 + 8 * n + t2 + (i & 1) >= S) x = MASK_VALUE * LOG2E;
            sc[4 * n + i] = x;
            mx[i >> 1] = fmaxf(mx[i >> 1], x);
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          // the factors of this thread's two columns 8n + t2 and 8n + t2 + 1
          const float2 km = *reinterpret_cast<const float2*>(c + 8 * n + t2);
          const float2 ba =
              *reinterpret_cast<const float2*>(c + BKV + 8 * n + t2);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = fmaf(sc[4 * n + i], i & 1 ? km.y : km.x,
                                 i & 1 ? ba.y : ba.x);
            sc[4 * n + i] = x;
            mx[i >> 1] = fmaxf(mx[i >> 1], x);
          }
        }
      }
      float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
      uint32_t pa[8][4];
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          e[i] = ex2(sc[4 * n + i] - m[i >> 1]);
          rsum[i >> 1] += e[i];
        }
        if (!is_self) {
          // the column scale multiplies e after e joined the denominator
          const float2 vm =
              *reinterpret_cast<const float2*>(c + 2 * BKV + 8 * n + t2);
          e[0] *= vm.x;
          e[1] *= vm.y;
          e[2] *= vm.x;
          e[3] *= vm.y;
        }
        // accumulator columns 16kk..16kk+15 are the A fragment of k-step kk
        pa[n >> 1][2 * (n & 1)] = pack_bf16(e[0], e[1]);
        pa[n >> 1][2 * (n & 1) + 1] = pack_bf16(e[2], e[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
        rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
        l[r] = l[r] * alpha[r] + rsum[r];
      }
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }

      // O += P V: V rows 16kk..16kk+15, both 64-column boxes (lbo = HALF)
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_m64n128k16_bf16_rs<1>(o, pa[kk],
                                    desc_sw128(vb + kk * 16 * 128, HALF, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;
    const int row1 = row0 + 8;
    const float inv0 = 1.f / l[0];
    const float inv1 = 1.f / l[1];
    __nv_bfloat16* out_h = out + gb * sb + h * sh;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int cc = 8 * n + t2;
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(out_h + row0 * ss + cc) =
            pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      if (row1 < S)
        *reinterpret_cast<uint32_t*>(out_h + row1 * ss + cc) =
            pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
  }
}

// A (D, rows, H, batch) map over a (batch, rows, H, D) tensor with element
// strides (sb, sr, sh); boxes of (inner, box_rows, 1, 1).
int map4(CUtensorMap* m, const void* p, bool int8, int n_batch, int rows,
         int H, long long sb, long long sr, long long sh, int box_rows) {
  const int es = int8 ? 1 : 2;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)rows, (uint64_t)H,
                            (uint64_t)n_batch};
  const uint64_t strides[3] = {(uint64_t)(sr * es), (uint64_t)(sh * es),
                               (uint64_t)(sb * es)};
  const uint32_t box[4] = {int8 ? (uint32_t)D : 64u, (uint32_t)box_rows, 1, 1};
  return make_map(m, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  4, p, dims, strides, box,
                  int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool KV8>
int launch(const void* q, const void* k_self, const void* v_self,
           const void* k_st, const void* v_st, const void* mask,
           const void* col_scale, const void* k_deq, const void* v_deq,
           void* out, int GB, int S, int H, int B, int T,
           long long sb, long long ss, long long sh, long long tb,
           long long ts, long long th, float sm_scale, cudaStream_t st) {
  using L = AttnSmem<KV8>;
  static const int attr = allow_smem(joint_attention_kernel<KV8>, L::TOTAL);
  if (attr) return attr;
  CUtensorMap tq, tk, tv, tkt, tvt;
  int rc;
  if ((rc = map4(&tq, q, false, GB, S, H, sb, ss, sh, BQ)) ||
      (rc = map4(&tk, k_self, false, GB, S, H, sb, ss, sh, BKV)) ||
      (rc = map4(&tv, v_self, false, GB, S, H, sb, ss, sh, BKV)) ||
      (rc = map4(&tkt, k_st, KV8, B, T, H, tb, ts, th, BKV)) ||
      (rc = map4(&tvt, v_st, KV8, B, T, H, tb, ts, th, BKV)))
    return rc;
  const dim3 grid((S + BQ - 1) / BQ, H, GB);
  joint_attention_kernel<KV8><<<grid, 384, L::TOTAL, st>>>(
      tq, tk, tv, tkt, tvt, (const bool*)mask, (const float*)col_scale,
      (const float*)k_deq, (const float*)v_deq, (__nv_bfloat16*)out, S, B, T,
      H, sb, ss, sh, sm_scale);
  return (int)cudaGetLastError();
}

template <bool KV8>
int dispatch(const void* q, const void* k_self, const void* v_self,
             const void* k_st, const void* v_st, const void* mask,
             const void* col_scale, const void* k_deq, const void* v_deq,
             void* out, int GB, int S, int H, int D_, int B, int T,
             long long sb, long long ss, long long sh, long long tb,
             long long ts, long long th, float sm_scale, int bq, void* stream) {
  if (D_ != D || bq != BQ) return (int)cudaErrorInvalidValue;
  return launch<KV8>(q, k_self, v_self, k_st, v_st, mask, col_scale, k_deq,
                     v_deq, out, GB, S, H, B, T, sb, ss, sh, tb, ts, th,
                     sm_scale, reinterpret_cast<cudaStream_t>(stream));
}

}  // namespace

// C entry points, loaded with ctypes (echo_tts_torch/ops/joint_attention.py).
// q/k_self/v_self/out share the (GB, S, H, D) strides (sb, ss, sh); the
// static K/V share (B, T, H, D) strides (tb, ts, th); all in elements with
// the head dimension contiguous, every other stride a multiple of 16 bytes
// and every base 16-byte aligned.  mask is (GB, T) bool, contiguous;
// col_scale is (T,) fp32 or null; bq (128) is the query tile of the
// wrapper's tile plan.  Each returns 0 or a cudaError_t after the launch.
extern "C" int echo_joint_attention_bf16(
    const void* q, const void* k_self, const void* v_self, const void* k_st,
    const void* v_st, const void* mask, const void* col_scale, void* out,
    int GB, int S, int H, int D_, int B, int T,
    long long sb, long long ss, long long sh, long long tb, long long ts,
    long long th, float sm_scale, int bq, void* stream) {
  return dispatch<false>(q, k_self, v_self, k_st, v_st, mask, col_scale,
                         nullptr, nullptr, out, GB, S, H, D_, B, T, sb, ss, sh,
                         tb, ts, th, sm_scale, bq, stream);
}

// Static K/V int8, with their dequant scales k_deq/v_deq (B, T, H) fp32,
// contiguous.
extern "C" int echo_joint_attention_kv8(
    const void* q, const void* k_self, const void* v_self, const void* k_st,
    const void* v_st, const void* mask, const void* col_scale,
    const void* k_deq, const void* v_deq, void* out,
    int GB, int S, int H, int D_, int B, int T,
    long long sb, long long ss, long long sh, long long tb, long long ts,
    long long th, float sm_scale, int bq, void* stream) {
  return dispatch<true>(q, k_self, v_self, k_st, v_st, mask, col_scale, k_deq,
                        v_deq, out, GB, S, H, D_, B, T, sb, ss, sh, tb, ts, th,
                        sm_scale, bq, stream);
}

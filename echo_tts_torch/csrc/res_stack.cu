// The S1-DAC codec's three dilated residual units (kernel B).
//
// Replaces echo_tts_tpu/ops/pallas/res_stack.py:60 `_res_stack_kernel`
// (called through `_run` :118).  For d in (1, 3, 9):
//   x += conv_k1(snake(conv_k7_dil_d(snake(x))))
// with the Pallas kernel's rounding points, which the plain version
// (ops/res_stack.py `residual_unit_plain`) keeps: snake in fp32 then cast
// to bf16; each conv with fp32 accumulation, + bias, then cast; the
// residual add in bf16.  snake(v) = v + sin^2(a v) / (a + 1e-9), exact sinf
// (this file must not be built with --use_fast_math) or the sin2_poly
// polynomial.
//
// What bounds it on the H100: 2 * 8 * C^2 FLOP per frame and unit, the
// bf16 tensor-core rate (1.17 ms per stack at C = 384, L = 163 840); one
// unit moves 4 * L * C bytes through HBM (read x, write out), 0.07 ms
// there.  The weights, 8 * C^2 bf16 per unit (2.4 MB at C = 384), stay in
// the 50 MB L2 and are read from it once per block of BM rows: at C = 384,
// with 64-row blocks, that is 17.7 GB per stack at L = 163 840, and L2's
// rate rather than the tensor cores' is then what this kernel runs into.
//
// Design: one launch per unit (three per stack, from one entry point), so
// a block needs only its own 6 * d frames of context and recomputes no
// other unit's rows.  A block owns BM output rows (128, or 64 at C = 384)
// and every output channel; 256 threads, two warpgroups, of which thread
// 0 also issues the weight loads.  An SM holds two blocks at C <= 128 (so
// that one block's snake pass and epilogue overlap the other's wgmma
// loop) and one above.
//  1. The block reads x rows [r0 - 6d, r0 + BM) and writes snake1 of
//     them, bf16, into Y in shared memory (rows padded to C + 8, so that
//     any eight consecutive rows sit on distinct banks).  Positions
//     before 0 are written as zero: that is the causal pad of the k7 input
//     (the plain version pads snake(x) with zeros), so no unit needs a
//     "zero the context again" step.  Positions >= L are zero too and
//     feed only rows >= L, which are not stored.
//  2. The k7 conv is seven taps times C_in/64 panels of wgmma
//     m64nNk16 bf16 with fp32 accumulators in registers.  A, the 64 rows
//     of Y shifted by tap * d, comes from shared memory into registers
//     through ldmatrix, which takes any row offset (a shift of 3 or 9 rows
//     is not a multiple of a swizzle atom, so Y cannot be a descriptor
//     operand at every tap).  B, one panel of the weights (all C_out rows
//     by 64 C_in, K-major), comes by TMA with the 128-byte swizzle through
//     a ring of STAGES stages with a full and an empty mbarrier each; the
//     first stages load while the block computes the snake, each later
//     one as soon as every warp is done with the stage, and every weight
//     byte read from L2 serves BM rows.
//  3. The k7 accumulators + b1, cast to bf16, go to shared memory as z
//     (reusing Y once both warpgroups are done with it); snake2 then runs
//     as a pass over z, outside the matrix loop's registers.
//  4. The k1 conv is the same loop over z with w2's panels; its
//     accumulators + b2, cast to bf16, are added to the tile's x rows
//     (read again, from L2) in bf16 and stored; rows >= L are masked.
// Warpgroup split: at C <= 256 each warpgroup owns 64 rows and
// all C output channels (C / 2 fp32 registers a thread); at C = 384 each
// owns the block's 64 rows and half of the channels (96 registers), so
// the block is 64 rows.  C_in is padded to whole 64-channel panels in the
// kernel-layout weights (96 -> 128, 192 stays); the k-steps beyond C are
// skipped, so the padding costs ring space and L2 reads, no operations.
// The tile plan and the shared-memory budget are mirrored in
// ops/res_stack.py `tile_plan`, which the wrapper passes and this file
// checks.
// History form (streaming decode and encode): with hin/hout given, the
// context rows before position 0 are the previous block's tail of snake1
// of the unit's input, hin (batch, 6d, C), already snake1'd, copied into Y
// as they are where the one-shot form writes zero.  The form is the
// template parameter HIST, so the one-shot instances (HIST = false, hin
// and hout null) compile exactly the kernel without it.  The new tail, the last 6d rows of [hin | snake1(x)], sits in
// the last block's Y (rows [L - 6d, L), also when L < 6d), and that block
// copies it to hout right after step 1: the next streamed block reads the
// values this launch computed, with no second snake pass.  hout is a
// buffer apart from hin, which block 0 may still be reading.
// Centred form (Descript's DAC decoder): the k7 conv pads 3d on each side,
// so the block reads positions [r0 - 3d, r0 + BM + 3d), the same BM + 6d
// rows of Y, and positions past the end feed real rows as the right pad
// (they are written as zero, as before).  With lens (batch,) given, row b
// reads positions >= lens[b] as zero and stores zeros there, so that a
// batch of ragged items runs as each alone; a block wholly past its row's
// length stores its zeros and leaves before it touches shared memory.  The
// form is the template parameter CENTRED, one-shot only, so the causal
// instances (CENTRED = false, lens null) compile exactly as without it.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int SMEM_LIMIT = 232448;   // bytes a block may use on sm_90
constexpr int SMEM_SM = 233472;      // an SM's shared memory, 1024 a block reserved
constexpr int MAX_DIL = 9;
constexpr int NTHREADS = 256;        // two warpgroups

// sin2_poly constants (echo_tts_torch/ops/activations.py)
constexpr float PI_HI = 3.140625f;
constexpr float PI_LO = 9.67653589793e-4f;  // float32(pi - 3.140625)
constexpr float INV_PI = 0.318309886183790672f;
constexpr float C0 = 9.869597907896603f, C1 = -32.46839063007976f,
                C2 = 42.686220577408491f, C3 = -29.642546184449031f,
                C4 = 10.952207549847412f;

template <int C>
struct Plan {
  static constexpr int KP = (C + 63) / 64 * 64;  // C_in in whole panels
  static constexpr int NP = KP / 64;             // panels of 64 C_in
  static constexpr int NS = C > 256 ? 2 : 1;     // C_out chunks, one a warpgroup
  static constexpr int MW = 2 / NS;              // 64-row warpgroup tiles
  static constexpr int BM = 64 * MW;             // rows per block
  static constexpr int NW = C / NS;              // C_out per warpgroup
  static constexpr int LDY = C + 8;              // Y / z row, bf16
  static constexpr int STAGE = C * 128;          // C_out rows of 128 bytes
  static constexpr int BOX_N = C > 256 ? C / 2 : C;  // TMA boxes <= 256 rows
  static constexpr int TILES = 8 * NP;           // 7 taps + the k1, NP each
  // blocks an SM holds: two at C <= 128, where one block's phases (snake
  // pass, wgmma loop, epilogue) leave the tensor cores idle between them;
  // a thread then has 128 registers (the accumulators take C / 2), 255
  // with one block
  static constexpr int MINB = C <= 128 ? 2 : 1;
  static constexpr int BUDGET = MINB == 1 ? SMEM_LIMIT : SMEM_SM / MINB - 1024;
  static constexpr int Y_MAX = (BM + 6 * MAX_DIL) * LDY * 2;
  static constexpr int TABLES = 4 * C * 4;       // both snakes' alpha, 1 / (alpha + 1e-9)
  static constexpr int FIT = (BUDGET - 1024 - Y_MAX - TABLES - 64) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static_assert(STAGES >= 2, "the weight ring needs two stages");
  static constexpr int smem(int d) {
    return 1024 + STAGES * STAGE + (BM + 6 * d) * LDY * 2 + TABLES +
           2 * STAGES * 8;
  }
};

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
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

// fp32 snake of a bf16 value, rounded back to bf16; inv = 1 / (a + 1e-9),
// the same IEEE quotient for every element of a channel, so the kernel
// takes it once per channel, into a table in shared memory
template <bool APPROX>
__device__ __forceinline__ __nv_bfloat16 snake(float v, float a, float inv) {
  return __float2bfloat16_rn(v + inv * sin2<APPROX>(a * v));
}

// snake of 8 bf16 channels c..c+7 (alpha, inv point at channel c);
// snake(0) = 0 exactly
template <bool APPROX>
__device__ __forceinline__ uint4 snake8(const uint4& v, const float* alpha,
                                        const float* inv) {
  const float4 alo = *reinterpret_cast<const float4*>(alpha);
  const float4 ahi = *reinterpret_cast<const float4*>(alpha + 4);
  const float4 ilo = *reinterpret_cast<const float4*>(inv);
  const float4 ihi = *reinterpret_cast<const float4*>(inv + 4);
  const float a[8] = {alo.x, alo.y, alo.z, alo.w, ahi.x, ahi.y, ahi.z, ahi.w};
  const float q[8] = {ilo.x, ilo.y, ilo.z, ilo.w, ihi.x, ihi.y, ihi.z, ihi.w};
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[i] = pack2(snake<APPROX>(f.x, a[2 * i], q[2 * i]),
                 snake<APPROX>(f.y, a[2 * i + 1], q[2 * i + 1]));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The A fragments of ring tile j for this lane: rows from `row` (its
// ldmatrix row of a padded buffer) moved by (j / NP) taps of `tap_step`
// elements, 64 channels a panel; k-steps past C are skipped.
template <int C>
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4],
                                       const __nv_bfloat16* row, int j,
                                       int tap_step) {
  using P = Plan<C>;
  const int c0 = 64 * (j % P::NP);
  const __nv_bfloat16* r = row + (j / P::NP) * tap_step + c0;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (c0 + 16 * kk < C) ldmatrix_x4(a[kk], r + 16 * kk);
}

// Keeps A fragments live up to this point: an in-flight wgmma still reads
// them, so the compiler must not give their registers to the next ldmatrix.
__device__ __forceinline__ void keep(const uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" :: "r"(a[i][k]));
}

// Issue tile j's wgmma group: acc (+)= A (64 x 64) * W (the stage's panel
// at b, this warpgroup's C_out rows); `first` overwrites acc.
template <int C>
__device__ __forceinline__ void issue(float (&acc)[Plan<C>::NW / 2],
                                      const uint32_t (&a)[4][4],
                                      const uint8_t* b, int j, bool first) {
  using P = Plan<C>;
  const int c0 = 64 * (j % P::NP);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (c0 + 16 * kk < C)
      wgmma_bf16_rs<P::NW>(acc, a[kk], desc_sw128(b + kk * 32, 16, 1024),
                           !(first && kk == 0));
  wgmma_commit();
}

// The ring of weight panels.  Tile t is k7 tap t / NP (or, from 7 NP on,
// the k1) at C_in panel t % NP, in stage t % STAGES.  Thread 0 issues the
// TMA loads: the first STAGES at the start, then tile t + STAGES as soon
// as all eight warps have handed tile t's stage back.
template <int C>
struct Ring {
  using P = Plan<C>;
  const CUtensorMap* w1;
  const CUtensorMap* w2;
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int unit;

  __device__ __forceinline__ void produce(int t) const {
    if (t >= P::TILES) return;
    const int s = t % P::STAGES;
    const bool k7 = t < 7 * P::NP;
    const int row = k7 ? (unit * 7 + t / P::NP) * C : unit * C;
    mbar_wait(&empty[s], ((t / P::STAGES) & 1) ^ 1);
    mbar_arrive_expect_tx(&full[s], P::STAGE);
#pragma unroll
    for (int h = 0; h < C / P::BOX_N; ++h)
      tma_load_2d(base + s * P::STAGE + h * P::BOX_N * 128, k7 ? w1 : w2,
                  &full[s], 64 * (t % P::NP), row + h * P::BOX_N);
  }

  // the stage of tile t, once its bytes have landed
  __device__ __forceinline__ const uint8_t* wait(int t) const {
    mbar_wait(&full[t % P::STAGES], (t / P::STAGES) & 1);
    return base + (t % P::STAGES) * P::STAGE;
  }

  // this warp is done with tile t; thread 0 refills its stage
  __device__ __forceinline__ void release(int t, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[t % P::STAGES]);
    if (threadIdx.x == 0) produce(t + P::STAGES);
  }
};

// Tiles [it0, it0 + n) of the ring into acc (the first overwrites it).
// Two A fragment sets alternate: one group of wgmma stays in flight while
// the next tile's fragments load and its group is issued, and a stage
// goes back to the ring once the group that read it has retired.
template <int C>
__device__ __forceinline__ void mma_tiles(float (&acc)[Plan<C>::NW / 2],
                                          const __nv_bfloat16* row,
                                          int tap_step, int it0, int n,
                                          const Ring<C>& ring, int boff,
                                          int lane) {
  uint32_t a0[4][4], a1[4][4];
  load_a<C>(a0, row, 0, tap_step);
#pragma unroll 1
  for (int j = 0; j < n; j += 2) {
    issue<C>(acc, a0, ring.wait(it0 + j) + boff, j, j == 0);
    if (j > 0) {
      wgmma_wait<1>();
      keep(a1);
      ring.release(it0 + j - 1, lane);
    }
    if (j + 1 >= n) break;
    load_a<C>(a1, row, j + 1, tap_step);
    issue<C>(acc, a1, ring.wait(it0 + j + 1) + boff, j + 1, false);
    wgmma_wait<1>();
    keep(a0);
    ring.release(it0 + j, lane);
    if (j + 2 < n) load_a<C>(a0, row, j + 2, tap_step);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  ring.release(it0 + n - 1, lane);
}

template <int C, bool APPROX, bool HIST, bool CENTRED>
__global__ void __launch_bounds__(NTHREADS, Plan<C>::MINB)
res_unit_kernel(const __grid_constant__ CUtensorMap tm_w1,  // (3*7*C, KP)
                const __grid_constant__ CUtensorMap tm_w2,  // (3*C, KP)
                const __nv_bfloat16* __restrict__ x,
                __nv_bfloat16* __restrict__ out,
                const float* __restrict__ b1, const float* __restrict__ a1,
                const float* __restrict__ b2, const float* __restrict__ a2,
                const __nv_bfloat16* __restrict__ hin,   // (batch, 6d, C) if HIST
                __nv_bfloat16* __restrict__ hout,        // (batch, 6d, C) if HIST
                const int* __restrict__ lens,            // (batch,) or null, if CENTRED
                int L, int unit, int d) {
  using P = Plan<C>;
  // the row's length: positions at or past it read and store zero
  const int Lb = CENTRED && lens != nullptr ? min(lens[blockIdx.y], L) : L;
  if (CENTRED && (int)blockIdx.x * P::BM >= Lb) {
    const long long o = ((long long)blockIdx.y * L + blockIdx.x * P::BM) * C;
    const int rows = min(P::BM, L - (int)blockIdx.x * P::BM);
    for (int i = threadIdx.x; i < rows * (C / 8); i += NTHREADS)
      reinterpret_cast<uint4*>(out + o)[i] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_aligned_1024(smem_raw);
  const int ny = P::BM + 6 * d;
  __nv_bfloat16* Y = reinterpret_cast<__nv_bfloat16*>(smem + P::STAGES * P::STAGE);
  // both snakes' alpha and 1 / (alpha + 1e-9), C floats each
  float* tab = reinterpret_cast<float*>(smem + P::STAGES * P::STAGE +
                                        ny * P::LDY * 2);
  uint64_t* full = reinterpret_cast<uint64_t*>(tab + 4 * C);
  uint64_t* empty = full + P::STAGES;

  const int r0 = blockIdx.x * P::BM;
  const long long base = (long long)blockIdx.y * L;
  const int wg = threadIdx.x / 128;
  b1 += unit * C;
  a1 += unit * C;
  b2 += unit * C;
  a2 += unit * C;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 4);   // one arrival per warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const Ring<C> ring{&tm_w1, &tm_w2, smem, full, empty, unit};
  if (threadIdx.x == 0)
    for (int t = 0; t < P::STAGES; ++t) ring.produce(t);

  const int ct = threadIdx.x;
  const int lane = ct % 32;
  const int warp = (ct / 32) % 4;
  const int mw = wg % P::MW;           // which 64 rows
  const int nc = wg / P::MW;           // which C_out chunk

  for (int c = ct; c < C; c += 256) {
    tab[c] = a1[c];
    tab[C + c] = 1.0f / (a1[c] + 1e-9f);
    tab[2 * C + c] = a2[c];
    tab[3 * C + c] = 1.0f / (a2[c] + 1e-9f);
  }
  __syncthreads();

  // 1. Y = snake1(x) on positions [r0 - 6d, r0 + BM), zero at >= L, and
  // before 0 zero or the history as it is; each thread loads U chunks of
  // 8 channels before it computes any
  constexpr int CH = C / 8;
  constexpr int U = 4;
  const int n_chunks = ny * CH;
  const int p0 = r0 - (CENTRED ? 3 : 6) * d;
  const long long hbase = (long long)blockIdx.y * 6 * d;
  for (int i0 = ct; i0 < n_chunks; i0 += 256 * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + 256 * u;
      const int pos = p0 + i / CH;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < n_chunks && pos >= 0 && pos < Lb)
        v[u] = *reinterpret_cast<const uint4*>(x + (base + pos) * C + (i % CH) * 8);
      else if (HIST && i < n_chunks && pos < 0)
        v[u] = *reinterpret_cast<const uint4*>(
            hin + (hbase + 6 * d + pos) * C + (i % CH) * 8);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + 256 * u;
      if (i >= n_chunks) break;
      const int c = (i % CH) * 8;
      *reinterpret_cast<uint4*>(Y + (i / CH) * P::LDY + c) =
          HIST && p0 + i / CH < 0 ? v[u]
                                  : snake8<APPROX>(v[u], tab + c, tab + C + c);
    }
  }
  __syncthreads();

  // the new history: positions [L - 6d, L), Y rows from L - 6d - p0 of the
  // last block; Y is not written again before the k7 loop is done
  if (HIST && blockIdx.x == gridDim.x - 1) {
    const int y0 = L - 6 * d - p0;
    for (int i = ct; i < 6 * d * CH; i += 256) {
      const int r = i / CH;
      const int c = (i % CH) * 8;
      *reinterpret_cast<uint4*>(hout + (hbase + r) * C + c) =
          *reinterpret_cast<const uint4*>(Y + (y0 + r) * P::LDY + c);
    }
  }

  // 2. k7: output row i of this warpgroup reads Y row i + tap * d
  float acc[P::NW / 2];
#pragma unroll
  for (int i = 0; i < P::NW / 2; ++i) acc[i] = 0.f;
  const int arow = 64 * mw + 16 * warp + (lane & 15);
  const __nv_bfloat16* a_row = Y + arow * P::LDY + (lane >> 4) * 8;
  const int boff = nc * P::NW * 128;
  mma_tiles<C>(acc, a_row, d * P::LDY, 0, 7 * P::NP, ring, boff, lane);

  // 3. z = bf16(k7 + b1) into Y's space once every warpgroup is done with
  // Y, then z = snake2(z) as a pass over the tile
  const int g = lane / 4;
  const int t2 = 2 * (lane % 4);
  const int row0 = 64 * mw + 16 * warp + g;   // and row0 + 8
  __syncthreads();
#pragma unroll
  for (int j = 0; j < P::NW / 8; ++j) {
    const int col = nc * P::NW + 8 * j + t2;
    const float2 bb = *reinterpret_cast<const float2*>(b1 + col);
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<__nv_bfloat162*>(Y + (row0 + 8 * half) * P::LDY + col) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] + bb.x,
                                acc[4 * j + 2 * half + 1] + bb.y);
  }
  __syncthreads();
  for (int i = ct; i < P::BM * (C / 8); i += 256) {
    const int r = i / (C / 8);
    const int c = (i % (C / 8)) * 8;
    uint4* zp = reinterpret_cast<uint4*>(Y + r * P::LDY + c);
    *zp = snake8<APPROX>(*zp, tab + 2 * C + c, tab + 3 * C + c);
  }
  __syncthreads();

  // 4. k1 over z, + b2, cast, residual add in bf16, store
  mma_tiles<C>(acc, a_row, 0, 7 * P::NP, P::NP, ring, boff, lane);
#pragma unroll
  for (int j = 0; j < P::NW / 8; ++j) {
    const int col = nc * P::NW + 8 * j + t2;
    const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pos = r0 + row0 + 8 * half;
      if (pos >= L) continue;
      const long long off = (base + pos) * C + col;
      if (CENTRED && pos >= Lb) {
        *reinterpret_cast<uint32_t*>(out + off) = 0u;
        continue;
      }
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(x + off));
      *reinterpret_cast<__nv_bfloat162*>(out + off) = __floats2bfloat162_rn(
          xv.x + round_bf16(acc[4 * j + 2 * half] + bb.x),
          xv.y + round_bf16(acc[4 * j + 2 * half + 1] + bb.y));
    }
  }
}

// A (rows, KP) bf16 map with (64, BOX_N) boxes, 128-byte swizzle
template <int C>
int weight_map(CUtensorMap* m, const void* w, int rows) {
  using P = Plan<C>;
  const uint64_t dims[2] = {(uint64_t)P::KP, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)P::KP * 2};
  const uint32_t box[2] = {64u, (uint32_t)P::BOX_N};
  return make_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, dims, strides,
                  box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int C, bool APPROX, bool HIST, bool CENTRED = false>
int run_stack(const void* x, void* tmp, void* out, const void* w1,
              const void* b1, const void* a1, const void* w2, const void* b2,
              const void* a2, const void* const* hin, void* const* hout,
              int batch, int L, int bm, int stages, cudaStream_t st,
              const int* lens = nullptr) {
  using P = Plan<C>;
  if (bm != P::BM || stages != P::STAGES) return (int)cudaErrorInvalidValue;
  auto kern = res_unit_kernel<C, APPROX, HIST, CENTRED>;
  static const int attr = allow_smem(kern, P::smem(MAX_DIL));
  if (attr) return attr;
  CUtensorMap t1, t2;
  int rc;
  if ((rc = weight_map<C>(&t1, w1, 3 * 7 * C)) ||
      (rc = weight_map<C>(&t2, w2, 3 * C)))
    return rc;
  const dim3 grid((L + P::BM - 1) / P::BM, batch);
  // x -> out -> tmp -> out: a unit never writes the buffer it reads,
  // since a block reads its neighbour's rows as context
  const __nv_bfloat16* src[3] = {(const __nv_bfloat16*)x,
                                 (const __nv_bfloat16*)out,
                                 (const __nv_bfloat16*)tmp};
  __nv_bfloat16* dst[3] = {(__nv_bfloat16*)out, (__nv_bfloat16*)tmp,
                           (__nv_bfloat16*)out};
  const int dil[3] = {1, 3, 9};
  for (int u = 0; u < 3; ++u) {
    kern<<<grid, NTHREADS, P::smem(dil[u]), st>>>(
        t1, t2, src[u], dst[u], (const float*)b1, (const float*)a1,
        (const float*)b2, (const float*)a2, (const __nv_bfloat16*)hin[u],
        (__nv_bfloat16*)hout[u], lens, L, u, dil[u]);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  return 0;
}

template <int C>
int run_c(int approx, const void* x, void* tmp, void* out, const void* w1,
          const void* b1, const void* a1, const void* w2, const void* b2,
          const void* a2, const void* const* hin, void* const* hout,
          int batch, int L, int bm, int stages, cudaStream_t st) {
  const bool hist = hin[0] != nullptr;
  auto run = approx ? (hist ? run_stack<C, true, true> : run_stack<C, true, false>)
                    : (hist ? run_stack<C, false, true> : run_stack<C, false, false>);
  return run(x, tmp, out, w1, b1, a1, w2, b2, a2, hin, hout, batch, L, bm,
             stages, st, nullptr);
}

template <int C>
int run_centred(int approx, const void* x, void* tmp, void* out,
                const void* w1, const void* b1, const void* a1,
                const void* w2, const void* b2, const void* a2,
                const int* lens, int batch, int L, int bm, int stages,
                cudaStream_t st) {
  const void* hin[3] = {nullptr, nullptr, nullptr};
  void* hout[3] = {nullptr, nullptr, nullptr};
  auto run = approx ? run_stack<C, true, false, true>
                    : run_stack<C, false, false, true>;
  return run(x, tmp, out, w1, b1, a1, w2, b2, a2, hin, hout, batch, L, bm,
             stages, st, lens);
}

}  // namespace

// C entry point, loaded with ctypes (echo_tts_torch/ops/res_stack.py).
// x, tmp, out: (batch, L, C) bf16 contiguous, 16-byte aligned, three
// distinct buffers (the result is in out, tmp is scratch); w1 (3, 7, C,
// KP) and w2 (3, C, KP) bf16 as (unit, [tap,] C_out, C_in padded to KP =
// whole 64-channel panels, zeros beyond C); biases and alphas (3, C) fp32.
// h0in..h2in: null for the one-shot form (zero context before position
// 0), or the three units' histories (batch, 6d, C) bf16 for d = 1, 3, 9,
// with h0out..h2out three more buffers of the same shapes, distinct from
// them, that receive the new histories.  C must be one of the
// instantiated widths; bm and stages are the wrapper's tile plan and must
// equal this file's.  Runs the three units (d = 1, 3, 9) as three
// launches on `stream`; returns 0 or the first cudaError_t.
extern "C" int echo_res_stack_bf16(const void* x, void* tmp, void* out,
                                   const void* w1, const void* b1,
                                   const void* a1, const void* w2,
                                   const void* b2, const void* a2,
                                   const void* h0in, const void* h1in,
                                   const void* h2in, void* h0out,
                                   void* h1out, void* h2out, int batch,
                                   int L, int C, int bm, int stages,
                                   int approx, void* stream) {
  if (batch < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const void* hin[3] = {h0in, h1in, h2in};
  void* hout[3] = {h0out, h1out, h2out};
  for (int u = 0; u < 3; ++u)
    if ((hin[u] == nullptr) != (hin[0] == nullptr) ||
        (hin[u] == nullptr) != (hout[u] == nullptr) ||
        (hin[u] != nullptr && hin[u] == hout[u]))
      return (int)cudaErrorInvalidValue;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (C) {
    case 64: return run_c<64>(approx, x, tmp, out, w1, b1, a1, w2, b2, a2, hin, hout, batch, L, bm, stages, st);
    case 96: return run_c<96>(approx, x, tmp, out, w1, b1, a1, w2, b2, a2, hin, hout, batch, L, bm, stages, st);
    case 128: return run_c<128>(approx, x, tmp, out, w1, b1, a1, w2, b2, a2, hin, hout, batch, L, bm, stages, st);
    case 192: return run_c<192>(approx, x, tmp, out, w1, b1, a1, w2, b2, a2, hin, hout, batch, L, bm, stages, st);
    case 256: return run_c<256>(approx, x, tmp, out, w1, b1, a1, w2, b2, a2, hin, hout, batch, L, bm, stages, st);
    case 384: return run_c<384>(approx, x, tmp, out, w1, b1, a1, w2, b2, a2, hin, hout, batch, L, bm, stages, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The centred form (Descript's DAC decoder), same buffers and weights as
// echo_res_stack_bf16 without the histories: each k7 conv pads 3d zeros on
// each side.  lens: null, or (batch,) int32 device lengths, each row's
// positions at or past its own read as zero and written as zero.
extern "C" int echo_res_stack_centred_bf16(const void* x, void* tmp,
                                           void* out, const void* w1,
                                           const void* b1, const void* a1,
                                           const void* w2, const void* b2,
                                           const void* a2, const void* lens,
                                           int batch, int L, int C, int bm,
                                           int stages, int approx,
                                           void* stream) {
  if (batch < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* ln = reinterpret_cast<const int*>(lens);
  switch (C) {
    case 64: return run_centred<64>(approx, x, tmp, out, w1, b1, a1, w2, b2, a2, ln, batch, L, bm, stages, st);
    case 96: return run_centred<96>(approx, x, tmp, out, w1, b1, a1, w2, b2, a2, ln, batch, L, bm, stages, st);
    case 128: return run_centred<128>(approx, x, tmp, out, w1, b1, a1, w2, b2, a2, ln, batch, L, bm, stages, st);
    case 192: return run_centred<192>(approx, x, tmp, out, w1, b1, a1, w2, b2, a2, ln, batch, L, bm, stages, st);
    case 256: return run_centred<256>(approx, x, tmp, out, w1, b1, a1, w2, b2, a2, ln, batch, L, bm, stages, st);
    case 384: return run_centred<384>(approx, x, tmp, out, w1, b1, a1, w2, b2, a2, ln, batch, L, bm, stages, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

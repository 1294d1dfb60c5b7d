// Local-alignment (LA) DP on Hopper (sm_90a), full f32: four kernels, each
// on a choice of lane geometries.
//
// Replaces the four Pallas TPU kernels of stem_kernel_tpu/ops/pallas_la.py:
//
//   la_log_factored_f32  <- la_log_factored (body _la_log_fac_kernel)   K2
//   la_exp_factored_f32  <- la_exp_factored (body _la_exp_fac_kernel)   K3
//   la_exp_f32           <- la_exp_pallas   (body _la_exp_kernel)       K4
//   la_log_f32           <- la_log_pallas   (body _la_log_kernel)       K5
//
// All four run the M-only closure form of the 5-state sum over local
// alignments.  Per pair, for each row i < lx:
//
//   m = e * (1 + a + bg*g);   a' = m @ Tu;   g' = be*g + a;   K = 1 + sum m
//
// with Tu[k][j] = 1 at j = k+1 and bg*be^(j-k-2) beyond.  The log twin
// keeps log a, log g, takes r = max_j m and em = exp(m - r), and sets
// a' = r + log(em @ Tu), acc = logaddexp(acc, r + log sum em); it returns
// logaddexp(0, acc).  A closure below the smallest normal f32 is empty
// (a' = -1e30): the TPU kernels' floor max(av, 1e-38) is 0 under XLA,
// which flushes subnormals, and a true subnormal floor would make up mass.
//
// The emission is exp(le), with le = sum_k c_k fx[i][k] fy[j][k]
// (c = alpha*beta on slots 0, 1 and beta on the rest; rank <= 6) for the
// factored kernels, and le = beta*s[i][j] or beta*(alpha*s0[i][j] +
// s1[i][j]) for the materialised ones.  Rows >= lx are not visited; columns
// >= ly are masked exactly (e = 0, le = -1e30), which matches the TPU
// kernels' additive masks.
//
// What bounds it on the card: the work is a chain of lx dependent rows per
// pair, each O(ly) cells; there is no large product to feed the tensor
// cores.  The TPU kernel applied Tu as an (ly x ly) matmul per row, which
// would cost O(ly^2) a row and a resident Tu of 4*ly^2 bytes (227 KB of
// shared memory stops at ly ~ 241).  Here the product is its exact
// first-order recurrence,
//
//   a'[j] = m[j-1] + bg*z[j-2],   z[t] = be*z[t-1] + m[t],
//
// O(ly) a row, no matrix and no bound on ly from shared memory.  One warp
// holds one pair; lane l owns columns [l*C, l*C + C) in registers (C a
// compile-time 2..32, so ly <= 1024), runs z along its chunk, and a
// five-step shuffle scan of (be^C, carry) joins the chunks.  Row maxima and
// sums are butterfly shuffles, identical in every lane.  The kernel is
// bound by the latency of that per-row chain (about 20 dependent steps), so
// the card fills only with many pairs in flight: 4 pairs a block.  A pair's
// value depends on its own operands only, never on its batch.
//
// Ly > 1024: one pair a block of ceil(Ly / 1024) warps (at most 32, the
// largest block that launches: Ly <= 32768), each warp on a 1024-column
// chunk, 32 columns a lane.  The closure's z is a first-order recurrence,
// so warp w's carry-in is the earlier warps' chunk-end values (carry 0),
// each scaled by be^1024 per warp in between: the warps pass them, and
// their last columns' m and z, through shared memory, and each warp fixes
// up its own chunk.  Row maxima and sums become block reductions, taken in
// warp order.  Three barriers a row (two in exp space).  At 1024 threads a
// block the compiler keeps 64 registers a thread, so the 32-column chunks
// spill to local memory; the route is for rare long inputs, not for speed.
//
// Numerics of la_dp: expf/logf/log1pf (no fast-math intrinsics, no flush
// to zero, as in the plain torch version), and -1e30 for an empty log cell.
//
// The log kernels K2 and K5 (la_log_lanes) run the same row step on a lane
// geometry: a pair takes a block of P lanes of C columns (P C >= Ly); past
// one warp the P/32 warps join their row maxima, scan carries, edges and
// row sums through shared memory, two barriers a row.  The library holds
// the five geometries that the wrapper routes to (ops/la.py, LOG_ROUTE,
// placed by chip_smoke.py's geometry table): 32 lanes of 1, 2 or 4 columns
// up to 128 columns, 128 lanes of 2 or 4 up to 512, and the one-warp kernel
// past 512 rows or columns.  (Fewer than 32 lanes a pair, 64 lanes, 32 x 8
// and 128 x 1 or 8 lost at every width measured, and are gone.)  A pair's
// bits depend on the geometry, hence on the padded shape, never on its
// batch; the Gram engine pads a corpus once, so a Gram does not depend on
// its batch size.
//
// What the design does about the row chain (the kernel's time is lx rows of
// latency): the pair's fy sits in registers for the whole pair and the next
// row's fx (K2) or scores (K5) is loaded while a row is computed, so no load
// stands between two rows; each cell takes 7 SFU operations (ex2.approx,
// lg2.approx) where the one-warp kernel takes 8 libm calls:
// softplus(logaddexp(a, bg g)) is one log of a three-term sum under its
// largest term; the row maximum is one redux.sync on the floats'
// order-preserving integer keys; the row sum's butterfly runs beside the
// carry scan.
//
// Their error budget (against the plain version, log K): ex2.approx and
// lg2.approx err by about 2 units in the last place.  Logs stay natural, so
// every stored log value rounds as the plain version's does.  exp(m - r)
// is ex2 of (m - r) log2(e) carried in two floats (exp_sub): that product
// rounded to one float errs by |m - r| 2^-24 relatively, and in a plain
// torch model of the closure (la_log_numerics.py, 128 pairs a length) it
// lifted log K by 6e-5 at 256 columns to 3.3e-4 at 700 on average, and
// one pair by 3.6e-3; carried in two floats, 6.1e-5 at most.  exp(m - r)
// keeps its subnormal results (ex2.approx without .ftz), as torch.exp does:
// a closure summed from subnormal terms can reach TINY, and flushing them
// drops log K by 0.036 at 400 x 400 on average (la_log_numerics.py).  log
// an and log rs take the exponent exactly and the SFU only on the
// mantissa.  Past 400 columns some pairs are ill-conditioned: any change
// of rounding, f64 too, moves their log K by 1e-3 and more.  Past 512 rows
// or columns the one-warp kernel, which repeats the plain version's
// arithmetic, runs.
//
// The exp kernels K3 and K4 (la_exp_lanes) run the exp row step on a lane
// geometry too, with one barrier a row past one warp (the scan's carries
// and edges, double buffered by row parity; there is no row maximum), and
// take their own routes (ops/la.py, EXP_ROUTE, placed by chip_smoke.py's
// geometry table at B = 256: K3 on 32 x 1 up to 32 columns, 64 x 2 to 128,
// 128 x 2 to 256, 128 x 4 to 512; K4 on 32 x 1, 64 x 1, 128 x 1 to 128
// columns, then as K3).  Of 13 geometries timed (32 to 256 lanes of 1 to 8
// columns), the library holds those that won a width for K3 or K4.  In exp space a row's emission does not depend on the
// closure, so it is computed, exp included, one row ahead from operands
// loaded a row before that, and fy stays in registers.  What bounds them on
// the card is the issue of a row's instructions, not the chain's latency:
// with one pair a warp the lane scan's shuffles overlap the rest, and a pair
// runs faster when more warps split its columns (128 lanes of 1 column at
// 80 columns for K4) though each warp then waits at a barrier a row.  A
// deeper ring of rows in flight, and a systolic wavefront (lane l on row
// t - l at step t, one shuffle a step, no scan), bought nothing or lost in
// development runs.  exp is libm's expf: an exp on the SFU (ex2.approx with
// the argument in two floats) was slower.  A pair whose emissions overflow
// comes out non-finite, as the plain version does.

// C interface: each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // pairs per block
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;
constexpr float TINY = 1.17549435e-38f;  // smallest normal f32
constexpr int MAX_RANK = 6;
// wide blocks (Ly > 1024): one pair a block, WIDE_C columns a lane, a warp
// per WARP_COLS columns, at most WIDE_WARPS warps (1024 threads, the largest
// block that launches), so Ly <= 32768
constexpr int WIDE_C = 32;
constexpr int WARP_COLS = 32 * WIDE_C;
constexpr int WIDE_WARPS = 32;

__device__ __forceinline__ float logaddexp(float x, float y) {
  const float hi = fmaxf(x, y), lo = fminf(x, y);
  return hi + log1pf(expf(lo - hi));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// z along a lane's chunk with carry 0: z[c] = be z[c-1] + v[c]
template <int C>
__device__ __forceinline__ void chunk_scan(const float (&v)[C], float (&z)[C], float be) {
  z[0] = v[0];
#pragma unroll
  for (int c = 1; c < C; ++c) z[c] = fmaf(be, z[c - 1], v[c]);
}

// inclusive scan over lanes of x_l = be^C x_(l-1) + z_l[C-1], carry 0 at lane 0
__device__ __forceinline__ float lane_scan(float x, float beC, int lane) {
  float p = beC;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x = fmaf(p, y, x);
    p *= p;
  }
  return x;
}

// z += be^(c+1) zin, zin being z at the column before the chunk
template <int C>
__device__ __forceinline__ void add_carry(float (&z)[C], float be, float zin) {
  float pw = be;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    z[c] = fmaf(pw, zin, z[c]);
    pw *= be;
  }
}

// an = v @ Tu from the chunk and the columns before it (m_prev = v, z_prev, z_prev2)
template <int C>
__device__ __forceinline__ void closure_an(const float (&v)[C], const float (&z)[C], float (&an)[C],
                                           float bg, float m_prev, float z_prev, float z_prev2) {
  an[0] = fmaf(bg, z_prev2, m_prev);
  an[1] = fmaf(bg, z_prev, v[0]);
#pragma unroll
  for (int c = 2; c < C; ++c) an[c] = fmaf(bg, z[c - 2], v[c - 1]);
}

// an = v @ Tu for one row held by the warp, lane chunks of C columns.
// beC = be^C.  Column 0 of Tu is empty, so an[0] of lane 0 is 0.
template <int C>
__device__ __forceinline__ void closure_row(const float (&v)[C], float (&an)[C],
                                            float bg, float be, float beC, int lane) {
  float z[C];
  chunk_scan<C>(v, z, be);
  const float x = lane_scan(z[C - 1], beC, lane);
  float zin = __shfl_up_sync(FULL, x, 1);  // z at the column before the chunk
  if (lane == 0) zin = 0.f;
  add_carry<C>(z, be, zin);
  float m_prev = __shfl_up_sync(FULL, v[C - 1], 1);
  float z_prev = __shfl_up_sync(FULL, z[C - 1], 1);
  float z_prev2 = __shfl_up_sync(FULL, z[C - 2], 1);
  if (lane == 0) m_prev = z_prev = z_prev2 = 0.f;
  closure_an<C>(v, z, an, bg, m_prev, z_prev, z_prev2);
}

// Shared memory of a wide block (one pair, up to WIDE_WARPS warps of
// WARP_COLS columns each): the warps' row maxima and sums, their chunk-end
// z with carry 0, and their last column's m, z and the z before it.
struct Wide {
  float red[WIDE_WARPS], sum[WIDE_WARPS], end[WIDE_WARPS], edge[WIDE_WARPS][3];
};

// closure_row across the warps of a wide block.  The warps' carries are
// joined through shared memory: warp w's carry-in is z at the last column of
// warp w-1, sum over w' < w of end[w'] be^(WARP_COLS (w-1-w')); each warp then
// fixes up its own chunk.  Two barriers.  rs: this warp's row sum, returned
// as the block's (summed in warp order).
template <int C>
__device__ __forceinline__ void closure_row_wide(const float (&v)[C], float (&an)[C], float bg,
                                                 float be, float beC, float beW, float beLane,
                                                 int lane, int warp, int nwarps, Wide& sh,
                                                 float& rs) {
  float z[C];
  chunk_scan<C>(v, z, be);
  const float x = lane_scan(z[C - 1], beC, lane);
  if (lane == 31) {
    sh.end[warp] = x;
    sh.sum[warp] = rs;
  }
  __syncthreads();
  float zw = 0.f;  // z at the column before this warp's chunk
  for (int q = 0; q < warp; ++q) zw = fmaf(beW, zw, sh.end[q]);
  float total = 0.f;
  for (int q = 0; q < nwarps; ++q) total += sh.sum[q];
  rs = total;
  float zin = __shfl_up_sync(FULL, x, 1);
  if (lane == 0) zin = 0.f;
  zin = fmaf(beLane, zw, zin);
  add_carry<C>(z, be, zin);
  float m_prev = __shfl_up_sync(FULL, v[C - 1], 1);
  float z_prev = __shfl_up_sync(FULL, z[C - 1], 1);
  float z_prev2 = __shfl_up_sync(FULL, z[C - 2], 1);
  if (lane == 31) {
    sh.edge[warp][0] = v[C - 1];
    sh.edge[warp][1] = z[C - 1];
    sh.edge[warp][2] = z[C - 2];
  }
  __syncthreads();
  if (lane == 0) {
    const bool first = warp == 0;
    m_prev = first ? 0.f : sh.edge[warp - 1][0];
    z_prev = first ? 0.f : sh.edge[warp - 1][1];
    z_prev2 = first ? 0.f : sh.edge[warp - 1][2];
  }
  closure_an<C>(v, z, an, bg, m_prev, z_prev, z_prev2);
}

struct Params {
  float alpha, beta, bg, be, lbg, lbe;
};

// FACTORED: p0 = fx (B, max_lx, rank), p1 = fy (B, max_ly, rank).
// Otherwise: p0 = s0 (B, max_lx, max_ly), p1 = s1 of the same shape or null.
// WIDE: one pair a block of ceil(max_ly / WARP_COLS) warps (C = WIDE_C);
// otherwise one pair a warp, WARPS pairs a block.
template <int C, bool LOG, bool FACTORED, bool WIDE>
__global__ void __launch_bounds__(WIDE ? 32 * WIDE_WARPS : 32 * WARPS)
la_dp(const float* __restrict__ p0, const float* __restrict__ p1,
      const int* __restrict__ lx, const int* __restrict__ ly,
      int batch, int max_lx, int max_ly, int rank, Params prm,
      float* __restrict__ out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  const int b = WIDE ? blockIdx.x : blockIdx.x * WARPS + warp;
  if (b >= batch) return;  // the whole warp (a wide block: the whole block) leaves together
  const int nx = min(max(lx[b], 0), max_lx);
  const int ny = min(max(ly[b], 0), max_ly);
  const int j0 = (WIDE ? warp * WARP_COLS : 0) + lane * C;

  float beC = 1.f;
#pragma unroll
  for (int c = 0; c < C; ++c) beC *= prm.be;
  const float ab = prm.alpha * prm.beta;
  __shared__ Wide sh;  // used by wide blocks only
  float beW = 1.f, beLane = 1.f;  // be^WARP_COLS, be^(lane C)
  if (WIDE) {
    for (int q = 0; q < 32; ++q) beW *= beC;
    for (int q = 0; q < lane; ++q) beLane *= beC;
  }

  float a[C], g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) a[c] = g[c] = LOG ? NEG : 0.f;
  float acc = LOG ? NEG : 0.f;  // exp: this lane's sum of m; log: warp-uniform

  for (int i = 0; i < nx; ++i) {
    // ---- log emission of row i on this lane's columns ----
    float le[C];
    if (FACTORED) {
      const float* fxr = p0 + ((size_t)b * max_lx + i) * rank;
      float fxs[MAX_RANK];
#pragma unroll
      for (int k = 0; k < MAX_RANK; ++k)
        fxs[k] = k < rank ? fxr[k] * (k < 2 ? ab : prm.beta) : 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = j0 + c;
        float s = 0.f;
        if (j < ny) {
          const float* fyr = p1 + ((size_t)b * max_ly + j) * rank;
          s = fxs[0] * fyr[0];
#pragma unroll
          for (int k = 1; k < MAX_RANK; ++k)
            if (k < rank) s = fmaf(fxs[k], fyr[k], s);
        }
        le[c] = s;
      }
    } else {
      const size_t row = ((size_t)b * max_lx + i) * max_ly;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = j0 + c;
        float s = 0.f;
        if (j < ny) {
          s = p0[row + j];
          if (p1 != nullptr) s = fmaf(prm.alpha, s, p1[row + j]);
        }
        le[c] = prm.beta * s;
      }
    }

    float v[C], an[C];
    if (!LOG) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float e = (j0 + c < ny) ? expf(le[c]) : 0.f;
        v[c] = e * (1.f + a[c] + prm.bg * g[c]);
        acc += v[c];
      }
      if (WIDE) {
        float unused = 0.f;
        closure_row_wide<C>(v, an, prm.bg, prm.be, beC, beW, beLane, lane, warp, nwarps, sh,
                            unused);
      } else {
        closure_row<C>(v, an, prm.bg, prm.be, beC, lane);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        g[c] = fmaf(prm.be, g[c], a[c]);
        a[c] = an[c];
      }
    } else {
      float m[C];
      float r = NEG;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float s = logaddexp(a[c], prm.lbg + g[c]);
        m[c] = ((j0 + c < ny) ? le[c] : NEG) + logaddexp(0.f, s);
        r = fmaxf(r, m[c]);
      }
      r = warp_max(r);
      if (WIDE) {
        if (lane == 0) sh.red[warp] = r;
        __syncthreads();
        for (int q = 0; q < nwarps; ++q) r = fmaxf(r, sh.red[q]);
      }
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[c] = expf(m[c] - r);
        rs += v[c];
      }
      rs = warp_sum(rs);
      if (WIDE)
        closure_row_wide<C>(v, an, prm.bg, prm.be, beC, beW, beLane, lane, warp, nwarps, sh, rs);
      else
        closure_row<C>(v, an, prm.bg, prm.be, beC, lane);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        g[c] = logaddexp(prm.lbe + g[c], a[c]);
        a[c] = an[c] >= TINY ? r + logf(an[c]) : NEG;
      }
      acc = logaddexp(acc, r + logf(fmaxf(rs, TINY)));
    }
  }
  if (!LOG) {
    acc = warp_sum(acc);
    if (WIDE) {  // the warps' sums in warp order
      if (lane == 0) sh.red[warp] = acc;
      __syncthreads();
      acc = 0.f;
      for (int q = 0; q < nwarps; ++q) acc += sh.red[q];
    }
    acc = 1.f + acc;
  } else {
    acc = logaddexp(0.f, acc);
  }
  if (lane == 0 && (!WIDE || warp == 0)) out[b] = acc;
}

template <bool LOG, bool FACTORED>
int launch(const float* p0, const float* p1, const int* lx, const int* ly,
           int batch, int max_lx, int max_ly, int rank, Params prm,
           float* out, cudaStream_t stream) {
  const int chunk = (max_ly + 31) / 32;
  const dim3 grid((batch + WARPS - 1) / WARPS), block(32 * WARPS);
#define LA_DP_CASE(CC)                                                     \
  la_dp<CC, LOG, FACTORED, false><<<grid, block, 0, stream>>>(             \
      p0, p1, lx, ly, batch, max_lx, max_ly, rank, prm, out)
  if (chunk <= 2) LA_DP_CASE(2);
  else if (chunk <= 4) LA_DP_CASE(4);
  else if (chunk <= 8) LA_DP_CASE(8);
  else if (chunk <= 16) LA_DP_CASE(16);
  else if (chunk <= 32) LA_DP_CASE(32);
  else if (max_ly <= WIDE_WARPS * WARP_COLS) {
    const int threads = 32 * ((max_ly + WARP_COLS - 1) / WARP_COLS);
    la_dp<WIDE_C, LOG, FACTORED, true><<<batch, threads, 0, stream>>>(
        p0, p1, lx, ly, batch, max_lx, max_ly, rank, prm, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef LA_DP_CASE
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The log kernels K2 and K5 on a lane geometry (P lanes of C columns a pair).

constexpr float L2E = 1.4426950408889634f;  // log2(e)
constexpr float L2E_LO = 1.925963033500011e-08f;  // log2(e) - L2E
constexpr float LN2 = 0.6931471805599453f;

// 2^x on the SFU; results below the smallest normal f32 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^x on the SFU, keeping subnormal results
__device__ __forceinline__ float ex2_sub(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// e^x for x <= 0 on the SFU, keeping subnormal results: x log2(e) as t + d,
// t its rounding, and 2^(t + d) = 2^t (1 + d ln 2) up to (d ln 2)^2 / 2,
// below 2^-34 since |d| <= 2^-24 |t|
__device__ __forceinline__ float exp_sub(float x) {
  const float t = x * L2E;
  const float d = fmaf(x, L2E, -t) + x * L2E_LO;
  const float y = ex2_sub(t);
  return fmaf(y, d * LN2, y);
}

// log2 x on the SFU, for x in [1, 4)
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log2 x for a normal x > 0 of any size: the exponent exactly (a float
// built from its bits, no conversion instruction) plus the SFU's log2 of
// the mantissa in [1, 2), where its error is smallest
__device__ __forceinline__ float lg2_wide(float x) {
  const int b = __float_as_int(x);
  const float e = __int_as_float(0x4B000000 | (b >> 23)) - 8388735.f;  // 2^23 + 127
  return e + lg2(__int_as_float((b & 0x007fffff) | 0x3f800000));
}

// logaddexp on the SFU (natural logs, as the plain version keeps them)
__device__ __forceinline__ float lae(float x, float y) {
  const float hi = fmaxf(x, y), lo = fminf(x, y);
  return fmaf(LN2, lg2(1.f + ex2((lo - hi) * L2E)), hi);
}

// f32 <-> a signed int of the same order, so that redux.sync takes the max
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float order_value(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// One pair a block of P threads, C columns a thread: thread q owns columns
// [q C, q C + C).  P/32 warps join through shared memory, two barriers a row.
template <int P, int C, bool FACTORED>
__global__ void __launch_bounds__(P)
la_log_lanes(const float* __restrict__ p0, const float* __restrict__ p1,
             const int* __restrict__ lx, const int* __restrict__ ly,
             int max_lx, int max_ly, int rank, Params prm, float* __restrict__ out) {
  constexpr int W = P / 32;  // warps of the pair
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.x;
  const int nx = min(max(lx[b], 0), max_lx);
  const int ny = min(max(ly[b], 0), max_ly);
  const int q = threadIdx.x;
  const int j0 = q * C;
  if (ny == 0) {  // every cell masked: log K = log 1
    if (q == 0) out[b] = 0.f;
    return;
  }

  float bp[C];  // be^(c+1)
  bp[0] = prm.be;
#pragma unroll
  for (int c = 1; c < C; ++c) bp[c] = bp[c - 1] * prm.be;
  const float beC = bp[C - 1];
  // W > 1: be^(32 C) (a warp's columns), be^(32 C - 1), be^(lane C)
  float beW = 1.f, bePre = 1.f, beLane = 1.f;
  if (W > 1) {
    for (int t = 0; t < 32; ++t) beW *= beC;
    bePre = beW / prm.be;
    for (int t = 0; t < lane; ++t) beLane *= beC;
  }
  __shared__ float sh_max[W], sh_end[W], sh_pre[W], sh_last[W], sh_sum[W];

  // ---- the pair's operands: fy in registers; row i + 1 loaded during row i
  const float ab = prm.alpha * prm.beta;
  float fyr[C][MAX_RANK];
  float fxn[MAX_RANK];
  float sn[C], s2n[C];
  const size_t xbase = (size_t)b * max_lx;
  if constexpr (FACTORED) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      const float* fy = p1 + ((size_t)b * max_ly + j) * rank;
#pragma unroll
      for (int k = 0; k < MAX_RANK; ++k) fyr[c][k] = (j < ny && k < rank) ? fy[k] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < MAX_RANK; ++k) fxn[k] = (nx > 0 && k < rank) ? p0[xbase * rank + k] : 0.f;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      sn[c] = (nx > 0 && j < ny) ? p0[xbase * max_ly + j] : 0.f;
      s2n[c] = (nx > 0 && j < ny && p1 != nullptr) ? p1[xbase * max_ly + j] : 0.f;
    }
  }

  float a[C], g[C];  // log a, log g
#pragma unroll
  for (int c = 0; c < C; ++c) a[c] = g[c] = NEG;
  float acc = NEG;  // log of the sum of m so far, uniform over the pair

  for (int i = 0; i < nx; ++i) {
    // ---- log emission of row i (its operands were loaded a row earlier)
    float le[C];
    if constexpr (FACTORED) {
      float fxs[MAX_RANK];
#pragma unroll
      for (int k = 0; k < MAX_RANK; ++k) fxs[k] = fxn[k] * (k < 2 ? ab : prm.beta);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float s = fxs[0] * fyr[c][0];
#pragma unroll
        for (int k = 1; k < MAX_RANK; ++k) s = fmaf(fxs[k], fyr[c][k], s);
        le[c] = s;
      }
      const size_t row = (xbase + min(i + 1, nx - 1)) * rank;
#pragma unroll
      for (int k = 0; k < MAX_RANK; ++k) fxn[k] = k < rank ? p0[row + k] : 0.f;
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c)
        le[c] = prm.beta * (p1 != nullptr ? fmaf(prm.alpha, sn[c], s2n[c]) : sn[c]);
      const size_t row = (xbase + min(i + 1, nx - 1)) * max_ly;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = j0 + c;
        sn[c] = j < ny ? p0[row + j] : 0.f;
        s2n[c] = (j < ny && p1 != nullptr) ? p1[row + j] : 0.f;
      }
    }

    // ---- m = le + log(1 + a + bg g), the largest of the three terms
    // factored out: one lg2 and two ex2 a cell
    float m[C];
    float r = NEG;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float x = a[c], y = prm.lbg + g[c];
      const float hi = fmaxf(x, y), lo = fminf(x, y);
      const float h = fmaxf(hi, 0.f), o = fminf(hi, 0.f);
      const float sp = fmaf(LN2, lg2(1.f + ex2((o - h) * L2E) + ex2((lo - h) * L2E)), h);
      m[c] = j0 + c < ny ? le[c] + sp : NEG;
      r = fmaxf(r, m[c]);
    }
    r = order_value(__reduce_max_sync(FULL, order_key(r)));
    if (W > 1) {
      if (lane == 0) sh_max[warp] = r;
      __syncthreads();
#pragma unroll
      for (int t = 0; t < W; ++t) r = fmaxf(r, sh_max[t]);
    }

    // ---- v = exp(m - r); its row sum and the closure scan side by side
    float v[C], z[C];
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] = exp_sub(m[c] - r);
      rs += v[c];
    }
    z[0] = v[0];
#pragma unroll
    for (int c = 1; c < C; ++c) z[c] = fmaf(prm.be, z[c - 1], v[c]);
    float x = z[C - 1], p = beC;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(FULL, x, d);
      rs += __shfl_xor_sync(FULL, rs, d);
      if (lane >= d) x = fmaf(p, y, x);
      p *= p;
    }
    float zin = __shfl_up_sync(FULL, x, 1);  // z at the column before the chunk
    if (lane == 0) zin = 0.f;
    float m_edge = 0.f, z2_edge = 0.f;  // lane 0 of warp w > 0: from warp w - 1
    if (W > 1) {
      if (lane == 31) {
        sh_end[warp] = x;
        if constexpr (C > 1) sh_pre[warp] = fmaf(bp[C - 2], zin, z[C - 2]);
        else sh_pre[warp] = zin;
        sh_last[warp] = v[C - 1];
        sh_sum[warp] = rs;
      }
      __syncthreads();
      float zw = 0.f, zw_prev = 0.f;  // carry into this warp, into the one before
      for (int t = 0; t < warp; ++t) {
        zw_prev = zw;
        zw = fmaf(beW, zw, sh_end[t]);
      }
      rs = 0.f;
#pragma unroll
      for (int t = 0; t < W; ++t) rs += sh_sum[t];
      zin = fmaf(beLane, zw, zin);
      if (warp > 0) {
        m_edge = sh_last[warp - 1];
        z2_edge = fmaf(bePre, zw_prev, sh_pre[warp - 1]);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) z[c] = fmaf(bp[c], zin, z[c]);
    // an = v @ Tu: an[j] = v[j-1] + bg z[j-2]
    float m_prev = __shfl_up_sync(FULL, v[C - 1], 1);
    float z_prev2;
    if constexpr (C > 1) z_prev2 = __shfl_up_sync(FULL, z[C - 2], 1);
    else z_prev2 = __shfl_up_sync(FULL, zin, 1);
    if (lane == 0) {
      m_prev = m_edge;
      z_prev2 = z2_edge;
    }
    float an[C];
    an[0] = fmaf(prm.bg, z_prev2, m_prev);
    if constexpr (C > 1) an[1] = fmaf(prm.bg, zin, v[0]);
#pragma unroll
    for (int c = 2; c < C; ++c) an[c] = fmaf(prm.bg, z[c - 2], v[c - 1]);

#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float gn = lae(prm.lbe + g[c], a[c]);
      a[c] = an[c] >= TINY ? fmaf(LN2, lg2_wide(an[c]), r) : NEG;
      g[c] = gn;
    }
    acc = lae(acc, fmaf(LN2, lg2_wide(fmaxf(rs, TINY)), r));
  }
  if (q == 0) out[b] = lae(0.f, acc);
}

// lanes 0: the one-warp kernel (and its one-block-a-pair form past 1024
// columns); otherwise la_log_lanes<lanes, cols>, which needs lanes * cols >= max_ly
template <bool FACTORED>
int launch_log(const float* p0, const float* p1, const int* lx, const int* ly,
               int batch, int max_lx, int max_ly, int rank, int lanes, int cols,
               Params prm, float* out, cudaStream_t stream) {
  if (lanes == 0)
    return launch<true, FACTORED>(p0, p1, lx, ly, batch, max_lx, max_ly, rank, prm, out, stream);
  if (lanes * cols < max_ly) return (int)cudaErrorInvalidValue;
#define LA_LOG_CASE(PP, CC)                                                         \
  if (lanes == PP && cols == CC) {                                                  \
    la_log_lanes<PP, CC, FACTORED><<<batch, PP, 0, stream>>>(p0, p1, lx, ly, max_lx, \
                                                             max_ly, rank, prm, out); \
    return (int)cudaGetLastError();                                                 \
  }
  LA_LOG_CASE(32, 1) LA_LOG_CASE(32, 2) LA_LOG_CASE(32, 4)  // ops/la.py LOG_GEOMETRIES
  LA_LOG_CASE(128, 2) LA_LOG_CASE(128, 4)
#undef LA_LOG_CASE
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The exp kernels K3 and K4 on a lane geometry (P lanes of C columns a pair).

// One pair a block of P threads, C columns a thread (thread q owns columns
// [q C, q C + C)).  The emission e of row i + 1, exp included, is computed
// during row i from operands loaded D rows earlier, so the row
// step starts from a ready e and only the closure is on the chain.  P/32
// warps join their scan carries and edges through shared memory, double
// buffered by row parity: one barrier a row.  Each thread keeps its own
// running sum of m, reduced once after the last row, lanes by butterfly and
// warps in warp order.
template <int P, int C, bool FACTORED>
__global__ void __launch_bounds__(P)
la_exp_lanes(const float* __restrict__ p0, const float* __restrict__ p1,
             const int* __restrict__ lx, const int* __restrict__ ly,
             int max_lx, int max_ly, int rank, Params prm, float* __restrict__ out) {
  constexpr int W = P / 32;  // warps of the pair
  // rows of operands in flight: 3 for K4's scores at one column a lane, its
  // shortest row step; 1 elsewhere
  constexpr int D = (C == 1 && !FACTORED) ? 3 : 1;
  // a row's operands a thread holds: fx (K3), or its scores in one or two slabs (K4)
  constexpr int R = FACTORED ? MAX_RANK : 2 * C;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.x;
  const int nx = min(max(lx[b], 0), max_lx);
  const int ny = min(max(ly[b], 0), max_ly);
  const int j0 = threadIdx.x * C;
  if (nx == 0 || ny == 0) {  // every cell masked: K = 1
    if (threadIdx.x == 0) out[b] = 1.f;
    return;
  }

  float bp[C];  // be^(c+1)
  bp[0] = prm.be;
#pragma unroll
  for (int c = 1; c < C; ++c) bp[c] = bp[c - 1] * prm.be;
  const float beC = bp[C - 1];
  // W > 1: be^(32 C) (a warp's columns), be^(32 C - 1), be^(lane C), be^((lane - 1) C)
  float beW = 1.f, bePre = 1.f, beLane = 1.f, beLane1 = 1.f;
  if (W > 1) {
    for (int t = 0; t < 32; ++t) beW *= beC;
    bePre = beW / prm.be;
    for (int t = 0; t < lane; ++t) {
      beLane1 = beLane;
      beLane *= beC;
    }
  }
  float pw[5];  // be^(C 2^k): the lane scan's factors, the same every row
  pw[0] = beC;
#pragma unroll
  for (int k = 1; k < 5; ++k) pw[k] = pw[k - 1] * pw[k - 1];
  __shared__ float sh_end[2][W], sh_pre[2][W], sh_last[2][W], sh_acc[W];

  // ---- the pair's operands: fy in registers; the rows' fx or scores in a
  // ring of D rows, each loaded D rows before its emission is computed
  const float ab = prm.alpha * prm.beta;
  const bool two = p1 != nullptr;
  const size_t xbase = (size_t)b * max_lx;
  float fyr[C][MAX_RANK];
  float ring[D][R];
  auto load_row = [&](int r, float (&op)[R]) {
    if constexpr (FACTORED) {
      const size_t row = (xbase + r) * rank;
#pragma unroll
      for (int k = 0; k < MAX_RANK; ++k) op[k] = k < rank ? p0[row + k] : 0.f;
    } else {
      const size_t row = (xbase + r) * max_ly;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = j0 + c;
        op[c] = j < ny ? p0[row + j] : 0.f;
        op[C + c] = (j < ny && two) ? p1[row + j] : 0.f;
      }
    }
  };
  // e of a row from its operands; 0 on masked columns
  auto emission = [&](const float (&op)[R], float (&e)[C]) {
    if constexpr (FACTORED) {
      float fxs[MAX_RANK];
#pragma unroll
      for (int k = 0; k < MAX_RANK; ++k) fxs[k] = op[k] * (k < 2 ? ab : prm.beta);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float s = fxs[0] * fyr[c][0];
#pragma unroll
        for (int k = 1; k < MAX_RANK; ++k) s = fmaf(fxs[k], fyr[c][k], s);
        e[c] = j0 + c < ny ? expf(s) : 0.f;
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float le = prm.beta * (two ? fmaf(prm.alpha, op[c], op[C + c]) : op[c]);
        e[c] = j0 + c < ny ? expf(le) : 0.f;
      }
    }
  };
  if constexpr (FACTORED) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      const float* fy = p1 + ((size_t)b * max_ly + j) * rank;
#pragma unroll
      for (int k = 0; k < MAX_RANK; ++k) fyr[c][k] = (j < ny && k < rank) ? fy[k] : 0.f;
    }
  }
  float e[C];
  load_row(0, ring[0]);
  emission(ring[0], e);
#pragma unroll
  for (int d = 0; d < D; ++d) load_row(min(1 + d, nx - 1), ring[d]);

  float a[C], g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) a[c] = g[c] = 0.f;
  float acc = 0.f;  // this thread's sum of m

  for (int i = 0; i < nx; ++i) {
    // ---- off the chain: e of row i + 1, and the operands of row i + 1 + D
    float en[C];
    emission(ring[0], en);
#pragma unroll
    for (int d = 0; d + 1 < D; ++d) {
#pragma unroll
      for (int k = 0; k < R; ++k) ring[d][k] = ring[d + 1][k];
    }
    load_row(min(i + 1 + D, nx - 1), ring[D - 1]);

    // ---- m = e (1 + a + bg g) = e a + w, w = e (1 + bg g) known before a;
    // the chunk's z with carry 0
    float v[C], z[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] = fmaf(e[c], a[c], e[c] * fmaf(prm.bg, g[c], 1.f));
      acc += v[c];
    }
    z[0] = v[0];
#pragma unroll
    for (int c = 1; c < C; ++c) z[c] = fmaf(prm.be, z[c - 1], v[c]);
    // the lane before's last m and z at its column C - 2 (carry 0), taken
    // before the scan so that neither shuffle waits on it
    float m_prev = __shfl_up_sync(FULL, v[C - 1], 1);
    float z_loc2 = 0.f;
    if constexpr (C > 1) z_loc2 = __shfl_up_sync(FULL, z[C - 2], 1);
    // inclusive scan over the warp's lanes of x = be^C x' + z[C - 1]
    float x = z[C - 1];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float y = __shfl_up_sync(FULL, x, 1 << k);
      if (lane >= (1 << k)) x = fmaf(pw[k], y, x);
    }
    // z at the column before this lane's chunk and before the lane before's
    float zin = __shfl_up_sync(FULL, x, 1);
    float zin1 = __shfl_up_sync(FULL, x, 2);
    if (lane < 1) zin = 0.f;
    if (lane < 2) zin1 = 0.f;
    float m_edge = 0.f, z2_edge = 0.f;  // lane 0 of warp w > 0: from warp w - 1
    if (W > 1) {
      const int par = i & 1;
      if (lane == 31) {
        sh_end[par][warp] = x;
        if constexpr (C > 1) sh_pre[par][warp] = fmaf(bp[C - 2], zin, z[C - 2]);
        else sh_pre[par][warp] = zin;
        sh_last[par][warp] = v[C - 1];
      }
      __syncthreads();
      float zw = 0.f, zw_prev = 0.f;  // carry into this warp, into the one before
      for (int t = 0; t < warp; ++t) {
        zw_prev = zw;
        zw = fmaf(beW, zw, sh_end[par][t]);
      }
      zin = fmaf(beLane, zw, zin);
      if (lane >= 1) zin1 = fmaf(beLane1, zw, zin1);
      if (warp > 0) {
        m_edge = sh_last[par][warp - 1];
        z2_edge = fmaf(bePre, zw_prev, sh_pre[par][warp - 1]);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) z[c] = fmaf(bp[c], zin, z[c]);
    // an = v @ Tu: an[j] = v[j-1] + bg z[j-2]; z[j-2] of the first column
    // is the lane before's z at its column C - 2, with its carry zin1
    float z_prev2;
    if constexpr (C > 1) z_prev2 = fmaf(bp[C - 2], zin1, z_loc2);
    else z_prev2 = zin1;
    if (lane == 0) {
      m_prev = m_edge;
      z_prev2 = z2_edge;
    }
    float an[C];
    an[0] = fmaf(prm.bg, z_prev2, m_prev);
    if constexpr (C > 1) an[1] = fmaf(prm.bg, zin, v[0]);
#pragma unroll
    for (int c = 2; c < C; ++c) an[c] = fmaf(prm.bg, z[c - 2], v[c - 1]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      g[c] = fmaf(prm.be, g[c], a[c]);
      a[c] = an[c];
      e[c] = en[c];
    }
  }
  acc = warp_sum(acc);
  if (W > 1) {  // the warps' sums in warp order
    if (lane == 0) sh_acc[warp] = acc;
    __syncthreads();
    acc = 0.f;
#pragma unroll
    for (int t = 0; t < W; ++t) acc += sh_acc[t];
  }
  if (threadIdx.x == 0) out[b] = 1.f + acc;
}

// lanes 0: the one-warp kernel (and its one-block-a-pair form past 1024
// columns); otherwise la_exp_lanes<lanes, cols>, which needs lanes * cols >= max_ly
template <bool FACTORED>
int launch_exp(const float* p0, const float* p1, const int* lx, const int* ly,
               int batch, int max_lx, int max_ly, int rank, int lanes, int cols,
               Params prm, float* out, cudaStream_t stream) {
  if (lanes == 0)
    return launch<false, FACTORED>(p0, p1, lx, ly, batch, max_lx, max_ly, rank, prm, out, stream);
  if (lanes * cols < max_ly) return (int)cudaErrorInvalidValue;
#define LA_EXP_CASE(PP, CC)                                                         \
  if (lanes == PP && cols == CC) {                                                  \
    la_exp_lanes<PP, CC, FACTORED><<<batch, PP, 0, stream>>>(p0, p1, lx, ly, max_lx, \
                                                             max_ly, rank, prm, out); \
    return (int)cudaGetLastError();                                                 \
  }
  if constexpr (FACTORED) {  // ops/la.py EXP_GEOMETRIES["factored"]
    LA_EXP_CASE(32, 1) LA_EXP_CASE(64, 2) LA_EXP_CASE(128, 2) LA_EXP_CASE(128, 4)
  } else {  // EXP_GEOMETRIES["scores"]
    LA_EXP_CASE(32, 1) LA_EXP_CASE(64, 1) LA_EXP_CASE(128, 1) LA_EXP_CASE(128, 2)
    LA_EXP_CASE(128, 4)
  }
#undef LA_EXP_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// every entry point takes the lane geometry (lanes, cols); lanes 0 is the one-warp kernel
extern "C" int la_log_factored_f32(
    const float* fx, const float* fy, const int* lx, const int* ly,
    int batch, int max_lx, int max_ly, int rank, int lanes, int cols,
    float alpha, float beta, float bg, float be, float lbg, float lbe,
    float* out, cudaStream_t stream) {
  if (rank < 2 || rank > MAX_RANK) return (int)cudaErrorInvalidValue;
  return launch_log<true>(fx, fy, lx, ly, batch, max_lx, max_ly, rank, lanes, cols,
                          Params{alpha, beta, bg, be, lbg, lbe}, out, stream);
}

extern "C" int la_exp_factored_f32(
    const float* fx, const float* fy, const int* lx, const int* ly,
    int batch, int max_lx, int max_ly, int rank, int lanes, int cols,
    float alpha, float beta, float bg, float be, float lbg, float lbe,
    float* out, cudaStream_t stream) {
  if (rank < 2 || rank > MAX_RANK) return (int)cudaErrorInvalidValue;
  return launch_exp<true>(fx, fy, lx, ly, batch, max_lx, max_ly, rank, lanes, cols,
                          Params{alpha, beta, bg, be, lbg, lbe}, out, stream);
}

extern "C" int la_exp_f32(
    const float* s0, const float* s1, const int* lx, const int* ly,
    int batch, int max_lx, int max_ly, int lanes, int cols,
    float alpha, float beta, float bg, float be, float lbg, float lbe,
    float* out, cudaStream_t stream) {
  return launch_exp<false>(s0, s1, lx, ly, batch, max_lx, max_ly, 0, lanes, cols,
                           Params{alpha, beta, bg, be, lbg, lbe}, out, stream);
}

extern "C" int la_log_f32(
    const float* s0, const float* s1, const int* lx, const int* ly,
    int batch, int max_lx, int max_ly, int lanes, int cols,
    float alpha, float beta, float bg, float be, float lbg, float lbe,
    float* out, cudaStream_t stream) {
  return launch_log<false>(s0, s1, lx, ly, batch, max_lx, max_ly, 0, lanes, cols,
                           Params{alpha, beta, bg, be, lbg, lbe}, out, stream);
}

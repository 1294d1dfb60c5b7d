// Local-alignment (LA) DP on Hopper (sm_90a), full f32: four kernels.
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
// Numerics: expf/logf/log1pf (no fast-math intrinsics, no flush to zero,
// as in the plain torch version), and -1e30 for an empty log cell.
//
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

}  // namespace

extern "C" int la_log_factored_f32(
    const float* fx, const float* fy, const int* lx, const int* ly,
    int batch, int max_lx, int max_ly, int rank,
    float alpha, float beta, float bg, float be, float lbg, float lbe,
    float* out, cudaStream_t stream) {
  if (rank < 2 || rank > MAX_RANK) return (int)cudaErrorInvalidValue;
  return launch<true, true>(fx, fy, lx, ly, batch, max_lx, max_ly, rank,
                            Params{alpha, beta, bg, be, lbg, lbe}, out, stream);
}

extern "C" int la_exp_factored_f32(
    const float* fx, const float* fy, const int* lx, const int* ly,
    int batch, int max_lx, int max_ly, int rank,
    float alpha, float beta, float bg, float be, float lbg, float lbe,
    float* out, cudaStream_t stream) {
  if (rank < 2 || rank > MAX_RANK) return (int)cudaErrorInvalidValue;
  return launch<false, true>(fx, fy, lx, ly, batch, max_lx, max_ly, rank,
                             Params{alpha, beta, bg, be, lbg, lbe}, out, stream);
}

extern "C" int la_exp_f32(
    const float* s0, const float* s1, const int* lx, const int* ly,
    int batch, int max_lx, int max_ly,
    float alpha, float beta, float bg, float be, float lbg, float lbe,
    float* out, cudaStream_t stream) {
  return launch<false, false>(s0, s1, lx, ly, batch, max_lx, max_ly, 0,
                              Params{alpha, beta, bg, be, lbg, lbe}, out, stream);
}

extern "C" int la_log_f32(
    const float* s0, const float* s1, const int* lx, const int* ly,
    int batch, int max_lx, int max_ly,
    float alpha, float beta, float bg, float be, float lbg, float lbe,
    float* out, cudaStream_t stream) {
  return launch<true, false>(s0, s1, lx, ly, batch, max_lx, max_ly, 0,
                             Params{alpha, beta, bg, be, lbg, lbe}, out, stream);
}

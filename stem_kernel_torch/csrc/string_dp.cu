// Gap-weighted string kernel DP on Hopper (sm_90a), full f32: one launch a
// call, every pair of the call in it.
//
// Replaces no Pallas kernel.  The JAX package computes this kernel as a
// lax.scan over rows with associative scans inside
// (stem_kernel_tpu/models/string_kernel.py:116), which XLA compiles into one
// program on the TPU.  The port's plain version (models/string_kernel.py,
// gap_weighted_string_kernel_reference) is a Python loop of about nine
// launches a row; on the stem_kernel_lite train Gram that loop held most of
// a job's host time while the card idled.  This kernel runs the whole DP of
// every pair of a call in one launch.
//
// The recursion (stem_kernel/stem_kernel_lite/string_kernel.cpp:66-132), per
// pair, for each row i < Lx, over the columns j < Ly:
//
//   v[j]     = G0[j] * s[i][j]         (G0 as the row found it)
//   K1[j]    = v[j] + K1[j-1]           (a prefix sum)
//   G1[j]    = v[j] + gap*G1[j-1]       (an affine scan)
//   K0[j+1] += K1[j];   G0[j+1] = G1[j] + gap*G0[j+1];   G0[0] *= gap
//
// from K0 = 1 and G0[j] = gap^j; the value is K0[Ly].  The score source is a
// template parameter.  Profiles builds s[i][j] in the kernel from the pair's
// profiles (B, L, 4), the 4 x 4 substitution table and the position weights,
// as StringKernel does: sum_ab subst[a][b] px[i][a] py[j][b] / sum_ab
// px[i][a] py[j][b], 1 where that normaliser is 0, times wx[i] wy[j], 0
// outside either length; no (B, Lx, Ly) tensor is made.  Scores reads a
// given (B, Lx, Ly) score tensor, zero-masked by its caller (the
// string_kernel CLI's exact-match scores).
//
// What bounds it on the card: neither bytes nor operations (a few FLOPs a
// cell; a stem_kernel_lite train job of 20,100 pairs of ~120 x 120 is some
// 290 M cells) but latency.  A pair is a chain of Lx dependent rows, a row a
// chain of ceil(Ly / 32) dependent column chunks, a chunk about a dozen warp
// shuffles deep.  Before this kernel the bound was the host: the row loop's
// launches.  What the design does about it: one warp a pair, all pairs of a
// call in one launch (the Gram's 256 pairs put about two warps on each of
// the 132 SMs, so every pair's chain runs at once); the row loop and the
// chunk walk run inside the kernel; lane l owns the columns l, l + 32, ...
// of the row state K0[1..Ly], G0[1..Ly], kept in shared memory (8 bytes a
// column, so no register array has to be sized by Ly), and reads no other
// lane's slot.  The two column recurrences are 5-step shuffle scans, the
// affine one with the constant weights gap, gap^2, gap^4, gap^8, gap^16,
// and each scan's sum is carried from one chunk to the next (K1 by adding
// it, G1 by gap^(l+1) times it).  Every power of gap is at most 1 for
// gap <= 1, so no step overflows at any length, as with the Toeplitz
// product of the plain version.  A step's operands (the score, or the
// profile row and column) are loaded, and its score built, one step ahead of
// their use, off the chain of shuffles.
//
// Limits: Ly <= MAX_LY = 29,056 columns (8 bytes a column of one block's
// 232,448 bytes of shared memory; past 6,144 columns the launch opts in to
// more than 48 KB).  Lx has no limit.
//
// A pair's value depends on its own operands only: never on its batch or
// its position in it, and in the profile mode, which walks only the pair's
// own lx rows and ly columns, not on the padded widths either.  Full f32:
// FMA where the plain version multiplies and adds, IEEE division, no
// fast-math, no TF32.
//
// C interface: each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_LY = 29056;  // 8 * MAX_LY bytes of shared memory <= 232,448
constexpr size_t DEFAULT_SMEM = 48 * 1024;

// s[i][j] read from a (B, Lx, Ly) tensor
struct Scores {
  const float* s;
  int max_lx, max_ly;

  struct Op {
    float s;
  };

  __device__ __forceinline__ Op load(int b, int i, int c, bool in) const {
    Op op{0.f};
    if (in) op.s = s[((size_t)b * max_lx + i) * max_ly + c];
    return op;
  }

  __device__ __forceinline__ float score(const Op& op, const float (&)[16]) const { return op.s; }
};

// s[i][j] built from the profiles, the table and the weights
struct Profiles {
  const float *px, *py, *wx, *wy;
  int max_lx, max_ly;

  struct Op {
    float x[4], wx, y[4], wy;
  };

  __device__ __forceinline__ Op load(int b, int i, int c, bool in) const {
    Op op{};
    const size_t row = (size_t)b * max_lx + i;
#pragma unroll
    for (int a = 0; a < 4; ++a) op.x[a] = px[row * 4 + a];
    op.wx = wx[row];
    if (in) {
      const size_t col = (size_t)b * max_ly + c;
#pragma unroll
      for (int a = 0; a < 4; ++a) op.y[a] = py[col * 4 + a];
      op.wy = wy[col];
    }
    return op;
  }

  // sum_b (sum_a x[a] sub[a][b]) y[b] / ((sum x)(sum y)), 1 where the
  // normaliser is 0, times wx wy
  __device__ __forceinline__ float score(const Op& op, const float (&sub)[16]) const {
    float num = 0.f;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      float q = op.x[0] * sub[bb];
#pragma unroll
      for (int a = 1; a < 4; ++a) q = fmaf(op.x[a], sub[a * 4 + bb], q);
      num = fmaf(q, op.y[bb], num);
    }
    const float den = (((op.x[0] + op.x[1]) + op.x[2]) + op.x[3])
                      * (((op.y[0] + op.y[1]) + op.y[2]) + op.y[3]);
    const float s = den == 0.f ? 1.f : num / den;
    return s * (op.wx * op.wy);
  }
};

// One warp a pair (blockIdx.x).  lx, ly null: the whole (max_lx, max_ly)
// block, as the Scores mode runs it.
template <class Src>
__global__ void __launch_bounds__(32) string_dp(Src src, const float* __restrict__ subst,
                                                const int* __restrict__ lx,
                                                const int* __restrict__ ly, int max_lx,
                                                int max_ly, float gap, float* __restrict__ out) {
  extern __shared__ float state[];  // K0[1..ny], then G0[1..ny]
  const int b = blockIdx.x, lane = threadIdx.x;
  int nx = max_lx, ny = max_ly;
  if (lx != nullptr) {
    nx = min(max(lx[b], 0), max_lx);
    ny = min(max(ly[b], 0), max_ly);
  }
  if (ny == 0) nx = 0;
  float* k0 = state;
  float* g0 = state + ny;
  float sub[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) sub[t] = subst != nullptr ? subst[t] : 0.f;
  // gap^(2^t), the affine scan's weight at shuffle distance 2^t, each
  // rounded once (squaring would double the error of every power it reuses)
  float pw[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) pw[t] = powf(gap, (float)(1 << t));
  const float carry_w = powf(gap, (float)(lane + 1));  // gap^(l+1): G1's carry at lane l
  for (int c = lane; c < ny; c += 32) {
    k0[c] = 1.f;
    g0[c] = powf(gap, (float)(c + 1));
  }
  float edge = 1.f;              // G0[0] as row i finds it: gap^i
  float kc = 0.f, gc = 0.f, gl = 0.f;  // K1, G1 and the old G0 at the chunk's last column
  typename Src::Op first{};
  if (nx > 0) first = src.load(b, 0, lane, lane < ny);
  float s = src.score(first, sub);  // the step's score, built a step ahead
  int i = 0, c0 = 0;
  while (i < nx) {
    int ni = i, nc0 = c0 + 32;  // the next step, whose operands load now
    if (nc0 >= ny) {
      nc0 = 0;
      ++ni;
    }
    typename Src::Op nxt{};
    if (ni < nx) nxt = src.load(b, ni, nc0 + lane, nc0 + lane < ny);
    if (c0 == 0) {
      kc = 0.f;
      gc = 0.f;
      gl = edge;
    }
    const int c = c0 + lane;
    const bool in = c < ny;
    const float kold = in ? k0[c] : 0.f;
    const float gold = in ? g0[c] : 0.f;
    float gprev = __shfl_up_sync(FULL, gold, 1);  // G0[c], the old value one column left
    if (lane == 0) gprev = gl;
    float k1 = in ? gprev * s : 0.f;  // v
    float g1 = k1;
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const int d = 1 << t;
      const float yk = __shfl_up_sync(FULL, k1, d);
      const float yg = __shfl_up_sync(FULL, g1, d);
      if (lane >= d) {
        k1 += yk;
        g1 = fmaf(pw[t], yg, g1);
      }
    }
    k1 += kc;
    g1 = fmaf(carry_w, gc, g1);
    if (in) {
      k0[c] = k1 + kold;
      g0[c] = fmaf(gap, gold, g1);
    }
    kc = __shfl_sync(FULL, k1, 31);
    gc = __shfl_sync(FULL, g1, 31);
    gl = __shfl_sync(FULL, gold, 31);
    if (nc0 == 0) edge *= gap;
    s = src.score(nxt, sub);
    i = ni;
    c0 = nc0;
  }
  __syncwarp();
  if (lane == 0) out[b] = ny > 0 ? k0[ny - 1] : 1.f;
}

template <class Src>
int launch(Src src, const float* subst, const int* lx, const int* ly, int batch, int max_lx,
           int max_ly, float gap, float* out, cudaStream_t stream) {
  if (batch < 0 || max_lx < 0 || max_ly < 0 || max_ly > MAX_LY)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const size_t smem = 2 * sizeof(float) * (size_t)(max_ly > 0 ? max_ly : 1);
  if (smem > DEFAULT_SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(
        string_dp<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  string_dp<Src><<<batch, 32, smem, stream>>>(src, subst, lx, ly, max_lx, max_ly, gap, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int string_dp_profile_f32(const float* px, const float* py, const float* subst,
                                     const float* wx, const float* wy, const int* lx,
                                     const int* ly, int batch, int max_lx, int max_ly,
                                     float gap, float* out, cudaStream_t stream) {
  return launch(Profiles{px, py, wx, wy, max_lx, max_ly}, subst, lx, ly, batch, max_lx,
                max_ly, gap, out, stream);
}

extern "C" int string_dp_scores_f32(const float* scores, int batch, int max_lx, int max_ly,
                                    float gap, float* out, cudaStream_t stream) {
  return launch(Scores{scores, max_lx, max_ly}, nullptr, nullptr, nullptr, batch, max_lx,
                max_ly, gap, out, stream);
}

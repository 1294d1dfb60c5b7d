// Stem-kernel closure fixed point on Hopper (sm_90a), full f32.
//
// Replaces the Pallas TPU kernel stem_kernel_tpu/ops/pallas_stem.py
// (stem_fixed_point, body _make_kernel).  Per pair b, starting from M = 0,
// repeat iters[b] times (capped at max_iters):
//
//     G = Vx (M Vy^T + L);      M = NS * (Ax G Ay^T)
//
// and return out[b] = ux^T M uy.  Shapes: Vx, Ax (B, Nx, Nx); Vy, Ay
// (B, Ny, Ny); NS, L, M, G (B, Nx, Ny); ux (B, Nx); uy (B, Ny); iters (B,)
// int32; all row-major and contiguous.  Nx and Ny differ for pairs across
// two node buckets of the Gram.
//
// What bounds it on the card: one iteration is four dependent N x N
// products, 8 N^3 FLOPs per pair, against six N x N operands.  The TPU
// kernel kept all six operands plus two scratch planes of a pair resident
// in VMEM (8 x 64 KB at N = 128), which is more than the 227 KB of shared
// memory one block may use, so that schedule does not carry over.  Here
// each iteration is four launches of a batched, shared-memory-tiled FFMA
// GEMM (grid: column tile, row tile, pair) with the epilogue fused: "+ L"
// after the first product and "* NS" after the last.  The operands are
// re-read from L2/HBM on every launch; at B = 256, N = 128 the six operand
// planes are 100 MB, about twice the 50 MB L2, so the loop is bound by the
// FFMA rate of the tiles and by those re-reads.  Transposed operands
// (Vy^T, Ay^T) are read through their strides, with no copies.  A pair
// whose trip count is spent returns at once from every later launch, which
// reproduces the per-pair scalar-prefetch trip counts of the TPU kernel.
// wgmma, TMA and thread-block clusters are for later versions.
//
// C interface: every entry point returns cudaGetLastError() after its last
// launch (or the first launch error), so the caller can raise.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 16;       // depth per shared-memory stage
constexpr int TPB = 256;     // threads per block: a 16 x 16 grid
constexpr int TM = BM / 16;  // rows per thread (strided by 16)
constexpr int TN = BN / 16;  // columns per thread (strided by 16)

enum Epilogue { kPlain = 0, kAddL = 1, kMulNS = 2 };

// C[b] = epi(A[b] @ op(B[b])) for one pair: A is (rows, depth), op(B) is
// (depth, cols), C and the epilogue operand E are (rows, cols), all
// row-major.  op(B)[k][j] = B[k][j], or B[j][k] (B stored (cols, depth))
// when B_TRANS.  With FIRST the product is skipped (A is the zero matrix of
// the first iteration), so C = E.
template <bool B_TRANS, int EPI, bool FIRST>
__global__ void __launch_bounds__(TPB)
fixed_point_gemm(const float* __restrict__ A, const float* __restrict__ B,
                 const float* __restrict__ E, float* __restrict__ C,
                 const int* __restrict__ iters, int k_iter,
                 int rows, int cols, int depth) {
  const int b = blockIdx.z;
  if (iters[b] <= k_iter) return;  // this pair's fixed point is done

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const size_t c_plane = (size_t)rows * cols;
  const float* a = A + b * (size_t)rows * depth;
  const float* bm = B + b * (size_t)depth * cols;
  float* c = C + b * c_plane;

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int s = 0; s < TN; ++s) acc[r][s] = 0.f;

  if (!FIRST) {
    __shared__ float As[BK][BM + 1];
    __shared__ float Bs[BK][BN + 1];
    for (int k0 = 0; k0 < depth; k0 += BK) {
      // A tile (BM x BK): consecutive threads walk k, the contiguous axis.
#pragma unroll
      for (int q = 0; q < (BM * BK) / TPB; ++q) {
        const int lin = threadIdx.x + q * TPB;
        const int m = lin / BK, kk = lin % BK;
        const int gi = i0 + m, gk = k0 + kk;
        As[kk][m] = (gi < rows && gk < depth) ? a[(size_t)gi * depth + gk] : 0.f;
      }
      // B tile (BK x BN), read along whichever axis is contiguous.
#pragma unroll
      for (int q = 0; q < (BK * BN) / TPB; ++q) {
        const int lin = threadIdx.x + q * TPB;
        if (B_TRANS) {
          const int jj = lin / BK, kk = lin % BK;
          const int gj = j0 + jj, gk = k0 + kk;
          Bs[kk][jj] = (gj < cols && gk < depth) ? bm[(size_t)gj * depth + gk] : 0.f;
        } else {
          const int kk = lin / BN, jj = lin % BN;
          const int gj = j0 + jj, gk = k0 + kk;
          Bs[kk][jj] = (gj < cols && gk < depth) ? bm[(size_t)gk * cols + gj] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[TM], bv[TN];
#pragma unroll
        for (int r = 0; r < TM; ++r) av[r] = As[kk][ty + 16 * r];
#pragma unroll
        for (int s = 0; s < TN; ++s) bv[s] = Bs[kk][tx + 16 * s];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int s = 0; s < TN; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gi = i0 + ty + 16 * r;
    if (gi >= rows) continue;
#pragma unroll
    for (int s = 0; s < TN; ++s) {
      const int gj = j0 + tx + 16 * s;
      if (gj >= cols) continue;
      const size_t idx = (size_t)gi * cols + gj;
      float v = acc[r][s];
      if (EPI == kAddL) v += E[b * c_plane + idx];
      if (EPI == kMulNS) v *= E[b * c_plane + idx];
      c[idx] = v;
    }
  }
}

// out[b] = sum_i ux[b,i] sum_j M[b,i,j] uy[b,j] with M (nx, ny); 0 for a
// pair with no iterations (its M is the zero matrix, never written).  One
// block a pair.
__global__ void __launch_bounds__(TPB)
bilinear_form(const float* __restrict__ M, const float* __restrict__ ux,
              const float* __restrict__ uy, const int* __restrict__ iters,
              float* __restrict__ out, int nx, int ny) {
  const int b = blockIdx.x;
  __shared__ float partial[TPB / 32];
  float acc = 0.f;
  if (iters[b] > 0) {
    const float* m = M + (size_t)b * nx * ny;
    const float* u = ux + (size_t)b * nx;
    const float* w = uy + (size_t)b * ny;
    const int total = nx * ny;
    for (int lin = threadIdx.x; lin < total; lin += TPB) {
      const int i = lin / ny, j = lin % ny;
      acc = fmaf(u[i] * m[lin], w[j], acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < TPB / 32 ? partial[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (threadIdx.x == 0) out[b] = v;
  }
}

}  // namespace

extern "C" int stem_fixed_point_f32(
    const float* ns, const float* vx, const float* vy, const float* ax,
    const float* ay, const float* l, const float* ux, const float* uy,
    const int* iters, int batch, int nx, int ny, int max_iters,
    float* m, float* g1, float* g2, float* out, cudaStream_t stream) {
  const dim3 grid((ny + BN - 1) / BN, (nx + BM - 1) / BM, batch);
  const dim3 block(TPB);
  cudaError_t err;
  for (int k = 0; k < max_iters; ++k) {
    // G1 = M Vy^T + L  (M = 0 on the first iteration: G1 = L)
    if (k == 0)
      fixed_point_gemm<true, kAddL, true><<<grid, block, 0, stream>>>(
          m, vy, l, g1, iters, k, nx, ny, ny);
    else
      fixed_point_gemm<true, kAddL, false><<<grid, block, 0, stream>>>(
          m, vy, l, g1, iters, k, nx, ny, ny);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // G2 = Vx G1
    fixed_point_gemm<false, kPlain, false><<<grid, block, 0, stream>>>(
        vx, g1, nullptr, g2, iters, k, nx, ny, nx);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // G1 = G2 Ay^T
    fixed_point_gemm<true, kPlain, false><<<grid, block, 0, stream>>>(
        g2, ay, nullptr, g1, iters, k, nx, ny, ny);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // M = NS * (Ax G1)
    fixed_point_gemm<false, kMulNS, false><<<grid, block, 0, stream>>>(
        ax, g1, ns, m, iters, k, nx, ny, nx);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  bilinear_form<<<batch, TPB, 0, stream>>>(m, ux, uy, iters, out, nx, ny);
  return (int)cudaGetLastError();
}

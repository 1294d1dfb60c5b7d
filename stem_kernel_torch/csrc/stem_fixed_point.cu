// Stem-kernel closure fixed point on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel stem_kernel_tpu/ops/pallas_stem.py
// (stem_fixed_point, body _make_kernel).  Per pair b, starting from M = 0,
// repeat iters[b] times (the caller caps it at max_iters):
//
//     G = Vx (M Vy^T + L);      M = NS * (Ax G Ay^T)
//
// and return out[b] = ux^T M uy.  Shapes: Vx, Ax (B, Nx, Nx); Vy, Ay
// (B, Ny, Ny); NS, L, M, G (B, Nx, Ny); ux (B, Nx); uy (B, Ny); iters (B,)
// int32; all row-major and contiguous.  Nx and Ny differ for pairs across
// two node buckets of the Gram.
//
// What bounds it on the card: one iteration is four dependent N x N
// products against six N x N operands of the pair, 8 N^3 operations at
// Nx = Ny = N.  At B = 256, N = 128 and 20-51 trips a pair that is 165
// GFLOP: 2.46 ms on the f32 units (67 TFLOP/s), 1.00 ms as three TF32
// passes (495 TFLOP/s) and 0.17 ms as one bf16 pass (989 TFLOP/s), against
// 0.03 ms to read the 100 MB of operands once.  So the kernel is bound by
// operations, provided the operands are read once and not once a product.
//
// Route 1, stem_fixed_point_cluster: one launch for the whole fixed point
// and the bilinear form, for max(Nx, Ny) <= 64 (Nx, Ny multiples of 16),
// one CTA a pair.  (Past 64 nodes a pair's planes outgrow one CTA's shared
// memory, and clusters of 4 or 16 CTAs a pair lost to route 2 at every such
// shape of the stem Gram, PERF.md.)  The CTA holds NS, L, M, Vx, Ax, Vy, Ay
// in shared memory for the whole fixed point, plus two transposed planes
// G1^T, G3^T (Ny x Nx): up to 166 KB, the operands read from device memory
// once.  Each product is a plane A times a plane B^T, both K-contiguous:
//
//   P1  G1^T <- (M Vy^T + L)^T    A = M,  B = Vy,   K = Ny
//   P2  M    <- Vx G1             A = Vx, B = G1^T, K = Nx
//   P3  G3^T <- (M Ay^T)^T        A = M,  B = Ay,   K = Ny
//   P4  M    <- NS * (Ax G3)      A = Ax, B = G3^T, K = Nx
//
// Each intermediate is written in the layout its next product reads, so no
// product reads through a stride; G2 lives in M's plane (M is dead between
// P1 and P4).  A __syncthreads follows each product.  The first iteration
// skips P1 (M = 0, so G1 = L).  A CTA reads its pair's trip count; a pair
// with 0 trips writes 0 and its CTA leaves at once, freeing its SM for the
// next pair.  The bilinear form is fused: the warps' partials are added in
// warp order (deterministic).
//
// What holds it back (PERF.md): the tensor-core modes split or convert
// every fragment element where it is loaded, and all 8 warps of a CTA load
// the same A rows, so the conversions' integer and float work, more than
// mma.sync, looks to set the pace (development builds on the card).
//
// The product mode is a template parameter, chosen by the wrapper from the
// precision name (stem_kernel_torch/ops/stem_fixed_point.py, MODES), on
// both routes:
//
//   kF32     ("highest"): f32 FFMA from shared memory.
//   kTF32x3  ("high"): 3xTF32 on mma.sync.m16n8k8.tf32: x = hi + lo, both
//            rounded to nearest, ties away from zero, as cvt.rna.tf32.f32
//            rounds (unrounded f32 bits would be truncated), acc += lo*hi;
//            acc += hi*lo; acc += hi*hi.
//   kBF16    ("default"): mma.sync.m16n8k16.bf16 on operands rounded to
//            nearest even, f32 accumulation: the JAX kernel's dot_bf.
//
// In route 1 the planes stay f32 in shared memory and are converted as
// fragments are loaded.  Rows are padded by 4 floats (8 for bf16, whose
// fragments load float2) so that the fragment loads hit 32 distinct banks.
// 8 warps each own one or two 16 MT x 16 output tiles and issue mma.sync.
//
// Route 2, stem_fixed_point_strips: every other pair, at any node count
// (multiples of 16).  One launch for the whole fixed point and the bilinear
// form.  A pair's columns are cut into strips J of 64; a cluster of
// C = min(strips, 8) CTAs runs the pair, CTA r its strips r, r + C, ....
// Each trip is two half-trips, each a pair-wide barrier (cluster.sync) apart:
//
//   A  S = M Vy[J,:]^T + L[:, J]  (Nx x 64, kept in shared memory as S^T)
//      G2[:, J] = Vx S            (to device memory: every CTA reads all of G2)
//   B  S = G2 Ay[J,:]^T
//      M[:, J] = NS[:, J] * (Ax S)
//
// so G1 and G3 of the four-product form stay on the SM where the strip fits
// (below), and the first trip skips M Vy^T (M = 0).  A CTA computes a product in tiles of 128 rows x
// 64 columns, 8 warps of 32 x 32 (mma.sync; f32: 8 x 4 FFMA outputs a
// thread), and streams A (and B, where it is not the strip) from L2 in
// chunks of 32 through cp.async stages (two for 3xTF32, three otherwise).
// Each thread converts the pieces it copied once they land: 3xTF32 splits
// them into a hi plane (in place) and a lo plane, bf16 rounds them into a
// bf16 plane; fragments then load by ldmatrix with no further arithmetic.
// The strip is written converted the same way.  The epilogue operand
// (L or NS) is staged by cp.async before its product, and each output tile
// leaves through shared memory as whole rows.  Where the strip does not
// fit shared memory (Nx past 160 in 3xTF32, whose hi and lo planes take
// twice the room; past 432 in f32 and 512 in bf16) it spills to a
// (B, Ny, Nx) buffer in device memory and streams back like B.
//
// What bounds route 2: at 128 x 256 the products need 2.5 ms as three TF32
// passes and 0.43 ms in bf16 (B = 256, 20-50 trips), the operands' bytes
// under 0.1 ms, so it is bound by operations.  What holds it back (PERF.md;
// in-kernel clock counters in development builds on the card): mma.sync
// and its ldmatrix loads take about half of a CTA's time, waiting for and
// converting chunks about a quarter, the epilogues and the cluster
// barriers the rest.  Each CTA streams the whole of M (or G2) and Vx (or Ax)
// from L2 every half-trip, C times a pair, and with 220-240 registers a
// thread an SM holds one CTA, 8 warps.  Multicasting those tiles across
// the cluster (TMA) is the next step.  wgmma (m64n64 a warpgroup, from the
// same staged tiles) gave the same values in development builds on the
// card but did not win: on unswizzled core-matrix tiles slower in every
// mode, on 128-byte-swizzled ones faster at 128 x 128 and 256 x 256 under
// "high" and slower at 128 x 256 and in f32.  Its chunks of 32 k leave
// each wgmma batch short; longer chunks want the shared memory the strip
// holds.
//
// C interface: every entry point returns cudaGetLastError() after its last
// launch (or the first error), so the caller can raise.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// ===================================================================
// Route 1: one launch, each pair resident in one CTA (max(Nx, Ny) <= 64)
// ===================================================================

enum Mode { kF32 = 0, kTF32x3 = 1, kBF16 = 2 };
enum Store { kG1T = 0, kG2 = 1, kG3T = 2, kM = 3 };

constexpr int CTHREADS = 256;
constexpr int CWARPS = CTHREADS / 32;
constexpr int MAX_CLUSTER_N = 64;  // the largest max(Nx, Ny) of route 1
constexpr int TPW = 2;             // warp tiles a warp holds at most

__host__ __device__ constexpr int pad_of(int mode) { return mode == kBF16 ? 8 : 4; }

// offsets (floats) of a CTA's planes in dynamic shared memory
struct Layout {
  int ldx, ldv, ldt;  // row strides: (Nx, Ny) and (Ny, Ny) planes, (Nx, Nx), (Ny, Nx)
  int ns, l, m, vx, ax, vy, ay, g1t, g3t, part, total;
};

__host__ __device__ inline Layout layout_of(int nx, int ny, int pad) {
  Layout s;
  s.ldx = ny + pad;
  s.ldv = nx + pad;
  s.ldt = nx + pad;
  int o = 0;
  s.ns = o;  o += nx * s.ldx;
  s.l = o;   o += nx * s.ldx;
  s.m = o;   o += nx * s.ldx;  // M, and G2 between P2 and P3
  s.vx = o;  o += nx * s.ldv;
  s.ax = o;  o += nx * s.ldv;
  s.vy = o;  o += ny * s.ldx;
  s.ay = o;  o += ny * s.ldx;
  s.g1t = o; o += ny * s.ldt;
  s.g3t = o; o += ny * s.ldt;
  s.part = o; o += 16;  // CWARPS warp partials
  s.total = o;
  return s;
}

// the warp tile's m16 count: two m16 rows a tile (16 MT x 16) where that
// still gives every warp one
inline int mt_of(int nx, int ny) {
  const int q = nx / 16;
  return q % 2 == 0 && (q / 2) * (ny / 16) >= CWARPS ? 2 : 1;
}

struct ClusterParams {
  const float *ns, *vx, *vy, *ax, *ay, *l, *ux, *uy;
  const int* iters;
  float* out;
  int nx, ny;
};

// what a CTA needs to run a product: its planes and shape
struct Ctx {
  float* sm;
  Layout s;
  int nx, ny;
};

template <int STORE>
__device__ __forceinline__ void store(const Ctx& c, int i, int j, float v) {
  float* sm = c.sm;
  if (STORE == kG1T) sm[c.s.g1t + j * c.s.ldt + i] = v + sm[c.s.l + i * c.s.ldx + j];
  if (STORE == kG2) sm[c.s.m + i * c.s.ldx + j] = v;
  if (STORE == kG3T) sm[c.s.g3t + j * c.s.ldt + i] = v;
  if (STORE == kM) sm[c.s.m + i * c.s.ldx + j] = sm[c.s.ns + i * c.s.ldx + j] * v;
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the bits of cvt.rna.tf32.f32 (unrounded f32 bits would be truncated
// by the tensor cores), in three integer operations and a select, fewer
// than the instruction sequence cvt.rna compiles to; inf and nan pass through
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x7f800000u) == 0x7f800000u ? u : (u + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi, lo TF32 (rounded to nearest, ties away from zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);  // .x (the lower k) in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A[0:16 MT, 0:klen] B^T for one warp: a is the tile's first row at
// the range's first column (row stride lda), brow[nt] the row of B (n =
// 8 nt + lane / 4 of the tile) at the range's first k.  klen % 16 == 0.
template <int MODE, int MT>
__device__ __forceinline__ void mma_range(float (&acc)[MT][2][4], const float* a, int lda,
                                          const float* const (&brow)[2], int klen, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if (MODE == kBF16) {
#pragma unroll 2
    for (int k = 0; k < klen; k += 16) {
      uint32_t af[MT][4], bf[2][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* p = a + (16 * mt + g) * lda + k + 2 * t;
        af[mt][0] = pack_bf16(*reinterpret_cast<const float2*>(p));
        af[mt][1] = pack_bf16(*reinterpret_cast<const float2*>(p + 8 * lda));
        af[mt][2] = pack_bf16(*reinterpret_cast<const float2*>(p + 8));
        af[mt][3] = pack_bf16(*reinterpret_cast<const float2*>(p + 8 * lda + 8));
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* q = brow[nt] + k + 2 * t;
        bf[nt][0] = pack_bf16(*reinterpret_cast<const float2*>(q));
        bf[nt][1] = pack_bf16(*reinterpret_cast<const float2*>(q + 8));
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
    }
  } else {
#pragma unroll 2
    for (int k = 0; k < klen; k += 8) {
      uint32_t ah[MT][4], al[MT][4], bh[2][2], bl[2][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* p = a + (16 * mt + g) * lda + k + t;
        split_tf32(p[0], ah[mt][0], al[mt][0]);
        split_tf32(p[8 * lda], ah[mt][1], al[mt][1]);
        split_tf32(p[4], ah[mt][2], al[mt][2]);
        split_tf32(p[8 * lda + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* q = brow[nt] + k + t;
        split_tf32(q[0], bh[nt][0], bl[nt][0]);
        split_tf32(q[4], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_tf32(acc[mt][nt], al[mt], bh[nt]);
          mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
          mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
        }
    }
  }
}

// acc[v][u] += sum_k A[v-th row][k] B[u-th row][k] over k < klen, f32 FFMA in k order
__device__ __forceinline__ void ffma_range(float (&acc)[4][4], const float* a, int astep,
                                           const float* const (&brow)[4], int klen) {
#pragma unroll 2
  for (int k = 0; k < klen; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) av[v] = *reinterpret_cast<const float4*>(a + v * astep + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) bv[u] = *reinterpret_cast<const float4*>(brow[u] + k);
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float s = acc[v][u];
        s = fmaf(av[v].x, bv[u].x, s);
        s = fmaf(av[v].y, bv[u].y, s);
        s = fmaf(av[v].z, bv[u].z, s);
        s = fmaf(av[v].w, bv[u].w, s);
        acc[v][u] = s;
      }
  }
}

// One product out(Nx, Ny) = A(Nx, K) B^T of the fixed point: A and B
// (Ny, K) are planes at offsets a_off, b_off (row strides lda, ldb).
// Tensor cores: warp w owns warp tiles w, w + 8 (16 MT x 16 outputs).  f32:
// thread t owns rows tr + (Nx/4) v and columns tc + (Ny/4) u, v, u < 4
// (strided, so that the lanes of a warp read consecutive B rows and one
// broadcast A row).
template <int MODE, int MT, int STORE>
__device__ void product(const Ctx& c, int a_off, int lda, int K, int b_off, int ldb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* bm = c.sm + b_off;
  const int rgs = c.nx / (16 * MT), tiles = rgs * (c.ny / 16);
  const int rq = c.nx / 4, cq = c.ny / 4;
  float acc[TPW][MT][2][4];
  float facc[4][4];
#pragma unroll
  for (int w = 0; w < TPW; ++w)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[w][mt][nt][e] = 0.f;
#pragma unroll
  for (int v = 0; v < 4; ++v)
#pragma unroll
    for (int u = 0; u < 4; ++u) facc[v][u] = 0.f;

  if (MODE == kF32) {
    if ((int)threadIdx.x < rq * cq) {
      const int tr = threadIdx.x / cq, tc = threadIdx.x - tr * cq;
      const float* brow[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) brow[u] = bm + (tc + cq * u) * ldb;
      ffma_range(facc, c.sm + a_off + tr * lda, rq * lda, brow, K);
    }
  } else {
#pragma unroll
    for (int w = 0; w < TPW; ++w) {
      const int tile = warp + w * CWARPS;
      if (tile < tiles) {
        const int m0 = (tile % rgs) * 16 * MT, n0 = (tile / rgs) * 16;
        const float* brow[2] = {bm + (n0 + g) * ldb, bm + (n0 + 8 + g) * ldb};
        mma_range<MODE, MT>(acc[w], c.sm + a_off + m0 * lda, lda, brow, K, lane);
      }
    }
  }

  if (MODE == kF32) {
    if ((int)threadIdx.x < rq * cq) {
      const int tr = threadIdx.x / cq, tc = threadIdx.x - tr * cq;
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int u = 0; u < 4; ++u) store<STORE>(c, tr + rq * v, tc + cq * u, facc[v][u]);
    }
  } else {
#pragma unroll
    for (int w = 0; w < TPW; ++w) {
      const int tile = warp + w * CWARPS;
      if (tile < tiles) {
        const int m0 = (tile % rgs) * 16 * MT, n0 = (tile / rgs) * 16;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              store<STORE>(c, m0 + 16 * mt + g + (e >> 1) * 8, n0 + 8 * nt + 2 * t + (e & 1),
                           acc[w][mt][nt][e]);
      }
    }
  }
}

// rows [row0, row0 + rows) and columns [col0, col0 + cols) of a
// (total_r, total_c) row-major plane into shared memory (row stride ld);
// what lies past the plane is zero.  cols, col0 and total_c are multiples of 4.
__device__ void load_block(float* dst, int ld, const float* src, int row0, int rows, int total_r,
                           int col0, int cols, int total_c) {
  const int c4 = cols / 4;
  for (int q = threadIdx.x; q < rows * c4; q += CTHREADS) {
    const int r = q / c4, col = (q - r * c4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < total_r && col0 + col < total_c)
      v = __ldg(reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * total_c + col0 + col));
    *reinterpret_cast<float4*>(dst + r * ld + col) = v;
  }
}

template <int MODE, int MT>
__global__ void __launch_bounds__(CTHREADS, 1) fixed_point_cluster(ClusterParams p) {
  extern __shared__ __align__(16) float sm[];
  const Ctx c{sm, layout_of(p.nx, p.ny, pad_of(MODE)), p.nx, p.ny};
  const int b = blockIdx.x;
  const int trips = p.iters[b];
  if (trips <= 0) {  // M = 0
    if (threadIdx.x == 0) p.out[b] = 0.f;
    return;
  }
  const Layout& s = c.s;
  const int nx = p.nx, ny = p.ny;
  const size_t pxy = (size_t)b * nx * ny, pxx = (size_t)b * nx * nx, pyy = (size_t)b * ny * ny;
  load_block(sm + s.ns, s.ldx, p.ns + pxy, 0, nx, nx, 0, ny, ny);
  load_block(sm + s.l, s.ldx, p.l + pxy, 0, nx, nx, 0, ny, ny);
  load_block(sm + s.vx, s.ldv, p.vx + pxx, 0, nx, nx, 0, nx, nx);
  load_block(sm + s.ax, s.ldv, p.ax + pxx, 0, nx, nx, 0, nx, nx);
  load_block(sm + s.vy, s.ldx, p.vy + pyy, 0, ny, ny, 0, ny, ny);
  load_block(sm + s.ay, s.ldx, p.ay + pyy, 0, ny, ny, 0, ny, ny);
  __syncthreads();  // every plane loaded

  for (int it = 0; it < trips; ++it) {
    if (it == 0) {  // M = 0: G1 = L
      for (int q = threadIdx.x; q < nx * ny; q += CTHREADS) {
        const int i = q / ny, j = q - i * ny;
        sm[s.g1t + j * s.ldt + i] = sm[s.l + i * s.ldx + j];
      }
    } else {
      product<MODE, MT, kG1T>(c, s.m, s.ldx, ny, s.vy, s.ldx);
    }
    __syncthreads();  // G1^T complete
    product<MODE, MT, kG2>(c, s.vx, s.ldv, nx, s.g1t, s.ldt);
    __syncthreads();  // G2 complete
    product<MODE, MT, kG3T>(c, s.m, s.ldx, ny, s.ay, s.ldx);
    __syncthreads();  // G3^T complete
    product<MODE, MT, kM>(c, s.ax, s.ldv, nx, s.g3t, s.ldt);
    __syncthreads();  // M complete
  }

  // ux^T M uy: each warp takes rows w, w + 8, ...; thread 0 adds the warps'
  // partials in warp order
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float v = 0.f;
  for (int i = warp; i < nx; i += CWARPS) {
    float r = 0.f;
    for (int j = lane; j < ny; j += 32)
      r = fmaf(sm[s.m + i * s.ldx + j], p.uy[(size_t)b * ny + j], r);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
    v = fmaf(p.ux[(size_t)b * nx + i], r, v);
  }
  if (lane == 0) sm[s.part + warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < CWARPS; ++w) total += sm[s.part + w];
    p.out[b] = total;
  }
}

// Sets the kernel's attributes and launches it, one CTA a pair; with
// `info` it writes [dynamic shared memory bytes a CTA, pairs that can be
// active at once] there instead.
template <int MODE, int MT>
int launch_cluster(const ClusterParams& p, int batch, cudaStream_t stream, int* info) {
  void (*kern)(ClusterParams) = fixed_point_cluster<MODE, MT>;
  const size_t smem = layout_of(p.nx, p.ny, pad_of(MODE)).total * sizeof(float);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  if (info != nullptr) {
    int per_sm = 0, dev = 0, sms = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, CTHREADS, smem)) !=
            cudaSuccess ||
        (err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    info[0] = (int)smem;
    info[1] = per_sm * sms;
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch);
  cfg.blockDim = dim3(CTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if ((err = cudaLaunchKernelEx(&cfg, kern, p)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_mode(const ClusterParams& p, int batch, cudaStream_t stream, int* info) {
  if constexpr (MODE == kF32) {
    return launch_cluster<MODE, 1>(p, batch, stream, info);  // the FFMA tiles take no m16 count
  } else {
    if (mt_of(p.nx, p.ny) == 2) return launch_cluster<MODE, 2>(p, batch, stream, info);
    return launch_cluster<MODE, 1>(p, batch, stream, info);
  }
}

int dispatch(const ClusterParams& p, int mode, int batch, cudaStream_t stream, int* info) {
  if (mode == kF32) return launch_mode<kF32>(p, batch, stream, info);
  if (mode == kTF32x3) return launch_mode<kTF32x3>(p, batch, stream, info);
  return launch_mode<kBF16>(p, batch, stream, info);
}

bool valid_shape(int nx, int ny, int mode) {
  return nx >= 16 && ny >= 16 && nx % 16 == 0 && ny % 16 == 0 && nx <= MAX_CLUSTER_N &&
         ny <= MAX_CLUSTER_N && mode >= kF32 && mode <= kBF16;
}

// ===================================================================
// Route 2: a pair's column strips on a cluster, one launch (the rest)
// ===================================================================

constexpr int SBM = 128;           // rows of a CTA's product tile
constexpr int SBN = 64;            // columns of a strip
constexpr int SBK = 32;            // depth of a staged chunk
constexpr int STHREADS = 256;      // 8 warps: 4 along the rows x 2 along the columns
constexpr int SWARPS = STHREADS / 32;
constexpr int MAX_STRIP_CTAS = 8;  // CTAs a pair at most: the portable cluster size
constexpr int MAX_SMEM = 232448;   // dynamic shared memory a CTA can opt into

// chunks staged at once, one multiplied and the rest landing: 3xTF32's
// second plane leaves room for two
__host__ __device__ constexpr int stages_of(int mode) { return mode == kTF32x3 ? 2 : 3; }

// A CTA's buffers in dynamic shared memory, offsets in floats.  A chunk is
// staged as f32 (cp.async) and converted once, in place, by the thread that
// copied it: 3xTF32 overwrites it with its hi part and writes the lo part
// to a second plane; bf16 writes a bf16 plane.  The strip S^T holds what the
// next product reads: f32, hi and lo planes, or bf16.  Rows are padded (4
// floats, 8 bf16) so that fragment loads hit distinct banks.
struct StripLayout {
  int ldk;  // row stride (floats) of an f32 / hi / lo stage: SBK + 4
  int ldh;  // row stride (bf16) of a bf16 stage: SBK + 8
  int ldt;  // row stride of the strip: floats nx + 4, or bf16 nx + 8
  int lde;  // row stride (floats) of the epilogue tile: SBN + 4
  int a, b, alo, blo, ah, bh;  // stages: f32 or hi, lo (3xTF32), bf16 (bf16)
  int st, stlo;                // the strip: f32, bf16 or hi, and lo (3xTF32)
  int e, part, total;          // the epilogue tile, the bilinear partials
};

__host__ __device__ inline StripLayout strip_layout(int nx, int mode, bool spill) {
  StripLayout s;
  s.ldk = SBK + 4;
  s.ldh = SBK + 8;
  s.ldt = mode == kBF16 ? nx + 8 : nx + 4;
  s.lde = SBN + 4;
  const bool tf = mode == kTF32x3, bf = mode == kBF16;
  const int NSTAGE = stages_of(mode);
  int o = 0;
  s.a = o;   o += NSTAGE * SBM * s.ldk;
  s.b = o;   o += NSTAGE * SBN * s.ldk;
  s.alo = o; o += tf ? NSTAGE * SBM * s.ldk : 0;
  s.blo = o; o += tf ? NSTAGE * SBN * s.ldk : 0;
  s.ah = o;  o += bf ? NSTAGE * SBM * s.ldh / 2 : 0;
  s.bh = o;  o += bf ? NSTAGE * SBN * s.ldh / 2 : 0;
  const int plane = bf ? SBN * s.ldt / 2 : SBN * s.ldt;
  s.st = o;   o += spill ? 0 : plane;
  s.stlo = o; o += spill || !tf ? 0 : plane;
  s.e = o;    o += SBM * s.lde;
  s.part = o; o += 16;  // SWARPS warp partials, then the CTA's partial at [SWARPS]
  s.total = o;
  return s;
}

struct StripParams {
  const float *ns, *vx, *vy, *ax, *ay, *l, *ux, *uy;
  const int* iters;
  float *m, *g2, *st, *out;
  int nx, ny, csize, nstrips;
};

// 16 bytes global -> shared, through L2 only (.cg: a peer's writes of this
// launch are never read from a stale L1 line); zero-filled when !full
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 matrices of 16-bit pairs from shared memory: lane l gives the
// address of row l % 8 of matrix l / 8, and gets word l % 4 of row l / 4 of
// each matrix
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// rows [r0, r0 + ROWS) and columns [k0, k0 + COLS) of a row-major plane
// (row stride ld) into shared memory (row stride lds); rows at or past
// rlim and columns at or past klim are zero.  Thread t copies the 16-byte
// pieces t, t + STHREADS, ...
template <int ROWS, int COLS>
__device__ __forceinline__ void stage(float* dst, int lds, const float* src, int ld, int r0,
                                      int rlim, int k0, int klim) {
  constexpr int PER_ROW = COLS / 4;
#pragma unroll
  for (int i = 0; i < ROWS * PER_ROW / STHREADS; ++i) {
    const int q = threadIdx.x + i * STHREADS;
    const int r = q / PER_ROW, c = (q % PER_ROW) * 4;
    const bool ok = r0 + r < rlim && k0 + c < klim;
    cp_async16(dst + r * lds + c, ok ? src + (size_t)(r0 + r) * ld + k0 + c : src, ok);
  }
}

// The pieces this thread staged with stage<ROWS, SBK> at f32 offset `raw`,
// converted for MODE: 3xTF32 writes hi over them and lo at `lo`; bf16
// writes them rounded at bf16 offset `h` (row stride s.ldh).
template <int MODE, int ROWS>
__device__ __forceinline__ void convert(float* sm, const StripLayout& s, int raw, int lo, int h) {
  constexpr int PER_ROW = SBK / 4;
#pragma unroll
  for (int i = 0; i < ROWS * PER_ROW / STHREADS; ++i) {
    const int q = threadIdx.x + i * STHREADS;
    const int r = q / PER_ROW, c = (q % PER_ROW) * 4;
    float4* p = reinterpret_cast<float4*>(sm + raw + r * s.ldk + c);
    const float4 v = *p;
    if (MODE == kTF32x3) {
      uint4 hi, lw;
      split_tf32(v.x, hi.x, lw.x);
      split_tf32(v.y, hi.y, lw.y);
      split_tf32(v.z, hi.z, lw.z);
      split_tf32(v.w, hi.w, lw.w);
      *reinterpret_cast<uint4*>(p) = hi;
      *reinterpret_cast<uint4*>(sm + lo + r * s.ldk + c) = lw;
    } else if (MODE == kBF16) {
      uint2 w;
      w.x = pack_bf16(make_float2(v.x, v.y));
      w.y = pack_bf16(make_float2(v.z, v.w));
      *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(sm + h) + r * s.ldh + c) = w;
    }
  }
}

// acc[mt][nt] += A[16 mt + 0..15, 0:klen] B[8 nt + 0..7, 0:klen]^T for one
// warp's 32 x 32 tile, fragments by ldmatrix from converted planes: a (and
// al) at the tile's first row, b (and bl) at its first B row, k contiguous;
// row strides lda, ldb in 32-bit words (3xTF32) or bf16 elements (bf16).
// klen % 16 == 0.
template <int MODE>
__device__ __forceinline__ void warp_mma(float (&acc)[2][4][4], const void* a, const void* al,
                                         int lda, const void* b, const void* bl, int ldb,
                                         int klen, int lane) {
  const int ar = (lane & 7) + 8 * ((lane >> 3) & 1), ak = lane >> 4;  // A: matrix rows, k half
  const int bn = (lane & 7) + 8 * (lane >> 4), bk = (lane >> 3) & 1;  // B: matrix rows, k half
  if (MODE == kBF16) {
    const __nv_bfloat16* pa = static_cast<const __nv_bfloat16*>(a);
    const __nv_bfloat16* pb = static_cast<const __nv_bfloat16*>(b);
#pragma unroll 2
    for (int k = 0; k < klen; k += 16) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldsm_x4(af[mt], pa + (16 * mt + ar) * lda + k + 8 * ak);
#pragma unroll
      for (int np = 0; np < 2; ++np) ldsm_x4(bf[np], pb + (16 * np + bn) * ldb + k + 8 * bk);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t bb[2] = {bf[nt >> 1][2 * (nt & 1)], bf[nt >> 1][2 * (nt & 1) + 1]};
          mma_bf16(acc[mt][nt], af[mt], bb);
        }
    }
  } else {
    const uint32_t* pa = static_cast<const uint32_t*>(a);
    const uint32_t* pal = static_cast<const uint32_t*>(al);
    const uint32_t* pb = static_cast<const uint32_t*>(b);
    const uint32_t* pbl = static_cast<const uint32_t*>(bl);
#pragma unroll 2
    for (int k = 0; k < klen; k += 8) {
      uint32_t ah[2][4], alo[2][4], bh[2][4], blo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int off = (16 * mt + ar) * lda + k + 4 * ak;
        ldsm_x4(ah[mt], pa + off);
        ldsm_x4(alo[mt], pal + off);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int off = (16 * np + bn) * ldb + k + 4 * bk;
        ldsm_x4(bh[np], pb + off);
        ldsm_x4(blo[np], pbl + off);
      }
      // pass by pass over the 8 tiles: mma.sync is issued in program order,
      // so a tile's three dependent passes stand 8 products apart
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint32_t(&bs)[2][4] = pass == 1 ? blo : bh;
            const uint32_t b2[2] = {bs[nt >> 1][2 * (nt & 1)], bs[nt >> 1][2 * (nt & 1) + 1]};
            mma_tf32(acc[mt][nt], pass == 0 ? alo[mt] : ah[mt], b2);
          }
    }
  }
}

// f32: acc[v >> 2][v & 3][u] += sum_k A[16 v][k] B[16 u][k] over k < klen, FFMA in
// k order; a and b at the thread's first row of each (row strides lda, ldb)
__device__ __forceinline__ void thread_ffma(float (&acc)[2][4][4], const float* a, int lda,
                                            const float* b, int ldb, int klen) {
#pragma unroll 2
  for (int k = 0; k < klen; k += 4) {
    float4 av[8], bv[4];
#pragma unroll
    for (int v = 0; v < 8; ++v) av[v] = *reinterpret_cast<const float4*>(a + 16 * v * lda + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) bv[u] = *reinterpret_cast<const float4*>(b + 16 * u * ldb + k);
#pragma unroll
    for (int v = 0; v < 8; ++v)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float x = acc[v >> 2][v & 3][u];
        x = fmaf(av[v].x, bv[u].x, x);
        x = fmaf(av[v].y, bv[u].y, x);
        x = fmaf(av[v].z, bv[u].z, x);
        x = fmaf(av[v].w, bv[u].w, x);
        acc[v >> 2][v & 3][u] = x;
      }
  }
}

// f(i, n, value) for each element of the CTA's SBM x SBN tile this thread
// holds: i a row of the tile, n a column of the strip
template <int MODE, typename F>
__device__ __forceinline__ void each_element(const float (&acc)[2][4][4], F f) {
  if (MODE == kF32) {
    const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
    for (int v = 0; v < 8; ++v)
#pragma unroll
      for (int u = 0; u < 4; ++u) f(tr + 16 * v, tc + 16 * u, acc[v >> 2][v & 3][u]);
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(32 * wm + 16 * mt + g + 8 * (e >> 1), 32 * wn + 8 * nt + 2 * t + (e & 1),
            acc[mt][nt][e]);
  }
}

// Where a product's B operand lies: streamed from a global plane (rows
// [br0, br0 + SBN) past blim zero, row stride ldb), or the resident strip.
struct Operand {
  const float* g;
  int ld, r0, lim;
};

// acc = A[ar0 : ar0 + SBM, 0:K] B^T over k < K, both row-major with k
// contiguous.  A streams from global in SBK chunks, one landing while one
// is multiplied (cp.async); each thread converts the pieces it copied once
// they land.  B streams the same way (STAGE_B) or is the strip, read in
// place.  Rows past alim are zero.  Begins and ends at a barrier; waits for
// every commit group issued before it.
template <int MODE, bool STAGE_B>
__device__ void tile_product(float (&acc)[2][4][4], float* sm, const StripLayout& s,
                             const float* a, int lda, int ar0, int alim, const Operand& b,
                             int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const bool live = ar0 + 32 * wm < alim && b.r0 + 32 * wn < b.lim;  // a warp tile in range
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  constexpr int NSTAGE = stages_of(MODE);
  const int nk = (K + SBK - 1) / SBK;
  auto load = [&](int c) {  // chunk c into stage c % NSTAGE, one commit group a chunk
    if (c < nk) {
      const int buf = c % NSTAGE;
      stage<SBM, SBK>(sm + s.a + buf * SBM * s.ldk, s.ldk, a, lda, ar0, alim, c * SBK, K);
      if (STAGE_B)
        stage<SBN, SBK>(sm + s.b + buf * SBN * s.ldk, s.ldk, b.g, b.ld, b.r0, b.lim, c * SBK, K);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < NSTAGE - 1; ++c) load(c);
  for (int c = 0; c < nk; ++c) {
    const int buf = c % NSTAGE;
    cp_async_wait<NSTAGE - 2>();  // this thread's copies of chunk c landed
    convert<MODE, SBM>(sm, s, s.a + buf * SBM * s.ldk, s.alo + buf * SBM * s.ldk,
                       s.ah + buf * SBM * s.ldh / 2);
    if (STAGE_B)
      convert<MODE, SBN>(sm, s, s.b + buf * SBN * s.ldk, s.blo + buf * SBN * s.ldk,
                         s.bh + buf * SBN * s.ldh / 2);
    __syncthreads();  // chunk c converted by every thread; every thread done with chunk c - 1
    load(c + NSTAGE - 1);  // into chunk c - 1's stage
    const int k0 = c * SBK, klen = min(SBK, K - k0);
    if (MODE == kF32) {
      const float* bt = STAGE_B ? sm + s.b + buf * SBN * s.ldk : sm + s.st + k0;
      const int bld = STAGE_B ? s.ldk : s.ldt;
      thread_ffma(acc, sm + s.a + buf * SBM * s.ldk + tr * s.ldk, s.ldk, bt + tc * bld, bld, klen);
    } else if (live) {
      const int bld = STAGE_B ? (MODE == kBF16 ? s.ldh : s.ldk) : s.ldt;
      const void *pa, *pal, *pb, *pbl;
      if (MODE == kBF16) {
        pa = reinterpret_cast<const __nv_bfloat16*>(sm + s.ah + buf * SBM * s.ldh / 2) +
             32 * wm * s.ldh;
        pal = pa;
        pb = STAGE_B ? reinterpret_cast<const __nv_bfloat16*>(sm + s.bh + buf * SBN * s.ldh / 2)
                     : reinterpret_cast<const __nv_bfloat16*>(sm + s.st) + k0;
        pb = static_cast<const __nv_bfloat16*>(pb) + 32 * wn * bld;
        pbl = pb;
      } else {
        pa = sm + s.a + buf * SBM * s.ldk + 32 * wm * s.ldk;
        pal = sm + s.alo + buf * SBM * s.ldk + 32 * wm * s.ldk;
        pb = (STAGE_B ? sm + s.b + buf * SBN * s.ldk : sm + s.st + k0) + 32 * wn * bld;
        pbl = (STAGE_B ? sm + s.blo + buf * SBN * s.ldk : sm + s.stlo + k0) + 32 * wn * bld;
      }
      warp_mma<MODE>(acc, pa, pal, MODE == kBF16 ? s.ldh : s.ldk, pb, pbl, bld, klen, lane);
    }
  }
  __syncthreads();  // every thread done with every stage
}

// The epilogue operand E[r0 : r0 + SBM, j0 : j0 + SBN] (row stride ld) into
// the epilogue tile, as one commit group; rows past rlim and columns past
// clim are zero
__device__ __forceinline__ void stage_epilogue(float* sm, const StripLayout& s, const float* e,
                                               int ld, int r0, int rlim, int j0, int clim) {
  stage<SBM, SBN>(sm + s.e, s.lde, e, ld, r0, rlim, j0, clim);
  cp_async_commit();
}

// Half a trip for the strip of columns [j0, j0 + SBN) of pair b (plane
// offsets pxy, pxx, pyy): S = Y Z[J,:]^T (+ E1[:, J]) into the strip, kept
// transposed (row n = column j0 + n) in shared memory, or in p.st when it
// spills; then X[:, J] = A S (* E2[:, J]).  FIRST: Y = 0 (the first trip's
// M), so S = E1 and the product is skipped.  E1 and E2 tiles are staged
// before each product, so their loads overlap it; X leaves through the
// epilogue tile as whole rows.
template <int MODE, bool SPILL>
__device__ void half_trip(float* sm, const StripLayout& s, const StripParams& p, size_t pxy,
                          size_t pxx, size_t pyy, int j0, const float* y, const float* z,
                          const float* e1, const float* aop, const float* e2, float* x,
                          bool first) {
  const int nx = p.nx, ny = p.ny;
  float* st_g = p.st + pxy;  // the spilled strip: (ny, nx) a pair
  float acc[2][4][4];
  for (int r0 = 0; r0 < nx; r0 += SBM) {
    if (e1 != nullptr) stage_epilogue(sm, s, e1 + pxy, ny, r0, nx, j0, ny);
    if (first) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      cp_async_wait<0>();
      __syncthreads();
    } else {
      tile_product<MODE, true>(acc, sm, s, y + pxy, ny, r0, nx, Operand{z + pyy, ny, j0, ny}, ny);
    }
    each_element<MODE>(acc, [&](int i, int n, float v) {
      const int gi = r0 + i, gj = j0 + n;
      if (gi < nx && gj < ny) {
        if (e1 != nullptr) v += sm[s.e + i * s.lde + n];
        if (SPILL) {
          st_g[(size_t)gj * nx + gi] = v;
        } else if (MODE == kTF32x3) {
          uint32_t hi, lo;
          split_tf32(v, hi, lo);
          reinterpret_cast<uint32_t*>(sm + s.st)[n * s.ldt + gi] = hi;
          reinterpret_cast<uint32_t*>(sm + s.stlo)[n * s.ldt + gi] = lo;
        } else if (MODE == kBF16) {
          reinterpret_cast<__nv_bfloat16*>(sm + s.st)[n * s.ldt + gi] = __float2bfloat16_rn(v);
        } else {
          sm[s.st + n * s.ldt + gi] = v;
        }
      }
    });
    __syncthreads();  // the epilogue tile free; at the last tile, the strip complete
  }
  for (int r0 = 0; r0 < nx; r0 += SBM) {
    if (e2 != nullptr) stage_epilogue(sm, s, e2 + pxy, ny, r0, nx, j0, ny);
    if (SPILL)
      tile_product<MODE, true>(acc, sm, s, aop + pxx, nx, r0, nx, Operand{st_g, nx, j0, ny}, nx);
    else
      tile_product<MODE, false>(acc, sm, s, aop + pxx, nx, r0, nx, Operand{nullptr, 0, j0, ny}, nx);
    each_element<MODE>(acc, [&](int i, int n, float v) {
      float* q = sm + s.e + i * s.lde + n;
      *q = e2 != nullptr ? *q * v : v;
    });
    __syncthreads();  // the tile complete
    constexpr int PER_ROW = SBN / 4;
#pragma unroll
    for (int k = 0; k < SBM * PER_ROW / STHREADS; ++k) {  // whole rows of the strip out
      const int q = threadIdx.x + k * STHREADS;
      const int i = q / PER_ROW, n = (q % PER_ROW) * 4;
      if (r0 + i < nx && j0 + n < ny)
        *reinterpret_cast<float4*>(x + pxy + (size_t)(r0 + i) * ny + j0 + n) =
            *reinterpret_cast<const float4*>(sm + s.e + i * s.lde + n);
    }
    __syncthreads();  // the epilogue tile free
  }
}

template <int MODE, bool SPILL>
__global__ void __launch_bounds__(STHREADS, 1) fixed_point_strips(StripParams p) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / p.csize;
  const int trips = p.iters[b];
  if (trips <= 0) {  // M = 0: every CTA of the cluster leaves
    if (rank == 0 && threadIdx.x == 0) p.out[b] = 0.f;
    return;
  }
  const StripLayout s = strip_layout(p.nx, MODE, SPILL);
  const size_t pxy = (size_t)b * p.nx * p.ny, pxx = (size_t)b * p.nx * p.nx,
               pyy = (size_t)b * p.ny * p.ny;
  for (int it = 0; it < trips; ++it) {
    for (int j = rank; j < p.nstrips; j += p.csize)  // G2[:, J] = Vx (M Vy[J,:]^T + L[:, J])
      half_trip<MODE, SPILL>(sm, s, p, pxy, pxx, pyy, j * SBN, p.m, p.vy, p.l, p.vx, nullptr,
                             p.g2, it == 0);
    cluster.sync();  // G2 complete; every CTA done reading M
    for (int j = rank; j < p.nstrips; j += p.csize)  // M[:, J] = NS[:, J] * (Ax G2 Ay[J,:]^T)
      half_trip<MODE, SPILL>(sm, s, p, pxy, pxx, pyy, j * SBN, p.g2, p.ay, nullptr, p.ax, p.ns,
                             p.m, false);
    cluster.sync();  // M complete; every CTA done reading G2
  }

  // ux^T M uy over the CTA's strips: each warp takes rows w, w + 8, ...;
  // rank 0 adds the CTAs' partials in rank order
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float v = 0.f;
  for (int j = rank; j < p.nstrips; j += p.csize) {
    const int j0 = j * SBN;
    for (int i = warp; i < p.nx; i += SWARPS) {
      float r = 0.f;
      for (int n = lane; n < SBN && j0 + n < p.ny; n += 32)
        r = fmaf(__ldcg(p.m + pxy + (size_t)i * p.ny + j0 + n),
                 __ldg(p.uy + (size_t)b * p.ny + j0 + n), r);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
      v = fmaf(__ldg(p.ux + (size_t)b * p.nx + i), r, v);
    }
  }
  if (lane == 0) sm[s.part + warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float cta = 0.f;
    for (int w = 0; w < SWARPS; ++w) cta += sm[s.part + w];
    sm[s.part + SWARPS] = cta;
  }
  cluster.sync();  // every CTA's partial written
  if (rank == 0 && threadIdx.x == 0) {
    float total = 0.f;
    for (int r = 0; r < p.csize; ++r) {
      float* q = sm + s.part + SWARPS;
      total += *(r == 0 ? q : cluster.map_shared_rank(q, r));
    }
    p.out[b] = total;
  }
  cluster.sync();  // no CTA leaves while rank 0 may still read its partial
}

// whether the strip of (nx, mode) fits a CTA's shared memory
bool strip_fits(int nx, int mode) {
  return (size_t)strip_layout(nx, mode, false).total * sizeof(float) <= MAX_SMEM;
}

// Sets the kernel's attributes, checks that a cluster of its shape fits
// the card, and launches it; with `info` it writes [CTAs a cluster, dynamic
// shared memory bytes a CTA, clusters active at once, spill] there instead.
template <int MODE, bool SPILL>
int launch_strips(const StripParams& p, int batch, cudaStream_t stream, int* info) {
  void (*kern)(StripParams) = fixed_point_strips<MODE, SPILL>;
  const size_t smem = strip_layout(p.nx, MODE, SPILL).total * sizeof(float);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.csize * batch);
  cfg.blockDim = dim3(STHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg)) != cudaSuccess) return (int)err;
  if (info != nullptr) {
    info[0] = p.csize;
    info[1] = (int)smem;
    info[2] = clusters;
    info[3] = SPILL ? 1 : 0;
    return 0;
  }
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  if ((err = cudaLaunchKernelEx(&cfg, kern, p)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MODE>
int strips_mode(const StripParams& p, bool spill, int batch, cudaStream_t stream, int* info) {
  if (spill) return launch_strips<MODE, true>(p, batch, stream, info);
  return launch_strips<MODE, false>(p, batch, stream, info);
}

// The strip spills to st where it does not fit shared memory.  Returns the
// geometry, or false on a shape or mode the kernel does not take.
bool strips_geometry(int nx, int ny, int mode, StripParams& p, bool& spills) {
  if (nx < 16 || ny < 16 || nx % 16 != 0 || ny % 16 != 0 || mode < kF32 || mode > kBF16)
    return false;
  spills = !strip_fits(nx, mode);
  p.nx = nx;
  p.ny = ny;
  p.nstrips = (ny + SBN - 1) / SBN;
  p.csize = p.nstrips < MAX_STRIP_CTAS ? p.nstrips : MAX_STRIP_CTAS;
  return true;
}

int strips_dispatch(const StripParams& p, int mode, bool spill, int batch, cudaStream_t stream,
                    int* info) {
  if (mode == kF32) return strips_mode<kF32>(p, spill, batch, stream, info);
  if (mode == kTF32x3) return strips_mode<kTF32x3>(p, spill, batch, stream, info);
  return strips_mode<kBF16>(p, spill, batch, stream, info);
}

}  // namespace

// Route 1.  nx, ny multiples of 16, max(nx, ny) <= 64; iters already capped.
// mode: 0 f32 FFMA, 1 3xTF32, 2 bf16.
extern "C" int stem_fixed_point_cluster(
    const float* ns, const float* vx, const float* vy, const float* ax,
    const float* ay, const float* l, const float* ux, const float* uy,
    const int* iters, int batch, int nx, int ny, int mode, float* out,
    cudaStream_t stream) {
  if (batch < 1 || !valid_shape(nx, ny, mode)) return (int)cudaErrorInvalidValue;
  const ClusterParams p{ns, vx, vy, ax, ay, l, ux, uy, iters, out, nx, ny};
  return dispatch(p, mode, batch, stream, nullptr);
}

// Route 1's launch geometry for (nx, ny, mode): out = [dynamic shared
// memory bytes a CTA, pairs that can be active at once].
extern "C" int stem_fixed_point_cluster_info(int nx, int ny, int mode, int* out) {
  if (!valid_shape(nx, ny, mode)) return (int)cudaErrorInvalidValue;
  ClusterParams p = {};
  p.nx = nx;
  p.ny = ny;
  return dispatch(p, mode, 1, nullptr, out);
}

// Route 2.  nx, ny multiples of 16; iters already capped.  mode: 0 f32
// FFMA, 1 3xTF32, 2 bf16.  m, g2: (batch, nx, ny) scratch; st: (batch, ny,
// nx) scratch, read only when the strip spills (strips_geometry; may be
// null otherwise).
extern "C" int stem_fixed_point_strips(
    const float* ns, const float* vx, const float* vy, const float* ax,
    const float* ay, const float* l, const float* ux, const float* uy,
    const int* iters, int batch, int nx, int ny, int mode, float* m, float* g2, float* st,
    float* out, cudaStream_t stream) {
  StripParams p{ns, vx, vy, ax, ay, l, ux, uy, iters, m, g2, st, out, 0, 0, 0, 0};
  bool spills = false;
  if (batch < 1 || !strips_geometry(nx, ny, mode, p, spills) || (spills && st == nullptr) ||
      (long long)p.csize * batch > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return strips_dispatch(p, mode, spills, batch, stream, nullptr);
}

// Route 2's launch geometry for (nx, ny, mode): out = [CTAs a cluster,
// dynamic shared memory bytes a CTA, clusters that can be active at once,
// 1 if the strip spills to st].
extern "C" int stem_fixed_point_strips_info(int nx, int ny, int mode, int* out) {
  StripParams p = {};
  bool spills = false;
  if (!strips_geometry(nx, ny, mode, p, spills)) return (int)cudaErrorInvalidValue;
  return strips_dispatch(p, mode, spills, 1, nullptr, out);
}

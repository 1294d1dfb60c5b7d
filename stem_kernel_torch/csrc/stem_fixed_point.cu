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
// memory, and clusters of 4 or 16 CTAs a pair lost to an earlier route 2
// at every such shape of the stem Gram, PERF.md.)  The CTA holds NS, L, M, Vx, Ax, Vy, Ay
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
// Route 2, stem_fixed_point_tiles: every other pair, at any node count
// (multiples of 16).  One launch for the whole fixed point and the bilinear
// form.  A pair's columns are cut into strips J of sn = 64 (128 in bf16 on
// the 64-row tile, the one geometry where wider strips ran faster); a
// cluster of C = min(strips, 8) CTAs runs the pair, CTA r its strips r,
// r + C, ....  Each trip is two half-trips, each a pair-wide barrier
// (cluster) apart:
//
//   A  S = M Vy[J,:]^T + L[:, J]  (Nx x sn, the strip, kept as S^T)
//      G2[:, J] = Vx S            (to device memory: every CTA reads all of G2)
//   B  S = G2 Ay[J,:]^T
//      M[:, J] = NS[:, J] * (Ax S)
//
// and the first trip skips M Vy^T (M = 0).  Every operand a product reads
// is in the mode's form before the product runs, so no product converts:
// a prologue (each CTA a 1/C share of its pair) writes Vx, Ax, Vy and Ay
// once a call into scratch, as TF32 hi and lo planes (3xTF32) or a bf16
// plane (bf16); f32 reads the inputs as they are.  The epilogues write G2,
// M and the strip in the same form (M also in f32 at the last trip, for
// the bilinear form); rounding once or each trip gives the same bits.
//
// A CTA is three warpgroups.  One thread of the producer warpgroup
// (setmaxnreg down to 40 registers) keeps a ring of 2-8 stages full by TMA:
// a stage is one 128-byte k chunk of the A tile (M, G2, Vx or Ax; a rows
// tile of 64 or 128) and of the B tile (sn rows of Vy or Ay, or of the
// spilled strip), 128-byte swizzled, landing on the stage's mbarrier.  The
// two consumer warpgroups (232 registers) issue wgmma on the stages: bf16
// m64nNk16, 3xTF32 three m64nNk8 passes a k step (lo*hi, hi*lo, hi*hi),
// N = sn (rows tile 128: a warpgroup takes 64 rows) or sn / 2 (rows tile
// 64, at Nx <= 64: a warpgroup takes half the columns, so no warp idles
// at Nx = 64); f32 ("highest") FFMA
// from the same swizzled tiles.  Each consumer warp releases a stage to the
// producer (mbarrier) once its products from it are done, a chunk later
// where the ring holds more than 4 stages.  The epilogue operand (L or NS)
// is loaded into registers before the product it follows, so it lands
// while the product runs (loaded after it, with scalar stores and every
// release a chunk late, 128 x 256 ran 1.7x as long in "high").  The strip
// stays on the SM, swizzled as wgmma's B operand, where shared memory
// leaves at least 3 stages beside it; else it spills to a (B, planes, Ny,
// Nx) buffer and streams back by TMA like B.  The geometry (rows tile,
// strip columns, CTAs a pair, stages, spill, lag) is chosen in one place,
// stem_kernel_torch/ops/stem_fixed_point.py:tile_geometry, and checked here.
//
// What bounds route 2: at 128 x 256, B = 256, the products need 2.51 ms as
// three TF32 passes and 0.43 ms in bf16, the operands' bytes under 0.1 ms,
// so it is bound by operations; it runs at 3.5x that in "high" and 10x in
// bf16 (PERF.md).  A half-trip is short (12 chunks at 128 x 256), so its
// start (the cluster barrier, the first TMA loads) and its end (the stores
// of G2 or M) weigh, and a 128 x 64 tile reads 48 KB of stage from L2 for
// 1.6 MFLOP (3xTF32).  Tried on the card and left out: the A tiles
// multicast by TMA across the pair's cluster (each CTA one box of the tile,
// every arrival on every CTA's barrier) was 1.2-2x slower at every block
// shape and mode, since each refill waits for the slowest CTA of the
// cluster; the route's former strip kernel (mma.sync from cp.async chunks
// converted in the loop) was 1.4-2.2x slower in "high".
//
// C interface: every entry point returns cudaGetLastError() after its last
// launch (or the first error), so the caller can raise.

#include <cooperative_groups.h>
#include <cuda.h>
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
// Route 2: a pair's column strips on a cluster, TMA rings, wgmma (the
// rest; see the header)
// ===================================================================

constexpr int MAX_SMEM = 232448;   // dynamic shared memory a CTA can opt into
constexpr int TTHREADS = 384;     // consumer warpgroups 0 and 1, the producer warpgroup 2
constexpr int TCONSUMERS = 256;
constexpr int TROW = 128;         // bytes of k a staged row holds: one 128-byte swizzle atom
constexpr int TMAX_STAGES = 8;
constexpr int TMAX_CTAS = 8;      // the portable cluster size
constexpr int TRAP_NS = 2000000000;  // a barrier wait this long is a fault: trap, do not hang

__host__ __device__ constexpr int planes_of(int mode) { return mode == kTF32x3 ? 2 : 1; }
__host__ __device__ constexpr int esize_of(int mode) { return mode == kBF16 ? 2 : 4; }

// A CTA's dynamic shared memory, offsets in bytes from a 1024-aligned base.
// A stage holds the A tile (rt rows) and the B tile (sn rows) of one
// 128-byte k chunk, each plane (3xTF32: hi, lo) a 128-byte-swizzled tile;
// the strip S^T (sn columns: 64 or 128), where it stays on the SM, one
// such sn-row tile a k chunk.
struct TileLayout {
  int a_plane, b_plane, stage, strip_plane;
  int stages_off, strip_off, bar_off, part_off, total;
};

__host__ __device__ inline TileLayout tile_layout(int nx, int mode, int rt, int sn, int stages,
                                                  bool spill) {
  const int p = planes_of(mode), ke = TROW / esize_of(mode);
  TileLayout t;
  t.a_plane = rt * TROW;
  t.b_plane = sn * TROW;
  t.stage = p * (t.a_plane + t.b_plane);
  t.strip_plane = ((nx + ke - 1) / ke) * sn * TROW;
  int o = 0;
  t.stages_off = o; o += stages * t.stage;
  t.strip_off = o;  o += spill ? 0 : p * t.strip_plane;
  t.bar_off = o;    o += 8 * (2 * TMAX_STAGES + 1);  // full, empty, strip ready
  t.part_off = o;   o += 4 * 16;
  t.total = o + 1024;  // the base is aligned up to 1024 bytes
  return t;
}

// Tensor maps (3-D: k, rows, pair x plane) over the operands in the mode's
// form, and the plain pointers the prologue and the epilogues use.
struct TileParams {
  CUtensorMap tm_vx, tm_ax, tm_m, tm_g2;  // A operands: boxes of rt rows
  CUtensorMap tm_vy, tm_ay, tm_st;        // B operands: boxes of sn rows (tm_st: spill only)
  const float *vx, *ax, *vy, *ay, *ns, *l, *ux, *uy;
  const int* iters;
  void *cvx, *cax, *cvy, *cay;  // Vx, Ax, Vy, Ay in the mode's form (3xTF32, bf16)
  void *mc, *g2c, *st;          // M, G2 and the spilled strip in the mode's form
  float *mf, *out;              // f32 M for the bilinear form (mc in f32), the values
  int nx, ny, rt, sn, csize, stages, spill, lag;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wait for the phase of `parity` to complete; trap after TRAP_NS (a
// protocol fault), so that a fault ends the launch with an error
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - t0 > TRAP_NS) __trap();
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled tile
// (8-row groups 1024 bytes apart); k advances by adding bytes >> 4
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// acc (m64 x n64: 32 floats a thread; n32: 16) += A B^T, both from
// 128-byte-swizzled shared memory (descriptors)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db));
}

// The consumer thread's outputs: element i of acc is row row(i), column
// col(i) of the CTA's rt x sn tile.  Warpgroup w takes NW columns: rows 64 w
// and all sn columns (rt 128, NW = sn), or all 64 rows and columns NW w (rt
// 64, NW = sn / 2).
// Tensor cores: the wgmma accumulator layout; f32: rows tr + 8 v, columns
// tc + 16 u.
template <int MODE, int RT, int NW>
struct Frag {
  static constexpr int NACC = NW / 2;
  static constexpr int NU = NACC / 8;  // f32: columns a thread
  int r0, c0, g, q, wi;
  __device__ Frag(int t, int wg) {
    r0 = RT == 128 ? 64 * wg : 0;
    c0 = RT == 128 ? 0 : NW * wg;
    if (MODE == kF32) {
      g = t >> 4;  // tr
      q = t & 15;  // tc
      wi = 0;
    } else {
      wi = t >> 5;
      g = (t & 31) >> 2;
      q = t & 3;
    }
  }
  __device__ __forceinline__ int row(int i) const {
    return MODE == kF32 ? r0 + g + 8 * (i / NU) : r0 + 16 * wi + g + 8 * ((i >> 1) & 1);
  }
  __device__ __forceinline__ int col(int i) const {
    return MODE == kF32 ? c0 + q + 16 * (i % NU) : c0 + 8 * (i >> 2) + 2 * q + (i & 1);
  }
};

// f32: acc[8 v + u] += sum over the chunk's 32 k of A[tr + 8 v] B[tc + 16 u],
// FFMA in k order, from 128-byte-swizzled tiles (a: the warpgroup's first
// A row, b: its first B row)
template <int NU>
__device__ __forceinline__ void ffma_chunk(float (&acc)[8 * NU], const uint8_t* a,
                                           const uint8_t* b, int tr, int tc) {
#pragma unroll 2
  for (int c = 0; c < 8; ++c) {
    float4 av[8], bv[NU];
#pragma unroll
    for (int v = 0; v < 8; ++v)
      av[v] = *reinterpret_cast<const float4*>(a + (tr + 8 * v) * TROW + ((c ^ (tr & 7)) << 4));
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int r = tc + 16 * u;
      bv[u] = *reinterpret_cast<const float4*>(b + r * TROW + ((c ^ (r & 7)) << 4));
    }
#pragma unroll
    for (int v = 0; v < 8; ++v)
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        float x = acc[v * NU + u];
        x = fmaf(av[v].x, bv[u].x, x);
        x = fmaf(av[v].y, bv[u].y, x);
        x = fmaf(av[v].z, bv[u].z, x);
        x = fmaf(av[v].w, bv[u].w, x);
        acc[v * NU + u] = x;
      }
  }
}

// v into plane element `idx` (elements of one plane) of the mode's form at dst
// (planes `pstride` elements apart)
template <int MODE>
__device__ __forceinline__ void store_form(void* dst, size_t idx, size_t pstride, float v) {
  if (MODE == kTF32x3) {
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    static_cast<uint32_t*>(dst)[idx] = hi;
    static_cast<uint32_t*>(dst)[pstride + idx] = lo;
  } else if (MODE == kBF16) {
    static_cast<__nv_bfloat16*>(dst)[idx] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(dst)[idx] = v;
  }
}

// v0, v1 into plane elements idx, idx + 1 (idx even) of the mode's form
template <int MODE>
__device__ __forceinline__ void store_form2(void* dst, size_t idx, size_t pstride, float v0,
                                            float v1) {
  if (MODE == kTF32x3) {
    uint2 hi, lo;
    split_tf32(v0, hi.x, lo.x);
    split_tf32(v1, hi.y, lo.y);
    *reinterpret_cast<uint2*>(static_cast<uint32_t*>(dst) + idx) = hi;
    *reinterpret_cast<uint2*>(static_cast<uint32_t*>(dst) + pstride + idx) = lo;
  } else if (MODE == kBF16) {
    *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(dst) + idx) = pack_bf16(make_float2(v0, v1));
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(dst) + idx) = make_float2(v0, v1);
  }
}

// v into the resident strip at (row n, k) in the mode's form: tile k / ke
// of SN rows, its 16-byte chunk swizzled by n % 8
template <int MODE, int SN>
__device__ __forceinline__ void store_strip(uint8_t* strip, int plane_bytes, int n, int k, float v) {
  constexpr int ES = esize_of(MODE), KE = TROW / ES;
  const int kb = (k % KE) * ES;
  const int off = (k / KE) * SN * TROW + n * TROW + ((((kb >> 4) ^ (n & 7))) << 4) + (kb & 15);
  if (MODE == kTF32x3) {
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    *reinterpret_cast<uint32_t*>(strip + off) = hi;
    *reinterpret_cast<uint32_t*>(strip + plane_bytes + off) = lo;
  } else if (MODE == kBF16) {
    *reinterpret_cast<__nv_bfloat16*>(strip + off) = __float2bfloat16_rn(v);
  } else {
    *reinterpret_cast<float*>(strip + off) = v;
  }
}

// One pair's (n1, n2) f32 plane into the mode's form: float4 pieces
// first, first + step, ...
template <int MODE>
__device__ void convert_plane(const float* src, void* dst, int n, int first, int step) {
  for (int q = first; q < n / 4; q += step) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src) + q);
    if (MODE == kTF32x3) {
      uint4 hi, lo;
      split_tf32(v.x, hi.x, lo.x);
      split_tf32(v.y, hi.y, lo.y);
      split_tf32(v.z, hi.z, lo.z);
      split_tf32(v.w, hi.w, lo.w);
      static_cast<uint4*>(dst)[q] = hi;
      static_cast<uint4*>(dst)[n / 4 + q] = lo;
    } else {
      uint2 w;
      w.x = pack_bf16(make_float2(v.x, v.y));
      w.y = pack_bf16(make_float2(v.z, v.w));
      static_cast<uint2*>(dst)[q] = w;
    }
  }
}

template <int MODE, int RT, int SN>
__global__ void __launch_bounds__(TTHREADS, 1) fixed_point_tiles(const __grid_constant__ TileParams p) {
  constexpr int P = planes_of(MODE), ES = esize_of(MODE), KE = TROW / ES;
  using Fr = Frag<MODE, RT, RT == 128 ? SN : SN / 2>;
  constexpr int NACC = Fr::NACC;
  extern __shared__ uint8_t smraw[];
  // aligned up to 1024 bytes by pointer arithmetic on the shared array, so
  // the compiler keeps its address space (shared loads, not generic ones)
  uint8_t* sm = smraw + ((1024u - (smem_u32(smraw) & 1023u)) & 1023u);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = p.csize, rank = static_cast<int>(cluster_rank());
  const int b = blockIdx.x / C;
  const int trips = p.iters[b];
  if (trips <= 0) {  // M = 0: every CTA of the cluster leaves
    if (rank == 0 && tid == 0) p.out[b] = 0.f;
    return;
  }
  const int nx = p.nx, ny = p.ny, S = p.stages;
  const TileLayout L = tile_layout(nx, MODE, RT, SN, S, p.spill != 0);
  const uint32_t sbase = smem_u32(sm);
  const uint32_t full = sbase + L.bar_off, empty = full + 8 * TMAX_STAGES,
                 strip_ready = empty + 8 * TMAX_STAGES;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival a consumer warp
    }
    mbar_init(strip_ready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const size_t pxy = (size_t)b * nx * ny;
  if constexpr (MODE != kF32) {  // the prologue: this CTA's share of Vx, Ax, Vy, Ay in the mode's form
    const int first = rank * TTHREADS + tid, step = C * TTHREADS;
    const size_t xx = (size_t)b * nx * nx, yy = (size_t)b * ny * ny;
    convert_plane<MODE>(p.vx + xx, static_cast<uint8_t*>(p.cvx) + xx * P * ES, nx * nx, first, step);
    convert_plane<MODE>(p.ax + xx, static_cast<uint8_t*>(p.cax) + xx * P * ES, nx * nx, first, step);
    convert_plane<MODE>(p.vy + yy, static_cast<uint8_t*>(p.cvy) + yy * P * ES, ny * ny, first, step);
    convert_plane<MODE>(p.ay + yy, static_cast<uint8_t*>(p.cay) + yy * P * ES, ny * ny, first, step);
    fence_async_global();
  }
  cluster_sync_all();  // every CTA's barriers initialized; the converted operands written

  const int rtiles = (nx + RT - 1) / RT, nky = (ny + KE - 1) / KE, nkx = (nx + KE - 1) / KE;

  if (warp >= 8) {
    // ---- producer warpgroup: one thread keeps the TMA ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == TCONSUMERS) {
      uint32_t fill = 0, sr_phase = 0;
      auto load = [&](const CUtensorMap* ta, int r0, int kc, const CUtensorMap* tb, int j0) {
        const int s = fill % S;
        mbar_wait(empty + 8 * s, ((fill / S) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, P * L.a_plane + (tb != nullptr ? P * L.b_plane : 0));
        const uint32_t st = sbase + L.stages_off + s * L.stage;
        for (int pl = 0; pl < P; ++pl) {
          tma_load(st + pl * L.a_plane, ta, bar, kc * KE, r0, b * P + pl);
          if (tb != nullptr)
            tma_load(st + P * L.a_plane + pl * L.b_plane, tb, bar, kc * KE, j0, b * P + pl);
        }
        ++fill;
      };
      for (int it = 0; it < trips; ++it) {
        for (int half = 0; half < 2; ++half) {
          fence_async_global();  // the last half's M or G2, seen through the cluster barrier
          const CUtensorMap* ty = half ? &p.tm_g2 : &p.tm_m;
          const CUtensorMap* tz = half ? &p.tm_ay : &p.tm_vy;
          const CUtensorMap* ta = half ? &p.tm_ax : &p.tm_vx;
          for (int j0 = rank * SN; j0 < ny; j0 += C * SN) {
            if (half == 1 || it > 0)
              for (int r0 = 0; r0 < rtiles * RT; r0 += RT)
                for (int kc = 0; kc < nky; ++kc) load(ty, r0, kc, tz, j0);
            if (p.spill) {
              mbar_wait(strip_ready, sr_phase);
              sr_phase ^= 1;
              fence_async_global();
            }
            for (int r0 = 0; r0 < rtiles * RT; r0 += RT)
              for (int kc = 0; kc < nkx; ++kc) load(ta, r0, kc, p.spill ? &p.tm_st : nullptr, j0);
          }
          cluster_sync_all();
        }
      }
    } else {
      for (int k = 0; k < 2 * trips; ++k) cluster_sync_all();
    }
    cluster_sync_all();  // the bilinear form's two barriers
    cluster_sync_all();
    return;
  }

  // ---- consumer warpgroups 0 and 1 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2, t = tid & 127;
  const Fr fr(t, wg);
  const size_t plane_xy = (size_t)nx * ny;
  uint8_t* strip = sm + L.strip_off;
  float acc[NACC], ev[NACC];
  uint32_t fill = 0;

  // the thread's elements of E[r0 + row, j0 + col] (E: the pair's (nx, ny)
  // plane), 0 past the edges
  constexpr int W = MODE == kF32 ? 1 : 2;  // adjacent columns a thread holds (wgmma layout)
  auto fetch = [&](const float* e, int r0, int j0) {
#pragma unroll
    for (int i = 0; i < NACC; i += W) {
      const int gi = r0 + fr.row(i), gj = j0 + fr.col(i);
      const bool in = gi < nx && gj < ny;
      if constexpr (W == 2) {
        const float2 v = in ? __ldg(reinterpret_cast<const float2*>(e + pxy + (size_t)gi * ny + gj))
                            : make_float2(0.f, 0.f);
        ev[i] = v.x;
        ev[i + 1] = v.y;
      } else {
        ev[i] = in ? __ldg(e + pxy + (size_t)gi * ny + gj) : 0.f;
      }
    }
  };

  // acc = A[r0 : r0 + RT, :] B^T over nk chunks; B staged, or the resident strip
  auto product = [&](int nk, bool staged) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int kc = 0; kc < nk; ++kc) {
      const int s = fill % S;
      mbar_wait(full + 8 * s, (fill / S) & 1);
      const int st = L.stages_off + s * L.stage;
      const int a_off = st + fr.r0 * TROW;
      const int b_off = (staged ? st + P * L.a_plane : L.strip_off + kc * SN * TROW) + fr.c0 * TROW;
      const int b_plane = staged ? L.b_plane : L.strip_plane;
      if constexpr (MODE == kF32) {
        ffma_chunk<Fr::NU>(acc, sm + a_off, sm + b_off, fr.g, fr.q);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      } else {
        const uint64_t da = sw128_desc(sbase + a_off), db = sw128_desc(sbase + b_off);
        const uint64_t dal = da + (L.a_plane >> 4), dbl = db + (b_plane >> 4);
        reg_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {  // 32 bytes of k a step
          if constexpr (MODE == kTF32x3) {
            wgmma_tf32(acc, dal + 2 * ks, db + 2 * ks);
            wgmma_tf32(acc, da + 2 * ks, dbl + 2 * ks);
            wgmma_tf32(acc, da + 2 * ks, db + 2 * ks);
          } else {
            wgmma_bf16(acc, da + 2 * ks, db + 2 * ks);
          }
        }
        wgmma_commit();
        if (p.lag) {
          wgmma_wait<1>();  // the last chunk's products done: release its stage
        } else {
          wgmma_wait<0>();  // this chunk's: release it now
          prev = s;
        }
        reg_fence(acc);
        if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = p.lag ? s : -1;
      }
      ++fill;
    }
    if constexpr (MODE != kF32) {
      wgmma_wait<0>();
      reg_fence(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
    }
  };

  for (int it = 0; it < trips; ++it) {
    for (int half = 0; half < 2; ++half) {
      const float* e1 = half ? nullptr : p.l;
      const float* e2 = half ? p.ns : nullptr;
      void* x = half ? p.mc : p.g2c;
      const bool last = half == 1 && it == trips - 1 && MODE != kF32;
      for (int j0 = rank * SN; j0 < ny; j0 += C * SN) {
        // S = M Z[J,:]^T (+ L[:, J]) into the strip, kept as S^T
        if (half == 0 && it == 0) {  // M = 0: S = L
          for (int q = tid; q < SN * nkx * KE; q += TCONSUMERS) {
            const int k = q / SN, n = q % SN;
            const float v = k < nx && j0 + n < ny ? __ldg(p.l + pxy + (size_t)k * ny + j0 + n) : 0.f;
            if (!p.spill)
              store_strip<MODE, SN>(strip, L.strip_plane, n, k, v);
            else if (k < nx && j0 + n < ny)
              store_form<MODE>(p.st, ((size_t)b * P * ny + j0 + n) * nx + k, (size_t)ny * nx, v);
          }
        } else {
          for (int r0 = 0; r0 < rtiles * RT; r0 += RT) {
            if (e1 != nullptr) fetch(e1, r0, j0);  // lands while the product runs
            product(nky, true);
#pragma unroll
            for (int i = 0; i < NACC; ++i) {
              const int k = r0 + fr.row(i), n = fr.col(i);
              // 0 past nx and ny: those A and B rows load as zeros, and so does E
              const float v = e1 != nullptr ? acc[i] + ev[i] : acc[i];
              if (!p.spill) {
                if (k < nkx * KE) store_strip<MODE, SN>(strip, L.strip_plane, n, k, v);
              } else if (k < nx && j0 + n < ny) {
                store_form<MODE>(p.st, ((size_t)b * P * ny + j0 + n) * nx + k, (size_t)ny * nx, v);
              }
            }
          }
        }
        if (p.spill) {  // the strip in device memory, for the producer's TMA
          fence_async_global();
          consumers_sync();
          if (tid == 0) mbar_arrive(strip_ready);
        } else {  // the strip in shared memory, for wgmma
          fence_async_shared();
          consumers_sync();
        }
        // X[:, J] = Aop S (* NS[:, J])
        for (int r0 = 0; r0 < rtiles * RT; r0 += RT) {
          if (e2 != nullptr) fetch(e2, r0, j0);
          product(nkx, p.spill != 0);
#pragma unroll
          for (int i = 0; i < NACC; i += W) {
            const int gi = r0 + fr.row(i), gj = j0 + fr.col(i);
            if (gi < nx && gj < ny) {
              const size_t e = (size_t)gi * ny + gj;
              const float v0 = e2 != nullptr ? acc[i] * ev[i] : acc[i];
              if constexpr (W == 2) {
                const float v1 = e2 != nullptr ? acc[i + 1] * ev[i + 1] : acc[i + 1];
                store_form2<MODE>(x, (size_t)b * P * plane_xy + e, plane_xy, v0, v1);
                if (last) *reinterpret_cast<float2*>(p.mf + pxy + e) = make_float2(v0, v1);
              } else {
                store_form<MODE>(x, (size_t)b * P * plane_xy + e, plane_xy, v0);
              }
            }
          }
        }
        consumers_sync();  // every consumer done with the strip
      }
      fence_async_global();  // X's writes, read by the cluster's TMA in the next half
      cluster_sync_all();
    }
  }

  // ux^T M uy over the CTA's strips: each consumer warp takes rows w, w + 8,
  // ...; rank 0 adds the CTAs' partials in rank order
  float* part = reinterpret_cast<float*>(sm + L.part_off);
  float v = 0.f;
  for (int j0 = rank * SN; j0 < ny; j0 += C * SN) {
    for (int i = warp; i < nx; i += 8) {
      float r = 0.f;
      for (int n = lane; n < SN && j0 + n < ny; n += 32)
        r = fmaf(__ldcg(p.mf + pxy + (size_t)i * ny + j0 + n), __ldg(p.uy + (size_t)b * ny + j0 + n), r);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
      v = fmaf(__ldg(p.ux + (size_t)b * nx + i), r, v);
    }
  }
  if (lane == 0) part[warp] = v;
  consumers_sync();
  if (tid == 0) {
    float cta = 0.f;
    for (int w = 0; w < 8; ++w) cta += part[w];
    part[8] = cta;
  }
  cluster_sync_all();  // every CTA's partial written
  if (rank == 0 && tid == 0) {
    cg::cluster_group cluster = cg::this_cluster();
    float total = 0.f;
    for (int r = 0; r < C; ++r) total += *(r == 0 ? part + 8 : cluster.map_shared_rank(part + 8, r));
    p.out[b] = total;
  }
  cluster_sync_all();  // no CTA leaves while rank 0 may still read its partial
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a map over (z, rows, k) planes of element size es: boxes of 128 bytes of
// k by box_rows rows, 128-byte swizzle, zeros past the edges
bool encode_map(CUtensorMap* m, const void* base, int es, int k, int rows, int z, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)k, (cuuint64_t)rows, (cuuint64_t)z};
  const cuuint64_t strides[2] = {(cuuint64_t)k * es, (cuuint64_t)rows * k * es};
  const cuuint32_t box[3] = {(cuuint32_t)(TROW / es), (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(m, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// whether a geometry is one the kernel takes: rows tile 64 or 128, strips of
// 64 columns (or 128 in bf16 on the 64-row tile, the one place the card ran
// them faster), 1-8 CTAs a pair, 2-8 stages, the shared memory within a CTA's
bool tiles_valid(int nx, int ny, int mode, int rt, int sn, int csize, int stages, int spill) {
  if (nx < 16 || ny < 16 || nx % 16 != 0 || ny % 16 != 0 || mode < kF32 || mode > kBF16) return false;
  if ((rt != 64 && rt != 128) || (sn != 64 && (sn != 128 || mode != kBF16 || rt != 64)) ||
      csize < 1 || csize > TMAX_CTAS || stages < 2 || stages > TMAX_STAGES)
    return false;
  return tile_layout(nx, mode, rt, sn, stages, spill != 0).total <= MAX_SMEM;
}

template <int MODE, int RT, int SN>
int launch_tiles(TileParams& p, int batch, cudaStream_t stream, int* info) {
  void (*kern)(TileParams) = fixed_point_tiles<MODE, RT, SN>;
  const size_t smem = tile_layout(p.nx, MODE, RT, SN, p.stages, p.spill != 0).total;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.csize * batch);
  cfg.blockDim = dim3(TTHREADS);
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
    info[0] = (int)smem;
    info[1] = clusters;
    return 0;
  }
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  if ((err = cudaLaunchKernelEx(&cfg, kern, p)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MODE>
int tiles_mode(TileParams& p, int batch, cudaStream_t stream, int* info) {
  if constexpr (MODE == kBF16) {
    if (p.sn == 128) return launch_tiles<MODE, 64, 128>(p, batch, stream, info);
  }
  if (p.rt == 64) return launch_tiles<MODE, 64, 64>(p, batch, stream, info);
  return launch_tiles<MODE, 128, 64>(p, batch, stream, info);
}

int tiles_dispatch(TileParams& p, int mode, int batch, cudaStream_t stream, int* info) {
  if (mode == kF32) return tiles_mode<kF32>(p, batch, stream, info);
  if (mode == kTF32x3) return tiles_mode<kTF32x3>(p, batch, stream, info);
  return tiles_mode<kBF16>(p, batch, stream, info);
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

// Route 2, the tile kernel.  nx, ny multiples of 16; iters already capped;
// mode: 0 f32 FFMA, 1 3xTF32, 2 bf16.  The geometry (rows tile rt, columns
// a strip sn, CTAs a pair csize, stages, spill, lag) is the wrapper's choice
// (stem_kernel_torch/ops/stem_fixed_point.py: tile_geometry); this checks it.
// lag: a stage is released one chunk after its products were issued.
// Scratch in the mode's form (planes hi, lo in 3xTF32; bf16 in bf16):
// cvx, cax (batch, planes, nx, nx), cvy, cay (batch, planes, ny, ny) (null in
// f32: the inputs are read as they are); mc, g2c (batch, planes, nx, ny);
// mf (batch, nx, ny) f32, = mc in f32; st (batch, planes, ny, nx) where the
// strip spills (else null).  Every pointer 16-byte aligned.
extern "C" int stem_fixed_point_tiles(
    const float* ns, const float* vx, const float* vy, const float* ax, const float* ay,
    const float* l, const float* ux, const float* uy, const int* iters, int batch, int nx, int ny,
    int mode, int rt, int sn, int csize, int stages, int spill, int lag, void* cvx, void* cax, void* cvy,
    void* cay, void* mc, void* g2c, float* mf, void* st, float* out, cudaStream_t stream) {
  if (batch < 1 || !tiles_valid(nx, ny, mode, rt, sn, csize, stages, spill) ||
      (spill && st == nullptr) || (long long)csize * batch > 0x7fffffffLL ||
      (mode != kF32 && (cvx == nullptr || cax == nullptr || cvy == nullptr || cay == nullptr)))
    return (int)cudaErrorInvalidValue;
  TileParams p = {};
  p.vx = vx; p.ax = ax; p.vy = vy; p.ay = ay; p.ns = ns; p.l = l; p.ux = ux; p.uy = uy;
  p.iters = iters;
  p.cvx = cvx; p.cax = cax; p.cvy = cvy; p.cay = cay;
  p.mc = mc; p.g2c = g2c; p.st = st; p.mf = mf; p.out = out;
  p.nx = nx; p.ny = ny; p.rt = rt; p.sn = sn; p.csize = csize;
  p.stages = stages; p.spill = spill; p.lag = lag != 0;
  const int es = esize_of(mode), z = batch * planes_of(mode);
  const bool f32 = mode == kF32;
  if (!encode_map(&p.tm_vx, f32 ? (const void*)vx : cvx, es, nx, nx, z, rt) ||
      !encode_map(&p.tm_ax, f32 ? (const void*)ax : cax, es, nx, nx, z, rt) ||
      !encode_map(&p.tm_m, mc, es, ny, nx, z, rt) ||
      !encode_map(&p.tm_g2, g2c, es, ny, nx, z, rt) ||
      !encode_map(&p.tm_vy, f32 ? (const void*)vy : cvy, es, ny, ny, z, sn) ||
      !encode_map(&p.tm_ay, f32 ? (const void*)ay : cay, es, ny, ny, z, sn) ||
      (spill && !encode_map(&p.tm_st, st, es, nx, ny, z, sn)))
    return (int)cudaErrorInvalidValue;
  return tiles_dispatch(p, mode, batch, stream, nullptr);
}

// The tile kernel's launch geometry for a given choice: out = [dynamic
// shared memory bytes a CTA, clusters that can be active at once].
extern "C" int stem_fixed_point_tiles_info(int nx, int ny, int mode, int rt, int sn, int csize,
                                           int stages, int spill, int* out) {
  if (!tiles_valid(nx, ny, mode, rt, sn, csize, stages, spill)) return (int)cudaErrorInvalidValue;
  TileParams p = {};
  p.nx = nx; p.ny = ny; p.rt = rt; p.sn = sn; p.csize = csize; p.stages = stages; p.spill = spill;
  return tiles_dispatch(p, mode, 1, nullptr, out);
}

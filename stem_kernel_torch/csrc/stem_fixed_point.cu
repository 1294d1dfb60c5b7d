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
// and the bilinear form, for max(Nx, Ny) <= 128 (Nx, Ny multiples of 16).
// A pair runs on a thread-block cluster of C CTAs, C = 1 for max(Nx, Ny)
// <= 64 and 4 up to 128.  CTA c holds rows [c rx, c rx + rx) of NS, L, M,
// Vx, Ax, and columns [c ry, c ry + ry) of Vy, Ay, in shared memory for the
// whole fixed point (rx, ry: ceil(N / C) rounded up to 16), plus two
// transposed planes G1^T, G3^T (Ny x rx) and two stage buffers: up to 205 KB
// a CTA, the operands read from device memory once.  Each product is the CTA's own row slab A times
// a full right-hand operand B, split by K into C chunks, chunk r held by CTA
// r (a Vy/Ay column block, or a G^T plane):
//
//   P1  G1^T <- (M Vy^T + L)^T    A = M,  B = Vy,   K = Ny
//   P2  M    <- Vx G1             A = Vx, B = G1^T, K = Nx
//   P3  G3^T <- (M Ay^T)^T        A = M,  B = Ay,   K = Ny
//   P4  M    <- NS * (Ax G3)      A = Ax, B = G3^T, K = Nx
//
// A CTA multiplies its own chunk straight from its planes, and every other
// chunk from a local copy: while it multiplies chunk s, its threads hold
// chunk s + 1, loaded from the peer over distributed shared memory
// (cluster.map_shared_rank), in registers, and store it into the other
// stage buffer afterwards.  Every B chunk keeps K contiguous in a row, and
// each intermediate is written in the layout its next product reads, so no
// product reads through a stride; G2 lives in M's plane (M is dead between
// P1 and P4).  Barriers an iteration: a cluster barrier after P1 and after
// P3 (the planes the peers read next are complete, and every peer is done
// with the plane about to be written: G1^T is written again only after all
// peers passed P3, G3^T only after all passed P1), and __syncthreads after
// P2 and P4 (M's plane is local).  The first iteration skips P1 (M = 0, so
// G1 = L).  A CTA reads its pair's trip count; a pair with 0 trips writes 0
// and its CTAs leave at once, so short pairs free their SMs for the next
// cluster.  The bilinear form is fused: each CTA reduces its rows, rank 0
// adds the C partials in rank order (deterministic), and a last cluster
// barrier keeps every CTA's shared memory alive until rank 0 has read it.
//
// Why not past 128 nodes: 256 nodes need C = 16 (nine 256-node planes pass
// four CTAs' shared memory), and then every CTA pulls each product's whole
// right-hand operand over distributed shared memory, 15 chunks of K = 16
// with a barrier each.  That lost to route 2 at every 256-node block shape
// of the stem Gram (PERF.md), so route 2 takes them.
//
// What holds it back (PERF.md): a chunk step is short (K = 32 at N = 128)
// and each pays a register round trip of the next chunk and a
// __syncthreads; the tensor-core modes split or convert every fragment
// element where it is loaded, and all 8 warps of a CTA load the same A rows,
// so the conversions' integer and float work, more than mma.sync, looks to
// set the pace (development builds on the card).  Converting A once a
// product, and wgmma, are the next steps.
//
// The product mode is a template parameter, chosen by the wrapper from the
// precision name (stem_kernel_torch/ops/stem_fixed_point.py, MODES):
//
//   kF32     ("highest"): f32 FFMA from shared memory, 4 x 4 outputs a thread.
//   kTF32x3  ("high"): 3xTF32 on mma.sync.m16n8k8.tf32: x = hi + lo, both
//            rounded to nearest, ties away from zero, as cvt.rna.tf32.f32
//            rounds (unrounded f32 bits would be truncated), acc += lo*hi;
//            acc += hi*lo; acc += hi*hi.
//   kBF16    ("default"): mma.sync.m16n8k16.bf16 on operands rounded to
//            nearest even, f32 accumulation: the JAX kernel's dot_bf.
//
// The planes stay f32 in shared memory and are converted as fragments are
// loaded.  Rows are padded by 4 floats (8 for bf16, whose fragments load
// float2) so that the fragment loads hit 32 distinct banks.  wgmma, TMA
// and warp specialisation are for a later version: here 8 warps each own
// one or two 16 MT x 16 output tiles and issue mma.sync.
//
// Route 2, stem_fixed_point_f32: pairs with max(Nx, Ny) > 128.  Each iteration is four launches of a batched,
// shared-memory-tiled f32 FFMA GEMM (grid: column tile, row tile, pair)
// with "+ L" and "* NS" fused, then one launch for the bilinear form; the
// operands are read again from L2/HBM on every launch.  It runs f32 for
// every precision name.
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
// Route 2: one launch a product (max(Nx, Ny) > 128)
// ===================================================================

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

// ===================================================================
// Route 1: one launch, each pair resident in a cluster (max(Nx, Ny) <= 128)
// ===================================================================

enum Mode { kF32 = 0, kTF32x3 = 1, kBF16 = 2 };
enum Store { kG1T = 0, kG2 = 1, kG3T = 2, kM = 3 };

constexpr int CTHREADS = 256;
constexpr int CWARPS = CTHREADS / 32;
constexpr int MAX_CLUSTER_N = 128;
constexpr int TPW = 2;       // warp tiles a warp holds at most
constexpr int PREFETCH = 6;  // float4 a thread stages of a peer's chunk: 6144 floats

__host__ __device__ constexpr int pad_of(int mode) { return mode == kBF16 ? 8 : 4; }

// offsets (floats) of a CTA's planes in dynamic shared memory
struct Layout {
  int ldx, ldv, ldky, ldt;  // row strides: (rx, Ny), (rx, Nx), (Ny, ry), (Ny, rx) planes
  int ns, l, m, vx, ax, vy, ay, g1t, g3t, stage, chunk, part, total;
};

__host__ __device__ inline Layout layout_of(int nx, int ny, int rx, int ry, int pad) {
  Layout s;
  s.ldx = ny + pad;
  s.ldv = nx + pad;
  s.ldky = ry + pad;
  s.ldt = rx + pad;
  s.chunk = ny * (s.ldky > s.ldt ? s.ldky : s.ldt);  // the larger B chunk a peer holds
  int o = 0;
  s.ns = o;  o += rx * s.ldx;
  s.l = o;   o += rx * s.ldx;
  s.m = o;   o += rx * s.ldx;  // M, and G2 between P2 and P3
  s.vx = o;  o += rx * s.ldv;
  s.ax = o;  o += rx * s.ldv;
  s.vy = o;  o += ny * s.ldky;  // Vy[:, ry columns], row j at j * ldky
  s.ay = o;  o += ny * s.ldky;
  s.g1t = o; o += ny * s.ldt;
  s.g3t = o; o += ny * s.ldt;
  s.stage = o; o += 2 * s.chunk;  // two copies of a peer's chunk, in turns
  s.part = o; o += 16;  // CWARPS warp partials, then the CTA's partial at [CWARPS]
  s.total = o;
  return s;
}

struct Geometry {
  int csize, rx, ry, mt;
};

// CTAs a pair, rows (x side) and columns (y side) a CTA, and the warp
// tile's m16 count
inline Geometry geometry_of(int nx, int ny) {
  const int big = nx > ny ? nx : ny;
  const int side = big <= 64 ? 1 : 2;
  Geometry g;
  g.csize = side * side;
  const int cx = (nx + g.csize - 1) / g.csize, cy = (ny + g.csize - 1) / g.csize;
  g.rx = (cx + 15) / 16 * 16;
  g.ry = (cy + 15) / 16 * 16;
  // two m16 rows a warp tile (16 MT x 16) where that still gives every warp one
  const int q = g.rx / 16;
  g.mt = q % 2 == 0 && (q / 2) * (ny / 16) >= CWARPS ? 2 : 1;
  return g;
}

// whether the kernel's fixed per-thread arrays cover the geometry
inline bool geometry_fits(const Geometry& g, int nx, int ny, int pad) {
  const Layout s = layout_of(nx, ny, g.rx, g.ry, pad);
  return (g.rx / (16 * g.mt)) * (ny / 16) <= TPW * CWARPS  // warp tiles
         && (g.rx / 4) * (ny / 4) <= CTHREADS              // FFMA thread tiles
         && s.chunk <= 4 * PREFETCH * CTHREADS;            // staged chunk
}

struct ClusterParams {
  const float *ns, *vx, *vy, *ax, *ay, *l, *ux, *uy;
  const int* iters;
  float* out;
  int nx, ny, csize, rx, ry;
};

// what a CTA needs to run a product: its planes and geometry
struct Ctx {
  float* sm;
  Layout s;
  int nx, ny, rx, ry, rank;
};

// the address of the float at local offset `off` in CTA `r`'s shared memory
__device__ __forceinline__ const float* peer(const Ctx& c, int off, int r) {
  float* p = c.sm + off;
  return r == c.rank ? p : cg::this_cluster().map_shared_rank(p, r);
}

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

// One product out(rx, Ny) = A(rx, K) B^T of the fixed point.  A is a local
// plane (row stride lda).  B (Ny, K) is split by K into chunks of kc
// columns, chunk r in CTA r at plane offset b_off (row j at j * ldb):
// Vy and Ay (kc = ry, K = Ny) or G1^T and G3^T (kc = rx, K = Nx).  The
// CTA runs its own chunk first, straight from its plane, and every other
// one from a local copy: while it multiplies chunk s, its threads hold
// chunk s + 1, loaded from the peer, in registers, and store it into the
// other stage buffer after the multiply.  Tensor cores: warp w owns warp
// tiles w, w + 8 (16 MT x 16 outputs).  f32: thread t owns rows
// tr + (rx/4) v and columns tc + (Ny/4) u, v, u < 4 (strided, so that the
// lanes of a warp read consecutive B rows and one broadcast A row).
template <int MODE, int MT, int STORE>
__device__ void product(const Ctx& c, int a_off, int lda, int K, int kc, int b_off, int ldb) {
  const Layout& s = c.s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nchunks = (K + kc - 1) / kc;           // CTAs 0 .. nchunks-1 hold B
  const int base = c.rank < nchunks ? c.rank : 0;  // own chunk first, if it has one
  const bool own = c.rank < nchunks;
  const int len4 = c.ny * ldb / 4;  // a chunk, in float4
  float4 pf[PREFETCH];
  auto fetch = [&](int r) {
    const float4* src = reinterpret_cast<const float4*>(peer(c, b_off, r));
#pragma unroll
    for (int q = 0; q < PREFETCH; ++q) {
      const int idx = threadIdx.x + q * CTHREADS;
      if (idx < len4) pf[q] = src[idx];
    }
  };
  auto put = [&](int buf) {
    float4* dst = reinterpret_cast<float4*>(c.sm + s.stage + buf * s.chunk);
#pragma unroll
    for (int q = 0; q < PREFETCH; ++q) {
      const int idx = threadIdx.x + q * CTHREADS;
      if (idx < len4) dst[idx] = pf[q];
    }
  };
  if (!own) {
    fetch(0);
    put(0);
    __syncthreads();
  }

  const int rgs = c.rx / (16 * MT), tiles = rgs * (c.ny / 16);
  const int rq = c.rx / 4, cq = c.ny / 4;
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

  for (int step = 0; step < nchunks; ++step) {
    if (step + 1 < nchunks) fetch((base + step + 1) % nchunks);
    const int r = (base + step) % nchunks;
    const int k0 = r * kc, klen = min(kc, K - k0);
    const float* bm = (step == 0 && own) ? c.sm + b_off : c.sm + s.stage + (step & 1) * s.chunk;
    if (MODE == kF32) {
      if ((int)threadIdx.x < rq * cq) {
        const int tr = threadIdx.x / cq, tc = threadIdx.x - tr * cq;
        const float* brow[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) brow[u] = bm + (tc + cq * u) * ldb;
        ffma_range(facc, c.sm + a_off + tr * lda + k0, rq * lda, brow, klen);
      }
    } else {
#pragma unroll
      for (int w = 0; w < TPW; ++w) {
        const int tile = warp + w * CWARPS;
        if (tile < tiles) {
          const int m0 = (tile % rgs) * 16 * MT, n0 = (tile / rgs) * 16;
          const float* brow[2] = {bm + (n0 + g) * ldb, bm + (n0 + 8 + g) * ldb};
          mma_range<MODE, MT>(acc[w], c.sm + a_off + m0 * lda + k0, lda, brow, klen, lane);
        }
      }
    }
    if (step + 1 < nchunks) {
      put((step + 1) & 1);
      __syncthreads();
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
  cg::cluster_group cluster = cg::this_cluster();
  const Ctx c{sm, layout_of(p.nx, p.ny, p.rx, p.ry, pad_of(MODE)), p.nx, p.ny, p.rx, p.ry,
              (int)cluster.block_rank()};
  const int b = blockIdx.x / p.csize;
  const int trips = p.iters[b];
  if (trips <= 0) {  // M = 0: every CTA of the cluster leaves, none reads a peer
    if (c.rank == 0 && threadIdx.x == 0) p.out[b] = 0.f;
    return;
  }
  const Layout& s = c.s;
  const int nx = p.nx, ny = p.ny, x0 = c.rank * p.rx, y0 = c.rank * p.ry;
  const bool has_x = x0 < nx;  // a CTA past the x rows only lends its Vy, Ay columns
  const size_t pxy = (size_t)b * nx * ny, pxx = (size_t)b * nx * nx, pyy = (size_t)b * ny * ny;
  load_block(sm + s.ns, s.ldx, p.ns + pxy, x0, p.rx, nx, 0, ny, ny);
  load_block(sm + s.l, s.ldx, p.l + pxy, x0, p.rx, nx, 0, ny, ny);
  load_block(sm + s.vx, s.ldv, p.vx + pxx, x0, p.rx, nx, 0, nx, nx);
  load_block(sm + s.ax, s.ldv, p.ax + pxx, x0, p.rx, nx, 0, nx, nx);
  load_block(sm + s.vy, s.ldky, p.vy + pyy, 0, ny, ny, y0, p.ry, ny);
  load_block(sm + s.ay, s.ldky, p.ay + pyy, 0, ny, ny, y0, p.ry, ny);
  cluster.sync();  // every plane loaded, every CTA of the cluster running

  for (int it = 0; it < trips; ++it) {
    if (has_x) {
      if (it == 0) {  // M = 0: G1 = L
        for (int q = threadIdx.x; q < p.rx * ny; q += CTHREADS) {
          const int i = q / ny, j = q - i * ny;
          sm[s.g1t + j * s.ldt + i] = sm[s.l + i * s.ldx + j];
        }
      } else {
        product<MODE, MT, kG1T>(c, s.m, s.ldx, ny, p.ry, s.vy, s.ldky);
      }
    }
    cluster.sync();  // G1^T complete in every CTA; every peer done with G3^T
    if (has_x) product<MODE, MT, kG2>(c, s.vx, s.ldv, nx, p.rx, s.g1t, s.ldt);
    __syncthreads();  // G2 complete
    if (has_x) product<MODE, MT, kG3T>(c, s.m, s.ldx, ny, p.ry, s.ay, s.ldky);
    cluster.sync();  // G3^T complete in every CTA; every peer done with G1^T
    if (has_x) product<MODE, MT, kM>(c, s.ax, s.ldv, nx, p.rx, s.g3t, s.ldt);
    __syncthreads();  // M complete
  }

  // ux^T M uy: each warp takes rows w, w + 8, ...; rank 0 adds the CTAs' partials
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float v = 0.f;
  for (int li = warp; li < p.rx && x0 + li < nx; li += CWARPS) {
    float r = 0.f;
    for (int j = lane; j < ny; j += 32) r = fmaf(sm[s.m + li * s.ldx + j], p.uy[(size_t)b * ny + j], r);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
    v = fmaf(p.ux[(size_t)b * nx + x0 + li], r, v);
  }
  if (lane == 0) sm[s.part + warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float cta = 0.f;
    for (int w = 0; w < CWARPS; ++w) cta += sm[s.part + w];
    sm[s.part + CWARPS] = cta;
  }
  cluster.sync();  // every CTA's partial written
  if (c.rank == 0 && threadIdx.x == 0) {
    float total = 0.f;
    for (int r = 0; r < p.csize; ++r) total += *peer(c, s.part + CWARPS, r);
    p.out[b] = total;
  }
  cluster.sync();  // no CTA leaves while rank 0 may still read its partial
}

// Sets the kernel's attributes, checks that a cluster of its shape fits
// the card, and launches it; with `info` it writes [CTAs a cluster, dynamic
// shared memory bytes a CTA, clusters active at once] there instead.
template <int MODE, int MT>
int launch_cluster(const ClusterParams& p, int batch, cudaStream_t stream, int* info) {
  void (*kern)(ClusterParams) = fixed_point_cluster<MODE, MT>;
  const size_t smem = layout_of(p.nx, p.ny, p.rx, p.ry, pad_of(MODE)).total * sizeof(float);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.csize * batch);
  cfg.blockDim = dim3(CTHREADS);
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
    return 0;
  }
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;  // no cluster of this shape fits
  if ((err = cudaLaunchKernelEx(&cfg, kern, p)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_mode(const ClusterParams& p, int mt, int batch, cudaStream_t stream, int* info) {
  if constexpr (MODE == kF32) {
    return launch_cluster<MODE, 1>(p, batch, stream, info);  // the FFMA tiles take no m16 count
  } else {
    if (mt == 2) return launch_cluster<MODE, 2>(p, batch, stream, info);
    return launch_cluster<MODE, 1>(p, batch, stream, info);
  }
}

int dispatch(const ClusterParams& p, int mode, int mt, int batch, cudaStream_t stream,
             int* info) {
  if (mode == kF32) return launch_mode<kF32>(p, mt, batch, stream, info);
  if (mode == kTF32x3) return launch_mode<kTF32x3>(p, mt, batch, stream, info);
  return launch_mode<kBF16>(p, mt, batch, stream, info);
}

bool valid_shape(int nx, int ny, int mode) {
  return nx >= 16 && ny >= 16 && nx % 16 == 0 && ny % 16 == 0 && nx <= MAX_CLUSTER_N &&
         ny <= MAX_CLUSTER_N && mode >= kF32 && mode <= kBF16 &&
         geometry_fits(geometry_of(nx, ny), nx, ny, pad_of(mode));
}

}  // namespace

// Route 1.  nx, ny multiples of 16, max(nx, ny) <= 128; iters already capped.
// mode: 0 f32 FFMA, 1 3xTF32, 2 bf16.
extern "C" int stem_fixed_point_cluster(
    const float* ns, const float* vx, const float* vy, const float* ax,
    const float* ay, const float* l, const float* ux, const float* uy,
    const int* iters, int batch, int nx, int ny, int mode, float* out,
    cudaStream_t stream) {
  const Geometry g = geometry_of(nx, ny);
  if (batch < 1 || !valid_shape(nx, ny, mode) || (long long)g.csize * batch > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const ClusterParams p{ns, vx, vy, ax, ay, l, ux, uy, iters, out, nx, ny, g.csize, g.rx, g.ry};
  return dispatch(p, mode, g.mt, batch, stream, nullptr);
}

// Route 1's launch geometry for (nx, ny, mode): out = [CTAs a cluster,
// dynamic shared memory bytes a CTA, clusters that can be active at once].
extern "C" int stem_fixed_point_cluster_info(int nx, int ny, int mode, int* out) {
  if (!valid_shape(nx, ny, mode)) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry_of(nx, ny);
  ClusterParams p = {};
  p.nx = nx;
  p.ny = ny;
  p.csize = g.csize;
  p.rx = g.rx;
  p.ry = g.ry;
  return dispatch(p, mode, g.mt, 1, nullptr, out);
}

// Route 2: any shape, f32 for every precision name.
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

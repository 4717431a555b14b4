// K3: the fused blocked-LU forward/back substitution, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel of flowcontrol_tpu/ops/pallas_trisolve.py
// (pallas_block_lu_solve, body from _make_solve_kernel): x = A^-1 b from a
// BlockLU factor, lu (n_pad, n_pad) row-major with the L blocks strictly
// below and the U blocks on and above the block diagonal, dinv (nb, bs, bs)
// the inverses of the U diagonal blocks:
//
//   forward   y_k = b_k - sum_{j<k} L_kj y_j        (L unit block lower)
//   backward  x_k = D_k^-1 (y_k - sum_{j>k} U_kj x_j)
//
// The TPU kernel is one program on one core with the right-hand-side panel
// resident in VMEM. One thread block cannot pull the factor at this card's
// memory rate, so here every block row is spread over the whole card, and
// block row k+1 learns that block row k is finished from the order of the
// stream: the one C entry point below issues every block row's launches
// itself, back to back, with no host code between them.
//
// The sweep is right-looking: once y_k is final, every block subtracts
// L_ik y_k from the rows i > k it owns (backward: U_ik x_k from the rows
// i < k). Each output element is owned by one thread (panel) or one warp
// (single right-hand side), which sums its products in a fixed order: there
// is no sum across blocks, no scratch buffer and no atomic, and two calls
// give bitwise the same x. The forward sweep never reads the diagonal
// blocks of lu; the backward sweep reads dinv[k] in their place, writing
// x_k into a second panel (out) because other blocks still read y_k.
//
// What bounds it: at one right-hand side the bytes of the factor, each tile
// read once with 16-byte loads through the read-only path (4 n_pad^2 bytes
// in all: lu without its diagonal blocks, plus dinv); for a panel the
// 2 n_pad^2 B operations, done as register-tiled f32 FMAs from shared
// memory (full f32: no TF32, no tensor cores). The panel is read with plain
// global loads: its rows are written by one launch and read by the next.
//
// Every offset into lu is 64-bit: n_pad^2 is 3.3e9 elements at 56,383 dofs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 16;  // depth of one shared-memory tile of the panel kernel

// ---- one right-hand side: a block GEMV ------------------------------------
// y[r] = (SUB ? y[r] : 0) -+ sum_c a[r, c] v[c] for r < rows, c < cols; one
// warp per pair of rows, v staged in shared memory. rows % 2 == 0,
// cols % 4 == 0, a 16-byte aligned.
template <bool SUB>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const float* __restrict__ a, int64_t lda, const float* v, float* y, int rows,
            int cols) {
  extern __shared__ __align__(16) float vs[];
  for (int c = threadIdx.x; c < cols; c += kThreads) vs[c] = v[c];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cols4 = cols >> 2;
  const float4* vs4 = reinterpret_cast<const float4*>(vs);
  // two rows per warp and pass: twice the loads in flight per lane
  for (int64_t r = ((int64_t)blockIdx.x * kWarps + warp) * 2; r < rows;
       r += (int64_t)gridDim.x * kWarps * 2) {
    const float4* ar0 = reinterpret_cast<const float4*>(a + r * lda);
    const float4* ar1 = reinterpret_cast<const float4*>(a + (r + 1) * lda);
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 4
    for (int c = lane; c < cols4; c += 32) {
      const float4 av = __ldg(ar0 + c);
      const float4 bv = __ldg(ar1 + c);
      const float4 xv = vs4[c];
      acc0 = fmaf(av.x, xv.x, acc0);
      acc0 = fmaf(av.y, xv.y, acc0);
      acc0 = fmaf(av.z, xv.z, acc0);
      acc0 = fmaf(av.w, xv.w, acc0);
      acc1 = fmaf(bv.x, xv.x, acc1);
      acc1 = fmaf(bv.y, xv.y, acc1);
      acc1 = fmaf(bv.z, xv.z, acc1);
      acc1 = fmaf(bv.w, xv.w, acc1);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc0 += __shfl_down_sync(0xffffffffu, acc0, off);
      acc1 += __shfl_down_sync(0xffffffffu, acc1, off);
    }
    if (lane == 0) {
      y[r] = SUB ? y[r] - acc0 : acc0;
      y[r + 1] = SUB ? y[r + 1] - acc1 : acc1;
    }
  }
}

// ---- a panel of right-hand sides: a register-tiled f32 product ------------
// c[r, j] = (SUB ? c[r, j] : 0) -+ sum_k a[r, k] b[k, j] for r < rows,
// j < ncols, k < depth. One block computes a (16 TM) x (16 TN) tile of c,
// one thread TM x TN of it, in groups of four rows and four columns 64
// apart so that the shared-memory reads are 16-byte and free of bank
// conflicts. depth % kBK == 0, a 16-byte aligned; b and c take any ncols.
template <int TM, int TN, bool SUB>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const float* __restrict__ a, int64_t lda, const float* b, int64_t ldb, float* c,
            int64_t ldc, int rows, int ncols, int depth) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  constexpr int A_LOADS = BM * kBK / 4 / kThreads;  // float4 per thread
  constexpr int B_LOADS = BN * kBK / kThreads;      // floats per thread
  __shared__ __align__(16) float a_s[kBK][BM + 4];  // a_s[k][r]: the a tile, transposed
  __shared__ __align__(16) float b_s[kBK][BN];
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int64_t r0 = (int64_t)blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;

  float4 a_reg[A_LOADS];
  float b_reg[B_LOADS];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int f = t + i * kThreads;
      const int64_t r = r0 + (f >> 2);
      a_reg[i] = r < rows ? __ldg(reinterpret_cast<const float4*>(a + r * lda + k0) + (f & 3))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int f = t + i * kThreads;
      const int j = j0 + f % BN;
      b_reg[i] = j < ncols ? b[(int64_t)(k0 + f / BN) * ldb + j] : 0.f;
    }
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int f = t + i * kThreads;
      const int r = f >> 2, k = (f & 3) * 4;
      a_s[k + 0][r] = a_reg[i].x;
      a_s[k + 1][r] = a_reg[i].y;
      a_s[k + 2][r] = a_reg[i].z;
      a_s[k + 3][r] = a_reg[i].w;
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int f = t + i * kThreads;
      b_s[f / BN][f % BN] = b_reg[i];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load_tiles(0);
  for (int k0 = 0; k0 < depth; k0 += kBK) {
    store_tiles();
    __syncthreads();
    if (k0 + kBK < depth) load_tiles(k0 + kBK);  // in flight during the products
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 q = *reinterpret_cast<const float4*>(&a_s[k][g * 64 + ty * 4]);
        av[4 * g + 0] = q.x, av[4 * g + 1] = q.y, av[4 * g + 2] = q.z, av[4 * g + 3] = q.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 q = *reinterpret_cast<const float4*>(&b_s[k][g * 64 + tx * 4]);
        bv[4 * g + 0] = q.x, bv[4 * g + 1] = q.y, bv[4 * g + 2] = q.z, bv[4 * g + 3] = q.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = r0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = j0 + (j / 4) * 64 + tx * 4 + (j % 4);
      if (col >= ncols) continue;
      float* p = c + r * ldc + col;
      *p = SUB ? *p - acc[i][j] : acc[i][j];
    }
  }
}

// c (rows, nrhs) = (SUB ? c : 0) -+ a (rows, depth) b (depth, nrhs), panels
// with row stride nrhs.
template <bool SUB>
cudaError_t block_product(const float* a, int64_t lda, const float* b, float* c, int rows,
                          int depth, int nrhs, cudaStream_t s) {
  if (nrhs == 1) {
    const int want = (rows / 2 + kWarps - 1) / kWarps;
    const int grid = want < 132 * 16 ? want : 132 * 16;
    gemv_kernel<SUB><<<grid, kThreads, (size_t)depth * sizeof(float), s>>>(a, lda, b, c, rows,
                                                                          depth);
  } else if constexpr (SUB) {
    // the off-diagonal updates: large tiles, many of them
    const dim3 grid((unsigned)((nrhs + 127) / 128), (unsigned)((rows + 127) / 128));
    gemm_kernel<8, 8, SUB><<<grid, kThreads, 0, s>>>(a, lda, b, nrhs, c, nrhs, rows, nrhs,
                                                     depth);
  } else {
    // the dinv product: bs rows only and on the critical path, so small
    // tiles to spread it over more blocks
    const dim3 grid((unsigned)((nrhs + 63) / 64), (unsigned)((rows + 63) / 64));
    gemm_kernel<4, 4, SUB><<<grid, kThreads, 0, s>>>(a, lda, b, nrhs, c, nrhs, rows, nrhs,
                                                     depth);
  }
  return cudaGetLastError();
}

}  // namespace

// lu (n_pad, n_pad) f32 row-major; dinv (nb, bs, bs) f32; x (n_pad, nrhs)
// f32, the right-hand sides on entry (padding rows zero), overwritten with
// intermediate values; out (n_pad, nrhs) f32, the solution on return.
// n_pad % bs == 0, bs % 16 == 0, bs <= 12288 (one block row of a single
// right-hand side is staged in 48 KB of shared memory). Returns cudaGetLastError() of the first
// launch that was refused, else 0.
extern "C" int block_trisolve_f32(const float* lu, const float* dinv, float* x, float* out,
                                  int n_pad, int bs, int nrhs, void* stream) {
  if (n_pad <= 0 || nrhs <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = n_pad / bs;
  const size_t ld = (size_t)n_pad, w = (size_t)nrhs, b = (size_t)bs;
  cudaError_t e;
  // forward: y_k is final once the updates of block rows 0..k-1 are in
  for (int k = 0; k + 1 < nb; ++k) {
    const size_t below = (size_t)(k + 1) * b;
    e = block_product<true>(lu + below * ld + (size_t)k * b, (int64_t)ld, x + (size_t)k * b * w,
                            x + below * w, n_pad - (int)below, bs, nrhs, s);
    if (e != cudaSuccess) return (int)e;
  }
  // backward: x_k = dinv[k] y_k into out, then U_ik x_k off the rows above
  for (int k = nb - 1; k >= 0; --k) {
    const size_t at = (size_t)k * b;
    e = block_product<false>(dinv + (size_t)k * b * b, (int64_t)bs, x + at * w, out + at * w, bs,
                             bs, nrhs, s);
    if (e != cudaSuccess) return (int)e;
    if (k == 0) break;
    e = block_product<true>(lu + at, (int64_t)ld, out + at * w, x, (int)at, bs, nrhs, s);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" const char* block_trisolve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

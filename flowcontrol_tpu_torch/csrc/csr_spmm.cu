// S on Hopper: the batched step's sparse products in a fixed order.
//
// csr_spmm: out[b, i] = sum_k val[k] * x[b, col[k]] over the nonzeros k of
//   row i of a CSR matrix (n_rows x n, f32 or f64 values), for a batch of B
//   vectors x (B, n), read through its strides, into out (B, n_rows). The
//   batched step applies two such matrices per step: the mass (f32: dE and
//   the next step's right-hand side) and the BDF operator of the refinement
//   residual (f64), the latter fused with the residual itself:
// csr_residual: r[b, i] = float(double(rhs[b, i]) - sum_k val[k] *
//   double(x[b, col[k]])) for an f64 matrix and f32 x, rhs and r.
//   They stand for the JAX package's element-tensor applies of those
//   operators (flowcontrol_tpu/core/stepper.py _apply), which are XLA
//   gathers and products, not a Pallas kernel.
//
//   Why a kernel of its own: cuSPARSE's CSR x dense product (torch's
//   sparse @ dense, in every layout, index type and precision torch
//   offers) sums with atomics, so two calls on the same operands differ in
//   their last bits and the batched step is not repeatable: its CUDA graph
//   could not be held to the eager step bit for bit. Here each output is
//   one thread's sum over its row in CSR order (fused multiply-adds from
//   0), with no atomics and no split: two calls give the same bits, and the
//   tiled kernel gives the bits of the row-wise one (csr_spmm_rowwise, kept
//   as the reference order). csr_residual widens x in registers, sums in
//   f64 in the same order and rounds once on the store: the bits of
//   float(double(rhs) - csr_spmm_f64(a, double(x))).
//
//   What bounds it: bytes on paper (x read and out written once, B x n
//   values each, the matrix once per slab of vectors), in practice the
//   SM's L1/shared-memory traffic of the gather. Design: the rows are cut
//   into tiles (ops/spmm.py SpmmPlan, built once on the host: at most 64
//   consecutive rows whose distinct columns, sorted, number at most 128,
//   ops/spmm.py TILE_COLS; each nonzero packed with its index into its tile's list, one
//   8- or 16-byte load). A block takes one (tile, slab of 64 vectors):
//   it stages x[slab, tile's columns] into shared memory by 4- or 8-byte
//   cp.async copies, lanes walking the column list (it comes in runs of
//   consecutive dofs, so the reads coalesce in part), each column read
//   once per slab however many of the tile's rows use it; then each warp
//   sums its rows in registers, lane l the slab's vectors l and l + 32
//   (the packed nonzero is one broadcast load for both, the staged
//   x a conflict-free row of the padded tile; csr_residual widens it
//   there); then the sums go through the staged x's shared memory and
//   each warp writes one vector's rows, lanes on consecutive rows, so the
//   stores coalesce. One launch a call, no layout copy. csr_spmm_rowwise
//   (S's earlier kernel) read x dof-major: the wrapper paid two
//   transposes, and the kernel read a line of x for every nonzero.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float fma_of(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_of(double a, double b, double c) { return fma(a, b, c); }

// ── the row-wise reference: x_t (n, B) and out_t (n_rows, B) dof-major ───────

constexpr int kLanes = 32;  // right-hand sides per warp
constexpr int kRows = 8;    // rows per block, one warp each

template <typename T>
__global__ void __launch_bounds__(kLanes * kRows)
csr_spmm_rowwise_kernel(const int64_t* __restrict__ indptr, const int64_t* __restrict__ indices,
                        const T* __restrict__ val, int64_t n_rows, const T* __restrict__ x_t,
                        T* __restrict__ out_t, int batch) {
  const int64_t i = (int64_t)blockIdx.x * kRows + threadIdx.y;
  const int b = blockIdx.y * kLanes + threadIdx.x;
  if (i >= n_rows || b >= batch) return;
  const int64_t k1 = indptr[i + 1];
  T acc = 0;
  for (int64_t k = indptr[i]; k < k1; ++k) {
    acc = fma_of(val[k], x_t[indices[k] * batch + b], acc);
  }
  out_t[i * batch + b] = acc;
}

template <typename T>
int launch_rowwise(const int64_t* indptr, const int64_t* indices, const T* val, int64_t n_rows,
                   const T* x_t, T* out_t, int batch, void* stream) {
  if (n_rows <= 0 || batch <= 0) return 0;
  if ((batch + kLanes - 1) / kLanes > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n_rows + kRows - 1) / kRows), (unsigned)((batch + kLanes - 1) / kLanes));
  csr_spmm_rowwise_kernel<T><<<grid, dim3(kLanes, kRows), 0, static_cast<cudaStream_t>(stream)>>>(
      indptr, indices, val, n_rows, x_t, out_t, batch);
  return (int)cudaGetLastError();
}

// ── the tiled kernel: x (B, n) and out (B, n_rows) as the step holds them ────

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = 64;                  // rows of a tile at most (ops/spmm.py TILE_ROWS)
constexpr int kRowSlots = kTileRows / kWarps;  // rows of one warp
constexpr int kOLd = kTileRows + 1;            // the sums: one padded row of the tile per vector
constexpr int kVec = 2;                        // vectors per lane
constexpr int kSlab = 32 * kVec;               // vectors per block
constexpr int kXLd = kSlab + 1;                // staged x: one padded row of the slab per column

// dynamic shared memory of one block: the staged x, [cols][kXLd] of TX,
// later reused for the sums, [kSlab][kOLd] of TA
template <typename TX, typename TA>
size_t tiled_smem(int max_cols) {
  const size_t xs = (size_t)max_cols * kXLd * sizeof(TX);
  const size_t sums = (size_t)kSlab * kOLd * sizeof(TA);
  return xs > sums ? xs : sums;
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(N));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// one nonzero: its value and its column as an index into its tile's list,
// one 8- or 16-byte load (ops/spmm.py SpmmPlan.entries)
template <typename TA>
struct Entry;
template <>
struct alignas(8) Entry<float> {
  float v;
  int loc;
};
template <>
struct alignas(16) Entry<double> {
  double v;
  int loc, pad;
};

struct Plan {
  const int* tile_row0;  // (tiles + 1) first row of each tile
  const int* col_off;    // (tiles + 1) start of each tile's column list in cols
  const int* cols;       // each tile's distinct columns, sorted
  const int* indptr;     // (n_rows + 1) the CSR row pointers
  int tiles;
  int max_cols;          // the longest column list
};

// x[b, c] at x + b * xs_b + c * xs_c; rhs (kResidual) likewise; out (B, n_rows)
// with row stride ldo. TX: x's (as staged), rhs's and out's type; TA: the
// matrix's and the sums'. A block takes one tile and a slab of kSlab
// vectors: lane l of every warp owns the vectors l and l + 32 of the slab.
template <typename TX, typename TA, bool kResidual>
__global__ void __launch_bounds__(kThreads)
csr_spmm_tiled_kernel(Plan p, const Entry<TA>* __restrict__ ent, const TX* __restrict__ x,
                      int64_t xs_b, int64_t xs_c, const TX* __restrict__ rhs, int64_t rs_b,
                      int64_t rs_c, TX* __restrict__ out, int64_t ldo, int batch) {
  extern __shared__ __align__(16) unsigned char smem[];
  TX* xs = reinterpret_cast<TX*>(smem);    // [cols][kXLd]
  TA* sums = reinterpret_cast<TA*>(smem);  // [kSlab][kOLd], once xs is read
  const int t = blockIdx.x;
  const int b0 = blockIdx.y * kSlab;
  const int nb = min(kSlab, batch - b0);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r0 = p.tile_row0[t], nr = p.tile_row0[t + 1] - r0;
  const int c0 = p.col_off[t], nc = p.col_off[t + 1] - c0;

  // 1. stage x[b0 + b, cols[j]] at xs[j][b]: lanes on the column list, warp
  //    w the vectors w, w + 8, ...
  for (int j = lane; j < nc; j += 32) {
    const TX* xc = x + (int64_t)b0 * xs_b + (int64_t)p.cols[c0 + j] * xs_c;
    for (int b = w; b < nb; b += kWarps) cp_async<sizeof(TX)>(xs + j * kXLd + b, xc + b * xs_b);
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. warp w sums rows w, w + 8, ... in registers, each of its kVec vectors
  //    in CSR order from 0, x widened to TA (vectors past the batch sum
  //    what the slab left unstaged and are never stored)
  TA acc[kRowSlots][kVec];
#pragma unroll
  for (int i = 0; i < kRowSlots; ++i) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[i][v] = 0;
    const int r = w + i * kWarps;
    if (r < nr) {
      const int k1 = p.indptr[r0 + r + 1];
      for (int k = p.indptr[r0 + r]; k < k1; ++k) {
        const Entry<TA> e = ent[k];
        const TX* xk = xs + e.loc * kXLd + lane;
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          acc[i][v] = fma_of(e.v, static_cast<TA>(xk[32 * v]), acc[i][v]);
        }
      }
    }
  }
  __syncthreads();  // every warp has read xs: its memory takes the sums
#pragma unroll
  for (int i = 0; i < kRowSlots; ++i) {
    const int r = w + i * kWarps;
    if (r < nr) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) sums[(lane + 32 * v) * kOLd + r] = acc[i][v];
    }
  }
  __syncthreads();

  // 3. warp w writes vectors w, w + 8, ...: lanes on consecutive rows
  for (int b = w; b < nb; b += kWarps) {
    const int64_t ob = (int64_t)(b0 + b) * ldo + r0;
    for (int r = lane; r < nr; r += 32) {
      const TA s = sums[b * kOLd + r];
      if constexpr (kResidual) {
        const TX bi = rhs[(int64_t)(b0 + b) * rs_b + (int64_t)(r0 + r) * rs_c];
        out[ob + r] = static_cast<TX>(static_cast<TA>(bi) - s);
      } else {
        out[ob + r] = s;
      }
    }
  }
}

template <typename TX, typename TA, bool kResidual>
int launch_tiled(const Plan& p, const void* entries, const TX* x, int64_t xs_b, int64_t xs_c,
                 const TX* rhs, int64_t rs_b, int64_t rs_c, TX* out, int64_t ldo, int batch,
                 void* stream) {
  if (p.tiles <= 0 || batch <= 0) return 0;
  if (p.max_cols < 0) return (int)cudaErrorInvalidValue;
  const int slabs = (batch + kSlab - 1) / kSlab;
  if (slabs > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = tiled_smem<TX, TA>(p.max_cols);
  static size_t opted = 48 * 1024;  // dynamic shared memory granted to this instance
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(csr_spmm_tiled_kernel<TX, TA, kResidual>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  csr_spmm_tiled_kernel<TX, TA, kResidual>
      <<<dim3((unsigned)p.tiles, (unsigned)slabs), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(p, static_cast<const Entry<TA>*>(entries), x, xs_b,
                                              xs_c, rhs, rs_b, rs_c, out, ldo, batch);
  return (int)cudaGetLastError();
}

}  // namespace

// The tiled kernels. The plan (ops/spmm.py SpmmPlan): tile_row0 and
// col_off (tiles + 1), cols, indptr (n_rows + 1) int32; entries (nnz): each
// nonzero's value and its index into its tile's column list, 8 bytes (f32:
// value, index) or 16 (f64: value, index, 0). x (B, n) at strides (xs_b,
// xs_c); out (B, n_rows) with row stride ldo, not overlapping x (or rhs);
// blocks of 64 right-hand sides. Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 when the launch was
// accepted).
extern "C" int csr_spmm_f32(const int* tile_row0, const int* col_off, const int* cols,
                            const int* indptr, int tiles, int max_cols, const void* entries,
                            const float* x, int64_t xs_b, int64_t xs_c, float* out, int64_t ldo,
                            int batch, void* stream) {
  return launch_tiled<float, float, false>(Plan{tile_row0, col_off, cols, indptr, tiles, max_cols},
                                           entries, x, xs_b, xs_c, nullptr, 0, 0, out, ldo, batch,
                                           stream);
}

extern "C" int csr_spmm_f64(const int* tile_row0, const int* col_off, const int* cols,
                            const int* indptr, int tiles, int max_cols, const void* entries,
                            const double* x, int64_t xs_b, int64_t xs_c, double* out,
                            int64_t ldo, int batch, void* stream) {
  return launch_tiled<double, double, false>(
      Plan{tile_row0, col_off, cols, indptr, tiles, max_cols}, entries, x, xs_b, xs_c, nullptr,
      0, 0, out, ldo, batch, stream);
}

// r = float(double(rhs) - a @ double(x)): an f64 matrix (16-byte entries),
// f32 x (strides xs_b, xs_c), rhs (strides rs_b, rs_c) and r (row stride ldo).
extern "C" int csr_residual_f32(const int* tile_row0, const int* col_off, const int* cols,
                                const int* indptr, int tiles, int max_cols, const void* entries,
                                const float* x, int64_t xs_b, int64_t xs_c, const float* rhs,
                                int64_t rs_b, int64_t rs_c, float* out, int64_t ldo, int batch,
                                void* stream) {
  return launch_tiled<float, double, true>(Plan{tile_row0, col_off, cols, indptr, tiles, max_cols},
                                           entries, x, xs_b, xs_c, rhs, rs_b, rs_c, out, ldo,
                                           batch, stream);
}

// The row-wise reference (S's earlier kernel): indptr (n_rows + 1) and indices (nnz)
// int64, val (nnz); x_t (n, batch) and out_t (n_rows, batch) contiguous.
extern "C" int csr_spmm_rowwise_f32(const int64_t* indptr, const int64_t* indices,
                                    const float* val, int64_t n_rows, const float* x_t,
                                    float* out_t, int batch, void* stream) {
  return launch_rowwise<float>(indptr, indices, val, n_rows, x_t, out_t, batch, stream);
}

extern "C" int csr_spmm_rowwise_f64(const int64_t* indptr, const int64_t* indices,
                                    const double* val, int64_t n_rows, const double* x_t,
                                    double* out_t, int batch, void* stream) {
  return launch_rowwise<double>(indptr, indices, val, n_rows, x_t, out_t, batch, stream);
}

extern "C" int csr_spmm_tile_rows() { return kTileRows; }

extern "C" const char* csr_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// S on Hopper: the batched step's sparse products in a fixed order.
//
// csr_spmm: out_t[i, b] = sum_k val[k] * x_t[col[k], b] over the nonzeros k
//   of row i of a CSR matrix (n_rows x n, int64 row pointers and column
//   indices, f32 or f64 values), for a batch of B vectors stored dof-major:
//   x_t (n, B) and out_t (n_rows, B) contiguous. The batched step applies
//   two such matrices per step: the mass (f32: dE and the next step's
//   right-hand side) and the BDF operator of the refinement residual (f64).
//   It stands for the JAX package's element-tensor applies of those
//   operators (flowcontrol_tpu/core/stepper.py _apply), which are XLA
//   gathers and products, not a Pallas kernel.
//
//   Why a kernel of its own: cuSPARSE's CSR x dense product (torch's
//   sparse @ dense, in every layout, index type and precision torch
//   offers) sums with atomics, so two calls on the same operands differ in
//   their last bits and the batched step is not repeatable: its CUDA graph
//   could not be held to the eager step bit for bit. Here each output is
//   one thread's sum over its row in CSR order (fused multiply-adds), with
//   no atomics and no split: two calls give the same bits.
//
//   What bounds it: the reads of x_t, one row of B values per nonzero (the
//   rows a block's rows share hit L2); the matrix is read once per 32
//   right-hand sides. Design: a block is 8 warps, one row each; the 32
//   lanes of a warp take 32 consecutive right-hand sides, so each nonzero's
//   read of x_t is one coalesced 128-byte (f32) or 256-byte (f64) line and
//   its value and column are one broadcast load.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;  // right-hand sides per warp
constexpr int kRows = 8;    // rows per block, one warp each

__device__ __forceinline__ float fma_of(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_of(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(kLanes * kRows)
csr_spmm_kernel(const int64_t* __restrict__ indptr, const int64_t* __restrict__ indices,
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
int launch(const int64_t* indptr, const int64_t* indices, const T* val, int64_t n_rows,
           const T* x_t, T* out_t, int batch, void* stream) {
  if (n_rows <= 0 || batch <= 0) return 0;
  if ((batch + kLanes - 1) / kLanes > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n_rows + kRows - 1) / kRows), (unsigned)((batch + kLanes - 1) / kLanes));
  csr_spmm_kernel<T><<<grid, dim3(kLanes, kRows), 0, static_cast<cudaStream_t>(stream)>>>(
      indptr, indices, val, n_rows, x_t, out_t, batch);
  return (int)cudaGetLastError();
}

}  // namespace

// indptr (n_rows + 1) and indices (nnz) int64, val (nnz); x_t (n, batch)
// and out_t (n_rows, batch) contiguous (out_t must not overlap x_t).
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int csr_spmm_f32(const int64_t* indptr, const int64_t* indices, const float* val,
                            int64_t n_rows, const float* x_t, float* out_t, int batch,
                            void* stream) {
  return launch<float>(indptr, indices, val, n_rows, x_t, out_t, batch, stream);
}

extern "C" int csr_spmm_f64(const int64_t* indptr, const int64_t* indices, const double* val,
                            int64_t n_rows, const double* x_t, double* out_t, int batch,
                            void* stream) {
  return launch<double>(indptr, indices, val, n_rows, x_t, out_t, batch, stream);
}

extern "C" const char* csr_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

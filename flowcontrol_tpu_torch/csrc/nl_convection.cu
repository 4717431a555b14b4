// K1 on Hopper: the nonlinear convection term N(u) of the P2/P1 stepper.
//
// N(u)_i = sum over cells of  ∫ ((u·∇)u)·v_i dx  for every velocity dof i,
// with u given by its P2 nodal values. Replaces the TPU kernel
// flowcontrol_tpu/ops/pallas_nl.py (_nl_kernel, launched by _nl_pallas_call).
//
// The TPU design is not carried over: its one-hot pick/scatter masks, the
// 3-term bf16 split of every operand and the 128-cell node windows exist to
// feed the TPU's matrix unit from VMEM. Here every thread gathers its own
// values directly and does the quadrature in f32 FMAs:
//
//   launch 1 (nl_cell_kernel): one thread per (sample, cell). Gathers the
//     6 nodes x 2 components of u at cell_vel_nodes, forms u_q and ∇u_q at
//     the 7 quadrature points, conv_q = (u_q·∇)u_q weighted by wq, projects
//     it on phi2 (kept in shared memory) and writes the 12 per-cell
//     contributions r_e[b, c, 2a+d].
//   launch 2 (nl_gather_kernel): one thread per (sample, mixed dof). Sums
//     that dof's row of the velocity gather table (the transposed scatter,
//     rows padded with m = nc*12) in a fixed order, so the result is
//     deterministic with no atomics. Pressure rows hold only padding and
//     come out as zeros.
//
// What bounds it: at the 56,383-dof cylinder mesh a call moves about 8 MB
// (dphi2 4.1 MB, wq 0.3 MB, the gather table, u and r_e), a few µs at the
// H100's 3.35 TB/s, and does ~2 MFLOP. So the two launches' latency bounds
// it, not bytes or FLOPs; fusing it into the step (one launch, or a CUDA
// graph over the step) is the lever, not a faster inner loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNq = 7;    // quadrature points per cell
constexpr int kNloc = 6;  // P2 nodes per cell
constexpr int kThreads = 256;

__global__ void nl_cell_kernel(const float* __restrict__ u, int64_t n_dofs,
                               const int* __restrict__ cell_vel_nodes,
                               const float* __restrict__ dphi2,
                               const float* __restrict__ wq,
                               const float* __restrict__ phi2,
                               float* __restrict__ r_e, int nc, int batch) {
  __shared__ float s_phi2[kNq * kNloc];
  for (int i = threadIdx.x; i < kNq * kNloc; i += blockDim.x) s_phi2[i] = phi2[i];
  __syncthreads();

  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)batch * nc) return;
  const int64_t b = t / nc;
  const int64_t c = t % nc;
  const float* ub = u + b * n_dofs;

  float ue[kNloc][2];
#pragma unroll
  for (int n = 0; n < kNloc; ++n) {
    const int64_t node = cell_vel_nodes[c * kNloc + n];
    ue[n][0] = ub[2 * node];
    ue[n][1] = ub[2 * node + 1];
  }

  float r[kNloc][2];
#pragma unroll
  for (int a = 0; a < kNloc; ++a) r[a][0] = r[a][1] = 0.f;

  const float* dp = dphi2 + c * (kNq * kNloc * 2);  // [q][n][i]
  const float* wc = wq + c * kNq;
#pragma unroll
  for (int q = 0; q < kNq; ++q) {
    // u_q[d] and g[i][d] = ∂u_d/∂x_i at this quadrature point
    float u0 = 0.f, u1 = 0.f, g00 = 0.f, g01 = 0.f, g10 = 0.f, g11 = 0.f;
#pragma unroll
    for (int n = 0; n < kNloc; ++n) {
      const float ph = s_phi2[q * kNloc + n];
      const float dx = dp[(q * kNloc + n) * 2];
      const float dy = dp[(q * kNloc + n) * 2 + 1];
      u0 = fmaf(ph, ue[n][0], u0);
      u1 = fmaf(ph, ue[n][1], u1);
      g00 = fmaf(dx, ue[n][0], g00);
      g01 = fmaf(dx, ue[n][1], g01);
      g10 = fmaf(dy, ue[n][0], g10);
      g11 = fmaf(dy, ue[n][1], g11);
    }
    // conv_d = sum_i u_i g[i][d], weighted by wq (which includes detJ/2)
    const float w = wc[q];
    const float conv0 = w * fmaf(u0, g00, u1 * g10);
    const float conv1 = w * fmaf(u0, g01, u1 * g11);
#pragma unroll
    for (int a = 0; a < kNloc; ++a) {
      const float ph = s_phi2[q * kNloc + a];
      r[a][0] = fmaf(ph, conv0, r[a][0]);
      r[a][1] = fmaf(ph, conv1, r[a][1]);
    }
  }

  float* out = r_e + t * (kNloc * 2);
#pragma unroll
  for (int a = 0; a < kNloc; ++a) {
    out[2 * a] = r[a][0];
    out[2 * a + 1] = r[a][1];
  }
}

__global__ void nl_gather_kernel(const float* __restrict__ r_e,
                                 const int* __restrict__ table, int kmax,
                                 int64_t m, float* __restrict__ out,
                                 int64_t n_dofs, int batch) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)batch * n_dofs) return;
  const int64_t b = t / n_dofs;
  const int64_t i = t % n_dofs;
  const int* row = table + i * kmax;
  const float* rb = r_e + b * m;
  float s = 0.f;
  for (int k = 0; k < kmax; ++k) {
    const int src = row[k];
    if (src < m) s += rb[src];
  }
  out[t] = s;
}

}  // namespace

// u (batch, n_dofs) f32; cell_vel_nodes (nc, 6) i32; dphi2 (nc, 7, 6, 2) f32;
// wq (nc, 7) f32; phi2 (7, 6) f32; table (n_dofs, kmax) i32 padded with
// nc*12; r_e (batch, nc, 12) f32 scratch; out (batch, n_dofs) f32.
// All contiguous on one device. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (0 when both launches were accepted).
extern "C" int nl_convection_f32(const float* u, int64_t n_dofs,
                                 const int* cell_vel_nodes, const float* dphi2,
                                 const float* wq, const float* phi2, int nc,
                                 const int* table, int kmax, float* r_e,
                                 float* out, int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t cells = (int64_t)batch * nc;
  if (cells > 0) {
    nl_cell_kernel<<<(unsigned)((cells + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        u, n_dofs, cell_vel_nodes, dphi2, wq, phi2, r_e, nc, batch);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t dofs = (int64_t)batch * n_dofs;
  if (dofs > 0) {
    nl_gather_kernel<<<(unsigned)((dofs + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        r_e, table, kmax, (int64_t)nc * kNloc * 2, out, n_dofs, batch);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* nl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

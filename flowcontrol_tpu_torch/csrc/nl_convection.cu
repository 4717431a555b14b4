// K1 on Hopper: the nonlinear convection term N(u) of the P2/P1 stepper.
//
// N(u)_i = sum over cells of  ∫ ((u·∇)u)·v_i dx  for every velocity dof i,
// with u given by its P2 nodal values, for a batch u (B, n_dofs) f32.
// Replaces the TPU kernel flowcontrol_tpu/ops/pallas_nl.py (_nl_kernel,
// launched by _nl_pallas_call). The TPU design is not carried over: its
// one-hot pick/scatter masks, the 3-term bf16 split of every operand and
// the 128-cell node windows exist to feed the TPU's matrix unit from VMEM.
//
// What bounds it: the bytes of u and N(u), 8 B n_dofs (115 MB at the
// 56,383-dof cylinder and B = 256, 0.034 ms at 3.35 TB/s), plus the cell
// tables once. The earlier design (one thread per (sample, cell), a second
// launch summing each dof's row of a gather table) ran at ~20x that: it
// wrote the 12 per-cell contributions of every sample to device memory and
// read them back with 4-byte gathers, read every cell's 91 geometry values
// at an 84-float stride across the warp once per sample, and paid two
// launches.
//
// Design: the host orders the cells along a Morton curve of their
// centroids and cuts them into patches of 64 cells (ops/nl.py,
// NLTables.build; the dof numbering is untouched). One block of 256 threads
// per (patch, tile of samples):
//   - the patch's geometry (dphi2 and wq, 91 floats a cell, laid out patch
//     by patch) is copied once into shared memory with 16-byte loads and
//     used for every sample of the tile; its odd per-cell stride keeps the
//     reads free of bank conflicts;
//   - per pass of four samples, the patch's velocity-node values are
//     gathered into shared memory once; one thread per (cell, sample) forms
//     u_q and ∇u_q at the 7 quadrature points and the 12 contributions in
//     registers (f32 FMAs) and leaves them in shared memory; one thread per
//     patch node sums its cells' contributions for the four samples in the
//     fixed order of the node's slot list;
//   - a node that only this patch touches is written to N(u) directly; a
//     node on a patch boundary goes as a partial sum to a small buffer.
//     When a block has written its partials it counts itself in per
//     (boundary node, sample tile); the last of the node's patches to
//     arrive lists the node, and the block's threads then sum the listed
//     nodes' partials in patch order, one (node, sample) each. The counter
//     is scheduling only (the last arrival zeroes it for the next call):
//     the sums run in a fixed order, so two calls give the same bits;
//   - each block zero-fills its share of the pressure rows.
// One launch; the per-cell contributions never leave the SM. The tile of
// samples (ops/nl.py sample_tile) is sized so that about a thousand blocks
// share the card. 64-cell patches put more blocks on the card than 128-cell
// ones (whose geometry took 46.6 KB of shared memory) for more boundary
// nodes (28% of the cylinder's velocity nodes against 21%), and ran faster
// at every batch width on the H100.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNq = 7;    // quadrature points per cell
constexpr int kNloc = 6;  // P2 nodes per cell
constexpr int kGeo = kNq * kNloc * 2 + kNq;  // dphi2 (q, n, i) then wq (q): 91 floats
constexpr int kThreads = 256;
constexpr int kCells = 64;    // cells of a patch (ops/nl.py PATCH_CELLS)
constexpr int kSpt = 1;       // samples per thread in the cell phase
constexpr int kG = kThreads / kCells * kSpt;  // samples per pass
constexpr int kRStride = 13;  // shared stride of one cell's 12 contributions (odd)

struct Patches {
  const float* geo;          // (n_patches * kCells, 91) in patch order
  const int* cell_loc;       // (n_patches * kCells, 6) local node of each cell node
  const int* nodes;          // (n_patches, lmax) global velocity node of each local node
  const int* n_local;        // (n_patches,)
  const int* slots;          // (n_patches, lmax, kmax) cell * 6 + node, -1 pads
  const int* dest;           // (n_patches, lmax) node (owned) or -(partial slot + 1)
  const int* halo_node;      // (n_halo,)
  const int* halo_start;     // (n_halo + 1,) partial slots of each boundary node
  const int* slot_halo;      // (n_slots,) boundary node of each partial slot
  int lmax, kmax, n_halo, n_slots;
};

size_t patch_smem(int lmax) {
  const size_t u = (size_t)kG * lmax * 2, r = (size_t)kG * kCells * kRStride;
  return ((size_t)kCells * kGeo + (u > r ? u : r) + lmax) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
nl_patch_kernel(const float* __restrict__ u, float* __restrict__ out, int64_t n_dofs,
                int n_vnodes, int batch, int tile_b, const float* __restrict__ phi2,
                Patches pt, float* __restrict__ partial, int* __restrict__ arrivals) {
  extern __shared__ __align__(16) float smem[];
  float* s_geo = smem;                    // kCells * 91
  float* s_u = s_geo + kCells * kGeo;     // kG * lmax * 2, then in the same place
  float* s_r = s_u;                       // kG * kCells * 13
  int* s_fin = reinterpret_cast<int*>(     // lmax: the boundary nodes this block finishes
      s_u + max(kG * pt.lmax * 2, kG * kCells * kRStride));
  __shared__ float s_phi[kNq * kNloc];
  __shared__ int s_nfin;
  const int p = blockIdx.x, t = threadIdx.x;
  const int b0 = blockIdx.y * tile_b;
  const int b1 = min(b0 + tile_b, batch);
  const int nl = __ldg(pt.n_local + p);
  const int* nodes = pt.nodes + (int64_t)p * pt.lmax;
  const int* dest = pt.dest + (int64_t)p * pt.lmax;
  const int* slots = pt.slots + (int64_t)p * pt.lmax * pt.kmax;

  {  // the patch's geometry, once for every sample of the tile
    const float4* g4 = reinterpret_cast<const float4*>(pt.geo + (int64_t)p * kCells * kGeo);
    float4* s4 = reinterpret_cast<float4*>(s_geo);
    for (int i = t; i < kCells * kGeo / 4; i += kThreads) s4[i] = __ldg(g4 + i);
    if (t < kNq * kNloc) s_phi[t] = phi2[t];
  }
  const int j = t % kCells, h = t / kCells;  // this thread's cell, and its samples h*kSpt + s
  int loc[kNloc];
#pragma unroll
  for (int a = 0; a < kNloc; ++a)
    loc[a] = __ldg(pt.cell_loc + ((int64_t)p * kCells + j) * kNloc + a);
  __syncthreads();

  for (int bp = b0; bp < b1; bp += kG) {
    const int ng = min(kG, b1 - bp);
    // the patch's velocity values for samples bp .. bp + kG - 1 (zeros past the tile)
    for (int l = t; l < nl; l += kThreads) {
      const int64_t off = 2 * (int64_t)__ldg(nodes + l);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float v0 = 0.f, v1 = 0.f;
        if (g < ng) {
          const float* ub = u + (int64_t)(bp + g) * n_dofs + off;
          v0 = __ldg(ub);
          v1 = __ldg(ub + 1);
        }
        s_u[(g * pt.lmax + l) * 2] = v0;
        s_u[(g * pt.lmax + l) * 2 + 1] = v1;
      }
    }
    __syncthreads();
    float ue[kSpt][kNloc][2];
#pragma unroll
    for (int s = 0; s < kSpt; ++s)
#pragma unroll
      for (int a = 0; a < kNloc; ++a) {
        ue[s][a][0] = s_u[((h * kSpt + s) * pt.lmax + loc[a]) * 2];
        ue[s][a][1] = s_u[((h * kSpt + s) * pt.lmax + loc[a]) * 2 + 1];
      }
    __syncthreads();  // s_u is read: s_r takes its place
    float r[kSpt][kNloc][2];
#pragma unroll
    for (int s = 0; s < kSpt; ++s)
#pragma unroll
      for (int a = 0; a < kNloc; ++a) r[s][a][0] = r[s][a][1] = 0.f;
    const float* dp = s_geo + j * kGeo;
#pragma unroll
    for (int q = 0; q < kNq; ++q) {
      float ph[kNloc], dx[kNloc], dy[kNloc];
#pragma unroll
      for (int n = 0; n < kNloc; ++n) {
        ph[n] = s_phi[q * kNloc + n];
        dx[n] = dp[(q * kNloc + n) * 2];
        dy[n] = dp[(q * kNloc + n) * 2 + 1];
      }
      const float w = dp[kNq * kNloc * 2 + q];
#pragma unroll
      for (int s = 0; s < kSpt; ++s) {
        // u_q[d] and gr[i][d] = ∂u_d/∂x_i at this quadrature point
        float u0 = 0.f, u1 = 0.f, g00 = 0.f, g01 = 0.f, g10 = 0.f, g11 = 0.f;
#pragma unroll
        for (int n = 0; n < kNloc; ++n) {
          u0 = fmaf(ph[n], ue[s][n][0], u0);
          u1 = fmaf(ph[n], ue[s][n][1], u1);
          g00 = fmaf(dx[n], ue[s][n][0], g00);
          g01 = fmaf(dx[n], ue[s][n][1], g01);
          g10 = fmaf(dy[n], ue[s][n][0], g10);
          g11 = fmaf(dy[n], ue[s][n][1], g11);
        }
        // conv_d = sum_i u_i gr[i][d], weighted by wq (which includes detJ/2)
        const float conv0 = w * fmaf(u0, g00, u1 * g10);
        const float conv1 = w * fmaf(u0, g01, u1 * g11);
#pragma unroll
        for (int a = 0; a < kNloc; ++a) {
          r[s][a][0] = fmaf(ph[a], conv0, r[s][a][0]);
          r[s][a][1] = fmaf(ph[a], conv1, r[s][a][1]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kSpt; ++s) {
      float* rs = s_r + ((h * kSpt + s) * kCells + j) * kRStride;
#pragma unroll
      for (int a = 0; a < kNloc; ++a) {
        rs[2 * a] = r[s][a][0];
        rs[2 * a + 1] = r[s][a][1];
      }
    }
    __syncthreads();
    // each patch node sums its cells' contributions in its slot order
    for (int l = t; l < nl; l += kThreads) {
      const int* sl = slots + (int64_t)l * pt.kmax;
      float acc[kG][2];
#pragma unroll
      for (int g = 0; g < kG; ++g) acc[g][0] = acc[g][1] = 0.f;
      for (int k = 0; k < pt.kmax; ++k) {
        const int s = __ldg(sl + k);
        if (s < 0) break;
        const float* rs = s_r + (s / kNloc) * kRStride + 2 * (s % kNloc);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          acc[g][0] += rs[g * kCells * kRStride];
          acc[g][1] += rs[g * kCells * kRStride + 1];
        }
      }
      const int d = __ldg(dest + l);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g >= ng) break;
        float* o = d >= 0 ? out + (int64_t)(bp + g) * n_dofs + 2 * (int64_t)d
                          : partial + ((int64_t)(bp + g) * pt.n_slots + (-d - 1)) * 2;
        o[0] = acc[g][0];
        o[1] = acc[g][1];
      }
    }
    __syncthreads();  // s_u and s_r are refilled by the next pass
  }

  {  // this block's share of the pressure rows: zero
    const int64_t np = n_dofs - 2 * (int64_t)n_vnodes;
    const int64_t per = (np + gridDim.x - 1) / gridDim.x;
    const int64_t r0 = 2 * (int64_t)n_vnodes + per * p;
    const int64_t r1 = min(r0 + per, n_dofs);
    for (int b = b0; b < b1; ++b)
      for (int64_t r = r0 + t; r < r1; r += kThreads) out[(int64_t)b * n_dofs + r] = 0.f;
  }

  // boundary nodes: count this patch in; the last of a node's patches to
  // arrive lists it, and the block's threads then sum the listed nodes'
  // partials, one (node, sample) each
  if (t == 0) s_nfin = 0;
  __threadfence();
  __syncthreads();
  for (int l = t; l < nl; l += kThreads) {
    const int d = __ldg(dest + l);
    if (d >= 0) continue;
    const int hn = __ldg(pt.slot_halo + (-d - 1));
    const int shares = __ldg(pt.halo_start + hn + 1) - __ldg(pt.halo_start + hn);
    int* count = arrivals + (int64_t)blockIdx.y * pt.n_halo + hn;
    if (atomicAdd(count, 1) == shares - 1) {
      *count = 0;  // every patch has arrived: zero again for the next launch
      s_fin[atomicAdd(&s_nfin, 1)] = hn;
    }
  }
  __threadfence();
  __syncthreads();
  const int nf = s_nfin, nb_tile = b1 - b0;
  for (int i = t; i < nf * nb_tile; i += kThreads) {
    const int hn = s_fin[i % nf], b = b0 + i / nf;
    const int q0 = __ldg(pt.halo_start + hn), q1 = __ldg(pt.halo_start + hn + 1);
    const float2* pb = reinterpret_cast<const float2*>(partial) + (int64_t)b * pt.n_slots;
    float s0 = 0.f, s1 = 0.f;
    for (int q = q0; q < q1; ++q) {
      const float2 v = __ldcg(pb + q);
      s0 += v.x;
      s1 += v.y;
    }
    const int64_t node = __ldg(pt.halo_node + hn);
    out[(int64_t)b * n_dofs + 2 * node] = s0;
    out[(int64_t)b * n_dofs + 2 * node + 1] = s1;
  }
}

}  // namespace

// u (batch, n_dofs) f32; out (batch, n_dofs) f32; phi2 (7, 6) f32; the patch
// tables of ops/nl.py (int32, contiguous, on the device); partial (batch,
// n_slots, 2) f32 scratch; arrivals (ceil(batch / tile_b), n_halo) int32
// counters, zero on entry and left zero (the last arrival resets each, so
// calls sharing one buffer must run in stream order). cells == 64; one
// block per (patch, tile of tile_b samples). Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 when all was accepted).
extern "C" int nl_convection_f32(const float* u, float* out, int64_t n_dofs, int n_vnodes,
                                 int batch, int tile_b, const float* phi2, const float* geo,
                                 const int* cell_loc, const int* nodes, const int* n_local,
                                 const int* slots, const int* dest, const int* halo_node,
                                 const int* halo_start, const int* slot_halo, int n_patches,
                                 int cells, int lmax, int kmax, int n_halo, int n_slots,
                                 float* partial, int* arrivals, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || n_patches <= 0) return 0;
  if (cells != kCells || tile_b <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (batch + tile_b - 1) / tile_b;
  const size_t smem = patch_smem(lmax);
  cudaError_t e = cudaFuncSetAttribute(nl_patch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  Patches pt{geo, cell_loc, nodes, n_local, slots, dest, halo_node, halo_start, slot_halo,
             lmax, kmax, n_halo, n_slots};
  nl_patch_kernel<<<dim3((unsigned)n_patches, (unsigned)tiles), kThreads, smem, s>>>(
      u, out, n_dofs, n_vnodes, batch, tile_b, phi2, pt, partial, arrivals);
  return (int)cudaGetLastError();
}

// samples one block takes per pass (ops/nl.py sizes its tiles by it)
extern "C" int nl_samples_per_pass() { return kG; }

extern "C" const char* nl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K2 and P1 on Hopper: the two kernels of the multifrontal solve's sweeps.
//
// K2, stack_matvec: out[b, m, p] = sum_q a[m, p, q] * v[b, m, q] over one
//   stage's padded factor stack a (m, p, q) f32 (inv, fbi or ginv) and a
//   leading batch of B right-hand sides. Replaces the TPU kernel
//   flowcontrol_tpu/ops/pallas_mf_matvec.py (_mv_kernel, launched by
//   _stack_matvec), which took only 128-aligned p and q; this one takes
//   every stage (p, q multiples of 8 at the 56,383-dof cylinder, down to 8).
//
//   What bounds it: one multiply-add per element of a, read once. At the
//   56,383-dof cylinder one solve reads 0.46 GB of stacks over ~57 launches,
//   0.137 ms at the H100's 3.35 TB/s, so bytes bound it, and at single
//   stream the latency of memory and of the launch: one launch moves ~8 MB,
//   2.4 µs at bandwidth. Design: one block per (tile of 8 output rows, node
//   m); v[b, m, :] for up to 8 right-hand sides sits in shared memory
//   (q <= ~1.5k floats: under 48 KB); each warp computes one whole row with
//   coalesced 16-byte loads of a, all eight of a 1024-float chunk in flight
//   per lane before their FMAs (4-byte loads when q % 4 != 0), and a
//   fixed-order warp-shuffle reduction. No atomics, so the result is deterministic. a is read once
//   per group of 8 right-hand sides (once for the single stream, whose
//   instance keeps one accumulator per thread). Full f32 FMAs: no TF32, no
//   tensor cores.
//
// P1, gather_sum_sub: out[b, j] = xe[b, j] - sum_k buf[b, t[k, j]] over one
//   inbox segment of the forward sweep, t (kmax, w) int32 with pads
//   pointing at buf[b, 0] = 0. Replaces the TPU probe
//   tools/pallas_gather_probe.py (k_take, launched by take_2d_table), the
//   primitive of the JAX sweep's _gather_sum0, and fuses the segment's
//   subtraction. One thread per (b, j) sums its column in a fixed k order:
//   deterministic, no atomics, reads of t coalesced along j. What bounds it:
//   launch latency; all inboxes of one solve hold ~31k contributions at the
//   56,383-dof cylinder, a few hundred KB in all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = kWarps;  // output rows per block: one per warp
constexpr int kLoads = 8;      // 16-byte loads of a in flight per lane
constexpr int kChunk = 8;      // most right-hand sides per pass over a
constexpr int kGatherThreads = 256;

template <int NB>
__device__ __forceinline__ void fma4(float (&acc)[NB], const float4 w, const float* sv, int q,
                                     int j, int nb) {
#pragma unroll
  for (int bb = 0; bb < NB; ++bb) {
    if (bb < nb) {
      const float4 s = *reinterpret_cast<const float4*>(sv + bb * q + j);
      acc[bb] = fmaf(w.x, s.x, acc[bb]);
      acc[bb] = fmaf(w.y, s.y, acc[bb]);
      acc[bb] = fmaf(w.z, s.z, acc[bb]);
      acc[bb] = fmaf(w.w, s.w, acc[bb]);
    }
  }
}

// NB = right-hand sides per pass over a (1, 2, 4 or 8): the single stream
// keeps one accumulator per thread, and so more warps per SM.
template <int NB>
__global__ void stack_matvec_kernel(const float* __restrict__ a, int p, int q,
                                    const float* __restrict__ v, int64_t v_bstride,
                                    float* __restrict__ out, int64_t o_bstride,
                                    int batch) {
  extern __shared__ float sv[];  // [min(batch, NB)][q]
  const int mi = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* am = a + (int64_t)mi * p * q;
  // every row of a starts 16-byte aligned when q % 4 == 0 (torch allocations
  // are 256-byte aligned), and so does every row of sv
  const bool vec4 = (q % 4) == 0;

  for (int b0 = 0; b0 < batch; b0 += NB) {
    const int nb = min(NB, batch - b0);
    __syncthreads();  // the previous pass's reads of sv are done
    for (int i = threadIdx.x; i < nb * q; i += blockDim.x) {
      const int bb = i / q;
      const int j = i - bb * q;
      sv[i] = v[(int64_t)(b0 + bb) * v_bstride + (int64_t)mi * q + j];
    }
    __syncthreads();

    const int row = row0 + warp;
    if (row < p) {
      const float* ar = am + (int64_t)row * q;
      float acc[NB];
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) acc[bb] = 0.f;
      if (vec4) {
        // all kLoads loads of a chunk are issued before its FMAs: a row of
        // up to 1024 floats is one round trip to memory
        const float4* ar4 = reinterpret_cast<const float4*>(ar);
        const int n4 = q / 4;
        for (int c0 = 0; c0 < n4; c0 += kLoads * 32) {
          float4 w[kLoads];
#pragma unroll
          for (int u = 0; u < kLoads; ++u) {
            const int j4 = c0 + u * 32 + lane;
            w[u] = j4 < n4 ? __ldg(ar4 + j4) : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < kLoads; ++u) {
            const int j4 = c0 + u * 32 + lane;
            if (j4 < n4) fma4<NB>(acc, w[u], sv, q, 4 * j4, nb);
          }
        }
      } else {
        for (int j = lane; j < q; j += 32) {
          const float w = __ldg(ar + j);
#pragma unroll
          for (int bb = 0; bb < NB; ++bb) {
            if (bb < nb) acc[bb] = fmaf(w, sv[bb * q + j], acc[bb]);
          }
        }
      }
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          acc[bb] += __shfl_xor_sync(0xffffffffu, acc[bb], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int bb = 0; bb < NB; ++bb) {
          if (bb < nb) out[(int64_t)(b0 + bb) * o_bstride + (int64_t)mi * p + row] = acc[bb];
        }
      }
    }
  }
}

template <int NB>
int launch_stack_matvec(const float* a, int m, int p, int q, const float* v,
                        int64_t v_bstride, float* out, int64_t o_bstride, int batch,
                        cudaStream_t stream) {
  const size_t smem = (size_t)(batch < NB ? batch : NB) * q * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stack_matvec_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((p + kRows - 1) / kRows), (unsigned)m);
  stack_matvec_kernel<NB><<<grid, kWarps * 32, smem, stream>>>(a, p, q, v, v_bstride, out,
                                                                o_bstride, batch);
  return (int)cudaGetLastError();
}

__global__ void gather_sum_sub_kernel(const float* __restrict__ buf, int64_t buf_bstride,
                                      const int* __restrict__ t, int kmax, int w,
                                      const float* xe, int64_t xe_bstride,
                                      float* out, int64_t o_bstride, int batch) {
  // xe and out may be the same memory (the sweep updates its work vector in
  // place): each thread reads its xe element before it writes that element
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)batch * w) return;
  const int64_t b = tid / w;
  const int64_t j = tid - b * w;
  const float* bb = buf + b * buf_bstride;
  float s = 0.f;
  for (int k = 0; k < kmax; ++k) s += bb[t[(int64_t)k * w + j]];
  out[b * o_bstride + j] = xe[b * xe_bstride + j] - s;
}

}  // namespace

// a (m, p, q) f32 contiguous; v[b, mi, j] at v + b*v_bstride + mi*q + j;
// out[b, mi, i] at out + b*o_bstride + mi*p + i (out must not overlap v).
// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// (0 when the launch was accepted).
extern "C" int mf_stack_matvec_f32(const float* a, int m, int p, int q, const float* v,
                                   int64_t v_bstride, float* out, int64_t o_bstride,
                                   int batch, void* stream) {
  if (m <= 0 || p <= 0 || batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 1) return launch_stack_matvec<1>(a, m, p, q, v, v_bstride, out, o_bstride, batch, s);
  if (batch == 2) return launch_stack_matvec<2>(a, m, p, q, v, v_bstride, out, o_bstride, batch, s);
  if (batch <= 4) return launch_stack_matvec<4>(a, m, p, q, v, v_bstride, out, o_bstride, batch, s);
  return launch_stack_matvec<kChunk>(a, m, p, q, v, v_bstride, out, o_bstride, batch, s);
}

// buf[b, c] at buf + b*buf_bstride + c (buf[b, 0] == 0); t (kmax, w) int32
// contiguous; xe[b, j] at xe + b*xe_bstride + j; out likewise (may equal xe).
// Same launch contract as above.
extern "C" int mf_gather_sum_sub_f32(const float* buf, int64_t buf_bstride, const int* t,
                                     int kmax, int w, const float* xe, int64_t xe_bstride,
                                     float* out, int64_t o_bstride, int batch, void* stream) {
  const int64_t n = (int64_t)batch * w;
  if (n <= 0) return 0;
  gather_sum_sub_kernel<<<(unsigned)((n + kGatherThreads - 1) / kGatherThreads),
                          kGatherThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      buf, buf_bstride, t, kmax, w, xe, xe_bstride, out, o_bstride, batch);
  return (int)cudaGetLastError();
}

extern "C" const char* mf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

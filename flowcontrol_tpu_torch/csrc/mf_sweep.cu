// K2 and P1 on Hopper: the two kernels of the multifrontal solve's sweeps.
//
// K2, stack_matvec: out[b, m, p] = sum_q a[m, p, q] * v[b, m, q] over one
//   stage's padded factor stack a (m, p, q) f32 (inv, fbi or ginv) and a
//   leading batch of B right-hand sides. Replaces the TPU kernel
//   flowcontrol_tpu/ops/pallas_mf_matvec.py:79 (_mv_kernel, launched by
//   _stack_matvec :71), which took only 128-aligned p and q; this one takes
//   every stage (p, q multiples of 8 at the 56,383-dof cylinder, down to 8).
//   Two designs, by the width of the batch:
//
//   Narrow, B <= 8 (the per-stage sweep with F turned off; the single
//   stream's launches before F took them). What bounds it: one
//   multiply-add per element of a, read once: 0.46 GB per solve at the
//   cylinder, 0.137 ms at the H100's 3.35 TB/s, and at single stream the
//   latency of memory and of the launch (one launch moves ~8 MB, 2.4 us at
//   bandwidth). Design: one block per (tile of 8 output rows, node m);
//   v[b, m, :] for up to 8 right-hand sides sits in shared memory (q <=
//   ~1.5k floats: under 48 KB); each warp computes one whole row with
//   coalesced 16-byte loads of a, all eight of a 1024-float chunk in flight
//   per lane before their FMAs (4-byte loads when q % 4 != 0), and a
//   fixed-order warp-shuffle reduction.
//
//   Wide, B > 8 (the batched paths: B = 64 at the cavity, 256 at the
//   cylinder). Per node m this is a product out[:, m, :]^T (p x B) =
//   a[m] (p x q) . v[:, m, :]^T (q x B). What bounds it: the FMAs, 2 p q B
//   flops per node: 58.8 GFLOP per solve at the cylinder's B = 256 (0.878
//   ms at the 67 TFLOP/s f32 rate), 28.1 GFLOP at the cavity's B = 64
//   (0.419 ms); the stacks, 0.46 and 0.88 GB, take 0.14 and 0.26 ms to
//   read. The narrow design re-read every row of a once per 8 right-hand
//   sides and issued one shared-memory load per four FMAs: 25.17 ms and
//   10.36 ms per solve, 2.3-2.7 TFLOP/s, against torch.bmm's 2.22 and 2.07
//   ms (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py phases 7 and 20).
//   Design: a tiled product. A block is SK groups of 128 threads and owns
//   one tile of 64 right-hand sides x 16 TM rows of one node; the
//   right-hand-side tiles of one (node, row tile) are launched next to each
//   other, so the second read of an a tile hits L2. Each group stages its
//   chunks of 16 values of q of the a tile and of the v tile in shared
//   memory through a ring of three buffers filled by cp.async (16-byte .cg
//   copies), so two chunks are in flight while one is multiplied; each
//   thread keeps TM x 8 accumulators, and per four values of q makes 8 + TM
//   16-byte shared loads for 32 TM FMAs (TM = 8: balanced with the shared
//   memory's rate). The launch takes the largest row tile (128, 64, 32)
//   that keeps three quarters of the SMs busy, and splits q over SK = 1, 2
//   or 4 groups of the block, the most whose blocks still fit the card in
//   one wave (an SM holds four groups): a stage of a few nodes has few
//   tiles at B = 64. Group g takes the chunks g, g + SK, ...; at the end
//   group 0 adds the other groups' sums in the order g = 1, 2, .. . No
//   atomics and no split across blocks, so two calls give the same bits.
//   Rows, right-hand sides and q past their ends are zero-filled by the
//   copy (never read past p, q or the batch); v and a whose rows are not
//   16-byte aligned (never on the sweep's paths) take one tile shape with
//   4-byte copies. Full f32 FMAs: no TF32, no tensor cores (the repo's f32
//   pin).
//
// P1, sweep_gather: the batched sweep's one gather kernel. Over a list of
//   segments s (out offset o_s, width w_s, depth kmax_s, an int32 table
//   t_s (kmax_s, w_s)) it computes, for every right-hand side b,
//     the inbox form:  out[b, o_s + j] = xe[b, o_s + j] - sum_k src[b, t_s[k, j]]
//                      (the sum a chain from 0 in k order, then one
//                      subtraction: the bits of gather_sum_sub below);
//     the gather form: out[b, o_s + j] = src[b, t_s[0, j]] (kmax_s = 1, no xe),
//   where an index past src's row (>= n_src) reads 0: the zero sentinel of
//   the entry permutation's pad slots. It replaces the TPU probe
//   tools/pallas_gather_probe.py:50 (take_2d_table, k_take), the primitive
//   of the JAX sweep's _gather_sum0 (flowcontrol_tpu/solvers/multifrontal.py
//   :1343) and of its boundary gather (:1303), and takes, per solve: one
//   launch per stage with an inbox (all its segments), one boundary gather
//   per stage, and the entry and exit permutations.
//   What bounds it: bytes. At the 56,383-dof cylinder and B = 256 a solve's
//   gathers move ~0.5 GB (the entry and exit permutations ~115 MB each, the
//   boundary gathers ~63 MB, the inbox ~47 MB), 0.15 ms at 3.35 TB/s; each
//   launch is a few microseconds of latency at the narrow stages. The
//   per-segment kernel below (one thread per (b, j), one launch per inbox
//   segment) read the table once per right-hand side (~45 MB from L2 a
//   solve), and the sweep's other gathers went through torch's index
//   kernel with an int64 index per output element.
//   Design: a block of 8 warps owns a tile of kGatherCols = 128 columns of
//   one segment and a slab of kGatherSlab = 8 right-hand sides; it stages
//   its tile of the table in shared memory (cp.async, 16-byte pieces where
//   the rows are 16-byte aligned, in chunks of kGatherK rows of k) once and
//   reuses it for the whole slab. Lane l of warp w takes columns l + 32 c
//   (c < 4) of row w: a warp reads 32 consecutive table entries of one row
//   of src at a time (runs of consecutive entries coalesce) and writes 32
//   consecutive outputs; each of a thread's 4 sums takes its k values in
//   order, the 4 loads of one k issued together and the k loop unrolled by
//   4. The narrow per-stage launches (a few hundred to a few thousand
//   columns) want many blocks, the permutations (64k columns) many loads
//   in flight per thread: a scratch A/B of tiles of 32-128 columns and
//   slabs of 8-32 on the H100 chose this shape for both. A segment's tiles
//   follow the previous segment's in the grid (its descriptor holds its
//   first tile). No atomics: two calls give the same bits.
//
// gather_sum_sub (the earlier P1, kept as the sweep's reference order):
//   one inbox segment, one thread per (b, j) summing its column in k order:
//   out[b, j] = xe[b, j] - sum_k buf[b, t[k, j]].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = kWarps;  // output rows per block: one per warp
constexpr int kLoads = 8;      // 16-byte loads of a in flight per lane
constexpr int kChunk = 8;      // most right-hand sides per pass over a
constexpr int kGatherThreads = 256;

// P1's tiles
constexpr int kGatherCols = 128;  // columns of one block's tile: four per lane
constexpr int kGatherSlab = 8;    // right-hand sides of one block's slab: one per warp
constexpr int kGatherK = 32;      // table rows (k) staged at once
// a segment's descriptor: out offset, w, kmax, table offset, first tile
constexpr int kSegWords = 5;
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kColsPer = kGatherCols / 32;         // columns of a lane
constexpr int kRowsPer = kGatherSlab / kGatherWarps;  // rows of a warp

// the wide instance's tiles
constexpr int kWideThreads = 128;  // threads of one group (a block holds SK groups)
constexpr int kTileB = 64;       // right-hand sides per block
constexpr int kTileQ = 16;       // depth of one staged chunk of q
constexpr int kRing = 3;         // chunks staged at once (two in flight)
constexpr int kLd = kTileQ + 4;  // padded tile row: conflict-free 16-byte reads
constexpr int kWideMin = kChunk + 1;  // batches the wide instance takes

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

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one 16-float column chunk [k0, k0 + 16) of TR rows of a row-major matrix
// (row i at src + i * ld, `rows` real rows, `cols` real columns) into a
// staged tile dst[TR][kLd]; the group's 128 threads (index t0) copy it in
// 16-byte pieces (VEC) or 4-byte ones. What lies past the real rows or
// columns is zero-filled (the copy reads no byte there; its address is
// src's).
template <bool VEC, int TR>
__device__ __forceinline__ void stage_chunk(float* dst, const float* src, int64_t ld,
                                            int rows, int cols, int k0, int t0) {
#pragma unroll
  for (int t = t0; t < TR * 4; t += kWideThreads) {
    const int i = t >> 2;
    const int c = k0 + 4 * (t & 3);
    float* d = dst + i * kLd + 4 * (t & 3);
    const float* s = src + (int64_t)i * ld + c;
    if (VEC) {
      const bool full = i < rows && c < cols;  // cols % 4 == 0: all four or none
      cp_async16(d, full ? s : src, full);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool full = i < rows && c + u < cols;
        cp_async4(d + u, full ? s + u : src, full);
      }
    }
  }
}

// floats of one group's ring of staged chunks (a tile of 16 TM rows and one
// of 64 right-hand sides per chunk)
__host__ __device__ constexpr int ring_floats(int tm) { return kRing * (16 * tm + kTileB) * kLd; }

// The wide instance: one block of SK groups of 128 threads per (tile of
// kTileB = 64 right-hand sides, tile of 16 TM rows, node); grid
// (ceil(B / 64), ceil(p / (16 TM)), m). Group g multiplies the chunks of q
// with index = g (mod SK), each thread keeping TM x 8 accumulators (rows
// tr + 16 i, i < TM; right-hand sides tc + 8 j, j < 8); at the end group 0
// adds the other groups' sums to its own in the order g = 1, 2, .. and
// stores. A warp covers 4 row groups x 8 right-hand-side groups: each
// quarter-warp's 16-byte shared loads are one broadcast word (a) or 8
// consecutive padded rows in distinct banks (v). Per 4 values of q a thread
// makes 8 + TM 16-byte shared loads for 32 TM FMAs. Dynamic shared memory:
// SK rings of ring_floats(TM) floats. VEC: a's and v's rows are 16-byte
// aligned (q % 4 == 0), so the copies move 16-byte pieces.
template <bool VEC, int TM, int SK>
__global__ void __launch_bounds__(kWideThreads * SK, 4 / SK)
    stack_matmul_kernel(const float* __restrict__ a, int p, int q,
                        const float* __restrict__ v, int64_t v_bstride,
                        float* __restrict__ out, int64_t o_bstride, int batch) {
  constexpr int kRowsT = 16 * TM;
  constexpr int kStage = (kRowsT + kTileB) * kLd;  // floats of one staged chunk
  extern __shared__ float4 smem4[];
  const int g = threadIdx.x / kWideThreads, t0 = threadIdx.x % kWideThreads;
  float* ring = reinterpret_cast<float*>(smem4) + g * ring_floats(TM);
  const int b0 = blockIdx.x * kTileB;
  const int row0 = blockIdx.y * kRowsT;
  const int mi = blockIdx.z;
  const float* at = a + ((int64_t)mi * p + row0) * q;
  const float* vt = v + (int64_t)b0 * v_bstride + (int64_t)mi * q;
  const int rows = min(kRowsT, p - row0);
  const int nb = min(kTileB, batch - b0);

  const int warp = t0 >> 5, lane = t0 & 31;
  const int tr = warp * 4 + (lane >> 3);
  const int tc = lane & 7;
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // the group's chunks are g, g + SK, ...: nk_g of them
  const int nk = (q + kTileQ - 1) / kTileQ;
  const int rounds = (nk + SK - 1) / SK;
  auto stage = [&](int slot, int kt) {
    const int chunk = kt * SK + g;
    if (chunk < nk) {
      float* st = ring + slot * kStage;
      stage_chunk<VEC, kRowsT>(st, at, q, rows, q, chunk * kTileQ, t0);
      stage_chunk<VEC, kTileB>(st + kRowsT * kLd, vt, v_bstride, nb, q, chunk * kTileQ, t0);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int sl = 0; sl < kRing - 1; ++sl) {
    if (sl < rounds) {
      stage(sl, sl);
    } else {
      cp_async_commit();
    }
  }
  for (int kt = 0; kt < rounds; ++kt) {
    cp_async_wait<kRing - 2>();  // round kt has landed (this thread's copies)
    __syncthreads();             // ... and everyone's; round kt - 1 is consumed
    if (kt + kRing - 1 < rounds) {
      stage((kt + kRing - 1) % kRing, kt + kRing - 1);
    } else {
      cp_async_commit();
    }
    if (kt * SK + g >= nk) continue;  // this group has no chunk this round
    const float* ca = ring + (kt % kRing) * kStage;
    const float* cv = ca + kRowsT * kLd;
#pragma unroll
    for (int kk = 0; kk < kTileQ; kk += 4) {
      float4 y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[j] = *reinterpret_cast<const float4*>(cv + (tc + 8 * j) * kLd + kk);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(ca + (tr + 16 * i) * kLd + kk);
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // q ascending: kk, kk + 1, kk + 2, kk + 3
          acc[i][j] = fmaf(x.x, y[j].x, acc[i][j]);
          acc[i][j] = fmaf(x.y, y[j].y, acc[i][j]);
          acc[i][j] = fmaf(x.z, y[j].z, acc[i][j]);
          acc[i][j] = fmaf(x.w, y[j].w, acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (the last groups are empty)

  if (SK > 1) {  // the groups' sums meet in shared memory, in a fixed order
    __syncthreads();  // every group is done with its ring
    float* part = reinterpret_cast<float*>(smem4);  // [SK - 1][TM * 8][128]
    if (g > 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[((g - 1) * TM * 8 + i * 8 + j) * kWideThreads + t0] = acc[i][j];
    }
    __syncthreads();
    if (g > 0) return;
#pragma unroll
    for (int h = 1; h < SK; ++h)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += part[((h - 1) * TM * 8 + i * 8 + j) * kWideThreads + t0];
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int bb = tc + 8 * j;
    if (bb >= nb) continue;
    float* o = out + (int64_t)(b0 + bb) * o_bstride + (int64_t)mi * p + row0;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = tr + 16 * i;
      if (r < rows) o[r] = acc[i][j];
    }
  }
}

int g_sms = 0;  // SMs of the current device, read on the first wide launch

template <bool VEC, int TM, int SK>
int launch_tile(dim3 grid, const float* a, int p, int q, const float* v, int64_t v_bstride,
                float* out, int64_t o_bstride, int batch, cudaStream_t stream) {
  const int smem = SK * ring_floats(TM) * (int)sizeof(float);
  static bool opted = false;  // dynamic shared memory past 48 KB, once per instance
  if (!opted && smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(stack_matmul_kernel<VEC, TM, SK>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  opted = true;
  stack_matmul_kernel<VEC, TM, SK><<<grid, kWideThreads * SK, smem, stream>>>(
      a, p, q, v, v_bstride, out, o_bstride, batch);
  return (int)cudaGetLastError();
}

template <bool VEC, int TM>
int launch_split(int64_t tiles, dim3 grid, const float* a, int p, int q, const float* v,
                 int64_t v_bstride, float* out, int64_t o_bstride, int batch,
                 cudaStream_t stream) {
  // an SM holds 4 groups of 128 threads (registers and shared memory): the
  // largest split of q whose blocks all fit in one wave
  if (tiles <= g_sms) return launch_tile<VEC, TM, 4>(grid, a, p, q, v, v_bstride, out, o_bstride, batch, stream);
  if (tiles <= 2 * g_sms) return launch_tile<VEC, TM, 2>(grid, a, p, q, v, v_bstride, out, o_bstride, batch, stream);
  return launch_tile<VEC, TM, 1>(grid, a, p, q, v, v_bstride, out, o_bstride, batch, stream);
}

int launch_stack_matmul(const float* a, int m, int p, int q, const float* v, int64_t v_bstride,
                        float* out, int64_t o_bstride, int batch, cudaStream_t stream) {
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  // rows per tile: the most (128, then 64, then 32) that still keep three
  // quarters of the SMs busy (a stage of a few nodes at B = 64 has few
  // 128-row tiles); each shared load then feeds the most FMAs
  const unsigned bx = (unsigned)((batch + kTileB - 1) / kTileB);
  auto tiles = [&](int tm) { return (int64_t)bx * ((p + 16 * tm - 1) / (16 * tm)) * m; };
  auto grid = [&](int tm) { return dim3(bx, (unsigned)((p + 16 * tm - 1) / (16 * tm)), (unsigned)m); };
  const int64_t busy = (3 * (int64_t)g_sms) / 4;
  if (tiles(8) >= busy) return launch_split<true, 8>(tiles(8), grid(8), a, p, q, v, v_bstride, out, o_bstride, batch, stream);
  if (tiles(4) >= busy) return launch_split<true, 4>(tiles(4), grid(4), a, p, q, v, v_bstride, out, o_bstride, batch, stream);
  return launch_split<true, 2>(tiles(2), grid(2), a, p, q, v, v_bstride, out, o_bstride, batch, stream);
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

// stage rows [k0, k0 + kc) of columns [j0, j0 + kGatherCols) of the table t
// (kmax, w), row-major, into st[kc][kGatherCols]; columns past w are
// zero-filled (the copy reads no byte there). VEC: t and w are multiples
// of 4 ints, so the rows are 16-byte aligned and the copies 16-byte pieces.
template <bool VEC>
__device__ __forceinline__ void stage_table(int* st, const int* t, int w, int k0, int kc, int j0) {
  constexpr int kPer = VEC ? 4 : 1;  // ints of one copy
  constexpr int kRowCopies = kGatherCols / kPer;
  for (int i = threadIdx.x; i < kc * kRowCopies; i += kGatherThreads) {
    const int kk = i / kRowCopies;
    const int c = kPer * (i - kk * kRowCopies);
    const bool full = j0 + c < w;  // VEC: w % 4 == 0, so all four or none
    const int* g = full ? t + (int64_t)(k0 + kk) * w + j0 + c : t;
    float* d = reinterpret_cast<float*>(st + kk * kGatherCols + c);
    if (VEC) {
      cp_async16(d, reinterpret_cast<const float*>(g), full);
    } else {
      cp_async4(d, reinterpret_cast<const float*>(g), full);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// P1 (see the note at the top). Grid (tiles of all segments, slabs of
// kGatherSlab right-hand sides); desc[s * kSegWords + ...] = (out offset,
// w, kmax, table offset, first tile) of segment s, in tile order. xe null:
// the gather form (kmax 1). xe and out may be the same memory (the sweep
// updates its work vector in place): each element is read, then written,
// by one thread.
__global__ void __launch_bounds__(kGatherThreads)
    sweep_gather_kernel(const int* __restrict__ desc, int n_segs, const int* __restrict__ tables,
                        const float* __restrict__ src, int64_t src_bstride, int n_src,
                        const float* xe, int64_t xe_bstride, float* out, int64_t o_bstride,
                        int batch) {
  __shared__ __align__(16) int st[kGatherK * kGatherCols];
  int s = 0;  // the block's segment: the last one whose first tile is at or before it
  while (s + 1 < n_segs && desc[(s + 1) * kSegWords + 4] <= (int)blockIdx.x) ++s;
  const int* d = desc + s * kSegWords;
  const int o_off = d[0], w = d[1], kmax = d[2], t_off = d[3];
  const int j0 = ((int)blockIdx.x - d[4]) * kGatherCols;
  const int* t = tables + t_off;
  const bool vec = ((t_off | w) & 3) == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.y * kGatherSlab + warp;  // rows b0 + kGatherWarps r
  bool col_ok[kColsPer];  // columns lane + 32 c
#pragma unroll
  for (int c = 0; c < kColsPer; ++c) col_ok[c] = j0 + lane + 32 * c < w;

  if (xe == nullptr) {  // the gather form: one table row
    if (vec) {
      stage_table<true>(st, t, w, 0, 1, j0);
    } else {
      stage_table<false>(st, t, w, 0, 1, j0);
    }
#pragma unroll
    for (int r = 0; r < kRowsPer; ++r) {
      const int b = b0 + kGatherWarps * r;
      if (b >= batch) break;
#pragma unroll
      for (int c = 0; c < kColsPer; ++c) {
        if (!col_ok[c]) continue;
        const int j = lane + 32 * c;
        const int idx = st[j];
        out[(int64_t)b * o_bstride + o_off + j0 + j] =
            idx < n_src ? __ldg(src + (int64_t)b * src_bstride + idx) : 0.f;
      }
    }
    return;
  }

  float acc[kRowsPer][kColsPer];
#pragma unroll
  for (int r = 0; r < kRowsPer; ++r)
#pragma unroll
    for (int c = 0; c < kColsPer; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < kmax; k0 += kGatherK) {
    const int kc = min(kGatherK, kmax - k0);
    if (k0 > 0) __syncthreads();  // the previous chunk is consumed
    if (vec) {
      stage_table<true>(st, t, w, k0, kc, j0);
    } else {
      stage_table<false>(st, t, w, k0, kc, j0);
    }
#pragma unroll 4
    for (int kk = 0; kk < kc; ++kk) {
      int idx[kColsPer];
#pragma unroll
      for (int c = 0; c < kColsPer; ++c) idx[c] = st[kk * kGatherCols + lane + 32 * c];
      float v[kRowsPer][kColsPer];
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r) {  // all loads of this k before the adds
        const float* sb = src + (int64_t)min(b0 + kGatherWarps * r, batch - 1) * src_bstride;
#pragma unroll
        for (int c = 0; c < kColsPer; ++c) v[r][c] = idx[c] < n_src ? __ldg(sb + idx[c]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r)
#pragma unroll
        for (int c = 0; c < kColsPer; ++c) acc[r][c] += v[r][c];
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPer; ++r) {
    const int b = b0 + kGatherWarps * r;
    if (b >= batch) break;
#pragma unroll
    for (int c = 0; c < kColsPer; ++c) {
      if (!col_ok[c]) continue;
      const int64_t j = o_off + j0 + lane + 32 * c;
      out[(int64_t)b * o_bstride + j] = xe[(int64_t)b * xe_bstride + j] - acc[r][c];
    }
  }
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
  if (batch < kWideMin) {
    return launch_stack_matvec<kChunk>(a, m, p, q, v, v_bstride, out, o_bstride, batch, s);
  }
  if (q <= 0) return (int)cudaErrorInvalidValue;  // the wrapper zero-fills out itself
  const bool vec = (q % 4) == 0 && (reinterpret_cast<uintptr_t>(a) % 16) == 0 &&
                   (v_bstride % 4) == 0 && (reinterpret_cast<uintptr_t>(v) % 16) == 0;
  if (vec) return launch_stack_matmul(a, m, p, q, v, v_bstride, out, o_bstride, batch, s);
  // rows not 16-byte aligned (never on the sweep's paths): one tile shape
  // with 4-byte copies
  const dim3 grid((unsigned)((batch + kTileB - 1) / kTileB), (unsigned)((p + 63) / 64), (unsigned)m);
  return launch_tile<false, 4, 1>(grid, a, p, q, v, v_bstride, out, o_bstride, batch, s);
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

// P1 over the n_segs segments desc[0 .. n_segs) (int32, kSegWords each,
// their first tiles ascending from 0; n_tiles tiles in all), tables their
// flat int32 table; src[b, c] at src + b*src_bstride + c for c < n_src (an
// index >= n_src reads 0); xe (null: the gather form) and out as
// above. Same launch contract as above.
extern "C" int mf_sweep_gather_f32(const int* desc, int n_segs, int n_tiles, const int* tables,
                                   const float* src, int64_t src_bstride, int n_src,
                                   const float* xe, int64_t xe_bstride, float* out,
                                   int64_t o_bstride, int batch, void* stream) {
  if (n_tiles <= 0 || batch <= 0) return 0;
  const dim3 grid((unsigned)n_tiles, (unsigned)((batch + kGatherSlab - 1) / kGatherSlab));
  sweep_gather_kernel<<<grid, kGatherThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      desc, n_segs, tables, src, src_bstride, n_src, xe, xe_bstride, out, o_bstride, batch);
  return (int)cudaGetLastError();
}

// P1's tile width, which the descriptors' first tiles count in
extern "C" int mf_gather_cols() { return kGatherCols; }

extern "C" const char* mf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

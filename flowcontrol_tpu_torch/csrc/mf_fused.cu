// F on Hopper: the whole multifrontal solve in one cooperative launch, and
// its primitives P2, P3 and P4 as small kernels of their own.
//
// F, fused_solve: x = A^-1 b from a MultifrontalLU factor for 1 to 8
//   right-hand sides (rows) of b (rows, n) f32. It replaces the JAX
//   package's per-stage sweep (flowcontrol_tpu/solvers/multifrontal.py:
//   multifrontal_solve, ~lines 1202-1385; the port's per-stage counterpart
//   is solvers/multifrontal.py: multifrontal_solve, K2 and P1 per stage) and
//   is the whole-sweep kernel the TPU probes tools/pallas_gather_probe.py
//   could not build in Mosaic (docs/tpu-design.md). Its parts are the
//   probes' patterns:
//     P1 take_2d_table            -> the inbox gather-sum of every stage;
//     P2 take_along_axis_lanes    -> take_lane: the entry and exit
//                                    permutations and the gather of the
//                                    ancestors' bd slots;
//     P3 dynamic_slice_smem_offset -> slice_load: each stage's slices of x, z
//                                    and the buffer, at offsets read at run
//                                    time from the stage descriptor array
//                                    (staged in shared memory, the SMEM of
//                                    the probe);
//     P4 dynamic_offset_accum_store -> accum_store: x[stage] -= ginv·xb and
//                                    xe -= inbox sum, written as += of the
//                                    negated value (the same bits).
//   One launch: the grid is the SM count times the occupancy calculator's
//   blocks per SM, launched with cudaLaunchCooperativeKernel (one kernel
//   instance per accumulator count 1, 2, 4, 8, so the single stream keeps
//   one accumulator per thread and fits more blocks per SM); dependent
//   phases are separated by cooperative_groups grid syncs (a grid too large
//   to be co-resident is refused at launch, never hung). Each phase is a
//   grid-stride loop: the matvecs give one warp to one row of the stage's
//   stack (every node of every stage shape, leaf stages of hundreds of small
//   fronts and root stages of one large front alike) and compute all rows of
//   b from one read of that row; z = inv·xe goes to a scratch z, never in
//   place, because other warps still read xe. Products are f32 FMAs in a
//   fixed order with a fixed butterfly reduction and no atomics: two calls
//   give the same bits. No tensor cores (the f32 pin). Data written inside
//   the launch is read through L2 (__ldcg), since L1 is not coherent across
//   SMs; the factor and the tables through the read-only path (__ldg).
//
//   What bounds it: one read of the factor stacks. At the 56,383-dof
//   cylinder that is 0.4606 GB, 0.1375 ms at the H100's 3.35 TB/s; the
//   vectors, tables and buffer are a few MB. In this first version the
//   grid syncs (about 3 per stage forward and 1 back) and one row per warp
//   with one 16-byte load in flight per lane keep it well above that.
//
// Offsets into the flat stacks and tables are 64-bit. The stage record
// layout is ops/mf_fused.py's HEAD_FIELDS / SEG_FIELDS / MAX_SEGS.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;
enum Head { kE, kB, kM, kOff, kCOff, kInv, kGinv, kFbi, kBd, kNSegs, kHeadWords };
enum Seg { kM0, kM1, kTabbed, kInbox, kKmax, kSegWords };
constexpr int kMaxSegs = 4;
constexpr int kStageWords = kHeadWords + kMaxSegs * kSegWords;

typedef long long i64;

// ── the probes' primitives, as F uses them ───────────────────────────────────

// P2: one lane of a gather along a row, row[idx]
__device__ __forceinline__ float take_lane(const float* row, i64 idx) { return __ldcg(row + idx); }

// P3: element j of the slice of v at the runtime offset s
__device__ __forceinline__ float slice_load(const float* v, i64 s, i64 j) {
  return __ldcg(v + s + j);
}

// P4: o[s + j] += val, an accumulating store at the runtime offset s
__device__ __forceinline__ void accum_store(float* o, i64 s, i64 j, float val) {
  float* p = o + s + j;
  *p = __ldcg(p) + val;
}

template <int R>
__device__ __forceinline__ void warp_sum(float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
  }
}

// acc[r] = sum_q a[q] * v[r*vs + q] for r < rows <= R, q < Q, by one warp.
// Q % 4 == 0 and a, v and vs 16-byte aligned; each lane takes every 32nd
// float4.
template <int R>
__device__ __forceinline__ void warp_dot(const float* __restrict__ a, const float* v, i64 vs,
                                         int Q, int rows, int lane, float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const int n4 = Q >> 2;
#pragma unroll 4
  for (int j = lane; j < n4; j += 32) {
    const float4 w = __ldg(a4 + j);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) {
        const float4 s = __ldcg(reinterpret_cast<const float4*>(v + r * vs) + j);
        acc[r] = fmaf(w.x, s.x, acc[r]);
        acc[r] = fmaf(w.y, s.y, acc[r]);
        acc[r] = fmaf(w.z, s.z, acc[r]);
        acc[r] = fmaf(w.w, s.w, acc[r]);
      }
    }
  }
  warp_sum(acc);
}

// acc[r] = sum_q a[q] * v[r*vs + idx[q]]: the same with the vector gathered (P2)
template <int R>
__device__ __forceinline__ void warp_dot_gather(const float* __restrict__ a,
                                                const i64* __restrict__ idx, const float* v,
                                                i64 vs, int Q, int rows, int lane,
                                                float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const int n4 = Q >> 2;
#pragma unroll 2
  for (int j = lane; j < n4; j += 32) {
    const float4 w = __ldg(a4 + j);
    const i64 i0 = __ldg(idx + 4 * j), i1 = __ldg(idx + 4 * j + 1);
    const i64 i2 = __ldg(idx + 4 * j + 2), i3 = __ldg(idx + 4 * j + 3);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) {
        const float* vr = v + r * vs;
        acc[r] = fmaf(w.x, take_lane(vr, i0), acc[r]);
        acc[r] = fmaf(w.y, take_lane(vr, i1), acc[r]);
        acc[r] = fmaf(w.z, take_lane(vr, i2), acc[r]);
        acc[r] = fmaf(w.w, take_lane(vr, i3), acc[r]);
      }
    }
  }
  warp_sum(acc);
}

struct FusedArgs {
  const i64* desc;
  int n_stages;
  const float* stacks;
  const i64* bd;
  const int* inbox;
  const i64* perm;
  const i64* ipos;
  const float* b;
  float* out;
  float* x;
  float* z;
  float* buf;
  int rows;
  i64 n, total, xs, zs, bs;
};

// the stage's descriptor words into shared memory (the block reads its
// offsets there, as the probe reads its offset from SMEM)
__device__ __forceinline__ void load_stage(const i64* desc, int si, i64* sd) {
  __syncthreads();
  if (threadIdx.x < kStageWords) sd[threadIdx.x] = __ldg(desc + (i64)si * kStageWords + threadIdx.x);
  __syncthreads();
}

// one instance per accumulator count R (1, 2, 4, 8), the smallest that
// holds the rows: the single stream keeps one accumulator per thread
template <int R>
__global__ void __launch_bounds__(kThreads) fused_solve_kernel(FusedArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ i64 sd[kStageWords];
  const i64 tid = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  const i64 nthreads = (i64)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const i64 gw = tid >> 5;
  const i64 nwarps = nthreads >> 5;
  const int rows = a.rows;

  // 1. entry permutation x[r, s] = b[r, perm[s]] (P2; the pad slots and the
  //    trailing slot, perm == n, read zero) and the buffer's leading zero
  const i64 slots = a.total + 1;
  for (i64 i = tid; i < rows * slots; i += nthreads) {
    const i64 r = i / slots, s = i - r * slots;
    const i64 p = __ldg(a.perm + s);
    a.x[r * a.xs + s] = p < a.n ? take_lane(a.b + r * a.n, p) : 0.f;
  }
  if (tid < rows) a.buf[tid * a.bs] = 0.f;
  grid.sync();

  // 2. forward sweep, deepest stage first
  for (int si = 0; si < a.n_stages; ++si) {
    load_stage(a.desc, si, sd);
    const i64 e = sd[kE], bw = sd[kB], m = sd[kM], off = sd[kOff];
    // 2a. xe -= the inbox sums of the tabbed segments (P1, stored by P4)
    bool tabbed = false;
    for (int k = 0; k < (int)sd[kNSegs]; ++k) {
      const i64* sg = sd + kHeadWords + k * kSegWords;
      if (!sg[kTabbed]) continue;
      tabbed = true;
      const i64 w = (sg[kM1] - sg[kM0]) * e, kmax = sg[kKmax];
      const int* t = a.inbox + sg[kInbox];
      const i64 s0 = off + sg[kM0] * e;
      for (i64 i = tid; i < rows * w; i += nthreads) {
        const i64 r = i / w, j = i - r * w;
        const float* br = a.buf + r * a.bs;
        float acc = 0.f;
        for (i64 k2 = 0; k2 < kmax; ++k2) acc += take_lane(br, __ldg(t + k2 * w + j));
        accum_store(a.x + r * a.xs, s0, j, -acc);
      }
    }
    if (tabbed) grid.sync();
    // 2b. z = inv · xe, one warp per row of inv
    const float* inv = a.stacks + sd[kInv];
    for (i64 rw = gw; rw < m * e; rw += nwarps) {
      const i64 mi = rw / e;
      float acc[R];
      warp_dot<R>(inv + rw * e, a.x + off + mi * e, a.xs, (int)e, rows, lane, acc);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rows) a.z[r * a.zs + rw] = acc[r];
        }
      }
    }
    grid.sync();
    // 2c. the stage's boundary updates fbi · z into its slice of the buffer
    //     (the root's have no consumer), and xe <- z
    if (si < a.n_stages - 1) {
      const float* fbi = a.stacks + sd[kFbi];
      const i64 c0 = 1 + sd[kCOff];
      for (i64 rw = gw; rw < m * bw; rw += nwarps) {
        const i64 mi = rw / bw;
        float acc[R];
        warp_dot<R>(fbi + rw * e, a.z + mi * e, a.zs, (int)e, rows, lane, acc);
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r < rows) a.buf[r * a.bs + c0 + rw] = acc[r];
          }
        }
      }
    }
    const i64 me = m * e;
    for (i64 i = tid; i < rows * me; i += nthreads) {
      const i64 r = i / me, j = i - r * me;
      a.x[r * a.xs + off + j] = slice_load(a.z + r * a.zs, 0, j);
    }
    grid.sync();
  }

  // 3. backward sweep, root first: x[stage] -= ginv · x[bd] (the bd slots
  //    are strict ancestors', final since their stage's sync)
  for (int si = a.n_stages - 1; si >= 0; --si) {
    load_stage(a.desc, si, sd);
    const i64 e = sd[kE], bw = sd[kB], m = sd[kM], off = sd[kOff];
    const float* ginv = a.stacks + sd[kGinv];
    const i64* bd = a.bd + sd[kBd];
    for (i64 rw = gw; rw < m * e; rw += nwarps) {
      const i64 mi = rw / e;
      float acc[R];
      warp_dot_gather<R>(ginv + rw * bw, bd + mi * bw, a.x, a.xs, (int)bw, rows, lane, acc);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rows) accum_store(a.x + r * a.xs, off, rw, -acc[r]);
        }
      }
    }
    grid.sync();
  }

  // 4. exit permutation out[r, i] = x[r, ipos[i]] (P2)
  for (i64 i = tid; i < rows * a.n; i += nthreads) {
    const i64 r = i / a.n, k = i - r * a.n;
    a.out[i] = take_lane(a.x + r * a.xs, __ldg(a.ipos + k));
  }
}

// ── P2, P3, P4 on their own, through the device functions F uses ─────────────

__global__ void take_along_lanes_kernel(const float* v, i64 vs, const int* idx, int rows, int w,
                                        float* out) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (i64)rows * w) return;
  out[i] = take_lane(v + (i / w) * vs, __ldg(idx + i));
}

__global__ void dynamic_slice_kernel(const float* v, const int* s, int w, float* out) {
  __shared__ i64 s0;  // the runtime offset, as the probe holds it in SMEM
  if (threadIdx.x == 0) s0 = __ldg(s);
  __syncthreads();
  for (int j = threadIdx.x; j < w; j += blockDim.x) out[j] = slice_load(v, s0, j);
}

__global__ void dynamic_accum_store_kernel(float* o, const int* s, const float* v, int w) {
  __shared__ i64 s0;
  if (threadIdx.x == 0) s0 = __ldg(s);
  __syncthreads();
  for (int j = threadIdx.x; j < w; j += blockDim.x) accum_store(o, s0, j, __ldg(v + j));
}

// the cooperative grid of each instance: SMs times the occupancy
// calculator's blocks per SM, queried once per device
struct GridCache {
  int device = -1;
  int per_sm[4] = {0, 0, 0, 0};
  int sms = 0;
};
GridCache g_grid;

int instance_of(int rows) { return rows <= 1 ? 0 : rows <= 2 ? 1 : rows <= 4 ? 2 : 3; }

const void* kernel_of(int inst) {
  switch (inst) {
    case 0: return (const void*)fused_solve_kernel<1>;
    case 1: return (const void*)fused_solve_kernel<2>;
    case 2: return (const void*)fused_solve_kernel<4>;
    default: return (const void*)fused_solve_kernel<8>;
  }
}

cudaError_t fused_grid(int rows, int* blocks, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (g_grid.device != dev) {
    int coop = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return e;
    if (!coop) return cudaErrorNotSupported;
    e = cudaDeviceGetAttribute(&g_grid.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    for (int i = 0; i < 4; ++i) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g_grid.per_sm[i], kernel_of(i),
                                                        kThreads, 0);
      if (e != cudaSuccess) return e;
      if (g_grid.per_sm[i] < 1) return cudaErrorCooperativeLaunchTooLarge;
    }
    g_grid.device = dev;
  }
  const int inst = instance_of(rows);
  *per_sm = g_grid.per_sm[inst];
  *sms = g_grid.sms;
  *blocks = g_grid.per_sm[inst] * g_grid.sms;
  return cudaSuccess;
}

}  // namespace

// F's grid on the current device for `rows` right-hand sides: blocks,
// blocks per SM, SMs.
extern "C" int mf_fused_grid(int rows, int* blocks, int* per_sm, int* sms) {
  if (rows < 1 || rows > kMaxRows) return (int)cudaErrorInvalidValue;
  return (int)fused_grid(rows, blocks, per_sm, sms);
}

// desc (n_stages, stage_words) int64; stacks, bd, inbox: the factor's flat
// arrays; perm (total + 1) and ipos (n) int64; b and out (rows, n) f32
// contiguous; scratch x (rows, xs), z (rows, zs), buf (rows, bs) f32 with
// xs >= total + 1 and xs % 4 == 0, zs >= the largest stage's m·e and
// zs % 4 == 0, bs = 1 + total_contrib. One cooperative launch on `stream`;
// does not synchronise; returns cudaGetLastError() (0 when accepted).
extern "C" int mf_fused_solve_f32(const i64* desc, int n_stages, int stage_words,
                                  const float* stacks, const i64* bd, const int* inbox,
                                  const i64* perm, const i64* ipos, const float* b, float* out,
                                  float* x, float* z, float* buf, int rows, i64 n, i64 total,
                                  i64 xs, i64 zs, i64 bs, void* stream) {
  if (stage_words != kStageWords || rows < 1 || rows > kMaxRows || n_stages < 1 || xs % 4 ||
      zs % 4 || xs < total + 1) {
    return (int)cudaErrorInvalidValue;
  }
  int blocks = 0, per_sm = 0, sms = 0;
  cudaError_t e = fused_grid(rows, &blocks, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  FusedArgs a;
  a.desc = desc;
  a.n_stages = n_stages;
  a.stacks = stacks;
  a.bd = bd;
  a.inbox = inbox;
  a.perm = perm;
  a.ipos = ipos;
  a.b = b;
  a.out = out;
  a.x = x;
  a.z = z;
  a.buf = buf;
  a.rows = rows;
  a.n = n;
  a.total = total;
  a.xs = xs;
  a.zs = zs;
  a.bs = bs;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel_of(instance_of(rows)), dim3(blocks), dim3(kThreads),
                                  params, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// P2: out[r, j] = v[r*vs + idx[r*w + j]] for r < rows, j < w.
extern "C" int mf_take_along_lanes_f32(const float* v, i64 vs, const int* idx, int rows, int w,
                                       float* out, void* stream) {
  const i64 total = (i64)rows * w;
  if (total <= 0) return 0;
  take_along_lanes_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(v, vs, idx, rows, w, out);
  return (int)cudaGetLastError();
}

// P3: out[j] = v[*s + j] for j < w, the offset *s read on the device.
extern "C" int mf_dynamic_slice_f32(const float* v, const int* s, int w, float* out,
                                    void* stream) {
  if (w <= 0) return 0;
  dynamic_slice_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(v, s, w, out);
  return (int)cudaGetLastError();
}

// P4: o[*s + j] += v[j] for j < w, the offset *s read on the device.
extern "C" int mf_dynamic_accum_store_f32(float* o, const int* s, const float* v, int w,
                                          void* stream) {
  if (w <= 0) return 0;
  dynamic_accum_store_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(o, s, v, w);
  return (int)cudaGetLastError();
}

extern "C" const char* mf_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// F on Hopper: the whole multifrontal solve in one cooperative launch, and
// its primitives P2, P3 and P4 as small kernels of their own.
//
// F, fused_solve: x = A^-1 b from a MultifrontalLU factor for 1 to 8
//   right-hand sides (rows) of b (rows, n) f32. It replaces the JAX
//   package's per-stage sweep (flowcontrol_tpu/solvers/multifrontal.py:1202
//   multifrontal_solve; the port's per-stage counterpart is
//   solvers/multifrontal.py: multifrontal_solve, K2 and P1 per stage) and
//   is the whole-sweep kernel the TPU probes tools/pallas_gather_probe.py
//   could not build in Mosaic (docs/tpu-design.md). Its parts are the
//   probes' patterns:
//     P1 take_2d_table            -> the inbox gather-sum of every stage;
//     P2 take_along_axis_lanes    -> take_lane: the entry permutation and
//                                    the gather of the ancestors' bd slots;
//     P3 dynamic_slice_smem_offset -> slice_load: each stage's slices of x
//                                    and z, at offsets read at run time
//                                    from the stage descriptor array (in
//                                    shared memory, the SMEM of the probe);
//     P4 dynamic_offset_accum_store -> accum_store: z[stage] -= ginv·zb.
//
//   What bounds it: one read of the factor stacks. At the 56,383-dof
//   cylinder that is 0.4606 GB, 0.1377 ms at the H100's 3.35 TB/s; at the
//   120,068-dof cavity 0.8765 GB, 0.2627 ms; the vectors and tables are a
//   few MB. The first version ran at 20-29% of that (0.622-0.681 and
//   0.902-0.924 ms per solve at rows 1, NVIDIA H100 80GB HBM3, 700.00 W,
//   chip_smoke.py) and grew about linearly with the rows (1.91 and 2.81 ms
//   at rows 8): one 16-byte load of the stack in flight per lane, the
//   vector re-read through L2 for every row of the stack and every
//   right-hand side, and a grid sync after each of 3-4 phases per stage
//   (64 at the cylinder, 82 at the cavity), each sync and phase a few us.
//
//   Design. One block of 512 threads per SM (cudaLaunchCooperativeKernel;
//   one kernel instance per accumulator count 1, 2, 4, 8, each with 128
//   registers a thread); dependent phases are separated by
//   cooperative_groups grid syncs (a grid too large to be co-resident is
//   refused at launch, never hung), and fewer blocks make each sync
//   cheaper. The descriptors of all stages sit in shared memory for the
//   whole launch. A phase multiplies one stack of each of its stages
//   against one vector per node: a block takes a unit of (stage, node, 16
//   x RW rows), stages that node's vector for all right-hand sides in
//   shared memory once (index loads, then the gathers, several elements
//   per thread in flight together), and each warp computes RW rows from
//   it, with 8 16-byte loads of the stack in flight per lane before their
//   FMAs (RW rows x 8 / RW chunks; 4 loads at 8 right-hand sides, whose
//   accumulators take the registers; the first chunk is issued before the
//   vector is staged); every lane holds the butterfly's sums, so RW x R
//   lanes store at once. RW (4, 2 or 1) minimises an estimate of the
//   busiest block's time, so the root's single front spreads over the card.
//   Leaf stages (descriptor word leaf: no stage's bd holds one of their
//   slots) receive no inbox sums and nothing reads their results backward:
//   all of them run together, z = inv·b[perm] in one phase and their
//   updates fbi·z in the next, and their backward updates in the last
//   phase. Each other stage, deepest first: xe = b[perm] less its inbox
//   sums in one pass over the grid (once for the stage, into x), z = inv·xe
//   into a full-length vector z, and the updates fbi·z into the
//   contribution buffer. The backward sweep updates z in place, z[stage]
//   -= ginv·z[bd], and scatters each final value to the output through the
//   permutation (no copy-back, no exit pass); a stage whose bd holds no
//   real slot (descriptor word n_bd: the root) writes its z to the output
//   in the forward sweep and has no backward phase. Syncs: 24 at the
//   cylinder, 36 at the cavity (ops/mf_fused.py: grid_syncs). Products are
//   f32 FMAs, each lane over its 16-byte words in ascending order, then a
//   fixed butterfly: the same order as the per-stage sweep's K2 narrow
//   instance, and the inbox sums in the order of P1, so F equals the sweep
//   bitwise; no atomics, so two calls give the same bits. No tensor cores
//   (the f32 pin). Data written inside the launch is read through L2
//   (__ldcg), since L1 is not coherent across SMs; the factor and the
//   tables through the read-only path (__ldg). A launch given a trace
//   buffer records the card's global timer after every grid sync
//   (ops/mf_fused.py: fused_phase_times).
//
// Offsets into the flat stacks and tables are 64-bit. The stage record
// layout is ops/mf_fused.py's HEAD_FIELDS / SEG_FIELDS / MAX_SEGS.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;
// 16-byte loads of a stack in flight per lane: 8, and 4 with 8 right-hand
// sides, whose accumulators take the registers
template <int R>
constexpr int kInFlight = R >= 8 ? 4 : 8;
enum Head { kE, kB, kM, kOff, kCOff, kInv, kGinv, kFbi, kBd, kNBd, kLeaf, kNSegs, kHeadWords };
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

// P4: o[s + j] += val, an accumulating store at the runtime offset s;
// returns the value stored
__device__ __forceinline__ float accum_store(float* o, i64 s, i64 j, float val) {
  float* p = o + s + j;
  const float nv = __ldcg(p) + val;
  *p = nv;
  return nv;
}

// One warp computes RW rows of a stack against R vectors staged in shared
// memory: acc[i][r] = sum_q a[i*q + q'] * sv[r*ld + q'] for rows i < nrows
// and right-hand sides r < rows. Each lane takes every 32nd 16-byte word of
// the rows (q % 4 == 0, a 16-byte aligned), in chunks of KU words per row,
// all RW x KU loads of a chunk issued before their FMAs; then a butterfly.
// The order of the sum is that of K2's narrow instance (csrc/mf_sweep.cu).
template <int R, int RW>
using Chunk = float4[RW][kInFlight<R> / RW];

template <int R, int RW>
__device__ __forceinline__ void load_chunk(Chunk<R, RW>& w, const float4* __restrict__ a4,
                                           int nrows, int n4, int c0, int lane) {
  constexpr int KU = kInFlight<R> / RW;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int j4 = c0 + u * 32 + lane;
      w[i][u] = (i < nrows && j4 < n4) ? __ldg(a4 + (i64)i * n4 + j4)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int R, int RW>
__device__ __forceinline__ void fma_chunk(float (&acc)[RW][R], const Chunk<R, RW>& w,
                                          const float* sv, int ld, int rows, int n4, int c0,
                                          int lane) {
  constexpr int KU = kInFlight<R> / RW;
#pragma unroll
  for (int u = 0; u < KU; ++u) {
    const int j4 = c0 + u * 32 + lane;
    if (j4 < n4) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) {
          const float4 s = reinterpret_cast<const float4*>(sv + r * ld)[j4];
#pragma unroll
          for (int i = 0; i < RW; ++i) {
            acc[i][r] = fmaf(w[i][u].x, s.x, acc[i][r]);
            acc[i][r] = fmaf(w[i][u].y, s.y, acc[i][r]);
            acc[i][r] = fmaf(w[i][u].z, s.z, acc[i][r]);
            acc[i][r] = fmaf(w[i][u].w, s.w, acc[i][r]);
          }
        }
      }
    }
  }
}

struct FusedArgs {
  const i64* desc;
  int n_stages;
  const float* stacks;
  const i64* bd;
  const int* inbox;
  const i64* perm;
  const float* b;
  float* out;
  float* x;
  float* z;
  float* buf;
  int rows, ld;
  i64 n, total, zs, bs;
  unsigned long long* trace;  // null, or one time stamp per phase boundary
};

// elements of a node's vector each thread gathers at once (their index
// loads, then their R value loads, all in flight together)
template <int R>
constexpr int kGatherBatch = R <= 2 ? 4 : 2;

// sv[r*ld + j] = val(r, idx(j)) for r < rows, j < q: an index per element,
// then one value per right-hand side
template <int R, class Index, class Value>
__device__ __forceinline__ void stage_gather(float* sv, int ld, int rows, int q, Index idx,
                                             Value val) {
  constexpr int KB = kGatherBatch<R>;
  for (int j0 = threadIdx.x; j0 < q; j0 += KB * kThreads) {
    i64 ix[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const int j = j0 + k * kThreads;
      ix[k] = j < q ? idx(j) : 0;
    }
    float v[KB][R];
#pragma unroll
    for (int k = 0; k < KB; ++k)
#pragma unroll
      for (int r = 0; r < R; ++r) v[k][r] = (j0 + k * kThreads < q && r < rows) ? val(r, ix[k]) : 0.f;
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const int j = j0 + k * kThreads;
      if (j < q) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rows) sv[r * ld + j] = v[k][r];
        }
      }
    }
  }
}

// x[r, off + j] = b[r, perm[off + j]] - sum_k buf[r, t[k, j - m0 e]] for the
// stage's slots j < m e (the sum over the inbox table of the tabbed segment
// that holds j's node; P2 for b, P1 for the sum, k ascending as in the
// sweep's P1, and the subtraction as += of the negated sum), by the whole
// grid, one slot per thread. The permutation's and the table's index loads
// go out together, then the gathers of b and of KI values of k.
__device__ __forceinline__ void inbox_pass(const FusedArgs& a, const i64* sd, int rows) {
  constexpr int KI = 8;
  const i64 e = sd[kE], m = sd[kM], off = sd[kOff];
  const i64 me = m * e;
  const i64 nthreads = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < rows * me; i += nthreads) {
    const i64 r = i / me, j = i - r * me, mi = j / e;
    const int* t = nullptr;
    i64 w = 0, jj = 0, kmax = 0;
    for (int k = 0; k < (int)sd[kNSegs]; ++k) {
      const i64* sg = sd + kHeadWords + k * kSegWords;
      if (sg[kTabbed] && mi >= sg[kM0] && mi < sg[kM1]) {
        t = a.inbox + sg[kInbox];
        w = (sg[kM1] - sg[kM0]) * e;
        jj = j - sg[kM0] * e;
        kmax = sg[kKmax];
      }
    }
    const i64 pp = __ldg(a.perm + off + j);
    int tix[KI];
#pragma unroll
    for (int u = 0; u < KI; ++u) tix[u] = u < kmax ? __ldg(t + u * w + jj) : 0;
    float val = pp < a.n ? take_lane(a.b + r * a.n, pp) : 0.f;
    if (t != nullptr) {
      const float* br = a.buf + r * a.bs;
      float acc = 0.f;
      for (i64 k0 = 0; k0 < kmax; k0 += KI) {
        if (k0 > 0) {
#pragma unroll
          for (int u = 0; u < KI; ++u) tix[u] = k0 + u < kmax ? __ldg(t + (k0 + u) * w + jj) : 0;
        }
#pragma unroll
        for (int u = 0; u < KI; ++u) {
          if (k0 + u < kmax) acc += take_lane(br, tix[u]);  // P1
        }
      }
      val = val + -acc;
    }
    a.x[r * a.zs + off + j] = val;
  }
}

// The stages one phase covers: stage `first` alone, or every leaf stage
// (descriptor word leaf: no stage's bd holds one of its slots) in
// [first, last]; and which of their stacks it multiplies.
enum Kind { kInvStack, kFbiStack, kGinvStack };
struct PhaseSet {
  int first, last;
  bool leaves;
  Kind kind;
};

__device__ __forceinline__ bool in_set(const PhaseSet& ps, const i64* sd) {
  return !ps.leaves || sd[kLeaf] != 0;
}

// the stack of the phase's kind in stage sd: rows p, columns q, offset
__device__ __forceinline__ void stack_of(const PhaseSet& ps, const i64* sd, int& p, int& q,
                                         i64& off) {
  const int e = (int)sd[kE], b = (int)sd[kB];
  p = ps.kind == kFbiStack ? b : e;
  q = ps.kind == kGinvStack ? b : e;
  off = ps.kind == kInvStack ? sd[kInv] : ps.kind == kFbiStack ? sd[kFbi] : sd[kGinv];
}

// One phase: each stage's stack (m, p, q) of the set against, per node mi,
// a vector that stage(sv, sd, mi) stages in shared memory sv (R rows of ld
// floats); store(sd, r, mi, i, acc) takes row i's result. A unit is
// (stage, node, kWarps x RW rows); blocks stride over the units of all the
// set's stages. Each warp issues its first chunk of loads of the stack
// before the vector is staged, so the two round trips to memory overlap.
template <int R, int RW, class Stage, class Store>
__device__ __forceinline__ void stack_phase_rw(const float* __restrict__ stacks,
                                               const i64* sdesc, const PhaseSet& ps, int rows,
                                               int ld, float* sv, Stage stage, Store store) {
  constexpr int KU = kInFlight<R> / RW;
  constexpr int kTile = kWarps * RW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  i64 total = 0;
  for (int si = ps.first; si <= ps.last; ++si) {
    const i64* sd = sdesc + si * kStageWords;
    if (!in_set(ps, sd)) continue;
    int p, q;
    i64 off;
    stack_of(ps, sd, p, q, off);
    total += sd[kM] * ((p + kTile - 1) / kTile);
  }
  for (i64 u = blockIdx.x; u < total; u += gridDim.x) {
    // the unit's stage, node and rows
    const i64* sd = sdesc;
    int p = 0, q = 0;
    i64 off = 0, uu = u, tiles = 1;
    for (int si = ps.first; si <= ps.last; ++si) {
      sd = sdesc + si * kStageWords;
      if (!in_set(ps, sd)) continue;
      stack_of(ps, sd, p, q, off);
      tiles = (p + kTile - 1) / kTile;
      if (uu < sd[kM] * tiles) break;
      uu -= sd[kM] * tiles;
    }
    const i64 mi = uu / tiles;
    const int row0 = (int)(uu - mi * tiles) * kTile + warp * RW;
    const int nrows = max(0, min(RW, p - row0));
    const int n4 = q >> 2;
    const float4* a4 =
        reinterpret_cast<const float4*>(stacks + off + (mi * p + min(row0, p - 1)) * q);
    Chunk<R, RW> w;
    load_chunk<R, RW>(w, a4, nrows, n4, 0, lane);
    __syncthreads();  // every warp is done with the previous unit's vector
    stage(sv, sd, mi);
    __syncthreads();
    if (nrows > 0) {
      float acc[RW][R];
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[i][r] = 0.f;
      for (int c0 = 0; c0 < n4; c0 += 32 * KU) {
        if (c0 > 0) load_chunk<R, RW>(w, a4, nrows, n4, c0, lane);
        fma_chunk<R, RW>(acc, w, sv, ld, rows, n4, c0, lane);
      }
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) acc[i][r] += __shfl_xor_sync(0xffffffffu, acc[i][r], o);
      // every lane holds every sum (the butterfly's result is the same in
      // all lanes); lane i R + r stores row i's result for right-hand side r
      float val = 0.f;
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (lane == i * R + r) val = acc[i][r];
        }
      const int li = lane / R, lr = lane % R;
      if (lane < RW * R && li < nrows && lr < rows) store(sd, lr, mi, row0 + li, val);
    }
  }
}

// rows per warp RW (4, 2 or 1): the least estimated time of the busiest
// block, rounds of units x the round trips to memory of one unit (two for
// the vector, one per chunk of the stack) plus its reads of the staged
// vector (R q floats per warp, ~3,000 per round trip); a tie goes to the
// larger RW
template <int R, class Stage, class Store>
__device__ __forceinline__ void stack_phase(const float* __restrict__ stacks, const i64* sdesc,
                                            const PhaseSet& ps, int rows, int ld, float* sv,
                                            Stage stage, Store store) {
  auto cost = [&](int rw) {
    i64 units = 0, chunks = 0, qmax = 0;
    for (int si = ps.first; si <= ps.last; ++si) {
      const i64* sd = sdesc + si * kStageWords;
      if (!in_set(ps, sd)) continue;
      int p, q;
      i64 off;
      stack_of(ps, sd, p, q, off);
      units += sd[kM] * ((p + kWarps * rw - 1) / (kWarps * rw));
      chunks = max(chunks, (i64)(((q >> 2) * rw + 32 * kInFlight<R> - 1) / (32 * kInFlight<R>)));
      qmax = max(qmax, (i64)q);
    }
    const i64 rounds = (units + gridDim.x - 1) / gridDim.x;
    return rounds * (6000 + 3000 * chunks + R * qmax);
  };
  const i64 c4 = cost(4), c2 = cost(2), c1 = cost(1);
  if (c4 <= c2 && c4 <= c1) {
    stack_phase_rw<R, 4>(stacks, sdesc, ps, rows, ld, sv, stage, store);
  } else if (c2 <= c1) {
    stack_phase_rw<R, 2>(stacks, sdesc, ps, rows, ld, sv, stage, store);
  } else {
    stack_phase_rw<R, 1>(stacks, sdesc, ps, rows, ld, sv, stage, store);
  }
}

__device__ __forceinline__ bool has_tabbed(const i64* sd) {
  bool t = false;
  for (int k = 0; k < (int)sd[kNSegs]; ++k) t |= sd[kHeadWords + k * kSegWords + kTabbed] != 0;
  return t;
}

// the time at a phase boundary, kept by one thread when tracing
__device__ __forceinline__ void mark(unsigned long long* trace, int& k) {
  if (trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    trace[k] = t;
  }
  ++k;
}

// bytes of the dynamic shared memory: every stage's descriptor words, then
// one node's vector (R rows of ld floats)
__host__ __device__ constexpr size_t desc_bytes(int n_stages) {
  return ((size_t)n_stages * kStageWords * sizeof(i64) + 15) / 16 * 16;
}

// one instance per accumulator count R (1, 2, 4, 8), the smallest that
// holds the rows
template <int R>
__global__ void __launch_bounds__(kThreads, 1) fused_solve_kernel(FusedArgs args) {
  cg::grid_group grid = cg::this_grid();
  const FusedArgs& a = args;  // the phases' lambdas read the arguments through it
  extern __shared__ float4 dyn[];
  // every stage's descriptor words (the block reads its offsets there, as
  // the probe reads its offset from SMEM), then one node's vector [R][ld]
  i64* sdesc = reinterpret_cast<i64*>(dyn);
  float* sv = reinterpret_cast<float*>(reinterpret_cast<char*>(dyn) + desc_bytes(a.n_stages));
  const i64 tid = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  const int rows = a.rows;
  const int last = a.n_stages - 1;
  int tk = 0;
  mark(a.trace, tk);
  for (int i = threadIdx.x; i < a.n_stages * kStageWords; i += kThreads) sdesc[i] = __ldg(a.desc + i);

  // the buffer's leading zero (the inbox pads read it) and z's trailing
  // zero slot (the bd pads read it); both are read only after a sync
  if (tid < rows) {
    a.buf[tid * a.bs] = 0.f;
    a.z[tid * a.zs + a.total] = 0.f;
  }
  __syncthreads();

  // the phases' vectors and results
  auto z_from_b = [&](float* v, const i64* sd, i64 mi) {  // P2: the entry permutation
    const i64 e = sd[kE], off = sd[kOff];
    stage_gather<R>(
        v, a.ld, rows, (int)e, [&](int j) { return __ldg(a.perm + off + mi * e + j); },
        [&](int r, i64 pp) { return pp < a.n ? take_lane(a.b + r * a.n, pp) : 0.f; });
  };
  auto z_from_x = [&](float* v, const i64* sd, i64 mi) {  // P3: xe less its inbox sums
    const i64 e = sd[kE], off = sd[kOff];
    stage_gather<R>(v, a.ld, rows, (int)e, [&](int j) { return (i64)j; },
                    [&](int r, i64 j) { return slice_load(a.x + r * a.zs, off + mi * e, j); });
  };
  auto store_z = [&](const i64* sd, int r, i64 mi, int i, float v) {
    const i64 s = sd[kOff] + mi * sd[kE] + i;
    a.z[r * a.zs + s] = v;
    if (sd[kNBd] == 0) {  // no backward phase: z is final
      const i64 pp = __ldg(a.perm + s);
      if (pp < a.n) a.out[r * a.n + pp] = v;
    }
  };
  auto z_slice = [&](float* v, const i64* sd, i64 mi) {  // P3: the node's z
    const i64 e = sd[kE], off = sd[kOff];
    stage_gather<R>(v, a.ld, rows, (int)e, [&](int j) { return (i64)j; },
                    [&](int r, i64 j) { return slice_load(a.z + r * a.zs, off + mi * e, j); });
  };
  auto store_update = [&](const i64* sd, int r, i64 mi, int i, float v) {
    a.buf[r * a.bs + 1 + sd[kCOff] + mi * sd[kB] + i] = v;
  };
  auto z_bd = [&](float* v, const i64* sd, i64 mi) {  // P2: the ancestors' slots
    const i64 bw = sd[kB];
    const i64* bd = a.bd + sd[kBd];
    stage_gather<R>(v, a.ld, rows, (int)bw, [&](int j) { return __ldg(bd + mi * bw + j); },
                    [&](int r, i64 s) { return take_lane(a.z + r * a.zs, s); });
  };
  auto store_back = [&](const i64* sd, int r, i64 mi, int i, float v) {
    const i64 s = sd[kOff] + mi * sd[kE] + i;
    const float x = accum_store(a.z + r * a.zs, s, 0, -v);  // P4
    const i64 pp = __ldg(a.perm + s);
    if (pp < a.n) a.out[r * a.n + pp] = x;
  };
  auto sync = [&]() {
    grid.sync();
    mark(a.trace, tk);
  };

  // forward sweep. The leaf stages (no stage's bd holds one of their slots,
  // so they receive no inbox sums and nothing reads their results in the
  // backward sweep) first, all in one phase for z = inv · b[perm] and one
  // for their updates fbi · z; then the other stages one by one, deepest
  // first: xe less its inbox sums (a pass over the grid), z, updates.
  bool any_leaf = false, leaf_updates = false, synced = false;
  for (int si = 0; si <= last; ++si) {
    any_leaf |= sdesc[si * kStageWords + kLeaf] != 0;
    leaf_updates |= si < last && sdesc[si * kStageWords + kLeaf] != 0;
  }
  if (any_leaf) {
    stack_phase<R>(a.stacks, sdesc, PhaseSet{0, last, true, kInvStack}, rows, a.ld, sv, z_from_b,
                   store_z);
    sync();
    synced = true;
    if (leaf_updates) {  // the root's updates have no consumer
      stack_phase<R>(a.stacks, sdesc, PhaseSet{0, last - 1, true, kFbiStack}, rows, a.ld, sv,
                     z_slice, store_update);
      sync();
    }
  }
  for (int si = 0; si <= last; ++si) {
    const i64* sd = sdesc + si * kStageWords;
    if (sd[kLeaf]) continue;
    const PhaseSet one{si, si, false, kInvStack};
    if (has_tabbed(sd)) {
      if (!synced) sync();  // the prologue's zeros before the first inbox
      synced = true;
      inbox_pass(a, sd, rows);
      sync();
      stack_phase<R>(a.stacks, sdesc, one, rows, a.ld, sv, z_from_x, store_z);
    } else {
      stack_phase<R>(a.stacks, sdesc, one, rows, a.ld, sv, z_from_b, store_z);
    }
    sync();
    synced = true;
    if (si == last) break;  // the root's updates have no consumer
    stack_phase<R>(a.stacks, sdesc, PhaseSet{si, si, false, kFbiStack}, rows, a.ld, sv, z_slice,
                   store_update);
    sync();
  }

  // backward sweep: z[stage] -= ginv · z[bd] (the bd slots are strict
  // ancestors', final since their stage's sync), each final value
  // scattered to the output through the permutation; the other stages one
  // by one, root first, then all leaf stages in one phase. A stage without
  // a real bd slot has no backward phase: its z went out in the forward
  // sweep.
  bool first = true;
  for (int si = last; si >= 0; --si) {
    const i64* sd = sdesc + si * kStageWords;
    if (sd[kLeaf] || sd[kNBd] == 0) continue;
    if (!first) sync();
    first = false;
    stack_phase<R>(a.stacks, sdesc, PhaseSet{si, si, false, kGinvStack}, rows, a.ld, sv, z_bd,
                   store_back);
  }
  if (any_leaf) {
    if (!first) sync();
    stack_phase<R>(a.stacks, sdesc, PhaseSet{0, last, true, kGinvStack}, rows, a.ld, sv, z_bd,
                   store_back);
  }
  if (a.trace != nullptr) sync();  // the end of the last phase, when tracing
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
// calculator's blocks per SM at the launch's shared memory (R x ld floats)
struct GridCache {
  int device = -1;
  int sms = 0;
  int per_sm[4] = {0, 0, 0, 0};
  size_t smem[4] = {0, 0, 0, 0};
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

size_t smem_of(int rows, int ld, int n_stages) {
  return desc_bytes(n_stages) + (size_t)(1 << instance_of(rows)) * ld * sizeof(float);
}

cudaError_t fused_grid(int rows, int ld, int n_stages, int* blocks, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (g_grid.device != dev) {
    int coop = 0, optin = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return e;
    if (!coop) return cudaErrorNotSupported;
    e = cudaDeviceGetAttribute(&g_grid.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    for (int i = 0; i < 4; ++i) {  // allow dynamic shared memory past 48 KB
      cudaFuncAttributes fa;
      e = cudaFuncGetAttributes(&fa, kernel_of(i));
      if (e != cudaSuccess) return e;
      e = cudaFuncSetAttribute(kernel_of(i), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
      if (e != cudaSuccess) return e;
      g_grid.per_sm[i] = 0;
    }
    g_grid.device = dev;
  }
  const int inst = instance_of(rows);
  const size_t smem = smem_of(rows, ld, n_stages);
  if (g_grid.per_sm[inst] == 0 || g_grid.smem[inst] != smem) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g_grid.per_sm[inst], kernel_of(inst),
                                                      kThreads, smem);
    if (e != cudaSuccess) return e;
    if (g_grid.per_sm[inst] < 1) return cudaErrorCooperativeLaunchTooLarge;
    g_grid.smem[inst] = smem;
  }
  *per_sm = g_grid.per_sm[inst];
  *sms = g_grid.sms;
  *blocks = g_grid.per_sm[inst] * g_grid.sms;
  return cudaSuccess;
}

}  // namespace

// F's grid on the current device for `rows` right-hand sides, vectors of
// up to `ld` floats per node (the factor's largest front or boundary, a
// multiple of 4) and n_stages stages: blocks, blocks per SM, SMs.
extern "C" int mf_fused_grid(int rows, int ld, int n_stages, int* blocks, int* per_sm,
                             int* sms) {
  if (rows < 1 || rows > kMaxRows || ld < 4 || ld % 4 || n_stages < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)fused_grid(rows, ld, n_stages, blocks, per_sm, sms);
}

// The most dynamic shared memory one F block of the instance for `rows`
// right-hand sides may request on the current device: the opt-in less the
// instance's static shared memory.
extern "C" int mf_fused_smem_limit(int rows, long long* bytes) {
  if (rows < 1 || rows > kMaxRows) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel_of(instance_of(rows)));
  if (e != cudaSuccess) return (int)e;
  *bytes = (long long)optin - (long long)fa.sharedSizeBytes;
  return (int)cudaSuccess;
}

// desc (n_stages, stage_words) int64; stacks, bd, inbox: the factor's flat
// arrays; perm (total + 1) int64; b and out (rows, n) f32 contiguous;
// scratch x and z (rows, zs) and buf (rows, bs) f32 with zs >= total + 1,
// zs % 4 == 0 and bs = 1 + total_contrib; ld >= every stage's e and b,
// ld % 4 == 0; trace null, or room for grid_syncs + 2 time stamps (ns, one
// at the start, one after every grid sync, one at the end). One
// cooperative launch on `stream`; does not synchronise; returns
// cudaGetLastError() (0 when accepted).
extern "C" int mf_fused_solve_f32(const i64* desc, int n_stages, int stage_words,
                                  const float* stacks, const i64* bd, const int* inbox,
                                  const i64* perm, const float* b, float* out, float* x,
                                  float* z, float* buf, int rows, int ld, i64 n, i64 total, i64 zs,
                                  i64 bs, unsigned long long* trace, void* stream) {
  if (stage_words != kStageWords || rows < 1 || rows > kMaxRows || n_stages < 1 || zs % 4 ||
      zs < total + 1 || ld < 4 || ld % 4) {
    return (int)cudaErrorInvalidValue;
  }
  int blocks = 0, per_sm = 0, sms = 0;
  cudaError_t e = fused_grid(rows, ld, n_stages, &blocks, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  FusedArgs a;
  a.desc = desc;
  a.n_stages = n_stages;
  a.stacks = stacks;
  a.bd = bd;
  a.inbox = inbox;
  a.perm = perm;
  a.b = b;
  a.out = out;
  a.x = x;
  a.z = z;
  a.buf = buf;
  a.rows = rows;
  a.ld = ld;
  a.n = n;
  a.total = total;
  a.zs = zs;
  a.bs = bs;
  a.trace = trace;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel_of(instance_of(rows)), dim3(blocks), dim3(kThreads),
                                  params, smem_of(rows, ld, n_stages),
                                  static_cast<cudaStream_t>(stream));
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

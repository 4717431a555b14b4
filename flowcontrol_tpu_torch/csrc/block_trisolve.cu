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
// resident in VMEM. Here the sweep is right-looking: once y_k is final, the
// rows i > k subtract L_ik y_k (backward: x_k = D_k^-1 y_k, then the rows
// i < k subtract U_ik x_k). Every output element is owned by one thread,
// which sums its products in a fixed order (over the bs depth of one block
// column, then c -= sum): there is no sum across blocks and no atomic on
// data, and two calls give bitwise the same x. The forward sweep never
// reads the diagonal blocks of lu; the backward sweep reads dinv[k] in
// their place, writing x_k into a second panel (out) because other blocks
// still read y_k.
//
// One right-hand side (the single stream): a block GEMV per block row,
// each tile of lu read once with 16-byte loads through the read-only path,
// one warp per pair of rows; block row k+1 learns that block row k is
// finished from the order of the stream, so the C entry point issues
// 3 nb - 2 launches back to back. What bounds it: the bytes of the factor,
// 4 n_pad^2 (lu without its diagonal blocks, plus dinv).
//
// A panel of right-hand sides (the batched paths, B = 256): ONE persistent
// launch per solve, in place of the earlier 166 launches of a 128 x 128
// tiled product ordered by the stream (56-58 ms per solve at B = 256, NVIDIA
// H100 80GB HBM3, 700 W, chip_smoke.py phase 11). What bounds it: the
// 2 n_pad^2 B FMAs in f32 (no TF32, no tensor cores: the repo's f32 pin),
// 25 ms at n_pad = 57,344, B = 256. The work is a host-built schedule of
// items (kind, k, tile, slice): a tile is 64 rows of one block row, so
// every tile of lu is read by one item only (by ns = ldx / 64 items where
// the schedule cuts it into 64-column slices); the kinds are a forward
// update (c -= L_ik y_k), a product with dinv[k] (x_k = D_k^-1 y_k into
// out) and a backward update (c -= U_ik x_k). The schedule walks the steps
// in dependency order with lookahead: at each step the tiles of the next
// block row come first, and the dinv products and the updates of the two
// block rows next to the step are cut into 64-column slices, so the
// critical path (block row k+1 final, then its dinv product) runs on four
// times as many blocks while the bulk of the trailing update still runs.
// A block claims the next item from an atomic ticket, so an item only waits
// on items already claimed by running blocks and the spin-waits cannot
// deadlock. Dependencies are per-tile counters in 64-column units: cnt
// counts the updates applied to a tile of the panel, ocnt the slices of
// its rows of out written; a writer publishes with a fence and an atomic
// add after its stores, a reader spins with ld.acquire.gpu and then reads
// the panels through L2 only (cp.async.cg, ld.global.cg), never through
// the non-coherent L1. The counters and the ticket are scheduling only.
// Each item streams its bs-deep product through a four-deep ring of
// 16-deep chunks filled by 16-byte cp.async copies, 64 rows x BN columns
// (BN = 64, 128 or 256, by the width), each thread 4 rows x BN/16 columns
// of f32 accumulators, 5 16-byte shared loads per 64 FMAs at BN = 256. Per
// element the order is the earlier kernel's (the depth ascending in one
// FMA chain, then c -= acc per step), so its results are bitwise the same.
//
// Every offset into lu is 64-bit: n_pad^2 is 3.3e9 elements at 56,383 dofs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <bool SUB>
cudaError_t gemv(const float* a, int64_t lda, const float* v, float* y, int rows, int cols,
                 cudaStream_t s) {
  const int want = (rows / 2 + kWarps - 1) / kWarps;
  const int grid = want < 132 * 16 ? want : 132 * 16;
  gemv_kernel<SUB><<<grid, kThreads, (size_t)cols * sizeof(float), s>>>(a, lda, v, y, rows,
                                                                       cols);
  return cudaGetLastError();
}

// ---- a panel of right-hand sides: one persistent launch -------------------
constexpr int kPanelThreads = 256;
constexpr int kBM = kPanelThreads / 16 * 4;  // rows of one tile: 4 per row of threads
constexpr int kBK = 16;              // depth of one staged chunk
constexpr int kStages = 4;           // chunks in the cp.async ring
constexpr int kALd = kBK + 4;        // row stride of a staged a chunk (floats)
enum : int { kFwd = 0, kDinv = 1, kBwd = 2 };  // item kinds, as ops/trisolve.py

template <int BN>
constexpr size_t panel_smem() {
  return (size_t)kStages * (kBM * kALd + kBK * BN) * sizeof(float);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void wait_at_least(const int* p, int target) {
  while (ld_acquire(p) < target) __nanosleep(100);
}

// c[r, j] = (sub ? c[r, j] : 0) - + sum_k a[r, k] b[k, j] for r < rows,
// j < BN, k < depth: one tile of kBM rows. a rows past `rows` are read from
// row 0 and never stored. depth % kBK == 0; a, b, c and their strides
// 16-byte aligned. Ends with a barrier, so the ring may be refilled.
template <int BN>
__device__ __forceinline__ void tile_product(float* smem, const float* __restrict__ a,
                                             int64_t lda, const float* b, int64_t ldb, float* c,
                                             int64_t ldc, int rows, int depth, bool sub) {
  constexpr int TN = BN / 16;  // columns per thread, in groups of four 64 apart
  float* a_s = smem;
  float* b_s = smem + kStages * kBM * kALd;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int nk = depth / kBK;

  // one chunk: kBM x kBK of a and kBK x BN of b in 16-byte copies
  constexpr int A_COPIES = kBM * kBK / 4 / kPanelThreads;
  constexpr int B_COPIES = kBK * BN / 4 / kPanelThreads;
  static_assert(A_COPIES * 4 * kPanelThreads == kBM * kBK, "a chunk copies");
  static_assert(B_COPIES * 4 * kPanelThreads == kBK * BN, "b chunk copies");
  auto load_chunk = [&](int kc) {
    const int st = kc % kStages;
#pragma unroll
    for (int i = 0; i < A_COPIES; ++i) {
      const int f = t + i * kPanelThreads;
      const int ar = f / (kBK / 4), a4 = f % (kBK / 4);
      cp_async16(a_s + (st * kBM + ar) * kALd + a4 * 4,
                 a + (int64_t)(ar < rows ? ar : 0) * lda + kc * kBK + a4 * 4);
    }
#pragma unroll
    for (int i = 0; i < B_COPIES; ++i) {
      const int f = t + i * kPanelThreads;
      const int kr = f / (BN / 4), c4 = f % (BN / 4);
      cp_async16(b_s + (st * kBK + kr) * BN + c4 * 4, b + (int64_t)(kc * kBK + kr) * ldb + c4 * 4);
    }
  };

  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_chunk(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();  // chunk kc has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and chunk kc - 1 is consumed
    if (kc + kStages - 1 < nk) load_chunk(kc + kStages - 1);
    cp_async_commit();
    const float* as = a_s + (kc % kStages) * kBM * kALd;
    const float* bsm = b_s + (kc % kStages) * kBK * BN;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + (ty * 4 + i) * kALd + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float bv[TN];
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
          const float4 q = *reinterpret_cast<const float4*>(bsm + (kk + j) * BN + g * 64 + tx * 4);
          bv[4 * g + 0] = q.x, bv[4 * g + 1] = q.y, bv[4 * g + 2] = q.z, bv[4 * g + 3] = q.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ai = j == 0 ? av[i].x : j == 1 ? av[i].y : j == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int q = 0; q < TN; ++q) acc[i][q] = fmaf(ai, bv[q], acc[i][q]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      float4* p = reinterpret_cast<float4*>(c + (int64_t)r * ldc + g * 64 + tx * 4);
      float4 v = make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                             acc[i][4 * g + 3]);
      if (sub) {
        const float4 o = __ldcg(p);
        v = make_float4(o.x - v.x, o.y - v.y, o.z - v.z, o.w - v.w);
      }
      __stcg(p, v);
    }
  }
  __syncthreads();
}

// The persistent solve: blocks claim items of `sched` (n_items x {kind, k,
// tile, slice}) in order from *ticket until none is left. slice < 0: the
// item spans the panel's width; else only its 64 columns from slice * 64
// (the schedule splits the items near the critical path so that more
// blocks share them). x (n_pad, ldx): the right-hand sides on entry
// (padding rows and columns zero), intermediate values on return; out
// (n_pad, ldx): the solution. cnt, ocnt: one counter per tile, zero on
// entry, in 64-column units (an item over the whole width adds ldx / 64).
template <int BN>
__global__ void __launch_bounds__(kPanelThreads, 2)
panel_solve_kernel(const float* __restrict__ lu, const float* __restrict__ dinv, float* x,
                   float* out, int n_pad, int bs, int ldx, const int4* __restrict__ sched,
                   int n_items, int* ticket, int* cnt, int* ocnt) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_item;
  const int nb = n_pad / bs, tpb = (bs + kBM - 1) / kBM, ns = ldx / 64;
  for (;;) {
    if (threadIdx.x == 0) s_item = atomicAdd(ticket, 1);
    __syncthreads();
    const int it = s_item;
    if (it >= n_items) break;
    const int4 e = __ldg(sched + it);
    const int kind = e.x, k = e.y, tile = e.z, slice = e.w;
    const int blk = tile / tpb;
    const int row0 = blk * bs + (tile % tpb) * kBM;
    const int rows = min(kBM, (blk + 1) * bs - row0);
    // wait: thread i < tpb on tile i of block row k, thread tpb on this tile
    const int i = threadIdx.x;
    if (kind == kFwd) {
      if (i < tpb) wait_at_least(cnt + k * tpb + i, k * ns);   // y_k final
      else if (i == tpb) wait_at_least(cnt + tile, k * ns);    // steps < k applied here
    } else if (kind == kDinv) {
      if (i < tpb) wait_at_least(cnt + k * tpb + i, (nb - 1) * ns);  // every update of row k
    } else {
      if (i < tpb) wait_at_least(ocnt + k * tpb + i, ns);      // x_k written to out
      else if (i == tpb) wait_at_least(cnt + tile, (blk + nb - 1 - k) * ns);  // steps > k
    }
    __syncthreads();
    const int64_t ld = n_pad;
    const float* a;
    int64_t lda;
    const float* b;
    float* c;
    if (kind == kDinv) {
      a = dinv + (int64_t)k * bs * bs + (int64_t)(row0 - k * bs) * bs;
      lda = bs;
      b = x + (int64_t)k * bs * ldx;
      c = out + (int64_t)row0 * ldx;
    } else {
      a = lu + (int64_t)row0 * ld + (int64_t)k * bs;
      lda = ld;
      b = (kind == kFwd ? x : out) + (int64_t)k * bs * ldx;
      c = x + (int64_t)row0 * ldx;
    }
    if (slice < 0) {
      for (int j0 = 0; j0 < ldx; j0 += BN)
        tile_product<BN>(smem, a, lda, b + j0, ldx, c + j0, ldx, rows, bs, kind != kDinv);
    } else {
      tile_product<64>(smem, a, lda, b + slice * 64, ldx, c + slice * 64, ldx, rows, bs,
                       kind != kDinv);
    }
    __threadfence();  // this thread's stores, before the counter says they are there
    __syncthreads();
    if (threadIdx.x == 0)
      atomicAdd(kind == kDinv ? ocnt + tile : cnt + tile, slice < 0 ? ns : 1);
  }
}

template <int BN>
cudaError_t panel_solve(const float* lu, const float* dinv, float* x, float* out, int n_pad,
                        int bs, int ldx, const int4* sched, int n_items, int* scratch,
                        cudaStream_t s) {
  const int n_tiles = (n_pad / bs) * ((bs + kBM - 1) / kBM);
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)(1 + 2 * n_tiles) * sizeof(int), s);
  if (e != cudaSuccess) return e;
  constexpr size_t smem = panel_smem<BN>();
  e = cudaFuncSetAttribute(panel_solve_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, panel_solve_kernel<BN>,
                                                    kPanelThreads, smem);
  if (e != cudaSuccess) return e;
  int grid = sms * (per_sm > 0 ? per_sm : 1);
  if (grid > n_items) grid = n_items;
  panel_solve_kernel<BN><<<grid, kPanelThreads, smem, s>>>(
      lu, dinv, x, out, n_pad, bs, ldx, sched, n_items, scratch, scratch + 1,
      scratch + 1 + n_tiles);
  return cudaGetLastError();
}

}  // namespace

// lu (n_pad, n_pad) f32 row-major; dinv (nb, bs, bs) f32; x (n_pad, ldx)
// f32, the right-hand sides on entry (padding rows and columns zero),
// overwritten with intermediate values; out (n_pad, ldx) f32, the solution
// on return. n_pad % bs == 0, bs % 16 == 0, bs <= 12288.
// One right-hand side (nrhs == 1, ldx == 1): 3 nb - 2 GEMV launches; sched
// and scratch are not read. A panel (nrhs > 1): ldx a multiple of bn (64,
// 128 or 256), sched the n_items x 4 int32 schedule of ops/trisolve.py for
// this nb, tile height and ldx / 64 column slices (16-byte aligned),
// scratch 1 + 2 nb ceil(bs / 64) int32 (reset here on the stream), one
// launch. Returns cudaGetLastError() of the first call that failed, else 0.
extern "C" int block_trisolve_f32(const float* lu, const float* dinv, float* x, float* out,
                                  int n_pad, int bs, int nrhs, int ldx, int bn,
                                  const int* sched, int n_items, int* scratch, void* stream) {
  if (n_pad <= 0 || nrhs <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nrhs > 1) {
    if (ldx % bn || bn % 64) return (int)cudaErrorInvalidValue;
    const int4* sched4 = reinterpret_cast<const int4*>(sched);
    switch (bn) {
      case 64: return (int)panel_solve<64>(lu, dinv, x, out, n_pad, bs, ldx, sched4, n_items,
                                           scratch, s);
      case 128: return (int)panel_solve<128>(lu, dinv, x, out, n_pad, bs, ldx, sched4, n_items,
                                             scratch, s);
      case 256: return (int)panel_solve<256>(lu, dinv, x, out, n_pad, bs, ldx, sched4, n_items,
                                             scratch, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const int nb = n_pad / bs;
  const size_t ld = (size_t)n_pad, b = (size_t)bs;
  cudaError_t e;
  // forward: y_k is final once the updates of block rows 0..k-1 are in
  for (int k = 0; k + 1 < nb; ++k) {
    const size_t below = (size_t)(k + 1) * b;
    e = gemv<true>(lu + below * ld + (size_t)k * b, (int64_t)ld, x + (size_t)k * b, x + below,
                   n_pad - (int)below, bs, s);
    if (e != cudaSuccess) return (int)e;
  }
  // backward: x_k = dinv[k] y_k into out, then U_ik x_k off the rows above
  for (int k = nb - 1; k >= 0; --k) {
    const size_t at = (size_t)k * b;
    e = gemv<false>(dinv + (size_t)k * b * b, (int64_t)bs, x + at, out + at, bs, bs, s);
    if (e != cudaSuccess) return (int)e;
    if (k == 0) break;
    e = gemv<true>(lu + at, (int64_t)ld, out + at, x, (int)at, bs, s);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// rows of one tile of the panel schedule (ops/trisolve.py checks it)
extern "C" int block_trisolve_tile_rows() { return kBM; }

extern "C" const char* block_trisolve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

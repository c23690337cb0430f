// Particle-filter step tail for one batch row (sm_90a): the warp and block
// reductions and scans that the eval tails share, and the cluster row tail
// (the second half of this file), used by B5 (pf_resample.cu) and the
// whole-trajectory kernel B3 (pf_fused_step.cu): the row split into
// contiguous slices over the blocks of a thread-block cluster, merged through
// distributed shared memory. B1 and B4 (pf_resample.cu) run one block a row
// on the warp functions and cluster_cdf below.
//
// The block functions are called by all threads of the block (each contains
// __syncthreads) and return the same value to all of them. `red` is a
// scratch of 32 floats in shared memory.
//
// The math is ops/pallas_pf.py's: p = exp(v - max v) / sum exp(v - max v)
// for the updated log-weights v = lw + ll; est[d] = sum_m p[m] x[m, d]
// (before resampling); an inclusive CDF of p (multinomial) or of the mixture
// alpha p + (1 - alpha) / M (soft), NOT divided by its last entry;
// idx[j] = #(cdf < target[j]) clipped to M - 1.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace pf_tail {

constexpr int kMaxD = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_inclusive_scan(float x, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Block reductions: every warp reduces the per-warp partials itself, so the
// result reaches all threads without a second barrier; the leading barrier
// keeps `red` free of an earlier call's readers.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_max(lane < nwarps ? red[lane] : -INFINITY);
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < nwarps ? red[lane] : 0.0f);
}

// Inclusive scan of one value per thread over the block, in thread order.
// Returns this thread's prefix; *total gets the block's sum.
__device__ __forceinline__ float block_inclusive_scan(float v, float* red,
                                                      float* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_inclusive_scan(v, lane);
  __syncthreads();
  if (lane == 31) red[warp] = v;
  __syncthreads();
  const float w = warp_inclusive_scan(lane < nwarps ? red[lane] : 0.0f, lane);
  const float before = __shfl_sync(kFull, w, warp > 0 ? warp - 1 : 0);
  *total = __shfl_sync(kFull, w, nwarps - 1);
  return warp > 0 ? v + before : v;
}

// Block sums of D <= kMaxD values at once: on return warp 0 holds them in
// acc. `red` is a scratch of 32 * kMaxD floats.
__device__ __forceinline__ void block_sums(float* acc, int D, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int d = 0; d < kMaxD; ++d)
    if (d < D) acc[d] = warp_sum(acc[d]);
  __syncthreads();
  if (lane == 0)
    for (int d = 0; d < D; ++d) red[d * 32 + warp] = acc[d];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int d = 0; d < kMaxD; ++d)
      if (d < D) acc[d] = warp_sum(lane < nwarps ? red[d * 32 + lane] : 0.0f);
  }
}

// Soft resampling's proposal: the mixture alpha p + (1 - alpha) / M, with
// uniform_part = (1 - alpha) / M.
__device__ __forceinline__ float mixture(float p, float alpha, float uniform_part) {
  return alpha * p + uniform_part;
}

// ---------------------------------------------------------------------------
// The cluster row tail
// ---------------------------------------------------------------------------
//
// A row of M slots is split into C <= kMaxCluster contiguous slices, one per
// block of a thread-block cluster: block (cluster rank) r owns the slots
// [start_r, start_{r+1}). The blocks of one cluster run at once on
// neighbouring SMs and read each other's shared memory (DSMEM) through
// map_shared_rank. One step of the tail:
//
//   a. Each block scans its slice: max_r = max logit; the inclusive scan
//      scan_r[i] of exp(logit - max_r), kept where its peers can read it
//      (shared memory, or a device-memory scratch for very long slices);
//      total_r = scan_r[last]; est_r[d] = sum exp(logit - max_r) x[., d].
//      It publishes SlicePartials {max_r, total_r, est_r} in shared memory.
//   b. Cluster barrier 1: the partials and scans are complete and visible.
//   c. Each block merges all C partials IN RANK ORDER (merge_partials), so
//      every block holds the same ClusterRow bit for bit: the global max G,
//      sum = sum_r total_r exp(max_r - G), est, each slice's scale
//      f_r = alpha exp(max_r - G) / sum and CDF offset. Were they to differ
//      in one bit, the same slot could be drawn differently in two blocks.
//   d. The CDF entry of slice r's i-th slot is
//        cdf = offset_r + (f_r scan_r[i] + (i + 1) (1 - alpha) / M)
//      (the last term 0 in multinomial mode), in fp32 with explicit
//      round-to-nearest operations so no block contracts it into an FMA,
//      and offset_{r+1} is the same expression at the slice's last slot.
//      So the global sequence is monotone across slice boundaries and
//      offset_C = cdf[M - 1]. A search keeps B1's semantics: #(cdf <
//      target) clipped to M - 1, the CDF not divided by its last entry,
//      target = u (multinomial) or u cdf[M - 1] (soft). Either it is
//      two-level: the first slice whose last entry reaches the target,
//      then a binary search inside that slice's scan, forming each entry
//      from it. The scan may be a peer's shared memory read through DSMEM
//      (cluster_lower_bound, B3), a scratch row in device memory, or a copy
//      of the whole row that every block holds (B5, after its owners push
//      their slices with bulk copies). All give the same index.
//   e. Each slot gathers its source particle (a peer's shared memory in B3,
//      device memory in B5).
//
// Where peers read (pull) a block's scan and partials after barrier 1, the
// block may overwrite them, or exit, only after the next cluster barrier:
// DSMEM needs its owner resident. Where every block pushes what its peers
// need into their shared memory before a barrier, nothing is read remotely
// after it.

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;  // the portable cluster size

// Split arrive / wait of the cluster barrier (by default release and
// acquire at cluster scope, so shared- and device-memory writes before the
// arrive are visible to every thread of the cluster after the wait). Every
// thread of every block calls both, alternately; not `.aligned`, so a warp
// may reach them diverged.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// `p`, a pointer into this block's shared memory, in the block of rank r.
template <class T>
__device__ __forceinline__ T* peer(T* p, int r) {
  return cg::this_cluster().map_shared_rank(p, r);
}

// What a block publishes about its slice.
struct SlicePartials {
  float max;         // max logit over the slice
  float total;       // scan[last]: sum of exp(logit - max) over the slice
  float est[kMaxD];  // sum of exp(logit - max) x[., d] over the slice
};

// The merged row, the same bit for bit in every block of the cluster.
struct ClusterRow {
  float max;                      // G = max logit over the row
  float sum;                      // sum of exp(logit - G) over the row
  float est[kMaxD];               // weighted-mean estimate
  float scale[kMaxCluster];       // f_r: slice r's scan -> (alpha times) probability
  float offset[kMaxCluster + 1];  // CDF before slice r; offset[C] = cdf[M - 1]
  int start[kMaxCluster + 1];     // slice bounds
};

// CDF entry of a slice's i-th slot (step d above). uniform_part is
// (1 - alpha) / M in soft mode and 0 in multinomial mode.
__device__ __forceinline__ float cluster_cdf(float offset, float scale, float scan, int i,
                                             float uniform_part) {
  return __fadd_rn(offset, __fadd_rn(__fmul_rn(scale, scan),
                                     __fmul_rn(static_cast<float>(i + 1), uniform_part)));
}

// Step c: called by one whole warp, which reads partials r < C (one lane
// each, through `part_of(r)`) and merges them in rank order; every lane
// computes the same values and lane 0 writes `row`. Slice r holds slots
// [min(r S, M), min((r + 1) S, M)); every slice is non-empty.
template <class PartOf>
__device__ void merge_partials(PartOf part_of, int C, int S, int M, int D, float alpha,
                               float uniform_part, ClusterRow* row) {
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY, total = 0.0f, est[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) est[d] = 0.0f;
  if (lane < C) {
    const SlicePartials* p = part_of(lane);
    mx = p->max;
    total = p->total;
#pragma unroll
    for (int d = 0; d < kMaxD; ++d)
      if (d < D) est[d] = p->est[d];
  }
  const float g = warp_max(mx);
  const float e = lane < C ? expf(mx - g) : 0.0f;
  float sum = 0.0f, acc[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) acc[d] = 0.0f;
  for (int r = 0; r < C; ++r) {
    const float er = __shfl_sync(kFull, e, r);
    sum = __fadd_rn(sum, __fmul_rn(__shfl_sync(kFull, total, r), er));
#pragma unroll
    for (int d = 0; d < kMaxD; ++d)
      acc[d] = __fadd_rn(acc[d], __fmul_rn(__shfl_sync(kFull, est[d], r), er));
  }
  const float scale = __fmul_rn(alpha, __fdiv_rn(e, sum));
  float offset = 0.0f;
  if (lane == 0) {
    row->max = g;
    row->sum = sum;
    for (int d = 0; d < D; ++d) row->est[d] = __fdiv_rn(acc[d], sum);
    row->offset[0] = 0.0f;
    row->start[0] = 0;
  }
  for (int r = 0; r < C; ++r) {
    const float f = __shfl_sync(kFull, scale, r);
    const float t = __shfl_sync(kFull, total, r);
    const int start = min(r * S, M), count = min(start + S, M) - start;
    offset = cluster_cdf(offset, f, t, count - 1, uniform_part);
    if (lane == 0) {
      row->scale[r] = f;
      row->offset[r + 1] = offset;
      row->start[r + 1] = start + count;
    }
  }
  __syncwarp();
}

struct Draw {
  int rank;   // the slice (cluster rank) that holds the drawn slot
  int local;  // its index inside that slice
};

// Step d: the slot drawn for `target`, #(cdf < target) clipped to M - 1.
// scan_of(r) points at slice r's scan (a peer's shared memory or the
// scratch).
template <class ScanOf>
__device__ __forceinline__ Draw cluster_lower_bound(const ClusterRow& row, int C,
                                                    ScanOf scan_of, float uniform_part,
                                                    float target) {
  int r = 0;
  while (r < C && row.offset[r + 1] < target) ++r;
  if (r == C) return {C - 1, row.start[C] - row.start[C - 1] - 1};
  const float* scan = scan_of(r);
  const int n = row.start[r + 1] - row.start[r];
  const float offset = row.offset[r], scale = row.scale[r];
  int lo = 0;  // binary lifting: the count of entries below the target
  for (int step = 1 << (31 - __clz(n)); step > 0; step >>= 1) {
    const int i = lo + step - 1;
    if (i < n && cluster_cdf(offset, scale, scan[i], i, uniform_part) < target) lo += step;
  }
  return {r, lo};
}

}  // namespace pf_tail

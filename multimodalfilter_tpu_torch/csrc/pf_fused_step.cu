// B3: the whole eval forward_loop of a particle filter as one kernel, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel
// multimodalfilter_tpu/ops/pallas_fused_step.py::_fused_kernel (:158), the
// JAX package's small-N serving route (MMF_TPU_FUSED_STEP=1). For every time
// step t and trajectory n it computes, in fp32:
//
//   dynamics trunk (11 packed 64x64 layers, feature-major):
//     h = relu(W0 x + b0); h = res(1, h); z = W3 h + row_dyn[t]   (no
//     activation after dense_in: the reference's quirk); z = res(4), res(6),
//     res(8); o = W10 z + b10;  x' = x + o[:D] * sigmoid(o[D]) + noise[t]
//   K measurement trunks (9 layers each):
//     h = relu(W0 x' + b0); h = res(1, h); z = relu(W3 h + row_k[t]);
//     z = res(4), res(6); ll_k = (W8 z + b8)[0] + gate_k[t]
//   ll = logsumexp_k ll_k  (raw per-modality log-likelihoods; ll_0 when K=1)
//   tail: B1's math on the row (pf_tail.cuh's cluster row tail), est[t]
//   before resampling, then the resampled belief carried to t+1,
//
// where res(i, v) = v + relu(W_{i+1} relu(W_i v + b_i) + b_{i+1}), and
// row_dyn / row_k are the carry-independent halves of the dense_in layers
// (control or observation features times their weights, plus the bias),
// hoisted by the caller.
//
// Operands (all fp32, contiguous): parts0 (N, M, D) and lw0 (N, M), the
// initial belief; noise (T, N, M, D), already scaled by the process noise's
// diagonal; uniforms (T, N, M); rows (T, N, 1+K, 64); gate (T, N, K);
// wdt (11, 64, 64) and wmt (K, 9, 64, 64), each layer transposed to
// (in, out); bd (11, 64) and bm (K, 9, 64). Out: est (T, N, D) and the final
// belief out_parts (N, M, D), out_lw (N, M); and, when ll_out is not null,
// each step's fused log-likelihoods (T, N, M), so a check can hold the
// trunks and the tail apart. Layers narrower than 64 (the D-wide input, the
// D+1 and 1-wide outputs) are zero-padded to 64x64.
//
// Design. The TPU kernel's sequential (N, T) grid becomes one thread-block
// cluster per trajectory with the loop over T inside it: C = ceil(M / 64)
// blocks (C <= 8, M <= 512), block r owning the 64-particle tile of slots
// [64 r, min(64 r + 64, M)) for all T steps, so N C blocks run (80 at
// N = 16, M = 300). Each block keeps its tile's belief (D x 64, feature-
// major), propagated particles, K log-likelihood rows, log-weights and scan
// in shared memory. Its trunks run the tile through the layers: two 64x64
// activation buffers ping-pong (a residual block writes back into its
// input), and 256 threads each own a 4x4 block of a layer's 64x64 output:
// per input feature one float4 of weights and one float4 of activations
// feed 16 fp32 FMAs (no single-pass TF32, for parity with the plain
// version; a 3xTF32 mma.sync version of the 64-deep layers met the same
// limits but ran slower on the H100, PERF.md). The 11 + 9K weight layers (~464 KiB at K = 2) stay L2-resident in device
// memory and stream through a ring of three 16 KB shared-memory buffers
// with cp.async: layer l + 2 is in flight while layer l computes, so one
// barrier per layer both lands a layer and publishes the previous output.
// The step tail is pf_tail.cuh's cluster row tail over the blocks' tiles;
// a slot gathers its source particle from the owning block's shared memory
// through DSMEM. Two cluster barriers a step: 1 after the partials (every
// block needs all of them to draw), and 2 (split: arrive after the gather,
// wait just before the next step overwrites the propagated particles, the
// scan and the partials that peers read), whose last wait also keeps every
// block resident until its peers are done with its shared memory.
//
// Bound. The trunks do 2 * 64 * 64 FLOPs per full layer: about 1.9e5 per
// particle-step at D = 3, K = 2 (9 full dynamics layers, 7 per modality,
// and the narrow ones), so 9.1e10 FLOPs at N = 16, T = 100, M = 300 -- 1.36
// ms at the card's 67 TFLOP/s fp32 rate. The bytes (noise, uniforms, rows,
// weights, belief and estimates, ~9.4 MB) take under 3 us at 3.35 TB/s, so
// the operations bound it. Known limits: N C blocks fill 80 of the 132 SMs
// at N = 16, M = 300 (and ragged last tiles compute padding); one block of
// 8 warps per tile hides latency only through its 16 independent FMAs a
// thread; and each step ends in a serial tail of two cluster barriers.
//
// Entry points: plain C functions (built with nvcc into a shared library and
// bound with ctypes). The kernel launches on the given stream, allocates
// nothing, and returns the launch's error so the caller sees a refused
// launch; a second function reports the launch's cluster, blocks and
// cudaOccupancyMaxActiveClusters.

#include "pf_tail.cuh"

namespace {

using namespace pf_tail;

constexpr int kUnits = 64;
constexpr int kTile = 64;  // particle columns per trunk tile
constexpr int kLayer = kUnits * kUnits;
constexpr int kMeasLayers = 9;
constexpr int kMaxK = 4;
constexpr int kMaxM = 512;
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 output block each

enum Epilogue { kRelu, kLinear, kResidual };

constexpr int kDynLayers = 11;
constexpr int kRing = 3;  // weight buffers in flight

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The weight layers stream through kRing shared-memory buffers in the fixed
// order of a step (11 dynamics layers, then 9 per modality), repeated every
// step. Layer q is copied two layers ahead of its use.
struct WeightRing {
  float* buf;  // kRing x kLayer
  const float* wdt;
  const float* wmt;
  int layers;  // 11 + 9 K per step
  int q;       // layers used so far

  __device__ void issue(int layer) const {
    const int l = layer % layers;
    const float* src = l < kDynLayers ? wdt + static_cast<size_t>(l) * kLayer
                                      : wmt + static_cast<size_t>(l - kDynLayers) * kLayer;
    float* dst = buf + (layer % kRing) * kLayer;
    for (int i = threadIdx.x; i < kLayer / 4; i += kThreads) {
      cp_async16(dst + 4 * i, src + 4 * i);
    }
    cp_async_commit();
  }

  __device__ void start() {
    q = 0;
    issue(0);
    issue(1);
  }

  // The next layer's weights, once every thread's copies have landed. The
  // barrier also publishes the previous layer's output and frees the
  // buffer the previous layer read, which the copy of layer q + 2 reuses.
  __device__ const float* next() {
    cp_async_wait<1>();
    __syncthreads();
    issue(q + 2);
    return buf + (q++ % kRing) * kLayer;
  }
};

// y (64 x kTile) = epilogue(W x + add) in fp32 FMAs: W staged as
// wt[k * 64 + i]; x has `kdim` rows of kTile; add is the bias or a hoisted
// row.
template <int kEpi>
__device__ __forceinline__ void dense_tile(const float* wt, const float* add,
                                           const float* x, int kdim, float* y) {
  const int i0 = (threadIdx.x >> 4) * 4;
  const int p0 = (threadIdx.x & 15) * 4;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll 8
  for (int k = 0; k < kdim; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(wt + k * kUnits + i0);
    const float4 b = *reinterpret_cast<const float4*>(x + k * kTile + p0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + r;
    const float ad = add[i];
    float4* yr = reinterpret_cast<float4*>(y + i * kTile + p0);
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[c] = acc[r][c] + ad;
      if (kEpi != kLinear) v[c] = fmaxf(v[c], 0.0f);
    }
    if (kEpi == kResidual) {
      const float4 prev = *yr;
      v[0] += prev.x; v[1] += prev.y; v[2] += prev.z; v[3] += prev.w;
    }
    *yr = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// v += relu(W_{l+1} relu(W_l v + b_l) + b_{l+1}), with tmp as scratch.
__device__ __forceinline__ void resblock(WeightRing& ring, const float* __restrict__ b, int l,
                                         float* v, float* tmp) {
  dense_tile<kRelu>(ring.next(), b + l * kUnits, v, kUnits, tmp);
  dense_tile<kResidual>(ring.next(), b + (l + 1) * kUnits, tmp, kUnits, v);
}

// The first `rows` outputs of a staged layer: out[j * kTile + p].
__device__ __forceinline__ void dense_rows(const float* wt, const float* __restrict__ bias,
                                           const float* x, int rows, float* out) {
  for (int idx = threadIdx.x; idx < rows * kTile; idx += kThreads) {
    const int j = idx / kTile, p = idx % kTile;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < kUnits; ++k)
      acc = fmaf(wt[k * kUnits + j], x[k * kTile + p], acc);
    out[idx] = acc + bias[j];
  }
}

// Two blocks an SM (91 KB of shared memory each, at most 128 registers a
// thread), so two clusters can share a GPC's SMs.
__global__ void __launch_bounds__(kThreads, 2)
pf_fused_forward_kernel(const float* __restrict__ parts0, const float* __restrict__ lw0,
                        const float* __restrict__ noise, const float* __restrict__ unis,
                        const float* __restrict__ rows, const float* __restrict__ gate,
                        const float* __restrict__ wdt, const float* __restrict__ bd,
                        const float* __restrict__ wmt, const float* __restrict__ bm,
                        float* __restrict__ est, float* __restrict__ out_parts,
                        float* __restrict__ out_lw, float* __restrict__ ll_out, int N,
                        int T, int M, int D, int K, float neg_log_m) {
  extern __shared__ float4 smem4[];  // float4 for 16-byte alignment
  __shared__ SlicePartials part;
  __shared__ ClusterRow merged[2];  // one per tail warp
  float* s_ring = reinterpret_cast<float*>(smem4);
  float* s_a = s_ring + kRing * kLayer;
  float* s_b = s_a + kUnits * kTile;
  float* s_parts = s_b + kUnits * kTile;   // (D, 64) belief carry of the tile
  float* s_newp = s_parts + kMaxD * kTile;  // (D, 64) propagated particles
  float* s_lls = s_newp + kMaxD * kTile;    // (K, 64) per-modality log-liks
  float* s_lw = s_lls + kMaxK * kTile;      // (64) log-weights
  float* s_scan = s_lw + kTile;             // (64) the tile's scan
  float* s_o = s_scan + kTile;              // (kMaxD + 1, 64) narrow outputs
  float* s_rows = s_o + (kMaxD + 1) * kTile;  // (1 + K, 64) hoisted rows of step t
  float* s_gate = s_rows + (1 + kMaxK) * kUnits;

  const int C = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int n = static_cast<int>(blockIdx.x) / C;
  const int start = rank * kTile;
  const int count = min(kTile, M - start);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t belief = static_cast<size_t>(n) * M + start;
  for (int idx = tid; idx < D * kTile; idx += kThreads) {
    const int d = idx / kTile, p = idx % kTile;
    s_parts[idx] = p < count ? parts0[(belief + p) * D + d] : 0.0f;
  }
  for (int p = tid; p < kTile; p += kThreads) s_lw[p] = p < count ? lw0[belief + p] : 0.0f;

  WeightRing ring{s_ring, wdt, wmt, kDynLayers + kMeasLayers * K, 0};
  ring.start();
  for (int t = 0; t < T; ++t) {
    const size_t tn = static_cast<size_t>(t) * N + n;
    const size_t slots = tn * M + start;  // this tile's slots of step t
    for (int idx = tid; idx < (1 + K) * kUnits; idx += kThreads)
      s_rows[idx] = rows[tn * (1 + K) * kUnits + idx];
    if (tid < K) s_gate[tid] = gate[tn * K + tid];

    // --- dynamics trunk on the tile ---
    dense_tile<kRelu>(ring.next(), bd, s_parts, D, s_a);
    resblock(ring, bd, 1, s_a, s_b);
    dense_tile<kLinear>(ring.next(), s_rows, s_a, kUnits, s_b);
    resblock(ring, bd, 4, s_b, s_a);
    resblock(ring, bd, 6, s_b, s_a);
    resblock(ring, bd, 8, s_b, s_a);
    dense_rows(ring.next(), bd + 10 * kUnits, s_b, D + 1, s_o);
    __syncthreads();
    // Barrier 2 of the previous step: peers are done gathering from this
    // block's propagated particles, scan and partials.
    if (t > 0) cluster_wait();
    for (int idx = tid; idx < D * kTile; idx += kThreads) {
      const int d = idx / kTile, p = idx % kTile;
      const float gate_logit = s_o[D * kTile + p];
      const float moved = s_parts[idx] + s_o[idx] * (1.0f / (1.0f + expf(-gate_logit)));
      const float nz = p < count ? noise[(slots + p) * D + d] : 0.0f;
      s_newp[idx] = moved + nz;
    }
    // --- measurement trunks on the same tile ---
    for (int k = 0; k < K; ++k) {
      const float* b = bm + static_cast<size_t>(k) * kMeasLayers * kUnits;
      dense_tile<kRelu>(ring.next(), b, s_newp, D, s_a);
      resblock(ring, b, 1, s_a, s_b);
      dense_tile<kRelu>(ring.next(), s_rows + (1 + k) * kUnits, s_a, kUnits, s_b);
      resblock(ring, b, 4, s_b, s_a);
      resblock(ring, b, 6, s_b, s_a);
      dense_rows(ring.next(), b + 8 * kUnits, s_b, 1, s_o);
      __syncthreads();
      if (tid < kTile) s_lls[k * kTile + tid] = s_o[tid] + s_gate[k];
    }
    __syncthreads();

    // --- fusion (raw logsumexp over modalities), weight update and the
    // tile's tail partials, by warp 0 (slots lane and lane + 32) ---
    if (warp == 0) {
      float v[2], e[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = lane + 32 * h;
        float ll = s_lls[p];
        if (K > 1) {
          float mx = ll;
          for (int k = 1; k < K; ++k) mx = fmaxf(mx, s_lls[k * kTile + p]);
          float s = 0.0f;
          for (int k = 0; k < K; ++k) s += expf(s_lls[k * kTile + p] - mx);
          ll = mx + logf(s);
        }
        v[h] = -INFINITY;
        if (p < count) {
          if (ll_out != nullptr) ll_out[slots + p] = ll;
          v[h] = s_lw[p] + ll;
          s_lw[p] = v[h];
        }
      }
      const float mx = warp_max(fmaxf(v[0], v[1]));
#pragma unroll
      for (int h = 0; h < 2; ++h) e[h] = lane + 32 * h < count ? expf(v[h] - mx) : 0.0f;
      const float lo = warp_inclusive_scan(e[0], lane);
      s_scan[lane] = lo;
      s_scan[lane + 32] = warp_inclusive_scan(e[1], lane) + __shfl_sync(kFull, lo, 31);
      float acc[kMaxD];
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        acc[d] = d < D ? warp_sum(e[0] * s_newp[d * kTile + lane] +
                                  e[1] * s_newp[d * kTile + lane + 32])
                       : 0.0f;
      __syncwarp();
      if (lane == 0) {
        part.max = mx;
        part.total = s_scan[count - 1];
#pragma unroll
        for (int d = 0; d < kMaxD; ++d) part.est[d] = acc[d];
      }
    }
    // Barrier 1: every block's partials, scan and propagated particles.
    cluster_sync();

    // --- merge, search and gather, by warps 0 and 1 (one slot a lane) ---
    if (warp < 2) {
      ClusterRow& row = merged[warp];
      merge_partials([&](int r) { return peer(&part, r); }, C, kTile, M, D, 1.0f, 0.0f, &row);
      if (rank == 0 && warp == 0 && lane < D) est[tn * D + lane] = row.est[lane];
      const int p = tid;
      if (p < count) {
        const Draw draw = cluster_lower_bound(
            row, C, [&](int r) -> const float* { return peer(s_scan, r); }, 0.0f,
            unis[slots + p]);
        const float* src = peer(s_newp, draw.rank);
        for (int d = 0; d < D; ++d) s_parts[d * kTile + p] = src[d * kTile + draw.local];
        s_lw[p] = neg_log_m;
      }
    }
    cluster_arrive();
  }
  cluster_wait();
  cp_async_wait<0>();
  __syncthreads();
  for (int idx = tid; idx < count * D; idx += kThreads) {
    const int p = idx / D, d = idx % D;
    out_parts[belief * D + idx] = s_parts[d * kTile + p];
  }
  for (int p = tid; p < count; p += kThreads) out_lw[belief + p] = s_lw[p];
}

size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kRing) * kLayer + 2 * kUnits * kTile +
                          (2 * kMaxD + kMaxK + 2 + kMaxD + 1) * kTile +
                          (1 + kMaxK) * kUnits + kMaxK);
}

// The launch configuration: N clusters of ceil(M / 64) blocks.
struct ClusterLaunch {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attribute;
};

int cluster_config(int N, int M, void* stream, ClusterLaunch* out) {
  if (N < 1 || M < 1 || M > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      pf_fused_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int C = (M + kTile - 1) / kTile;
  out->config = cudaLaunchConfig_t{};
  out->config.gridDim = dim3(static_cast<unsigned>(N * C));
  out->config.blockDim = dim3(kThreads);
  out->config.dynamicSmemBytes = smem;
  out->config.stream = static_cast<cudaStream_t>(stream);
  out->attribute.id = cudaLaunchAttributeClusterDimension;
  out->attribute.val.clusterDim.x = static_cast<unsigned>(C);
  out->attribute.val.clusterDim.y = 1;
  out->attribute.val.clusterDim.z = 1;
  out->config.attrs = &out->attribute;
  out->config.numAttrs = 1;
  return 0;
}

}  // namespace

extern "C" int pf_fused_forward_f32(const float* parts0, const float* lw0,
                                    const float* noise, const float* unis,
                                    const float* rows, const float* gate,
                                    const float* wdt, const float* bd,
                                    const float* wmt, const float* bm, float* est,
                                    float* out_parts, float* out_lw, float* ll_out,
                                    int N, int T, int M, int D, int K, void* stream) {
  if (T < 1 || D < 1 || D > kMaxD || K < 1 || K > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ClusterLaunch cl;
  const int rc = cluster_config(N, M, stream, &cl);
  if (rc != 0) return rc;
  const float neg_log_m = static_cast<float>(-log(static_cast<double>(M)));
  const cudaError_t err =
      cudaLaunchKernelEx(&cl.config, pf_fused_forward_kernel, parts0, lw0, noise, unis, rows,
                         gate, wdt, bd, wmt, bm, est, out_parts, out_lw, ll_out, N, T, M, D,
                         K, neg_log_m);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// What pf_fused_forward_f32 launches for N trajectories of M particles:
// the blocks of each cluster, the blocks in all, and how many such
// clusters the card holds at once (cudaOccupancyMaxActiveClusters).
extern "C" int pf_fused_forward_plan(int N, int M, int* cluster, int* blocks,
                                     int* max_clusters) {
  ClusterLaunch cl;
  const int rc = cluster_config(N, M, nullptr, &cl);
  if (rc != 0) return rc;
  *cluster = static_cast<int>(cl.attribute.val.clusterDim.x);
  *blocks = static_cast<int>(cl.config.gridDim.x);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(max_clusters, pf_fused_forward_kernel, &cl.config));
}

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
//   tail: B1's math on the row (pf_tail.cuh), est[t] before resampling,
//   then the resampled belief carried to t+1,
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
// Design. The TPU kernel's sequential (N, T) grid becomes one thread block
// per trajectory with the loop over T inside it. The belief (D x M, feature-
// major, padded to Mp = M rounded up to 64), the propagated particles, the K
// log-likelihood rows, the log-weights and the CDF stay in shared memory for
// the whole trajectory. The trunks walk the particles in column tiles of 64:
// two 64x64 activation buffers ping-pong through the layers (a residual
// block writes back into its input), and each layer's 64x64 weights are
// staged into shared memory from device memory, where all ~464 KiB of them
// (K = 2) stay L2-resident; they are never all held on chip (a block has at
// most 227 KB). 256 threads each own a 4x4 block of a layer's 64x64 output
// tile: per input feature one float4 of weights and one float4 of
// activations feed 16 fp32 FMAs (no TF32, for parity with the plain
// version). The tail is pf_tail.cuh's, on the shared-memory row.
//
// Bound. The trunks do 2 * 64 * 64 FLOPs per full layer: about 1.9e5 per
// particle-step at D = 3, K = 2 (9 full dynamics layers, 7 per modality,
// and the narrow ones), so 9.1e10 FLOPs at N = 16, T = 100, M = 300 -- 1.36
// ms at the card's 67 TFLOP/s fp32 rate. The bytes (noise, uniforms, rows,
// weights, belief and estimates, ~9.4 MB) take under 3 us at 3.35 TB/s, so
// the operations bound it. Known limit: one block per trajectory keeps only
// N of the 132 SMs busy (16 at N = 16) and one block of 8 warps hides
// little latency on its SM, so the kernel sits far above its bound at small
// N. Tensor cores, cp.async/TMA staging and splitting a trajectory's
// particles over a cluster are the redesign that answers that.
//
// Entry point: a plain C function (built with nvcc into a shared library and
// bound with ctypes). It launches on the given stream, allocates nothing,
// and returns cudaGetLastError() so the caller sees a refused launch.

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

// Stage one layer's (in, out) weights into shared memory. The leading
// barrier also publishes the previous layer's output and frees s_w.
__device__ __forceinline__ void stage(float* s_w, const float* __restrict__ g) {
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(g);
  float4* dst = reinterpret_cast<float4*>(s_w);
  for (int i = threadIdx.x; i < kLayer / 4; i += kThreads) dst[i] = __ldg(src + i);
  __syncthreads();
}

// y (64 x kTile) = epilogue(W x + add): W staged as wt[k * 64 + i]; x has
// `kdim` rows of leading dimension ldx; add is the bias or a hoisted row.
template <int kEpi>
__device__ __forceinline__ void dense_tile(const float* wt, const float* add,
                                           const float* x, int ldx, int kdim,
                                           float* y) {
  const int i0 = (threadIdx.x >> 4) * 4;
  const int p0 = (threadIdx.x & 15) * 4;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < kdim; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(wt + k * kUnits + i0);
    const float4 b = *reinterpret_cast<const float4*>(x + k * ldx + p0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float ad = add[i0 + r];
    float4* yr = reinterpret_cast<float4*>(y + (i0 + r) * kTile + p0);
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
__device__ __forceinline__ void resblock(float* s_w, const float* __restrict__ w,
                                         const float* __restrict__ b, int l, float* v,
                                         float* tmp) {
  stage(s_w, w + l * kLayer);
  dense_tile<kRelu>(s_w, b + l * kUnits, v, kTile, kUnits, tmp);
  stage(s_w, w + (l + 1) * kLayer);
  dense_tile<kResidual>(s_w, b + (l + 1) * kUnits, tmp, kTile, kUnits, v);
}

// The first `rows` outputs of a staged layer: out[j * kTile + p].
__device__ __forceinline__ void dense_rows(const float* wt, const float* __restrict__ bias,
                                           const float* x, int rows, float* out) {
  for (int idx = threadIdx.x; idx < rows * kTile; idx += kThreads) {
    const int j = idx / kTile, p = idx % kTile;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < kUnits; ++k) acc = fmaf(wt[k * kUnits + j], x[k * kTile + p], acc);
    out[idx] = acc + bias[j];
  }
}

__global__ void __launch_bounds__(kThreads)
pf_fused_forward_kernel(const float* __restrict__ parts0, const float* __restrict__ lw0,
                        const float* __restrict__ noise, const float* __restrict__ unis,
                        const float* __restrict__ rows, const float* __restrict__ gate,
                        const float* __restrict__ wdt, const float* __restrict__ bd,
                        const float* __restrict__ wmt, const float* __restrict__ bm,
                        float* __restrict__ est, float* __restrict__ out_parts,
                        float* __restrict__ out_lw, float* __restrict__ ll_out, int N,
                        int T, int M, int D, int K, float neg_log_m) {
  extern __shared__ float4 smem4[];  // float4 for 16-byte alignment
  __shared__ float red[32];
  const int mp = (M + kTile - 1) / kTile * kTile;
  float* s_w = reinterpret_cast<float*>(smem4);
  float* s_a = s_w + kLayer;
  float* s_b = s_a + kUnits * kTile;
  float* s_parts = s_b + kUnits * kTile;   // (D, mp) belief carry
  float* s_newp = s_parts + D * mp;        // (D, mp) propagated particles
  float* s_lls = s_newp + D * mp;          // (K, mp) per-modality log-liks
  float* s_lw = s_lls + K * mp;            // (mp) log-weights
  float* s_cdf = s_lw + mp;                // (mp)
  float* s_o = s_cdf + mp;                 // (kMaxD + 1, kTile) narrow outputs
  float* s_rows = s_o + (kMaxD + 1) * kTile;  // (1 + K, 64) hoisted rows of step t
  float* s_gate = s_rows + (1 + kMaxK) * kUnits;

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < D * mp; idx += kThreads) {
    const int d = idx / mp, m = idx % mp;
    s_parts[idx] = m < M ? parts0[(static_cast<size_t>(n) * M + m) * D + d] : 0.0f;
  }
  for (int m = tid; m < mp; m += kThreads) s_lw[m] = m < M ? lw0[static_cast<size_t>(n) * M + m] : 0.0f;

  for (int t = 0; t < T; ++t) {
    const size_t tn = static_cast<size_t>(t) * N + n;
    __syncthreads();
    for (int idx = tid; idx < (1 + K) * kUnits; idx += kThreads)
      s_rows[idx] = rows[tn * (1 + K) * kUnits + idx];
    if (tid < K) s_gate[tid] = gate[tn * K + tid];

    for (int c0 = 0; c0 < mp; c0 += kTile) {
      // --- dynamics trunk on columns [c0, c0 + 64) ---
      stage(s_w, wdt);
      dense_tile<kRelu>(s_w, bd, s_parts + c0, mp, D, s_a);
      resblock(s_w, wdt, bd, 1, s_a, s_b);
      stage(s_w, wdt + 3 * kLayer);
      dense_tile<kLinear>(s_w, s_rows, s_a, kTile, kUnits, s_b);
      resblock(s_w, wdt, bd, 4, s_b, s_a);
      resblock(s_w, wdt, bd, 6, s_b, s_a);
      resblock(s_w, wdt, bd, 8, s_b, s_a);
      stage(s_w, wdt + 10 * kLayer);
      dense_rows(s_w, bd + 10 * kUnits, s_b, D + 1, s_o);
      __syncthreads();
      for (int idx = tid; idx < D * kTile; idx += kThreads) {
        const int d = idx / kTile, p = idx % kTile, m = c0 + p;
        const float gate_logit = s_o[D * kTile + p];
        const float moved = s_parts[d * mp + m] + s_o[idx] * (1.0f / (1.0f + expf(-gate_logit)));
        const float nz = m < M ? noise[(tn * M + m) * D + d] : 0.0f;
        s_newp[d * mp + m] = moved + nz;
      }
      // --- measurement trunks on the same columns ---
      for (int k = 0; k < K; ++k) {
        const float* w = wmt + static_cast<size_t>(k) * kMeasLayers * kLayer;
        const float* b = bm + static_cast<size_t>(k) * kMeasLayers * kUnits;
        stage(s_w, w);
        dense_tile<kRelu>(s_w, b, s_newp + c0, mp, D, s_a);
        resblock(s_w, w, b, 1, s_a, s_b);
        stage(s_w, w + 3 * kLayer);
        dense_tile<kRelu>(s_w, s_rows + (1 + k) * kUnits, s_a, kTile, kUnits, s_b);
        resblock(s_w, w, b, 4, s_b, s_a);
        resblock(s_w, w, b, 6, s_b, s_a);
        stage(s_w, w + 8 * kLayer);
        dense_rows(s_w, b + 8 * kUnits, s_b, 1, s_o);
        __syncthreads();
        if (tid < kTile) s_lls[k * mp + c0 + tid] = s_o[tid] + s_gate[k];
      }
    }
    __syncthreads();

    // --- fusion (raw logsumexp over modalities) and weight update ---
    for (int m = tid; m < M; m += kThreads) {
      float ll = s_lls[m];
      if (K > 1) {
        float mx = ll;
        for (int k = 1; k < K; ++k) mx = fmaxf(mx, s_lls[k * mp + m]);
        float s = 0.0f;
        for (int k = 0; k < K; ++k) s += expf(s_lls[k * mp + m] - mx);
        ll = mx + logf(s);
      }
      if (ll_out != nullptr) ll_out[tn * M + m] = ll;
      s_lw[m] += ll;
    }
    __syncthreads();

    // --- tail: normalise, estimate, CDF, search, gather (pf_tail.cuh) ---
    const auto logit = [&](int m) { return s_lw[m]; };
    const RowStats st = row_stats(logit, M, red);
    const auto p = [&](int m) { return prob(s_lw[m], st); };
    const auto x = [&](int m, int d) { return s_newp[d * mp + m]; };
    row_estimate(p, x, M, D, red, est + tn * D);
    row_cdf(p, M, s_cdf, red);
    for (int j = tid; j < M; j += kThreads) {
      const int src = cdf_lower_bound(s_cdf, M, unis[tn * M + j]);
      for (int d = 0; d < D; ++d) s_parts[d * mp + j] = s_newp[d * mp + src];
      s_lw[j] = neg_log_m;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < M * D; idx += kThreads) {
    const int m = idx / D, d = idx % D;
    out_parts[static_cast<size_t>(n) * M * D + idx] = s_parts[d * mp + m];
  }
  for (int m = tid; m < M; m += kThreads) out_lw[static_cast<size_t>(n) * M + m] = s_lw[m];
}

}  // namespace

extern "C" int pf_fused_forward_f32(const float* parts0, const float* lw0,
                                    const float* noise, const float* unis,
                                    const float* rows, const float* gate,
                                    const float* wdt, const float* bd,
                                    const float* wmt, const float* bm, float* est,
                                    float* out_parts, float* out_lw, float* ll_out,
                                    int N, int T, int M, int D, int K, void* stream) {
  if (N < 1 || T < 1 || M < 1 || M > kMaxM || D < 1 || D > kMaxD || K < 1 || K > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int mp = (M + kTile - 1) / kTile * kTile;
  const size_t floats = static_cast<size_t>(kLayer) + 2 * kUnits * kTile +
                        static_cast<size_t>(2 * D + K + 2) * mp + (kMaxD + 1) * kTile +
                        (1 + kMaxK) * kUnits + kMaxK;
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pf_fused_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float neg_log_m = static_cast<float>(-log(static_cast<double>(M)));
  pf_fused_forward_kernel<<<N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      parts0, lw0, noise, unis, rows, gate, wdt, bd, wmt, bm, est, out_parts, out_lw, ll_out,
      N, T, M, D, K, neg_log_m);
  return static_cast<int>(cudaGetLastError());
}

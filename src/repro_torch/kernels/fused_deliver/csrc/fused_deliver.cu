// Fused stage-1 scatter + stage-2 CAM match, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_deliver_kernel` / `fused_deliver_pallas` in
// src/repro/kernels/fused_deliver/fused_deliver.py. For batch element b and
// cluster c it builds the tag-activity row
//
//     A[b, c, k] = ext[b, c, k] + sum_i ev_w[b, i] * [ev_flat[b, i] == c*K + k]
//
// from the queued events' flat SRAM entries (ev_flat = dest*K + tag, -1 =
// empty), then CAM-matches it as the cam_match kernel does:
//
//     drive[b, n, t] = sum_s A[b, c, cam_tag[n, s]] * [cam_syn[n, s] == t]
//
// The activity matrix never reaches device memory.
//
// What bounds it on this card: bytes. Each (b, c) block reads its batch
// row's Q*E entries and weights (192 KB at the Table-V serving shape, Q =
// 1536, E = 16; the six cluster blocks of one batch row share them through
// L2), its external-activity row (4 KB) and the cluster's CAM words, and
// writes 256 x 4 floats. The arithmetic is one compare per queue entry and
// one add per matched entry and per valid CAM word: far below the FP32 line.
//
// What the design does about it: one block owns a whole (cluster, batch
// element) pair. The TPU kernel builds the row once at neuron tile j == 0
// and reuses it for later tiles (`@pl.when(j == 0)`), which relies on the
// TPU's sequential grid; GPU blocks run in no order and share nothing, so
// here one block builds the row and matches every neuron of the cluster.
// Stage 1's one-hot compare-plane matmul becomes a block-stride walk over
// the entries with shared-memory atomicAdd into the row; entries for other
// clusters and empty entries are skipped. Integer-valued weights give sums
// that are exact in any atomic order.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

__global__ void fused_deliver_kernel(const int32_t* __restrict__ ev_flat,  // [B, QE]
                                     const float* __restrict__ ev_w,       // [B, QE]
                                     const float* __restrict__ ext,        // [B, nc, K] or null
                                     const int32_t* __restrict__ cam_tag,  // [N, S]
                                     const int32_t* __restrict__ cam_syn,  // [N, S]
                                     float4* __restrict__ drive,           // [B, N] x 4
                                     int n_clusters, int cluster_size, int k_tags,
                                     int s_words, int qe) {
  extern __shared__ float row[];  // [K]: this (batch, cluster)'s activity
  const int c = blockIdx.x;
  const long long b = blockIdx.y;

  // stage 1: external activity, then the queued entries addressed to c
  if (ext != nullptr) {
    const float* e = ext + (b * n_clusters + c) * static_cast<long long>(k_tags);
    for (int k = threadIdx.x; k < k_tags; k += blockDim.x) row[k] = e[k];
  } else {
    for (int k = threadIdx.x; k < k_tags; k += blockDim.x) row[k] = 0.f;
  }
  __syncthreads();
  const int32_t* f = ev_flat + b * qe;
  const float* w = ev_w + b * qe;
  const int lo = c * k_tags;
  for (int i = threadIdx.x; i < qe; i += blockDim.x) {
    const int local = f[i] - lo;  // -1 (empty) and other clusters fall outside [0, K)
    if (local >= 0 && local < k_tags) atomicAdd(&row[local], w[i]);
  }
  __syncthreads();

  // stage 2: CAM match of the shared row, one thread per neuron
  const long long n_neurons = static_cast<long long>(n_clusters) * cluster_size;
  for (int j = threadIdx.x; j < cluster_size; j += blockDim.x) {
    const long long n = static_cast<long long>(c) * cluster_size + j;
    const int32_t* tags = cam_tag + n * s_words;
    const int32_t* syns = cam_syn + n * s_words;
    float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
    for (int s = 0; s < s_words; ++s) {
      const int t = tags[s];
      if (t < 0) continue;
      const float v = row[min(t, k_tags - 1)];
      switch (syns[s]) {
        case 0: d0 += v; break;
        case 1: d1 += v; break;
        case 2: d2 += v; break;
        case 3: d3 += v; break;
        default: break;
      }
    }
    drive[b * n_neurons + n] = make_float4(d0, d1, d2, d3);
  }
}

}  // namespace

extern "C" int fused_deliver_launch(const void* ev_flat, const void* ev_w,
                                    const void* ext, const void* cam_tag,
                                    const void* cam_syn, void* drive, int batch,
                                    int n_clusters, int cluster_size, int k_tags,
                                    int s_words, int qe, void* stream) {
  const int threads = std::min(1024, (cluster_size + 31) / 32 * 32);
  const size_t smem = static_cast<size_t>(k_tags) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_deliver_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_clusters, batch);
  fused_deliver_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ev_flat), static_cast<const float*>(ev_w),
      static_cast<const float*>(ext), static_cast<const int32_t*>(cam_tag),
      static_cast<const int32_t*>(cam_syn), static_cast<float4*>(drive), n_clusters,
      cluster_size, k_tags, s_words, qe);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

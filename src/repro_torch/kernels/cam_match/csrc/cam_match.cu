// Stage-2 CAM match, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_cam_match_kernel` / `cam_match_pallas` in
// src/repro/kernels/cam_match/cam_match.py. For batch element b and every
// neuron n of cluster c:
//
//     drive[b, n, t] = sum_s A[b, c, cam_tag[n, s]] * [cam_syn[n, s] == t]
//
// Words with cam_tag < 0 are empty and add nothing; a tag past K - 1 reads
// cell K - 1, as the plain version's clamp does. A synapse type outside
// [0, 4) adds nothing, as its one-hot row is zero.
//
// What bounds it on this card: bytes. Per (b, c) it reads one K-row of
// activity (4 KB at K = 1024) and the cluster's CAM words (256 x 64 words
// x 2 int32 = 128 KB, shared by the whole batch, so from L2 after the first
// batch element) and writes 256 x 4 floats. The arithmetic is one add per
// valid CAM word, some 3 M at the Table-V serving shape: far below both the
// FP32 line and the tensor-core line.
//
// What the design does about it: one block per (cluster, batch element),
// one thread per neuron. The block stages its activity row in shared
// memory (the TPU kernel's VMEM-pinned row), so each CAM word costs one
// shared-memory read instead of the MXU one-hot compare plane, which on
// Hopper would multiply the work by K. Each thread keeps the four
// synapse-type sums in registers and stores them once, as one float4.
// Integer-valued activity gives sums that are exact in any order.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

__global__ void cam_match_kernel(const float* __restrict__ activity,  // [B, nc, K]
                                 const int32_t* __restrict__ cam_tag,  // [N, S]
                                 const int32_t* __restrict__ cam_syn,  // [N, S]
                                 float4* __restrict__ drive,           // [B, N] x 4
                                 int n_clusters, int cluster_size, int k_tags,
                                 int s_words) {
  extern __shared__ float row[];  // [K]: this (batch, cluster)'s activity
  const int c = blockIdx.x;
  const long long b = blockIdx.y;
  const float* a = activity + (b * n_clusters + c) * static_cast<long long>(k_tags);
  for (int k = threadIdx.x; k < k_tags; k += blockDim.x) row[k] = a[k];
  __syncthreads();

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

extern "C" int cam_match_launch(const void* activity, const void* cam_tag,
                                const void* cam_syn, void* drive, int batch,
                                int n_clusters, int cluster_size, int k_tags,
                                int s_words, void* stream) {
  const int threads = std::min(1024, (cluster_size + 31) / 32 * 32);
  const size_t smem = static_cast<size_t>(k_tags) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cam_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_clusters, batch);
  cam_match_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(activity), static_cast<const int32_t*>(cam_tag),
      static_cast<const int32_t*>(cam_syn), static_cast<float4*>(drive), n_clusters,
      cluster_size, k_tags, s_words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

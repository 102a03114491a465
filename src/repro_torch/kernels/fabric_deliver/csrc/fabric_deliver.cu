// Time-wheel fabric delivery (ring update + arrival pop + CAM match),
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fabric_deliver_kernel` / `fabric_deliver_ring_pallas`
// in src/repro/kernels/fabric_deliver/fabric_deliver.py:52. For batch
// element b and cluster c, with D1 ring slots and the 0-dim cursor `cur`:
//
//     col[d, k] = ring[b, d, c, k]
//                 + sum_m w[b, m] * [(cur + delay[m]) % D1 == d] * [dstk[m] == c*K + k]
//     A[k]      = col[cur, k] + ext[b, c, k]
//     ring_out[b, d, c, k] = (d == cur) ? 0 : col[d, k]
//     drive[b, n, t] = sum_s A[cam_tag[n, s]] * [cam_syn[n, s] == t]   (n in cluster c)
//
// The entry columns dstk (dst_cluster * K + tag) and delay are static and
// shared by the batch; w holds the step's masked weights (0 = dropped,
// silent or pad). The cursor is read through a pointer, so the host never
// waits on it. Queue admission, link arbitration and the stats stay
// outside, in the prefix counts of ops.py:fabric_deliver_ring.
//
// What bounds it on this card: bytes. At the Table-V serving shape (B = 32,
// D1 = 2, 6 clusters, K = 1024, M = 1280 entries, 1536 neurons x 64 CAM
// words) one call reads the ring (1.57 MB) and writes the new one (1.57 MB),
// reads ext (0.79 MB), the weights (0.16 MB), the entry columns (10 KB) and
// the CAM tables (0.79 MB), and writes the drive (0.79 MB): about 5.67 MB,
// 1.7 us at 3.35 TB/s. The arithmetic is one compare per entry, one add per
// matching entry and one per valid CAM word: far below the FP32 line.
//
// What the design does about it: every byte of the ring and of ext is read
// once and every byte of the new ring and the drive is written once. One
// block owns one (cluster, batch element) pair and stages its ring column
// (D1 x K floats, 8 KB at D1 = 2) in shared memory; the arrival row never
// leaves the SM between the ring update and the CAM match. The TPU kernel
// builds the column at neuron tile j == 0 and relies on its sequential grid,
// with one compare-plane matmul per delay slot; GPU blocks run in no order,
// so here one block walks the M entries with shared-memory atomicAdd into
// the right slot and then matches every neuron of the cluster, one thread
// per neuron with four register sums, as cam_match.cu does. The entry
// columns and CAM tables are shared by all blocks and come from L2 after
// the first touch. Integer-valued weights and ext (0/1 spikes, event counts
// x 8.0 on the serving path) give sums that are exact in any atomic order.
// A column larger than the shared memory a block can hold is refused by the
// wrapper (ops.py); there is no fallback.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

__global__ void fabric_deliver_kernel(const int32_t* __restrict__ dstk,    // [M]
                                      const int32_t* __restrict__ delay,   // [M]
                                      const float* __restrict__ w,         // [B, M]
                                      const float* __restrict__ ring,      // [B, D1, nc, K]
                                      const int32_t* __restrict__ cursor,  // []
                                      const float* __restrict__ ext,       // [B, nc, K] or null
                                      const int32_t* __restrict__ cam_tag, // [N, S]
                                      const int32_t* __restrict__ cam_syn, // [N, S]
                                      float4* __restrict__ drive,          // [B, N] x 4
                                      float* __restrict__ ring_out,        // [B, D1, nc, K]
                                      int n_clusters, int cluster_size, int k_tags,
                                      int s_words, int d1, int m) {
  extern __shared__ float col[];  // [D1, K]: this (batch, cluster)'s ring column
  const int c = blockIdx.x;
  const long long b = blockIdx.y;
  const int cur = *cursor;
  const long long plane = static_cast<long long>(n_clusters) * k_tags;  // one slot
  const long long base = b * d1 * plane + static_cast<long long>(c) * k_tags;
  const int cells = d1 * k_tags;

  // load the carried column
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int d = i / k_tags;
    col[i] = ring[base + d * plane + (i - d * k_tags)];
  }
  __syncthreads();

  // scatter this step's entries addressed to cluster c into their slots
  const float* wb = w + b * m;
  const int lo = c * k_tags;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int local = dstk[i] - lo;  // other clusters fall outside [0, K)
    if (local >= 0 && local < k_tags) {
      const int slot = (cur + delay[i]) % d1;
      atomicAdd(&col[slot * k_tags + local], wb[i]);
    }
  }
  __syncthreads();

  // pop the cursor slot: write the column back with that slot zeroed, and
  // keep cursor slot + external input in shared memory as the arrival row
  const float* ext_bc =
      ext == nullptr ? nullptr : ext + (b * n_clusters + c) * static_cast<long long>(k_tags);
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int d = i / k_tags;
    const int k = i - d * k_tags;
    if (d == cur) {
      ring_out[base + d * plane + k] = 0.f;
      if (ext_bc != nullptr) col[i] += ext_bc[k];
    } else {
      ring_out[base + d * plane + k] = col[i];
    }
  }
  __syncthreads();

  // CAM match of the arrival row, one thread per neuron
  const float* row = col + cur * k_tags;
  const long long n_neurons = static_cast<long long>(n_clusters) * cluster_size;
  for (int j = threadIdx.x; j < cluster_size; j += blockDim.x) {
    const long long n = static_cast<long long>(c) * cluster_size + j;
    const int32_t* tags = cam_tag + n * s_words;
    const int32_t* syns = cam_syn + n * s_words;
    float d0 = 0.f, d1s = 0.f, d2 = 0.f, d3 = 0.f;
    for (int s = 0; s < s_words; ++s) {
      const int t = tags[s];
      if (t < 0) continue;
      const float v = row[min(t, k_tags - 1)];
      switch (syns[s]) {
        case 0: d0 += v; break;
        case 1: d1s += v; break;
        case 2: d2 += v; break;
        case 3: d3 += v; break;
        default: break;
      }
    }
    drive[b * n_neurons + n] = make_float4(d0, d1s, d2, d3);
  }
}

}  // namespace

extern "C" int fabric_deliver_launch(const void* dstk, const void* delay, const void* w,
                                     const void* ring, const void* cursor, const void* ext,
                                     const void* cam_tag, const void* cam_syn, void* drive,
                                     void* ring_out, int batch, int n_clusters,
                                     int cluster_size, int k_tags, int s_words, int d1,
                                     int m, void* stream) {
  const int threads = std::min(1024, std::max(32, (cluster_size + 31) / 32 * 32));
  const size_t smem = static_cast<size_t>(d1) * k_tags * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fabric_deliver_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_clusters, batch);
  fabric_deliver_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(dstk), static_cast<const int32_t*>(delay),
      static_cast<const float*>(w), static_cast<const float*>(ring),
      static_cast<const int32_t*>(cursor), static_cast<const float*>(ext),
      static_cast<const int32_t*>(cam_tag), static_cast<const int32_t*>(cam_syn),
      static_cast<float4*>(drive), static_cast<float*>(ring_out), n_clusters,
      cluster_size, k_tags, s_words, d1, m);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of shared memory one block of this kernel may opt in to on `device`,
// or the negated cudaError_t when it cannot be read.
extern "C" int fabric_deliver_max_shared_bytes(int device) {
  int bytes = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? bytes : -static_cast<int>(e);
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

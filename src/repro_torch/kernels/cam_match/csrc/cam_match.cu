// Stage-2 CAM match, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_cam_match_kernel` / `cam_match_pallas` in
// src/repro/kernels/cam_match/cam_match.py:39. For batch element b and every
// neuron n of cluster c:
//
//     drive[b, n, t] = sum_s A[b, c, cam_tag[n, s]] * [cam_syn[n, s] == t]
//
// Words with cam_tag < 0 are empty and add nothing; a tag past K - 1 reads
// cell K - 1, as the plain version's clamp does. A synapse type outside
// [0, 4) adds nothing, as its one-hot row is zero.
//
// What bounds it on this card: latency, not bytes or operations. At the
// Table-V serving shape (B = 32, 6 clusters of 256, K = 1024, S = 64) one
// call reads the activity (0.79 MB) and the CAM tables (0.79 MB) and writes
// the drive (0.79 MB): about 2.4 MB, 0.7 us at 3.35 TB/s. The arithmetic is
// one add per valid CAM word and batch element, some 3 M: far below the
// FP32 line. What costs time is the chain of each block: read the CAM words
// and the activity rows, stage the rows, walk the words, store.
//
// What the design does about it:
// - A block of cam_rows::kThreads threads owns (cluster c, one part of the
//   cluster's neurons, a tile of TB batch elements); the grid is
//   (n_clusters x parts, ceil(B / TB)). Nothing is shared between the
//   blocks, so there is no thread-block cluster.
// - Before anything else each thread issues the 16-byte CAM reads of its
//   first pass of neurons (cam_rows::load_cam); only then are the TB
//   activity rows read, coalesced, into registers, and stored interleaved
//   in shared memory, rows[k * TB + tb], with cell K = 0 for empty words.
// - Stage 2 is common/cam_rows.cuh, shared with fused_deliver.cu and
//   fabric_deliver.cu: four lanes per neuron, each CAM word looked up in all
//   TB rows with one shared load, so the CAM tables are read once per tile
//   and not once per batch element; one 16-byte store of drive per neuron
//   and batch element.
// The work split (TB, parts) is the wrapper's (ops.py, kernels/_split.py).
// Indices are 32-bit (the wrapper refuses larger tensors). A block whose
// rows do not fit in shared memory is refused by the wrapper; there is no
// fallback. Integer-valued activity gives sums that are exact in any order.

#include <cuda_runtime.h>

#include <cstdint>

#include "../../common/cam_rows.cuh"

using cam_rows::kThreads;

namespace {

constexpr int kRowCells = 16;  // cells of the activity rows per thread, loaded first

template <int TB, bool VEC_S>
__global__ void __launch_bounds__(kThreads) cam_match_kernel(
    const float* __restrict__ activity,    // [B, nc, K]
    const int32_t* __restrict__ cam_tag,   // [N, S]
    const int32_t* __restrict__ cam_syn,   // [N, S]
    float* __restrict__ drive,             // [B, N, 4]
    int batch, int n_clusters, int cluster_size, int k_tags, int s_words, int parts) {
  extern __shared__ __align__(16) float rows[];  // [K + 1][TB] interleaved, cell K stays 0

  const int part = blockIdx.x % parts;
  const int c = blockIdx.x / parts;
  const int b0 = blockIdx.y * TB;
  const int span = (cluster_size + parts - 1) / parts;
  const int first = c * cluster_size;
  const int n_begin = first + min(cluster_size, part * span);
  const int n_end = first + min(cluster_size, (part + 1) * span);

  // the CAM words of the first pass of neurons, first of all
  cam_rows::CamVectors cv{};
  if constexpr (VEC_S) {
    const int n = n_begin + threadIdx.x / cam_rows::kLanes;
    cam_rows::load_cam(cam_tag, cam_syn, s_words, n, n < n_end, cv);
  }

  // Thread t holds the cells t, t + kThreads, ... of the interleaved rows
  // (so that its shared stores fall on consecutive words): all of them in
  // row t % TB, whose global reads are coalesced along k.
  constexpr int kStep = kThreads / TB;  // tags between a thread's cells
  const int t_row = threadIdx.x % TB;
  const int t_tag = threadIdx.x / TB;
  const bool t_in = b0 + t_row < batch;
  const float* a = activity + (t_in ? ((b0 + t_row) * n_clusters + c) * k_tags : 0);
  float av[kRowCells];
#pragma unroll
  for (int u = 0; u < kRowCells; ++u) {
    const int k = t_tag + u * kStep;
    av[u] = t_in && k < k_tags ? __ldg(a + k) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kRowCells; ++u) {
    if (t_tag + u * kStep < k_tags) rows[threadIdx.x + u * kThreads] = av[u];
  }
  for (int k = t_tag + kRowCells * kStep; k < k_tags; k += kStep) {
    rows[k * TB + t_row] = t_in ? __ldg(a + k) : 0.f;
  }
  if (threadIdx.x < TB) rows[k_tags * TB + threadIdx.x] = 0.f;
  __syncthreads();

  cam_rows::match_neurons<TB, VEC_S>(cam_tag, cam_syn, s_words, rows, k_tags, n_begin, n_end, b0,
                                     batch, n_clusters * cluster_size, cv, drive);
}

size_t shared_bytes(int batch_tile, int k_tags) {
  return sizeof(float) * static_cast<size_t>(batch_tile) * (static_cast<size_t>(k_tags) + 1);
}

using Kernel = void (*)(const float*, const int32_t*, const int32_t*, float*, int, int, int, int,
                        int, int);

Kernel select_kernel(int batch_tile, bool vec_s) {
  switch (batch_tile) {
    case 1: return vec_s ? &cam_match_kernel<1, true> : &cam_match_kernel<1, false>;
    case 2: return vec_s ? &cam_match_kernel<2, true> : &cam_match_kernel<2, false>;
    case 4: return vec_s ? &cam_match_kernel<4, true> : &cam_match_kernel<4, false>;
    case 8: return vec_s ? &cam_match_kernel<8, true> : &cam_match_kernel<8, false>;
    default: return nullptr;
  }
}

}  // namespace

// Launches one CAM match on `stream`. batch_tile (1, 2, 4 or 8) and parts
// (blocks per (cluster, tile), 1..8) are the wrapper's work split. Returns a
// cudaError_t.
extern "C" int cam_match_launch(const void* activity, const void* cam_tag, const void* cam_syn,
                                void* drive, int batch, int n_clusters, int cluster_size,
                                int k_tags, int s_words, int batch_tile, int parts,
                                void* stream) {
  const Kernel kernel =
      select_kernel(batch_tile, cam_rows::vector_rows(cam_tag, cam_syn, s_words));
  if (kernel == nullptr || parts < 1 || parts > 8) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_clusters * parts, (batch + batch_tile - 1) / batch_tile);
  return static_cast<int>(cam_rows::launch(
      kernel, grid, 1, shared_bytes(batch_tile, k_tags), static_cast<cudaStream_t>(stream),
      static_cast<const float*>(activity), static_cast<const int32_t*>(cam_tag),
      static_cast<const int32_t*>(cam_syn), static_cast<float*>(drive), batch, n_clusters,
      cluster_size, k_tags, s_words, parts));
}

// The kernel instance of the Table-V shape (int4 reads of the CAM rows) at
// this batch tile on the current card: registers and local (spill) bytes per
// thread, the block's dynamic shared bytes, and the blocks that fit on one
// SM. Returns a cudaError_t.
extern "C" int cam_match_kernel_info(int batch_tile, int k_tags, int* registers,
                                     int* local_bytes, int* shared, int* blocks_per_sm) {
  const Kernel kernel = select_kernel(batch_tile, true);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *shared = static_cast<int>(shared_bytes(batch_tile, k_tags));
  return static_cast<int>(
      cam_rows::kernel_info(kernel, *shared, registers, local_bytes, blocks_per_sm));
}

// Bytes of shared memory one block of this kernel may opt in to on `device`,
// or the negated cudaError_t when it cannot be read.
extern "C" int cam_match_max_shared_bytes(int device) {
  int bytes = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? bytes : -static_cast<int>(e);
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

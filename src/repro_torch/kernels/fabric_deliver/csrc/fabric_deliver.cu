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
// shared by the batch, in arbitration order; w holds the step's masked
// weights in the same order (0 = dropped, silent or pad). The static
// per-cluster ranges (cluster_start [nc + 1], cluster_order [M]: entry
// indices grouped by dstk / K) name each cluster's own entries. The cursor
// is read through a pointer, so the host never waits on it. Queue
// admission, link arbitration and the stats stay outside, in the prefix
// counts of ops.py:fabric_deliver_ring.
//
// What bounds it on this card: latency, not bytes or operations. At the
// Table-V serving shape (B = 32, D1 = 2, 6 clusters, K = 1024, M = 1280
// entries, 1536 neurons x 64 CAM words) one call reads the ring (1.57 MB),
// ext (0.79 MB), the weights (0.16 MB), the entry columns and the CAM
// tables (0.79 MB), and writes the new ring (1.57 MB) and the drive
// (0.79 MB): about 5.7 MB, 1.7 us at 3.35 TB/s. The arithmetic is one add
// per entry carrying weight and one per valid CAM word and batch element:
// far below the FP32 line. What costs time is a chain of dependent steps
// per block: load, scatter, pop, match.
//
// What the design does about it:
// - A block owns (cluster c, a tile of TB batch elements, one part of the
//   cluster's neurons and a k-slice of its ring column). The first round of
//   reads issues, all at once, the tile's cursor slot and ext rows (the
//   whole of K: every block needs the whole arrival row), the block's
//   k-slice of the other slots, the CAM words of its first pass of neurons,
//   and its cluster's first entries (entry range, then the entry ids,
//   then their columns and weights).
// - Stage 1 walks only cluster c's own entries: its static range of
//   cluster_order, read through the permutation, skipping zero weights.
//   An entry due now is added to the arrival rows in every block of (c,
//   tile); a later one only by the block whose k-slice holds it, which
//   writes its slice of the new ring (the cursor slot zeroed): every cell of
//   the new ring is written once, with no sync between blocks, and the ring
//   passed in is never written. The arrival rows are the cursor slot plus
//   the entries due now plus ext.
// - Stage 2 is common/cam_rows.cuh: four lanes per neuron with coalesced
//   16-byte CAM reads, each CAM word looked up in the TB interleaved arrival
//   rows by one shared load, so the CAM tables are read once per tile.
// The work split (TB, parts) is the wrapper's (ops.py, kernels/_split.py).
// Integer-valued weights and ext (0/1 spikes, event counts x 8.0 on the
// serving path) give sums that are exact in any atomic order. A block
// larger than the shared memory it can hold is refused by the wrapper; there
// is no fallback.

#include <cuda_runtime.h>

#include <cstdint>

#include "../../common/cam_rows.cuh"

using cam_rows::kThreads;

namespace {

constexpr int kRowCells = 16;   // cells of the cursor slot and of ext per thread, loaded first
constexpr int kSliceCells = 8;  // cells of the other slots' k-slice per thread, loaded first

template <int TB, bool VEC_S>
__global__ void __launch_bounds__(kThreads) fabric_deliver_kernel(
    const int32_t* __restrict__ dstk,           // [M]
    const int32_t* __restrict__ delay,          // [M]
    const float* __restrict__ w,                // [B, M]
    const float* __restrict__ ring,             // [B, D1, nc, K]
    const int32_t* __restrict__ cursor,         // []
    const float* __restrict__ ext,              // [B, nc, K] or null
    const int32_t* __restrict__ cam_tag,        // [N, S]
    const int32_t* __restrict__ cam_syn,        // [N, S]
    const int32_t* __restrict__ cluster_start,  // [nc + 1]
    const int32_t* __restrict__ cluster_order,  // [M]
    float* __restrict__ drive,                  // [B, N, 4]
    float* __restrict__ ring_out,               // [B, D1, nc, K]
    int batch, int n_clusters, int cluster_size, int k_tags, int s_words, int d1, int m,
    int parts) {
  extern __shared__ __align__(16) float smem[];
  const int slice = (k_tags + parts - 1) / parts;
  float* arrival = smem;                  // [K + 1][TB] interleaved, cell K stays 0
  float* col = smem + (k_tags + 1) * TB;  // [TB][D1][nk]: the k-slice of every slot

  const int part = blockIdx.x % parts;
  const int c = blockIdx.x / parts;
  const int b0 = blockIdx.y * TB;
  const int k_lo = min(k_tags, part * slice);
  const int nk = min(k_tags, k_lo + slice) - k_lo;
  const int plane = n_clusters * k_tags;  // one slot
  const int c_off = c * k_tags;
  const int span = (cluster_size + parts - 1) / parts;
  const int first = c * cluster_size;
  const int n_begin = first + min(cluster_size, part * span);
  const int n_end = first + min(cluster_size, (part + 1) * span);
  const int cells = TB * d1 * nk;

  // One round of loads, all in flight together, the independent ones
  // first: the cursor and this cluster's entry range; ext of the tile (whole
  // rows: every block needs the whole arrival row) and the first pass's CAM
  // words; then, from the cursor, the cursor slot of the tile and the
  // k-slice of the other slots.
  const int cur = *cursor;
  const int e_lo = cluster_start[c];
  const int e_n = cluster_start[c + 1] - e_lo;
  // Thread t holds the cells t, t + kThreads, ... of the interleaved
  // arrival rows (so that its shared stores fall on consecutive words): all
  // of them in row t % TB.
  constexpr int kStep = kThreads / TB;  // tags between a thread's cells
  const int t_row = threadIdx.x % TB;
  const int t_tag = threadIdx.x / TB;
  const bool t_in = b0 + t_row < batch;
  const float* ext_t =
      ext != nullptr && t_in ? ext + ((b0 + t_row) * n_clusters + c) * k_tags : nullptr;
  float xv[kRowCells];
#pragma unroll
  for (int u = 0; u < kRowCells; ++u) {
    const int k = t_tag + u * kStep;
    xv[u] = ext_t != nullptr && k < k_tags ? __ldg(ext_t + k) : 0.f;
  }
  cam_rows::CamVectors cv{};
  if constexpr (VEC_S) {
    const int n = n_begin + threadIdx.x / cam_rows::kLanes;
    cam_rows::load_cam(cam_tag, cam_syn, s_words, n, n < n_end, cv);
  }
  const float* ring_t = ring + ((b0 + t_row) * d1 + cur) * plane + c_off;
  float rv[kRowCells];
#pragma unroll
  for (int u = 0; u < kRowCells; ++u) {
    const int k = t_tag + u * kStep;
    rv[u] = t_in && k < k_tags ? __ldg(ring_t + k) : 0.f;
  }
  // the k-slice of the other slots: cell i = (tb * D1 + d) * nk + k of
  // `col`, thread t holding cells t, t + kThreads, ...
  float sv[kSliceCells];
  {
    const int row = nk > 0 ? threadIdx.x / nk : 0;  // tb * D1 + d
    int k = threadIdx.x - row * nk, tb = row / d1, d = row - tb * d1;
#pragma unroll
    for (int u = 0; u < kSliceCells; ++u) {
      const int b = b0 + tb;
      sv[u] = tb < TB && k < nk && b < batch && d != cur
                  ? __ldg(ring + (b * d1 + d) * plane + c_off + k_lo + k)
                  : 0.f;
      for (k += kThreads; nk > 0 && k >= nk; k -= nk) {
        if (++d == d1) {
          d = 0;
          ++tb;
        }
      }
    }
  }

  // the first kThreads entries of cluster c, last: a chain of dependent
  // reads (entry range, entry id, then its columns and weights)
  auto load_entry = [&](int e, int& local, int& slot, float (&wv)[TB]) {
    const int idx = cluster_order[e_lo + e];
    local = dstk[idx] - c_off;
    slot = (cur + delay[idx]) % d1;
#pragma unroll
    for (int tb = 0; tb < TB; ++tb) wv[tb] = b0 + tb < batch ? w[(b0 + tb) * m + idx] : 0.f;
  };
  int e_local = -1, e_slot = 0;
  float e_w[TB];
#pragma unroll
  for (int tb = 0; tb < TB; ++tb) e_w[tb] = 0.f;
  if (threadIdx.x < e_n) load_entry(threadIdx.x, e_local, e_slot, e_w);

  // the arrival rows start as the cursor slot; the k-slice of every slot
#pragma unroll
  for (int u = 0; u < kRowCells; ++u) {
    if (t_tag + u * kStep < k_tags) arrival[threadIdx.x + u * kThreads] = rv[u];
  }
  for (int k = t_tag + kRowCells * kStep; k < k_tags; k += kStep) {
    arrival[k * TB + t_row] = t_in ? ring_t[k] : 0.f;
  }
  if (threadIdx.x < TB) arrival[k_tags * TB + threadIdx.x] = 0.f;
#pragma unroll
  for (int u = 0; u < kSliceCells; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < cells) col[i] = sv[u];
  }
  for (int i = threadIdx.x + kSliceCells * kThreads; i < cells; i += kThreads) {
    const int row = i / nk;
    const int tb = row / d1;
    const int d = row - tb * d1;
    const int b = b0 + tb;
    col[i] = b < batch && d != cur ? ring[(b * d1 + d) * plane + c_off + k_lo + (i - row * nk)]
                                   : 0.f;
  }
  __syncthreads();

  // this step's entries of cluster c: arrivals now into the whole arrival
  // rows, later ones into the slice; zero weights add nothing
  auto add_entry = [&](int local, int slot, const float (&wv)[TB]) {
    if (local < 0 || local >= k_tags) return;
    if (slot == cur) {
#pragma unroll
      for (int tb = 0; tb < TB; ++tb) {
        if (wv[tb] != 0.f) atomicAdd(&arrival[local * TB + tb], wv[tb]);
      }
    } else if (local >= k_lo && local < k_lo + nk) {
#pragma unroll
      for (int tb = 0; tb < TB; ++tb) {
        if (wv[tb] != 0.f) atomicAdd(&col[(tb * d1 + slot) * nk + local - k_lo], wv[tb]);
      }
    }
  };
  add_entry(e_local, e_slot, e_w);
  for (int e = threadIdx.x + kThreads; e < e_n; e += kThreads) {
    load_entry(e, e_local, e_slot, e_w);
    add_entry(e_local, e_slot, e_w);
  }
  __syncthreads();

  // arrival = cursor slot + ext; the new ring's k-slice, cursor slot zeroed
  if (ext != nullptr) {
#pragma unroll
    for (int u = 0; u < kRowCells; ++u) {
      if (t_tag + u * kStep < k_tags) arrival[threadIdx.x + u * kThreads] += xv[u];
    }
    for (int k = t_tag + kRowCells * kStep; k < k_tags; k += kStep) {
      if (ext_t != nullptr) arrival[k * TB + t_row] += ext_t[k];
    }
  }
  {
    const int row = nk > 0 ? threadIdx.x / nk : 0;  // tb * D1 + d
    int k = threadIdx.x - row * nk, tb = row / d1, d = row - tb * d1;
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      const int b = b0 + tb;
      if (b < batch) ring_out[(b * d1 + d) * plane + c_off + k_lo + k] = d == cur ? 0.f : col[i];
      for (k += kThreads; k >= nk; k -= nk) {
        if (++d == d1) {
          d = 0;
          ++tb;
        }
      }
    }
  }
  __syncthreads();

  // CAM match of this block's part of cluster c's neurons
  cam_rows::match_neurons<TB, VEC_S>(cam_tag, cam_syn, s_words, arrival, k_tags, n_begin, n_end,
                                     b0, batch, n_clusters * cluster_size,
                                     cv, drive);
}

size_t shared_bytes(int batch_tile, int k_tags, int d1, int parts) {
  const size_t slice = (static_cast<size_t>(k_tags) + parts - 1) / parts;
  return sizeof(float) * static_cast<size_t>(batch_tile) *
         ((k_tags + 1) + static_cast<size_t>(d1) * slice);
}

using Kernel = void (*)(const int32_t*, const int32_t*, const float*, const float*,
                        const int32_t*, const float*, const int32_t*, const int32_t*,
                        const int32_t*, const int32_t*, float*, float*, int, int, int, int, int,
                        int, int, int);

Kernel select_kernel(int batch_tile, bool vec_s) {
  switch (batch_tile) {
    case 1: return vec_s ? &fabric_deliver_kernel<1, true> : &fabric_deliver_kernel<1, false>;
    case 2: return vec_s ? &fabric_deliver_kernel<2, true> : &fabric_deliver_kernel<2, false>;
    case 4: return vec_s ? &fabric_deliver_kernel<4, true> : &fabric_deliver_kernel<4, false>;
    case 8: return vec_s ? &fabric_deliver_kernel<8, true> : &fabric_deliver_kernel<8, false>;
    default: return nullptr;
  }
}

}  // namespace

// Launches one ring step on `stream`. batch_tile (1, 2, 4 or 8) and parts
// (1..8 blocks per thread-block cluster) are the wrapper's work split.
// Returns a cudaError_t.
extern "C" int fabric_deliver_launch(const void* dstk, const void* delay, const void* w,
                                     const void* ring, const void* cursor, const void* ext,
                                     const void* cam_tag, const void* cam_syn,
                                     const void* cluster_start, const void* cluster_order,
                                     void* drive, void* ring_out, int batch, int n_clusters,
                                     int cluster_size, int k_tags, int s_words, int d1, int m,
                                     int batch_tile, int parts, void* stream) {
  const Kernel kernel =
      select_kernel(batch_tile, cam_rows::vector_rows(cam_tag, cam_syn, s_words));
  if (kernel == nullptr || parts < 1 || parts > 8) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_clusters * parts, (batch + batch_tile - 1) / batch_tile);
  return static_cast<int>(cam_rows::launch(
      kernel, grid, 1, shared_bytes(batch_tile, k_tags, d1, parts),
      static_cast<cudaStream_t>(stream), static_cast<const int32_t*>(dstk),
      static_cast<const int32_t*>(delay), static_cast<const float*>(w),
      static_cast<const float*>(ring), static_cast<const int32_t*>(cursor),
      static_cast<const float*>(ext), static_cast<const int32_t*>(cam_tag),
      static_cast<const int32_t*>(cam_syn), static_cast<const int32_t*>(cluster_start),
      static_cast<const int32_t*>(cluster_order), static_cast<float*>(drive),
      static_cast<float*>(ring_out), batch, n_clusters, cluster_size, k_tags, s_words, d1, m,
      parts));
}

// The kernel instance of the Table-V shape (int4 reads of the CAM rows) at
// this work split on the current card: registers and local (spill) bytes per
// thread, the block's dynamic shared bytes, and the blocks that fit on one
// SM. Returns a cudaError_t.
extern "C" int fabric_deliver_kernel_info(int batch_tile, int k_tags, int d1, int parts,
                                          int* registers, int* local_bytes, int* shared,
                                          int* blocks_per_sm) {
  const Kernel kernel = select_kernel(batch_tile, true);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *shared = static_cast<int>(shared_bytes(batch_tile, k_tags, d1, parts));
  return static_cast<int>(
      cam_rows::kernel_info(kernel, *shared, registers, local_bytes, blocks_per_sm));
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

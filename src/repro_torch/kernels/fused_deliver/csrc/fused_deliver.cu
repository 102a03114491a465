// Fused stage-1 scatter + stage-2 CAM match from the AER queue, hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_deliver_kernel` / `fused_deliver_pallas` in
// src/repro/kernels/fused_deliver/fused_deliver.py:42. For batch element b
// and cluster c it builds the tag-activity row from the queue
// (src, w [B, Q], -1 = empty slot) and the SRAM tables (src_tag, src_dest
// [N, E], tag -1 = empty entry):
//
//     A[b, c, k] = ext[b, c, k] + sum_{slots j, src = src[b, j] >= 0} sum_e w[b, j]
//                  * [src_dest[src, e] * K + src_tag[src, e] == c * K + k]
//
// (a source id past N - 1 reads row N - 1, as the plain gather's clamp
// does), then CAM-matches it:
//
//     drive[b, n, t] = sum_s A[b, c, cam_tag[n, s]] * [cam_syn[n, s] == t]
//
// The SRAM gather happens here, so neither the activity matrix nor the
// queued entries ever reach device memory, and the wrapper issues no
// device op but the output's allocation.
//
// What bounds it on this card: latency, not bytes or operations. At the
// Table-V serving shape (B = 32, Q = N = 1536, E = 16, six clusters of 256
// neurons, S = 64, K = 1024) the inputs and the output are 2.9 MB, 0.88 us
// at 3.35 TB/s, and the arithmetic (one add per valid CAM word and batch
// element) is far below the FP32 line; at 10% activity only about 155 of a
// row's 1536 slots are live. What costs time is a chain of dependent steps
// per block: load, compact, load the events' SRAM rows, add, match.
//
// What the design does about it:
// - A block owns (cluster c, a tile of TB batch elements, one part of the
//   cluster's neurons); the `parts` blocks of one (c, tile) form a
//   thread-block cluster. The chain has two rounds of device-memory reads.
//   The first issues, all at once, the tile's ext rows, the block's first
//   chunk of queue slots (ids and weights) and the CAM words of its first
//   pass of neurons. The second reads the live events' SRAM rows.
// - Stage 1: each block of the cluster takes a contiguous share of the
//   tile's TB * Q slots, in chunks; the chunk's groups of 32 slots are
//   dealt to the warps in turn, so that live slots at the head of a row are
//   spread over the warps. A warp ballots its slots, compacts the live ones
//   in slot order into its own segment of a list (empty slots cost their
//   share of one coalesced read per 32; live slots need not form a prefix),
//   and each lane takes one live event: the event's SRAM row read as int4
//   vectors, tags and destinations together. Each entry addressed to c is
//   added to the rows of every block of the cluster with a distributed
//   shared-memory reduction (red.shared::cluster): the queue is walked once
//   per (c, tile), not once per block. The cluster barrier that lets the
//   reductions start is split: a block arrives when its rows hold ext and
//   waits only after compacting its first chunk.
// - Stage 2 is common/cam_rows.cuh: four lanes per neuron with coalesced
//   16-byte CAM reads, each CAM word looked up in the TB interleaved rows by
//   one shared load, so the CAM tables are read once per tile.
// The work split (TB, parts, slots per warp) is the wrapper's (ops.py,
// kernels/_split.py). Integer-valued weights give sums that are exact in any
// atomic order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../../common/cam_rows.cuh"

namespace cg = cooperative_groups;
using cam_rows::kThreads;
using cam_rows::kWarps;

namespace {

constexpr int kSlotsPerLane = 8;  // a warp compacts at most 8 x 32 slots per chunk
constexpr int kRowCells = 16;     // cells of the ext rows per thread loaded at the start

// Adds entry (tag, dest) of an event of weight wt to cell tb of the rows of
// every block of the cluster, if it is valid and addressed to cluster c.
template <int TB>
__device__ __forceinline__ void add_entry(int tag, int dest, float wt, float* rows, int tb,
                                          int c, int k_tags, int parts) {
  if (tag < 0) return;
  const int local = dest * k_tags + tag - c * k_tags;
  if (local < 0 || local >= k_tags) return;
  float* cell = rows + local * TB + tb;
#pragma unroll 1
  for (int r = 0; r < parts; ++r) cam_rows::red_add_cluster(cell, r, wt);
}

template <int TB, bool VEC_E, bool VEC_S>
__global__ void __launch_bounds__(kThreads) fused_deliver_kernel(
    const int32_t* __restrict__ q_src,     // [B, Q], -1 = empty
    const float* __restrict__ q_w,         // [B, Q]
    const int32_t* __restrict__ src_tag,   // [N, E]
    const int32_t* __restrict__ src_dest,  // [N, E]
    const float* __restrict__ ext,         // [B, nc, K] or null
    const int32_t* __restrict__ cam_tag,   // [N, S]
    const int32_t* __restrict__ cam_syn,   // [N, S]
    float* __restrict__ drive,             // [B, N, 4]
    int batch, int q_slots, int n_clusters, int cluster_size, int k_tags, int s_words,
    int e_entries, int parts, int slots_per_warp) {
  extern __shared__ __align__(16) float smem[];
  float* rows = smem;  // [K + 1][TB]: the tile's rows, interleaved; cell K stays 0
  const int list = kWarps * slots_per_warp;  // slots of one chunk
  int* ev_key = reinterpret_cast<int*>(smem + (k_tags + 1) * TB);  // [list]: src * 8 + tb
  float* ev_w = smem + (k_tags + 1) * TB + list;                    // [list]

  cg::cluster_group cluster = cg::this_cluster();
  const int part = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.x / parts;
  const int b0 = blockIdx.y * TB;
  const int rows_in = min(TB, batch - b0);  // batch elements of the tile
  const int n_neurons = n_clusters * cluster_size;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // this block's share of the tile's TB * Q slots, and its part of the neurons
  const int total = TB * q_slots;
  const int share = (total + parts - 1) / parts;
  const int lo = min(total, part * share);
  const int hi = min(min(total, lo + share), rows_in * q_slots);
  const int span = (cluster_size + parts - 1) / parts;
  const int first = c * cluster_size;
  const int n_begin = first + min(cluster_size, part * span);
  const int n_end = first + min(cluster_size, (part + 1) * span);

  // One round of loads, all in flight together: the ext rows, the first
  // chunk's slots and the first pass's CAM words. Thread t holds the cells
  // t, t + kThreads, ... of the interleaved rows (so that its shared stores
  // fall on consecutive words): all of them in row t % TB.
  constexpr int kStep = kThreads / TB;  // tags between a thread's cells
  const int t_row = threadIdx.x % TB;
  const int t_tag = threadIdx.x / TB;
  const float* ext_t =
      ext != nullptr && t_row < rows_in ? ext + ((b0 + t_row) * n_clusters + c) * k_tags : nullptr;
  float xv[kRowCells];
#pragma unroll
  for (int u = 0; u < kRowCells; ++u) {
    const int k = t_tag + u * kStep;
    xv[u] = ext_t != nullptr && k < k_tags ? __ldg(ext_t + k) : 0.f;
  }
  // the chunk's groups of 32 slots are dealt to the warps in turn: slot u of
  // a lane is i = base + (u * kWarps + warp) * 32 + lane, row tb of the tile
  int key[kSlotsPerLane];  // src * 8 + tb of a live slot, -1 for an empty one
  float wt[kSlotsPerLane];
  const int groups = slots_per_warp / 32;  // of 32 slots, per warp and chunk
  const int step_rows = kWarps * 32 / q_slots;
  const int step_rem = kWarps * 32 - step_rows * q_slots;
  const int* q_tile = q_src + b0 * q_slots;
  const float* w_tile = q_w + b0 * q_slots;
  auto load_slots = [&](int base) {
    int i = base + warp * 32 + lane;
    int tb = i / q_slots;
    int rem = i - tb * q_slots;
#pragma unroll
    for (int u = 0; u < kSlotsPerLane; ++u) {
      key[u] = -1;
      wt[u] = 0.f;
      if (u < groups && i < hi) {
        const int src = q_tile[i];
        key[u] = src < 0 ? -1 : min(src, n_neurons - 1) * 8 + tb;
        wt[u] = w_tile[i];
      }
      i += kWarps * 32;
      tb += step_rows;
      rem += step_rem;
      if (rem >= q_slots) {
        rem -= q_slots;
        ++tb;
      }
    }
  };
  load_slots(lo);
  cam_rows::CamVectors cv{};
  if constexpr (VEC_S) {
    const int n = n_begin + threadIdx.x / cam_rows::kLanes;
    cam_rows::load_cam(cam_tag, cam_syn, s_words, n, n < n_end, cv);
  }

  // the rows start as the external activity (or 0); cell K stays 0
#pragma unroll
  for (int u = 0; u < kRowCells; ++u) {
    if (t_tag + u * kStep < k_tags) rows[threadIdx.x + u * kThreads] = xv[u];
  }
  for (int k = t_tag + kRowCells * kStep; k < k_tags; k += kStep) {
    rows[k * TB + t_row] = ext_t != nullptr ? ext_t[k] : 0.f;
  }
  if (threadIdx.x < TB) rows[k_tags * TB + threadIdx.x] = 0.f;

  cam_rows::cluster_arrive();  // this block's rows are ready for the other blocks' adds

  // stage 1: the share in chunks of kWarps * slots_per_warp slots; each warp
  // compacts its live slots, in slot order, into its own segment of the
  // list, and its lanes then take one live event each: the event's SRAM row
  // (tags and destinations read together), and the entries addressed to c
  // added to the rows of every block of the cluster
  int* w_key = ev_key + warp * slots_per_warp;
  float* w_w = ev_w + warp * slots_per_warp;
  const unsigned below = (1u << lane) - 1u;
  bool waited = false;
  for (int base = lo; base < hi; base += list) {
    if (base != lo) load_slots(base);
    int count = 0;
#pragma unroll
    for (int u = 0; u < kSlotsPerLane; ++u) {
      const unsigned live = __ballot_sync(0xffffffffu, key[u] >= 0);
      if (key[u] >= 0) {
        w_key[count + __popc(live & below)] = key[u];
        w_w[count + __popc(live & below)] = wt[u];
      }
      count += __popc(live);
    }
    __syncwarp();
    if (!waited) {
      cam_rows::cluster_wait();  // every block of the cluster holds its rows
      waited = true;
    }
#pragma unroll 1
    for (int j = lane; j < count; j += 32) {
      const int key_j = w_key[j];
      const float w = w_w[j];
      const int tb = key_j & 7;
      const int row = (key_j >> 3) * e_entries;
      if constexpr (VEC_E) {
        const int4* t4 = reinterpret_cast<const int4*>(src_tag + row);
        const int4* d4 = reinterpret_cast<const int4*>(src_dest + row);
#pragma unroll 1
        for (int v0 = 0; v0 < (e_entries >> 2); v0 += 4) {
          int4 t[4], d[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const bool in = v0 + u < (e_entries >> 2);
            t[u] = in ? __ldg(t4 + v0 + u) : make_int4(-1, -1, -1, -1);
            d[u] = in ? __ldg(d4 + v0 + u) : make_int4(0, 0, 0, 0);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if ((t[u].x & t[u].y & t[u].z & t[u].w) < 0) continue;  // four empty entries
            add_entry<TB>(t[u].x, d[u].x, w, rows, tb, c, k_tags, parts);
            add_entry<TB>(t[u].y, d[u].y, w, rows, tb, c, k_tags, parts);
            add_entry<TB>(t[u].z, d[u].z, w, rows, tb, c, k_tags, parts);
            add_entry<TB>(t[u].w, d[u].w, w, rows, tb, c, k_tags, parts);
          }
        }
      } else {
#pragma unroll 1
        for (int e = 0; e < e_entries; ++e) {
          add_entry<TB>(__ldg(src_tag + row + e), __ldg(src_dest + row + e), w, rows, tb, c,
                        k_tags, parts);
        }
      }
    }
    __syncwarp();  // the next chunk reuses the warp's segment
  }
  if (!waited) cam_rows::cluster_wait();  // a block with no slots still meets the cluster
  cluster.sync();  // every block's share of stage 1 is in every block's rows

  // stage 2: this block's part of cluster c's neurons
  cam_rows::match_neurons<TB, VEC_S>(cam_tag, cam_syn, s_words, rows, k_tags, n_begin, n_end,
                                     b0, batch, n_neurons, cv, drive);
}

size_t shared_bytes(int batch_tile, int k_tags, int slots_per_warp) {
  return sizeof(float) * (static_cast<size_t>(batch_tile) * (k_tags + 1) +
                          2 * static_cast<size_t>(kWarps) * slots_per_warp);
}

using Kernel = void (*)(const int32_t*, const float*, const int32_t*, const int32_t*,
                        const float*, const int32_t*, const int32_t*, float*, int, int, int, int,
                        int, int, int, int, int);

template <int TB>
Kernel pick(bool vec_e, bool vec_s) {
  if (vec_e) {
    return vec_s ? &fused_deliver_kernel<TB, true, true> : &fused_deliver_kernel<TB, true, false>;
  }
  return vec_s ? &fused_deliver_kernel<TB, false, true> : &fused_deliver_kernel<TB, false, false>;
}

Kernel select_kernel(int batch_tile, bool vec_e, bool vec_s) {
  switch (batch_tile) {
    case 1: return pick<1>(vec_e, vec_s);
    case 2: return pick<2>(vec_e, vec_s);
    case 4: return pick<4>(vec_e, vec_s);
    case 8: return pick<8>(vec_e, vec_s);
    default: return nullptr;
  }
}

}  // namespace

// Launches one fused delivery on `stream`. batch_tile (1, 2, 4 or 8),
// parts (1..8 blocks per thread-block cluster) and slots_per_warp (a
// multiple of 32, at most 256) are the wrapper's work split. Returns a
// cudaError_t.
extern "C" int fused_deliver_launch(const void* q_src, const void* q_w, const void* src_tag,
                                    const void* src_dest, const void* ext, const void* cam_tag,
                                    const void* cam_syn, void* drive, int batch, int q_slots,
                                    int n_clusters, int cluster_size, int k_tags, int s_words,
                                    int e_entries, int batch_tile, int parts,
                                    int slots_per_warp, void* stream) {
  const Kernel kernel =
      select_kernel(batch_tile, cam_rows::vector_rows(src_tag, src_dest, e_entries),
                    cam_rows::vector_rows(cam_tag, cam_syn, s_words));
  if (kernel == nullptr || parts < 1 || parts > 8 || slots_per_warp < 32 ||
      slots_per_warp > 32 * kSlotsPerLane || slots_per_warp % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_clusters * parts, (batch + batch_tile - 1) / batch_tile);
  return static_cast<int>(cam_rows::launch(
      kernel, grid, parts, shared_bytes(batch_tile, k_tags, slots_per_warp),
      static_cast<cudaStream_t>(stream), static_cast<const int32_t*>(q_src),
      static_cast<const float*>(q_w), static_cast<const int32_t*>(src_tag),
      static_cast<const int32_t*>(src_dest), static_cast<const float*>(ext),
      static_cast<const int32_t*>(cam_tag), static_cast<const int32_t*>(cam_syn),
      static_cast<float*>(drive), batch, q_slots, n_clusters, cluster_size, k_tags, s_words,
      e_entries, parts, slots_per_warp));
}

// The kernel instance of the Table-V shape (int4 reads of the SRAM and CAM
// rows) at this work split on the current card: registers and local (spill)
// bytes per thread, the block's dynamic shared bytes, and the blocks that fit
// on one SM. Returns a cudaError_t.
extern "C" int fused_deliver_kernel_info(int batch_tile, int k_tags, int slots_per_warp,
                                         int* registers, int* local_bytes, int* shared,
                                         int* blocks_per_sm) {
  const Kernel kernel = select_kernel(batch_tile, true, true);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *shared = static_cast<int>(shared_bytes(batch_tile, k_tags, slots_per_warp));
  return static_cast<int>(
      cam_rows::kernel_info(kernel, *shared, registers, local_bytes, blocks_per_sm));
}

// Bytes of shared memory one block may opt in to on `device`, or the
// negated cudaError_t when it cannot be read.
extern "C" int fused_deliver_max_shared_bytes(int device) {
  int bytes = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? bytes : -static_cast<int>(e);
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

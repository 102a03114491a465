// Stage 2 of the delivery kernels: the CAM match of activity rows held in
// shared memory, shared by fused_deliver.cu and fabric_deliver.cu.
//
//     drive[b, n, t] = sum_s row_b[cam_tag[n, s]] * [cam_syn[n, s] == t]
//
// Words with cam_tag < 0 are empty and add nothing; a tag past K - 1 reads
// cell K - 1; a synapse type outside [0, 4) adds nothing (the plain
// version's clamp and zero one-hot row).
//
// Layout of the rows: the TB rows of the block's batch tile are interleaved,
// cell k of row tb at rows[k * TB + tb], for k in [0, K]; cell K of every
// row holds 0, and an empty word reads it, so no word needs a branch. One
// 16-byte shared load (two for TB = 8) fetches a tag's cell of every row,
// which keeps the shared-memory wavefronts per lookup, and the bank
// conflicts of random tags, a quarter of those of one load per row.
//
// Four lanes share a neuron (kLanes). Lane q reads the 16-byte vectors
// q, q + 4, q + 8, ... of the neuron's tag and type rows, so one warp
// instruction reads eight contiguous 64-byte runs, and all of a lane's loads
// are issued before its first lookup. Each word's type is turned once into
// four 0/1 masks, and every row of the tile then costs four fused
// multiply-adds per word: the CAM words are read from L2 once per batch
// tile, not once per batch element. The four lanes' per-type sums are added
// with three shuffles (a transpose reduction: lane q ends with type q), and
// the four lanes of a neuron store its drive as one 16-byte run.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace cam_rows {

constexpr int kLanes = 4;      // lanes per neuron in the CAM walk
constexpr int kThreads = 256;  // threads per block of the delivery kernels
constexpr int kWarps = kThreads / 32;

// The cells of tag cell `idx` of the TB interleaved rows.
template <int TB>
__device__ __forceinline__ void load_cells(const float* rows, int idx, float (&v)[TB]) {
  const float* cell = rows + idx * TB;
  if constexpr (TB % 4 == 0) {
#pragma unroll
    for (int j = 0; j < TB; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(cell + j);
      v[j] = x.x;
      v[j + 1] = x.y;
      v[j + 2] = x.z;
      v[j + 3] = x.w;
    }
  } else if constexpr (TB == 2) {
    const float2 x = *reinterpret_cast<const float2*>(cell);
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int j = 0; j < TB; ++j) v[j] = cell[j];
  }
}

// One CAM word looked up in the TB rows and added into its type's sums.
// fmaf(1, v, d) rounds as d + v does, and fmaf(0, v, d) is d.
template <int TB>
__device__ __forceinline__ void match_word(int tag, int syn, const float* rows, int k_tags,
                                           float (&d)[TB][4]) {
  float v[TB];
  load_cells<TB>(rows, tag < 0 ? k_tags : min(tag, k_tags - 1), v);
  const float m0 = syn == 0 ? 1.f : 0.f;
  const float m1 = syn == 1 ? 1.f : 0.f;
  const float m2 = syn == 2 ? 1.f : 0.f;
  const float m3 = syn == 3 ? 1.f : 0.f;
#pragma unroll
  for (int tb = 0; tb < TB; ++tb) {
    d[tb][0] = fmaf(m0, v[tb], d[tb][0]);
    d[tb][1] = fmaf(m1, v[tb], d[tb][1]);
    d[tb][2] = fmaf(m2, v[tb], d[tb][2]);
    d[tb][3] = fmaf(m3, v[tb], d[tb][3]);
  }
}

// The four lanes of a neuron hold partial sums of the four types; lane q of
// the group returns the total of type q. Called by every lane of the warp.
__device__ __forceinline__ float reduce_types(const float (&d)[4]) {
  const int q = threadIdx.x & (kLanes - 1);
  const bool hi = q & 2;  // with lane ^ 2: the high lanes keep types 2 and 3
  const float e0 = (hi ? d[2] : d[0]) + __shfl_xor_sync(0xffffffffu, hi ? d[0] : d[2], 2);
  const float e1 = (hi ? d[3] : d[1]) + __shfl_xor_sync(0xffffffffu, hi ? d[1] : d[3], 2);
  const bool odd = q & 1;  // with lane ^ 1: the odd lanes keep the second type
  return (odd ? e1 : e0) + __shfl_xor_sync(0xffffffffu, odd ? e0 : e1, 1);
}

// A lane's first four 16-byte vectors of its neuron's tag and type rows
// (vectors q, q + 4, q + 8, q + 12: all of them when S <= 64), loaded at the
// start of a kernel so that their latency overlaps stage 1.
struct CamVectors {
  int4 tag[4];
  int4 syn[4];
};

// Loads the CamVectors of neuron n (nothing when !live; a vector past the
// row reads as empty words).
__device__ __forceinline__ void load_cam(const int32_t* __restrict__ cam_tag,
                                         const int32_t* __restrict__ cam_syn, int s_words,
                                         int n, bool live, CamVectors& cv) {
  const int q = threadIdx.x & (kLanes - 1);
  const int nv = s_words >> 2;
  const int4* t4 = reinterpret_cast<const int4*>(cam_tag + n * s_words);
  const int4* s4 = reinterpret_cast<const int4*>(cam_syn + n * s_words);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int v = q + u * kLanes;
    const bool in = live && v < nv;
    cv.tag[u] = in ? __ldg(t4 + v) : make_int4(-1, -1, -1, -1);
    cv.syn[u] = in ? __ldg(s4 + v) : make_int4(0, 0, 0, 0);
  }
}

template <int TB>
__device__ __forceinline__ void match_vector(const int4& t, const int4& s, const float* rows,
                                             int k_tags, float (&d)[TB][4]) {
  match_word<TB>(t.x, s.x, rows, k_tags, d);
  match_word<TB>(t.y, s.y, rows, k_tags, d);
  match_word<TB>(t.z, s.z, rows, k_tags, d);
  match_word<TB>(t.w, s.w, rows, k_tags, d);
}

// Drive of neurons [n_begin, n_end) for batch elements b0 .. b0 + TB - 1
// from the TB interleaved rows; elements at or past `batch` are not stored.
// VEC reads the CAM rows as int4 (S % 4 == 0 and 16-byte aligned tables):
// the first pass takes the vectors `first` loaded by load_cam for neuron
// n_begin + threadIdx.x / kLanes; otherwise the rows are read as single
// words. Every thread of the block calls it. The kernels index in 32 bits
// (their wrappers refuse larger tensors).
template <int TB, bool VEC>
__device__ __forceinline__ void match_neurons(const int32_t* __restrict__ cam_tag,
                                              const int32_t* __restrict__ cam_syn, int s_words,
                                              const float* rows, int k_tags, int n_begin,
                                              int n_end, int b0, int batch, int n_neurons,
                                              const CamVectors& first,
                                              float* __restrict__ drive) {
  const int q = threadIdx.x & (kLanes - 1);
  const int per_pass = blockDim.x / kLanes;
  CamVectors cv = first;
  for (int n0 = n_begin; n0 < n_end; n0 += per_pass) {
    const int n = n0 + threadIdx.x / kLanes;
    const bool live = n < n_end;
    float d[TB][4];
#pragma unroll
    for (int tb = 0; tb < TB; ++tb) d[tb][0] = d[tb][1] = d[tb][2] = d[tb][3] = 0.f;
    if constexpr (VEC) {
      if (n0 != n_begin) load_cam(cam_tag, cam_syn, s_words, n, live, cv);
#pragma unroll
      for (int u = 0; u < 4; ++u) match_vector<TB>(cv.tag[u], cv.syn[u], rows, k_tags, d);
      if (live) {  // rows of more than 64 words
        const int4* t4 = reinterpret_cast<const int4*>(cam_tag + n * s_words);
        const int4* s4 = reinterpret_cast<const int4*>(cam_syn + n * s_words);
#pragma unroll 1
        for (int v = q + 4 * kLanes; v < (s_words >> 2); v += kLanes) {
          match_vector<TB>(__ldg(t4 + v), __ldg(s4 + v), rows, k_tags, d);
        }
      }
    } else if (live) {
      const int32_t* tags = cam_tag + n * s_words;
      const int32_t* syns = cam_syn + n * s_words;
#pragma unroll 4
      for (int w = q; w < s_words; w += kLanes) {
        match_word<TB>(__ldg(tags + w), __ldg(syns + w), rows, k_tags, d);
      }
    }
#pragma unroll
    for (int tb = 0; tb < TB; ++tb) {
      const float total = reduce_types(d[tb]);
      if (live && b0 + tb < batch) drive[((b0 + tb) * n_neurons + n) * 4 + q] = total;
    }
  }
}

// The two halves of a thread-block cluster barrier: a thread arrives
// (release: its block's shared writes are visible to the cluster) and later
// waits (acquire) for every thread of every block of the cluster to arrive.
// Every thread of a block calls both, at points its warp reaches together.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Adds v to the float at `cell` in the shared memory of block `rank` of the
// cluster (cell is this block's address of it): one reduction, no return.
__device__ __forceinline__ void red_add_cluster(float* cell, int rank, float v) {
  const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(cell));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("red.shared::cluster.add.f32 [%0], %1;\n" ::"r"(remote), "f"(v) : "memory");
}

// Whether a pointer is 16-byte aligned.
__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether a table can be read as int4: whole vectors per row, aligned.
inline bool vector_rows(const void* a, const void* b, int words) {
  return words % 4 == 0 && aligned16(a) && aligned16(b);
}

// Registers and local (spill) bytes per thread of `kernel`, and the blocks
// of kThreads threads with `smem` dynamic shared bytes that fit on one SM.
// The kernel's dynamic shared-memory cap is raised to `smem` where it is
// lower, never lowered: a cap set to a small footprint would make every
// later launch with a larger one (still under the 48 KB default, where
// launch() opts in to nothing) fail with "invalid argument".
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, int smem, int* registers, int* local_bytes,
                        int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  if (smem > attr.maxDynamicSharedSizeBytes) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem);
}

// Launches `kernel` on a grid of (x, y) blocks of kThreads threads, in
// thread-block clusters of `cluster_x` blocks along x (1: no cluster), with
// `smem` dynamic shared bytes (opted in above 48 KB).
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int cluster_x, size_t smem,
                             cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace cam_rows

// Causal flash attention for the prefill of Multi-head Latent Attention
// (DeepSeek-V2/V3), hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's MLA prefill decompresses the
// latent cache into per-head keys and values and runs `attend_chunked`
// (src/repro/models/attention.py) as jnp under jit. The port's eager copy of
// that function (src/repro_torch/models/attention.py `attend_chunked`) runs
// every 1024 x 1024 block of a 4096-token prompt, the six the causal mask
// hides too, as some twenty float32 launches a block pair on the CUDA
// cores; this kernel takes its place on the card for bf16 tensors at MLA's
// head sizes (models/mla.py `_mla_layer`).
//
// What it computes, per batch element b, head h and query row i:
//
//     s[j]   = (q[b,i,h,:192] . k[b,j,h,:192]) * scale           (float32)
//     valid  = 0 <= pos[b,j] <= pos[b,i]
//     o[b,i,h,:128] = sum_j softmax_valid(s)[j] * v[b,j,h,:128]
//
// q, k [B, S, H, 192] and v [B, S, H, 128] in bf16; o [B, S, H, 128] bf16;
// a row with no valid key gives 0. Q.K^T takes bf16 inputs with float32
// accumulation; the scale, mask, running max, exponentials and sums are
// float32; the probabilities are rounded to bf16 for the product with v
// (as `attend_dense` casts them to v's dtype), accumulated in float32; the
// last division is float32.
//
// What bounds it on this card: DeepSeek-V2-Lite's prefill of 4 x 4096
// tokens (16 heads) takes 2 * 16 * 4 * 4096 * 4097 / 2 * (192 + 128) = 343.7
// GFLOP a layer, 0.35 ms at 989.4 TFLOP/s in bf16, against 335 MB of q, k,
// v and o, 0.10 ms at 3.35 TB/s: operations bound it.
//
// Design. A block takes 128 query rows of one (b, h): three warpgroups,
// one producer and two consumers of 64 rows each. The producer's first warp
// loads the block's Q once, then the K and V tiles of 128 keys through two
// rings of two stages each with the Tensor Memory Accelerator (TMA,
// 128-byte swizzle, rows past the prompt filled with zeros), every stage
// behind a `full` and an `empty` mbarrier. Before it loads a tile it reads
// the tile's positions (int32 warp reductions, the next tile's read ahead):
// a tile whose smallest valid position is past every query position of the
// block is skipped, a tile of valid keys all at or before the block's
// smallest query position is marked to run without a mask, and the rest
// (the diagonal, invalid or out-of-range keys) to be masked. So a causal
// prompt loads and computes about half the tiles, and only the diagonal
// ones pay for the mask. Each consumer warpgroup computes S = Q K^T with
// `wgmma` from shared memory (m64n128k16, twelve steps over the 192
// columns), the online softmax in registers (one FFMA and one exp2 a
// score, the scale folded into log2(e)), and O += P V with `wgmma` taking P
// from registers (the accumulator's layout is the A operand's, packed to
// bf16) and V from shared memory as an MN-major operand. Q K^T of a tile is
// issued together with P V of the one before, and its softmax runs while
// that P V finishes; K is released after Q K^T, V after P V, and the
// producer loads K of a tile before V of the one before it. The producer
// gives up registers (`setmaxnreg`) to the consumers, which hold the 64
// floats of S and of O a thread. Query tiles vary fastest in the grid, so
// the blocks in flight share a few heads' keys and values in L2; within a
// head the heaviest tiles start first.
//
// Shared memory: Q 48 KB, two stages of K (48 KB) and of V (32 KB), the
// barriers: 209 KB of the 227 KB a block may hold; one block of 384
// threads an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kDqk = 192;           // q and k head size (nope 128 + rope 64)
constexpr int kDv = 128;            // v head size
constexpr int kBlockM = 128;        // query rows a block
constexpr int kBlockN = 128;        // keys a tile
constexpr int kStages = 2;          // K/V ring
constexpr int kThreads = 384;       // producer warpgroup + two consumer warpgroups
constexpr int kChunk = 64;          // bf16 columns in one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr int kQChunkBytes = kBlockM * kRowBytes;  // 64 columns of every query row
constexpr int kKChunkBytes = kBlockN * kRowBytes;
constexpr int kQBytes = (kDqk / kChunk) * kQChunkBytes;
constexpr int kKBytes = (kDqk / kChunk) * kKChunkBytes;
constexpr int kVBytes = (kDv / kChunk) * kKChunkBytes;
constexpr int kBarrierBytes = 128;  // q_full, fullk, fullv, emptyk, emptyv, the tiles' tags
constexpr int kSmemBytes = kQBytes + kStages * (kKBytes + kVBytes) + kBarrierBytes + 1024;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMaskBit = 1;         // a tile's tag: (tile << 1) | masked; -1 ends the ring

struct Params {
  const long long* pos;  // [B, S] by (pos_b, pos_s) strides
  long long pos_b, pos_s;
  __nv_bfloat16* out;    // [B, S, H, 128]
  int seq, heads;
  float scale_log2;      // scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- mbarriers and TMA -----------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma -------------------------------------------------------------------
// Shared-memory operand descriptors for 128-byte swizzled tiles whose atoms
// (8 rows of 128 bytes) lie 1024 bytes apart. K-major (Q, K: the reduction
// runs along the 128-byte rows): stride between atoms 1024, leading offset
// unused. MN-major (V: the reduction runs over rows, the output columns
// along them): 1024 between atoms of 8 keys, kKChunkBytes between the two
// 64-column halves of the head.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kKChunkBytes >> 4) << 16) | (uint64_t{1024 >> 4} << 32) |
         (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Ties the accumulator registers to the asm around them, so that no read or
// write of them moves across a wgmma's issue or wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MLA_D4(i) "+f"(d[i]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define MLA_D16(i) MLA_D4(i), MLA_D4((i) + 4), MLA_D4((i) + 8), MLA_D4((i) + 12)
#define MLA_D64 MLA_D16(0), MLA_D16(16), MLA_D16(32), MLA_D16(48)
#define MLA_OUT64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MLA_OUT64
      ", %64, %65, p, 1, 1, 0, 0;\n\t}"
      : MLA_D64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A in registers (bf16 pairs), B in
// shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MLA_OUT64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}"
      : MLA_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ long long position(const Params& p, int b, int s) {
  return s < p.seq ? __ldg(p.pos + b * p.pos_b + s * p.pos_s) : -1;
}

__device__ __forceinline__ int clamp32(long long x) {
  return x < INT_MIN ? INT_MIN : (x > INT_MAX ? INT_MAX : static_cast<int>(x));
}

// ---- the ring ----------------------------------------------------------------
// Two stages each of K and of V, filled by TMA. Tile i of those the block
// sees goes to stage i % 2 of both rings; fullk/fullv say its bytes have
// landed, emptyk/emptyv that all eight consumer warps are done with them
// (K after Q K^T, V after P V). The K stage also carries the tile's tag.
struct Ring {
  uint32_t q_full, fullk, fullv, emptyk, emptyv;  // barrier s of each at + 8 s
  volatile int* tags;

  __device__ uint32_t at(uint32_t bar, int stage) const { return bar + 8 * stage; }
};

__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == kStages) {
    stage = 0;
    phase ^= 1;
  }
}

// ---- the producer: Q once, then the tiles a block sees -----------------------
// Loads run in the order the consumers need them: K of tile i + 1 before V
// of tile i, since Q K^T of the next tile is issued before P V of the last.
__device__ __forceinline__ void produce(const CUtensorMap* q_map, const CUtensorMap* k_map,
                                       const CUtensorMap* v_map, const Params& p, int b, int h,
                                       int q0, uint32_t q_s, uint32_t k_s, uint32_t v_s,
                                       const Ring& ring) {
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    mbar_expect_tx(ring.q_full, kQBytes);
#pragma unroll
    for (int c = 0; c < kDqk / kChunk; ++c)
      tma_load(q_s + c * kQChunkBytes, q_map, ring.q_full, c * kChunk, h, q0, b);
  }
  // positions as int32, clamped: a clamp keeps order (a > b after it means
  // a > b before), so a tile skipped is skipped rightly, and one left
  // unmasked is one whose largest key is below INT_MAX
  int q_lo = INT_MAX, q_hi = INT_MIN;
  for (int i = lane; i < kBlockM && q0 + i < p.seq; i += 32) {
    const int x = clamp32(position(p, b, q0 + i));
    q_lo = min(q_lo, x);
    q_hi = max(q_hi, x);
  }
  q_lo = __reduce_min_sync(0xffffffffu, q_lo);
  q_hi = __reduce_max_sync(0xffffffffu, q_hi);

  const int n_tiles = (p.seq + kBlockN - 1) / kBlockN;
  int k_stage = 0, v_stage = 0, last = -1;
  uint32_t k_phase = 0, v_phase = 0;
  auto load_v = [&](int j) {
    if (lane == 0) {
      mbar_wait(ring.at(ring.emptyv, v_stage), v_phase ^ 1);
      mbar_expect_tx(ring.at(ring.fullv, v_stage), kVBytes);
#pragma unroll
      for (int c = 0; c < kDv / kChunk; ++c)
        tma_load(v_s + v_stage * kVBytes + c * kKChunkBytes, v_map, ring.at(ring.fullv, v_stage),
                 c * kChunk, h, j * kBlockN, b);
    }
    advance(v_stage, v_phase);
  };
  // each lane's keys of a tile: lane, lane + 32, lane + 64, lane + 96; the
  // next tile's are read while this one's are reduced
  constexpr int kPer = kBlockN / 32;
  long long next[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) next[i] = position(p, b, lane + 32 * i);
  for (int j = 0; j < n_tiles; ++j) {
    int k_lo = INT_MAX, k_hi = INT_MIN;
    bool invalid = false;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int x = clamp32(next[i]);  // -1 past the prompt
      if (x >= 0) k_lo = min(k_lo, x); else invalid = true;
      k_hi = max(k_hi, x);
    }
    if (j + 1 < n_tiles) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) next[i] = position(p, b, (j + 1) * kBlockN + lane + 32 * i);
    }
    k_lo = __reduce_min_sync(0xffffffffu, k_lo);
    k_hi = __reduce_max_sync(0xffffffffu, k_hi);
    invalid = __any_sync(0xffffffffu, invalid);
    if (k_lo > q_hi) continue;  // no valid key of the tile is visible to any query row
    const bool masked = invalid || k_hi > q_lo || k_hi == INT_MAX;
    if (lane == 0) {
      mbar_wait(ring.at(ring.emptyk, k_stage), k_phase ^ 1);
      ring.tags[k_stage] = (j << 1) | (masked ? kMaskBit : 0);
      mbar_expect_tx(ring.at(ring.fullk, k_stage), kKBytes);
#pragma unroll
      for (int c = 0; c < kDqk / kChunk; ++c)
        tma_load(k_s + k_stage * kKBytes + c * kKChunkBytes, k_map, ring.at(ring.fullk, k_stage),
                 c * kChunk, h, j * kBlockN, b);
    }
    advance(k_stage, k_phase);
    if (last >= 0) load_v(last);
    last = j;
  }
  if (last >= 0) load_v(last);
  if (lane == 0) {
    mbar_wait(ring.at(ring.emptyk, k_stage), k_phase ^ 1);
    ring.tags[k_stage] = -1;
    mbar_arrive(ring.at(ring.fullk, k_stage));
  }
}

// ---- a consumer warpgroup: 64 query rows ------------------------------------
// S[64 x 128] = Q K^T over the 192 columns, in 64-column swizzled chunks.
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int c = 0; c < kDqk / kChunk; ++c) {
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      wgmma_ss(s, desc_k_major(q_rows + c * kQChunkBytes + kk * 32),
               desc_k_major(k_tile + c * kKChunkBytes + kk * 32), (c | kk) != 0);
    }
  }
  wgmma_commit();
}

// O += P V over the tile's 128 keys, 16 at a time.
__device__ __forceinline__ void issue_pv(float (&o)[64], const uint32_t (&pa)[8][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk)
    wgmma_rs(o, pa[kk], desc_mn_major(v_tile + kk * 16 * kRowBytes));
  wgmma_commit();
}

// All of a warp is done reading a stage: one arrival for it.
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// The causal mask of a tile the producer marked: s[4n + 2r + e] is row r
// of the thread's two and key key0 + 8n + 2 quad + e; a key a row may not
// see scores -inf.
__device__ __forceinline__ void mask_tile(float (&s)[64], int key0, const Params& p, int b,
                                          const long long (&qpos)[2], int quad) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long kp = position(p, b, key0 + 8 * n + 2 * quad + e);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!(kp >= 0 && kp <= qpos[r])) s[4 * n + 2 * r + e] = neg_inf();
      }
    }
  }
}

// The online softmax of one tile, in place: each score becomes
// exp2(s * scale log2(e) - its row's new running maximum, in those units),
// one FFMA and one MUFU a score; m (the maximum of the raw scores) and l
// move on, and corr is what the output so far must be multiplied by. The
// scale is positive, so the maximum of the raw scores is the scaled one's.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float scale_log2, float (&m)[2],
                                             float (&l)[2], float (&corr)[2]) {
  float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    // a row that has seen no valid key yet keeps m = -inf: subtract 0 then
    base[r] = m_new == neg_inf() ? 0.0f : m_new * scale_log2;
    corr[r] = exp2_approx(m[r] * scale_log2 - base[r]);
    m[r] = m_new;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = exp2_approx(fmaf(s[i], scale_log2, -base[(i / 2) % 2]));
    sum[(i / 2) % 2] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

// P packed to bf16 as wgmma's A operand: k-step kk takes the accumulator's
// columns 16 kk .. 16 kk + 15, whose layout is the operand's.
__device__ __forceinline__ void pack_p(const float (&s)[64], uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  }
}

__device__ __forceinline__ void consume(const Params& p, int b, int h, int q0, int group,
                                       uint32_t q_s, uint32_t k_s, uint32_t v_s,
                                       const Ring& ring) {
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, quad = lane % 4;
  // this thread's two rows of the accumulators: r and r + 8
  const int row = q0 + group * 64 + warp * 16 + lane / 4;
  const long long qpos[2] = {position(p, b, row), position(p, b, row + 8)};
  const uint32_t q_rows = q_s + group * 64 * kRowBytes;

  float o[64], s[64], corr[2];
  uint32_t pa[8][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = s[i] = 0.0f;
  float m[2] = {neg_inf(), neg_inf()};
  float l[2] = {0.0f, 0.0f};

  mbar_wait(ring.q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  mbar_wait(ring.at(ring.fullk, stage), phase);
  __syncwarp();
  int tag = ring.tags[stage];
  if (tag >= 0) {
    // the first tile: Q K^T and its softmax alone
    fence_acc(s);
    wgmma_fence();
    issue_qk(s, q_rows, k_s + stage * kKBytes);
    wgmma_wait<0>();
    fence_acc(s);
    release(ring.at(ring.emptyk, stage));
    if (tag & kMaskBit) mask_tile(s, (tag >> 1) * kBlockN, p, b, qpos, quad);
    softmax_tile(s, p.scale_log2, m, l, corr);
    pack_p(s, pa);
    int pv_stage = stage;
    uint32_t pv_phase = phase;
    advance(stage, phase);
    // then each next tile's Q K^T runs beside the last one's P V, and its
    // softmax beside that P V's tail
    for (;;) {
      mbar_wait(ring.at(ring.fullk, stage), phase);
      __syncwarp();
      tag = ring.tags[stage];
      if (tag < 0) break;
      mbar_wait(ring.at(ring.fullv, pv_stage), pv_phase);
      __syncwarp();
      fence_acc(s);
      fence_acc(o);
      wgmma_fence();
      issue_qk(s, q_rows, k_s + stage * kKBytes);
      issue_pv(o, pa, v_s + pv_stage * kVBytes);
      wgmma_wait<1>();
      fence_acc(s);
      release(ring.at(ring.emptyk, stage));
      if (tag & kMaskBit) mask_tile(s, (tag >> 1) * kBlockN, p, b, qpos, quad);
      softmax_tile(s, p.scale_log2, m, l, corr);
      wgmma_wait<0>();
      fence_acc(o);
      release(ring.at(ring.emptyv, pv_stage));
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= corr[(i / 2) % 2];
      pack_p(s, pa);
      pv_stage = stage;
      pv_phase = phase;
      advance(stage, phase);
    }
    mbar_wait(ring.at(ring.fullv, pv_stage), pv_phase);
    __syncwarp();
    fence_acc(o);
    wgmma_fence();
    issue_pv(o, pa, v_s + pv_stage * kVBytes);
    wgmma_wait<0>();
    fence_acc(o);
  }

  // the row sums over the quad, then o / l in float32, written as bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s_row = row + 8 * r;
    if (s_row >= p.seq) continue;
    __nv_bfloat16* dst =
        p.out + ((static_cast<long long>(b) * p.seq + s_row) * p.heads + h) * kDv + 2 * quad;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const float a = l[r] > 0.0f ? o[4 * n + 2 * r] / l[r] : 0.0f;
      const float c = l[r] > 0.0f ? o[4 * n + 2 * r + 1] / l[r] : 0.0f;
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(a, c);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    mla_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t q_s = smem_u32(smem);
  const uint32_t k_s = q_s + kQBytes;
  const uint32_t v_s = k_s + kStages * kKBytes;
  uint8_t* bar_area = smem + kQBytes + kStages * (kKBytes + kVBytes);
  Ring ring;
  ring.q_full = smem_u32(bar_area);
  ring.fullk = ring.q_full + 8;
  ring.fullv = ring.fullk + 8 * kStages;
  ring.emptyk = ring.fullv + 8 * kStages;
  ring.emptyv = ring.emptyk + 8 * kStages;
  ring.tags = reinterpret_cast<volatile int*>(bar_area + 8 * (1 + 4 * kStages));

  // query tiles vary fastest, so the blocks in flight share a few heads'
  // keys and values in L2; within a head the heaviest tiles start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(ring.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.at(ring.fullk, s), 1);
      mbar_init(ring.at(ring.fullv, s), 1);
      mbar_init(ring.at(ring.emptyk, s), 8);  // one arrival from each consumer warp
      mbar_init(ring.at(ring.emptyv, s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x < 32) produce(&q_map, &k_map, &v_map, p, b, h, q0, q_s, k_s, v_s, ring);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    consume(p, b, h, q0, wg - 1, q_s, k_s, v_s, ring);
  }
}

// ---- host side ---------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the library
// links against nothing but the CUDA runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault,
                                            &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// A [B, S, H, dim] bf16 tensor as a 4-d map, read in boxes of 64 columns of
// one head over 128 rows of one batch element (rows past S read as zeros).
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int dim, int batch, int seq,
            int heads) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dim), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(dim) * sizeof(__nv_bfloat16);
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {kChunk, 1, kBlockM, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" int mla_attention_launch(const void* q, const void* k, const void* v, const void* pos,
                                    long long pos_b, long long pos_s, void* out, int batch,
                                    int seq, int heads, float scale_log2, void* stream) {
  static_assert(kBlockM == kBlockN, "one box shape serves Q, K and V");
  const int q_tiles = (seq + kBlockM - 1) / kBlockM;
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap q_map, k_map, v_map;
  if (!encode(fn, &q_map, q, kDqk, batch, seq, heads) ||
      !encode(fn, &k_map, k, kDqk, batch, seq, heads) ||
      !encode(fn, &v_map, v, kDv, batch, seq, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(mla_attention_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  Params p{static_cast<const long long*>(pos), pos_b, pos_s, static_cast<__nv_bfloat16*>(out),
           seq, heads, scale_log2};
  const dim3 grid(q_tiles, heads, batch);
  mla_attention_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mla_attention_kernel_info(int* registers, int* local_bytes, int* shared_bytes,
                                         int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, mla_attention_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(mla_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *shared_bytes = kSmemBytes;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, mla_attention_kernel, kThreads, kSmemBytes));
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

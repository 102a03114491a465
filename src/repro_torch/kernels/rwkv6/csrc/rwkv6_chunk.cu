// One RWKV-6 chunk step (chunked WKV linear attention), hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_rwkv6_chunk_kernel` / `rwkv6_chunk_pallas` in
// src/repro/kernels/rwkv6/rwkv6.py:23. Per (batch b, head h), on the [T, P]
// tiles r, k, v, log_w of one chunk, the bonus u [P] and the carried state
// s0 [P, P], with cum[t] = sum_{j<=t} log_w[j] and cum_prev = cum - log_w:
//
//     a[t, i] = sum_p r[t,p] k[i,p] exp(cum_prev[t,p] - cum[i,p])   (i < t)
//     a[t, t] = sum_p r[t,p] u[p] k[t,p]                            (the bonus)
//     y[t, q] = sum_{i<=t} a[t, i] v[i, q] + sum_p r[t,p] exp(cum_prev[t,p]) s0[p, q]
//     s1[p, q] = s0[p, q] exp(cum[T-1,p]) + sum_i k[i,p] exp(cum[T-1,p] - cum[i,p]) v[i, q]
//
// all in float32, as the Pallas kernel computes.
//
// Sub-chunks. The chunk is cut into sub-chunks of 16 tokens. For a query
// sub-chunk J starting at token j0 and a key sub-chunk I < J ending at
// token i1, every pairwise decay of the block (J, I) factors as
//
//     exp(cum_prev[t] - cum[i]) = exp(cum_prev[t] - cum_prev[j0])    t in J
//                                 * exp(cum_prev[j0] - cum[i1])
//                                 * exp(cum[i1] - cum[i])            i in I
//
// and since log_w <= 0 makes cum non-increasing, each of the three exponents
// is <= 0 for any decay: no factor can overflow, and a factor underflows only
// where the whole term is below float32's range. So the off-diagonal blocks
// of a are plain products of r and k with their decays folded in, and only
// the 16 x 16 diagonal blocks keep the exact difference form (4 x 120 x 64
// exponentials per block instead of 64 x 63 / 2 x 64). The one-step
// factoring exp(cum_prev[t]) exp(-cum[i]) over the whole chunk is not used:
// cum reaches -174 over 64 tokens at the model's floor of -e per token, and
// exp(174) is past float32's range.
//
// Tensor cores, in 3xTF32. The products (off-diagonal a, a v, r' s0 and
// k'^T v) run on `mma.sync.m16n8k8` with TF32 operands. A TF32 operand keeps
// 10 of float32's 23 mantissa bits, and products of plain TF32 operands miss
// the kernel's tolerance (allclose(rtol=1e-4, atol=1e-5) against the plain
// version; tests/test_torch_rwkv6_subchunk.py shows it). So each operand x is
// split into hi = tf32(x) and lo = tf32(x - hi), and a.b is taken as
// lo.hi + hi.lo + hi.hi: three tensor-core products per term, 22 bits of
// each operand, within float32's error. The diagonal blocks, with their
// exponentials, stay on the CUDA cores.
//
// What bounds it on this card: at rwkv6-3b's prefill shape (B = 8, T = 64,
// H = 40, P = 64) one call reads r/k/v/log_w (21.0 MB), u and s0 (5.2 MB)
// and writes y and s1 (5.2 MB each): 36.7 MB, 11.0 us at 3.35 TB/s. The
// products take about 0.5 GFLOP (1.5 GFLOP of TF32 in three passes) and the
// diagonal blocks 9.8 M exponentials, so bytes set the bound. What holds it
// back is that the steps of a block follow each other: the three
// tensor-core passes take the largest share of a block's time, then the
// loads, which no other block overlaps since all run at once, then the
// diagonal blocks (PERF.md, section 7).
//
// Tiling: one block of 256 threads (8 warps) per (head, batch element)
// reads each input element once, in place in the [B, T, H, P] layout (row
// stride H*P, any batch stride). Four [64, 64] tiles of shared memory are
// reused as the chunk goes through its steps (r then r'; k then k'; log_w,
// cum_prev, then v; cum, s0, then a), 75,776 bytes in all, so three blocks
// fit on an SM and the 320 blocks of a prefill chunk run in one wave on 132
// SMs. Rows are padded so that the loads of a warp hit 32 banks: 68 floats
// for tiles read along their rows, 72 for v and s0, read down their
// columns. Steps: r, k and log_w copied in asynchronously; the cumulative
// sums (a thread per column, in token order, as torch.cumsum adds); the
// diagonal blocks into registers (2 x 2 pairs per thread over float4
// loads, each row loaded feeding two pairs) and the decay vectors; the
// decays folded into r and k in place while v and s0 are read into
// registers; v and s0 into the freed tiles; the carry-in read of y and s1
// (a warp per 16 rows and 32 columns, 4 accumulator tiles); a into the
// freed s0 tile, its off-diagonal blocks a warp per block; then a v.
// T < 64 and P < 64 are zero-padded in shared memory to whole sub-chunks
// and 8-wide steps, with no padding copy in device memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMax = 64;        // T and P
constexpr int kSub = 16;        // tokens per sub-chunk
constexpr int kLd = kMax + 4;   // row stride of tiles read along their rows (4 mod 32 banks)
constexpr int kLdv = kMax + 8;  // row stride of v and s0, read down their columns (8 mod 32)
constexpr int kTile = kMax * kLd;
constexpr int kTileV = kMax * kLdv;
constexpr int kPer = kMax * kMax / kThreads;  // elements of a [64, 64] tile per thread
constexpr int kQuads = (kSub / 2) * (kSub / 2 + 1) / 2;  // 2 x 2 pair groups of a diagonal block

// Shared memory: two [64, kLd] regions (r then r'; k then k'), two [64,
// kLdv] regions (log_w, cum_prev, then v; cum, s0, then a), u [64] and the
// decay vectors g [4, 64], f [4, 64], e [6, 64] and d [64]: 75,776 bytes, so
// three blocks fit on an SM and the 320 blocks of a prefill chunk run in one
// wave on 132 SMs.
constexpr int kSmemFloats = 2 * kTile + 2 * kTileV + 16 * kMax;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Asynchronous copies from device to shared memory (sm_80+): `bytes` of the
// source are read and the rest of the 4 or 16 bytes is zero-filled.
__device__ __forceinline__ void copy_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void copy_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes));
}

// Commit this thread's copies and wait until they have all landed.
__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Four floats of a row at column p (a multiple of 4), zero where the row or
// a column is out of range; one 16-byte load when vec4 (P % 4 == 0 and
// 16-byte aligned rows).
__device__ __forceinline__ float4 load4(const float* ptr, bool row_in, int p, int cols, bool vec4) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!row_in || p >= cols) return x;
  if (vec4) return *reinterpret_cast<const float4*>(ptr);
  x.x = ptr[0];
  if (p + 1 < cols) x.y = ptr[1];
  if (p + 2 < cols) x.z = ptr[2];
  if (p + 3 < cols) x.w = ptr[3];
  return x;
}

// float32 -> TF32 (10 mantissa bits), rounded to nearest, ties away from zero
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// An m16n8k8 A fragment (rows gid and gid + 8, columns tig and tig + 4, in
// the order a0..a3 of the PTX ISA), each element split x = hi + lo with hi =
// tf32(x), lo = tf32(x - hi): 22 of float32's 24 bits.
struct Frag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float x0, float x1, float x2, float x3) {
    const float x[4] = {x0, x1, x2, x3};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hi[j] = tf32(x[j]);
      lo[j] = tf32(x[j] - __uint_as_float(hi[j]));
    }
  }
};

// An m16n8k8 B fragment (rows tig and tig + 4, column gid), split likewise.
struct BFrag {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float x0, float x1) {
    hi[0] = tf32(x0);
    lo[0] = tf32(x0 - __uint_as_float(hi[0]));
    hi[1] = tf32(x1);
    lo[1] = tf32(x1 - __uint_as_float(hi[1]));
  }
};

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[n] += a b[n] for the first n_tiles column tiles, in 3xTF32: the two
// small cross terms first, then hi hi (lo lo, below 2^-22 of the product, is
// dropped). Each pass runs over all tiles before the next, so consecutive
// mma write different accumulators and need not wait for each other.
template <int N>
__device__ __forceinline__ void mma3(float (&c)[N][4], const Frag& a, const BFrag (&b)[N],
                                     int n_tiles) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < n_tiles) mma(c[n], a.lo, b[n].hi);
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < n_tiles) mma(c[n], a.hi, b[n].lo);
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < n_tiles) mma(c[n], a.hi, b[n].hi);
}

__global__ void __launch_bounds__(kThreads, 3)
    rwkv6_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ log_w,
                       const float* __restrict__ u, const float* __restrict__ s0,
                       float* __restrict__ y, float* __restrict__ s1, long long r_bstride,
                       long long k_bstride, long long v_bstride, long long w_bstride,
                       int t_len, int n_heads, int p_dim, bool vec4) {
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;           // r, then r' = r exp(cum_prev - cum_prev[j0])
  float* sk = sr + kTile;     // k, then k' = k exp(cum[i1] - cum)
  float* sp = sk + kTile;     // log_w, then cum_prev (row stride kLd) ...
  float* sv = sp;             // ... then v (row stride kLdv)
  float* sc = sp + kTileV;    // cum (kLd) ...
  float* ss = sc;             // ... then s0 (kLdv) ...
  float* sa = sc;             // ... then a (kLd)
  float* su = sc + kTileV;    // u of this head
  float* sg = su + kMax;      // g[J] = exp(cum_prev[j0])             carry-in read
  float* sf = sg + 4 * kMax;  // f[I] = exp(cum[T-1] - cum[i1])       state update
  float* se = sf + 4 * kMax;  // e[J(J-1)/2 + I] = exp(cum_prev[j0] - cum[i1]), I < J
  float* sd = se + 6 * kMax;  // d = exp(cum[T-1])                    s0 decay

  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const long long row = static_cast<long long>(n_heads) * p_dim;  // stride of t
  const long long head = static_cast<long long>(h) * p_dim;
  const long long state = (b * n_heads + h) * static_cast<long long>(p_dim) * p_dim;
  const int tid = threadIdx.x;
  const int n_sub = (t_len + kSub - 1) / kSub;
  const int last = t_len - 1;
  const float* rb = r + b * r_bstride + head;
  const float* kb = k + b * k_bstride + head;
  const float* vb = v + b * v_bstride + head;
  const float* wb = log_w + b * w_bstride + head;

  // 1. stage r, k and log_w, each element read once and zero past T and P,
  //    by asynchronous copies: 16 bytes at a time where P and the addresses
  //    allow (vec4), else 4
  {
    const float* srcs[3] = {rb, kb, wb};
    float* dsts[3] = {sr, sk, sp};
    if (vec4) {
#pragma unroll
      for (int j = 0; j < kPer / 4; ++j) {
        const int e = tid + j * kThreads, t = e / (kMax / 4), p = (e % (kMax / 4)) * 4;
        const bool in = t < t_len && p < p_dim;
#pragma unroll
        for (int x = 0; x < 3; ++x)
          copy_async16(dsts[x] + t * kLd + p, in ? srcs[x] + t * row + p : srcs[x], in ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < kPer; ++j) {
        const int e = tid + j * kThreads, t = e / kMax, p = e % kMax;
        const bool in = t < t_len && p < p_dim;
#pragma unroll
        for (int x = 0; x < 3; ++x)
          copy_async4(dsts[x] + t * kLd + p, in ? srcs[x] + t * row + p : srcs[x], in ? 4 : 0);
      }
    }
  }
  if (tid < kMax) su[tid] = tid < p_dim ? u[head + tid] : 0.f;
  copy_async_wait_all();
  __syncthreads();

  // 2. cumulative log decay down each column, in token order as
  //    torch.cumsum adds it: cum and cum_prev = cum - log_w (rows past T
  //    repeat cum[T-1])
  if (tid < kMax) {
    float c = 0.f;
    for (int t0 = 0; t0 < kMax; t0 += kSub) {
      float lw[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) lw[j] = sp[(t0 + j) * kLd + tid];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        c += lw[j];
        sc[(t0 + j) * kLd + tid] = c;
        sp[(t0 + j) * kLd + tid] = c - lw[j];
      }
    }
  }
  __syncthreads();

  // 3. the diagonal blocks of a into registers, in the difference form,
  //    2 x 2 pairs per thread (rows 2a, 2a + 1 and columns 2c, 2c + 1, c <= a,
  //    of a block; 144 threads), so that each row read from shared memory
  //    feeds two pairs; the other threads compute the decay vectors of the
  //    factored blocks meanwhile
  float diag[2][2] = {};
  int q_jb = 4, q_a = 0, q_c = 0;
  if (tid < 4 * kQuads) {
    q_jb = tid / kQuads;
    q_c = tid - q_jb * kQuads;
    while (q_c > q_a) q_c -= ++q_a;
  }
  const int t0 = q_jb * kSub + 2 * q_a, i0 = q_jb * kSub + 2 * q_c;
  if (q_jb < n_sub) {
    const bool on_diag = q_a == q_c;  // (t0, i0 + 1) lies above the diagonal
    const float* rt = sr + t0 * kLd;
    const float* pt = sp + t0 * kLd;
    const float* ki = sk + i0 * kLd;
    const float* ci = sc + i0 * kLd;
#pragma unroll
    for (int p = 0; p < kMax; p += 4) {  // zero past P
      float4 rv[2], pv[2], kv[2], cv[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        rv[x] = ld4(rt + x * kLd + p);
        pv[x] = ld4(pt + x * kLd + p);
        kv[x] = ld4(ki + x * kLd + p);
        cv[x] = ld4(ci + x * kLd + p);
      }
      const float4 uv = ld4(su + p);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          float4 w = make_float4(__expf(pv[x].x - cv[y].x), __expf(pv[x].y - cv[y].y),
                                 __expf(pv[x].z - cv[y].z), __expf(pv[x].w - cv[y].w));
          if (x == y && on_diag) w = uv;  // the bonus
          if (x < y && on_diag) w = make_float4(0.f, 0.f, 0.f, 0.f);
          diag[x][y] += rv[x].x * kv[y].x * w.x + rv[x].y * kv[y].y * w.y +
                        rv[x].z * kv[y].z * w.z + rv[x].w * kv[y].w * w.w;
        }
      }
    }
  }
  const float* clast = sc + last * kLd;
  for (int e = tid - 4 * kQuads; e >= 0 && e < 15 * kMax; e += kThreads - 4 * kQuads) {
    const int vec = e / kMax, p = e % kMax;
    if (vec < 4) {  // g[J]
      sg[e] = vec < n_sub ? expf(sp[vec * kSub * kLd + p]) : 0.f;
    } else if (vec < 8) {  // f[I]
      const int ib = vec - 4, i1 = min(ib * kSub + kSub - 1, last);
      sf[ib * kMax + p] = ib < n_sub ? expf(clast[p] - sc[i1 * kLd + p]) : 0.f;
    } else if (vec < 14) {  // e[J, I]
      const int pair = vec - 8;
      const int jb = pair < 1 ? 1 : pair < 3 ? 2 : 3, ib = pair - jb * (jb - 1) / 2;
      se[pair * kMax + p] =
          jb < n_sub ? expf(sp[jb * kSub * kLd + p] - sc[(ib * kSub + kSub - 1) * kLd + p]) : 0.f;
    } else {
      sd[p] = expf(clast[p]);
    }
  }
  __syncthreads();

  // 4. fold the bounded decays into r and k, in place, while v and s0 are
  //    read into registers (their tiles are taken until step 5)
  float4 v_reg[kPer / 4], s0_reg[kPer / 4];
#pragma unroll
  for (int j = 0; j < kPer / 4; ++j) {
    const int e = tid + j * kThreads, t = e / (kMax / 4), p = (e % (kMax / 4)) * 4;
    v_reg[j] = load4(vb + t * row + p, t < t_len, p, p_dim, vec4);
    s0_reg[j] = load4(s0 + state + t * p_dim + p, t < p_dim, p, p_dim, vec4);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = tid + j * kThreads, t = e / kMax, p = e % kMax, jb = t / kSub;
    if (jb < n_sub) {
      const int i1 = min(jb * kSub + kSub - 1, last);
      sr[t * kLd + p] *= expf(sp[t * kLd + p] - sp[jb * kSub * kLd + p]);
      sk[t * kLd + p] *= expf(sc[i1 * kLd + p] - sc[t * kLd + p]);
    }
  }
  __syncthreads();

  // 5. v and s0 into the tiles of cum_prev and cum
#pragma unroll
  for (int j = 0; j < kPer / 4; ++j) {
    const int e = tid + j * kThreads, t = e / (kMax / 4), p = (e % (kMax / 4)) * 4;
    *reinterpret_cast<float4*>(sv + t * kLdv + p) = v_reg[j];
    *reinterpret_cast<float4*>(ss + t * kLdv + p) = s0_reg[j];
  }
  __syncthreads();

  // 6. on the tensor cores, a warp per 16 rows (tile warp % 4) and 32
  //    columns (half warp / 4): the carry-in read of y, sum_p r'[t, p] g_J[p]
  //    s0[p, q], kept in registers; and s1[p, q] = s0[p, q] d[p] + sum_i
  //    k'[i, p] f_I[p] v[i, q], stored
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;  // mma fragment coordinates
  const int mt = warp % 4, q_base = (warp / 4) * 32;
  const int n_tiles = min(4, (p_dim - q_base + 7) / 8);  // 8-wide column tiles (<= 0: none)
  const bool y_rows = mt * kSub < t_len && n_tiles > 0;
  const float* vcol = sv + tig * kLdv + q_base + gid;
  float yacc[4][4] = {};
  if (y_rows) {
    const float* rrow = sr + (mt * kSub + gid) * kLd + tig;
    const float* gv = sg + mt * kMax + tig;
    const float* scol = ss + tig * kLdv + q_base + gid;
#pragma unroll
    for (int k0 = 0; k0 < kMax; k0 += 8) {  // zero past P
      const float g0 = gv[k0], g4 = gv[k0 + 4];
      Frag a;
      a.set(rrow[k0] * g0, rrow[8 * kLd + k0] * g0, rrow[k0 + 4] * g4, rrow[8 * kLd + k0 + 4] * g4);
      BFrag bf[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        bf[nt].set(scol[k0 * kLdv + nt * 8], scol[(k0 + 4) * kLdv + nt * 8]);
      mma3(yacc, a, bf, n_tiles);
    }
  }
  if (mt * kSub < p_dim && n_tiles > 0) {
    const int p0 = mt * kSub + gid;
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int pr = p0 + (c / 2) * 8, q = q_base + nt * 8 + 2 * tig + c % 2;
        acc[nt][c] = ss[pr * kLdv + q] * sd[pr];
      }
    }
    const float* kcol = sk + tig * kLd + p0;
#pragma unroll
    for (int k0 = 0; k0 < kMax; k0 += 8) {  // k' and v are zero past T
      const float* fv = sf + (k0 / kSub) * kMax + p0;
      const float f0 = fv[0], f8 = fv[8];
      Frag a;
      a.set(kcol[k0 * kLd] * f0, kcol[k0 * kLd + 8] * f8, kcol[(k0 + 4) * kLd] * f0,
            kcol[(k0 + 4) * kLd + 8] * f8);
      BFrag bf[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        bf[nt].set(vcol[k0 * kLdv + nt * 8], vcol[(k0 + 4) * kLdv + nt * 8]);
      mma3(acc, a, bf, n_tiles);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int pr = p0 + (c / 2) * 8, q = q_base + nt * 8 + 2 * tig + c % 2;
        if (nt < n_tiles && pr < p_dim && q < p_dim) s1[state + pr * p_dim + q] = acc[nt][c];
      }
    }
  }
  __syncthreads();

  // 7. a into the tile of s0: the diagonal blocks from registers (zero above
  //    the diagonal), and the off-diagonal blocks a[J, I] = r'_J (k'_I
  //    e_JI)^T on the tensor cores, one warp per (J, I)
  if (q_jb < n_sub) {
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y) sa[(t0 + x) * kLd + i0 + y] = diag[x][y];
  }
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) {
    const int tt = tid / kSub, ii = tid % kSub;
    if (jb < n_sub && ii / 2 > tt / 2) sa[(jb * kSub + tt) * kLd + jb * kSub + ii] = 0.f;
  }
  for (int pair = warp; pair < n_sub * (n_sub - 1) / 2; pair += kThreads / 32) {
    const int jb = pair < 1 ? 1 : pair < 3 ? 2 : 3, ib = pair - jb * (jb - 1) / 2;
    const float* ra = sr + (jb * kSub + gid) * kLd + tig;
    const float* kbk = sk + (ib * kSub + gid) * kLd + tig;
    const float* ev = se + pair * kMax + tig;
    float acc[2][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < kMax; k0 += 8) {  // zero past P
      Frag a;
      a.set(ra[k0], ra[8 * kLd + k0], ra[k0 + 4], ra[8 * kLd + k0 + 4]);
      const float e0 = ev[k0], e4 = ev[k0 + 4];
      BFrag bf[2];
#pragma unroll
      for (int half = 0; half < 2; ++half)
        bf[half].set(kbk[half * 8 * kLd + k0] * e0, kbk[half * 8 * kLd + k0 + 4] * e4);
      mma3(acc, a, bf, 2);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* out = sa + (jb * kSub + gid) * kLd + ib * kSub + half * 8 + 2 * tig;
      out[0] = acc[half][0];
      out[1] = acc[half][1];
      out[8 * kLd] = acc[half][2];
      out[8 * kLd + 1] = acc[half][3];
    }
  }
  __syncthreads();

  // 8. y[t, q] += sum_{i<=t} a[t, i] v[i, q], then y is stored
  if (y_rows) {
    const float* arow = sa + (mt * kSub + gid) * kLd + tig;
#pragma unroll
    for (int k0 = 0; k0 < kMax; k0 += 8) {
      if (k0 < (mt + 1) * kSub) {  // a is zero right of the diagonal block
        Frag a;
        a.set(arow[k0], arow[8 * kLd + k0], arow[k0 + 4], arow[8 * kLd + k0 + 4]);
        BFrag bf[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          bf[nt].set(vcol[k0 * kLdv + nt * 8], vcol[(k0 + 4) * kLdv + nt * 8]);
        mma3(yacc, a, bf, n_tiles);
      }
    }
    float* yb = y + b * t_len * row + head;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int t = mt * kSub + gid + (c / 2) * 8, q = q_base + nt * 8 + 2 * tig + c % 2;
        if (nt < n_tiles && t < t_len && q < p_dim) yb[t * row + q] = yacc[nt][c];
      }
    }
  }
}

}  // namespace

// Bytes of shared memory one block takes (the same at every chunk length
// t_len <= 64 and head size p_dim <= 64).
extern "C" long long rwkv6_chunk_shared_bytes(int t_len, int p_dim) {
  (void)t_len;
  (void)p_dim;
  return kSmemFloats * static_cast<long long>(sizeof(float));
}

extern "C" int rwkv6_chunk_launch(const void* r, const void* k, const void* v,
                                  const void* log_w, const void* u, const void* s0, void* y,
                                  void* s1, long long r_bstride, long long k_bstride,
                                  long long v_bstride, long long w_bstride, int batch,
                                  int t_len, int n_heads, int p_dim, void* stream) {
  const int smem = static_cast<int>(rwkv6_chunk_shared_bytes(t_len, p_dim));
  // opt in past the 48 KB default once per device
  static bool opted_in[64] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= 64 || !opted_in[device]) {
    e = cudaFuncSetAttribute(rwkv6_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device < 64) opted_in[device] = true;
  }
  const auto aligned = [](const void* ptr, long long bstride) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && bstride % 4 == 0;
  };
  const bool vec4 = p_dim % 4 == 0 && aligned(r, r_bstride) && aligned(k, k_bstride) &&
                    aligned(v, v_bstride) && aligned(log_w, w_bstride) && aligned(s0, 0);
  const dim3 grid(n_heads, batch);
  rwkv6_chunk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(log_w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(y), static_cast<float*>(s1),
      r_bstride, k_bstride, v_bstride, w_bstride, t_len, n_heads, p_dim, vec4);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of shared memory one block of this kernel may opt in to on `device`,
// or the negated cudaError_t when it cannot be read.
extern "C" int rwkv6_chunk_max_shared_bytes(int device) {
  int bytes = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? bytes : -static_cast<int>(e);
}

// The compiled kernel's registers per thread, local (spill) bytes per thread,
// and resident blocks per SM at its shared-memory size on the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError_t.
extern "C" int rwkv6_chunk_kernel_info(int* registers, int* local_bytes, int* blocks_per_sm) {
  const int smem = static_cast<int>(rwkv6_chunk_shared_bytes(kMax, kMax));
  cudaError_t e = cudaFuncSetAttribute(rwkv6_chunk_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, rwkv6_chunk_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, rwkv6_chunk_kernel, kThreads,
                                                    smem);
  return static_cast<int>(e);
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

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
// all in float32, as the Pallas kernel computes. Every exponent is <= 0.
// The pairwise decay is NOT factored into exp(cum_prev[t]) * exp(-cum[i]):
// log_w >= -e per token, so cum reaches about -174 over 64 tokens and
// exp(174) is past float32's range. Each of the T(T-1)/2 x P exponents is
// taken as a difference, as the plain version does.
//
// What bounds it on this card: at rwkv6-3b's prefill shape (B = 8, T = 64,
// H = 40, P = 64) one call reads r/k/v/log_w (21.0 MB), u and s0 (5.2 MB)
// and writes y and s1 (5.2 MB each): 36.7 MB, 11.0 us at 3.35 TB/s. The
// arithmetic is about 0.6 GFLOP of float32 (8.6 us at 67 TFLOP/s) and 41 M
// exp on the special-function units. Bytes bound it, closely followed by
// the exponentials.
//
// What the design does about it: one block per (head, batch element) reads
// each input element once, in place in the [B, T, H, P] layout (row stride
// H*P, any batch stride), stages r, k, v, the inclusive and exclusive
// cumulative decay, s0 and u in shared memory (rows padded to an odd
// stride, so a warp reading one column of 32 different rows hits 32
// banks), and writes y and s1 once. The TPU kernel materialises the
// [T, T, P] decay plane in VMEM (1 MB) and contracts it on the MXU; here no
// plane exists: a warp owns a row t of a, each lane a column i, and the
// P-long sum with its exponentials runs in a register. The three products
// (a v, r' s0, k'^T v) read shared memory only, one warp per output row and
// a lane per output column. At T = P = 64 the tiles take 116,736 bytes,
// over the 48 KB default, so the launcher opts in to dynamic shared memory;
// the wrapper (ops.py) refuses a shape whose tiles exceed the card's
// opt-in limit, and T or P above 64. Tensor cores are not used: the
// pairwise exponent cannot be split into two matrix operands.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// Shared-memory floats for one block: five [T, P|1] tiles (r, k, v, cum,
// cum_prev), s0 [P, P|1], u [P] and a [T, T|1].
__host__ __device__ inline long long smem_floats(int t_len, int p_dim) {
  const long long ld = p_dim | 1, lda = t_len | 1;
  return (5LL * t_len + p_dim) * ld + p_dim + t_len * lda;
}

__global__ void __launch_bounds__(kThreads)
    rwkv6_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ log_w,
                       const float* __restrict__ u, const float* __restrict__ s0,
                       float* __restrict__ y, float* __restrict__ s1, long long r_bstride,
                       long long k_bstride, long long v_bstride, long long w_bstride,
                       int t_len, int n_heads, int p_dim) {
  extern __shared__ float smem[];
  const int ld = p_dim | 1;   // odd row strides: a column of 32 rows spans 32 banks
  const int lda = t_len | 1;
  float* sr = smem;               // [T, ld] r, then r * exp(cum_prev)
  float* sk = sr + t_len * ld;    // [T, ld] k, then k * exp(cum[T-1] - cum)
  float* sv = sk + t_len * ld;    // [T, ld] v
  float* sc = sv + t_len * ld;    // [T, ld] cum (inclusive)
  float* sp = sc + t_len * ld;    // [T, ld] log_w, then cum_prev
  float* ss = sp + t_len * ld;    // [P, ld] s0
  float* su = ss + p_dim * ld;    // [P] u of this head
  float* sa = su + p_dim;         // [T, lda] a, bonus on the diagonal

  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const long long row = static_cast<long long>(n_heads) * p_dim;  // stride of t
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = t_len * p_dim;
  const long long head = static_cast<long long>(h) * p_dim;

  // 1. stage the tiles, each element read once
  for (int e = tid; e < tile; e += kThreads) {
    const int t = e / p_dim, p = e - t * p_dim;
    const long long g = t * row + head + p;
    sr[t * ld + p] = r[b * r_bstride + g];
    sk[t * ld + p] = k[b * k_bstride + g];
    sv[t * ld + p] = v[b * v_bstride + g];
    sp[t * ld + p] = log_w[b * w_bstride + g];
  }
  const long long state = (b * n_heads + h) * static_cast<long long>(p_dim) * p_dim;
  for (int e = tid; e < p_dim * p_dim; e += kThreads) {
    const int p = e / p_dim, q = e - p * p_dim;
    ss[p * ld + q] = s0[state + e];
  }
  for (int p = tid; p < p_dim; p += kThreads) su[p] = u[head + p];
  __syncthreads();

  // 2. cumulative log decay down each column: cum and cum_prev = cum - log_w
  for (int p = tid; p < p_dim; p += kThreads) {
    float c = 0.f;
    for (int t = 0; t < t_len; ++t) {
      const float lw = sp[t * ld + p];
      c += lw;
      sc[t * ld + p] = c;
      sp[t * ld + p] = c - lw;
    }
  }
  __syncthreads();

  // 3. a: warp per row t, lane per column i; zero above the diagonal
  for (int t = warp; t < t_len; t += kWarps) {
    const float* rt = sr + t * ld;
    const float* pt = sp + t * ld;
    for (int i = lane; i < t_len; i += 32) {
      const float* ki = sk + i * ld;
      float acc = 0.f;
      if (i < t) {
        const float* ci = sc + i * ld;
        for (int p = 0; p < p_dim; ++p) acc += rt[p] * ki[p] * expf(pt[p] - ci[p]);
      } else if (i == t) {
        for (int p = 0; p < p_dim; ++p) acc += rt[p] * su[p] * ki[p];
      }
      sa[t * lda + i] = acc;
    }
  }
  __syncthreads();

  // 4. fold the decays into r (carry-in read) and k (state update)
  const float* clast = sc + (t_len - 1) * ld;
  for (int e = tid; e < tile; e += kThreads) {
    const int t = e / p_dim, p = e - t * p_dim;
    sr[t * ld + p] *= expf(sp[t * ld + p]);
    sk[t * ld + p] *= expf(clast[p] - sc[t * ld + p]);
  }
  __syncthreads();

  // 5. y[t, q] = sum_{i<=t} a[t, i] v[i, q] + sum_p r'[t, p] s0[p, q]
  float* yb = y + b * t_len * row + head;
  for (int t = warp; t < t_len; t += kWarps) {
    const float* at = sa + t * lda;
    const float* rt = sr + t * ld;
    for (int q = lane; q < p_dim; q += 32) {
      float acc = 0.f;
      for (int i = 0; i <= t; ++i) acc += at[i] * sv[i * ld + q];
      for (int p = 0; p < p_dim; ++p) acc += rt[p] * ss[p * ld + q];
      yb[t * row + q] = acc;
    }
  }

  // 6. s1[p, q] = s0[p, q] exp(cum[T-1, p]) + sum_i k'[i, p] v[i, q]
  for (int p = warp; p < p_dim; p += kWarps) {
    const float decay = expf(clast[p]);
    for (int q = lane; q < p_dim; q += 32) {
      float acc = 0.f;
      for (int i = 0; i < t_len; ++i) acc += sk[i * ld + p] * sv[i * ld + q];
      s1[state + p * p_dim + q] = ss[p * ld + q] * decay + acc;
    }
  }
}

}  // namespace

// Bytes of shared memory one block takes at chunk length t_len and head
// size p_dim.
extern "C" long long rwkv6_chunk_shared_bytes(int t_len, int p_dim) {
  return smem_floats(t_len, p_dim) * static_cast<long long>(sizeof(float));
}

extern "C" int rwkv6_chunk_launch(const void* r, const void* k, const void* v,
                                  const void* log_w, const void* u, const void* s0, void* y,
                                  void* s1, long long r_bstride, long long k_bstride,
                                  long long v_bstride, long long w_bstride, int batch,
                                  int t_len, int n_heads, int p_dim, void* stream) {
  const size_t smem = static_cast<size_t>(rwkv6_chunk_shared_bytes(t_len, p_dim));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_heads, batch);
  rwkv6_chunk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(log_w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(y), static_cast<float*>(s1),
      r_bstride, k_bstride, v_bstride, w_bstride, t_len, n_heads, p_dim);
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

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// One exponential-Euler step of the AdExp neuron with its four DPI synapse
// filters, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's step (src/repro/core/neuron.py
// `neuron_step`) is elementwise jnp code that XLA fuses under jit. Its
// PyTorch counterpart, core/neuron.py `neuron_step_eager`, runs as about
// forty elementwise kernels over [B, N] and [B, N, 4], each a full pass over
// device memory; this kernel is those forty in one pass. Per neuron i, with
// s = i_syn[i, :], d = drive[i, :] and the per-type decay and weight:
//
//     s'      = s * decay + d * weight
//     leak    = 1 + shunt_gain * s'[3]
//     i_in    = input_gain * ((s'[0] + s'[1]) - s'[2])  (+ i_ext[i])
//     e       = delta_t * exp(clamp((v - v_thresh) / delta_t, -20, 20))
//     v_new   = v + dt * ((-(v - v_rest) * leak + e - w) / tau_m + i_in)
//     w_new   = w + dt * (a_adapt * (v - v_rest) - w) / tau_w
//     then the refractory and spike logic of neuron_step_eager.
//
// Bit for bit the eager step on the card. Every operation of the eager step
// is one float32 operation here, in the same order, each rounded on its own:
// the __f*_rn intrinsics are never contracted into an FMA. A number reaches
// an eager operation as float32, and PyTorch's CUDA division by a number
// multiplies by its reciprocal, taken in float64 and rounded to float32; the
// wrapper hands the kernel those numbers and reciprocals (ops.py
// `constants`). expf is the CUDA math library's, as torch.exp's; the clamps
// keep a NaN, as torch.clamp does.
//
// What bounds it on this card: bytes. One step reads the state (v, w,
// refrac and the four DPI currents, 28 B a neuron) and the drive (16 B),
// writes the new state (28 B) and the spikes (4 B): 76 B a neuron, 0.96 GB
// at the benchmark's B = 8192, N = 1536, 0.285 ms at 3.35 TB/s; about 50
// float operations a neuron are far below the FP32 line.
//
// What the design does about it: one thread per neuron (a grid-stride loop
// past the grid's size), every load issued before any arithmetic, the
// [N, 4] rows of i_syn and drive read and written as one 16-byte float4,
// v, w, refrac and i_ext as coalesced 4-byte words; no shared memory, no
// reuse to exploit. The four decays and weights come from device memory
// (two float4 reads that every thread shares through L1), so the host never
// copies or waits on them. A null i_ext stands for no external current.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;

// The step's numbers, each as float32, in the order of ops.py CONSTANTS.
struct Constants {
  float dt, v_thresh, inv_delta_t, delta_t, v_rest, shunt_gain, input_gain, inv_tau_m, a_adapt,
      inv_tau_w, v_reset, v_peak, b_adapt, refrac;
};
constexpr int kConstants = sizeof(Constants) / sizeof(float);

// torch.clamp: a NaN passes through, anything else is bounded.
__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float4 dpi_update(float4 s, float4 d, float4 decay, float4 weight) {
  return make_float4(__fadd_rn(__fmul_rn(s.x, decay.x), __fmul_rn(d.x, weight.x)),
                     __fadd_rn(__fmul_rn(s.y, decay.y), __fmul_rn(d.y, weight.y)),
                     __fadd_rn(__fmul_rn(s.z, decay.z), __fmul_rn(d.z, weight.z)),
                     __fadd_rn(__fmul_rn(s.w, decay.w), __fmul_rn(d.w, weight.w)));
}

__global__ void __launch_bounds__(kThreads)
    neuron_step_kernel(const float* __restrict__ v_in, const float* __restrict__ w_in,
                       const float* __restrict__ refrac_in, const float4* __restrict__ i_syn_in,
                       const float4* __restrict__ drive, const float* __restrict__ i_ext,
                       const float4* __restrict__ decay_p, const float4* __restrict__ weight_p,
                       float* __restrict__ v_out, float* __restrict__ w_out,
                       float* __restrict__ refrac_out, float4* __restrict__ i_syn_out,
                       float* __restrict__ spikes, int64_t count, Constants c) {
  const float4 decay = __ldg(decay_p);
  const float4 weight = __ldg(weight_p);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < count;
       i += stride) {
    const float v = v_in[i];
    const float w = w_in[i];
    const float r = refrac_in[i];
    const float4 s_old = i_syn_in[i];
    const float4 d = drive[i];
    const float ext = i_ext != nullptr ? i_ext[i] : 0.0f;

    // DPI filters: exponential decay + weighted pulse injection.
    const float4 s = dpi_update(s_old, d, decay, weight);
    const float exc = __fadd_rn(s.x, s.y);
    const float leak_gain = __fadd_rn(1.0f, __fmul_rn(c.shunt_gain, s.w));
    float i_in = __fmul_rn(c.input_gain, __fsub_rn(exc, s.z));
    if (i_ext != nullptr) i_in = __fadd_rn(i_in, ext);

    // AdExp membrane, the exponential clipped.
    const float x = clamp_keep_nan(__fmul_rn(__fsub_rn(v, c.v_thresh), c.inv_delta_t), -20.0f,
                                   20.0f);
    const float exp_term = __fmul_rn(c.delta_t, expf(x));
    const float v_rel = __fsub_rn(v, c.v_rest);
    float dv = __fmul_rn(-v_rel, leak_gain);
    dv = __fadd_rn(dv, exp_term);
    dv = __fsub_rn(dv, w);
    dv = __fmul_rn(dv, c.inv_tau_m);
    dv = __fadd_rn(dv, i_in);
    float v_new = __fadd_rn(v, __fmul_rn(c.dt, dv));
    // adaptation
    const float dw = __fmul_rn(__fsub_rn(__fmul_rn(c.a_adapt, v_rel), w), c.inv_tau_w);
    const float w_new = __fadd_rn(w, __fmul_rn(c.dt, dw));

    const bool in_refrac = r > 0.0f;
    if (in_refrac) v_new = c.v_reset;
    const bool spike = v_new >= c.v_peak && !in_refrac;
    const float r_left = __fsub_rn(r, c.dt);

    v_out[i] = spike ? c.v_reset : v_new;
    w_out[i] = spike ? __fadd_rn(w_new, c.b_adapt) : w_new;
    refrac_out[i] = spike ? c.refrac : (isnan(r_left) ? r_left : fmaxf(r_left, 0.0f));
    i_syn_out[i] = s;
    spikes[i] = spike ? 1.0f : 0.0f;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// One step over `count` neurons (every leading dim flattened). `constants`
// is a host array of the kConstants floats of Constants; it is copied into
// the launch, so the caller may free it on return. Returns a cudaError_t.
extern "C" int neuron_step_launch(const void* v, const void* w, const void* refrac,
                                  const void* i_syn, const void* drive, const void* i_ext,
                                  const void* decay, const void* weight, void* v_out, void* w_out,
                                  void* refrac_out, void* i_syn_out, void* spikes, int64_t count,
                                  const float* constants, int n_constants, void* stream) {
  if (n_constants != kConstants || count < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(i_syn) || !aligned16(drive) || !aligned16(decay) || !aligned16(weight) ||
      !aligned16(i_syn_out)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (count == 0) return static_cast<int>(cudaSuccess);
  Constants c;
  std::memcpy(&c, constants, sizeof(c));
  const int64_t blocks = (count + kThreads - 1) / kThreads;
  const int64_t max_blocks = int64_t{1} << 30;
  const unsigned grid = static_cast<unsigned>(blocks < max_blocks ? blocks : max_blocks);
  neuron_step_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(refrac), static_cast<const float4*>(i_syn),
      static_cast<const float4*>(drive), static_cast<const float*>(i_ext),
      static_cast<const float4*>(decay), static_cast<const float4*>(weight),
      static_cast<float*>(v_out), static_cast<float*>(w_out), static_cast<float*>(refrac_out),
      static_cast<float4*>(i_syn_out), static_cast<float*>(spikes), count, c);
  return static_cast<int>(cudaGetLastError());
}

// The compiled kernel on the current card: registers and local (spill)
// bytes per thread, and the blocks of kThreads that fit on one SM.
extern "C" int neuron_step_kernel_info(int* registers, int* local_bytes, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, neuron_step_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, neuron_step_kernel, kThreads, 0));
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

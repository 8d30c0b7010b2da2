// Inference BatchNorm epilogue for Hopper (sm_90a): BatchNorm with the
// running statistics, then ReLU6 or nothing, then a residual add or
// nothing, in one pass over device memory.
//
// Replaces no TPU kernel: the JAX package leaves this epilogue to XLA, which
// fuses it into the convolution's output.  Unfused, UNISAL's static forward
// runs it as three PyTorch ops (cuDNN's eval BatchNorm, the clamp of relu6,
// the residual add), each a full read and write of a float32 activation.
// For each element of a (N, C, H, W) float32 tensor in channel c:
//     s = gamma[c] * (1 / sqrt(var[c] + eps));   t = beta[c] - mean[c] * s
//     y = fma(x, s, t);   y = min(max(y, 0), 6) if relu6;   y = r + y if r
// s and t in the order of ATen's CPU BatchNorm (its linear and constant
// terms), each operation correctly rounded (the intrinsics keep nvcc from
// contracting them); the clamp keeps NaN as torch.clamp does.
//
// Bound on this card: bytes.  Two float32 operations an element against 8
// bytes moved (12 with a residual).  The least it moves is one read of x
// (and of r) and one write of y: at the static forward's largest call,
// (96, 96, 128, 208) channels-last, 1.96 GB, 0.586 ms at 3.35 TB/s.
//
// Design, for one pass:
// - Each CTA first forms every channel's s and t in shared memory (8 bytes
//   a channel, from the BatchNorm's four buffers and eps: nothing is
//   precomputed on the host, so nothing can go stale).
// - A grid-stride loop over 16-byte units (float4 loads and stores, each
//   thread one unit in flight per step), the grid sized to fill the 132
//   SMs once: 8 CTAs of 256 threads an SM, as shared memory allows
//   (kernels/bn_act.py:launch_plan); 32-bit indices.  Channels-last (channel =
//   i % C) takes float4 units where C % 4 == 0: four channels, their s and
//   t read as float4 from shared memory.  NCHW (channel = (i / HW) % C)
//   takes them where HW % 4 == 0: one channel.  Either way the element
//   count is a multiple of 4, so no tail is left; any other shape, or an
//   unaligned pointer, runs the same loop over single floats.
// - The channel of a thread's element is carried along the loop by adding
//   the stride's step (no division after the first unit).
// Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Keep in step with kernels/bn_act.py (THREADS, MAX_CHANNELS, the modes).
constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;               // 2048 threads: a full SM
constexpr int kMaxChannels = 6144;          // 2 floats each: 48 KB of shared
constexpr int kMaxElements = 1 << 30;       // 32-bit indices, stride included
constexpr int kNhwcVec = 0;                 // float4: four channels
constexpr int kNchwVec = 1;                 // float4: one channel
constexpr int kScalar = 2;                  // one float

// The channel (e / inner) % c of element e, carried along a grid-stride
// loop whose step is `step` elements.
struct Channel {
  int inner, p, dp, c, ch, dc;
  __device__ Channel(int e, int step, int inner_, int c_)
      : inner(inner_), p(e % inner_), dp(step % inner_), c(c_),
        ch((e / inner_) % c_), dc((step / inner_) % c_) {}
  __device__ void advance() {
    p += dp;
    ch += dc;
    if (p >= inner) {
      p -= inner;
      ++ch;
    }
    if (ch >= c) ch -= c;                   // ch + dc + 1 < 2c
  }
};

template <bool kRelu6>
__device__ __forceinline__ float bn(float v, float s, float t) {
  float y = __fmaf_rn(v, s, t);
  if constexpr (kRelu6) {
    y = y < 0.0f ? 0.0f : y;                // NaN stays NaN
    y = y > 6.0f ? 6.0f : y;
  }
  return y;
}

template <int kMode, bool kRelu6, bool kRes>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
bn_act_kernel(const float* __restrict__ x, const float* __restrict__ res,
              float* __restrict__ out, const float* __restrict__ mean,
              const float* __restrict__ var, const float* __restrict__ gamma,
              const float* __restrict__ beta, float eps, int units, int c,
              int inner) {
  extern __shared__ __align__(16) float table[];   // s[0, c), t[c, 2c)
  float* scale = table;
  float* shift = table + c;
  for (int i = threadIdx.x; i < c; i += kThreads) {
    const float invstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var[i], eps)));
    const float s = __fmul_rn(invstd, gamma[i]);
    scale[i] = s;
    shift[i] = __fsub_rn(beta[i], __fmul_rn(mean[i], s));
  }
  __syncthreads();

  constexpr int kW = kMode == kScalar ? 1 : 4;
  const int stride = gridDim.x * kThreads;
  int u = blockIdx.x * kThreads + threadIdx.x;
  Channel ch(u * kW, stride * kW, inner, c);
  for (; u < units; u += stride, ch.advance()) {
    if constexpr (kMode == kScalar) {
      float y = bn<kRelu6>(__ldg(x + u), scale[ch.ch], shift[ch.ch]);
      if constexpr (kRes) y = __ldg(res + u) + y;
      out[u] = y;
    } else {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x) + u);
      float4 s, t;
      if constexpr (kMode == kNhwcVec) {        // ch % 4 == 0
        s = reinterpret_cast<const float4*>(scale)[ch.ch >> 2];
        t = reinterpret_cast<const float4*>(shift)[ch.ch >> 2];
      } else {
        s = make_float4(scale[ch.ch], scale[ch.ch], scale[ch.ch],
                        scale[ch.ch]);
        t = make_float4(shift[ch.ch], shift[ch.ch], shift[ch.ch],
                        shift[ch.ch]);
      }
      float4 y = make_float4(bn<kRelu6>(v.x, s.x, t.x),
                             bn<kRelu6>(v.y, s.y, t.y),
                             bn<kRelu6>(v.z, s.z, t.z),
                             bn<kRelu6>(v.w, s.w, t.w));
      if constexpr (kRes) {
        const float4 r = __ldg(reinterpret_cast<const float4*>(res) + u);
        y = make_float4(r.x + y.x, r.y + y.y, r.z + y.z, r.w + y.w);
      }
      reinterpret_cast<float4*>(out)[u] = y;
    }
  }
}

template <int kMode>
cudaError_t launch(bool relu6, bool has_res, int ctas, size_t smem,
                   cudaStream_t stream, const float* x, const float* res,
                   float* out, const float* mean, const float* var,
                   const float* gamma, const float* beta, float eps,
                   int units, int c, int inner) {
  auto kernel = relu6 ? (has_res ? bn_act_kernel<kMode, true, true>
                                 : bn_act_kernel<kMode, true, false>)
                      : (has_res ? bn_act_kernel<kMode, false, true>
                                 : bn_act_kernel<kMode, false, false>);
  kernel<<<ctas, kThreads, smem, stream>>>(x, res, out, mean, var, gamma,
                                           beta, eps, units, c, inner);
  return cudaGetLastError();
}

}  // namespace

// n float32 elements of a dense (N, C, H, W) tensor in `mode`'s layout, on
// the current device: channel (e / inner) % c, inner 1 for channels-last
// and H*W for NCHW.  `res` (null for none) and `out` have x's layout.  The
// float4 modes need 16-byte aligned x, res and out, and C % 4 == 0
// (kNhwcVec) or inner % 4 == 0 (kNchwVec); n at most 2^30; `ctas` from
// kernels/bn_act.py:launch_plan.  Returns the cudaError_t of the launch (0
// on success).
extern "C" int rtv_bn_act(const float* x, const float* res, float* out,
                          const float* mean, const float* var,
                          const float* gamma, const float* beta, float eps,
                          int n, int c, int inner, int mode, int relu6,
                          int ctas, void* stream) {
  if (n <= 0) return 0;
  const bool shape_ok = n <= kMaxElements && c >= 1 && c <= kMaxChannels &&
                        inner >= 1 && n % c == 0 && (n / c) % inner == 0 &&
                        ctas >= 1;
  const bool vec_ok = mode == kScalar ||
                      (mode == kNhwcVec && inner == 1 && c % 4 == 0) ||
                      (mode == kNchwVec && inner % 4 == 0);
  if (!shape_ok || !vec_ok) return static_cast<int>(cudaErrorInvalidValue);
  const int units = mode == kScalar ? n : n / 4;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(c);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (mode == kNhwcVec)
    rc = launch<kNhwcVec>(relu6, res != nullptr, ctas, smem, st, x, res, out,
                          mean, var, gamma, beta, eps, units, c, inner);
  else if (mode == kNchwVec)
    rc = launch<kNchwVec>(relu6, res != nullptr, ctas, smem, st, x, res, out,
                          mean, var, gamma, beta, eps, units, c, inner);
  else
    rc = launch<kScalar>(relu6, res != nullptr, ctas, smem, st, x, res, out,
                         mean, var, gamma, beta, eps, units, c, inner);
  return static_cast<int>(rc);
}

extern "C" const char* rtv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

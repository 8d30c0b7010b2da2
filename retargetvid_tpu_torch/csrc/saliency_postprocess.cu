// Saliency postprocess for Hopper (sm_90a): UNISAL log-probabilities ->
// per-frame max-normalized uint8 maps.
//
// Replaces the Pallas TPU kernel retargetvid_tpu/ops/pallas_kernels.py:
// saliency_postprocess (body _postprocess_kernel).  For each frame of a
// (T, H, W) float32 stack:
//     p = exp(x);  m = max(p);  out = floor((p / m) * 255)   (0 where m == 0)
// in the order of the JAX main path's inline form
// ((where(m > 0, p / m, p) * 255).astype(uint8), pipeline/fused.py:75-78):
// an IEEE division then a multiply, no reciprocal.  Built without
// --use_fast_math, so expf and the division are the precise ones and the
// result can be held bit for bit against torch.exp and / on the card.
//
// Bound on this card: bytes.  Each frame is read twice (max pass, then the
// scale pass) and written once as uint8; the 140x250 frame (137 KB) stays
// in L2 between the passes, so device memory sees about one read of the
// float32 input plus the uint8 output (16.8 MB at T=96, ~5 us at 3.35 TB/s).
// Design: one block per frame; a grid-stride max with a warp-shuffle and a
// shared-memory block reduction; then the scale pass storing uint8
// directly, so the float maps never go back to device memory.  Launches on
// the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
saliency_postprocess_kernel(const float* __restrict__ logp,
                            uint8_t* __restrict__ out, int hw) {
  const float* x = logp + static_cast<size_t>(blockIdx.x) * hw;
  uint8_t* o = out + static_cast<size_t>(blockIdx.x) * hw;

  // exp(x) >= 0, so 0 is the identity of this max (an all -inf frame
  // gives m == 0).
  float m = 0.0f;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) m = fmaxf(m, expf(x[i]));
  m = warp_max(m);

  __shared__ float partial[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (blockDim.x >> 5) ? partial[lane] : 0.0f;
    m = warp_max(m);
    if (lane == 0) partial[0] = m;
  }
  __syncthreads();
  m = partial[0];

  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    float q = 0.0f;
    if (m > 0.0f) q = floorf(__fdiv_rn(expf(x[i]), m) * 255.0f);
    o[i] = static_cast<uint8_t>(q);
  }
}

}  // namespace

// (T, H*W) float32 -> (T, H*W) uint8, both contiguous on the current device.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int rtv_saliency_postprocess(const float* logp, uint8_t* out,
                                        int t, int hw, void* stream) {
  if (t <= 0 || hw <= 0) return 0;
  saliency_postprocess_kernel<<<t, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      logp, out, hw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Saliency postprocess for Hopper (sm_90a): UNISAL log-probabilities ->
// per-frame max-normalized uint8 maps.
//
// Replaces the Pallas TPU kernel retargetvid_tpu/ops/pallas_kernels.py:
// saliency_postprocess (body _postprocess_kernel).  For each frame of a
// (T, H, W) float32 stack:
//     p = exp(x);  m = max(p);  out = floor((p / m) * 255)   (0 where m == 0)
// in the order of the JAX main path's inline form
// ((where(m > 0, p / m, p) * 255).astype(uint8), pipeline/fused.py:75-78):
// a correctly rounded division then a multiply.  Built without
// --use_fast_math, so expf is the precise one; a max is exact in any order,
// so the result is bit-equal to torch.exp and / on the card.
//
// Bound on this card: bytes.  The least the function moves is one read of
// the float32 input and one write of the uint8 output: 16.8 MB at the main
// path's (96, 140, 250), 5.0 us at 3.35 TB/s.
//
// Design, for one pass over device memory:
// - Each frame is split across a thread-block cluster of C CTAs (C <= 8,
//   from kernels/postprocess.py:launch_plan; C = 4 at the main shape: 384
//   CTAs of 256 threads, one wave on 132 SMs).  CTA r of a cluster takes
//   the contiguous slice [r*slice, (r+1)*slice) of its frame.
// - Each thread issues all of its loads before it uses any: up to 9
//   16-byte float4 loads (36 floats), held in registers, so a CTA keeps its
//   whole slice (9,216 floats) on chip and an SM has some 100 KB in flight.
//   exp is computed once, in place.
// - The frame's max: warp shuffles, then the block's warps through shared
//   memory, then the cluster's CTAs through distributed shared memory
//   (map_shared_rank) between two cluster barriers.
// - The scale pass works from the registers and stores one uchar4 per
//   float4, so device memory sees the input once and the output once.
// - Ragged shapes: where H*W % 4 != 0 or the input is not 16-byte aligned,
//   the same kernel runs with scalar loads and stores (kVec = false).  A
//   slice longer than a CTA holds on chip (frames above 8 x 9,216 floats) is
//   read twice: its overflow is reduced in the first pass and re-read, from
//   L2 or device memory, in the scale pass.
// Launches on the caller's stream and allocates nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Keep in step with kernels/postprocess.py (THREADS, FLOATS_PER_THREAD).
constexpr int kThreads = 256;
constexpr int kFloatsPerThread = 36;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// floor((p / m) * 255) as uint8 for the frame's max m (0 where m == 0).
__device__ __forceinline__ uint8_t scale(float p, float m) {
  return static_cast<uint8_t>(
      m > 0.0f ? __float2uint_rd(__fmul_rn(__fdiv_rn(p, m), 255.0f)) : 0u);
}

// One unit is kW consecutive elements: a float4 load and a uchar4 store on
// the vector path, one float and one byte on the scalar path.
template <bool kVec>
struct Unit {
  static constexpr int kW = kVec ? 4 : 1;
  __device__ static void load(const float* x, int u, float* v) {
    if constexpr (kVec) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(x) + u);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      v[0] = __ldg(x + u);
    }
  }
  __device__ static void store(uint8_t* o, int u, const float* p, float m) {
    if constexpr (kVec) {
      reinterpret_cast<uchar4*>(o)[u] = make_uchar4(
          scale(p[0], m), scale(p[1], m), scale(p[2], m), scale(p[3], m));
    } else {
      o[u] = scale(p[0], m);
    }
  }
};

// Grid: T * C CTAs, clusters of C along x; cluster i is frame i.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
saliency_postprocess_kernel(const float* __restrict__ logp,
                            uint8_t* __restrict__ out, int hw, int slice) {
  using U = Unit<kVec>;
  constexpr int kW = U::kW;
  constexpr int kUnits = kFloatsPerThread / kW;   // units held per thread

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t frame = blockIdx.x / c;
  const int lo = min(rank * slice, hw);
  const int n_units = (min(lo + slice, hw) - lo) / kW;
  const float* x = logp + frame * hw + lo;
  uint8_t* o = out + frame * hw + lo;
  const int tid = threadIdx.x;

  // Every load of the on-chip part first, then exp and the thread's max.
  // exp(x) >= 0, so 0 is the identity of this max (an all -inf frame gives
  // m == 0).
  float p[kFloatsPerThread];
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    const int u = tid + j * kThreads;
    if (u < n_units) U::load(x, u, p + j * kW);
  }
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    if (tid + j * kThreads < n_units) {
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        p[j * kW + e] = expf(p[j * kW + e]);
        m = fmaxf(m, p[j * kW + e]);
      }
    }
  }
  // Overflow beyond what the CTA holds: max now, re-read in the scale pass.
  for (int u = tid + kUnits * kThreads; u < n_units; u += kThreads) {
    float v[kW];
    U::load(x, u, v);
#pragma unroll
    for (int e = 0; e < kW; ++e) m = fmaxf(m, expf(v[e]));
  }

  // Block max, then the cluster's through distributed shared memory.
  __shared__ float warp_part[kWarps];
  __shared__ float cta_max;
  m = warp_max(m);
  const int lane = tid & 31;
  if (lane == 0) warp_part[tid >> 5] = m;
  __syncthreads();
  if (tid < 32) {
    m = warp_max(lane < kWarps ? warp_part[lane] : 0.0f);
    if (lane == 0) cta_max = m;
  }
  cluster.sync();                      // every CTA's cta_max is written
  m = lane < c ? *cluster.map_shared_rank(&cta_max, lane) : 0.0f;
  m = warp_max(m);
  // This CTA has read its peers; it may not exit before they have read it.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    const int u = tid + j * kThreads;
    if (u < n_units) U::store(o, u, p + j * kW, m);
  }
  for (int u = tid + kUnits * kThreads; u < n_units; u += kThreads) {
    float v[kW];
    U::load(x, u, v);
#pragma unroll
    for (int e = 0; e < kW; ++e) v[e] = expf(v[e]);
    U::store(o, u, v, m);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace

// (T, H*W) float32 -> (T, H*W) uint8, both contiguous on the current device,
// with the launch plan of kernels/postprocess.py:launch_plan: `cluster` CTAs
// per frame (1..8), each over `slice` elements (a multiple of 4); `vec`
// selects float4 loads, which need hw % 4 == 0 and a 16-byte aligned input.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int rtv_saliency_postprocess(const float* logp, uint8_t* out,
                                        int t, int hw, int cluster, int slice,
                                        int vec, void* stream) {
  if (t <= 0 || hw <= 0) return 0;
  if (cluster < 1 || cluster > 8 || slice <= 0 ||
      static_cast<int64_t>(slice) * cluster < hw)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(t) * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc =
      vec ? cudaLaunchKernelEx(&cfg, saliency_postprocess_kernel<true>, logp,
                               out, hw, slice)
          : cudaLaunchKernelEx(&cfg, saliency_postprocess_kernel<false>, logp,
                               out, hw, slice);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

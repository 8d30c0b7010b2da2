// UNISAL's smoothing tail for Hopper (sm_90a): the nearest resize of the
// adaptation map to the input size, the edge pad and both factors of the
// rank-r Gaussian smoothing, in one launch.
//
// Replaces no TPU kernel: the JAX package leaves the nearest resize, the
// edge pad and the two convolutions to XLA (retargetvid_tpu/models/
// unisal.py, the tail of UNISAL.__call__).  In the port it replaces
// UNISAL._resize (nearest), F.pad(..., 'replicate') and the two F.conv2d
// of models/unisal.py:forward_with_hidden, which cuDNN ran as a TF32 GEMM
// with two layout conversions (vertical) and a plain float32 FFMA conv
// at 1% of the card's float32 rate (horizontal).
//
// For every output pixel (n, y, x) of an (H, W) frame, p = k / 2:
//     out[n, y, x] = sum_f sum_j kh[f, j] *
//                    (sum_i kv[f, i] * src[n, nr(cl(y + i - p, H)),
//                                             nc(cl(x + j - p, W))])
// nr, nc: cv2 INTER_NEAREST's min(floor(d * (src / dst)), src - 1) in
// float64, as ops/resize.py:_nearest_matrix computes it; cl clamps to
// [0, dim - 1], the replicate pad.  kv is the (r, 1, k, 1) and kh the
// (1, r, 1, k) factor as stored, any values, r <= 16, odd k <= 63.  Every
// tap is one float32 FMA, in ascending i, then ascending j within f, then
// ascending f: nothing skipped or merged, so the vertical sum is formed at
// every one of the W + 2p padded columns, as the convolution computes it.
//
// Bound on this card: float32 FMA.  At the bench shape, (96, 1, 32, 52) ->
// (96, 1, 256, 416), r = 8, k = 41: 7.35 GFLOP vertical (96 * 8 * 256 *
// 456 * 41 * 2) and 6.71 GFLOP horizontal (96 * 8 * 256 * 416 * 41 * 2),
// 14.06 GFLOP at 67 TFLOP/s: 0.21 ms.  Its bytes, a 0.64 MB input and a
// 40.9 MB output, take 0.013 ms at 3.35 TB/s.  The vertical sum depends on
// its column only through the source column the nearest resize reads, so
// the function itself needs it at the 52 distinct source columns only:
// 0.84 GFLOP vertical, 7.55 GFLOP in all, 0.113 ms.  This kernel forms it
// at every padded column, as the convolution it replaces counts it.
//
// Design, for the FMA units:
// - One CTA of 416 threads (13 warps) per (frame, band of 16 output rows,
//   tile of up to 416 output columns): 1,536 CTAs at the bench shape, two
//   resident on each of the 132 SMs (72 registers, 46 KB of shared memory
//   each).  The tile is the whole 416-wide frame there; the host narrows
//   it (kernels/smooth.py:launch_plan) only where the staged source would
//   not fit, so the vertical pass is done once per padded column.
// - Staged once per CTA in shared memory: both factor tables, the source
//   row of each of the band's padded rows (as an offset), and the source
//   gathered down those rows for each distinct source column the tile
//   reads (52 at the bench shape, 12 KB), transposed (a column's rows
//   contiguous), so one float4 load gives a thread four rows of its
//   column.  The columns must upscale (w <= W; every UNISAL forward
//   upsamples its 1/8-size map to the network input): the wrapper refuses
//   a narrower output.  Rows take any scale.
// - For each factor f: the vertical pass writes the band's 16 rows of
//   V_f at the tile's padded columns into shared memory (a thread: one
//   column, 8 rows); then the horizontal pass adds sum_j kh[f, j] V_f to
//   16 accumulators a thread holds in registers over all f (a thread: 8
//   columns of 2 column blocks, in one row).  Both passes are the same
//   8-output register block: taps in steps of 8, two float4 loads of the
//   window and two of the weights (a broadcast) for 64 FMAs; the last
//   k % 8 taps one at a time.  Bands of 32 rows with 32 accumulators a
//   thread ran at the same speed (0.467 against 0.468 ms) in twice the
//   shared memory.
// - Row strides of 4 mod 8 floats: the 8 lanes of a quarter-warp that
//   read neighbouring rows (horizontal) or columns (vertical) with float4
//   loads hit 8 distinct 16-byte bank groups.
// - The finished tile goes back through shared memory and leaves in one
//   coalesced float32 store.
// At the bench shape it runs at 45% of the convolution's FMA bound and 24%
// of the function's (0.465 ms on an H100 at 700 W).  Its tap loops issue
// 150 instructions per 128 FMAs, so the instruction count does not hold it
// there; the shared-memory loads (about 10 wavefronts per 64 FMAs of a
// warp) and the two barriers per factor are the likely limits, not
// measured (no profiler of the SM's pipes).
// Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Keep in step with kernels/smooth.py (BAND, MAX_TILE, MAX_RANK, MAX_TAPS
// and launch_plan's strides and shared memory).
constexpr int kThreads = 416;
constexpr int kWarps = kThreads / 32;
constexpr int kBand = 16;                  // output rows of a CTA
constexpr int kBlock = 8;                  // outputs of a register block
constexpr int kUnits = 2;                  // horizontal blocks per thread
constexpr int kLaneCols = 32 / kBand;      // column blocks of a warp's lanes
constexpr int kMaxTile = kWarps * kUnits * kLaneCols * kBlock;   // 416
constexpr int kCtasPerSm = 2;
constexpr int kMaxRank = 16;
constexpr int kMaxTaps = 63;
constexpr int kMaxSmem = 232448;           // an H100 CTA's shared memory

struct Plan {
  int h, w, H, W, r, k;
  double sh, sw;                           // h / H and w / W
  int tile_w, tiles_x, bands;
  int sv, se, kp, n_ecols;
};

// cv2 INTER_NEAREST's source index of destination index d.
__device__ __forceinline__ int nearest(int d, double scale, int src) {
  const int i = static_cast<int>(floor(static_cast<double>(d) * scale));
  return i < src - 1 ? i : src - 1;
}

__device__ __forceinline__ int clamp_to(int v, int n) {
  return v < 0 ? 0 : (v > n - 1 ? n - 1 : v);
}

__device__ __forceinline__ void load8(float (&d)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}

// acc[q] += w[j] * s[q + j] for j < 8 (ascending), s = lo ++ hi.
__device__ __forceinline__ void taps8(float (&acc)[8], const float (&w)[8],
                                      const float (&lo)[8],
                                      const float (&hi)[8]) {
#pragma unroll
  for (int j = 0; j < kBlock; ++j) {
#pragma unroll
    for (int q = 0; q < kBlock; ++q) {
      const int s = q + j;                   // s & 7: its place in lo or hi
      acc[q] = __fmaf_rn(w[j], s < kBlock ? lo[s & 7] : hi[s & 7], acc[q]);
    }
  }
}

// acc[q] += sum_{i < k} w[i] * p[q + i], i ascending, q < 8.  p and w are
// 16-byte aligned; p is read up to p[k + 7], w up to w[k - 1].  Blocks of 8
// taps from two float4 loads of the window and two of the weights; the
// last k % 8 taps one at a time.
__device__ __forceinline__ void conv8(float (&acc)[8], const float* p,
                                      const float* w, int k) {
  float a[8], b[8], wb[8];
  load8(a, p);
  int i = 0;
  for (; i + 2 * kBlock <= k; i += 2 * kBlock) {
    load8(b, p + i + 8);
    load8(wb, w + i);
    taps8(acc, wb, a, b);
    load8(a, p + i + 16);
    load8(wb, w + i + 8);
    taps8(acc, wb, b, a);
  }
  if (i + kBlock <= k) {
    load8(b, p + i + 8);
    load8(wb, w + i);
    taps8(acc, wb, a, b);
    i += kBlock;
  }
  for (; i < k; ++i) {
    const float wi = w[i];
#pragma unroll
    for (int q = 0; q < kBlock; ++q) acc[q] = __fmaf_rn(wi, p[i + q], acc[q]);
  }
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
smooth_kernel(const float* __restrict__ src, const float* __restrict__ kv,
              const float* __restrict__ kh, float* __restrict__ out,
              const Plan pl) {
  extern __shared__ __align__(16) float smem[];
  const int vcols = pl.tile_w + pl.k - 1;            // padded columns
  float* vbuf = smem;                                // kBand x sv
  float* et = vbuf + kBand * pl.sv;                  // n_ecols x se
  float* kvs = et + pl.n_ecols * pl.se;              // r x kp
  float* khs = kvs + pl.r * pl.kp;                   // r x kp
  int* rows = reinterpret_cast<int*>(khs + pl.r * pl.kp);   // se
  int* ecol = rows + pl.se;                          // vcols

  int b = blockIdx.x;
  const int tile = b % pl.tiles_x;
  b /= pl.tiles_x;
  const int band = b % pl.bands;
  const int n = b / pl.bands;
  const int y0 = band * kBand;
  const int x0 = tile * pl.tile_w;
  const int pad = pl.k / 2;
  const int tid = threadIdx.x;
  const float* frame = src + static_cast<size_t>(n) * pl.h * pl.w;

  for (int i = tid; i < pl.r * pl.k; i += kThreads) {
    const int f = i / pl.k, t = i - f * pl.k;
    kvs[f * pl.kp + t] = __ldg(kv + i);
    khs[f * pl.kp + t] = __ldg(kh + i);
  }
  for (int t = tid; t < pl.se; t += kThreads)
    rows[t] = nearest(clamp_to(y0 + t - pad, pl.H), pl.sh, pl.h) * pl.w;
  const int cbase = nearest(clamp_to(x0 - pad, pl.W), pl.sw, pl.w);
  for (int x = tid; x < vcols; x += kThreads)
    ecol[x] = nearest(clamp_to(x0 + x - pad, pl.W), pl.sw, pl.w) - cbase;
  __syncthreads();
  for (int i = tid; i < pl.n_ecols * pl.se; i += kThreads) {
    const int e = i / pl.se, t = i - e * pl.se;
    et[i] = __ldg(frame + rows[t] + min(cbase + e, pl.w - 1));
  }
  __syncthreads();

  // Horizontal: lane -> (row, one of kLaneCols neighbouring blocks).
  const int row = (tid & 31) % kBand;
  const int xh = ((tid >> 5) * kLaneCols + (tid & 31) / kBand) * kBlock;
  float acc[kUnits][kBlock];
#pragma unroll
  for (int u = 0; u < kUnits; ++u)
#pragma unroll
    for (int q = 0; q < kBlock; ++q) acc[u][q] = 0.0f;

  for (int f = 0; f < pl.r; ++f) {
    // Vertical: V_f[g * 8 + q][x] for the tile's padded columns x.
    const float* wv = kvs + f * pl.kp;
    for (int u = tid; u < (kBand / kBlock) * vcols; u += kThreads) {
      const int g = u / vcols, x = u - g * vcols;
      float v[kBlock];
#pragma unroll
      for (int q = 0; q < kBlock; ++q) v[q] = 0.0f;
      conv8(v, et + ecol[x] * pl.se + g * kBlock, wv, pl.k);
#pragma unroll
      for (int q = 0; q < kBlock; ++q)
        vbuf[(g * kBlock + q) * pl.sv + x] = v[q];
    }
    __syncthreads();
    // Horizontal: this thread's row, 8 columns of each of its blocks.
    const float* wh = khs + f * pl.kp;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int x = xh + u * kWarps * kLaneCols * kBlock;
      if (x < pl.tile_w) conv8(acc[u], vbuf + row * pl.sv + x, wh, pl.k);
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int x = xh + u * kWarps * kLaneCols * kBlock;
    if (x < pl.tile_w) {
      float4* d = reinterpret_cast<float4*>(vbuf + row * pl.sv + x);
      d[0] = make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
      d[1] = make_float4(acc[u][4], acc[u][5], acc[u][6], acc[u][7]);
    }
  }
  __syncthreads();
  const int n_rows = min(kBand, pl.H - y0);
  const int n_cols = min(pl.tile_w, pl.W - x0);
  float* dst = out + (static_cast<size_t>(n) * pl.H + y0) * pl.W + x0;
  for (int i = tid; i < n_rows * n_cols; i += kThreads) {
    const int y = i / n_cols, x = i - y * n_cols;
    dst[static_cast<size_t>(y) * pl.W + x] = vbuf[y * pl.sv + x];
  }
}

}  // namespace

// (n, 1, h, w) float32 src -> (n, 1, H, W) float32 out, both dense, on the
// current device, w <= W; kv (r, 1, k, 1) and kh (1, r, 1, k) dense
// float32.  The tile plan (tile_w, n_ecols, the strides sv, se, kp) comes
// from kernels/smooth.py:launch_plan; it is checked here, and the shared
// memory is computed from it.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int rtv_saliency_smooth(const float* src, const float* kv,
                                   const float* kh, float* out, int n, int h,
                                   int w, int H, int W, int r, int k,
                                   int tile_w, int n_ecols, int sv, int se,
                                   int kp, void* stream) {
  if (n == 0 || H == 0 || W == 0) return 0;
  const int vcols = tile_w + k - 1;
  const bool ok =
      n > 0 && h > 0 && w > 0 && H > 0 && w <= W && r >= 1 &&
      r <= kMaxRank && k >= 1 && k <= kMaxTaps && k % 2 == 1 &&
      tile_w >= kBlock && tile_w <= kMaxTile && tile_w % kBlock == 0 &&
      sv >= tile_w + k && sv % 4 == 0 && se >= kBand + k &&
      se % 4 == 0 && kp >= k && kp % 4 == 0 && n_ecols >= 1 &&
      n_ecols <= vcols &&
      static_cast<int64_t>(h) * w < (int64_t{1} << 31);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kBand) * sv + static_cast<size_t>(n_ecols) * se +
       2 * static_cast<size_t>(r) * kp + se + vcols);
  const int64_t tiles_x = (W + tile_w - 1) / tile_w;
  const int64_t bands = (H + kBand - 1) / kBand;
  const int64_t ctas = n * tiles_x * bands;
  if (smem > static_cast<size_t>(kMaxSmem) || ctas > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaFuncSetAttribute(
      smooth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  Plan pl;
  pl.h = h;
  pl.w = w;
  pl.H = H;
  pl.W = W;
  pl.r = r;
  pl.k = k;
  pl.sh = static_cast<double>(h) / H;
  pl.sw = static_cast<double>(w) / W;
  pl.tile_w = tile_w;
  pl.tiles_x = static_cast<int>(tiles_x);
  pl.bands = static_cast<int>(bands);
  pl.sv = sv;
  pl.se = se;
  pl.kp = kp;
  pl.n_ecols = n_ecols;
  smooth_kernel<<<static_cast<unsigned>(ctas), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(src, kv, kh, out, pl);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

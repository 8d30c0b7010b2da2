// Butterworth low-pass filtfilt for Hopper (sm_90a): scipy's `filtfilt` of
// second-order sections, odd extension and `sosfilt_zi` initial states, over
// (B, L) padded series with live lengths n, in one launch.
//
// Replaces no TPU kernel: the JAX package runs this recurrence as an XLA
// scan (retargetvid_tpu/ops/filters.py:butter_lowpass_filter).  It takes the
// place of the port's plain version, kernels/filtfilt.py:
// butter_filtfilt_reference, whose Python loop over time issues about 15
// elementwise launches per step and section, twice: some 49,300 launches of
// a few hundred bytes for the (16, 512) series of a 480-frame clip.
//
// Result: bit-equal to that plain version (run on the card or the CPU).
// Each value is the same float32 operation in the same order:
//   ext   = 2*x0 - x[...] | x[...] | 2*xe - x[...] | 0, with the same
//           clamped indices;
//   init  s = zi * sig[0] per section;
//   step  y  = b0*x + s0;  s0' = (m00*s0 + m01*s1) + v0*x;
//         s1' = (m10*s0 + m11*s1) + v1*x   (M's 1.0 and 0.0 multiplied too)
//         on live steps; a masked step passes x through and keeps s;
//   filt  = the backward pass's output at the clamped reversed indices, the
//           padded tail included (it reads y2[0] there).
// Contraction is off by construction: __fmul_rn / __fadd_rn / __fsub_rn are
// never fused into an FMA, whatever the build flags.
//
// Bound on this card: latency.  A row is one serial recurrence of
// N = L + 2*padlen steps per pass.  The chain that carries from step to
// step is each section's state update, s0' = (m00*s0 + m01*s1) + v0*x:
// 3 dependent float32 operations per step, whatever the number of sections
// NS, since section k of step i+1 overlaps section k+1 of step i.  The
// output's path through the sections (2*NS operations) is paid once per
// pass, as the pipeline fills.  So one row takes at least
// 2 passes * (3*N + 2*NS) * 4 cycles.  Bytes (B*L*4 in, the same out) and
// operations (about 12*NS per step and row) are far below what the card
// moves.
//
// Design:
// - One thread per row; every section's state in registers: the section
//   loop is unrolled to kMaxSections and stops at the design's count, so
//   one instance serves every design and each state has a fixed register.
//   A block takes R <=
//   32 rows (kernels/filtfilt.py:launch_plan), so the rows of a warp step in
//   lockstep and each thread's chain sets the time.
// - The rows' work lives in shared memory, R rows of 2N+1 floats (an odd
//   stride, so the R threads of a step hit R banks): area A holds x, then
//   the backward output; area B holds the extension, which the forward pass
//   overwrites in place.  Where even one row does not fit, the same areas
//   live in a device scratch buffer that the wrapper allocates.
// - The 256 threads of a block load x, build the extension and write the
//   cropped, reversed output with coalesced loads and stores; only the
//   serial passes run on one thread per row, reading shared memory.
// - The design (b0, M, v, zi per section, padlen) is a kernel parameter
//   copied from the caller's host struct at launch: no upload, no sync.
// Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Keep in step with kernels/filtfilt.py (MAX_ROWS, MAX_SECTIONS).
constexpr int kMaxRows = 32;
constexpr int kMaxSections = 8;

}  // namespace

// Keep in step with kernels/filtfilt.py:Section and Design.
struct RtvSosSection {
  float b0, m00, m01, m10, m11, v0, v1, zi0, zi1;
};

struct RtvSosDesign {
  int n_sections;
  int padlen;
  RtvSosSection sec[kMaxSections];
};

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// The cascade of the design's sections, its states in registers
// (kernels/filtfilt.py:_cascade).
struct Cascade {
  float s0[kMaxSections], s1[kMaxSections];

  __device__ __forceinline__ void init(const RtvSosDesign& d, float x0) {
#pragma unroll
    for (int k = 0; k < kMaxSections; ++k) {
      if (k == d.n_sections) break;
      s0[k] = __fmul_rn(d.sec[k].zi0, x0);
      s1[k] = __fmul_rn(d.sec[k].zi1, x0);
    }
  }

  // One live step through every section; returns the last section's output.
  __device__ __forceinline__ float step(const RtvSosDesign& d, float y) {
#pragma unroll
    for (int k = 0; k < kMaxSections; ++k) {
      if (k == d.n_sections) break;
      const RtvSosSection& c = d.sec[k];
      const float xt = y;
      y = __fadd_rn(__fmul_rn(c.b0, xt), s0[k]);
      const float n0 = __fadd_rn(
          __fadd_rn(__fmul_rn(c.m00, s0[k]), __fmul_rn(c.m01, s1[k])),
          __fmul_rn(c.v0, xt));
      const float n1 = __fadd_rn(
          __fadd_rn(__fmul_rn(c.m10, s0[k]), __fmul_rn(c.m11, s1[k])),
          __fmul_rn(c.v1, xt));
      s0[k] = n0;
      s1[k] = n1;
    }
    return y;
  }
};

// Rows [blockIdx.x * rows, +rows) of x (B, L) -> out (B, L).  The rows'
// areas are in dynamic shared memory where `scratch` is null, else in
// `scratch` (B rows of 2N+1).
__global__ void __launch_bounds__(kThreads)
    butter_filtfilt_kernel(const float* __restrict__ x,
                           const int64_t* __restrict__ n,
                           float* __restrict__ out,
                           float* __restrict__ scratch, int b, int l,
                           int rows, const __grid_constant__ RtvSosDesign d) {
  extern __shared__ float smem[];
  __shared__ int live_n[kMaxRows];
  const int padlen = d.padlen;
  const int big_n = l + 2 * padlen;
  const int stride = 2 * big_n + 1;
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, b - row0);
  float* area = scratch == nullptr
                    ? smem
                    : scratch + static_cast<size_t>(row0) * stride;
  const int tid = threadIdx.x;

  // Live lengths, clamped to +-2N, beyond which every index below saturates
  // as it does for the int64 value; x into area A.
  if (tid < nrows) {
    const int64_t lim = 2 * static_cast<int64_t>(big_n);
    const int64_t v = n[row0 + tid];
    live_n[tid] = static_cast<int>(v < -lim ? -lim : (v > lim ? lim : v));
  }
  for (int e = tid; e < nrows * l; e += kThreads) {
    const int r = e / l, j = e - r * l;
    area[r * stride + j] = x[static_cast<size_t>(row0 + r) * l + j];
  }
  __syncthreads();

  // The odd extension into area B: [0, padlen) left, [padlen, padlen + n)
  // the data, [padlen + n, 2*padlen + n) right, then zeros.
  for (int e = tid; e < nrows * big_n; e += kThreads) {
    const int r = e / big_n, i = e - r * big_n;
    const float* xr = area + r * stride;
    const int nn = live_n[r];
    float v;
    if (i < padlen) {
      v = __fsub_rn(__fmul_rn(2.0f, xr[0]), xr[clampi(padlen - i, 0, l - 1)]);
    } else if (i < padlen + nn) {
      v = xr[clampi(i - padlen, 0, l - 1)];
    } else if (i < 2 * padlen + nn) {
      const int jr = i - padlen - nn;
      v = __fsub_rn(__fmul_rn(2.0f, xr[clampi(nn - 1, 0, l - 1)]),
                    xr[clampi(nn - 2 - jr, 0, l - 1)]);
    } else {
      v = 0.0f;
    }
    area[r * stride + big_n + i] = v;
  }
  __syncthreads();

  // The two passes, one thread per row.  Steps i < 2*padlen + n are live;
  // later ones pass their input through.
  if (tid < nrows) {
    float* ya = area + tid * stride;          // area A: backward output
    float* yb = ya + big_n;                   // area B: ext -> forward output
    const int m = 2 * padlen + live_n[tid];
    const int live = clampi(m, 0, big_n);
    Cascade c;
    c.init(d, yb[0]);
    for (int i = 0; i < live; ++i) yb[i] = c.step(d, yb[i]);
    // Backward over the forward output reversed into the front:
    // input i is yb[clamp(m - 1 - i, 0, N - 1)].
    c.init(d, yb[clampi(m - 1, 0, big_n - 1)]);
    for (int i = 0; i < live; ++i)
      ya[i] = c.step(d, yb[clampi(m - 1 - i, 0, big_n - 1)]);
    for (int i = live; i < big_n; ++i)
      ya[i] = yb[clampi(m - 1 - i, 0, big_n - 1)];
  }
  __syncthreads();

  // Reversed back and cropped: out[j] = y2[clamp(padlen + n - 1 - j, 0, N-1)].
  for (int e = tid; e < nrows * l; e += kThreads) {
    const int r = e / l, j = e - r * l;
    out[static_cast<size_t>(row0 + r) * l + j] =
        area[r * stride + clampi(padlen + live_n[r] - 1 - j, 0, big_n - 1)];
  }
}

}  // namespace

// x (B, L) float32 and n (B,) int64 in, out (B, L) float32, all contiguous on
// the current device.  `rows` rows per block (1..32; kernels/filtfilt.py:
// launch_plan); `scratch` null for shared memory, else B * (2N+1) floats of
// device memory, N = L + 2*padlen.  The design is read from host memory and
// passed by value.  Returns the cudaError_t of the launch (0 on success).
extern "C" int rtv_butter_filtfilt(const float* x, const int64_t* n,
                                   float* out, float* scratch, int b, int l,
                                   int rows, const RtvSosDesign* design,
                                   void* stream) {
  if (b <= 0 || l <= 0) return 0;
  const RtvSosDesign d = *design;
  if (rows < 1 || rows > kMaxRows || d.padlen < 0 || d.n_sections < 1 ||
      d.n_sections > kMaxSections)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = scratch != nullptr
                          ? 0
                          : static_cast<size_t>(rows) *
                                (2 * (l + 2 * d.padlen) + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        butter_filtfilt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  butter_filtfilt_kernel<<<(b + rows - 1) / rows, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      x, n, out, scratch, b, l, rows, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

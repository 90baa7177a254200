// filtered_lrelu forward for Hopper (sm_90a) on f32 maps: zero-stuff upsample
// + up-FIR, gain * leaky ReLU, clamp, down-FIR + decimate, on maps whose bias
// is already added. Plain C interface, loaded with ctypes by
// ops/filtered_lrelu_cuda.py. bf16 maps go to filtered_lrelu_tc.cu.
//
// Replaces: long_video_gan_tpu/ops/pallas/filtered_lrelu_packed.py
// `_packed_fwd` (the lane-packed Pallas kernel on the TPU). Same function:
// per plane X [H, W],  out = Ad . act(Au . X . Bu^T) . Bd^T  with the banded
// operators of ops/upfirdn2d.py `_axis_matrix` in the JAX package:
//   up pass, per axis:   u[r] = sum_k fu[fu_taps-1-k] * up * z[r + k - pad0],
//                        z[i*up] = x[i], zero elsewhere and out of range;
//   activation:          a = clamp(gain * lrelu(u, slope), -clamp, clamp);
//   down pass, per axis: o[r] = sum_k fd[fd_taps-1-k] * a[r*down + k].
// The wrapper passes the taps already flipped, and fu already times `up`.
//
// What bounds it: device-memory bytes. The composed path writes the
// up^2-times-larger supersampled buffer to device memory and reads it back
// between its passes; here it never leaves shared memory, so a block reads
// its input patch once and writes its output tile once. Arithmetic is a few
// dozen FMAs per supersampled value.
//
// Design (simple and right first): one block per 32x32 output tile of one
// plane; planes and tiles both on gridDim.x (16 frames x 512 channels x tiles
// passes 65,535). Four separable passes through shared memory, all in f32:
// input patch -> up pass along x -> up pass along y + activation -> down pass
// along x -> down pass along y -> global. The up passes visit only the taps
// that meet a nonzero of the zero-stuffed signal (polyphase). No tensor cores,
// TMA or tuning yet; the TPU kernel's lane packing and block-diagonal
// operators were TPU layout devices and have no counterpart here.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;      // output tile edge
constexpr int kThreads = 256;  // threads per block

struct Geometry {
  int in_h, in_w, out_h, out_w;
  int up, down, px0, py0;
  int fu_taps, fd_taps;
  int tiles_x, tiles_per_plane;
  int u_size;  // supersampled window edge: (kTile - 1) * down + fd_taps
  int i_size;  // input patch edge: (u_size + fu_taps - 2) / up + 1
  float gain, slope, clamp;
};

__host__ __device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return -floor_div(-a, b); }

// Floats of the [i_size][u_size] buffer, which the down pass along x reuses
// as [u_size][kTile].
__host__ __device__ __forceinline__ int t_floats(const Geometry& g) {
  const int t = g.i_size * g.u_size, d = g.u_size * kTile;
  return t > d ? t : d;
}

__host__ __device__ __forceinline__ int smem_floats(const Geometry& g) {
  return g.fu_taps + g.fd_taps + g.i_size * g.i_size + t_floats(g) + g.u_size * g.u_size;
}

__global__ void __launch_bounds__(kThreads)
filtered_lrelu_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                          const float* __restrict__ taps, Geometry g) {
  extern __shared__ float smem[];
  const int U = g.u_size, I = g.i_size;
  float* s_fu = smem;
  float* s_fd = s_fu + g.fu_taps;
  float* s_x = s_fd + g.fd_taps;  // [I][I] input patch
  float* s_t = s_x + I * I;       // [I][U] after the up pass along x
  float* s_a = s_t + t_floats(g); // [U][U] supersampled and activated

  const int plane = blockIdx.x / g.tiles_per_plane;
  const int tile = blockIdx.x - plane * g.tiles_per_plane;
  const int oy0 = (tile / g.tiles_x) * kTile;
  const int ox0 = (tile % g.tiles_x) * kTile;
  // Index into the zero-stuffed signal of tap 0 at the window's first
  // supersampled row/column, and the first input row/column it reaches.
  const int jy0 = oy0 * g.down - g.py0;
  const int jx0 = ox0 * g.down - g.px0;
  const int iy0 = ceil_div(jy0, g.up);
  const int ix0 = ceil_div(jx0, g.up);

  for (int k = threadIdx.x; k < g.fu_taps + g.fd_taps; k += blockDim.x) s_fu[k] = taps[k];

  // 1. Input patch, zero outside the image.
  const float* xp = x + (size_t)plane * g.in_h * g.in_w;
  for (int idx = threadIdx.x; idx < I * I; idx += blockDim.x) {
    const int r = idx / I, c = idx - r * I;
    const int gy = iy0 + r, gx = ix0 + c;
    float v = 0.f;
    if (gy >= 0 && gy < g.in_h && gx >= 0 && gx < g.in_w) v = xp[(size_t)gy * g.in_w + gx];
    s_x[idx] = v;
  }
  __syncthreads();

  // 2. Up pass along x. Tap k meets a nonzero of the zero-stuffed row only
  //    where (j + k) % up == 0; k0 is the first such tap.
  for (int idx = threadIdx.x; idx < I * U; idx += blockDim.x) {
    const int r = idx / U, c = idx - r * U;
    const int j = jx0 + c;
    const float* row = s_x + r * I;
    float acc = 0.f;
    for (int k = ceil_div(j, g.up) * g.up - j; k < g.fu_taps; k += g.up)
      acc += s_fu[k] * row[(j + k) / g.up - ix0];
    s_t[idx] = acc;
  }
  __syncthreads();

  // 3. Up pass along y, then gain * lrelu and clamp (comparisons keep NaN).
  for (int idx = threadIdx.x; idx < U * U; idx += blockDim.x) {
    const int r = idx / U, c = idx - r * U;
    const int j = jy0 + r;
    const float* col = s_t + c;
    float acc = 0.f;
    for (int k = ceil_div(j, g.up) * g.up - j; k < g.fu_taps; k += g.up)
      acc += s_fu[k] * col[((j + k) / g.up - iy0) * U];
    float v = (acc < 0.f ? acc * g.slope : acc) * g.gain;
    v = v > g.clamp ? g.clamp : (v < -g.clamp ? -g.clamp : v);
    s_a[idx] = v;
  }
  __syncthreads();

  // 4. Down pass along x into s_t, now [U][kTile].
  for (int idx = threadIdx.x; idx < U * kTile; idx += blockDim.x) {
    const int r = idx / kTile, c = idx - r * kTile;
    const float* row = s_a + r * U + c * g.down;
    float acc = 0.f;
    for (int k = 0; k < g.fd_taps; ++k) acc += s_fd[k] * row[k];
    s_t[idx] = acc;
  }
  __syncthreads();

  // 5. Down pass along y, store the tile's in-range outputs.
  float* yp = y + (size_t)plane * g.out_h * g.out_w;
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += blockDim.x) {
    const int r = idx / kTile, c = idx - r * kTile;
    const int oy = oy0 + r, ox = ox0 + c;
    if (oy >= g.out_h || ox >= g.out_w) continue;
    const float* col = s_t + r * g.down * kTile + c;
    float acc = 0.f;
    for (int k = 0; k < g.fd_taps; ++k) acc += s_fd[k] * col[k * kTile];
    yp[(size_t)oy * g.out_w + ox] = acc;
  }
}

cudaError_t launch(const void* x, void* y, int planes, int in_h, int in_w, int out_h, int out_w,
                   int up, int down, int px0, int px1, int py0, int py1,
                   const float* taps, int fu_taps, int fd_taps,
                   float gain, float slope, float clamp, cudaStream_t stream) {
  if (planes < 1 || in_h < 1 || in_w < 1 || up < 1 || down < 1 || fu_taps < 1 || fd_taps < 1)
    return cudaErrorInvalidValue;
  // Output size contract of ops/filtered_lrelu.py `output_size`.
  const int hu = in_h * up + py0 + py1 - fu_taps + 1;
  const int wu = in_w * up + px0 + px1 - fu_taps + 1;
  if (hu < fd_taps || wu < fd_taps || out_h != (hu - fd_taps) / down + 1 ||
      out_w != (wu - fd_taps) / down + 1)
    return cudaErrorInvalidValue;

  Geometry g;
  g.in_h = in_h; g.in_w = in_w; g.out_h = out_h; g.out_w = out_w;
  g.up = up; g.down = down; g.px0 = px0; g.py0 = py0;
  g.fu_taps = fu_taps; g.fd_taps = fd_taps;
  g.tiles_x = (out_w + kTile - 1) / kTile;
  g.tiles_per_plane = g.tiles_x * ((out_h + kTile - 1) / kTile);
  g.u_size = (kTile - 1) * down + fd_taps;
  g.i_size = (g.u_size + fu_taps - 2) / up + 1;
  g.gain = gain; g.slope = slope; g.clamp = clamp;

  const long long blocks = (long long)planes * g.tiles_per_plane;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)smem_floats(g) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        filtered_lrelu_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  filtered_lrelu_fwd_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y), taps, g);
  return cudaGetLastError();
}

}  // namespace

// x, y: [planes, in_h, in_w] / [planes, out_h, out_w], contiguous, same type.
// taps: device f32 [fu_taps + fd_taps]: fu flipped and times `up`, then fd
// flipped. clamp: +inf for none. Returns a cudaError_t (0 on success).
#define LVG_FLRELU_ARGS                                                                   \
  const void *x, void *y, int planes, int in_h, int in_w, int out_h, int out_w, int up,   \
      int down, int px0, int px1, int py0, int py1, const float *taps, int fu_taps,       \
      int fd_taps, float gain, float slope, float clamp, void *stream
#define LVG_FLRELU_PASS                                                                   \
  x, y, planes, in_h, in_w, out_h, out_w, up, down, px0, px1, py0, py1, taps, fu_taps,    \
      fd_taps, gain, slope, clamp, static_cast<cudaStream_t>(stream)

extern "C" int lvg_filtered_lrelu_fwd_f32(LVG_FLRELU_ARGS) {
  return static_cast<int>(launch(LVG_FLRELU_PASS));
}

extern "C" const char* lvg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

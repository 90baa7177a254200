// filtered_lrelu backward for Hopper (sm_90a) on f32 maps: the gradient with
// respect to the bias-added input x of filtered_lrelu_fwd.cu's function, with
// the supersampled U recomputed on chip. Plain C interface, loaded with ctypes
// by ops/filtered_lrelu_cuda.py. bf16 maps go to filtered_lrelu_tc.cu.
//
// Replaces: long_video_gan_tpu/ops/pallas/filtered_lrelu_packed.py
// `_packed_bwd` (the lane-packed Pallas backward kernel on the TPU, reached
// through the `_packed_op` custom VJP). Same function, per plane:
//   dX = Au^T . ( act'(U) * (Ad^T . dY . Bd) ) . Bu,   U = Au . X . Bu^T,
// with the operators of filtered_lrelu_fwd.cu, per axis:
//   up pass:      u[r] = sum_k fu[k] * z[r + k - pad0],  z[i*up] = x[i];
//   down pass:    o[r] = sum_k fd[k] * a[r*down + k];
// so the transposed passes are
//   down^T:       da[s] = sum_k fd[k] * dy[(s - k) / down]   ((s - k) % down == 0);
//   act':         g = da * (u >= 0 ? gain : gain * slope), zero where
//                 gain * lrelu(u) is not strictly inside (-clamp, clamp)
//                 (`_act_grad_factory`, ops/pallas/filtered_lrelu_fused.py);
//   up^T:         dx[i] = sum_k fu[k] * g[i*up + pad0 - k].
// fu and fd arrive flipped, fu times `up`, as for the forward kernel.
//
// What bounds it: device-memory bytes in principle (read x and dy, write dx
// once); the supersampled U, dA and G never leave shared memory, as the TPU
// kernel keeps them out of HBM. At these tile sizes the halo recompute and
// the f32 shared-memory passes cost more than the bytes.
//
// Design (simple and right first): one block per T x T tile of dx of one
// plane; planes and tiles on gridDim.x. The block recomputes U over the
// (T-1)*up + fu_taps window of supersampled rows/columns that its dx tile
// reads, turns it into act'(U), multiplies by the transposed down pass of the
// dy patch, and reduces with the transposed up pass, all in f32 in shared
// memory; the output rounds once. T is 32, halved until the buffers fit in
// 96 KB (up 4 with 24 taps: T = 16, 57 KB; up 2: T = 32, 50 KB). No tensor
// cores or TMA yet; the TPU kernel's lane packing and block-diagonal
// operators were TPU layout devices and have no counterpart here.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 32;
constexpr int kMinTile = 8;
constexpr size_t kSmemBudget = 96 * 1024;

struct Geometry {
  int in_h, in_w, out_h, out_w;  // x and dx [in_h, in_w]; dy [out_h, out_w]
  int up, down, px0, py0;
  int fu_taps, fd_taps;
  int tile;                      // dx tile edge T
  int tiles_x, tiles_per_plane;
  int g_size;  // supersampled window edge: (T - 1) * up + fu_taps
  int i_size;  // x patch edge: (g_size + fu_taps - 2) / up + 1
  int d_size;  // dy patch edge: (g_size + fd_taps - 2) / down + 1
  float gain, slope, clamp;
  int has_clamp;
};

__host__ __device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return -floor_div(-a, b); }

// Floats of the scratch buffer, used in turn as [G][I] (up pass along y),
// [D][G] (down^T pass along x) and [G][T] (up^T pass along x).
__host__ __device__ __forceinline__ int t_floats(const Geometry& g) {
  int t = g.i_size * g.g_size;
  const int d = g.d_size * g.g_size, e = g.g_size * g.tile;
  if (d > t) t = d;
  if (e > t) t = e;
  return t;
}

__host__ __device__ __forceinline__ int smem_floats(const Geometry& g) {
  return g.fu_taps + g.fd_taps + g.i_size * g.i_size + g.d_size * g.d_size + t_floats(g) +
         g.g_size * g.g_size;
}

__global__ void __launch_bounds__(kThreads)
filtered_lrelu_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                          float* __restrict__ dx, const float* __restrict__ taps, Geometry g) {
  extern __shared__ float smem[];
  const int G = g.g_size, I = g.i_size, D = g.d_size, TT = g.tile;
  float* s_fu = smem;
  float* s_fd = s_fu + g.fu_taps;
  float* s_x = s_fd + g.fd_taps;  // [I][I] x patch
  float* s_dy = s_x + I * I;      // [D][D] dy patch
  float* s_t = s_dy + D * D;      // scratch, see t_floats
  float* s_g = s_t + t_floats(g); // [G][G] act'(U), then G

  const int plane = blockIdx.x / g.tiles_per_plane;
  const int tile = blockIdx.x - plane * g.tiles_per_plane;
  const int iy0 = (tile / g.tiles_x) * TT;
  const int ix0 = (tile % g.tiles_x) * TT;
  // First supersampled row/column of the window the dx tile reads.
  const int r0 = iy0 * g.up + g.py0 - (g.fu_taps - 1);
  const int c0 = ix0 * g.up + g.px0 - (g.fu_taps - 1);
  // Zero-stuffed index of up-tap 0 at the window's first row/column, and the
  // first x row/column it reaches.
  const int jy0 = r0 - g.py0;
  const int jx0 = c0 - g.px0;
  const int ys0 = ceil_div(jy0, g.up);
  const int xs0 = ceil_div(jx0, g.up);
  // First dy row/column that reaches the window through the down pass.
  const int oy0 = ceil_div(r0 - (g.fd_taps - 1), g.down);
  const int ox0 = ceil_div(c0 - (g.fd_taps - 1), g.down);

  for (int k = threadIdx.x; k < g.fu_taps + g.fd_taps; k += blockDim.x) s_fu[k] = taps[k];

  // 1. x and dy patches, zero outside the maps.
  const float* xp = x + (size_t)plane * g.in_h * g.in_w;
  for (int idx = threadIdx.x; idx < I * I; idx += blockDim.x) {
    const int r = idx / I, c = idx - r * I;
    const int gy = ys0 + r, gx = xs0 + c;
    float v = 0.f;
    if (gy >= 0 && gy < g.in_h && gx >= 0 && gx < g.in_w) v = xp[(size_t)gy * g.in_w + gx];
    s_x[idx] = v;
  }
  const float* dyp = dy + (size_t)plane * g.out_h * g.out_w;
  for (int idx = threadIdx.x; idx < D * D; idx += blockDim.x) {
    const int r = idx / D, c = idx - r * D;
    const int gy = oy0 + r, gx = ox0 + c;
    float v = 0.f;
    if (gy >= 0 && gy < g.out_h && gx >= 0 && gx < g.out_w)
      v = dyp[(size_t)gy * g.out_w + gx];
    s_dy[idx] = v;
  }
  __syncthreads();

  // 2. Up pass along y into s_t [G][I], first, as the products Au . X . Bu^T
  //    of the plain version and the TPU kernel (act' jumps at U = 0, so U
  //    must round as theirs does); only the taps that meet a nonzero of the
  //    zero-stuffed column ((j + k) % up == 0).
  for (int idx = threadIdx.x; idx < G * I; idx += blockDim.x) {
    const int r = idx / I, c = idx - r * I;
    const int j = jy0 + r;
    const float* col = s_x + c;
    float acc = 0.f;
    for (int k = ceil_div(j, g.up) * g.up - j; k < g.fu_taps; k += g.up)
      acc += s_fu[k] * col[((j + k) / g.up - ys0) * I];
    s_t[idx] = acc;
  }
  __syncthreads();

  // 3. Up pass along x gives U; keep act'(U) in s_g [G][G].
  for (int idx = threadIdx.x; idx < G * G; idx += blockDim.x) {
    const int r = idx / G, c = idx - r * G;
    const int j = jx0 + c;
    const float* row = s_t + r * I;
    float u = 0.f;
    for (int k = ceil_div(j, g.up) * g.up - j; k < g.fu_taps; k += g.up)
      u += s_fu[k] * row[(j + k) / g.up - xs0];
    float d = u >= 0.f ? g.gain : g.gain * g.slope;
    if (g.has_clamp) {
      const float z = (u >= 0.f ? u : u * g.slope) * g.gain;
      if (!(z > -g.clamp && z < g.clamp)) d = 0.f;
    }
    s_g[idx] = d;
  }
  __syncthreads();

  // 4. Transposed down pass along x: zero-stuff the dy rows by `down` and
  //    correlate with fd, into s_t [D][G]. Tap k meets a dy sample only where
  //    (s - k) % down == 0; k0 is the first such tap.
  for (int idx = threadIdx.x; idx < D * G; idx += blockDim.x) {
    const int r = idx / G, c = idx - r * G;
    const int s = c0 + c;
    const float* row = s_dy + r * D;
    float acc = 0.f;
    for (int k = s - floor_div(s, g.down) * g.down; k < g.fd_taps; k += g.down)
      acc += s_fd[k] * row[floor_div(s - k, g.down) - ox0];
    s_t[idx] = acc;
  }
  __syncthreads();

  // 5. Transposed down pass along y gives dA; G = act'(U) * dA in place.
  for (int idx = threadIdx.x; idx < G * G; idx += blockDim.x) {
    const int r = idx / G, c = idx - r * G;
    const int s = r0 + r;
    const float* col = s_t + c;
    float acc = 0.f;
    for (int k = s - floor_div(s, g.down) * g.down; k < g.fd_taps; k += g.down)
      acc += s_fd[k] * col[(floor_div(s - k, g.down) - oy0) * G];
    s_g[idx] *= acc;
  }
  __syncthreads();

  // 6. Transposed up pass along x, keeping every up-th column: s_t [G][T].
  for (int idx = threadIdx.x; idx < G * TT; idx += blockDim.x) {
    const int r = idx / TT, c = idx - r * TT;
    const float* row = s_g + r * G + c * g.up + g.fu_taps - 1;
    float acc = 0.f;
    for (int k = 0; k < g.fu_taps; ++k) acc += s_fu[k] * row[-k];
    s_t[idx] = acc;
  }
  __syncthreads();

  // 7. Transposed up pass along y, store the tile's in-range dx.
  float* dxp = dx + (size_t)plane * g.in_h * g.in_w;
  for (int idx = threadIdx.x; idx < TT * TT; idx += blockDim.x) {
    const int r = idx / TT, c = idx - r * TT;
    const int iy = iy0 + r, ix = ix0 + c;
    if (iy >= g.in_h || ix >= g.in_w) continue;
    const float* col = s_t + (r * g.up + g.fu_taps - 1) * TT + c;
    float acc = 0.f;
    for (int k = 0; k < g.fu_taps; ++k) acc += s_fu[k] * col[-k * TT];
    dxp[(size_t)iy * g.in_w + ix] = acc;
  }
}

void set_tile(Geometry& g, int tile) {
  g.tile = tile;
  g.g_size = (tile - 1) * g.up + g.fu_taps;
  g.i_size = (g.g_size + g.fu_taps - 2) / g.up + 1;
  g.d_size = (g.g_size + g.fd_taps - 2) / g.down + 1;
  g.tiles_x = (g.in_w + tile - 1) / tile;
  g.tiles_per_plane = g.tiles_x * ((g.in_h + tile - 1) / tile);
}

cudaError_t launch(const void* x, const void* dy, void* dx, int planes, int in_h, int in_w,
                   int out_h, int out_w, int up, int down, int px0, int px1, int py0, int py1,
                   const float* taps, int fu_taps, int fd_taps, float gain, float slope,
                   float clamp, int has_clamp, cudaStream_t stream) {
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
  g.gain = gain; g.slope = slope; g.clamp = clamp; g.has_clamp = has_clamp;
  int tile = kMaxTile;
  set_tile(g, tile);
  while (tile > kMinTile && (size_t)smem_floats(g) * sizeof(float) > kSmemBudget) {
    tile /= 2;
    set_tile(g, tile);
  }

  const long long blocks = (long long)planes * g.tiles_per_plane;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)smem_floats(g) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        filtered_lrelu_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  filtered_lrelu_bwd_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(dx), taps,
      g);
  return cudaGetLastError();
}

}  // namespace

// x, dx: [planes, in_h, in_w]; dy: [planes, out_h, out_w]; contiguous, same
// type. taps: device f32 [fu_taps + fd_taps] as for the forward kernel.
// has_clamp = 0 for no clamp. Returns a cudaError_t (0 on success).
#define LVG_FLRELU_BWD_ARGS                                                               \
  const void *x, const void *dy, void *dx, int planes, int in_h, int in_w, int out_h,     \
      int out_w, int up, int down, int px0, int px1, int py0, int py1, const float *taps, \
      int fu_taps, int fd_taps, float gain, float slope, float clamp, int has_clamp,      \
      void *stream
#define LVG_FLRELU_BWD_PASS                                                               \
  x, dy, dx, planes, in_h, in_w, out_h, out_w, up, down, px0, px1, py0, py1, taps,        \
      fu_taps, fd_taps, gain, slope, clamp, has_clamp, static_cast<cudaStream_t>(stream)

extern "C" int lvg_filtered_lrelu_bwd_f32(LVG_FLRELU_BWD_ARGS) {
  return static_cast<int>(launch(LVG_FLRELU_BWD_PASS));
}

extern "C" const char* lvg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

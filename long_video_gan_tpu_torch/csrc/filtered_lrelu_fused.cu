// filtered_lrelu as four banded operator products, forward (K3a) and its
// gradient (K3b), and the f32-exact forward (K4), for Hopper (sm_90a), on maps
// whose bias is already added. Plain C interface, loaded with ctypes by
// ops/filtered_lrelu_fused.py (K3a, K3b) and ops/filtered_lrelu_exact.py (K4).
//
// Replaces: long_video_gan_tpu/ops/pallas/filtered_lrelu_fused.py
// `_fused_fwd` and `_fused_bwd` (the whole-image Pallas kernels on the TPU,
// joined by the `_fused_op` custom VJP), and
// long_video_gan_tpu/ops/pallas/filtered_lrelu_kernel.py
// `_filtered_lrelu_pallas` (the first Pallas kernel, reached through
// `filtered_lrelu(impl="pallas")`). Same functions, per plane X [H, W]:
//   forward:   t1 = Au . X;  U = t1 . Bu^T;  Z = act(U);  t3 = Z . Bd^T;
//              out = Ad . t3
//   backward:  t1 = Au . X;  U = t1 . Bu^T;  s1 = Ad^T . dY;  dZ = s1 . Bd;
//              dU = act'(U) * dZ;  dt1 = dU . Bu;  dX = Au^T . dt1
// with the banded operators of ops/upfirdn2d.py `_axis_matrix`: the up and
// down passes of filtered_lrelu_common.cuh, per axis. What sets K3 apart from
// filtered_lrelu_fwd.cu and _bwd.cu is the order of the products and the
// rounding between them: for bf16 maps the taps come rounded to bf16 (the TPU
// kernel holds its operators in the input's type), and t1, Z and t3 (forward)
// and t1, s1, dU and dt1 (backward) round to bf16, where the TPU kernel stores
// them in bf16; every sum is taken in f32. For f32 maps nothing rounds. K4 is
// the same forward with nothing rounded inside whatever the maps' type: f32
// taps, every stage in f32 (the TPU kernel's `Precision.HIGHEST`), no TF32,
// the output in the maps' type; it has no gradient.
//
// What bounds it: device-memory bytes in principle (read X, and dY; write
// the output once). The supersampled U never leaves shared memory, as the TPU
// kernel keeps it in VMEM. The TPU kernel keeps a whole image in VMEM; the U
// of the 166x278 layers is ~760 KB per plane in f32, over a block's 227 KB, so
// here a block takes one output tile and carries the band windows of its
// stages through shared memory. Only the band is contracted: every product
// visits the taps of the filter, not the zeros of the dense operator (~95% of
// it), and the up passes only the taps that meet a nonzero of the
// zero-stuffed signal.
//
// Design (simple and right first): one block per T x T output tile of one
// plane (forward: T = 32; backward: T = 32, halved until the buffers fit in
// 96 KB), planes and tiles on gridDim.x. Each stage is one pass over shared
// memory in f32 FMAs. No tensor cores or TMA yet.

#include "filtered_lrelu_common.cuh"

namespace {

using namespace lvg;

constexpr int kFwdTile = 32;
constexpr int kMaxTile = 32;
constexpr int kMinTile = 8;
constexpr size_t kSmemBudget = 96 * 1024;

struct Geometry {
  int in_h, in_w, out_h, out_w;
  int up, down, px0, py0;
  int fu_taps, fd_taps;
  int tile;                // output tile edge (forward) or dX tile edge (backward)
  int tiles_x, tiles_per_plane;
  int u_size;              // supersampled window edge
  int i_size;              // X patch edge
  int d_size;              // dY patch edge (backward)
  float gain, slope, clamp;
  int has_clamp;
};

// A stage's store in type S: rounds to bf16 where S is bf16.
template <typename S> __device__ __forceinline__ float stage(float v) {
  return to_f32(from_f32<S>(v));
}

// Forward buffers: taps, X patch [I][I], t1 [U][I] reused as t3 [U][T], Z [U][U].
__host__ __device__ __forceinline__ int fwd_t_floats(const Geometry& g) {
  return imax(g.u_size * g.i_size, g.u_size * g.tile);
}

__host__ __device__ __forceinline__ int fwd_smem_floats(const Geometry& g) {
  return g.fu_taps + g.fd_taps + g.i_size * g.i_size + fwd_t_floats(g) + g.u_size * g.u_size;
}

// Backward buffers: taps, X patch [I][I], dY patch [D][D], scratch used as
// t1 [U][I], s1 [U][D] and dt1 [U][T], act'(U) then dU [U][U].
__host__ __device__ __forceinline__ int bwd_t_floats(const Geometry& g) {
  return imax(imax(g.u_size * g.i_size, g.u_size * g.d_size), g.u_size * g.tile);
}

__host__ __device__ __forceinline__ int bwd_smem_floats(const Geometry& g) {
  return g.fu_taps + g.fd_taps + g.i_size * g.i_size + g.d_size * g.d_size + bwd_t_floats(g) +
         g.u_size * g.u_size;
}

// Maps of type T, stages stored in type S: S = T for K3a, float for K4.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
fused_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ taps,
                 Geometry g) {
  extern __shared__ float smem[];
  const int U = g.u_size, I = g.i_size, TT = g.tile;
  float* s_fu = smem;
  float* s_fd = s_fu + g.fu_taps;
  float* s_x = s_fd + g.fd_taps;      // [I][I] X patch
  float* s_t = s_x + I * I;           // t1 [U][I], then t3 [U][T]
  float* s_z = s_t + fwd_t_floats(g); // Z [U][U]

  const int plane = blockIdx.x / g.tiles_per_plane;
  const int tile = blockIdx.x - plane * g.tiles_per_plane;
  const int oy0 = (tile / g.tiles_x) * TT;
  const int ox0 = (tile % g.tiles_x) * TT;
  // Zero-stuffed index of up-tap 0 at the window's first supersampled
  // row/column, and the first X row/column it reaches.
  const int jy0 = oy0 * g.down - g.py0;
  const int jx0 = ox0 * g.down - g.px0;
  const int iy0 = ceil_div(jy0, g.up);
  const int ix0 = ceil_div(jx0, g.up);

  for (int k = threadIdx.x; k < g.fu_taps + g.fd_taps; k += blockDim.x) s_fu[k] = taps[k];
  load_patch(s_x, x + (size_t)plane * g.in_h * g.in_w, iy0, ix0, I, I, g.in_h, g.in_w);
  __syncthreads();

  // 1. t1 = Au . X along y (taps that meet a nonzero of the zero-stuffed
  //    column only), stored in type S.
  for (int idx = threadIdx.x; idx < U * I; idx += blockDim.x) {
    const int r = idx / I, c = idx - r * I;
    const int j = jy0 + r;
    float acc = 0.f;
    for (int k = ceil_div(j, g.up) * g.up - j; k < g.fu_taps; k += g.up)
      acc += s_fu[k] * s_x[((j + k) / g.up - iy0) * I + c];
    s_t[idx] = stage<S>(acc);
  }
  __syncthreads();

  // 2. U = t1 . Bu^T along x, Z = act(U) (comparisons keep NaN), stored in
  //    type S.
  for (int idx = threadIdx.x; idx < U * U; idx += blockDim.x) {
    const int r = idx / U, c = idx - r * U;
    const int j = jx0 + c;
    const float* row = s_t + r * I;
    float u = 0.f;
    for (int k = ceil_div(j, g.up) * g.up - j; k < g.fu_taps; k += g.up)
      u += s_fu[k] * row[(j + k) / g.up - ix0];
    float v = (u < 0.f ? u * g.slope : u) * g.gain;
    v = v > g.clamp ? g.clamp : (v < -g.clamp ? -g.clamp : v);
    s_z[idx] = stage<S>(v);
  }
  __syncthreads();

  // 3. t3 = Z . Bd^T along x into s_t [U][T], stored in type S.
  for (int idx = threadIdx.x; idx < U * TT; idx += blockDim.x) {
    const int r = idx / TT, c = idx - r * TT;
    const float* row = s_z + r * U + c * g.down;
    float acc = 0.f;
    for (int k = 0; k < g.fd_taps; ++k) acc += s_fd[k] * row[k];
    s_t[idx] = stage<S>(acc);
  }
  __syncthreads();

  // 4. out = Ad . t3 along y; store the tile's in-range outputs.
  T* yp = y + (size_t)plane * g.out_h * g.out_w;
  for (int idx = threadIdx.x; idx < TT * TT; idx += blockDim.x) {
    const int r = idx / TT, c = idx - r * TT;
    const int oy = oy0 + r, ox = ox0 + c;
    if (oy >= g.out_h || ox >= g.out_w) continue;
    const float* col = s_t + r * g.down * TT + c;
    float acc = 0.f;
    for (int k = 0; k < g.fd_taps; ++k) acc += s_fd[k] * col[k * TT];
    yp[(size_t)oy * g.out_w + ox] = from_f32<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                 const float* __restrict__ taps, Geometry g) {
  extern __shared__ float smem[];
  const int U = g.u_size, I = g.i_size, D = g.d_size, TT = g.tile;
  float* s_fu = smem;
  float* s_fd = s_fu + g.fu_taps;
  float* s_x = s_fd + g.fd_taps;      // [I][I] X patch
  float* s_dy = s_x + I * I;          // [D][D] dY patch
  float* s_t = s_dy + D * D;          // t1 [U][I], s1 [U][D], dt1 [U][T]
  float* s_g = s_t + bwd_t_floats(g); // act'(U), then dU [U][U]

  const int plane = blockIdx.x / g.tiles_per_plane;
  const int tile = blockIdx.x - plane * g.tiles_per_plane;
  const int iy0 = (tile / g.tiles_x) * TT;
  const int ix0 = (tile % g.tiles_x) * TT;
  // First supersampled row/column of the window the dX tile reads.
  const int r0 = iy0 * g.up + g.py0 - (g.fu_taps - 1);
  const int c0 = ix0 * g.up + g.px0 - (g.fu_taps - 1);
  // Zero-stuffed index of up-tap 0 at the window's first row/column, and the
  // first X row/column it reaches.
  const int jy0 = r0 - g.py0;
  const int jx0 = c0 - g.px0;
  const int ys0 = ceil_div(jy0, g.up);
  const int xs0 = ceil_div(jx0, g.up);
  // First dY row/column that reaches the window through the down pass.
  const int oy0 = ceil_div(r0 - (g.fd_taps - 1), g.down);
  const int ox0 = ceil_div(c0 - (g.fd_taps - 1), g.down);

  for (int k = threadIdx.x; k < g.fu_taps + g.fd_taps; k += blockDim.x) s_fu[k] = taps[k];
  load_patch(s_x, x + (size_t)plane * g.in_h * g.in_w, ys0, xs0, I, I, g.in_h, g.in_w);
  load_patch(s_dy, dy + (size_t)plane * g.out_h * g.out_w, oy0, ox0, D, D, g.out_h, g.out_w);
  __syncthreads();

  // 1. t1 = Au . X along y into s_t [U][I], stored in the maps' type.
  for (int idx = threadIdx.x; idx < U * I; idx += blockDim.x) {
    const int r = idx / I, c = idx - r * I;
    const int j = jy0 + r;
    float acc = 0.f;
    for (int k = ceil_div(j, g.up) * g.up - j; k < g.fu_taps; k += g.up)
      acc += s_fu[k] * s_x[((j + k) / g.up - ys0) * I + c];
    s_t[idx] = stage<T>(acc);
  }
  __syncthreads();

  // 2. U = t1 . Bu^T along x (f32); keep act'(U) in s_g [U][U]. A clamp, when
  //    given, zeroes it where gain * lrelu(U) is not strictly inside
  //    (-clamp, clamp) (`_act_grad_factory` of the TPU kernel).
  for (int idx = threadIdx.x; idx < U * U; idx += blockDim.x) {
    const int r = idx / U, c = idx - r * U;
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

  // 3. s1 = Ad^T . dY along y into s_t [U][D], stored in the maps' type. Tap
  //    k meets a dY row only where (s - k) % down == 0.
  for (int idx = threadIdx.x; idx < U * D; idx += blockDim.x) {
    const int r = idx / D, c = idx - r * D;
    const int s = r0 + r;
    float acc = 0.f;
    for (int k = s - floor_div(s, g.down) * g.down; k < g.fd_taps; k += g.down)
      acc += s_fd[k] * s_dy[(floor_div(s - k, g.down) - oy0) * D + c];
    s_t[idx] = stage<T>(acc);
  }
  __syncthreads();

  // 4. dZ = s1 . Bd along x (f32); dU = dZ * act'(U) in place, stored in the
  //    maps' type.
  for (int idx = threadIdx.x; idx < U * U; idx += blockDim.x) {
    const int r = idx / U, c = idx - r * U;
    const int s = c0 + c;
    const float* row = s_t + r * D;
    float acc = 0.f;
    for (int k = s - floor_div(s, g.down) * g.down; k < g.fd_taps; k += g.down)
      acc += s_fd[k] * row[floor_div(s - k, g.down) - ox0];
    s_g[idx] = stage<T>(acc * s_g[idx]);
  }
  __syncthreads();

  // 5. dt1 = dU . Bu along x, keeping every up-th column: s_t [U][T], stored
  //    in the maps' type.
  for (int idx = threadIdx.x; idx < U * TT; idx += blockDim.x) {
    const int r = idx / TT, c = idx - r * TT;
    const float* row = s_g + r * U + c * g.up + g.fu_taps - 1;
    float acc = 0.f;
    for (int k = 0; k < g.fu_taps; ++k) acc += s_fu[k] * row[-k];
    s_t[idx] = stage<T>(acc);
  }
  __syncthreads();

  // 6. dX = Au^T . dt1 along y; store the tile's in-range dX.
  T* dxp = dx + (size_t)plane * g.in_h * g.in_w;
  for (int idx = threadIdx.x; idx < TT * TT; idx += blockDim.x) {
    const int r = idx / TT, c = idx - r * TT;
    const int iy = iy0 + r, ix = ix0 + c;
    if (iy >= g.in_h || ix >= g.in_w) continue;
    const float* col = s_t + (r * g.up + g.fu_taps - 1) * TT + c;
    float acc = 0.f;
    for (int k = 0; k < g.fu_taps; ++k) acc += s_fu[k] * col[-k * TT];
    dxp[(size_t)iy * g.in_w + ix] = from_f32<T>(acc);
  }
}

Geometry base_geometry(int in_h, int in_w, int out_h, int out_w, int up, int down, int px0,
                       int py0, int fu_taps, int fd_taps, float gain, float slope, float clamp,
                       int has_clamp) {
  Geometry g;
  g.in_h = in_h; g.in_w = in_w; g.out_h = out_h; g.out_w = out_w;
  g.up = up; g.down = down; g.px0 = px0; g.py0 = py0;
  g.fu_taps = fu_taps; g.fd_taps = fd_taps;
  g.gain = gain; g.slope = slope; g.clamp = clamp; g.has_clamp = has_clamp;
  g.d_size = 0;
  return g;
}

template <typename T, typename S>
cudaError_t launch_fwd(const void* x, void* y, int planes, int in_h, int in_w, int out_h,
                       int out_w, int up, int down, int px0, int px1, int py0, int py1,
                       const float* taps, int fu_taps, int fd_taps, float gain, float slope,
                       float clamp, cudaStream_t stream) {
  if (!sizes_agree(in_h, in_w, out_h, out_w, up, down, px0, px1, py0, py1, fu_taps, fd_taps))
    return cudaErrorInvalidValue;
  Geometry g = base_geometry(in_h, in_w, out_h, out_w, up, down, px0, py0, fu_taps, fd_taps,
                             gain, slope, clamp, 0);
  g.tile = kFwdTile;
  g.tiles_x = (out_w + kFwdTile - 1) / kFwdTile;
  g.tiles_per_plane = g.tiles_x * ((out_h + kFwdTile - 1) / kFwdTile);
  g.u_size = (kFwdTile - 1) * down + fd_taps;
  g.i_size = (g.u_size + fu_taps - 2) / up + 1;
  return launch(fused_fwd_kernel<T, S>, (long long)planes * g.tiles_per_plane,
                (size_t)fwd_smem_floats(g) * sizeof(float), stream,
                static_cast<const T*>(x), static_cast<T*>(y), taps, g);
}

void set_bwd_tile(Geometry& g, int tile) {
  g.tile = tile;
  g.u_size = (tile - 1) * g.up + g.fu_taps;
  g.i_size = (g.u_size + g.fu_taps - 2) / g.up + 1;
  g.d_size = (g.u_size + g.fd_taps - 2) / g.down + 1;
  g.tiles_x = (g.in_w + tile - 1) / tile;
  g.tiles_per_plane = g.tiles_x * ((g.in_h + tile - 1) / tile);
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, void* dx, int planes, int in_h, int in_w,
                       int out_h, int out_w, int up, int down, int px0, int px1, int py0,
                       int py1, const float* taps, int fu_taps, int fd_taps, float gain,
                       float slope, float clamp, int has_clamp, cudaStream_t stream) {
  if (!sizes_agree(in_h, in_w, out_h, out_w, up, down, px0, px1, py0, py1, fu_taps, fd_taps))
    return cudaErrorInvalidValue;
  Geometry g = base_geometry(in_h, in_w, out_h, out_w, up, down, px0, py0, fu_taps, fd_taps,
                             gain, slope, clamp, has_clamp);
  int tile = kMaxTile;
  set_bwd_tile(g, tile);
  while (tile > kMinTile && (size_t)bwd_smem_floats(g) * sizeof(float) > kSmemBudget) {
    tile /= 2;
    set_bwd_tile(g, tile);
  }
  return launch(fused_bwd_kernel<T>, (long long)planes * g.tiles_per_plane,
                (size_t)bwd_smem_floats(g) * sizeof(float), stream,
                static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), taps,
                g);
}

}  // namespace

// Forward: LVG_FWD_ARGS (filtered_lrelu_common.cuh); for K3a the taps
// rounded to bf16 for bf16 maps, for K4 the taps in f32 whatever the maps'
// type. Backward: x and dx like the forward's x, dy like its y, and
// has_clamp = 0 for no clamp. Each returns a cudaError_t (0 on success).
extern "C" int lvg_fused_fwd_f32(LVG_FWD_ARGS) {
  return static_cast<int>(launch_fwd<float, float>(LVG_FWD_PASS));
}

extern "C" int lvg_fused_fwd_bf16(LVG_FWD_ARGS) {
  return static_cast<int>(launch_fwd<__nv_bfloat16, __nv_bfloat16>(LVG_FWD_PASS));
}

extern "C" int lvg_exact_fwd_f32(LVG_FWD_ARGS) {
  return static_cast<int>(launch_fwd<float, float>(LVG_FWD_PASS));
}

extern "C" int lvg_exact_fwd_bf16(LVG_FWD_ARGS) {
  return static_cast<int>(launch_fwd<__nv_bfloat16, float>(LVG_FWD_PASS));
}

#define LVG_BWD_ARGS                                                                       \
  const void *x, const void *dy, void *dx, int planes, int in_h, int in_w, int out_h,      \
      int out_w, int up, int down, int px0, int px1, int py0, int py1, const float *taps,  \
      int fu_taps, int fd_taps, float gain, float slope, float clamp, int has_clamp,       \
      void *stream
#define LVG_BWD_PASS                                                                       \
  x, dy, dx, planes, in_h, in_w, out_h, out_w, up, down, px0, px1, py0, py1, taps,         \
      fu_taps, fd_taps, gain, slope, clamp, has_clamp, static_cast<cudaStream_t>(stream)

extern "C" int lvg_fused_bwd_f32(LVG_BWD_ARGS) {
  return static_cast<int>(launch_bwd<float>(LVG_BWD_PASS));
}

extern "C" int lvg_fused_bwd_bf16(LVG_BWD_ARGS) {
  return static_cast<int>(launch_bwd<__nv_bfloat16>(LVG_BWD_PASS));
}

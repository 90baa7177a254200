// The f32-exact filtered_lrelu forward (K4) for Hopper (sm_90a), on maps
// whose bias is already added. Plain C interface, loaded with ctypes by
// ops/filtered_lrelu_exact.py.
//
// Replaces: long_video_gan_tpu/ops/pallas/filtered_lrelu_kernel.py
// `_filtered_lrelu_pallas` (the first Pallas kernel, reached through
// `filtered_lrelu(impl="pallas")`). Same function, per plane X [H, W]:
//   t1 = Au . X;  U = t1 . Bu^T;  Z = act(U);  t3 = Z . Bd^T;  out = Ad . t3
// with the banded operators of ops/upfirdn2d.py `axis_matrix`: the up and
// down passes of filtered_lrelu_common.cuh, per axis, with nothing rounded
// inside whatever the maps' type: f32 taps, every stage in f32 (the TPU
// kernel's `Precision.HIGHEST`), no TF32, the output in the maps' type. It
// has no gradient.
//
// What bounds it: the f32 operations (selftest.bound; the products at the
// f32 peak outside the tensor cores take longer than reading the maps and
// writing the result once). The supersampled U never leaves shared memory,
// as the TPU kernel keeps it in VMEM. The TPU kernel keeps a whole image in
// VMEM; the U of the 166x278 layers is ~760 KB per plane in f32, over a
// block's 227 KB, so here a block takes one output tile and carries the band
// windows of its stages through shared memory. Only the band is contracted:
// every product visits the taps of the filter, not the zeros of the dense
// operator (~95% of it), and the up passes only the taps that meet a nonzero
// of the zero-stuffed signal.
//
// Design (simple and right first): one block per 32 x 32 output tile of one
// plane, planes and tiles on gridDim.x. Each stage is one pass over shared
// memory in f32 FMAs. No tensor cores or TMA yet. (K3a, the same forward with
// the TPU kernel's bf16 stage rounding, now runs on the tensor cores in
// filtered_lrelu_fused_tc.cu.)

#include "filtered_lrelu_common.cuh"

namespace {

using namespace lvg;

constexpr int kFwdTile = 32;

struct Geometry {
  int in_h, in_w, out_h, out_w;
  int up, down, px0, py0;
  int fu_taps, fd_taps;
  int tile;                // output tile edge
  int tiles_x, tiles_per_plane;
  int u_size;              // supersampled window edge
  int i_size;              // X patch edge
  float gain, slope, clamp;
};

// Forward buffers: taps, X patch [I][I], t1 [U][I] reused as t3 [U][T], Z [U][U].
__host__ __device__ __forceinline__ int fwd_t_floats(const Geometry& g) {
  return imax(g.u_size * g.i_size, g.u_size * g.tile);
}

__host__ __device__ __forceinline__ int fwd_smem_floats(const Geometry& g) {
  return g.fu_taps + g.fd_taps + g.i_size * g.i_size + fwd_t_floats(g) + g.u_size * g.u_size;
}

// Maps of type T, stages in f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
exact_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ taps,
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
  //    column only), in f32.
  for (int idx = threadIdx.x; idx < U * I; idx += blockDim.x) {
    const int r = idx / I, c = idx - r * I;
    const int j = jy0 + r;
    float acc = 0.f;
    for (int k = ceil_div(j, g.up) * g.up - j; k < g.fu_taps; k += g.up)
      acc += s_fu[k] * s_x[((j + k) / g.up - iy0) * I + c];
    s_t[idx] = acc;
  }
  __syncthreads();

  // 2. U = t1 . Bu^T along x, Z = act(U) (comparisons keep NaN), in f32.
  for (int idx = threadIdx.x; idx < U * U; idx += blockDim.x) {
    const int r = idx / U, c = idx - r * U;
    const int j = jx0 + c;
    const float* row = s_t + r * I;
    float u = 0.f;
    for (int k = ceil_div(j, g.up) * g.up - j; k < g.fu_taps; k += g.up)
      u += s_fu[k] * row[(j + k) / g.up - ix0];
    float v = (u < 0.f ? u * g.slope : u) * g.gain;
    v = v > g.clamp ? g.clamp : (v < -g.clamp ? -g.clamp : v);
    s_z[idx] = v;
  }
  __syncthreads();

  // 3. t3 = Z . Bd^T along x into s_t [U][T], in f32.
  for (int idx = threadIdx.x; idx < U * TT; idx += blockDim.x) {
    const int r = idx / TT, c = idx - r * TT;
    const float* row = s_z + r * U + c * g.down;
    float acc = 0.f;
    for (int k = 0; k < g.fd_taps; ++k) acc += s_fd[k] * row[k];
    s_t[idx] = acc;
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

Geometry base_geometry(int in_h, int in_w, int out_h, int out_w, int up, int down, int px0,
                       int py0, int fu_taps, int fd_taps, float gain, float slope,
                       float clamp) {
  Geometry g;
  g.in_h = in_h; g.in_w = in_w; g.out_h = out_h; g.out_w = out_w;
  g.up = up; g.down = down; g.px0 = px0; g.py0 = py0;
  g.fu_taps = fu_taps; g.fd_taps = fd_taps;
  g.gain = gain; g.slope = slope; g.clamp = clamp;
  return g;
}

template <typename T>
cudaError_t launch_fwd(const void* x, void* y, int planes, int in_h, int in_w, int out_h,
                       int out_w, int up, int down, int px0, int px1, int py0, int py1,
                       const float* taps, int fu_taps, int fd_taps, float gain, float slope,
                       float clamp, cudaStream_t stream) {
  if (!sizes_agree(in_h, in_w, out_h, out_w, up, down, px0, px1, py0, py1, fu_taps, fd_taps))
    return cudaErrorInvalidValue;
  Geometry g = base_geometry(in_h, in_w, out_h, out_w, up, down, px0, py0, fu_taps, fd_taps,
                             gain, slope, clamp);
  g.tile = kFwdTile;
  g.tiles_x = (out_w + kFwdTile - 1) / kFwdTile;
  g.tiles_per_plane = g.tiles_x * ((out_h + kFwdTile - 1) / kFwdTile);
  g.u_size = (kFwdTile - 1) * down + fd_taps;
  g.i_size = (g.u_size + fu_taps - 2) / up + 1;
  return launch(exact_fwd_kernel<T>, (long long)planes * g.tiles_per_plane,
                (size_t)fwd_smem_floats(g) * sizeof(float), stream,
                static_cast<const T*>(x), static_cast<T*>(y), taps, g);
}

}  // namespace

// LVG_FWD_ARGS (filtered_lrelu_common.cuh), the taps in f32 whatever the
// maps' type. Each returns a cudaError_t (0 on success).
extern "C" int lvg_exact_fwd_f32(LVG_FWD_ARGS) {
  return static_cast<int>(launch_fwd<float>(LVG_FWD_PASS));
}

extern "C" int lvg_exact_fwd_bf16(LVG_FWD_ARGS) {
  return static_cast<int>(launch_fwd<__nv_bfloat16>(LVG_FWD_PASS));
}

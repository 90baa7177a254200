// Polyphase filtered_lrelu forward (K5) for Hopper (sm_90a), up and down in
// {1, 2}, on maps whose bias is already added. Plain C interface, loaded with
// ctypes by ops/filtered_lrelu_polyphase.py.
//
// Replaces: long_video_gan_tpu/ops/pallas/filtered_lrelu_v2.py
// `_filtered_lrelu_pallas_v2` (reached through its entry point
// `filtered_lrelu_pallas_v2`). Same function: X in f32, H-up, W-up split
// into its `up` phases (output column up*m + phi takes only the taps that meet
// a nonzero of the zero-stuffed row; no zero-stuffed buffer is formed), gain *
// leaky ReLU and clamp per phase, a W-down that reads the phase arrays
// directly (no interleave), H-down, all in f32; the output in X's type. The
// up and down passes are those of filtered_lrelu_common.cuh.
//
// What bounds it: device-memory bytes in principle (read X, write the output
// once); the supersampled window never leaves shared memory. Here the f32
// shared-memory passes cost more than the bytes.
//
// Design (simple and right first): `up` and `down` are template constants,
// so every tap loop has a fixed stride and phase. One block per 32 x 32
// output tile of one plane, planes and tiles on gridDim.x. The activated
// window is stored phase-major, [phase][row][m]: at up = down = 2 the W-down
// pass of neighbouring threads then reads neighbouring words of one phase,
// where an interleaved row would make them stride by 2. No tensor cores or
// TMA yet.

#include "filtered_lrelu_common.cuh"

namespace {

using namespace lvg;

constexpr int kTile = 32;  // output tile edge

struct Geometry {
  int in_h, in_w, out_h, out_w;
  int px0, py0;
  int fu_taps, fd_taps;
  int tiles_x, tiles_per_plane;
  int u_size;  // supersampled window edge: (kTile - 1) * down + fd_taps
  int i_size;  // X patch edge: (u_size + fu_taps - 2) / up + 1
  int m_size;  // length of one phase of a window row: (u_size + up - 2) / up + 1
  float gain, slope, clamp;
};

// Buffers: taps, X patch [I][I], H-up [U][I] reused for W-down [U][T], the
// activated window [up][U][M].
__host__ __device__ __forceinline__ int t_floats(const Geometry& g) {
  return imax(g.u_size * g.i_size, g.u_size * kTile);
}

template <int UP>
__host__ __device__ __forceinline__ int smem_floats(const Geometry& g) {
  return g.fu_taps + g.fd_taps + g.i_size * g.i_size + t_floats(g) +
         UP * g.u_size * g.m_size;
}

template <typename T, int UP, int DOWN>
__global__ void __launch_bounds__(kThreads)
polyphase_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ taps,
                     Geometry g) {
  extern __shared__ float smem[];
  const int U = g.u_size, I = g.i_size, M = g.m_size;
  float* s_fu = smem;
  float* s_fd = s_fu + g.fu_taps;
  float* s_x = s_fd + g.fd_taps;        // [I][I] X patch
  float* s_t = s_x + I * I;             // [U][I] after H-up, then [U][T] after W-down
  float* s_z = s_t + t_floats(g);       // [UP][U][M] activated, phase-major

  const int plane = blockIdx.x / g.tiles_per_plane;
  const int tile = blockIdx.x - plane * g.tiles_per_plane;
  const int oy0 = (tile / g.tiles_x) * kTile;
  const int ox0 = (tile % g.tiles_x) * kTile;
  // Zero-stuffed index of up-tap 0 at the window's first supersampled
  // row/column, and the first X row/column it reaches.
  const int jy0 = oy0 * DOWN - g.py0;
  const int jx0 = ox0 * DOWN - g.px0;
  const int iy0 = ceil_div(jy0, UP);
  const int ix0 = ceil_div(jx0, UP);
  // Window column c is phase (phi0 + c) % UP, element (phi0 + c) / UP.
  const int m0 = floor_div(jx0, UP);
  const int phi0 = jx0 - m0 * UP;

  for (int k = threadIdx.x; k < g.fu_taps + g.fd_taps; k += blockDim.x) s_fu[k] = taps[k];
  load_patch(s_x, x + (size_t)plane * g.in_h * g.in_w, iy0, ix0, I, I, g.in_h, g.in_w);
  __syncthreads();

  // 1. H-up: row j of the zero-stuffed column meets taps k0, k0 + UP, ...
  for (int idx = threadIdx.x; idx < U * I; idx += blockDim.x) {
    const int r = idx / I, c = idx - r * I;
    const int j = jy0 + r;
    const int k0 = ceil_div(j, UP) * UP - j;
    const float* col = s_x + (ceil_div(j, UP) - iy0) * I + c;
    float acc = 0.f;
    for (int k = k0, i = 0; k < g.fu_taps; k += UP, ++i) acc += s_fu[k] * col[i * I];
    s_t[idx] = acc;
  }
  __syncthreads();

  // 2. W-up by phase, then gain * lrelu and clamp (comparisons keep NaN):
  //    phase phi of element m takes taps (UP - phi) % UP + UP * i of X column
  //    m + ceil(phi / UP) + i.
  for (int idx = threadIdx.x; idx < U * U; idx += blockDim.x) {
    const int r = idx / U, c = idx - r * U;
    const int p = phi0 + c;
    const int phi = p % UP, m = p / UP;
    const int k0 = (UP - phi) % UP;
    const float* row = s_t + r * I + (m0 + m + (phi + k0) / UP - ix0);
    float u = 0.f;
    for (int k = k0, i = 0; k < g.fu_taps; k += UP, ++i) u += s_fu[k] * row[i];
    float v = (u < 0.f ? u * g.slope : u) * g.gain;
    s_z[(phi * U + r) * M + m] = v > g.clamp ? g.clamp : (v < -g.clamp ? -g.clamp : v);
  }
  __syncthreads();

  // 3. W-down from the phase arrays into s_t [U][T].
  for (int idx = threadIdx.x; idx < U * kTile; idx += blockDim.x) {
    const int r = idx / kTile, c = idx - r * kTile;
    float acc = 0.f;
    for (int k = 0; k < g.fd_taps; ++k) {
      const int p = phi0 + c * DOWN + k;
      acc += s_fd[k] * s_z[((p % UP) * U + r) * M + p / UP];
    }
    s_t[idx] = acc;
  }
  __syncthreads();

  // 4. H-down; store the tile's in-range outputs in X's type.
  T* yp = y + (size_t)plane * g.out_h * g.out_w;
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += blockDim.x) {
    const int r = idx / kTile, c = idx - r * kTile;
    const int oy = oy0 + r, ox = ox0 + c;
    if (oy >= g.out_h || ox >= g.out_w) continue;
    const float* col = s_t + r * DOWN * kTile + c;
    float acc = 0.f;
    for (int k = 0; k < g.fd_taps; ++k) acc += s_fd[k] * col[k * kTile];
    yp[(size_t)oy * g.out_w + ox] = from_f32<T>(acc);
  }
}

template <typename T, int UP, int DOWN>
cudaError_t launch_factors(const void* x, void* y, int planes, Geometry g, const float* taps,
                           cudaStream_t stream) {
  g.u_size = (kTile - 1) * DOWN + g.fd_taps;
  g.i_size = (g.u_size + g.fu_taps - 2) / UP + 1;
  g.m_size = (g.u_size + UP - 2) / UP + 1;
  return launch(polyphase_fwd_kernel<T, UP, DOWN>, (long long)planes * g.tiles_per_plane,
                (size_t)smem_floats<UP>(g) * sizeof(float), stream, static_cast<const T*>(x),
                static_cast<T*>(y), taps, g);
}

template <typename T>
cudaError_t launch_fwd(const void* x, void* y, int planes, int in_h, int in_w, int out_h,
                       int out_w, int up, int down, int px0, int px1, int py0, int py1,
                       const float* taps, int fu_taps, int fd_taps, float gain, float slope,
                       float clamp, cudaStream_t stream) {
  if (up < 1 || up > 2 || down < 1 || down > 2 ||
      !sizes_agree(in_h, in_w, out_h, out_w, up, down, px0, px1, py0, py1, fu_taps, fd_taps))
    return cudaErrorInvalidValue;
  Geometry g;
  g.in_h = in_h; g.in_w = in_w; g.out_h = out_h; g.out_w = out_w;
  g.px0 = px0; g.py0 = py0;
  g.fu_taps = fu_taps; g.fd_taps = fd_taps;
  g.tiles_x = (out_w + kTile - 1) / kTile;
  g.tiles_per_plane = g.tiles_x * ((out_h + kTile - 1) / kTile);
  g.gain = gain; g.slope = slope; g.clamp = clamp;
  if (up == 1)
    return down == 1 ? launch_factors<T, 1, 1>(x, y, planes, g, taps, stream)
                     : launch_factors<T, 1, 2>(x, y, planes, g, taps, stream);
  return down == 1 ? launch_factors<T, 2, 1>(x, y, planes, g, taps, stream)
                   : launch_factors<T, 2, 2>(x, y, planes, g, taps, stream);
}

}  // namespace

// LVG_FWD_ARGS (filtered_lrelu_common.cuh) with up, down in {1, 2}, the taps
// in f32 whatever the maps' type. Returns a cudaError_t (0 on success).
extern "C" int lvg_polyphase_fwd_f32(LVG_FWD_ARGS) {
  return static_cast<int>(launch_fwd<float>(LVG_FWD_PASS));
}

extern "C" int lvg_polyphase_fwd_bf16(LVG_FWD_ARGS) {
  return static_cast<int>(launch_fwd<__nv_bfloat16>(LVG_FWD_PASS));
}

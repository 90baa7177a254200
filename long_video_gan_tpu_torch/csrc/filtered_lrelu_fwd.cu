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
// `auto` runs it on the f32 head layers of the sres plan (L0-L2: 31x38 in,
// 29x36 out, up 2, down 2, 12 taps each).
//
// What bounds it: device-memory bytes (read the plane once, write it once).
// The composed path writes the up^2-times-larger supersampled buffer to
// device memory and reads it back between its passes; here it never leaves
// shared memory. Arithmetic is a few dozen f32 FMAs per supersampled value,
// each fed from shared memory, so shared-memory loads per FMA set the pace
// once the bytes are gone.
//
// Design. One block per output tile of one plane; planes and tiles on
// gridDim.x. The tile is chosen from the plane: a plane whose whole output
// and supersampled window fit in kPlaneSmem of shared memory takes one block
// (the head layers: 29x36 out, a 68x82 f32 window, 36 KB with the stage
// buffer, the input patch sharing the window's buffer); larger planes
// take 32x32 tiles. A tile shaped
// to the plane computes each supersampled value once; a 32x32 tile on a
// 29x36 plane computed two 74x74 windows for 36 columns.
// Four separable passes through shared memory, all in f32 FMA:
//   input patch -> up pass along x -> up pass along y + activation ->
//   down pass along x -> down pass along y -> global.
// Each pass is polyphase (`up_pass`: only the taps that meet a nonzero of the
// zero-stuffed signal; `down_pass`: only the kept outputs), and a thread
// computes kR neighbouring outputs of one row or column from inputs held in
// registers (filtered_lrelu_f32.cuh): at the plan's factor 2 and 12 taps the
// taps sit in registers and each input loads once for every phase; the
// first tap of each phase is the phase itself, and no integer division is
// left in a tap or item loop. Passes along x put neighbouring threads on
// neighbouring rows of an odd-pitched buffer; passes along y on neighbouring
// columns: no bank conflicts. No tensor cores, TF32 or bf16 parts: every
// product and sum is f32.

#include <climits>
#include <cuda_runtime.h>

#include "filtered_lrelu_f32.cuh"

namespace {

using namespace lvg_f32;

struct Geometry {
  int in_h, in_w, out_h, out_w;
  int up, down, px0, py0;
  int fu_taps, fd_taps;
  int tile_h, tile_w;              // output tile
  int tiles_x, tiles_per_plane;
  int u_h, u_w;                    // supersampled window a full tile reads
  int x_rows, x_cols, x_pitch;     // input patch [x_rows][x_pitch]
  int t_pitch;                     // after the up pass along x: [x_rows][t_pitch]
  int a_pitch;                     // supersampled and activated: [u_h][a_pitch]
  int d_rows, d_pitch;             // after the down pass along x: [d_rows][d_pitch]
  int t_floats;                    // the buffer the two x passes write
  int a_floats;                    // the input patch, then the supersampled buffer
  float gain, slope, clamp;
};

__host__ __device__ inline int smem_floats(const Geometry& g) {
  return g.fu_taps + g.fd_taps + g.t_floats + g.a_floats;
}

// The buffers of one tile shape.
void set_tile(Geometry& g, int tile_h, int tile_w) {
  const int nu = ceil_div(g.fu_taps, g.up), nd = ceil_div(g.fd_taps, g.down);
  g.tile_h = tile_h;
  g.tile_w = tile_w;
  g.tiles_x = ceil_div(g.out_w, tile_w);
  g.tiles_per_plane = g.tiles_x * ceil_div(g.out_h, tile_h);
  g.u_h = (tile_h - 1) * g.down + g.fd_taps;
  g.u_w = (tile_w - 1) * g.down + g.fd_taps;
  g.x_rows = up_reads(g.u_h, g.up, nu);
  g.x_cols = up_reads(g.u_w, g.up, nu);
  g.x_pitch = g.x_cols | 1;
  g.t_pitch = g.u_w | 1;
  g.a_pitch = down_reads(tile_w, g.down, nd) | 1;
  g.d_rows = down_reads(tile_h, g.down, nd);
  g.d_pitch = tile_w | 1;
  const int t = g.x_rows * g.t_pitch, d = g.d_rows * g.d_pitch;
  g.t_floats = t > d ? t : d;
  const int x = g.x_rows * g.x_pitch, a = g.u_h * g.a_pitch;
  g.a_floats = x > a ? x : a;
}

// Activation on the way into the supersampled buffer (comparisons keep NaN).
struct StoreAct {
  float gain, slope, clamp;
  __device__ __forceinline__ void operator()(float* p, float u) const {
    float v = (u < 0.f ? u * slope : u) * gain;
    *p = v > clamp ? clamp : (v < -clamp ? -clamp : v);
  }
};

__global__ void __launch_bounds__(kThreads, 5)
flrelu_f32_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                      const float* __restrict__ taps, Geometry g) {
  extern __shared__ float smem[];
  float* s_fu = smem;
  float* s_fd = s_fu + g.fu_taps;
  float* s_t = s_fd + g.fd_taps;               // [x_rows][t_pitch], then [d_rows][d_pitch]
  float* s_x = s_t + g.t_floats;               // [x_rows][x_pitch] input patch, then
  float* s_a = s_x;                            // [u_h][a_pitch] supersampled, activated

  const int plane = blockIdx.x / g.tiles_per_plane;
  const int tile = blockIdx.x - plane * g.tiles_per_plane;
  const int oy0 = (tile / g.tiles_x) * g.tile_h;
  const int ox0 = (tile % g.tiles_x) * g.tile_w;
  const int rows = min(g.tile_h, g.out_h - oy0), cols = min(g.tile_w, g.out_w - ox0);
  // Zero-stuffed index of tap 0 at the window's first supersampled row and
  // column, the first input row/column it reaches, and the phase offset q
  // of `up_pass`.
  const int jy0 = oy0 * g.down - g.py0, jx0 = ox0 * g.down - g.px0;
  const int iy0 = ceil_div(jy0, g.up), ix0 = ceil_div(jx0, g.up);

  for (int k = threadIdx.x; k < g.fu_taps + g.fd_taps; k += blockDim.x) s_fu[k] = taps[k];
  load_patch(s_x, g.x_rows, g.x_cols, g.x_pitch, x + (size_t)plane * g.in_h * g.in_w, g.in_h,
             g.in_w, iy0, ix0);
  __syncthreads();

  // Only what the tile's in-range outputs read.
  const int u_h = (rows - 1) * g.down + g.fd_taps, u_w = (cols - 1) * g.down + g.fd_taps;
  // 1. Up pass along x: [x_rows][x_cols] -> s_t [x_rows][u_w].
  up_pass(s_x, 1, g.x_pitch, s_t, 1, g.t_pitch, up_reads(u_h, g.up, ceil_div(g.fu_taps, g.up)),
          u_w, ix0 * g.up - jx0, s_fu, g.fu_taps, g.up, StoreTo());
  __syncthreads();
  // 2. Up pass along y, then gain * lrelu and clamp: s_a [u_h][u_w].
  up_pass(s_t, g.t_pitch, 1, s_a, g.a_pitch, 1, u_w, u_h, iy0 * g.up - jy0, s_fu, g.fu_taps,
          g.up, StoreAct{g.gain, g.slope, g.clamp});
  __syncthreads();
  // 3. Down pass along x: s_t [u_h][cols].
  down_pass(s_a, 1, g.a_pitch, s_t, 1, g.d_pitch, u_h, cols, s_fd, g.fd_taps, g.down, StoreTo());
  __syncthreads();
  // 4. Down pass along y into the tile's in-range outputs.
  down_pass(s_t, g.d_pitch, 1, y + (size_t)plane * g.out_h * g.out_w + (size_t)oy0 * g.out_w + ox0,
            g.out_w, 1, cols, rows, s_fd, g.fd_taps, g.down, StoreTo());
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
  g.gain = gain; g.slope = slope; g.clamp = clamp;
  // The whole plane in one block where it fits, else kTile.
  set_tile(g, out_h, out_w);
  if ((size_t)smem_floats(g) * sizeof(float) > kPlaneSmem) set_tile(g, kTile, kTile);

  const long long blocks = (long long)planes * g.tiles_per_plane;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)smem_floats(g) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flrelu_f32_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  flrelu_f32_fwd_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
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

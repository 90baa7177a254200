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
//   down^T:       da[s] = sum_k fd[k] * dy[(s - k) / down]   ((s - k) % down == 0),
//                 an up pass of the dy patch by `down` with fd reversed;
//   act':         g = da * (u >= 0 ? gain : gain * slope), zero where
//                 gain * lrelu(u) is not strictly inside (-clamp, clamp)
//                 (`_act_grad_factory`, ops/pallas/filtered_lrelu_fused.py);
//   up^T:         dx[i] = sum_k fu[k] * g[i*up + pad0 - k], a down pass by
//                 `up` with fu reversed.
// fu and fd arrive flipped, fu times `up`, as for the forward kernel.
// `auto` runs it in training on the f32 head layers of the sres plan (L0-L2:
// 31x38 dX, up 2, down 2, 12 taps each).
//
// What bounds it: device-memory bytes in principle (read x and dy, write dx
// once); the supersampled U, dA and G never leave shared memory, as the TPU
// kernel keeps them out of HBM. In practice the f32 shared-memory passes:
// six per tile.
//
// Design. One block per dX tile of one plane; planes and tiles on gridDim.x.
// The tile is chosen from the plane: a plane whose whole dX and supersampled
// window fit in kPlaneSmem of shared memory takes one block (the head layers:
// 31x38 dX, a 72x86 f32 window, 51 KB with the patch and the stage buffer;
// the dy patch loads where the x patch was once U is made, so four blocks
// share an SM); larger planes take 32x32 tiles, halved until the buffers
// fit in 96 KB (up 4 with 24 taps: 16). A tile shaped to the plane recomputes each supersampled value
// once; 32x32 tiles on a 31x38 dX computed two 74x74 windows for 38 columns.
// The block recomputes U over the window of supersampled rows/columns its dX
// tile reads, turns it into act'(U), multiplies by the transposed down pass
// of the dy patch and reduces with the transposed up pass, all in f32 FMA in
// shared memory; the output rounds once. Every pass is one of the polyphase
// passes of filtered_lrelu_f32.cuh (kR outputs a thread from inputs held in
// registers, the plan's factor and tap count compiled in, no integer
// division in a tap or item loop, odd pitches under the passes along x).
// The up pass runs along y first, as the products Au . X . Bu^T of the plain
// version and the TPU kernel: act' jumps at U = 0, and each U sums its taps
// in the plain version's order. No tensor cores, TF32 or bf16 parts.

#include <climits>
#include <cuda_runtime.h>

#include "filtered_lrelu_f32.cuh"

namespace {

using namespace lvg_f32;

constexpr int kMinTile = 8;
constexpr size_t kSmemBudget = 96 * 1024;

struct Geometry {
  int in_h, in_w, out_h, out_w;    // x and dx [in_h, in_w]; dy [out_h, out_w]
  int up, down, px0, py0;
  int fu_taps, fd_taps;
  int tile_h, tile_w;              // dX tile
  int tiles_x, tiles_per_plane;
  int g_h, g_w;                    // supersampled window a full tile reads
  int x_rows, x_cols;              // x patch [x_rows][x_cols]
  int d_rows, d_cols, d_pitch;     // dy patch [d_rows][d_pitch], where the x patch was
  int p_floats;                    // the patch buffer: the larger of the two
  int g_pitch;                     // act'(U), then G: [g_h][g_pitch]
  int t_floats;                    // scratch, see set_tile
  float gain, slope, clamp;
  int has_clamp;
};

__host__ __device__ inline int smem_floats(const Geometry& g) {
  return 2 * g.fu_taps + g.fd_taps + g.p_floats + g.t_floats + g.g_h * g.g_pitch;
}

// The buffers of one tile shape. The scratch holds in turn the up pass along
// y [g_h][x_cols | 1], the down^T pass along x [d_rows][g_w | 1] and the
// up^T pass along x [e_rows][tile_w | 1].
void set_tile(Geometry& g, int tile_h, int tile_w) {
  const int nu = ceil_div(g.fu_taps, g.up), nd = ceil_div(g.fd_taps, g.down);
  g.tile_h = tile_h;
  g.tile_w = tile_w;
  g.tiles_x = ceil_div(g.in_w, tile_w);
  g.tiles_per_plane = g.tiles_x * ceil_div(g.in_h, tile_h);
  g.g_h = (tile_h - 1) * g.up + g.fu_taps;
  g.g_w = (tile_w - 1) * g.up + g.fu_taps;
  g.x_rows = up_reads(g.g_h, g.up, nu);
  g.x_cols = up_reads(g.g_w, g.up, nu);
  g.d_rows = up_reads(g.g_h, g.down, nd);
  g.d_cols = up_reads(g.g_w, g.down, nd);
  g.d_pitch = g.d_cols | 1;
  g.p_floats = g.x_rows * g.x_cols > g.d_rows * g.d_pitch ? g.x_rows * g.x_cols
                                                          : g.d_rows * g.d_pitch;
  g.g_pitch = down_reads(tile_w, g.up, nu) | 1;
  int t = g.g_h * (g.x_cols | 1);
  const int d = g.d_rows * (g.g_w | 1), e = down_reads(tile_h, g.up, nu) * (tile_w | 1);
  if (d > t) t = d;
  if (e > t) t = e;
  g.t_floats = t;
}

size_t smem_bytes(const Geometry& g) { return (size_t)smem_floats(g) * sizeof(float); }

// act'(U) on the way into s_g.
struct StoreActGrad {
  float gain, slope, clamp;
  int has_clamp;
  __device__ __forceinline__ void operator()(float* p, float u) const {
    float d = u >= 0.f ? gain : gain * slope;
    if (has_clamp) {
      const float z = (u >= 0.f ? u : u * slope) * gain;
      if (!(z > -clamp && z < clamp)) d = 0.f;
    }
    *p = d;
  }
};

// G = act'(U) * dA in place.
struct StoreScale {
  __device__ __forceinline__ void operator()(float* p, float v) const { *p *= v; }
};

__global__ void __launch_bounds__(kThreads, 4)
flrelu_f32_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                      float* __restrict__ dx, const float* __restrict__ taps, Geometry g) {
  extern __shared__ float smem[];
  float* s_fu = smem;                          // fu as delivered
  float* s_fur = s_fu + g.fu_taps;             // fu reversed
  float* s_fdr = s_fur + g.fu_taps;            // fd reversed
  float* s_x = s_fdr + g.fd_taps;              // [x_rows][x_cols] x patch, then
  float* s_dy = s_x;                           // [d_rows][d_pitch] dy patch
  float* s_t = s_x + g.p_floats;               // scratch, see set_tile
  float* s_g = s_t + g.t_floats;               // [g_h][g_pitch] act'(U), then G

  const int plane = blockIdx.x / g.tiles_per_plane;
  const int tile = blockIdx.x - plane * g.tiles_per_plane;
  const int iy0 = (tile / g.tiles_x) * g.tile_h;
  const int ix0 = (tile % g.tiles_x) * g.tile_w;
  const int rows = min(g.tile_h, g.in_h - iy0), cols = min(g.tile_w, g.in_w - ix0);
  // First supersampled row/column of the window the dx tile reads.
  const int r0 = iy0 * g.up + g.py0 - (g.fu_taps - 1);
  const int c0 = ix0 * g.up + g.px0 - (g.fu_taps - 1);
  // Zero-stuffed index of up-tap 0 at the window's first row/column, and the
  // first x row/column it reaches; the same for the down^T pass over dy.
  const int jy0 = r0 - g.py0, jx0 = c0 - g.px0;
  const int ys0 = ceil_div(jy0, g.up), xs0 = ceil_div(jx0, g.up);
  const int ky0 = r0 - (g.fd_taps - 1), kx0 = c0 - (g.fd_taps - 1);
  const int oy0 = ceil_div(ky0, g.down), ox0 = ceil_div(kx0, g.down);

  for (int k = threadIdx.x; k < g.fu_taps; k += blockDim.x) {
    const float f = taps[k];
    s_fu[k] = f;
    s_fur[g.fu_taps - 1 - k] = f;
  }
  for (int k = threadIdx.x; k < g.fd_taps; k += blockDim.x)
    s_fdr[g.fd_taps - 1 - k] = taps[g.fu_taps + k];
  load_patch(s_x, g.x_rows, g.x_cols, g.x_cols, x + (size_t)plane * g.in_h * g.in_w, g.in_h,
             g.in_w, ys0, xs0);
  __syncthreads();

  // Only what the tile's in-range dx reads.
  const int g_h = (rows - 1) * g.up + g.fu_taps, g_w = (cols - 1) * g.up + g.fu_taps;
  const int nu = ceil_div(g.fu_taps, g.up), nd = ceil_div(g.fd_taps, g.down);
  const int t_pitch = g.x_cols | 1, d_pitch = g.g_w | 1, e_pitch = g.tile_w | 1;
  // 1. Up pass along y: s_t [g_h][x_cols].
  up_pass(s_x, g.x_cols, 1, s_t, t_pitch, 1, up_reads(g_w, g.up, nu), g_h, ys0 * g.up - jy0,
          s_fu, g.fu_taps, g.up, StoreTo());
  __syncthreads();
  // 2. The dy patch where the x patch was; up pass along x gives U; keep
  //    act'(U) in s_g [g_h][g_w].
  load_patch(s_dy, g.d_rows, g.d_cols, g.d_pitch, dy + (size_t)plane * g.out_h * g.out_w,
             g.out_h, g.out_w, oy0, ox0);
  up_pass(s_t, 1, t_pitch, s_g, 1, g.g_pitch, g_h, g_w, xs0 * g.up - jx0, s_fu, g.fu_taps, g.up,
          StoreActGrad{g.gain, g.slope, g.clamp, g.has_clamp});
  __syncthreads();
  // 3. Transposed down pass along x: s_t [d_rows][g_w].
  up_pass(s_dy, 1, g.d_pitch, s_t, 1, d_pitch, up_reads(g_h, g.down, nd), g_w,
          ox0 * g.down - kx0, s_fdr, g.fd_taps, g.down, StoreTo());
  __syncthreads();
  // 4. Transposed down pass along y gives dA; G = act'(U) * dA in s_g.
  up_pass(s_t, d_pitch, 1, s_g, g.g_pitch, 1, g_w, g_h, oy0 * g.down - ky0, s_fdr, g.fd_taps,
          g.down, StoreScale());
  __syncthreads();
  // 5. Transposed up pass along x: s_t [g_h][cols].
  down_pass(s_g, 1, g.g_pitch, s_t, 1, e_pitch, g_h, cols, s_fur, g.fu_taps, g.up, StoreTo());
  __syncthreads();
  // 6. Transposed up pass along y into the tile's in-range dx.
  down_pass(s_t, e_pitch, 1, dx + (size_t)plane * g.in_h * g.in_w + (size_t)iy0 * g.in_w + ix0,
            g.in_w, 1, cols, rows, s_fur, g.fu_taps, g.up, StoreTo());
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
  // The whole plane in one block where it fits, else kTile, halved until
  // the buffers fit.
  set_tile(g, in_h, in_w);
  if (smem_bytes(g) > kPlaneSmem) {
    int tile = kTile;
    set_tile(g, tile, tile);
    while (tile > kMinTile && smem_bytes(g) > kSmemBudget) {
      tile /= 2;
      set_tile(g, tile, tile);
    }
  }

  const long long blocks = (long long)planes * g.tiles_per_plane;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(g);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flrelu_f32_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  flrelu_f32_bwd_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
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

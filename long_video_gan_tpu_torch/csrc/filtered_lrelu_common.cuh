// Helpers shared by the filtered_lrelu kernels of filtered_lrelu_exact.cu
// and filtered_lrelu_polyphase.cu (and, for the error string, of
// filtered_lrelu_tc.cuh): type conversion,
// index arithmetic, patch loads, the launch and the error string of their
// plain C interface. Every kernel takes per axis
//   up pass:    u[r] = sum_k fu[k] * z[r + k - pad0],  z[i*up] = x[i], else 0;
//   down pass:  o[r] = sum_k fd[k] * a[r*down + k],
// with the taps `fu` (flipped, times `up`) and `fd` (flipped) from the wrapper.
#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lvg {

constexpr int kThreads = 256;  // threads per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__host__ __device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return -floor_div(-a, b); }

__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// rows x cols patch at (r0, c0) of an h x w map, zero outside it, as f32.
template <typename T>
__device__ __forceinline__ void load_patch(float* dst, const T* src, int r0, int c0, int rows,
                                           int cols, int h, int w) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    const int r = idx / cols, c = idx - r * cols;
    const int gy = r0 + r, gx = c0 + c;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) v = to_f32(src[(size_t)gy * w + gx]);
    dst[idx] = v;
  }
}

// The output size contract of ops/filtered_lrelu.py `output_size`.
inline bool sizes_agree(int in_h, int in_w, int out_h, int out_w, int up, int down, int px0,
                        int px1, int py0, int py1, int fu_taps, int fd_taps) {
  if (in_h < 1 || in_w < 1 || up < 1 || down < 1 || fu_taps < 1 || fd_taps < 1) return false;
  const int hu = in_h * up + py0 + py1 - fu_taps + 1;
  const int wu = in_w * up + px0 + px1 - fu_taps + 1;
  return hu >= fd_taps && wu >= fd_taps && out_h == (hu - fd_taps) / down + 1 &&
         out_w == (wu - fd_taps) / down + 1;
}

// `blocks` blocks of kThreads threads with `smem` bytes of dynamic shared
// memory on `stream`; the launch's own error, if any.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), long long blocks, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (blocks < 1) return cudaErrorInvalidValue;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace lvg

// Arguments of every forward C function: x, y: [planes, in_h, in_w] /
// [planes, out_h, out_w], contiguous, one type; taps: device f32
// [fu_taps + fd_taps]; clamp: +inf for none. They return a cudaError_t.
#define LVG_FWD_ARGS                                                                       \
  const void *x, void *y, int planes, int in_h, int in_w, int out_h, int out_w, int up,    \
      int down, int px0, int px1, int py0, int py1, const float *taps, int fu_taps,        \
      int fd_taps, float gain, float slope, float clamp, void *stream
#define LVG_FWD_PASS                                                                       \
  x, y, planes, in_h, in_w, out_h, out_w, up, down, px0, px1, py0, py1, taps, fu_taps,     \
      fd_taps, gain, slope, clamp, static_cast<cudaStream_t>(stream)

extern "C" const char* lvg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

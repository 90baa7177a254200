// filtered_lrelu forward (K1) and input gradient (K2) in bf16 on Hopper's
// tensor cores (sm_90a). Plain C interface, loaded with ctypes by
// ops/filtered_lrelu_cuda.py; f32 maps keep filtered_lrelu_fwd.cu and
// filtered_lrelu_bwd.cu.
//
// Replaces: long_video_gan_tpu/ops/pallas/filtered_lrelu_packed.py
// `_packed_fwd` and `_packed_bwd`. Same function, per plane X, stage for
// stage, with the TPU kernel's bf16 stores: the bodies of
// filtered_lrelu_tc.cuh at one bf16 part per operand, which K3a/K3b
// (filtered_lrelu_fused_tc.cu) share. ops/filtered_lrelu_bands.py holds the
// plain version.
//
// What bounds it: on the card's peaks, the bytes. The products' tap-exact
// multiply-adds take less time at the tensor cores' 989 TFLOP/s than reading
// the maps and writing the result once at 3.35 TB/s (selftest.bound). The f32
// kernels (filtered_lrelu_fwd.cu, filtered_lrelu_bwd.cu) issue every product
// as a scalar FMA with two shared-memory loads, runtime index math and
// strided (bank-conflicting) reads. The design is the header's.

#include "filtered_lrelu_tc.cuh"

namespace {

__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSM)
filtered_lrelu_fwd_tc_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                             const bf16* __restrict__ ops, const int* __restrict__ win,
                             FwdParams p, float gain, float slope, float clamp) {
  fwd_tc<bf16, 1, kFwdGroup>(x, y, ops, win, p, gain, slope, clamp);
}

__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSM)
filtered_lrelu_bwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                             bf16* __restrict__ dx, const bf16* __restrict__ ops,
                             const int* __restrict__ win, BwdParams p, float gain, float slope,
                             float clamp, int has_clamp) {
  bwd_tc<bf16, 1, kBwdGroup>(x, dy, dx, ops, win, p, gain, slope, clamp, has_clamp);
}

// K2 that also stores each tile's U (check-only: selftest holds the plain
// version to the kernel's own act' decisions with it).
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSM)
filtered_lrelu_bwd_tc_u_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                               bf16* __restrict__ dx, const bf16* __restrict__ ops,
                               const int* __restrict__ win, BwdParams p, float gain, float slope,
                               float clamp, int has_clamp, float* __restrict__ u) {
  bwd_tc<bf16, 1, kBwdGroup, true>(x, dy, dx, ops, win, p, gain, slope, clamp, has_clamp, u);
}

}  // namespace

// x [planes, in_h, in_w] -> y [planes, out_h, out_w], bf16, contiguous. ops:
// the operator blocks (bf16), win: their K-windows (int32), both on the
// device; params: host ints in FwdParams' order. clamp: +inf for none.
extern "C" int lvg_tc_fwd(const void* x, void* y, const void* ops, const void* win,
                          const int* params, int n_params, float gain, float slope, float clamp,
                          void* stream) {
  return launch_fwd_tc<bf16, 1>(filtered_lrelu_fwd_tc_kernel, x, y, ops, win, params, n_params,
                                gain, slope, clamp, stream);
}

// dy [planes, out_h, out_w], x and dx [planes, in_h, in_w], bf16, contiguous;
// ops, win, params as for lvg_tc_fwd (BwdParams' order). has_clamp = 0 for
// no clamp.
extern "C" int lvg_tc_bwd(const void* x, const void* dy, void* dx, const void* ops,
                          const void* win, const int* params, int n_params, float gain,
                          float slope, float clamp, int has_clamp, void* stream) {
  return launch_bwd_tc<bf16, 1>(filtered_lrelu_bwd_tc_kernel, x, dy, dx, ops, win, params,
                                n_params, gain, slope, clamp, has_clamp, stream);
}

// lvg_tc_bwd that also writes U, as act' takes it, to u: f32 [tiles][rp][rp],
// tiles in (plane, tile row, tile column) order. Check-only.
extern "C" int lvg_tc_bwd_u(const void* x, const void* dy, void* dx, void* u, const void* ops,
                            const void* win, const int* params, int n_params, float gain,
                            float slope, float clamp, int has_clamp, void* stream) {
  return launch_bwd_tc<bf16, 1>(filtered_lrelu_bwd_tc_u_kernel, x, dy, dx, ops, win, params,
                                n_params, gain, slope, clamp, has_clamp, stream,
                                static_cast<float*>(u));
}

// filtered_lrelu forward (K3a) and input gradient (K3b) of impl "fused", on
// Hopper's tensor cores (sm_90a), for bf16 and f32 maps whose bias is already
// added. Plain C interface, loaded with ctypes by ops/filtered_lrelu_fused.py.
//
// Replaces: long_video_gan_tpu/ops/pallas/filtered_lrelu_fused.py
// `_fused_fwd` and `_fused_bwd` (the whole-image Pallas kernels, joined by
// the `_fused_op` custom VJP). They compute the packed kernels' function
// (they differ from them only in the TPU's lane layout), so:
// - bf16 maps (L3-L13 of the 144x256 plan): the bodies of K1/K2
//   (filtered_lrelu_tc.cuh, one bf16 part per operand), bf16 operators and
//   stores of t1, Z, t3 (t1, s1, dU, dt1), sums in f32;
// - f32 maps (the f32 head layers L0-L2, where the TPU kernel asks its MXU
//   for Precision.HIGHEST): the same bodies with every operand in three
//   bf16 parts, six partial products per product, f32 stages (the header
//   says how). A single bf16 or TF32 pass would compute another function.
// ops/filtered_lrelu_bands.py holds the plain version of both.
//
// What bounds it: the bytes in bf16, as K1/K2. In f32 the six bf16 passes
// run at a sixth of the bf16 peak (selftest.SPLIT_F32_FLOPS), so at L0-L2
// the bytes bound both kernels too. At L0-L2 a 29x36 output plane takes two
// 32x32 tiles, the second 4 columns wide: one tile over the plane (48x48, or
// 32x48) would need about 240 KB of shared memory with three bf16 planes per
// stage and operator, over a block's 227 KB, so the f32 kernels take the
// bf16 kernels' plans (T = 32) at one block per SM. The f32 backward at
// up 4 takes T = 16 (the wrapper's `tile_for`): at 32 its stages would not
// fit.
//
// The kernels have names of their own, so that a trace tells them from
// K1/K2: filtered_lrelu_fused_{fwd,bwd}_tc_kernel<T> for T = __nv_bfloat16
// and float.

#include "filtered_lrelu_tc.cuh"

namespace {

template <typename T> struct FusedCfg;  // parts per operand, group, blocks per SM
template <> struct FusedCfg<bf16> {
  static constexpr int kS = 1, kFwdG = kFwdGroup, kFwdSM = kFwdBlocksPerSM, kBwdG = kBwdGroup,
                       kBwdSM = kBwdBlocksPerSM;
};
template <> struct FusedCfg<float> {
  static constexpr int kS = 3, kFwdG = 2, kFwdSM = 1, kBwdG = 4, kBwdSM = 1;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, FusedCfg<T>::kFwdSM)
filtered_lrelu_fused_fwd_tc_kernel(const T* __restrict__ x, T* __restrict__ y,
                                   const bf16* __restrict__ ops, const int* __restrict__ win,
                                   FwdParams p, float gain, float slope, float clamp) {
  fwd_tc<T, FusedCfg<T>::kS, FusedCfg<T>::kFwdG>(x, y, ops, win, p, gain, slope, clamp);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, FusedCfg<T>::kBwdSM)
filtered_lrelu_fused_bwd_tc_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                   T* __restrict__ dx, const bf16* __restrict__ ops,
                                   const int* __restrict__ win, BwdParams p, float gain,
                                   float slope, float clamp, int has_clamp) {
  bwd_tc<T, FusedCfg<T>::kS, FusedCfg<T>::kBwdG>(x, dy, dx, ops, win, p, gain, slope, clamp,
                                                   has_clamp);
}

// K3b that also stores each tile's U (check-only; f32 maps: after the small
// partial products are added, as act' takes it).
template <typename T>
__global__ void __launch_bounds__(kThreads, FusedCfg<T>::kBwdSM)
filtered_lrelu_fused_bwd_tc_u_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                     T* __restrict__ dx, const bf16* __restrict__ ops,
                                     const int* __restrict__ win, BwdParams p, float gain,
                                     float slope, float clamp, int has_clamp,
                                     float* __restrict__ u) {
  bwd_tc<T, FusedCfg<T>::kS, FusedCfg<T>::kBwdG, true>(x, dy, dx, ops, win, p, gain, slope,
                                                         clamp, has_clamp, u);
}

}  // namespace

// As lvg_tc_fwd / lvg_tc_bwd (filtered_lrelu_tc.cu), for maps of the named
// type; for f32 maps `ops` holds the three bf16 parts of the f32 operator
// blocks, one after another, each of ops_elems.
#define LVG_FUSED_TC_FWD(suffix, T)                                                          \
  extern "C" int lvg_fused_tc_fwd_##suffix(const void* x, void* y, const void* ops,          \
                                           const void* win, const int* params, int n_params, \
                                           float gain, float slope, float clamp,             \
                                           void* stream) {                                   \
    return launch_fwd_tc<T, FusedCfg<T>::kS>(filtered_lrelu_fused_fwd_tc_kernel<T>, x, y,    \
                                             ops, win, params, n_params, gain, slope, clamp, \
                                             stream);                                        \
  }
#define LVG_FUSED_TC_BWD(suffix, T)                                                            \
  extern "C" int lvg_fused_tc_bwd_##suffix(const void* x, const void* dy, void* dx,            \
                                           const void* ops, const void* win,                   \
                                           const int* params, int n_params, float gain,        \
                                           float slope, float clamp, int has_clamp,            \
                                           void* stream) {                                     \
    return launch_bwd_tc<T, FusedCfg<T>::kS>(filtered_lrelu_fused_bwd_tc_kernel<T>, x, dy, dx, \
                                             ops, win, params, n_params, gain, slope, clamp,   \
                                             has_clamp, stream);                               \
  }

// As lvg_fused_tc_bwd_*, also writing each tile's U to u (lvg_tc_bwd_u's
// layout). Check-only.
#define LVG_FUSED_TC_BWD_U(suffix, T)                                                          \
  extern "C" int lvg_fused_tc_bwd_u_##suffix(const void* x, const void* dy, void* dx, void* u, \
                                             const void* ops, const void* win,                 \
                                             const int* params, int n_params, float gain,      \
                                             float slope, float clamp, int has_clamp,          \
                                             void* stream) {                                   \
    return launch_bwd_tc<T, FusedCfg<T>::kS>(filtered_lrelu_fused_bwd_tc_u_kernel<T>, x, dy,   \
                                             dx, ops, win, params, n_params, gain, slope,      \
                                             clamp, has_clamp, stream, static_cast<float*>(u)); \
  }

LVG_FUSED_TC_FWD(bf16, bf16)
LVG_FUSED_TC_FWD(f32, float)
LVG_FUSED_TC_BWD(bf16, bf16)
LVG_FUSED_TC_BWD(f32, float)
LVG_FUSED_TC_BWD_U(bf16, bf16)
LVG_FUSED_TC_BWD_U(f32, float)

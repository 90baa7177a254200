// The f32-exact filtered_lrelu forwards K4 (impl "pallas") and K5
// (filtered_lrelu_pallas_v2) on Hopper's tensor cores (sm_90a), for bf16 and
// f32 maps whose bias is already added. Plain C interface, loaded with ctypes
// by ops/filtered_lrelu_exact.py (K4) and ops/filtered_lrelu_polyphase.py (K5).
//
// Replaces: long_video_gan_tpu/ops/pallas/filtered_lrelu_kernel.py
// `_filtered_lrelu_pallas` (K4) and ops/pallas/filtered_lrelu_v2.py
// `_filtered_lrelu_pallas_v2` (K5). Both compute, per plane X [H, W],
//   t1 = Au . X;  U = t1 . Bu^T;  Z = act(U);  t3 = Z . Bd^T;  out = Ad . t3
// with every product and stage in f32 (the TPU kernels' Precision.HIGHEST;
// K5's products, which name no precision, are exact f32 in interpret mode,
// the run the port is held to) and only the output rounded to the maps' type.
// So one body serves both (K5 takes up and down in {1, 2} only, which its
// wrapper checks); the kernels have names of their own, so that a trace tells
// them apart: filtered_lrelu_{exact,polyphase}_tc_kernel<T> for
// T = __nv_bfloat16 and float.
//
// The body is K3a's f32 one (filtered_lrelu_tc.cuh, kS = 3): operators,
// stages and f32 patches in three bf16 parts, six partial products per
// product, hi.hi in its own accumulator. A bf16 patch is exact in one part,
// so on bf16 maps t1 = Au . X takes three partial products, the stages stay
// f32 in three parts (where K3a rounds them to bf16), and the output alone
// rounds to bf16. ops/filtered_lrelu_bands.py `split_matmul` is the CPU
// emulation of these products; the plain version is the composed op in f32.
//
// What bounds it: the bytes (selftest.bound, at selftest.SPLIT_F32_FLOPS for
// the six bf16 passes), as for K3a's f32 layers. Three parts per operator and
// stage take 124 KB of shared memory at the 144x256 plan's layers in bf16 and
// 138 KB in f32, so one block runs per SM, and a tile's dependent chains of
// ldmatrix and MMAs (five partial products into one accumulator per K-block)
// are what a tile waits on. So the block has 16 warps, not K3a's 8, and each
// warp takes one block of the other operand (no group): twice the warps and
// items in flight to hide that latency: on the H100 that cut K4's time at
// the plan's layers by about a quarter against K3a's f32 configuration (8
// warps, groups of two; scripts/torch_exact_sweep.py, PERF.md).

#include "filtered_lrelu_tc.cuh"

namespace {

// Three bf16 parts per operand, no grouping, one block per SM (the
// shared-memory footprint allows no more) of kExactWarps warps.
constexpr int kExactS = 3, kExactG = 1, kExactWarps = 16;

template <typename T>
__global__ void __launch_bounds__(32 * kExactWarps, 1)
filtered_lrelu_exact_tc_kernel(const T* __restrict__ x, T* __restrict__ y,
                               const bf16* __restrict__ ops, const int* __restrict__ win,
                               FwdParams p, float gain, float slope, float clamp) {
  fwd_tc<T, kExactS, kExactG, kExactWarps>(x, y, ops, win, p, gain, slope, clamp);
}

template <typename T>
__global__ void __launch_bounds__(32 * kExactWarps, 1)
filtered_lrelu_polyphase_tc_kernel(const T* __restrict__ x, T* __restrict__ y,
                                   const bf16* __restrict__ ops, const int* __restrict__ win,
                                   FwdParams p, float gain, float slope, float clamp) {
  fwd_tc<T, kExactS, kExactG, kExactWarps>(x, y, ops, win, p, gain, slope, clamp);
}

}  // namespace

// As lvg_tc_fwd (filtered_lrelu_tc.cu), for maps of the named type; `ops`
// holds the three bf16 parts of the f32 operator blocks, one after another,
// each of ops_elems.
#define LVG_EXACT_TC_FWD(entry, kernel, suffix, T)                                            \
  extern "C" int entry##_##suffix(const void* x, void* y, const void* ops, const void* win,   \
                                  const int* params, int n_params, float gain, float slope,   \
                                  float clamp, void* stream) {                                \
    return launch_fwd_tc<T, kExactS, kExactWarps>(kernel<T>, x, y, ops, win, params, n_params, \
                                                  gain, slope, clamp, stream);                 \
  }

LVG_EXACT_TC_FWD(lvg_exact_tc_fwd, filtered_lrelu_exact_tc_kernel, bf16, bf16)
LVG_EXACT_TC_FWD(lvg_exact_tc_fwd, filtered_lrelu_exact_tc_kernel, f32, float)
LVG_EXACT_TC_FWD(lvg_polyphase_tc_fwd, filtered_lrelu_polyphase_tc_kernel, bf16, bf16)
LVG_EXACT_TC_FWD(lvg_polyphase_tc_fwd, filtered_lrelu_polyphase_tc_kernel, f32, float)

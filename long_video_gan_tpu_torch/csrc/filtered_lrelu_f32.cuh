// The separable f32 passes of filtered_lrelu_fwd.cu and filtered_lrelu_bwd.cu:
// one-axis polyphase FIRs between shared-memory buffers, every product and
// sum an f32 FMA.
//
// A pass runs along one axis of an [across][along] buffer (strides given,
// so one function serves rows and columns). A thread takes one row (column)
// and kR neighbouring outputs on it, from inputs held in registers: each
// input load serves up to kR FMAs of a phase. Where the factor and the tap
// count are the sres plan's (2 and 12), they are compiled in: the taps sit
// in registers and the kR + NT - 1 inputs of an item load once for every
// phase; other factors and tap counts slide a window of kR inputs over a
// runtime tap loop (each broadcast tap load serves kR FMAs). Neighbouring
// threads take neighbouring rows (columns), so a pass along x wants an odd
// row pitch and a pass along y none. The first tap of each phase is the
// phase itself, and items are dealt without a division: no integer division
// in a tap or item loop.

#pragma once

#include <cstddef>

namespace lvg_f32 {

constexpr int kThreads = 256;               // threads per block
constexpr int kR = 4;                       // outputs per thread item
constexpr int kTile = 32;                   // tile edge of planes too large for one block
constexpr size_t kPlaneSmem = 64 * 1024;    // a plane takes one block up to this

__host__ __device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return -floor_div(-a, b); }

__host__ __device__ __forceinline__ int round_up(int a, int b) { return ceil_div(a, b) * b; }

// Inputs along its axis that an `up_pass` of n_out outputs at factor S, nt
// taps a phase, reads (for any q).
__host__ __device__ __forceinline__ int up_reads(int n_out, int S, int nt) {
  return round_up(ceil_div(n_out - 1, S) + 1, kR) + nt - 1;
}

// Inputs along its axis that a `down_pass` of n_out outputs at factor S, nt
// taps a phase, reads.
__host__ __device__ __forceinline__ int down_reads(int n_out, int S, int nt) {
  return (round_up(n_out, kR) + nt - 1) * S;
}

struct StoreTo {
  __device__ __forceinline__ void operator()(float* p, float v) const { *p = v; }
};

// [rows][cols] of `src` [h][w] from (r0, c0) into `dst` (row pitch `pitch`),
// zero outside the map.
__device__ __forceinline__ void load_patch(float* dst, int rows, int cols, int pitch,
                                           const float* __restrict__ src, int h, int w, int r0,
                                           int c0) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    const int r = idx / cols, c = idx - r * cols;
    const int gy = r0 + r, gx = c0 + c;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) v = __ldg(src + (size_t)gy * w + gx);
    dst[r * pitch + c] = v;
  }
}

// The items of a pass, (row a, block b) for a in [0, n) and b in [0,
// blocks), dealt to the block's threads in turn: item = a + n * b, walked
// in steps of blockDim.x without a division per item.
struct Items {
  int n, a, b, da, db;
  __device__ __forceinline__ explicit Items(int n_across)
      : n(n_across), a(threadIdx.x % n_across), b(threadIdx.x / n_across),
        da(blockDim.x % n_across), db(blockDim.x / n_across) {}
  __device__ __forceinline__ void next() {
    a += da;
    b += db;
    if (a >= n) {
      a -= n;
      ++b;
    }
  }
};

// Zero-stuffed FIR: out[c] = sum_k f[k] * z[j0 + c + k] for c in [0, n_out),
// z the input zero-stuffed by S (z[(i0 + i) * S] = in[i]), q = i0 * S - j0 in
// [0, S). Per phase p, out[q + m*S - p] = sum_t f[p + t*S] * in[m + t]: the
// taps that meet a nonzero, in increasing order. Each of n_across rows.
// Any S and tap count: a runtime loop over the taps.
template <class Store>
__device__ __forceinline__ void up_pass_any(const float* __restrict__ in, int in_along,
                                            int in_across, float* out, int out_along,
                                            int out_across, int n_across, int n_out, int q,
                                            const float* __restrict__ f, int nf, int S,
                                            Store store) {
  const int blocks = ceil_div(ceil_div(n_out - 1 - q, S) + 1, kR);
  for (Items it(n_across); it.b < blocks; it.next()) {
    const int m0 = it.b * kR;
    const float* src = in + it.a * in_across + m0 * in_along;
    float* dst = out + it.a * out_across;
    float first[kR - 1];
#pragma unroll
    for (int i = 0; i < kR - 1; ++i) first[i] = src[i * in_along];
    for (int p = 0; p < S && p < nf; ++p) {
      float acc[kR], w[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < kR - 1; ++i) w[i] = first[i];
      const float* s = src + (kR - 1) * in_along;
      for (int k = p; k < nf; k += S, s += in_along) {
        w[kR - 1] = *s;
        const float fk = f[k];
#pragma unroll
        for (int i = 0; i < kR; ++i) acc[i] = fmaf(fk, w[i], acc[i]);
#pragma unroll
        for (int i = 0; i < kR - 1; ++i) w[i] = w[i + 1];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int c = q + (m0 + i) * S - p;
        if (c >= 0 && c < n_out) store(dst + c * out_along, acc[i]);
      }
    }
  }
}

// `up_pass_any` for S and NF known when compiled: the taps in registers, the
// kR + NT - 1 inputs of an item loaded once for all S phases, every loop
// unrolled. The same sums in the same order, so the same bits.
template <int S, int NF, class Store>
__device__ __forceinline__ void up_pass_fixed(const float* __restrict__ in, int in_along,
                                              int in_across, float* out, int out_along,
                                              int out_across, int n_across, int n_out, int q,
                                              const float* __restrict__ f, Store store) {
  constexpr int NT = (NF + S - 1) / S;
  float tap[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) tap[k] = f[k];
  const int blocks = ceil_div(ceil_div(n_out - 1 - q, S) + 1, kR);
  for (Items it(n_across); it.b < blocks; it.next()) {
    const int m0 = it.b * kR;
    const float* src = in + it.a * in_across + m0 * in_along;
    float* dst = out + it.a * out_across;
    float v[kR + NT - 1];
#pragma unroll
    for (int i = 0; i < kR + NT - 1; ++i) v[i] = src[i * in_along];
#pragma unroll
    for (int p = 0; p < S; ++p) {
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < NT; ++t)
          if (p + t * S < NF) acc = fmaf(tap[p + t * S], v[i + t], acc);
        const int c = q + (m0 + i) * S - p;
        if (c >= 0 && c < n_out) store(dst + c * out_along, acc);
      }
    }
  }
}

template <class Store>
__device__ __forceinline__ void up_pass(const float* __restrict__ in, int in_along, int in_across,
                                        float* out, int out_along, int out_across, int n_across,
                                        int n_out, int q, const float* __restrict__ f, int nf,
                                        int S, Store store) {
  if (S == 2 && nf == 12)   // the sres plan's up-2 layers and down^T passes
    up_pass_fixed<2, 12>(in, in_along, in_across, out, out_along, out_across, n_across, n_out,
                         q, f, store);
  else
    up_pass_any(in, in_along, in_across, out, out_along, out_across, n_across, n_out, q, f, nf,
                S, store);
}

// Decimating FIR: out[c] = sum_k f[k] * in[c*S + k] for c in [0, n_out),
// summed phase by phase: sum_p sum_t f[p + t*S] * in[(c + t)*S + p]. Each of
// n_across rows. Any S and tap count.
template <class Store>
__device__ __forceinline__ void down_pass_any(const float* __restrict__ in, int in_along,
                                              int in_across, float* out, int out_along,
                                              int out_across, int n_across, int n_out,
                                              const float* __restrict__ f, int nf, int S,
                                              Store store) {
  const int blocks = ceil_div(n_out, kR);
  const int step = S * in_along;
  for (Items it(n_across); it.b < blocks; it.next()) {
    const int c0 = it.b * kR;
    const float* src = in + it.a * in_across + c0 * step;
    float acc[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) acc[i] = 0.f;
    for (int p = 0; p < S && p < nf; ++p, src += in_along) {
      float w[kR];
#pragma unroll
      for (int i = 0; i < kR - 1; ++i) w[i] = src[i * step];
      const float* s = src + (kR - 1) * step;
      for (int k = p; k < nf; k += S, s += step) {
        w[kR - 1] = *s;
        const float fk = f[k];
#pragma unroll
        for (int i = 0; i < kR; ++i) acc[i] = fmaf(fk, w[i], acc[i]);
#pragma unroll
        for (int i = 0; i < kR - 1; ++i) w[i] = w[i + 1];
      }
    }
    float* dst = out + it.a * out_across;
#pragma unroll
    for (int i = 0; i < kR; ++i)
      if (c0 + i < n_out) store(dst + (c0 + i) * out_along, acc[i]);
  }
}

// `down_pass_any` for S and NF known when compiled (see `up_pass_fixed`).
template <int S, int NF, class Store>
__device__ __forceinline__ void down_pass_fixed(const float* __restrict__ in, int in_along,
                                                int in_across, float* out, int out_along,
                                                int out_across, int n_across, int n_out,
                                                const float* __restrict__ f, Store store) {
  constexpr int NT = (NF + S - 1) / S;
  float tap[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) tap[k] = f[k];
  const int blocks = ceil_div(n_out, kR);
  const int step = S * in_along;
  for (Items it(n_across); it.b < blocks; it.next()) {
    const int c0 = it.b * kR;
    const float* src = in + it.a * in_across + c0 * step;
    float acc[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) acc[i] = 0.f;
#pragma unroll
    for (int p = 0; p < S; ++p) {
      float v[kR + NT - 1];
#pragma unroll
      for (int i = 0; i < kR + NT - 1; ++i) v[i] = src[i * step + p * in_along];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int t = 0; t < NT; ++t)
          if (p + t * S < NF) acc[i] = fmaf(tap[p + t * S], v[i + t], acc[i]);
    }
    float* dst = out + it.a * out_across;
#pragma unroll
    for (int i = 0; i < kR; ++i)
      if (c0 + i < n_out) store(dst + (c0 + i) * out_along, acc[i]);
  }
}

template <class Store>
__device__ __forceinline__ void down_pass(const float* __restrict__ in, int in_along,
                                          int in_across, float* out, int out_along,
                                          int out_across, int n_across, int n_out,
                                          const float* __restrict__ f, int nf, int S,
                                          Store store) {
  if (S == 2 && nf == 12)   // the sres plan's down passes and up-2 up^T passes
    down_pass_fixed<2, 12>(in, in_along, in_across, out, out_along, out_across, n_across, n_out,
                           f, store);
  else
    down_pass_any(in, in_along, in_across, out, out_along, out_across, n_across, n_out, f, nf,
                  S, store);
}

}  // namespace lvg_f32

// filtered_lrelu forward (K1) and input gradient (K2) in bf16 on Hopper's
// tensor cores (sm_90a). Plain C interface, loaded with ctypes by
// ops/filtered_lrelu_cuda.py; f32 maps keep filtered_lrelu_fwd.cu and
// filtered_lrelu_bwd.cu.
//
// Replaces: long_video_gan_tpu/ops/pallas/filtered_lrelu_packed.py
// `_packed_fwd` and `_packed_bwd`. Same function, per plane X, stage for stage:
//   t1 = Au . X,  Z = act(t1 . Bu^T),  t3 = Z . Bd^T,  out = Ad . t3;
//   t1 = Au . X,  s1 = Ad^T . dY,  dU = (s1 . Bd) * act'(t1 . Bu^T),
//   dt1 = dU . Bu,  dX = Au^T . dt1;
// operators, t1, Z, t3 (t1, s1, dU, dt1) and the result in bf16, every sum in
// f32: the TPU kernel's stores, and what bf16 tensor-core operands round to
// anyway. ops/filtered_lrelu_bands.py holds the plain version.
//
// What bounds it: on the card's peaks, the bytes. The products' tap-exact
// multiply-adds take less time at the tensor cores' 989 TFLOP/s than reading
// the maps and writing the result once at 3.35 TB/s (selftest.bound). The f32
// kernels (filtered_lrelu_fwd.cu, filtered_lrelu_bwd.cu) issue every product
// as a scalar FMA with two shared-memory loads, runtime index math and
// strided (bank-conflicting) reads.
//
// Design:
// - One T x T output (dX) tile per step (the wrapper takes T = 32).
//   A tile's supersampled window starts at a multiple of `up` (T*down, resp.
//   T*up/down, is a whole number of periods), so the block of each operator
//   that a tile reads is the same for every tile: the host builds the blocks
//   and their band K-windows once per geometry, each block copies them to
//   shared memory once, and patches are zero-filled outside the map.
// - All products are dense products of these blocks on the tensor cores:
//   mma.sync.aligned.m16n8k16 bf16 -> f32 (not wgmma), fragments by ldmatrix.
//   A warp takes one 16-row block of the banded operand, whose window (a fixed
//   number of 16-wide K-blocks, 2-3 of up to 10 at the plan's layers) skips
//   the zeros outside the band, and a group of blocks of the other operand
//   that reuse its fragment.
// - The activation (forward) and act'(U) * dZ (backward: U and dZ of the
//   same blocks in one warp, so U never leaves registers) work on the
//   accumulator fragments; stages are stored to shared memory as bf16 pairs.
//   Row strides are 8 mod 16 elements, so ldmatrix rows and pair stores hit
//   distinct banks.
// - A persistent grid (blocks per SM from the occupancy of the footprint)
//   walks (plane, tile); the next tile's patches load with cp.async (4-byte
//   words, zero-fill outside the map) while this tile's products run. TMA
//   would need 16-byte multiples as row strides; the bf16 maps' rows here are
//   76, 108, 172, 300 and 556 bytes. Outputs go out through shared memory as
//   bf16 pairs, neighbouring threads on neighbouring pairs, so global stores
//   coalesce.
// - On the H100 (PERF.md) the tensor cores are not what limits it: builds
//   without the MMAs took most of the time still. Per-tile latency, barriers
//   and patch loads do, which is why occupancy paid and wider or interleaved
//   items did not.

#include <cstdint>
#include <cstring>

#include "filtered_lrelu_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct OpRef {
  // Element offset in the operator buffer, row stride, first window entry,
  // window width in K-blocks.
  int off, ld, win, kb;
};

// Host int arrays of ops/filtered_lrelu_cuda.py `_tc_params`, in this order.
struct FwdParams {
  int planes, in_h, in_w, out_h, out_w;
  int tile, rp, pp, step, base_y, base_x, aligned;
  OpRef au_y, au_x, ad_y, ad_x;
  int ops_elems, n_win;
};

struct BwdParams {
  int planes, in_h, in_w, out_h, out_w;
  int tile, rp, px, pd, dstep, xbase_y, xbase_x, dbase_y, dbase_x, x_aligned, d_aligned;
  OpRef au_y, au_x, adt_y, adt_x, aut_y, aut_x;
  int ops_elems, n_win;
};

__host__ __device__ __forceinline__ int ld_of(int cols) { return (cols + 15) / 16 * 16 + 8; }
__host__ __device__ __forceinline__ int align16(int bytes) { return (bytes + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Lane addresses (bytes, shared space) of ldmatrix.x4 fragments. A is
// row-major [M][lda]: the m16 x k16 block at (m0, k0). B is stored [K][ldb]
// (KN: read transposed) or [N][ldb] (NK: the operator's own rows): the
// k16 x n16 block at (k0, n0), as two n8 fragments.
__device__ __forceinline__ uint32_t a_frag(const bf16* A, int lda, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  return smem_u32(A + (m0 + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
}

template <bool kKN>
__device__ __forceinline__ uint32_t b_frag(const bf16* B, int ldb, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const int r8 = (lane & 7) + ((lane >> 3) & 1) * 8, c8 = (lane >> 4) * 8;  // KN: k, n
  const int n8 = (lane & 7) + (lane >> 4) * 8, k8 = ((lane >> 3) & 1) * 8;  // NK: n, k
  return kKN ? smem_u32(B + (k0 + r8) * ldb + n0 + c8) : smem_u32(B + (n0 + n8) * ldb + k0 + k8);
}

template <bool kKN>
__device__ __forceinline__ void ldsm_b(uint32_t (&r)[4], uint32_t addr) {
  if (kKN)
    ldsm_x4_trans(r, addr);
  else
    ldsm_x4(r, addr);
}

__device__ __forceinline__ void mma_16x16(float (&c)[2][4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[4]) {
  mma_bf16(c[0], a, b[0], b[1]);
  mma_bf16(c[1], a, b[2], b[3]);
}

// Blocks of the other operand that share a band fragment, and blocks per SM
// the register budget leaves room for (measured on the H100 at the 144x256
// plan's layers: the forward is fastest at four 8-warp blocks per SM, the
// backward, with twice the live accumulators, at two).
constexpr int kFwdGroup = 2, kFwdBlocksPerSM = 4;
constexpr int kBwdGroup = 4, kBwdBlocksPerSM = 2;

// The fragment's (row, col) of acc[j][e]: rows m0 + g (+8 for e >= 2), cols
// n0 + 8j + 2t (+1 for odd e), g = lane / 4, t = lane % 4.
__device__ __forceinline__ void store_item(bf16* C, int ldc, int m0, int n0,
                                           const float (&v)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    bf16* c = C + (m0 + g) * ldc + n0 + 8 * j + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(c) = __floats2bfloat162_rn(v[j][0], v[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(c + 8 * ldc) = __floats2bfloat162_rn(v[j][2], v[j][3]);
  }
}

// C = A . B over an mblocks x nblocks grid of m16 x n16 blocks. `op` is the
// banded operand (A if kBandOfA, else B, stored NK); its op.kb-wide window
// depends only on its own 16-row block. A warp takes one band block and up to
// kG blocks of the other operand: per K-block the band fragment loads once and
// serves the group. epi(m0, n0, acc) stores a block.
template <int kG, bool kKN, bool kBandOfA, typename Epilogue>
__device__ __forceinline__ void product(const bf16* A, int lda, const bf16* B, int ldb,
                                        int mblocks, int nblocks, const int* s_win,
                                        const OpRef& op, Epilogue epi) {
  const int bands = kBandOfA ? mblocks : nblocks, others = kBandOfA ? nblocks : mblocks;
  const int groups = (others + kG - 1) / kG;
  for (int item = threadIdx.x >> 5; item < bands * groups; item += kWarps) {
    const int band = item / groups, g0 = (item - band * groups) * kG;
    const int count = min(kG, others - g0);
    const int k0 = 16 * s_win[op.win + band];
    float acc[kG][2][4] = {};
    for (int kb = 0; kb < op.kb; ++kb) {
      const int k = k0 + 16 * kb;
      uint32_t fixed[4], other[4];
      if (kBandOfA)
        ldsm_x4(fixed, a_frag(A, lda, 16 * band, k));
      else
        ldsm_b<kKN>(fixed, b_frag<kKN>(B, ldb, k, 16 * band));
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g < count) {
          if (kBandOfA) {
            ldsm_b<kKN>(other, b_frag<kKN>(B, ldb, k, 16 * (g0 + g)));
            mma_16x16(acc[g], fixed, other);
          } else {
            ldsm_x4(other, a_frag(A, lda, 16 * (g0 + g), k));
            mma_16x16(acc[g], other, fixed);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g)
      if (g < count)
        epi(16 * (kBandOfA ? band : g0 + g), 16 * (kBandOfA ? g0 + g : band), acc[g]);
  }
}

// size x size patch of the h x w plane `src` at (r0, c0) into dst [size][ld],
// zero outside the plane. `aligned`: w even, c0 even and src 4-byte aligned,
// so bf16 pairs load as 4-byte cp.async words (the caller commits); else a
// synchronous copy, element by element.
__device__ __forceinline__ void load_patch(bf16* dst, int ld, const bf16* src, int r0, int c0,
                                           int size, int h, int w, bool aligned) {
  if (aligned) {
    const int half = size / 2;
    for (int idx = threadIdx.x; idx < size * half; idx += blockDim.x) {
      const int r = idx / half, c = 2 * (idx - r * half);
      const int gy = r0 + r, gx = c0 + c;
      const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < w;
      cp_async4(dst + r * ld + c, ok ? src + (size_t)gy * w + gx : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < size * size; idx += blockDim.x) {
      const int r = idx / size, c = idx - r * size;
      const int gy = r0 + r, gx = c0 + c;
      const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < w;
      dst[r * ld + c] = ok ? src[(size_t)gy * w + gx] : __float2bfloat16_rn(0.f);
    }
  }
}

// rows x cols of the staged tile [tile][ld] to the h x w plane `dst` at (r0, c0).
__device__ __forceinline__ void store_tile(bf16* dst, const bf16* s, int ld, int tile, int r0,
                                           int c0, int h, int w) {
  const int rows = min(tile, h - r0), cols = min(tile, w - c0);
  if ((w & 1) == 0) {  // pairs: c0 and cols are even
    const int half = tile / 2;
    for (int idx = threadIdx.x; idx < rows * half; idx += blockDim.x) {
      const int r = idx / half, c = 2 * (idx - r * half);
      if (c < cols)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(r0 + r) * w + c0 + c) =
            *reinterpret_cast<const __nv_bfloat162*>(s + r * ld + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * tile; idx += blockDim.x) {
      const int r = idx / tile, c = idx - r * tile;
      if (c < cols) dst[(size_t)(r0 + r) * w + c0 + c] = s[r * ld + c];
    }
  }
}

// Operators and windows into shared memory (ops_elems is a multiple of 8).
__device__ __forceinline__ void load_ops(bf16* s_ops, int* s_win, const bf16* ops,
                                         const int* win, int ops_elems, int n_win) {
  for (int i = threadIdx.x; i < ops_elems / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(s_ops)[i] = reinterpret_cast<const uint4*>(ops)[i];
  for (int i = threadIdx.x; i < n_win; i += blockDim.x) s_win[i] = win[i];
}

struct FwdSmem {
  int win, ops, x, t, z, total;  // byte offsets of the regions, and the total
};

__host__ __device__ inline FwdSmem fwd_smem(const FwdParams& p) {
  FwdSmem s;
  s.win = 0;
  s.ops = align16(p.n_win * 4);
  s.x = s.ops + align16(p.ops_elems * 2);
  const int x_bytes = align16(p.pp * ld_of(p.pp) * 2);
  s.t = s.x + 2 * x_bytes;  // t1 [rp][ld(pp)], then t3 [rp][ld(T)]
  s.z = s.t + align16(lvg::imax(p.rp * ld_of(p.pp), p.rp * ld_of(p.tile)) * 2);
  // Z [rp][ld(rp)], then the output tile [T][ld(T)].
  s.total = s.z + align16(lvg::imax(p.rp * ld_of(p.rp), p.tile * ld_of(p.tile)) * 2);
  return s;
}

__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSM)
filtered_lrelu_fwd_tc_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                             const bf16* __restrict__ ops, const int* __restrict__ win,
                             FwdParams p, float gain, float slope, float clamp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdSmem L = fwd_smem(p);
  int* s_win = reinterpret_cast<int*>(smem + L.win);
  bf16* s_ops = reinterpret_cast<bf16*>(smem + L.ops);
  bf16* s_x = reinterpret_cast<bf16*>(smem + L.x);  // two patch buffers
  const int x_elems = align16(p.pp * ld_of(p.pp) * 2) / 2;
  bf16* s_t = reinterpret_cast<bf16*>(smem + L.t);
  bf16* s_z = reinterpret_cast<bf16*>(smem + L.z);
  const bf16* au_y = s_ops + p.au_y.off;
  const bf16* au_x = s_ops + p.au_x.off;
  const bf16* ad_y = s_ops + p.ad_y.off;
  const bf16* ad_x = s_ops + p.ad_x.off;
  const int T = p.tile, ld_x = ld_of(p.pp), ld_t1 = ld_of(p.pp), ld_z = ld_of(p.rp),
            ld_t = ld_of(T);
  const int tiles_x = (p.out_w + T - 1) / T;
  const int per_plane = tiles_x * ((p.out_h + T - 1) / T);
  const int total = p.planes * per_plane;

  load_ops(s_ops, s_win, ops, win, p.ops_elems, p.n_win);
  auto load = [&](int buf, int tile) {
    const int plane = tile / per_plane, t = tile - plane * per_plane;
    const int ty = t / tiles_x, tx = t - ty * tiles_x;
    load_patch(s_x + buf * x_elems, ld_x, x + (size_t)plane * p.in_h * p.in_w,
               ty * p.step + p.base_y, tx * p.step + p.base_x, p.pp, p.in_h, p.in_w, p.aligned);
  };
  if (blockIdx.x < total) load(0, blockIdx.x);
  cp_async_commit();

  for (int tile = blockIdx.x, it = 0; tile < total; tile += gridDim.x, ++it) {
    if (tile + gridDim.x < total) load((it + 1) & 1, tile + gridDim.x);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const bf16* xs = s_x + (it & 1) * x_elems;
    const auto store_t1 = [&](int m0, int n0, const float (&c)[2][4]) {
      store_item(s_t, ld_t1, m0, n0, c);
    };
    const auto store_z = [&](int m0, int n0, float (&c)[2][4]) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float u = c[j][e];
          const float v = (u >= 0.f ? u : u * slope) * gain;
          c[j][e] = v > clamp ? clamp : (v < -clamp ? -clamp : v);
        }
      store_item(s_z, ld_z, m0, n0, c);
    };
    const auto store_t3 = [&](int m0, int n0, const float (&c)[2][4]) {
      store_item(s_t, ld_t, m0, n0, c);
    };
    const auto store_out = [&](int m0, int n0, const float (&c)[2][4]) {
      store_item(s_z, ld_t, m0, n0, c);
    };
    const int rb = p.rp / 16, pb = p.pp / 16, tb = T / 16;
    // t1 = Au . X  [rp][pp]
    product<kFwdGroup, true, true>(au_y, p.au_y.ld, xs, ld_x, rb, pb, s_win, p.au_y, store_t1);
    __syncthreads();
    // Z = act(t1 . Bu^T)  [rp][rp]
    product<kFwdGroup, false, false>(s_t, ld_t1, au_x, p.au_x.ld, rb, rb, s_win, p.au_x, store_z);
    __syncthreads();
    // t3 = Z . Bd^T  [rp][T], over t1's storage
    product<kFwdGroup, false, false>(s_z, ld_z, ad_x, p.ad_x.ld, rb, tb, s_win, p.ad_x, store_t3);
    __syncthreads();
    // out = Ad . t3  [T][T], over Z's storage
    product<kFwdGroup, true, true>(ad_y, p.ad_y.ld, s_t, ld_t, tb, tb, s_win, p.ad_y, store_out);
    __syncthreads();
    const int plane = tile / per_plane, t = tile - plane * per_plane;
    const int ty = t / tiles_x, tx = t - ty * tiles_x;
    store_tile(y + (size_t)plane * p.out_h * p.out_w, s_z, ld_t, T, ty * T, tx * T, p.out_h,
               p.out_w);
  }
}

struct BwdSmem {
  int win, ops, x, d, t, s, u, total;
};

__host__ __device__ inline BwdSmem bwd_smem(const BwdParams& p) {
  BwdSmem s;
  s.win = 0;
  s.ops = align16(p.n_win * 4);
  s.x = s.ops + align16(p.ops_elems * 2);
  s.d = s.x + 2 * align16(p.px * ld_of(p.px) * 2);
  s.t = s.d + 2 * align16(p.pd * ld_of(p.pd) * 2);  // t1 [rp][ld(px)], then dt1 [rp][ld(T)]
  // s1 [rp][ld(pd)]
  s.s = s.t + align16(lvg::imax(p.rp * ld_of(p.px), p.rp * ld_of(p.tile)) * 2);
  s.u = s.s + align16(p.rp * ld_of(p.pd) * 2);  // dU [rp][ld(rp)], then dX [T][ld(T)]
  s.total = s.u + align16(lvg::imax(p.rp * ld_of(p.rp), p.tile * ld_of(p.tile)) * 2);
  return s;
}

__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSM)
filtered_lrelu_bwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                             bf16* __restrict__ dx, const bf16* __restrict__ ops,
                             const int* __restrict__ win, BwdParams p, float gain, float slope,
                             float clamp, int has_clamp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem L = bwd_smem(p);
  int* s_win = reinterpret_cast<int*>(smem + L.win);
  bf16* s_ops = reinterpret_cast<bf16*>(smem + L.ops);
  bf16* s_x = reinterpret_cast<bf16*>(smem + L.x);  // two x patch buffers
  bf16* s_d = reinterpret_cast<bf16*>(smem + L.d);  // two dy patch buffers
  const int x_elems = align16(p.px * ld_of(p.px) * 2) / 2;
  const int d_elems = align16(p.pd * ld_of(p.pd) * 2) / 2;
  bf16* s_t = reinterpret_cast<bf16*>(smem + L.t);
  bf16* s_s = reinterpret_cast<bf16*>(smem + L.s);
  bf16* s_u = reinterpret_cast<bf16*>(smem + L.u);
  const bf16* au_y = s_ops + p.au_y.off;
  const bf16* au_x = s_ops + p.au_x.off;
  const bf16* adt_y = s_ops + p.adt_y.off;
  const bf16* adt_x = s_ops + p.adt_x.off;
  const bf16* aut_y = s_ops + p.aut_y.off;
  const bf16* aut_x = s_ops + p.aut_x.off;
  const int T = p.tile, ld_x = ld_of(p.px), ld_d = ld_of(p.pd), ld_u = ld_of(p.rp),
            ld_t = ld_of(T);
  const int tiles_x = (p.in_w + T - 1) / T;
  const int per_plane = tiles_x * ((p.in_h + T - 1) / T);
  const int total = p.planes * per_plane;
  const int warp = threadIdx.x >> 5;
  const float gain_neg = gain * slope;

  load_ops(s_ops, s_win, ops, win, p.ops_elems, p.n_win);
  auto load = [&](int buf, int tile) {
    const int plane = tile / per_plane, t = tile - plane * per_plane;
    const int ty = t / tiles_x, tx = t - ty * tiles_x;
    load_patch(s_x + buf * x_elems, ld_x, x + (size_t)plane * p.in_h * p.in_w,
               ty * T + p.xbase_y, tx * T + p.xbase_x, p.px, p.in_h, p.in_w, p.x_aligned);
    load_patch(s_d + buf * d_elems, ld_d, dy + (size_t)plane * p.out_h * p.out_w,
               ty * p.dstep + p.dbase_y, tx * p.dstep + p.dbase_x, p.pd, p.out_h, p.out_w,
               p.d_aligned);
  };
  if (blockIdx.x < total) load(0, blockIdx.x);
  cp_async_commit();

  for (int tile = blockIdx.x, it = 0; tile < total; tile += gridDim.x, ++it) {
    if (tile + gridDim.x < total) load((it + 1) & 1, tile + gridDim.x);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const bf16* xs = s_x + (it & 1) * x_elems;
    const bf16* ds = s_d + (it & 1) * d_elems;
    const int rb = p.rp / 16, xb = p.px / 16, db = p.pd / 16, tb = T / 16;
    // t1 = Au . X  [rp][px]  and  s1 = Ad^T . dY  [rp][pd]
    product<kBwdGroup, true, true>(au_y, p.au_y.ld, xs, ld_x, rb, xb, s_win, p.au_y,
                        [&](int m0, int n0, const float (&c)[2][4]) {
                          store_item(s_t, ld_x, m0, n0, c);
                        });
    product<kBwdGroup, true, true>(adt_y, p.adt_y.ld, ds, ld_d, rb, db, s_win, p.adt_y,
                        [&](int m0, int n0, const float (&c)[2][4]) {
                          store_item(s_s, ld_d, m0, n0, c);
                        });
    __syncthreads();
    // dU = (s1 . Bd) * act'(t1 . Bu^T)  [rp][rp]: U and dZ of one item side by
    // side in one warp, so U never leaves registers.
    constexpr int kDuGroup = 2;
    const int du_groups = (rb + kDuGroup - 1) / kDuGroup;
    for (int item = warp; item < rb * du_groups; item += kWarps) {
      const int nb = item / du_groups, g0 = (item - nb * du_groups) * kDuGroup;
      const int count = min(kDuGroup, rb - g0);
      const int ku = 16 * s_win[p.au_x.win + nb], kz = 16 * s_win[p.adt_x.win + nb];
      float u[kDuGroup][2][4] = {}, dz[kDuGroup][2][4] = {};
      for (int kb = 0; kb < p.au_x.kb; ++kb) {  // the wrapper makes the two widths equal
        uint32_t bu[4], bz[4], a[4];
        ldsm_x4(bu, b_frag<false>(au_x, p.au_x.ld, ku + 16 * kb, 16 * nb));
        ldsm_x4(bz, b_frag<false>(adt_x, p.adt_x.ld, kz + 16 * kb, 16 * nb));
#pragma unroll
        for (int g = 0; g < kDuGroup; ++g) {
          if (g < count) {
            ldsm_x4(a, a_frag(s_t, ld_x, 16 * (g0 + g), ku + 16 * kb));
            mma_16x16(u[g], a, bu);
            ldsm_x4(a, a_frag(s_s, ld_d, 16 * (g0 + g), kz + 16 * kb));
            mma_16x16(dz[g], a, bz);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kDuGroup; ++g) {
        if (g >= count) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = u[g][j][e];
            float d = v >= 0.f ? gain : gain_neg;
            if (has_clamp) {
              const float z = (v >= 0.f ? v : v * slope) * gain;
              if (!(z > -clamp && z < clamp)) d = 0.f;
            }
            dz[g][j][e] *= d;
          }
        store_item(s_u, ld_u, 16 * (g0 + g), 16 * nb, dz[g]);
      }
    }
    __syncthreads();
    // dt1 = dU . Bu  [rp][T], over t1's storage
    product<kBwdGroup, false, false>(s_u, ld_u, aut_x, p.aut_x.ld, rb, tb, s_win, p.aut_x,
                          [&](int m0, int n0, const float (&c)[2][4]) {
                            store_item(s_t, ld_t, m0, n0, c);
                          });
    __syncthreads();
    // dX = Au^T . dt1  [T][T], over dU's storage
    product<kBwdGroup, true, true>(aut_y, p.aut_y.ld, s_t, ld_t, tb, tb, s_win, p.aut_y,
                        [&](int m0, int n0, const float (&c)[2][4]) {
                          store_item(s_u, ld_t, m0, n0, c);
                        });
    __syncthreads();
    const int plane = tile / per_plane, t = tile - plane * per_plane;
    const int ty = t / tiles_x, tx = t - ty * tiles_x;
    store_tile(dx + (size_t)plane * p.in_h * p.in_w, s_u, ld_t, T, ty * T, tx * T, p.in_h,
               p.in_w);
  }
}

// A persistent grid: as many blocks as fit on every SM at this footprint,
// never more than there are tiles.
template <typename Kernel, typename... Args>
cudaError_t launch_persistent(Kernel kernel, long long tiles, int smem, cudaStream_t stream,
                              Args... args) {
  if (tiles < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long grid = tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename Params>
bool read_params(Params& p, const int* params, int n_params) {
  if (n_params * (int)sizeof(int) != (int)sizeof(Params)) return false;
  std::memcpy(&p, params, sizeof(Params));
  return true;
}

}  // namespace

// x [planes, in_h, in_w] -> y [planes, out_h, out_w], bf16, contiguous. ops:
// the operator blocks (bf16), win: their K-windows (int32), both on the
// device; params: host ints in FwdParams' order. clamp: +inf for none.
extern "C" int lvg_tc_fwd(const void* x, void* y, const void* ops, const void* win,
                          const int* params, int n_params, float gain, float slope, float clamp,
                          void* stream) {
  FwdParams p;
  if (!read_params(p, params, n_params)) return cudaErrorInvalidValue;
  if (p.tile % 16 || p.rp % 16 || p.pp % 16 || p.ops_elems % 8) return cudaErrorInvalidValue;
  const long long tiles = (long long)p.planes * ((p.out_h + p.tile - 1) / p.tile) *
                          ((p.out_w + p.tile - 1) / p.tile);
  if (tiles > INT_MAX) return cudaErrorInvalidConfiguration;
  return launch_persistent(filtered_lrelu_fwd_tc_kernel, tiles, fwd_smem(p).total,
                           static_cast<cudaStream_t>(stream), static_cast<const bf16*>(x),
                           static_cast<bf16*>(y), static_cast<const bf16*>(ops),
                           static_cast<const int*>(win), p, gain, slope, clamp);
}

// dy [planes, out_h, out_w], x and dx [planes, in_h, in_w], bf16, contiguous;
// ops, win, params as for lvg_tc_fwd (BwdParams' order). has_clamp = 0 for
// no clamp.
extern "C" int lvg_tc_bwd(const void* x, const void* dy, void* dx, const void* ops,
                          const void* win, const int* params, int n_params, float gain,
                          float slope, float clamp, int has_clamp, void* stream) {
  BwdParams p;
  if (!read_params(p, params, n_params)) return cudaErrorInvalidValue;
  if (p.tile % 16 || p.rp % 16 || p.px % 16 || p.pd % 16 || p.ops_elems % 8)
    return cudaErrorInvalidValue;
  const long long tiles = (long long)p.planes * ((p.in_h + p.tile - 1) / p.tile) *
                          ((p.in_w + p.tile - 1) / p.tile);
  if (tiles > INT_MAX) return cudaErrorInvalidConfiguration;
  return launch_persistent(filtered_lrelu_bwd_tc_kernel, tiles, bwd_smem(p).total,
                           static_cast<cudaStream_t>(stream), static_cast<const bf16*>(x),
                           static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
                           static_cast<const bf16*>(ops), static_cast<const int*>(win), p, gain,
                           slope, clamp, has_clamp);
}

// The tensor-core filtered_lrelu tile kernels for Hopper (sm_90a), shared by
// K1/K2 (filtered_lrelu_tc.cu, impl "packed"), K3a/K3b
// (filtered_lrelu_fused_tc.cu, impl "fused") and the f32-exact forwards K4/K5
// (filtered_lrelu_exact_tc.cu, impl "pallas" and filtered_lrelu_pallas_v2).
// Per plane X, stage for stage:
//   t1 = Au . X,  Z = act(t1 . Bu^T),  t3 = Z . Bd^T,  out = Ad . t3;
//   t1 = Au . X,  s1 = Ad^T . dY,  dU = (s1 . Bd) * act'(t1 . Bu^T),
//   dt1 = dU . Bu,  dX = Au^T . dt1;
// with the banded operators of ops/filtered_lrelu_bands.py, whose tile plans
// (`fwd_tile_plan`, `bwd_tile_plan`) the host builds.
//
// The bodies `fwd_tc` and `bwd_tc` take the maps' type T and kS, the bf16
// parts each operand is held in:
// - kS = 1 (bf16 maps): operators, t1, Z, t3 (t1, s1, dU, dt1) and the result
//   in bf16, every sum in f32: the TPU kernels' stores, and what bf16
//   tensor-core operands round to anyway.
// - kS = 3 (f32 stages, the TPU kernel's Precision.HIGHEST): every f32
//   operand (operators, f32 patches, stages) is held as three bf16 parts
//   hi + mid + lo, each the rounding of what the parts before it leave, which
//   together hold its f32 value. A product sums, in f32, the six partial
//   products above 2^-24 of the operands' scale: hi.hi into one accumulator,
//   and hi.mid, mid.hi, hi.lo, lo.hi, mid.mid into another, added at the end
//   (the tensor cores truncate as they accumulate, so the small terms keep
//   their own sum). Stages stay f32 and are split as they are stored. A bf16
//   patch is exact in one part, so on bf16 maps (K4/K5) t1 = Au . X takes
//   three partial products, and only the output rounds to bf16.
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
//   accumulator fragments; stages are stored to shared memory as bf16 pairs
//   (kS planes). Row strides are 8 mod 16 elements, so ldmatrix rows and pair
//   stores hit distinct banks.
// - A persistent grid (blocks per SM from the occupancy of the footprint)
//   walks (plane, tile); the next tile's patches load with cp.async (4-byte
//   words, zero-fill outside the map) while this tile's products run: for
//   bf16 maps into the other of two patch buffers, for f32 maps into one raw
//   f32 buffer that the next step splits into its three planes. TMA would
//   need 16-byte multiples as row strides; the bf16 maps' rows here are 76,
//   108, 172, 300 and 556 bytes. Outputs go out through shared memory,
//   neighbouring threads on neighbouring elements, so global stores coalesce.
// - On the H100 (PERF.md) the tensor cores are not what limits the bf16
//   kernels: builds without the MMAs took most of the time still. Per-tile
//   latency, barriers and patch loads do, which is why occupancy paid and
//   wider or interleaved items did not.
#pragma once

#include <climits>
#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct OpRef {
  // Element offset in the operator buffer, row stride, first window entry,
  // window width in K-blocks.
  int off, ld, win, kb;
};

// Host int arrays of ops/filtered_lrelu_cuda.py `tc_params`, in this order.
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

__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
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

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

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

// One m16 x n16 x k16 step of a product whose operands are held in kSA and
// kSB parts: one part each, one product into `hi`; else hi.hi into `hi` and
// the products of the smaller parts above 2^-24 into `lo` (five for three
// parts each, two for three parts by one).
template <int kSA, int kSB>
__device__ __forceinline__ void mma_parts(float (&hi)[2][4], float (&lo)[2][4],
                                          const uint32_t (&a)[kSA][4],
                                          const uint32_t (&b)[kSB][4]) {
  static_assert((kSA == 1 || kSA == 3) && (kSB == 1 || kSB == 3), "one or three parts");
  if constexpr (kSA == 3 && kSB == 3) {
    mma_16x16(lo, a[1], b[1]);
    mma_16x16(lo, a[0], b[2]);
    mma_16x16(lo, a[2], b[0]);
    mma_16x16(lo, a[0], b[1]);
    mma_16x16(lo, a[1], b[0]);
  } else if constexpr (kSA == 3) {
    mma_16x16(lo, a[2], b[0]);
    mma_16x16(lo, a[1], b[0]);
  } else if constexpr (kSB == 3) {
    mma_16x16(lo, a[0], b[2]);
    mma_16x16(lo, a[0], b[1]);
  }
  mma_16x16(hi, a[0], b[0]);
}

// kS bf16 parts of the f32 pair (a, b): kS = 1 its rounding; kS = 3 hi, mid,
// lo, each the rounding of what the parts before it leave.
template <int kS>
__device__ __forceinline__ void split_pair(float a, float b, __nv_bfloat162 (&out)[kS]) {
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    out[s] = __floats2bfloat162_rn(a, b);
    if (s + 1 < kS) {
      a -= __low2float(out[s]);
      b -= __high2float(out[s]);
    }
  }
}

// The fragment's (row, col) of acc[j][e]: rows m0 + g (+8 for e >= 2), cols
// n0 + 8j + 2t (+1 for odd e), g = lane / 4, t = lane % 4. A stage of kS
// planes `plane` elements apart.
template <int kS>
__device__ __forceinline__ void store_item(bf16* C, int ldc, int plane, int m0, int n0,
                                           const float (&v)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    bf16* c = C + (m0 + g) * ldc + n0 + 8 * j + 2 * t;
    __nv_bfloat162 top[kS], bottom[kS];
    split_pair<kS>(v[j][0], v[j][1], top);
    split_pair<kS>(v[j][2], v[j][3], bottom);
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      *reinterpret_cast<__nv_bfloat162*>(c + s * plane) = top[s];
      *reinterpret_cast<__nv_bfloat162*>(c + s * plane + 8 * ldc) = bottom[s];
    }
  }
}

// The output tile's item in the maps' type: bf16 pairs, or f32 pairs for
// f32 maps (staged over a kS = 3 stage, which holds twice its bytes).
__device__ __forceinline__ void store_out_item(bf16* C, int ldc, int m0, int n0,
                                               const float (&v)[2][4]) {
  store_item<1>(C, ldc, 0, m0, n0, v);
}

__device__ __forceinline__ void store_out_item(float* C, int ldc, int m0, int n0,
                                               const float (&v)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float* c = C + (m0 + g) * ldc + n0 + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(c) = make_float2(v[j][0], v[j][1]);
    *reinterpret_cast<float2*>(c + 8 * ldc) = make_float2(v[j][2], v[j][3]);
  }
}

// Blocks of the other operand that share a band fragment, and blocks per SM
// the register budget leaves room for (measured on the H100 at the 144x256
// plan's layers: the bf16 forward is fastest at four 8-warp blocks per SM,
// the backward, with twice the live accumulators, at two). The f32 kernels'
// footprint leaves room for one block per SM.
constexpr int kFwdGroup = 2, kFwdBlocksPerSM = 4;
constexpr int kBwdGroup = 4, kBwdBlocksPerSM = 2;

// C = A . B over an mblocks x nblocks grid of m16 x n16 blocks, A held in kSA
// planes and B in kSB (a_plane, b_plane elements apart), by a block of kNW
// warps. `op` is the banded operand (A if kBandOfA, else B, stored NK); its
// op.kb-wide window depends only on its own 16-row block. A warp takes one
// band block and up to kG blocks of the other operand: per K-block the band
// fragment loads once and serves the group. epi(m0, n0, acc) stores a block.
template <int kSA, int kSB, int kG, bool kKN, bool kBandOfA, int kNW = kWarps,
          typename Epilogue>
__device__ __forceinline__ void product(const bf16* A, int lda, int a_plane, const bf16* B,
                                        int ldb, int b_plane, int mblocks, int nblocks,
                                        const int* s_win, const OpRef& op, Epilogue epi) {
  constexpr int kSF = kBandOfA ? kSA : kSB, kSO = kBandOfA ? kSB : kSA;  // band, other
  const int bands = kBandOfA ? mblocks : nblocks, others = kBandOfA ? nblocks : mblocks;
  const int groups = (others + kG - 1) / kG;
  for (int item = threadIdx.x >> 5; item < bands * groups; item += kNW) {
    const int band = item / groups, g0 = (item - band * groups) * kG;
    const int count = min(kG, others - g0);
    const int k0 = 16 * s_win[op.win + band];
    float acc[kG][2][4] = {}, low[kG][2][4] = {};
    for (int kb = 0; kb < op.kb; ++kb) {
      const int k = k0 + 16 * kb;
      uint32_t fixed[kSF][4], other[kSO][4];
#pragma unroll
      for (int s = 0; s < kSF; ++s) {
        if (kBandOfA)
          ldsm_x4(fixed[s], a_frag(A + s * a_plane, lda, 16 * band, k));
        else
          ldsm_b<kKN>(fixed[s], b_frag<kKN>(B + s * b_plane, ldb, k, 16 * band));
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g < count) {
#pragma unroll
          for (int s = 0; s < kSO; ++s) {
            if (kBandOfA)
              ldsm_b<kKN>(other[s], b_frag<kKN>(B + s * b_plane, ldb, k, 16 * (g0 + g)));
            else
              ldsm_x4(other[s], a_frag(A + s * a_plane, lda, 16 * (g0 + g), k));
          }
          if constexpr (kBandOfA)
            mma_parts<kSA, kSB>(acc[g], low[g], fixed, other);
          else
            mma_parts<kSA, kSB>(acc[g], low[g], other, fixed);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g < count) {
        if constexpr (kSA * kSB > 1) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][j][e] += low[g][j][e];
        }
        epi(16 * (kBandOfA ? band : g0 + g), 16 * (kBandOfA ? g0 + g : band), acc[g]);
      }
    }
  }
}

// size x size patch of the h x w bf16 plane `src` at (r0, c0) into dst
// [size][ld], zero outside the plane. `aligned`: w even, c0 even and src
// 4-byte aligned, so bf16 pairs load as 4-byte cp.async words (the caller
// commits); else a synchronous copy, element by element.
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

// The same patch of an f32 plane into the raw buffer dst [size][size] by
// 4-byte cp.async words (the caller commits), zero outside the plane.
__device__ __forceinline__ void load_patch(float* dst, const float* src, int r0, int c0,
                                           int size, int h, int w) {
  for (int idx = threadIdx.x; idx < size * size; idx += blockDim.x) {
    const int r = idx / size, c = idx - r * size;
    const int gy = r0 + r, gx = c0 + c;
    const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < w;
    cp_async4(dst + idx, ok ? src + (size_t)gy * w + gx : src, ok);
  }
}

// A raw f32 patch [size][size] into its three bf16 planes [size][ld],
// `plane` elements apart.
__device__ __forceinline__ void split_patch(bf16* dst, int ld, int plane, const float* raw,
                                            int size) {
  for (int idx = threadIdx.x; idx < size * size; idx += blockDim.x) {
    const int r = idx / size, c = idx - r * size;
    float v = raw[idx];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const bf16 part = __float2bfloat16_rn(v);
      dst[s * plane + r * ld + c] = part;
      v -= __bfloat162float(part);
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

__device__ __forceinline__ void store_tile(float* dst, const float* s, int ld, int tile, int r0,
                                           int c0, int h, int w) {
  const int rows = min(tile, h - r0), cols = min(tile, w - c0);
  for (int idx = threadIdx.x; idx < rows * tile; idx += blockDim.x) {
    const int r = idx / tile, c = idx - r * tile;
    if (c < cols) dst[(size_t)(r0 + r) * w + c0 + c] = s[r * ld + c];
  }
}

// Operators (kS planes of ops_elems, a multiple of 8) and windows into
// shared memory.
template <int kS>
__device__ __forceinline__ void load_ops(bf16* s_ops, int* s_win, const bf16* ops,
                                         const int* win, int ops_elems, int n_win) {
  for (int i = threadIdx.x; i < kS * ops_elems / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(s_ops)[i] = reinterpret_cast<const uint4*>(ops)[i];
  for (int i = threadIdx.x; i < n_win; i += blockDim.x) s_win[i] = win[i];
}

// The bf16 parts of a patch of maps of type T whose operators and stages
// take kS: a bf16 patch is exact in one.
template <typename T, int kS>
__host__ __device__ constexpr int patch_parts() {
  return sizeof(T) == 2 ? 1 : kS;
}

// Byte offsets of the shared-memory regions, and the total. x (d): two patch
// buffers for patches in one part, else the three planes of one patch and its
// raw f32 buffer (raw, raw_d). The stages take kS planes of *_plane elements
// each.
struct FwdSmem {
  int win, ops, x, raw, t, z, total;
  int x_elems, t_plane, z_plane;
};

template <int kS, int kSX>
__host__ __device__ inline FwdSmem fwd_smem(const FwdParams& p) {
  FwdSmem s;
  s.win = 0;
  s.ops = align16(p.n_win * 4);
  s.x = s.ops + align16(kS * p.ops_elems * 2);
  const int x_bytes = align16(p.pp * ld_of(p.pp) * 2);
  s.x_elems = x_bytes / 2;
  s.raw = s.x + (kSX == 1 ? 2 : kSX) * x_bytes;
  s.t = s.raw + (kSX == 1 ? 0 : align16(p.pp * p.pp * 4));
  // t1 [rp][ld(pp)], then t3 [rp][ld(T)]
  const int t_bytes = align16(imax(p.rp * ld_of(p.pp), p.rp * ld_of(p.tile)) * 2);
  s.t_plane = t_bytes / 2;
  s.z = s.t + kS * t_bytes;
  // Z [rp][ld(rp)], then the output tile [T][ld(T)] in the maps' type.
  const int z_bytes = align16(imax(p.rp * ld_of(p.rp), p.tile * ld_of(p.tile)) * 2);
  s.z_plane = z_bytes / 2;
  s.total = s.z + kS * z_bytes;
  return s;
}

// K1 (T = bf16, kS = 1), K3a (bf16, or f32 with kS = 3) and K4/K5 (bf16 or
// f32, kS = 3): one launch's walk, by blocks of kNW warps, over the
// (plane, tile) items of x [planes, in_h, in_w] -> y.
template <typename T, int kS, int kG, int kNW = kWarps>
__device__ __forceinline__ void fwd_tc(const T* __restrict__ x, T* __restrict__ y,
                                       const bf16* __restrict__ ops,
                                       const int* __restrict__ win, const FwdParams& p,
                                       float gain, float slope, float clamp) {
  static_assert(kS == 3 || sizeof(T) == 2, "f32 maps take three parts");
  constexpr int kSX = patch_parts<T, kS>();
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdSmem L = fwd_smem<kS, kSX>(p);
  int* s_win = reinterpret_cast<int*>(smem + L.win);
  bf16* s_ops = reinterpret_cast<bf16*>(smem + L.ops);
  bf16* s_x = reinterpret_cast<bf16*>(smem + L.x);  // two patch buffers, or three planes
  float* s_raw = reinterpret_cast<float*>(smem + L.raw);
  bf16* s_t = reinterpret_cast<bf16*>(smem + L.t);
  bf16* s_z = reinterpret_cast<bf16*>(smem + L.z);
  const int ops_plane = p.ops_elems, x_elems = L.x_elems, t_plane = L.t_plane,
            z_plane = L.z_plane;
  const bf16* au_y = s_ops + p.au_y.off;
  const bf16* au_x = s_ops + p.au_x.off;
  const bf16* ad_y = s_ops + p.ad_y.off;
  const bf16* ad_x = s_ops + p.ad_x.off;
  const int T_ = p.tile, ld_x = ld_of(p.pp), ld_t1 = ld_of(p.pp), ld_z = ld_of(p.rp),
            ld_t = ld_of(T_);
  const int tiles_x = (p.out_w + T_ - 1) / T_;
  const int per_plane = tiles_x * ((p.out_h + T_ - 1) / T_);
  const int total = p.planes * per_plane;

  load_ops<kS>(s_ops, s_win, ops, win, p.ops_elems, p.n_win);
  auto load = [&](int buf, int tile) {
    const int plane = tile / per_plane, t = tile - plane * per_plane;
    const int ty = t / tiles_x, tx = t - ty * tiles_x;
    const T* src = x + (size_t)plane * p.in_h * p.in_w;
    const int r0 = ty * p.step + p.base_y, c0 = tx * p.step + p.base_x;
    if constexpr (kSX == 1)
      load_patch(s_x + buf * x_elems, ld_x, src, r0, c0, p.pp, p.in_h, p.in_w, p.aligned);
    else
      load_patch(s_raw, src, r0, c0, p.pp, p.in_h, p.in_w);
  };
  if (blockIdx.x < total) load(0, blockIdx.x);
  cp_async_commit();

  for (int tile = blockIdx.x, it = 0; tile < total; tile += gridDim.x, ++it) {
    const bf16* xs;
    if constexpr (kSX == 1) {
      if (tile + gridDim.x < total) load((it + 1) & 1, tile + gridDim.x);
      cp_async_commit();
      cp_async_wait_prev();
      __syncthreads();
      xs = s_x + (it & 1) * x_elems;
    } else {
      cp_async_wait_all();
      __syncthreads();
      split_patch(s_x, ld_x, x_elems, s_raw, p.pp);
      __syncthreads();
      if (tile + gridDim.x < total) load(0, tile + gridDim.x);
      cp_async_commit();
      xs = s_x;
    }
    const auto store_t1 = [&](int m0, int n0, const float (&c)[2][4]) {
      store_item<kS>(s_t, ld_t1, t_plane, m0, n0, c);
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
      store_item<kS>(s_z, ld_z, z_plane, m0, n0, c);
    };
    const auto store_t3 = [&](int m0, int n0, const float (&c)[2][4]) {
      store_item<kS>(s_t, ld_t, t_plane, m0, n0, c);
    };
    T* s_out = reinterpret_cast<T*>(s_z);
    const auto store_out = [&](int m0, int n0, const float (&c)[2][4]) {
      store_out_item(s_out, ld_t, m0, n0, c);
    };
    const int rb = p.rp / 16, pb = p.pp / 16, tb = T_ / 16;
    // t1 = Au . X  [rp][pp]
    product<kS, kSX, kG, true, true, kNW>(au_y, p.au_y.ld, ops_plane, xs, ld_x, x_elems, rb,
                                          pb, s_win, p.au_y, store_t1);
    __syncthreads();
    // Z = act(t1 . Bu^T)  [rp][rp]
    product<kS, kS, kG, false, false, kNW>(s_t, ld_t1, t_plane, au_x, p.au_x.ld, ops_plane,
                                           rb, rb, s_win, p.au_x, store_z);
    __syncthreads();
    // t3 = Z . Bd^T  [rp][T], over t1's storage
    product<kS, kS, kG, false, false, kNW>(s_z, ld_z, z_plane, ad_x, p.ad_x.ld, ops_plane,
                                           rb, tb, s_win, p.ad_x, store_t3);
    __syncthreads();
    // out = Ad . t3  [T][T], over Z's storage
    product<kS, kS, kG, true, true, kNW>(ad_y, p.ad_y.ld, ops_plane, s_t, ld_t, t_plane, tb,
                                         tb, s_win, p.ad_y, store_out);
    __syncthreads();
    const int plane = tile / per_plane, t = tile - plane * per_plane;
    const int ty = t / tiles_x, tx = t - ty * tiles_x;
    store_tile(y + (size_t)plane * p.out_h * p.out_w, s_out, ld_t, T_, ty * T_, tx * T_,
               p.out_h, p.out_w);
  }
}

struct BwdSmem {
  int win, ops, x, d, raw_x, raw_d, t, s, u, total;
  int x_elems, d_elems, t_plane, s_plane, u_plane;
};

template <int kS>
__host__ __device__ inline BwdSmem bwd_smem(const BwdParams& p) {
  BwdSmem s;
  s.win = 0;
  s.ops = align16(p.n_win * 4);
  s.x = s.ops + align16(kS * p.ops_elems * 2);
  const int x_bytes = align16(p.px * ld_of(p.px) * 2), d_bytes = align16(p.pd * ld_of(p.pd) * 2);
  s.x_elems = x_bytes / 2;
  s.d_elems = d_bytes / 2;
  const int buffers = kS == 1 ? 2 : kS;
  s.d = s.x + buffers * x_bytes;
  s.raw_x = s.d + buffers * d_bytes;
  s.raw_d = s.raw_x + (kS == 1 ? 0 : align16(p.px * p.px * 4));
  s.t = s.raw_d + (kS == 1 ? 0 : align16(p.pd * p.pd * 4));
  // t1 [rp][ld(px)], then dt1 [rp][ld(T)]
  const int t_bytes = align16(imax(p.rp * ld_of(p.px), p.rp * ld_of(p.tile)) * 2);
  s.t_plane = t_bytes / 2;
  s.s = s.t + kS * t_bytes;  // s1 [rp][ld(pd)]
  const int s_bytes = align16(p.rp * ld_of(p.pd) * 2);
  s.s_plane = s_bytes / 2;
  s.u = s.s + kS * s_bytes;  // dU [rp][ld(rp)], then dX [T][ld(T)] in the maps' type
  const int u_bytes = align16(imax(p.rp * ld_of(p.rp), p.tile * ld_of(p.tile)) * 2);
  s.u_plane = u_bytes / 2;
  s.total = s.u + kS * u_bytes;
  return s;
}

// K2 (T = bf16, kS = 1) and K3b (bf16, or f32 with kS = 3): dx at x along dy.
// kDumpU (check-only builds): also store each tile's U, as act' takes it, to
// u_out [tile][rp][rp] in f32, tiles in the walk's (plane, row, column)
// order. Neighbouring tiles recompute overlapping windows, each in its own
// summation order, so U is kept per tile, not per map position.
template <typename T, int kS, int kG, bool kDumpU = false>
__device__ __forceinline__ void bwd_tc(const T* __restrict__ x, const T* __restrict__ dy,
                                       T* __restrict__ dx, const bf16* __restrict__ ops,
                                       const int* __restrict__ win, const BwdParams& p,
                                       float gain, float slope, float clamp, int has_clamp,
                                       float* __restrict__ u_out = nullptr) {
  static_assert(kS == (sizeof(T) == 2 ? 1 : 3), "bf16 maps take one part, f32 maps three");
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem L = bwd_smem<kS>(p);
  int* s_win = reinterpret_cast<int*>(smem + L.win);
  bf16* s_ops = reinterpret_cast<bf16*>(smem + L.ops);
  bf16* s_x = reinterpret_cast<bf16*>(smem + L.x);  // x patch buffers, or planes
  bf16* s_d = reinterpret_cast<bf16*>(smem + L.d);  // dy patch buffers, or planes
  float* s_raw_x = reinterpret_cast<float*>(smem + L.raw_x);
  float* s_raw_d = reinterpret_cast<float*>(smem + L.raw_d);
  bf16* s_t = reinterpret_cast<bf16*>(smem + L.t);
  bf16* s_s = reinterpret_cast<bf16*>(smem + L.s);
  bf16* s_u = reinterpret_cast<bf16*>(smem + L.u);
  const int ops_plane = p.ops_elems, x_elems = L.x_elems, d_elems = L.d_elems,
            t_plane = L.t_plane, s_plane = L.s_plane, u_plane = L.u_plane;
  const bf16* au_y = s_ops + p.au_y.off;
  const bf16* au_x = s_ops + p.au_x.off;
  const bf16* adt_y = s_ops + p.adt_y.off;
  const bf16* adt_x = s_ops + p.adt_x.off;
  const bf16* aut_y = s_ops + p.aut_y.off;
  const bf16* aut_x = s_ops + p.aut_x.off;
  const int T_ = p.tile, ld_x = ld_of(p.px), ld_d = ld_of(p.pd), ld_u = ld_of(p.rp),
            ld_t = ld_of(T_);
  const int tiles_x = (p.in_w + T_ - 1) / T_;
  const int per_plane = tiles_x * ((p.in_h + T_ - 1) / T_);
  const int total = p.planes * per_plane;
  const int warp = threadIdx.x >> 5;
  const float gain_neg = gain * slope;

  load_ops<kS>(s_ops, s_win, ops, win, p.ops_elems, p.n_win);
  auto load = [&](int buf, int tile) {
    const int plane = tile / per_plane, t = tile - plane * per_plane;
    const int ty = t / tiles_x, tx = t - ty * tiles_x;
    const T* xsrc = x + (size_t)plane * p.in_h * p.in_w;
    const T* dsrc = dy + (size_t)plane * p.out_h * p.out_w;
    const int xr = ty * T_ + p.xbase_y, xc = tx * T_ + p.xbase_x;
    const int dr = ty * p.dstep + p.dbase_y, dc = tx * p.dstep + p.dbase_x;
    if constexpr (kS == 1) {
      load_patch(s_x + buf * x_elems, ld_x, xsrc, xr, xc, p.px, p.in_h, p.in_w, p.x_aligned);
      load_patch(s_d + buf * d_elems, ld_d, dsrc, dr, dc, p.pd, p.out_h, p.out_w, p.d_aligned);
    } else {
      load_patch(s_raw_x, xsrc, xr, xc, p.px, p.in_h, p.in_w);
      load_patch(s_raw_d, dsrc, dr, dc, p.pd, p.out_h, p.out_w);
    }
  };
  if (blockIdx.x < total) load(0, blockIdx.x);
  cp_async_commit();

  for (int tile = blockIdx.x, it = 0; tile < total; tile += gridDim.x, ++it) {
    const bf16 *xs, *ds;
    if constexpr (kS == 1) {
      if (tile + gridDim.x < total) load((it + 1) & 1, tile + gridDim.x);
      cp_async_commit();
      cp_async_wait_prev();
      __syncthreads();
      xs = s_x + (it & 1) * x_elems;
      ds = s_d + (it & 1) * d_elems;
    } else {
      cp_async_wait_all();
      __syncthreads();
      split_patch(s_x, ld_x, x_elems, s_raw_x, p.px);
      split_patch(s_d, ld_d, d_elems, s_raw_d, p.pd);
      __syncthreads();
      if (tile + gridDim.x < total) load(0, tile + gridDim.x);
      cp_async_commit();
      xs = s_x;
      ds = s_d;
    }
    const int rb = p.rp / 16, xb = p.px / 16, db = p.pd / 16, tb = T_ / 16;
    // t1 = Au . X  [rp][px]  and  s1 = Ad^T . dY  [rp][pd]
    product<kS, kS, kG, true, true>(au_y, p.au_y.ld, ops_plane, xs, ld_x, x_elems, rb, xb,
                                    s_win, p.au_y, [&](int m0, int n0, const float (&c)[2][4]) {
                                      store_item<kS>(s_t, ld_x, t_plane, m0, n0, c);
                                    });
    product<kS, kS, kG, true, true>(adt_y, p.adt_y.ld, ops_plane, ds, ld_d, d_elems, rb, db,
                                    s_win, p.adt_y, [&](int m0, int n0, const float (&c)[2][4]) {
                                      store_item<kS>(s_s, ld_d, s_plane, m0, n0, c);
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
      float u_lo[kDuGroup][2][4] = {}, dz_lo[kDuGroup][2][4] = {};
      for (int kb = 0; kb < p.au_x.kb; ++kb) {  // the wrapper makes the two widths equal
        uint32_t bu[kS][4], bz[kS][4], a[kS][4];
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          ldsm_x4(bu[s], b_frag<false>(au_x + s * ops_plane, p.au_x.ld, ku + 16 * kb, 16 * nb));
          ldsm_x4(bz[s], b_frag<false>(adt_x + s * ops_plane, p.adt_x.ld, kz + 16 * kb, 16 * nb));
        }
#pragma unroll
        for (int g = 0; g < kDuGroup; ++g) {
          if (g < count) {
#pragma unroll
            for (int s = 0; s < kS; ++s)
              ldsm_x4(a[s], a_frag(s_t + s * t_plane, ld_x, 16 * (g0 + g), ku + 16 * kb));
            mma_parts<kS, kS>(u[g], u_lo[g], a, bu);
#pragma unroll
            for (int s = 0; s < kS; ++s)
              ldsm_x4(a[s], a_frag(s_s + s * s_plane, ld_d, 16 * (g0 + g), kz + 16 * kb));
            mma_parts<kS, kS>(dz[g], dz_lo[g], a, bz);
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
            float v = u[g][j][e];
            if constexpr (kS > 1) {
              v += u_lo[g][j][e];
              dz[g][j][e] += dz_lo[g][j][e];
            }
            if constexpr (kDumpU) {  // the fragment's (row, col), as store_item places it
              const int lane = threadIdx.x & 31;
              const int row = 16 * (g0 + g) + (lane >> 2) + 8 * (e >> 1);
              const int col = 16 * nb + 8 * j + 2 * (lane & 3) + (e & 1);
              u_out[((size_t)tile * p.rp + row) * p.rp + col] = v;
            }
            float d = v >= 0.f ? gain : gain_neg;
            if (has_clamp) {
              const float z = (v >= 0.f ? v : v * slope) * gain;
              if (!(z > -clamp && z < clamp)) d = 0.f;
            }
            dz[g][j][e] *= d;
          }
        store_item<kS>(s_u, ld_u, u_plane, 16 * (g0 + g), 16 * nb, dz[g]);
      }
    }
    __syncthreads();
    // dt1 = dU . Bu  [rp][T], over t1's storage
    product<kS, kS, kG, false, false>(s_u, ld_u, u_plane, aut_x, p.aut_x.ld, ops_plane, rb, tb,
                                      s_win, p.aut_x, [&](int m0, int n0, const float (&c)[2][4]) {
                                        store_item<kS>(s_t, ld_t, t_plane, m0, n0, c);
                                      });
    __syncthreads();
    // dX = Au^T . dt1  [T][T], over dU's storage
    T* s_out = reinterpret_cast<T*>(s_u);
    product<kS, kS, kG, true, true>(aut_y, p.aut_y.ld, ops_plane, s_t, ld_t, t_plane, tb, tb,
                                    s_win, p.aut_y, [&](int m0, int n0, const float (&c)[2][4]) {
                                      store_out_item(s_out, ld_t, m0, n0, c);
                                    });
    __syncthreads();
    const int plane = tile / per_plane, t = tile - plane * per_plane;
    const int ty = t / tiles_x, tx = t - ty * tiles_x;
    store_tile(dx + (size_t)plane * p.in_h * p.in_w, s_out, ld_t, T_, ty * T_, tx * T_, p.in_h,
               p.in_w);
  }
}

// A persistent grid of `threads`-thread blocks: as many as fit on every SM at
// this footprint, never more than there are tiles.
template <typename Kernel, typename... Args>
cudaError_t launch_persistent(Kernel kernel, long long tiles, int smem, int threads,
                              cudaStream_t stream, Args... args) {
  if (tiles < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long grid = tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm;
  kernel<<<(unsigned)grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename Params>
bool read_params(Params& p, const int* params, int n_params) {
  if (n_params * (int)sizeof(int) != (int)sizeof(Params)) return false;
  std::memcpy(&p, params, sizeof(Params));
  return true;
}

// The C entries' checks and launch. x [planes, in_h, in_w] -> y [planes,
// out_h, out_w] in type T, contiguous; ops: kS planes of the operator blocks
// (bf16), win: their K-windows (int32), both on the device; params: host ints
// in FwdParams' order. clamp: +inf for none. Blocks of kNW warps.
template <typename T, int kS, int kNW = kWarps, typename Kernel>
int launch_fwd_tc(Kernel kernel, const void* x, void* y, const void* ops, const void* win,
                  const int* params, int n_params, float gain, float slope, float clamp,
                  void* stream) {
  FwdParams p;
  if (!read_params(p, params, n_params)) return cudaErrorInvalidValue;
  if (p.tile % 16 || p.rp % 16 || p.pp % 16 || p.ops_elems % 8) return cudaErrorInvalidValue;
  const long long tiles = (long long)p.planes * ((p.out_h + p.tile - 1) / p.tile) *
                          ((p.out_w + p.tile - 1) / p.tile);
  if (tiles > INT_MAX) return cudaErrorInvalidConfiguration;
  return launch_persistent(kernel, tiles, fwd_smem<kS, patch_parts<T, kS>()>(p).total,
                           32 * kNW, static_cast<cudaStream_t>(stream), static_cast<const T*>(x),
                           static_cast<T*>(y), static_cast<const bf16*>(ops),
                           static_cast<const int*>(win), p, gain, slope, clamp);
}

// dy [planes, out_h, out_w], x and dx [planes, in_h, in_w], type T,
// contiguous; ops, win, params as for launch_fwd_tc (BwdParams' order).
// has_clamp = 0 for no clamp. `extra`: the kernel's arguments after has_clamp
// (a kDumpU kernel's U buffer).
template <typename T, int kS, typename Kernel, typename... Extra>
int launch_bwd_tc(Kernel kernel, const void* x, const void* dy, void* dx, const void* ops,
                  const void* win, const int* params, int n_params, float gain, float slope,
                  float clamp, int has_clamp, void* stream, Extra... extra) {
  BwdParams p;
  if (!read_params(p, params, n_params)) return cudaErrorInvalidValue;
  if (p.tile % 16 || p.rp % 16 || p.px % 16 || p.pd % 16 || p.ops_elems % 8)
    return cudaErrorInvalidValue;
  const long long tiles = (long long)p.planes * ((p.in_h + p.tile - 1) / p.tile) *
                          ((p.in_w + p.tile - 1) / p.tile);
  if (tiles > INT_MAX) return cudaErrorInvalidConfiguration;
  return launch_persistent(kernel, tiles, bwd_smem<kS>(p).total, kThreads,
                           static_cast<cudaStream_t>(stream), static_cast<const T*>(x),
                           static_cast<const T*>(dy), static_cast<T*>(dx),
                           static_cast<const bf16*>(ops), static_cast<const int*>(win), p, gain,
                           slope, clamp, has_clamp, extra...);
}

}  // namespace

// The message of a C entry's cudaError_t.
extern "C" const char* lvg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

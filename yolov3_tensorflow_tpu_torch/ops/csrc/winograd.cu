// Winograd F(2x2, 3x3) convolution for Hopper: 3x3, stride 1, SAME, NCHW,
// bf16 in and out, float32 sums, with the prologues and epilogues of the
// flagship's train chain.
//
// Replaces the TPU kernel of yolov3_tensorflow_tpu/ops/winograd.py
// (winograd_call -> _kernel) in the seven (prologue, epilogue) modes the
// JAX package calls: PRO_NONE + EPI_NONE (conv3x3), PRO_NONE + EPI_STATS
// (hconv_stats), PRO_BN_ACT + EPI_STATS and PRO_BN_ADD + EPI_STATS with
// the aux write (hconv_bn_act_stats, hconv_bn_add_act_stats), PRO_DYEFF +
// EPI_NONE, PRO_DYEFF + EPI_BN_ACT and PRO_DYEFF + EPI_BN_ADD with the aux
// write (their input gradients).
//
// What bounds it on an H100: bytes.  At module 2's chain shape
// [128, 128, 52, 52] -> 128 one activation tensor is 88.6 MB, 26 us at
// 3.35 TB/s; the products (16 * tiles * C * Co * 2 = 4.5e10 FLOP) take
// 46 us at the bf16 tensor-core peak, and the float32 transforms and
// epilogues 9-15 us on the float32 units, which work beside the tensor
// cores.  So every mode is bound by its bytes: 53 us for the modes that
// move two tensors, 79, 106 and 132 us for those that move three to five.
// Module 1's [128, 64, 104, 104] -> 64 has twice the bytes for the same
// products: 106 us for two tensors, up to 423 us for the eight of
// PRO_DYEFF + EPI_BN_ADD (dy, y, x, a, da_ext in; out, dye, out3 out).
// Design, simple and right first (not the TPU's block structure):
//   * a block owns kTiles 2x2 output tiles (consecutive in (n, tile row,
//     tile column) order) and kCoBlock output channels, and loops over
//     the input channels in chunks of kCChunk;
//   * per chunk each thread reads a tile's 4x4 input patch of two
//     channels, applies the prologue (zero outside the image), writes the
//     aux output for the patch's inner 2x2 (channel-slice 0 blocks only,
//     so every element is written once), and forms V = BT d BT^T, every
//     add rounded to bf16, into shared memory; the block stages the
//     chunk's U slice beside it in 16-byte loads (C and Co are multiples
//     of 8, as the shape rules require);
//   * warp k takes the 16x16x16 bf16 tensor-core products (WMMA, float32
//     sums) of transform position k for all the block's tiles and
//     channels, its accumulators in registers across the channel loop;
//   * the 16 accumulator tiles go to shared memory, each thread applies
//     AT (float32) for one tile and channel, the epilogue on the unrounded
//     output of the positions inside the image, and the bf16 store;
//   * per-channel sums: a fixed warp-shuffle tree per block into a
//     partial row, then one block per channel adds the rows in a fixed
//     order.  No float atomics: two runs give the same bits.
// The input patches are re-read by the neighbouring tiles and by each
// channel slice (from L1/L2); making the kernel approach its bound
// (TMA-fed wgmma, a persistent grid) is later work.
//
// Semantics, as the TPU kernel's (winograd.py:183-427) and the plain
// version's (ops/winograd.py winograd_reference):
//   * PRO_BN_ACT: z = relu(bf16(bf16(x * bf16(inv)) + bf16(shift))), each
//     op in f32 with __fmul_rn / __fadd_rn (no FMA contraction), relu as
//     max(0, z) with NaN kept (jnp.maximum);
//   * PRO_BN_ADD: z = relu(bf16(bf16(bf16(x * bf16(inv)) + bf16(shift))
//     + id)), the identity id read at the same positions as x (the
//     residual boundary: the apply, then the add, then the relu);
//   * PRO_DYEFF: z = bf16((dy + ds) + (2 * dq) * y), f32 ops;
//   * BT rows then columns, each add rounded to bf16; AT rows then
//     columns in f32; one bf16 rounding on the store
//     (__float2bfloat16_rn, which writes NaN as 0x7fff, as PyTorch's CUDA
//     conversion does);
//   * EPI_STATS: (sum o, sum o*o); EPI_BN_ACT: g = o where
//     bf16(bf16(c * bf16(inv)) + bf16(shift)) > 0 else 0, (sum g,
//     sum g*c), output g * inv; EPI_BN_ADD: g = o + d where the boundary
//     activation a > 0 else 0 (d its cotangent), (sum g, sum g*c), output
//     g * inv and out3 = g.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int PRO_NONE = 0, PRO_BN_ACT = 1, PRO_BN_ADD = 2, PRO_DYEFF = 3;
constexpr int EPI_NONE = 0, EPI_STATS = 1, EPI_BN_ACT = 2, EPI_BN_ADD = 3;

constexpr int kTiles = 32;      // output tiles per block (the GEMM's M)
constexpr int kCoBlock = 64;    // output channels per block (N)
constexpr int kCChunk = 32;     // input channels per step (K)
constexpr int kThreads = 512;   // 16 warps: warp k owns position k
constexpr int kVLd = kCChunk + 8;   // padded leading dims (bf16: x8)
constexpr int kULd = kCoBlock + 8;
constexpr int kMLd = kCoBlock + 4;  // (f32: x4)
constexpr int kVBytes = 16 * kTiles * kVLd * 2;
constexpr int kUBytes = 16 * kCChunk * kULd * 2;
constexpr int kMBytes = 16 * kTiles * kMLd * 4;
constexpr int kSmemBytes = kMBytes > kVBytes + kUBytes ? kMBytes
                                                       : kVBytes + kUBytes;
constexpr int kFinalThreads = 256;

static_assert(kThreads == 16 * 32, "one warp per transform position");
static_assert(kTiles * kCChunk % kThreads == 0, "whole (tile, channel) pairs");
static_assert(kThreads % kTiles == 0, "a thread keeps its tile");

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float relu_keep_nan(float v) {
  return v != v ? v : (0.0f < v ? v : 0.0f);
}

template <int PRO, int EPI>
__global__ void __launch_bounds__(kThreads, 1) winograd_f2x3_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ partner,
    const bf16* __restrict__ u, const bf16* __restrict__ cvals,
    const bf16* __restrict__ avals, const bf16* __restrict__ dvals,
    const float* __restrict__ scal, const float* __restrict__ scal2,
    bf16* __restrict__ out, bf16* __restrict__ aux, bf16* __restrict__ out3,
    float* __restrict__ partial, int C, int Co, int H, int W, int TH,
    int TW, int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  // [16][kTiles][kVLd] and [16][kCChunk][kULd] in the channel loop, then
  // [16][kTiles][kMLd] over both
  bf16* Vs = reinterpret_cast<bf16*>(smem);
  bf16* Us = reinterpret_cast<bf16*>(smem + kVBytes);
  float* Ms = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lt = tid % kTiles;  // this thread's tile in phases 1 and 4
  const int p = blockIdx.x * kTiles + lt;
  const bool tile_ok = p < P;
  int n = 0, tr = 0, tc = 0;
  if (tile_ok) {
    n = p / (TH * TW);
    const int rem = p - n * TH * TW;
    tr = rem / TW;
    tc = rem - tr * TW;
  }
  const int co0 = blockIdx.y * kCoBlock;
  const int64_t plane = (int64_t)H * W;
  const bool write_aux = aux != nullptr && blockIdx.y == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int c0 = 0; c0 < C; c0 += kCChunk) {
    // ---- phase 1: prologue + input transform of (tile, channel) pairs
#pragma unroll
    for (int pair = tid; pair < kTiles * kCChunk; pair += kThreads) {
      const int cl = pair / kTiles;
      const int c = c0 + cl;
      float d[4][4];
      if (tile_ok && c < C) {
        const int64_t base = ((int64_t)n * C + c) * plane;
        float inv_b = 0.0f, shift_b = 0.0f, ds = 0.0f, dq2 = 0.0f;
        if (PRO == PRO_BN_ACT || PRO == PRO_BN_ADD) {
          inv_b = bf16_round(scal[c]);
          shift_b = bf16_round(scal[C + c]);
        } else if (PRO == PRO_DYEFF) {
          ds = scal2[c];
          dq2 = 2.0f * scal2[C + c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int r = 2 * tr - 1 + a;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int q = 2 * tc - 1 + b;
            float v = 0.0f;
            if (r >= 0 && r < H && q >= 0 && q < W) {
              const int64_t at = base + (int64_t)r * W + q;
              v = __bfloat162float(x[at]);
              if (PRO == PRO_BN_ACT) {
                v = bf16_round(__fmul_rn(v, inv_b));
                v = relu_keep_nan(bf16_round(__fadd_rn(v, shift_b)));
              } else if (PRO == PRO_BN_ADD) {
                const float id = __bfloat162float(partner[at]);
                v = bf16_round(__fmul_rn(v, inv_b));
                v = bf16_round(__fadd_rn(v, shift_b));
                v = relu_keep_nan(bf16_round(__fadd_rn(v, id)));
              } else if (PRO == PRO_DYEFF) {
                const float y = __bfloat162float(partner[at]);
                v = bf16_round(__fadd_rn(__fadd_rn(v, ds), __fmul_rn(dq2, y)));
              }
              if (write_aux && a >= 1 && a <= 2 && b >= 1 && b <= 2)
                aux[at] = __float2bfloat16_rn(v);
            }
            d[a][b] = v;
          }
        }
      } else {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) d[a][b] = 0.0f;
      }
      // BT row combos (over a), then column combos (over b), bf16 adds
      float rc[4][4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        rc[0][b] = bf16_round(d[0][b] - d[2][b]);
        rc[1][b] = bf16_round(d[1][b] + d[2][b]);
        rc[2][b] = bf16_round(d[2][b] - d[1][b]);
        rc[3][b] = bf16_round(d[1][b] - d[3][b]);
      }
      bf16* vrow = Vs + lt * kVLd + cl;
      constexpr int kStride = kTiles * kVLd;
#pragma unroll
      for (int ki = 0; ki < 4; ++ki) {
        bf16* v = vrow + ki * 4 * kStride;
        v[0] = __float2bfloat16_rn(rc[ki][0] - rc[ki][2]);
        v[kStride] = __float2bfloat16_rn(rc[ki][1] + rc[ki][2]);
        v[2 * kStride] = __float2bfloat16_rn(rc[ki][2] - rc[ki][1]);
        v[3 * kStride] = __float2bfloat16_rn(rc[ki][1] - rc[ki][3]);
      }
    }
    // ---- phase 2: this chunk's U [16][kCChunk][kCoBlock], 8 channels
    // (16 bytes) a load; C and Co are multiples of 8
    constexpr int kVec = 8;
    for (int e = tid; e < 16 * kCChunk * kCoBlock / kVec; e += kThreads) {
      const int col = e % (kCoBlock / kVec) * kVec;
      const int cl = e / (kCoBlock / kVec) % kCChunk;
      const int k = e / (kCoBlock / kVec * kCChunk);
      const int c = c0 + cl, co = co0 + col;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c < C && co < Co)
        v = *reinterpret_cast<const uint4*>(u + ((int64_t)k * C + c) * Co +
                                            co);
      *reinterpret_cast<uint4*>(Us + (k * kCChunk + cl) * kULd + col) = v;
    }
    __syncthreads();
    // ---- phase 3: warp k: M[k] += V[k] (tiles x chunk) @ U[k] (chunk x co)
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
#pragma unroll
      for (int kk = 0; kk < kCChunk; kk += 16) {
        const bf16* va = Vs + warp * kTiles * kVLd + kk;
        wmma::load_matrix_sync(fa[0], va, kVLd);
        wmma::load_matrix_sync(fa[1], va + 16 * kVLd, kVLd);
        const bf16* ub = Us + (warp * kCChunk + kk) * kULd;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::load_matrix_sync(fb, ub + 16 * j, kULd);
          wmma::mma_sync(acc[0][j], fa[0], fb, acc[0][j]);
          wmma::mma_sync(acc[1][j], fa[1], fb, acc[1][j]);
        }
      }
    }
    __syncthreads();
  }

  // ---- phase 4: M to shared memory, AT, epilogue, store
  {
    float* mw = Ms + warp * kTiles * kMLd;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(mw + i * 16 * kMLd + j * 16, acc[i][j], kMLd,
                                wmma::mem_row_major);
  }
  __syncthreads();

  for (int i = 0; i < kCoBlock / 16; ++i) {
    const int col = warp + 16 * i;
    const int co = co0 + col;  // the same for the whole warp
    float s0 = 0.0f, s1 = 0.0f;
    if (tile_ok && co < Co) {
      float m[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) m[k] = Ms[(k * kTiles + lt) * kMLd + col];
      float r0[4], r1[4];
#pragma unroll
      for (int kj = 0; kj < 4; ++kj) {
        r0[kj] = (m[kj] + m[4 + kj]) + m[8 + kj];
        r1[kj] = (m[4 + kj] - m[8 + kj]) - m[12 + kj];
      }
      float o[2][2];
      o[0][0] = (r0[0] + r0[1]) + r0[2];
      o[0][1] = (r0[1] - r0[2]) - r0[3];
      o[1][0] = (r1[0] + r1[1]) + r1[2];
      o[1][1] = (r1[1] - r1[2]) - r1[3];
      const int64_t base = ((int64_t)n * Co + co) * plane;
      float minv = 0.0f, minv_b = 0.0f, mshift_b = 0.0f;
      if (EPI == EPI_BN_ACT || EPI == EPI_BN_ADD) minv = scal[co];
      if (EPI == EPI_BN_ACT) {
        minv_b = bf16_round(minv);
        mshift_b = bf16_round(scal[Co + co]);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = 2 * tr + a;
        if (r >= H) continue;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int q = 2 * tc + b;
          if (q >= W) continue;
          const int64_t at = base + (int64_t)r * W + q;
          float v = o[a][b];
          if (EPI == EPI_STATS) {
            s0 = __fadd_rn(s0, v);
            s1 = __fadd_rn(s1, __fmul_rn(v, v));
          } else if (EPI == EPI_BN_ACT) {
            const float cv = __bfloat162float(cvals[at]);
            const float bn =
                bf16_round(__fadd_rn(bf16_round(__fmul_rn(cv, minv_b)),
                                     mshift_b));
            const float g = bn > 0.0f ? v : 0.0f;
            s0 = __fadd_rn(s0, g);
            s1 = __fadd_rn(s1, __fmul_rn(g, cv));
            v = __fmul_rn(g, minv);
          } else if (EPI == EPI_BN_ADD) {
            // a was written by the forward's prologue: a > 0 exactly where
            // the boundary's pre-activation is
            const float cv = __bfloat162float(cvals[at]);
            const float g = __bfloat162float(avals[at]) > 0.0f
                                ? __fadd_rn(v, __bfloat162float(dvals[at]))
                                : 0.0f;
            s0 = __fadd_rn(s0, g);
            s1 = __fadd_rn(s1, __fmul_rn(g, cv));
            out3[at] = __float2bfloat16_rn(g);
            v = __fmul_rn(g, minv);
          }
          out[at] = __float2bfloat16_rn(v);
        }
      }
    }
    if (EPI != EPI_NONE) {
      // fixed shuffle tree over the warp's 32 tiles
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s0 = __fadd_rn(s0, __shfl_down_sync(0xffffffffu, s0, off));
        s1 = __fadd_rn(s1, __shfl_down_sync(0xffffffffu, s1, off));
      }
      if (lt == 0 && co < Co) {
        float* dst = partial + (int64_t)blockIdx.x * 2 * Co + co;
        dst[0] = s0;
        dst[Co] = s1;
      }
    }
  }
}

// One block per (sum, channel): thread t adds the partial rows t,
// t + kFinalThreads, ... in order, then a halving tree.
__global__ void winograd_stats_final_kernel(const float* __restrict__ partial,
                                            float* __restrict__ stats,
                                            int rows, int Co) {
  __shared__ float red[kFinalThreads];
  const int j = blockIdx.x / Co;
  const int co = blockIdx.x % Co;
  float s = 0.0f;
  for (int b = threadIdx.x; b < rows; b += kFinalThreads)
    s = __fadd_rn(s, partial[((int64_t)b * 2 + j) * Co + co]);
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = kFinalThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h)
      red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + h]);
    __syncthreads();
  }
  if (threadIdx.x == 0) stats[j * Co + co] = red[0];
}

template <int PRO, int EPI>
cudaError_t launch(const void* x, const void* partner, const void* u,
                   const void* cvals, const void* avals, const void* dvals,
                   const void* scal, const void* scal2, void* out, void* aux,
                   void* out3, void* partial, void* stats, int N, int C,
                   int Co, int H, int W, cudaStream_t stream) {
  auto kernel = winograd_f2x3_kernel<PRO, EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int TH = (H + 1) / 2, TW = (W + 1) / 2;
  const int P = N * TH * TW;
  const int rows = (P + kTiles - 1) / kTiles;
  dim3 grid(rows, (Co + kCoBlock - 1) / kCoBlock);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      (const bf16*)x, (const bf16*)partner, (const bf16*)u,
      (const bf16*)cvals, (const bf16*)avals, (const bf16*)dvals,
      (const float*)scal, (const float*)scal2, (bf16*)out, (bf16*)aux,
      (bf16*)out3, (float*)partial, C, Co, H, W, TH, TW, P);
  err = cudaGetLastError();
  if (err != cudaSuccess || EPI == EPI_NONE) return err;
  winograd_stats_final_kernel<<<2 * Co, kFinalThreads, 0, stream>>>(
      (const float*)partial, (float*)stats, rows, Co);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the per-block partial sums that yolo_winograd_f2x3 needs in
// `partial` (one per block of kTiles output tiles).
int yolo_winograd_partial_rows(int N, int H, int W) {
  const int64_t tiles = (int64_t)N * ((H + 1) / 2) * ((W + 1) / 2);
  return (int)((tiles + kTiles - 1) / kTiles);
}

// x [N, C, H, W] bf16; u [16, C, Co] bf16; partner [N, C, H, W] bf16
// (PRO_BN_ADD: the identity; PRO_DYEFF: y); cvals [N, Co, H, W] bf16
// (EPI_BN_ACT, EPI_BN_ADD: the forward input); avals, dvals [N, Co, H, W]
// bf16 (EPI_BN_ADD: the boundary activation and its cotangent); scal
// [2, C] f32 (PRO_BN_ACT, PRO_BN_ADD) or [2, Co] (EPI_BN_ACT, EPI_BN_ADD);
// scal2 [2, C] f32 (PRO_DYEFF: ds, dq).  The operands a mode does not read
// may be null.  Writes out [N, Co, H, W] bf16, aux [N, C, H, W] bf16 when
// aux is not null, out3 [N, Co, H, W] bf16 for EPI_BN_ADD, and for an
// epilogue with sums stats [2, Co] f32 through partial, caller-allocated
// scratch of yolo_winograd_partial_rows(N, H, W) * 2 * Co floats.  All
// contiguous.
// Launches on `stream` of device `device` and returns the cudaError_t of
// the launches (cudaErrorInvalidValue for a mode it does not have).
int yolo_winograd_f2x3(const void* x, const void* partner, const void* u,
                       const void* cvals, const void* avals,
                       const void* dvals, const void* scal,
                       const void* scal2, void* out, void* aux, void* out3,
                       void* partial, void* stats, int pro, int epi, int N,
                       int C, int Co, int H, int W, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((int64_t)N * H * W == 0 || C == 0 || Co == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define YOLO_WINOGRAD_MODE(P_, E_)                                         \
  if (pro == P_ && epi == E_)                                              \
    return (int)launch<P_, E_>(x, partner, u, cvals, avals, dvals, scal,   \
                               scal2, out, aux, out3, partial, stats, N, C, \
                               Co, H, W, s);
  YOLO_WINOGRAD_MODE(PRO_NONE, EPI_NONE)
  YOLO_WINOGRAD_MODE(PRO_NONE, EPI_STATS)
  YOLO_WINOGRAD_MODE(PRO_BN_ACT, EPI_STATS)
  YOLO_WINOGRAD_MODE(PRO_BN_ADD, EPI_STATS)
  YOLO_WINOGRAD_MODE(PRO_DYEFF, EPI_NONE)
  YOLO_WINOGRAD_MODE(PRO_DYEFF, EPI_BN_ACT)
  YOLO_WINOGRAD_MODE(PRO_DYEFF, EPI_BN_ADD)
#undef YOLO_WINOGRAD_MODE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

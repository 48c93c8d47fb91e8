// Stem pooling for Hopper, NCHW: the fused BN + 3x3/s2 max-pool + relu
// of the ResNet-18 stem, p = relu(maxpool3x3/s2_SAME(bn(y))), and the
// pool-only stem of ResNet-18-v2, p = maxpool3x3/s2_SAME(y), each in eval
// form, in train form with argmax codes, and the code-routed backward.
//
// Replaces the TPU kernels of yolov3_tensorflow_tpu/ops/stem_pool.py:
//   * bn_pool_relu_eval (-> _fwd_local, _fwd_kernel with EMIT=False);
//   * bn_pool_relu forward (_vjp_fwd -> _fwd_local, _fwd_kernel with
//     EMIT=True), which also writes the winning tap per window;
//   * bn_pool_relu backward (_vjp_bwd -> _bwd_local, _bwd_kernel with
//     _load_pooled and _route_row);
//   * max_pool_s2_eval and the max_pool_s2 forward (_pool_fwd_local,
//     _pool_fwd_kernel with EMIT=False / True);
//   * the max_pool_s2 backward (_pool_vjp_bwd -> _pool_bwd_local,
//     _pool_bwd_kernel).
// The pool-only kernels are the fused ones with the BN prologue, the relu
// epilogue and the BN sums compiled out (template flags), so both stems
// share one geometry, one tie rule and one routing order.
//
// What bounds them on an H100: bytes.  Each does a handful of operations
// per element it reads once from device memory (~0.1-1 operation per
// byte), so the floor is the bytes each must move at the card's memory
// rate.  Design, simple and right first:
//   * every kernel walks the positions inside an (n, c) plane on the
//     grid's x axis and loops over planes on its y axis, with about four
//     waves of resident blocks in all: one small block per plane and
//     position chunk (over a million at the flagship) spends more time in
//     block launches than in work.  A thread finds its row and column
//     with one 32-bit division;
//   * forward: one thread per pooled output, a warp on neighbouring
//     output columns of one row, so each of the three input rows a warp
//     reads is one contiguous run; the window overlap comes from L1/L2.
//     The code-emitting variant is a template flag, so the eval kernel
//     pays nothing for the codes.
//   * backward dy: a gather, one thread per input element, which sums
//     the at most four windows whose code names it.  No atomics.
//   * backward sums (fused stem only): per-block partials in shared
//     memory with a fixed halving tree, then one block per channel in a
//     fixed order.  No float atomics, so two runs give the same bits, and
//     the plain PyTorch version (stem_pool.py) repeats the same additions.
//
// Semantics, bit for bit as the TPU kernels (stem_pool.py:81-199,
// :202-288, :422-436) and the classic apply (models/layers.py
// FusedBatchNorm):
//   * fused stem: inv_b = bf16(inv), shift_b = bf16(shift) per channel;
//     t = bf16_rn(y * inv_b), then bf16_rn(t + shift_b): two roundings,
//     each op in f32 with __fmul_rn / __fadd_rn so nvcc cannot contract
//     them into an FMA (the f32 product of two bf16 values is exact; the
//     f32 sum then bf16 round is what XLA and PyTorch do for a bf16 add);
//     pool-only stem: the bf16 input itself;
//   * TF SAME windows for k=3, s=2: Ho = ceil(H/2),
//     pad_top = max((Ho-1)*2+3-H, 0) / 2 (0 for even H); taps outside the
//     image are skipped, which is -inf padding (the TPU's pool-only kernel
//     pads with -3e38, the fused one with 0, which relu makes the same);
//   * max in f32 with NaN propagating (as jnp.maximum and torch
//     max_pool2d: once the running max is NaN it stays NaN), then relu
//     for the fused stem; bf16 out through __float2bfloat16_rn, which
//     writes a NaN as 0x7fff, as PyTorch's own CUDA conversion does (its
//     CPU conversion writes 0x7fc0);
//   * code = the first tap (row-major) strictly above all before it (a
//     NaN tap is never above, so the code stops at the tap before it);
//     the fused stem writes 9 when the window's max is not > 0 (relu
//     clamps it: no gradient), the pool-only stem never does;
//   * dy: the routed dp terms added in the TPU kernel's order (window row
//     r-1 tap row 2 before window row r tap row 0; within a row tap 0 of
//     window t, then tap 2 of window t-1) into a zero f32 sum, times f32
//     inv for the fused stem, one bf16 round.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // threads per block, every kernel here
constexpr int kInactive = 9;       // code of a window that relu clamps

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// BN_RELU: the fused stem (BN prologue, relu epilogue, code 9 where relu
// clamps); otherwise the pool-only stem (inv and shift unused).
template <bool EMIT, bool BN_RELU>
__global__ void pool3x3s2_fwd_kernel(
    const __nv_bfloat16* __restrict__ y, const float* __restrict__ inv,
    const float* __restrict__ shift, __nv_bfloat16* __restrict__ out,
    uint8_t* __restrict__ codes, int NC, int C, int H, int W, int Ho, int Wo,
    int pad_top, int pad_left) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= Ho * Wo) return;
  const int ho = k / Wo;
  const int wo = k - ho * Wo;
  const int h0 = ho * 2 - pad_top;
  const int w0 = wo * 2 - pad_left;
  for (int nc = blockIdx.y; nc < NC; nc += gridDim.y) {
    float inv_b = 0.0f, shift_b = 0.0f;
    if (BN_RELU) {
      inv_b = bf16_round(inv[nc % C]);
      shift_b = bf16_round(shift[nc % C]);
    }
    const __nv_bfloat16* plane = y + (int64_t)nc * H * W;
    float m = -__int_as_float(0x7f800000);  // -inf
    int code = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int h = h0 + a;
      if (h < 0 || h >= H) continue;
      const __nv_bfloat16* row = plane + h * W;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int w = w0 + b;
        if (w < 0 || w >= W) continue;
        float v = __bfloat162float(row[w]);
        if (BN_RELU) {
          const float t = bf16_round(__fmul_rn(v, inv_b));
          v = bf16_round(__fadd_rn(t, shift_b));
        }
        if (EMIT && v > m) code = a * 3 + b;  // strict >: first tap wins
        m = (v > m || v != v) ? v : m;
      }
    }
    const int64_t o = (int64_t)nc * Ho * Wo + k;
    const float p = (!BN_RELU || m > 0.0f || m != m) ? m : 0.0f;
    out[o] = __float2bfloat16_rn(p);
    if (EMIT) codes[o] = (uint8_t)(!BN_RELU || m > 0.0f ? code : kInactive);
  }
}

// dy[n,c,i,j] = bf16(sum of dp over the windows whose code names (i, j)),
// terms in the TPU kernel's order (_route_row, stem_pool.py:221), times
// inv[c] before the round when SCALE (the fused stem).
template <bool SCALE>
__global__ void pool3x3s2_bwd_dy_kernel(
    const uint8_t* __restrict__ codes, const __nv_bfloat16* __restrict__ dp,
    const float* __restrict__ inv, __nv_bfloat16* __restrict__ dy, int NC,
    int C, int H, int W, int Ho, int Wo, int pad_top, int pad_left) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= H * W) return;
  const int i = k / W;
  const int j = k - i * W;
  const int ip = i + pad_top;   // row in padded coordinates
  const int jp = j + pad_left;
  // (window row, tap row) pairs in order; -1 marks an unused slot
  int wr[2], ta[2];
  if ((ip & 1) == 0) {
    wr[0] = ip / 2 - 1; ta[0] = 2;
    wr[1] = ip / 2;     ta[1] = 0;
  } else {
    wr[0] = (ip - 1) / 2; ta[0] = 1;
    wr[1] = -1;           ta[1] = 0;
  }
  int wc[2], tb[2];
  if ((jp & 1) == 0) {
    wc[0] = jp / 2;     tb[0] = 0;
    wc[1] = jp / 2 - 1; tb[1] = 2;
  } else {
    wc[0] = (jp - 1) / 2; tb[0] = 1;
    wc[1] = -1;           tb[1] = 0;
  }
  for (int nc = blockIdx.y; nc < NC; nc += gridDim.y) {
    const int64_t base = (int64_t)nc * Ho * Wo;
    float acc = 0.0f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int rr = wr[u];
      if (rr < 0 || rr >= Ho) continue;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int cc = wc[v];
        if (cc < 0 || cc >= Wo) continue;
        const int64_t q = base + rr * Wo + cc;
        if (codes[q] == ta[u] * 3 + tb[v])
          acc = __fadd_rn(acc, __bfloat162float(dp[q]));
      }
    }
    if (SCALE) acc = __fmul_rn(acc, inv[nc % C]);
    dy[(int64_t)nc * H * W + k] = __float2bfloat16_rn(acc);
  }
}

// Per (n, c) plane and block of kThreads pooled outputs: the sums of
// dp_active and dp_active * (p - shift), reduced by a halving tree.
__global__ void bn_pool_relu_bwd_partial_kernel(
    const uint8_t* __restrict__ codes, const __nv_bfloat16* __restrict__ dp,
    const __nv_bfloat16* __restrict__ p, const float* __restrict__ shift,
    float* __restrict__ partial, int NC, int C, int plane, int chunks) {
  __shared__ float s0[kThreads];
  __shared__ float s1[kThreads];
  const int chunk = blockIdx.x;
  const int k = chunk * kThreads + threadIdx.x;
  for (int nc = blockIdx.y; nc < NC; nc += gridDim.y) {
    float t0 = 0.0f, t1 = 0.0f;
    if (k < plane) {
      const int64_t q = (int64_t)nc * plane + k;
      if (codes[q] <= 8) {
        t0 = __bfloat162float(dp[q]);
        t1 = __fmul_rn(t0,
                       __fsub_rn(__bfloat162float(p[q]), shift[nc % C]));
      }
    }
    s0[threadIdx.x] = t0;
    s1[threadIdx.x] = t1;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s) {
        s0[threadIdx.x] = __fadd_rn(s0[threadIdx.x], s0[threadIdx.x + s]);
        s1[threadIdx.x] = __fadd_rn(s1[threadIdx.x], s1[threadIdx.x + s]);
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      float* dst = partial + ((int64_t)nc * chunks + chunk) * 2;
      dst[0] = s0[0];
      dst[1] = s1[0];
    }
    __syncthreads();  // the next plane reuses s0 and s1
  }
}

// One block per channel: thread t adds partials t, t+kThreads, ... of the
// channel's (n, chunk) list in order, then the halving tree.
__global__ void bn_pool_relu_bwd_final_kernel(
    const float* __restrict__ partial, float* __restrict__ sums, int N,
    int C, int chunks) {
  __shared__ float s0[kThreads];
  __shared__ float s1[kThreads];
  const int c = blockIdx.x;
  const int64_t count = (int64_t)N * chunks;
  float a0 = 0.0f, a1 = 0.0f;
  for (int64_t k = threadIdx.x; k < count; k += kThreads) {
    const int64_t n = k / chunks;
    const int64_t chunk = k % chunks;
    const float* src = partial + ((n * C + c) * chunks + chunk) * 2;
    a0 = __fadd_rn(a0, src[0]);
    a1 = __fadd_rn(a1, src[1]);
  }
  s0[threadIdx.x] = a0;
  s1[threadIdx.x] = a1;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      s0[threadIdx.x] = __fadd_rn(s0[threadIdx.x], s0[threadIdx.x + s]);
      s1[threadIdx.x] = __fadd_rn(s1[threadIdx.x], s1[threadIdx.x + s]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    sums[c] = s0[0];
    sums[C + c] = s1[0];
  }
}

// Grid of a per-plane kernel: x over the `per_plane` positions of a
// plane; y over the NC planes, cut so that the grid holds about four
// waves of resident blocks (8 blocks of kThreads per SM) and each block
// loops over planes blockIdx.y, blockIdx.y + gridDim.y, ...
dim3 plane_grid(int per_plane, int NC, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess || sms <= 0)
    sms = 132;  // the H100 SXM's count; only the grid's shape depends on it
  const int x = (per_plane + kThreads - 1) / kThreads;
  int y = sms * 8 * 4 / x;
  y = y < 1 ? 1 : y;
  y = y > NC ? NC : y;
  return dim3(x, y > 65535 ? 65535 : y);
}

}  // namespace

extern "C" {

// y [N, C, H, W] bf16 contiguous; inv, shift [C] f32; out [N, C, Ho, Wo]
// bf16 contiguous.  Launches on `stream` of device `device` and returns
// the cudaError_t of the launch (0 on success).  Allocates nothing.
int yolo_bn_pool_relu_eval(const void* y, const void* inv, const void* shift,
                           void* out, int N, int C, int H, int W, int Ho,
                           int Wo, int pad_top, int pad_left, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((int64_t)N * C * Ho * Wo == 0) return 0;
  pool3x3s2_fwd_kernel<false, true>
      <<<plane_grid(Ho * Wo, N * C, device), kThreads, 0,
         (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)y, (const float*)inv, (const float*)shift,
      (__nv_bfloat16*)out, nullptr, N * C, C, H, W, Ho, Wo, pad_top,
      pad_left);
  return (int)cudaGetLastError();
}

// As yolo_bn_pool_relu_eval, plus codes [N, C, Ho, Wo] uint8: the winning
// tap 0-8 of each window, or 9 where relu clamps it.
int yolo_bn_pool_relu_fwd(const void* y, const void* inv, const void* shift,
                          void* out, void* codes, int N, int C, int H, int W,
                          int Ho, int Wo, int pad_top, int pad_left,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((int64_t)N * C * Ho * Wo == 0) return 0;
  pool3x3s2_fwd_kernel<true, true>
      <<<plane_grid(Ho * Wo, N * C, device), kThreads, 0,
         (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)y, (const float*)inv, (const float*)shift,
      (__nv_bfloat16*)out, (uint8_t*)codes, N * C, C, H, W, Ho, Wo, pad_top,
      pad_left);
  return (int)cudaGetLastError();
}

// codes [N, C, Ho, Wo] uint8, dp and p [N, C, Ho, Wo] bf16, inv and shift
// [C] f32 -> dy [N, C, H, W] bf16 and sums [2, C] f32 (sum of dp_active,
// sum of dp_active * (p - shift)).  partial is caller-allocated scratch of
// N * C * ceil(Ho*Wo / 256) * 2 floats.  Three launches on `stream`.
int yolo_bn_pool_relu_bwd(const void* codes, const void* dp, const void* p,
                          const void* inv, const void* shift, void* dy,
                          void* partial, void* sums, int N, int C, int H,
                          int W, int Ho, int Wo, int pad_top, int pad_left,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if ((int64_t)N * C * H * W == 0) return 0;
  pool3x3s2_bwd_dy_kernel<true>
      <<<plane_grid(H * W, N * C, device), kThreads, 0, s>>>(
      (const uint8_t*)codes, (const __nv_bfloat16*)dp, (const float*)inv,
      (__nv_bfloat16*)dy, N * C, C, H, W, Ho, Wo, pad_top, pad_left);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int plane = Ho * Wo;
  const int chunks = (plane + kThreads - 1) / kThreads;
  bn_pool_relu_bwd_partial_kernel
      <<<plane_grid(plane, N * C, device), kThreads, 0, s>>>(
      (const uint8_t*)codes, (const __nv_bfloat16*)dp,
      (const __nv_bfloat16*)p, (const float*)shift, (float*)partial, N * C,
      C, plane, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_pool_relu_bwd_final_kernel<<<C, kThreads, 0, s>>>(
      (const float*)partial, (float*)sums, N, C, chunks);
  return (int)cudaGetLastError();
}

// y [N, C, H, W] bf16 contiguous -> out [N, C, Ho, Wo] bf16 contiguous,
// the pool-only stem's max.  Launches on `stream` of device `device` and
// returns the cudaError_t of the launch.  Allocates nothing.
int yolo_max_pool_s2_eval(const void* y, void* out, int N, int C, int H,
                          int W, int Ho, int Wo, int pad_top, int pad_left,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((int64_t)N * C * Ho * Wo == 0) return 0;
  pool3x3s2_fwd_kernel<false, false>
      <<<plane_grid(Ho * Wo, N * C, device), kThreads, 0,
         (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)y, nullptr, nullptr, (__nv_bfloat16*)out,
      nullptr, N * C, C, H, W, Ho, Wo, pad_top, pad_left);
  return (int)cudaGetLastError();
}

// As yolo_max_pool_s2_eval, plus codes [N, C, Ho, Wo] uint8: the winning
// tap 0-8 of each window.
int yolo_max_pool_s2_fwd(const void* y, void* out, void* codes, int N, int C,
                         int H, int W, int Ho, int Wo, int pad_top,
                         int pad_left, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((int64_t)N * C * Ho * Wo == 0) return 0;
  pool3x3s2_fwd_kernel<true, false>
      <<<plane_grid(Ho * Wo, N * C, device), kThreads, 0,
         (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)y, nullptr, nullptr, (__nv_bfloat16*)out,
      (uint8_t*)codes, N * C, C, H, W, Ho, Wo, pad_top, pad_left);
  return (int)cudaGetLastError();
}

// codes [N, C, Ho, Wo] uint8 and dp [N, C, Ho, Wo] bf16 -> dy [N, C, H, W]
// bf16, dp routed to the winning taps.  One launch on `stream`.
int yolo_max_pool_s2_bwd(const void* codes, const void* dp, void* dy, int N,
                         int C, int H, int W, int Ho, int Wo, int pad_top,
                         int pad_left, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((int64_t)N * C * H * W == 0) return 0;
  pool3x3s2_bwd_dy_kernel<false>
      <<<plane_grid(H * W, N * C, device), kThreads, 0,
         (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const __nv_bfloat16*)dp, nullptr,
      (__nv_bfloat16*)dy, N * C, C, H, W, Ho, Wo, pad_top, pad_left);
  return (int)cudaGetLastError();
}

const char* yolo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

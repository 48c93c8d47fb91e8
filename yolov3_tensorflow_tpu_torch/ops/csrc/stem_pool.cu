// Fused eval stem for Hopper: p = relu(maxpool3x3/s2_SAME(bn(y))), NCHW.
//
// Replaces the TPU kernel yolov3_tensorflow_tpu/ops/stem_pool.py
// bn_pool_relu_eval (-> _fwd_local, _fwd_kernel with EMIT=False).
//
// What bounds it on an H100: bytes.  Per output element the kernel does
// 9 bf16 multiplies, 9 adds and 9 compares on inputs it reads once from
// device memory (~0.1 operations per byte), so the floor is reading y
// (N*C*H*W*2 bytes) and writing p (N*C*Ho*Wo*2 bytes) at the card's
// memory rate.  Design: one thread per pooled output, threads of a warp on
// neighbouring output columns of one row, so each of the three input rows
// a warp reads is one contiguous run of ~66 bf16 values; the overlapping
// window rows and columns that neighbouring threads share come from L1/L2
// rather than device memory.  Simple and right first; a shared-memory
// row-band version is later work.
//
// Semantics, bit for bit as the TPU kernel (stem_pool.py:81-142) and the
// classic apply (models/layers.py FusedBatchNorm):
//   * inv_b = bf16(inv), shift_b = bf16(shift) per channel;
//   * t = bf16_rn(y * inv_b), then bf16_rn(t + shift_b): two roundings,
//     each op in f32 with __fmul_rn / __fadd_rn so nvcc cannot contract
//     them into an FMA (the f32 product of two bf16 values is exact; the
//     f32 sum then bf16 round is what XLA and PyTorch do for a bf16 add);
//   * TF SAME windows for k=3, s=2: Ho = ceil(H/2),
//     pad_top = max((Ho-1)*2+3-H, 0) / 2 (0 for even H); taps outside the
//     image are skipped, which equals zero padding because relu follows;
//   * max in f32 (NaN propagates, as in torch max_pool2d), relu, bf16 out.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void bn_pool_relu_eval_kernel(
    const __nv_bfloat16* __restrict__ y, const float* __restrict__ inv,
    const float* __restrict__ shift, __nv_bfloat16* __restrict__ out,
    int C, int H, int W, int Ho, int Wo, int pad_top, int pad_left,
    int64_t total) {
  const int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const int wo = (int)(o % Wo);
  const int64_t r = o / Wo;
  const int ho = (int)(r % Ho);
  const int64_t nc = r / Ho;  // n * C + c
  const int c = (int)(nc % C);
  const float inv_b = bf16_round(inv[c]);
  const float shift_b = bf16_round(shift[c]);
  const __nv_bfloat16* plane = y + nc * (int64_t)H * W;
  const int h0 = ho * 2 - pad_top;
  const int w0 = wo * 2 - pad_left;
  float m = -__int_as_float(0x7f800000);  // -inf
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int h = h0 + a;
    if (h < 0 || h >= H) continue;
    const __nv_bfloat16* row = plane + (int64_t)h * W;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int w = w0 + b;
      if (w < 0 || w >= W) continue;
      const float t = bf16_round(__fmul_rn(__bfloat162float(row[w]), inv_b));
      const float v = bf16_round(__fadd_rn(t, shift_b));
      m = (v > m || v != v) ? v : m;
    }
  }
  const float p = (m > 0.0f || m != m) ? m : 0.0f;
  out[o] = __float2bfloat16_rn(p);
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
  const int64_t total = (int64_t)N * C * Ho * Wo;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  bn_pool_relu_eval_kernel<<<(unsigned int)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)y, (const float*)inv, (const float*)shift,
      (__nv_bfloat16*)out, C, H, W, Ho, Wo, pad_top, pad_left, total);
  return (int)cudaGetLastError();
}

const char* yolo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

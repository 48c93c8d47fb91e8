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
// 46 us at the bf16 tensor-core peak.  So every mode is bound by its
// bytes: 53 us for the modes that move two tensors, up to 212 us for the
// eight of PRO_DYEFF + EPI_BN_ADD; module 1's [128, 64, 104, 104] -> 64
// has twice the bytes for the same products (106 to 423 us).
//
// What held the first design (32 tiles x 64 channels a block, all 16
// transform positions' float32 sums live at once, WMMA) far from that:
// one 512-thread block an SM with nothing overlapped inside a channel
// step, every input element gathered about 8 times with 2-byte loads, and
// all accumulators sent through shared memory for the AT stage.  This
// design, one block an SM, each block a band of output tiles of one image
// and 64 output channels, in three phases:
//
//   * phase 1, the band.  A block owns R whole tile rows (past 64 tiles a
//     row, a column segment of one): at most 64 tiles, wgmma's M.  Its
//     input rows 2*tr0-2 .. 2*tr0+2R of every input channel (and of the
//     partner, the identity or y) are copied once, one contiguous run per
//     channel, with 16-byte cp.async copies into a two-chunk staging ring.
//     All sixteen warps apply the prologue once per element while
//     transposing the chunk into the z band [row][column][channel] (zero
//     outside the image: the conv's padding; 16-byte chunks swizzled by
//     column, so the stores and the later loads are free of bank
//     conflicts), and write the aux output once, in bf16x2 pairs;
//   * phase 2, the products, in the JAX kernel's kj-major order.
//     Warpgroups 2 and 3 (the producers) form V_k = BT d BT^T for the 64
//     tiles from the z band, position k = 4 ki + kj taken kj by kj (a row
//     add and a column add of bf16x2 pairs, each rounded to bf16, as the
//     TPU kernel rounds), into one of two shared-memory V buffers, and
//     stage U_k beside it with one bulk copy (winograd_u_layout_kernel
//     lays U out once per launch in the blocks' layout).  Warpgroups 0 and
//     1 (the consumers) each run wgmma m64n32k16 (bf16 operands, float32
//     sums, A and B from shared memory, no-swizzle core matrices) on their
//     32 output channels while the producers fill the other buffer; named
//     barriers hand the buffers over.  The consumers fold the AT stages in
//     as each product finishes: r0 = (M0 + M1) + M2 and r1 = (M1 - M2) -
//     M3 per kj, then the column stage (r[0] + r[1]) + r[2] and (r[1] -
//     r[2]) - r[3] accumulated kj by kj, left to right: eight float32 sets
//     per (tile, output channel) live instead of sixteen, so the two
//     consumer warpgroups hold a 64 x 64 block in registers (setmaxnreg
//     gives them 152 a thread, the producers 104);
//   * phase 3, the epilogue.  The consumers put the outputs in shared
//     memory; all sixteen warps then take whole output channels, their
//     lanes along the band's rows: the epilogue on the unrounded output of
//     the positions inside the image (its inputs, c, a and d, staged at
//     the start with bulk copies), bf16x2 stores where W is even, the
//     per-channel sums in a fixed order (a lane's own, then a shuffle
//     tree) into one partial row per block of tiles; one block per channel
//     then adds the rows in a fixed order.  No float atomics: two runs give
//     the same bits.
//
// Two variants per mode: ALIGNED, where every band's first row and the
// (n, c) plane start on 16 bytes (both chain shapes, and every input size
// a multiple of 32), stages with 16-byte copies; the other stages the same
// band with 2-byte loads (odd widths and small planes).  ops/winograd.py
// (winograd_plan) computes the geometry and picks the variant.
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
//   * BT rows then columns, each add rounded to bf16 (fma(a, 1, b) of two
//     bf16 values equals the float32 add rounded to bf16); AT rows then
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
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int PRO_NONE = 0, PRO_BN_ACT = 1, PRO_BN_ADD = 2, PRO_DYEFF = 3;
constexpr int EPI_NONE = 0, EPI_STATS = 1, EPI_BN_ACT = 2, EPI_BN_ADD = 3;

// four warpgroups: 0 and 1 run the products (the consumers), 2 and 3
// form V and stage U for them (the producers); all four stage the band.
// setmaxnreg moves registers within the block's launch allocation of
// 128 a thread: 256 * 104 + 256 * 152 = 512 * 128.
constexpr int kThreads = 512;
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 104, kConsumerRegs = 152;
// named barriers (0 is __syncthreads): V and U of buffer b ready, buffer
// b free again, the consumers' own
constexpr int kBarFull = 1, kBarFree = 3, kBarConsumers = 5,
              kBarEpilogue = 6;
constexpr int kTiles = 64;     // tiles per block: wgmma's M
constexpr int kCoBlock = 64;   // output channels per block
constexpr int kCoWg = 32;      // per warpgroup: wgmma's N
constexpr int kMaxSmem = 232448;  // per block on an H100
constexpr int kFinalThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kStages = 2;  // the staging ring: one chunk in flight

// Launch geometry (ops/winograd.py winograd_plan) and operands.
struct Params {
  const bf16* x;
  const bf16* partner;
  const bf16* u;
  const unsigned char* ut;  // U in the blocks' shared-memory layout
  const bf16* cvals;
  const bf16* avals;
  const bf16* dvals;
  const float* scal;
  const float* scal2;
  bf16* out;
  bf16* aux;
  bf16* out3;
  float* partial;
  int C, Co, H, W, TH, TW;
  int R, TWb, segs, bands, co_blocks;
  int C16;    // C rounded up to wgmma's K step
  int cch;    // input channels per staging chunk
  int run_p;  // staging elements per channel (a band run, padded to 8)
  int zw;     // z band columns: 2 * TWb + 2
  int epi_p;  // staged epilogue elements per output channel (padded to 8)
  int zswz;   // 7 where C is a multiple of 64 (z chunk swizzle), else 0
  int z_bytes, epi_offset, region_bytes;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float relu_keep_nan(float v) {
  return v != v ? v : (0.0f < v ? v : 0.0f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  // src_bytes < 16 fills the rest with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy shared-memory writes (st.shared, cp.async) made visible
// to the tensor cores' async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, no swizzle: lbo the byte stride between
// core matrices (8 rows x 16 bytes) along K, sbo along M or N
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3fff) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32);
}

// D (64 x 32, f32) (+)= A (64 x 16, K-major) * B (16 x 32, N-major)
__device__ __forceinline__ void wgmma_m64n32k16(float* d, uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// a bulk (TMA) copy of bytes (a multiple of 16) from global to shared
// memory, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across the
// asynchronous product
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// a + b on eight bf16 values (four bf16x2 words) with b's sign bits
// flipped by neg, each sum rounded to bf16: a + b, or a - b (= a + (-b),
// bitwise), as the float32 op rounded to bf16.  As fma(a, 1, b): one
// rounding of the exact sum, and twice the rate of the bf16 add on an
// H100.
__device__ __forceinline__ uint4 add8(uint4 a, uint4 b, uint32_t neg) {
  const uint32_t av[4] = {a.x, a.y, a.z, a.w};
  const uint32_t bv[4] = {b.x ^ neg, b.y ^ neg, b.z ^ neg, b.w ^ neg};
  const uint32_t one_bits = 0x3f803f80u;  // bf16x2 (1, 1)
  const __nv_bfloat162 one = *reinterpret_cast<const __nv_bfloat162*>(&one_bits);
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 s =
        __hfma2(*reinterpret_cast<const __nv_bfloat162*>(&av[i]), one,
                *reinterpret_cast<const __nv_bfloat162*>(&bv[i]));
    r[i] = *reinterpret_cast<const uint32_t*>(&s);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// BT's row (or column) combo q of d0..d3 as first +- second (BT =
// [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]]; combo 2 is -d1 + d2,
// computed as d2 - d1): the two terms and the sign mask of the second
__device__ __forceinline__ int bt_first(int q) {
  return q == 0 ? 0 : (q == 2 ? 2 : 1);
}
__device__ __forceinline__ int bt_second(int q) {
  return q == 0 ? 2 : (q == 2 ? 1 : (q == 1 ? 2 : 3));
}
__device__ __forceinline__ uint32_t bt_neg(int q) {
  return q == 1 ? 0u : 0x80008000u;
}

// Prologue of one element, in the TPU kernel's op order.
template <int PRO>
__device__ __forceinline__ float prologue(float v, float partner, float s0,
                                          float s1) {
  if (PRO == PRO_BN_ACT) {
    v = bf16_round(__fmul_rn(v, s0));
    v = relu_keep_nan(bf16_round(__fadd_rn(v, s1)));
  } else if (PRO == PRO_BN_ADD) {
    v = bf16_round(__fmul_rn(v, s0));
    v = bf16_round(__fadd_rn(v, s1));
    v = relu_keep_nan(bf16_round(__fadd_rn(v, partner)));
  } else if (PRO == PRO_DYEFF) {
    v = bf16_round(__fadd_rn(__fadd_rn(v, s0), __fmul_rn(s1, partner)));
  }
  return v;
}

template <int PRO, int EPI, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, 1)
    winograd_f2x3_kernel(const Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr bool kPartner = PRO == PRO_BN_ADD || PRO == PRO_DYEFF;
  const int tid = threadIdx.x;
  const int C = p.C, Co = p.Co, H = p.H, W = p.W;

  // ---- this block: co-block, column segment, tile-row band, image
  int rest = blockIdx.x;
  const int cb = rest % p.co_blocks;
  rest /= p.co_blocks;
  const int seg = rest % p.segs;
  rest /= p.segs;
  const int band = rest % p.bands;
  const int n = rest / p.bands;
  const int prow = blockIdx.x / p.co_blocks;  // its partial-sum row
  const int tr0 = band * p.R;
  const int rb = min(p.R, p.TH - tr0);       // tile rows
  const int tc0 = seg * p.TWb;
  const int twe = min(p.TWb, p.TW - tc0);    // tile columns
  const int nt = rb * twe;                   // tiles
  const int s_row = max(2 * tr0 - 2, 0);     // the band's first row
  const int e_row = min(2 * tr0 + 2 * rb + 1, H);
  const int run = (e_row - s_row) * W;       // elements per channel
  const int co0 = cb * kCoBlock;
  const int64_t plane = (int64_t)H * W;
  const bool write_aux = p.aux != nullptr && cb == 0;

  bf16* zb = reinterpret_cast<bf16*>(smem);  // the z band [2R+2][zw][C]
  // then the region: the staging ring in phase 1; in phases 2 and 3 the
  // two V and two U buffers (later o_s) and, past them, the epilogue's
  // inputs [tensor][64 channels][epi_p]
  unsigned char* region = smem + p.z_bytes;
  bf16* epi_s = reinterpret_cast<bf16*>(region + p.epi_offset);
  float* pscal = reinterpret_cast<float*>(
      region + p.region_bytes);  // the prologue's [2][C] scalars
  // mbarriers: the staged epilogue inputs', U's two buffers'
  uint64_t* mbar = reinterpret_cast<uint64_t*>(pscal + 2 * C);
  const int N = gridDim.x / p.co_blocks / p.bands / p.segs;
  // EPI_BN_ACT / EPI_BN_ADD: the consumers stage this block's rows of
  // cvals (and avals, dvals) with bulk copies as phase 2 starts, where the
  // rows start on 16 bytes and the copies stay inside the tensors (all
  // but the very last block of a tensor); they land during the products
  constexpr bool kMask = EPI == EPI_BN_ACT || EPI == EPI_BN_ADD;
  constexpr int kEpiTensors = EPI == EPI_BN_ADD ? 3 : 1;
  const int or0 = 2 * tr0;  // the block's first output row
  const int epi_run = min(2 * rb, H - or0) * W;
  const bool epi_bulk =
      kMask && plane % 8 == 0 && (or0 * W) % 8 == 0 &&
      ((int64_t)n * Co + min(co0 + kCoBlock, Co) - 1) * plane + or0 * W +
              ((epi_run + 7) & ~7) <= (int64_t)N * Co * plane;
  const int zr = 2 * p.R + 2, zw = p.zw;
  if (PRO != PRO_NONE) {
    for (int c = tid; c < C; c += kThreads) {
      if (PRO == PRO_DYEFF) {
        pscal[c] = p.scal2[c];
        pscal[C + c] = 2.0f * p.scal2[C + c];
      } else {
        pscal[c] = bf16_round(p.scal[c]);
        pscal[C + c] = bf16_round(p.scal[C + c]);
      }
    }
  }  // read after phase 1's first barrier

  // ---- phase 1: stage the band a chunk of channels at a time, apply the
  // prologue, write aux, transpose into the z band
  {
    const int stage_elems = p.cch * p.run_p;
    bf16* stage = reinterpret_cast<bf16*>(region);
    const int nchunks = (C + p.cch - 1) / p.cch;
    if (tid == 0) {
      for (int i = 0; i < 3; ++i) mbar_init(&mbar[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // ALIGNED: 16-byte copies (the last of a run reads only the run's
    // tail); otherwise 2-byte copies
    auto issue = [&](int ci, int buf) {
      const int c0 = ci * p.cch;
      const int cc = min(p.cch, C - c0);
      const int nt_ = kPartner ? 2 : 1;
#pragma unroll
      for (int tsr = 0; tsr < nt_; ++tsr) {
        const bf16* src0 = (tsr ? p.partner : p.x) +
                           ((int64_t)n * C + c0) * plane + (int64_t)s_row * W;
        bf16* dst0 = stage + (buf * nt_ + tsr) * stage_elems;
        if (ALIGNED) {
          // a warp a channel run at a time, its lanes along the run
          const int nvec = (run + 7) >> 3;
          for (int cl = tid >> 5; cl < cc; cl += kThreads / 32)
            for (int v = tid & 31; v < nvec; v += 32)
              cp_async16(smem_u32(dst0 + cl * p.run_p + v * 8),
                         src0 + cl * plane + v * 8,
                         min(16, 2 * (run - v * 8)));
        } else {
          for (int e = tid; e < cc * run; e += kThreads) {
            const int cl = e / run, v = e - cl * run;
            dst0[cl * p.run_p + v] = src0[cl * plane + v];
          }
        }
      }
      cp_async_commit();
    };

    issue(0, 0);
    for (int ci = 0; ci < nchunks; ++ci) {
      if (ci + 1 < nchunks) {
        issue(ci + 1, (ci + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int c0 = ci * p.cch;
      const int cc = min(p.cch, C - c0);
      const bf16* xs = stage + (ci & 1) * (kPartner ? 2 : 1) * stage_elems;
      const bf16* ps = xs + stage_elems;
      // work item: one z row, a strip of 32 column pairs (one a lane:
      // image columns q0 = 2 (tc0 + pj) - 2 and q0 + 1, z columns 2 pj - 1
      // and 2 pj; conflict-free stores under the z swizzle), 8 channels;
      // items are warp-uniform
      const int npairs = p.TWb + 2;
      const int strips = (npairs + 31) >> 5, groups = cc >> 3;
      const int lane = tid & 31;
      const bool even_w = (W & 1) == 0;  // a pair is one aligned word
      // item it = (zrow * strips + strip) * groups + cgl, walked with a
      // stride of the block's warps (decoded once, then stepped)
      constexpr int kWarpsAll = kThreads / 32;
      int cgl = (tid >> 5) % groups, pos = (tid >> 5) / groups;
      int strip = pos % strips, zrow = pos / strips;
      const int step_pos = kWarpsAll / groups, step_cgl = kWarpsAll % groups;
      for (; zrow < zr; ) {
        const int pj = strip * 32 + lane;
        const int cgl_now = cgl;
        const int zrow_now = zrow;
        // the next item of this warp
        cgl += step_cgl;
        int dpos = step_pos;
        if (cgl >= groups) {
          cgl -= groups;
          ++dpos;
        }
        strip += dpos;
        while (strip >= strips) {
          strip -= strips;
          ++zrow;
        }
        if (pj >= npairs) continue;
        const int r = 2 * tr0 - 1 + zrow_now;
        const int q0 = 2 * (tc0 + pj) - 2;
        const bool row_ok = r >= 0 && r < e_row;
        bool ok[2], own[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = q0 + h;
          ok[h] = row_ok && q >= 0 && q < W;
          own[h] = write_aux && ok[h] && r >= 2 * tr0 &&
                   r < 2 * tr0 + 2 * rb && q >= 2 * tc0 &&
                   q < 2 * tc0 + 2 * twe;
        }
        const int c = c0 + cgl_now * 8;
        // the pair of 8 channels (and the partner's), loads first; a
        // missing column reads 0
        const int off = cgl_now * 8 * p.run_p + (r - s_row) * W + q0;
        uint32_t xw[8], pw[8];
        {
          const bf16* px = xs + off;
          const bf16* pp = ps + off;
          const bool word = even_w && ok[0] && ok[1];
#pragma unroll
          for (int i = 0; i < 8; ++i, px += p.run_p, pp += p.run_p) {
            if (word) {
              xw[i] = *reinterpret_cast<const uint32_t*>(px);
              pw[i] = kPartner ? *reinterpret_cast<const uint32_t*>(pp) : 0u;
            } else {
              const uint32_t lo = ok[0] ? *reinterpret_cast<const unsigned short*>(px) : 0u;
              const uint32_t hi = ok[1] ? *reinterpret_cast<const unsigned short*>(px + 1) : 0u;
              xw[i] = lo | (hi << 16);
              const uint32_t plo = kPartner && ok[0] ? *reinterpret_cast<const unsigned short*>(pp) : 0u;
              const uint32_t phi = kPartner && ok[1] ? *reinterpret_cast<const unsigned short*>(pp + 1) : 0u;
              pw[i] = plo | (phi << 16);
            }
          }
        }
        // zv[h][i/2]: column h, channels i and i + 1, bf16x2
        uint32_t zv[2][4];
        if (PRO == PRO_NONE) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            zv[0][i] = __byte_perm(xw[2 * i], xw[2 * i + 1], 0x5410);
            zv[1][i] = __byte_perm(xw[2 * i], xw[2 * i + 1], 0x7632);
          }
        } else {
          float s0v[8], s1v[8];
          *reinterpret_cast<float4*>(s0v) = *reinterpret_cast<const float4*>(pscal + c);
          *reinterpret_cast<float4*>(s0v + 4) = *reinterpret_cast<const float4*>(pscal + c + 4);
          *reinterpret_cast<float4*>(s1v) = *reinterpret_cast<const float4*>(pscal + C + c);
          *reinterpret_cast<float4*>(s1v + 4) = *reinterpret_cast<const float4*>(pscal + C + c + 4);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 8; i += 2) {
              float v2[2];
#pragma unroll
              for (int d = 0; d < 2; ++d) {
                const uint32_t xv = xw[i + d], pv = pw[i + d];
                const float x = __uint_as_float(h ? xv & 0xffff0000u : xv << 16);
                const float y = __uint_as_float(h ? pv & 0xffff0000u : pv << 16);
                v2[d] = ok[h] ? prologue<PRO>(x, y, s0v[i + d], s1v[i + d]) : 0.0f;
              }
              const __nv_bfloat162 b2 = __floats2bfloat162_rn(v2[0], v2[1]);
              zv[h][i / 2] = *reinterpret_cast<const uint32_t*>(&b2);
            }
        }
        if (own[0] || own[1]) {
          bf16* dst =
              p.aux + ((int64_t)n * C + c) * plane + (int64_t)r * W + q0;
          const bool word = even_w && own[0] && own[1];
#pragma unroll
          for (int i = 0; i < 8; ++i, dst += plane) {
            // channel i of both columns
            const uint32_t w2 = __byte_perm(zv[0][i / 2], zv[1][i / 2],
                                            i & 1 ? 0x7632 : 0x5410);
            if (word) {
              *reinterpret_cast<uint32_t*>(dst) = w2;
            } else {
              if (own[0]) *reinterpret_cast<unsigned short*>(dst) = w2 & 0xffffu;
              if (own[1]) *reinterpret_cast<unsigned short*>(dst + 1) = w2 >> 16;
            }
          }
        }
        const int cg = c >> 3;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int zcol = 2 * pj - 1 + h;
          if (zcol < 0 || zcol >= zw) continue;
          *reinterpret_cast<uint4*>(
              zb + (zrow_now * zw + zcol) * C +
              ((cg ^ ((zcol >> 1) & p.zswz)) * 8)) =
              make_uint4(zv[h][0], zv[h][1], zv[h][2], zv[h][3]);
        }
      }
      __syncthreads();
    }
  }

  // ---- phase 2: the 16 products, kj-major, with the AT fold
  const int C16 = p.C16, kg = C16 / 8, c8 = C / 8;
  const int vu_bytes = kTiles * C16 * 2 + 128;  // one V or U buffer
  // buffer i of V at region + i * vu_bytes, of U at region + (2 + i) *
  // vu_bytes
  auto vbuf = [&](int i) { return region + i * vu_bytes; };
  auto ubuf = [&](int i) { return region + (2 + i) * vu_bytes; };
  // U_k [C][co0 .. co0+63] -> N-major core matrices: co group g at g *
  // b_sbo (16 bytes past a multiple of 128, so that the eight groups of
  // one channel row land on different banks), channel group c / 8 at
  // (c / 8) * 128, channel c % 8 at 16-byte rows
  // (written so by winograd_u_layout_kernel, U_k of this co-block is one
  // vu_bytes run of ut, copied by one bulk copy)
  const uint32_t b_sbo = (uint32_t)kg * 128 + 16;
  const unsigned char* ut_block = p.ut + (int64_t)cb * 16 * vu_bytes;
  // the bulk copies of phase 2 rewrite what phase 1 read
  fence_async_smem();
  __syncthreads();

  // ---- the epilogue's channel loop, run by all sixteen warps (both roles:
  // each path keeps its own register budget): each warp takes whole output
  // channels from o_s, its lanes along the rows (bf16x2 accesses where W is
  // even), and adds the channel's sums in a fixed order: a lane's own,
  // then a shuffle tree
  float* o_s = reinterpret_cast<float*>(region);
  const int orows = 2 * p.R, ocols = 2 * p.TWb;
  auto epilogue_rows = [&]() {
    const int lane = tid & 31;
    const int nrow = min(2 * rb, H - or0);         // output rows
    const int npair = (min(2 * twe, W - 2 * tc0) + 1) >> 1;  // column pairs
    const bool pairs = (W & 1) == 0;  // bf16x2 accesses stay aligned
    // two bf16 a word: at k of a global tensor, or of the staged rows
    auto load2 = [&](const bf16* src, int64_t k, bool both) -> uint32_t {
      if (pairs && both) return *reinterpret_cast<const uint32_t*>(src + k);
      const uint32_t lo = *reinterpret_cast<const unsigned short*>(src + k);
      const uint32_t hi =
          both ? *reinterpret_cast<const unsigned short*>(src + k + 1) : 0u;
      return lo | (hi << 16);
    };
    auto lo_f = [](uint32_t w) { return __uint_as_float(w << 16); };
    auto hi_f = [](uint32_t w) { return __uint_as_float(w & 0xffff0000u); };
    // this warp's channels col = warp + 16 m; their scalars, lane m
    constexpr int kWarps = kThreads / 32;
    float my_inv = 0.0f, my_shift = 0.0f;
    if (kMask && lane < kCoBlock / kWarps) {
      const int co = co0 + (tid >> 5) + kWarps * lane;
      if (co < Co) {
        my_inv = __ldg(p.scal + co);
        my_shift = __ldg(p.scal + Co + co);
      }
    }
    // two channels at a time (col and col + kWarps), interleaved
    for (int m = 0; m < kCoBlock / kWarps; m += 2) {
      int col[2], co[2];
      float minv[2], minv_b[2], mshift_b[2], s0[2], s1[2];
      int64_t base[2];
  #pragma unroll
      for (int u = 0; u < 2; ++u) {
        col[u] = (tid >> 5) + kWarps * (m + u);
        co[u] = co0 + col[u];
        minv[u] = __shfl_sync(0xffffffffu, my_inv, m + u);
        minv_b[u] = bf16_round(minv[u]);
        mshift_b[u] = bf16_round(__shfl_sync(0xffffffffu, my_shift, m + u));
        base[u] = ((int64_t)n * Co + co[u]) * plane + (int64_t)or0 * W;
        s0[u] = s1[u] = 0.0f;
      }
      if (co[0] >= Co) break;
      const bool second = co[1] < Co;
      for (int pc = lane; pc < npair; pc += 32) {
        const int q = 2 * tc0 + 2 * pc;  // image column
        const bool two = q + 1 < W;
  #pragma unroll 2
        for (int r = 0; r < nrow; ++r) {
          const int rq = r * W + q;  // from the block's first row
  #pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (u == 1 && !second) continue;
            const float2 ov = *reinterpret_cast<const float2*>(
                o_s + (col[u] * orows + r) * ocols + 2 * pc);
            float v[2] = {ov.x, ov.y}, g3[2] = {0.0f, 0.0f};
            uint32_t cw = 0u, aw = 0u, dw = 0u;
            if (kMask) {
              const bf16* es = epi_s + col[u] * p.epi_p;
              cw = epi_bulk ? load2(es, rq, two)
                            : load2(p.cvals, base[u] + rq, two);
              if (EPI == EPI_BN_ADD) {
                aw = epi_bulk ? load2(es + kCoBlock * p.epi_p, rq, two)
                              : load2(p.avals, base[u] + rq, two);
                dw = epi_bulk ? load2(es + 2 * kCoBlock * p.epi_p, rq, two)
                              : load2(p.dvals, base[u] + rq, two);
              }
            }
            const float cv[2] = {lo_f(cw), hi_f(cw)};
            const float av[2] = {lo_f(aw), hi_f(aw)};
            const float dv[2] = {lo_f(dw), hi_f(dw)};
  #pragma unroll
            for (int b = 0; b < 2; ++b) {
              if (b == 1 && !two) continue;
              const float val = v[b];
              if (EPI == EPI_STATS) {
                s0[u] = __fadd_rn(s0[u], val);
                s1[u] = __fadd_rn(s1[u], __fmul_rn(val, val));
              } else if (EPI == EPI_BN_ACT) {
                const float bn = bf16_round(__fadd_rn(
                    bf16_round(__fmul_rn(cv[b], minv_b[u])), mshift_b[u]));
                const float gv = bn > 0.0f ? val : 0.0f;
                s0[u] = __fadd_rn(s0[u], gv);
                s1[u] = __fadd_rn(s1[u], __fmul_rn(gv, cv[b]));
                v[b] = __fmul_rn(gv, minv[u]);
              } else if (EPI == EPI_BN_ADD) {
                // a was written by the forward's prologue: a > 0 exactly
                // where the boundary's pre-activation is
                const float gv = av[b] > 0.0f ? __fadd_rn(val, dv[b]) : 0.0f;
                s0[u] = __fadd_rn(s0[u], gv);
                s1[u] = __fadd_rn(s1[u], __fmul_rn(gv, cv[b]));
                g3[b] = gv;
                v[b] = __fmul_rn(gv, minv[u]);
              }
            }
            const int64_t k = base[u] + rq;
            if (pairs && two) {
              *reinterpret_cast<__nv_bfloat162*>(p.out + k) =
                  __floats2bfloat162_rn(v[0], v[1]);
              if (EPI == EPI_BN_ADD)
                *reinterpret_cast<__nv_bfloat162*>(p.out3 + k) =
                    __floats2bfloat162_rn(g3[0], g3[1]);
            } else {
              p.out[k] = __float2bfloat16_rn(v[0]);
              if (EPI == EPI_BN_ADD) p.out3[k] = __float2bfloat16_rn(g3[0]);
              if (two) {
                p.out[k + 1] = __float2bfloat16_rn(v[1]);
                if (EPI == EPI_BN_ADD)
                  p.out3[k + 1] = __float2bfloat16_rn(g3[1]);
              }
            }
          }
        }
      }
      if (EPI != EPI_NONE) {
  #pragma unroll
        for (int off = 16; off > 0; off >>= 1)
  #pragma unroll
          for (int u = 0; u < 2; ++u) {
            s0[u] = __fadd_rn(s0[u], __shfl_xor_sync(0xffffffffu, s0[u], off));
            s1[u] = __fadd_rn(s1[u], __shfl_xor_sync(0xffffffffu, s1[u], off));
          }
  #pragma unroll
        for (int u = 0; u < 2; ++u)
          if (lane == 0 && co[u] < Co) {
            p.partial[((int64_t)prow * 2) * Co + co[u]] = s0[u];
            p.partial[((int64_t)prow * 2 + 1) * Co + co[u]] = s1[u];
          }
      }
    }
  };

  // step = 4 kj + ki, kj-major: position k = 4 ki + kj; buffers b = step
  // & 1.  The producers form V_k and stage U_k into buffer b once the
  // consumers have freed it (kBarFree + b), then hand it over (kBarFull +
  // b); the consumers run the product, free the buffer and fold.
  if (tid >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    const int ptid = tid - kConsumers;
    // this thread's tile in the V transform (the same at every position)
    const int vt = ptid & (kTiles - 1);
    const bool vt_ok = vt < nt;
    int zbase = 0, zc0 = 0;
    if (vt_ok) {
      const int trl = vt / twe;
      zc0 = 2 * (vt - trl * twe);
      zbase = (2 * trl * zw + zc0) * C;
    }
    const bf16* zt = zb + zbase;
    constexpr int kStride = (kThreads - kConsumers) / kTiles;  // a pass
    for (int step = 0; step < 16; ++step) {
      const int b = step & 1;
      const int k = 4 * (step & 3) + (step >> 2);
      if (step >= 2) bar_sync(kBarFree + b, kThreads);
      // U_k: one bulk copy, completing on mbar[1 + b]
      if (ptid == 0) {
        mbar_expect_tx(&mbar[1 + b], (uint32_t)vu_bytes);
        bulk_copy(ubuf(b), ut_block + (int64_t)k * vu_bytes, vu_bytes,
                  &mbar[1 + b]);
      }
      // V_k [64 tiles][C16] -> K-major core matrices: channel group cg at
      // cg * 1024, tile t at 16-byte row t
      const int ki = k >> 2, kj = k & 3;
      // V = BT's column combo of its row combos: four z loads a unit
      const int ra = bt_first(ki), rbb = bt_second(ki);
      const int ca = bt_first(kj), cbb = bt_second(kj);
      const int o_aa = (ra * zw + ca) * C, o_ab = (ra * zw + cbb) * C;
      const int o_ba = (rbb * zw + ca) * C, o_bb = (rbb * zw + cbb) * C;
      const int sw_a = ((zc0 + ca) >> 1) & p.zswz;
      const int sw_b = ((zc0 + cbb) >> 1) & p.zswz;
      const uint32_t nr = bt_neg(ki), nc = bt_neg(kj);
      unsigned char* vdst = vbuf(b);
      for (int cg0 = ptid >> 6; cg0 < kg; cg0 += 4 * kStride) {
        uint4 d[4][4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int cg = cg0 + m * kStride;
          if (vt_ok && cg < c8) {
            d[m][0] = *reinterpret_cast<const uint4*>(zt + o_aa + ((cg ^ sw_a) * 8));
            d[m][1] = *reinterpret_cast<const uint4*>(zt + o_ba + ((cg ^ sw_a) * 8));
            d[m][2] = *reinterpret_cast<const uint4*>(zt + o_ab + ((cg ^ sw_b) * 8));
            d[m][3] = *reinterpret_cast<const uint4*>(zt + o_bb + ((cg ^ sw_b) * 8));
          }
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int cg = cg0 + m * kStride;
          if (cg >= kg) break;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (vt_ok && cg < c8)
            v = add8(add8(d[m][0], d[m][1], nr), add8(d[m][2], d[m][3], nr),
                     nc);
          *reinterpret_cast<uint4*>(vdst + cg * 1024 + vt * 16) = v;
        }
      }
      fence_async_smem();
      bar_arrive(kBarFull + b, kThreads);
    }
    bar_sync(kBarEpilogue, kThreads);  // the consumers wrote o_s
    if (epi_bulk) mbar_wait(&mbar[0], 0);
    epilogue_rows();
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  if (epi_bulk) {  // the epilogue's inputs, landing during the products
    const int cos = min(kCoBlock, Co - co0);
    const int len = (epi_run + 7) & ~7;
    if (tid == 0)
      mbar_expect_tx(&mbar[0], (uint32_t)(kEpiTensors * cos * len * 2));
    for (int e = tid; e < kEpiTensors * cos; e += kConsumers) {
      const int t = e / cos, col = e - t * cos;
      const bf16* src = (t == 0 ? p.cvals : t == 1 ? p.avals : p.dvals) +
                        ((int64_t)n * Co + co0 + col) * plane + or0 * W;
      bulk_copy(epi_s + (t * kCoBlock + col) * p.epi_p, src, len * 2,
                &mbar[0]);
    }
  }

  const int wg = tid >> 7;
  const uint32_t a_lbo = kTiles * 16, a_sbo = 128;  // K, M strides
  const uint32_t b_lbo = 128;              // K stride; b_sbo the N stride
  const uint32_t b_off = (uint32_t)wg * 4 * b_sbo;  // this wg's 32 co
  const int ksteps = C16 / 16;

  float acc[16], p0[16], p1[16], o[4][16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    // -0: the first add of each output returns its term exactly
    o[0][e] = o[1][e] = o[2][e] = o[3][e] = -0.0f;
    p0[e] = p1[e] = acc[e] = 0.0f;
  }

#pragma unroll 1
  for (int step = 0; step < 16; ++step) {
    const int ki = step & 3, kj = step >> 2, b = step & 1;
    bar_sync(kBarFull + b, kThreads);
    mbar_wait(&mbar[1 + b], (step >> 1) & 1);
    {
      const uint32_t a0 = smem_u32(vbuf(b));
      const uint32_t b0 = smem_u32(ubuf(b)) + b_off;
      wgmma_fence();
      for (int s = 0; s < ksteps; ++s)
        wgmma_m64n32k16(acc, desc(a0 + s * 2 * a_lbo, a_lbo, a_sbo),
                        desc(b0 + s * 2 * b_lbo, b_lbo, b_sbo), s > 0);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // the producers wait for this only up to step 13 (for steps 2 .. 15)
    if (step < 14) bar_arrive(kBarFree + b, kThreads);
    // the AT fold: r0 = (M0 + M1) + M2 and r1 = (M1 - M2) - M3 of this
    // kj, then the column stage, left to right
    if (ki == 0) {
#pragma unroll
      for (int e = 0; e < 16; ++e) p0[e] = acc[e];
    } else if (ki == 1) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        p0[e] = __fadd_rn(p0[e], acc[e]);
        p1[e] = acc[e];
      }
    } else {
      // ki == 2 folds r0 into o[0][.], ki == 3 r1 into o[1][.]
      const bool row0 = ki == 2;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float r = row0 ? __fadd_rn(p0[e], acc[e])
                             : __fsub_rn(p1[e], acc[e]);
        if (row0) p1[e] = __fsub_rn(p1[e], acc[e]);
        float lo = row0 ? o[0][e] : o[2][e];
        float hi = row0 ? o[1][e] : o[3][e];
        if (kj <= 2) lo = __fadd_rn(lo, r);
        if (kj == 1) hi = __fadd_rn(hi, r);
        if (kj >= 2) hi = __fsub_rn(hi, r);
        if (row0) {
          o[0][e] = lo;
          o[1][e] = hi;
        } else {
          o[2][e] = lo;
          o[3][e] = hi;
        }
      }
    }
  }

  // ---- phase 3: the epilogue.  The outputs go from the accumulators to
  // shared memory, o_s [64 channels][2R rows][2 TWb columns] f32 over the
  // V and U buffers (accumulator element 4j+2i+e is tile 16*warp + lane/4
  // + 8i, channel 8j + 2*(lane%4) + e of this warpgroup's 32); then all
  // warps run epilogue_rows.
  bar_sync(kBarConsumers, kConsumers);  // every product is done
  {
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = 16 * warp + g + 8 * i;
      if (t >= nt) continue;
      const int trl = t / twe, tcl = t - trl * twe;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wg * kCoWg + 8 * j + 2 * t4 + e;
          const int idx = 4 * j + 2 * i + e;
#pragma unroll
          for (int a = 0; a < 2; ++a)
            *reinterpret_cast<float2*>(
                o_s + (col * orows + 2 * trl + a) * ocols + 2 * tcl) =
                make_float2(o[2 * a][idx], o[2 * a + 1][idx]);
        }
    }
  }
  if (epi_bulk) mbar_wait(&mbar[0], 0);
  bar_sync(kBarEpilogue, kThreads);  // o_s is written
  epilogue_rows();
}

// U [16, C, Co] -> ut: for each co-block and position k, U_k[c][co0 ..
// co0 + 63] in the blocks' N-major core-matrix layout (co group g at g *
// b_sbo, channel group c / 8 at (c / 8) * 128, channel c % 8 at 16-byte
// rows), zero past C and Co, so that a block stages U_k with one bulk
// copy.  One thread per 16 bytes.
__global__ void winograd_u_layout_kernel(const bf16* __restrict__ u,
                                         unsigned char* __restrict__ ut,
                                         int C, int Co, int C16,
                                         int co_blocks) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)co_blocks * 16 * C16 * 8) return;
  const int g = e & 7, c = (e >> 3) % C16;
  const int64_t bk = (e >> 3) / C16;  // co-block * 16 + k
  const int k = bk % 16, cb = bk / 16;
  const int co = cb * kCoBlock + g * 8;
  const int vu_bytes = kTiles * C16 * 2 + 128;
  const uint32_t b_sbo = (uint32_t)(C16 / 8) * 128 + 16;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (c < C && co < Co)
    v = *reinterpret_cast<const uint4*>(u + ((int64_t)k * C + c) * Co + co);
  *reinterpret_cast<uint4*>(ut + bk * vu_bytes + g * b_sbo + (c >> 3) * 128 +
                            (c & 7) * 16) = v;
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

template <int PRO, int EPI, bool ALIGNED>
cudaError_t launch(const Params& p, int grid, int smem, int rows, float* stats,
                   int device, cudaStream_t stream) {
  auto kernel = winograd_f2x3_kernel<PRO, EPI, ALIGNED>;
  // the shared-memory limit, once per instantiation and device
  static bool attribute_set[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!attribute_set[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    attribute_set[device] = true;
  }
  const int64_t u_threads = (int64_t)p.co_blocks * 16 * p.C16 * 8;
  winograd_u_layout_kernel<<<(u_threads + 255) / 256, 256, 0, stream>>>(
      p.u, const_cast<unsigned char*>(p.ut), p.C, p.Co, p.C16, p.co_blocks);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || EPI == EPI_NONE) return err;
  winograd_stats_final_kernel<<<2 * p.Co, kFinalThreads, 0, stream>>>(
      p.partial, stats, rows, p.Co);
  return cudaGetLastError();
}

template <int PRO, int EPI>
cudaError_t launch_variant(bool aligned, const Params& p, int grid, int smem,
                           int rows, float* stats, int device,
                           cudaStream_t stream) {
  return aligned
             ? launch<PRO, EPI, true>(p, grid, smem, rows, stats, device, stream)
             : launch<PRO, EPI, false>(p, grid, smem, rows, stats, device,
                                       stream);
}

}  // namespace

extern "C" {

// x [N, C, H, W] bf16; u [16, C, Co] bf16; partner [N, C, H, W] bf16
// (PRO_BN_ADD: the identity; PRO_DYEFF: y); cvals [N, Co, H, W] bf16
// (EPI_BN_ACT, EPI_BN_ADD: the forward input); avals, dvals [N, Co, H, W]
// bf16 (EPI_BN_ADD: the boundary activation and its cotangent); scal
// [2, C] f32 (PRO_BN_ACT, PRO_BN_ADD) or [2, Co] (EPI_BN_ACT, EPI_BN_ADD);
// scal2 [2, C] f32 (PRO_DYEFF: ds, dq).  The operands a mode does not read
// may be null.  Writes out [N, Co, H, W] bf16, aux [N, C, H, W] bf16 when
// aux is not null, out3 [N, Co, H, W] bf16 for EPI_BN_ADD, and for an
// epilogue with sums stats [2, Co] f32 through partial, caller-allocated
// scratch of N * bands * segs rows of 2 * Co floats.  All contiguous, x,
// partner and u on 16 bytes.
// The geometry comes from ops/winograd.py winograd_plan: R tile rows per
// band (bands = ceil(ceil(H/2) / R) per image), column segments of TWb
// tiles, cch input channels per staging chunk, and whether the aligned
// (16-byte copy) variant runs.  Launches on `stream` of device `device`
// and returns the cudaError_t of the launches (cudaErrorInvalidValue for
// a mode it does not have or a geometry it cannot run).
int yolo_winograd_f2x3(const void* x, const void* partner, const void* u,
                       void* ut,
                       const void* cvals, const void* avals,
                       const void* dvals, const void* scal,
                       const void* scal2, void* out, void* aux, void* out3,
                       void* partial, void* stats, int pro, int epi, int N,
                       int C, int Co, int H, int W, int R, int TWb, int segs,
                       int cch, int aligned, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((int64_t)N * H * W == 0 || C == 0 || Co == 0) return 0;
  const int TH = (H + 1) / 2, TW = (W + 1) / 2;
  if (C % 8 || Co % 8 || R < 1 || TWb < 1 || segs < 1 || cch < 8 ||
      cch % 8 || R * TWb > kTiles || (int64_t)TWb * segs < TW ||
      (int64_t)TWb * (segs - 1) >= TW)
    return (int)cudaErrorInvalidValue;
  const bool partner_read = pro == PRO_BN_ADD || pro == PRO_DYEFF;
  Params p;
  p.x = (const bf16*)x;
  p.partner = (const bf16*)partner;
  p.u = (const bf16*)u;
  p.ut = (const unsigned char*)ut;
  p.cvals = (const bf16*)cvals;
  p.avals = (const bf16*)avals;
  p.dvals = (const bf16*)dvals;
  p.scal = (const float*)scal;
  p.scal2 = (const float*)scal2;
  p.out = (bf16*)out;
  p.aux = (bf16*)aux;
  p.out3 = (bf16*)out3;
  p.partial = (float*)partial;
  p.C = C;
  p.Co = Co;
  p.H = H;
  p.W = W;
  p.TH = TH;
  p.TW = TW;
  p.R = R;
  p.TWb = TWb;
  p.segs = segs;
  p.bands = (TH + R - 1) / R;
  p.co_blocks = (Co + kCoBlock - 1) / kCoBlock;
  p.C16 = (C + 15) / 16 * 16;
  p.cch = cch;
  const int rows_max = 2 * R + 3 < H ? 2 * R + 3 : H;
  p.run_p = (rows_max * W + 7) / 8 * 8;
  p.zw = 2 * TWb + 2;
  p.epi_p = (2 * R * W + 7) / 8 * 8;
  p.zswz = C % 64 == 0 ? 7 : 0;
  const int epi_tensors = epi == EPI_BN_ADD ? 3 : (epi == EPI_BN_ACT ? 1 : 0);
  const int64_t z_bytes = (int64_t)(2 * R + 2) * p.zw * C * 2;
  const int64_t epi_bytes = (int64_t)epi_tensors * kCoBlock * p.epi_p * 2;
  const int64_t vu_bytes = (int64_t)4 * (kTiles * p.C16 * 2 + 128);
  const int64_t stage_bytes =
      (int64_t)kStages * (partner_read ? 2 : 1) * cch * p.run_p * 2;
  const int64_t o_bytes = (int64_t)kCoBlock * 2 * R * 2 * TWb * 4;  // o_s
  const int64_t epi_offset = vu_bytes > o_bytes ? vu_bytes : o_bytes;
  int64_t region = epi_offset + epi_bytes;
  region = region > stage_bytes ? region : stage_bytes;
  const int64_t smem = z_bytes + region + (int64_t)8 * C + 32;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  p.z_bytes = (int)z_bytes;
  p.epi_offset = (int)epi_offset;
  p.region_bytes = (int)region;
  const int64_t rows = (int64_t)N * p.bands * segs;
  const int64_t grid = rows * p.co_blocks;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define YOLO_WINOGRAD_MODE(P_, E_)                                        \
  if (pro == P_ && epi == E_)                                             \
    return (int)launch_variant<P_, E_>(aligned != 0, p, (int)grid,        \
                                       (int)smem, (int)rows,              \
                                       (float*)stats, device, s);
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

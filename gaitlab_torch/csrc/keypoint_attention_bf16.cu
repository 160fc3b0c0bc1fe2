// Keypoint-attention pooling of the PARE head on bf16 inputs, for Hopper
// (sm_90a), with the products on the tensor cores.
//
// For each frame b and part j, as csrc/keypoint_attention.cu computes on
// FP32 inputs:
//   attn[j, p]  = softmax over the HW positions p of heatmaps[b, p, j]
//   out1[b,j,c] = sum_p attn[j, p] * features[b, p, c]     (c < C1)
//   out2[b,j,c] = sum_p attn[j, p] * cam_feats[b, p, c]    (c < C2)
// Replaces the Pallas TPU kernel gaitlab/ops/attention_pallas.py::
// keypoint_attention_fused (pl.pallas_call at :60) on the inputs of a bf16
// trunk's head. gaitlab's wrapper upcasts bf16 before its call, so this
// kernel computes in FP32 from the bf16 values: FP32 softmax statistics and
// weights, FP32 sums, FP32 outputs.
//
// Bound on an H100 at B = 128, HW = 3136, J = 24, C1 + C2 = 192: 175.8 MB
// of bf16 inputs and FP32 outputs, 0.0525 ms at 3.35 TB/s. Its 3.7 GFLOP
// take 0.056 ms as FP32 FFMA, past that bound (the FP32 kernel templated on
// bf16 inputs, which this kernel replaces, ran at 3x the bound, bound by
// instruction issue), and 0.011 ms on the bf16 tensor cores even counted
// three times (below). So the products go to wgmma and the bytes bind.
//
// Per frame the pooling is one product D (C x J) = F (C x HW) . W^T (HW x J)
// with C = 192 channels (three m-blocks of 64) and W the softmax weights.
// The head's NCHW views hold F with positions contiguous, a K-major A
// operand as it lies, and the logits (J, HW) likewise, so the weights are
// a K-major B operand. Exact products on bf16 tensor cores: a feature is
// exact in bf16, and an FP32 weight w in (0, 1] is exactly the sum of three
// bf16 parts p0 = bf16_rn(w), p1 = bf16_rn(w - p0), p2 = w - p0 - p1 (p0
// takes w's top 8 significant bits, p1 the next 8 of a residual of at
// most 16, and p2 the rest, at most 8). So each product of a feature and a
// part is exact in FP32, their sum is f * w exactly, and only the order of
// the FP32 sums differs from the FFMA kernel's. The three parts are the
// B operand's 72 rows (parts 0, 1, 2 of parts 0..23): per m-block and 16
// positions, one wgmma m64n24k16 on part 0 and one m64n48k16 on parts 1
// and 2, whose accumulators keep each part's sums apart; the epilogue adds
// them, smallest first. The tensor cores' FP32 accumulation does not round
// as an FFMA does: part 0's sums chained over a whole frame err several
// times more than the FFMA kernel against float64 (scripts/
// torch_kernel_study.py ablate_bf16, chained_part0), so part 0 accumulates
// one tile at a time and the tiles are added with FP32 adds; parts 1 and
// 2 are 2^-8 and 2^-16 of it and chain over the split.
// A part below 2^-126 is a bf16 subnormal. A nonzero part is at least
// 2^(e - 23) for w's exponent e, so this arises only for w below 2^-103.
// PTX does not promise that the tensor cores keep bf16 subnormal inputs;
// kept or flushed to zero, such a part moves an output by less than
// 2^-126 * max|feature| * HW, about 1e-34 here.
//
// Each block takes one position split (whole tiles of kTile = 64
// positions, one 128-byte row of bf16) of one frame, and one chunk of up to
// kMB m-blocks (the head's 128 + 64 channels are one chunk). One producer
// warp keeps TMA loads in flight into a ring of kStages stages; a
// consumer warpgroup runs the softmax step and the wgmmas. Two passes over
// the split, so that no accumulator is ever rescaled:
//   1. the split's logits, kScan tiles a stage, give each part's max m;
//   2. each stage brings the tile's three channel blocks (64 x 64 each,
//      8 KB) and its logits (24 x 64, 3 KB), all with TMA's 128-byte
//      swizzle, which is wgmma's canonical K-major layout. Each consumer
//      thread forms w = exp2((l - m) * log2(e)) in FP32 for 3 parts x 4
//      positions, adds w to its part sums s, and writes the three bf16
//      parts into the stage's B tile in the same swizzled layout; then
//      fence.proxy.async, a barrier of the warpgroup, and 24 wgmmas whose
//      completion is awaited one tile later, when the stage goes back to
//      the producer.
// Positions past the split or past HW (TMA fills them with zeros, which
// would be the logit 0) get weight 0 by their index. The first pass marks
// the logits evict_last in L2 and the second pass streams everything
// evict_first, so device memory sees the logits once. A block writes its
// (m, s) per part and its partial sums for the merge of
// csrc/attention_merge.cuh (the FP32 kernel's), or, with one split, the
// normalised outputs. The wrapper (ops/keypoint_attention.py::
// launch_plan_bf16) splits so that the blocks, one per SM (144 KB of
// ring), fill the card in whole waves: at B = 128 one split per frame.
// On an H100 the TMA traffic alone, each tile handed back as it lands,
// takes most of the kernel's time (scripts/torch_kernel_study.py
// ablate_bf16, stream_only), so the reads of 216 rows of each frame 128
// bytes at a time, not the tensor cores or the softmax step, set its pace.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_merge.cuh"

namespace {

constexpr int kJ = 24;                     // parts
constexpr int kTile = 64;                  // positions per tile
constexpr int kRows = 64;                  // channels per m-block (M)
constexpr int kMB = 3;                     // m-blocks per block
constexpr int kN = 3 * kJ;                 // B's columns: three weight parts
constexpr int kPartRegs = kJ / 2;          // accumulators of one part
constexpr int kStages = 4;                 // stages of the TMA ring
constexpr int kScan = 8;                   // logit tiles a stage in pass 1
constexpr int kConsumers = 128;            // one warpgroup
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kATile = kRows * kTile * 2;  // bytes of an m-block's tile
constexpr int kLTile = kJ * kTile * 2;     // bytes of a logit tile
constexpr int kLogitOff = kMB * kATile;
constexpr int kWOff = kLogitOff + kLTile;  // the weight parts (B)
constexpr int kStageBytes = kWOff + kN * kTile * 2;
constexpr int kBarOff = kStages * kStageBytes;
constexpr int kMsOff = kBarOff + 2 * kStages * 8;
constexpr int kSmemBytes = kMsOff + 2 * kJ * 4 + 1024;  // + alignment
static_assert(kTile * 2 == 128, "a tile row is one 128-byte swizzle row");
static_assert(kATile % 1024 == 0 && kLTile % 1024 == 0 &&
                  kStageBytes % 1024 == 0,
              "swizzled tiles start on 1024-byte boundaries");
static_assert(kScan * kLTile <= kWOff, "a scan stage fits below B");
static_assert(kJ % 8 == 0, "each thread's rows r0 + 8i cover the parts");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// box (x, y, z) of `map` into shared memory at dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y, int z,
                                         uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x),
      "r"(y), "r"(z), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// the consumer warpgroup's own barrier (the producer warp has left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// wgmma descriptor of a tile of 128-byte rows with the 128-byte swizzle,
// K-major: start address, leading offset 16 B (unused), 1024 B between
// groups of 8 rows, layout 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// keeps the compiler from moving accumulator accesses across the asm
// statements that issue and await the wgmmas
template <int kN>
__device__ __forceinline__ void fence_operands(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 24, FP32) = A (64 x 16, bf16) . B (16 x 24, bf16), plus d where
// `accumulate`; A and B from shared memory through their descriptors
__device__ __forceinline__ void wgmma_m64n24k16(float (&d)[kPartRegs],
                                                uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 48, FP32) += A (64 x 16, bf16) . B (16 x 48, bf16)
__device__ __forceinline__ void wgmma_m64n48k16(float (&d)[2 * kPartRegs],
                                                uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(1));
}

// byte offset of positions [4q, 4q + 4) of row r in a tile of 128-byte
// rows written with the 128-byte swizzle: 16-byte chunk k of row r lies at
// chunk k ^ (r & 7)
__device__ __forceinline__ int swizzled(int r, int q) {
  return r * 128 + ((((q >> 1) ^ (r & 7)) << 4) | ((q & 1) << 3));
}

// four bf16 values at p (8 bytes) as floats
__device__ __forceinline__ void load4(const uint8_t* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// the three bf16 parts of four FP32 weights, 8 bytes each: part k rounds
// to nearest even what parts 0..k-1 left, and the last leaves nothing
__device__ __forceinline__ void split3(const float (&w)[4], uint2 (&part)[3]) {
  float r[4] = {w[0], w[1], w[2], w[3]};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(r[0], r[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(r[2], r[3]);
    part[k].x = *reinterpret_cast<const uint32_t*>(&lo);
    part[k].y = *reinterpret_cast<const uint32_t*>(&hi);
    const float2 flo = __bfloat1622float2(lo), fhi = __bfloat1622float2(hi);
    r[0] -= flo.x;  // exact: the residual has at most 16 significant bits
    r[1] -= flo.y;
    r[2] -= fhi.x;
    r[3] -= fhi.y;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

struct Args {
  float* out1;
  float* out2;
  float2* ms_part;  // (split, b, j): (m, s)
  float* acc_part;  // (split, b, j, c1 + c2)
  int c1, c2, hw, split_len;
};

// grid (n_split, B, channel chunks); the maps read (B, rows, HW) tensors,
// the feature maps in boxes of 64 positions x 64 channels, the logits in
// boxes of 64 positions x kJ parts. With gridDim.x == 1 the block writes
// out1/out2; else ms_part and acc_part as the FP32 kernel does.
__global__ void __launch_bounds__(kThreads, 1)
    attention_bf16_kernel(const __grid_constant__ CUtensorMap feat_map,
                          const __grid_constant__ CUtensorMap cam_map,
                          const __grid_constant__ CUtensorMap hm_map,
                          const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kBarOff);
  uint64_t* empty = full + kStages;
  float* ms_s = reinterpret_cast<float*>(base + kMsOff);  // m[kJ], s[kJ]
  const int split = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int p_begin = split * a.split_len;
  const int p_end = min(a.hw, p_begin + a.split_len);
  const int n_tiles = (p_end - p_begin + kTile - 1) / kTile;
  const int n_scan = (n_tiles + kScan - 1) / kScan;
  const int nf = (a.c1 + kRows - 1) / kRows;  // m-blocks of the features
  const int n_mb = min(kMB, nf + (a.c2 + kRows - 1) / kRows - kMB * z);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one lane issues
    if (tid == kConsumers) {
      prefetch_map(&feat_map);
      prefetch_map(&cam_map);
      prefetch_map(&hm_map);
      const uint64_t keep = policy_evict_last();
      const uint64_t stream = policy_evict_first();
      for (int it = 0; it < n_scan + n_tiles; ++it) {
        const int st = it % kStages;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        uint8_t* stage = base + st * kStageBytes;
        if (it < n_scan) {
          const int t0 = it * kScan, nt = min(kScan, n_tiles - t0);
          mbar_expect_tx(&full[st], nt * kLTile);
          for (int k = 0; k < nt; ++k) {
            tma_load(stage + k * kLTile, &hm_map, &full[st],
                     p_begin + (t0 + k) * kTile, 0, b, keep);
          }
        } else {
          const int p = p_begin + (it - n_scan) * kTile;
          mbar_expect_tx(&full[st], kLTile + n_mb * kATile);
          for (int mb = 0; mb < n_mb; ++mb) {
            const int g = kMB * z + mb;
            const bool cam = g >= nf;
            tma_load(stage + mb * kATile, cam ? &cam_map : &feat_map,
                     &full[st], p, (cam ? g - nf : g) * kRows, b, stream);
          }
          tma_load(stage + kLogitOff, &hm_map, &full[st], p, 0, b, stream);
        }
      }
    }
    return;
  }

  // the consumer warpgroup. Thread tid takes positions [4q, 4q + 4) of
  // parts r0, r0 + 8, r0 + 16 of every tile, so that each part's max and
  // sum are reduced over the 16 threads of a half warp.
  const int q = tid & 15, r0 = tid >> 4;
  float m[3], s[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    m[i] = -INFINITY;
    s[i] = 0.f;
  }
  int it = 0;
  for (; it < n_scan; ++it) {  // pass 1: the parts' max over the split
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    const uint8_t* stage = base + st * kStageBytes;
    const int t0 = it * kScan, nt = min(kScan, n_tiles - t0);
    for (int k = 0; k < nt; ++k) {
      const int p = p_begin + (t0 + k) * kTile + 4 * q;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float l[4];
        load4(stage + k * kLTile + swizzled(r0 + 8 * i, q), l);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (p + e < p_end) m[i] = fmaxf(m[i], l[e]);
        }
      }
    }
    mbar_arrive(&empty[st]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) m[i] = half_warp_max(m[i]);

  // Accumulators: parts 1 and 2 of the weights chain over the whole split
  // (their sums are 2^-8 and 2^-16 of part 0's, so the tensor cores'
  // accumulation error in them does not show); part 0 starts afresh on
  // each tile, in one of two buffers while the other tile's wgmmas may
  // still run, and each finished tile is added into `sum0` with a rounded
  // FP32 add, so that no chain of the tensor cores' accumulation is longer
  // than one tile.
  float low[kMB][2 * kPartRegs], fresh[2][kMB][kPartRegs], sum0[kMB][kPartRegs];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
    for (int i = 0; i < kPartRegs; ++i) {
      low[mb][i] = low[mb][kPartRegs + i] = 0.f;
      fresh[0][mb][i] = fresh[1][mb][i] = sum0[mb][i] = 0.f;
    }
  }
  auto fold = [&](float (&done)[kMB][kPartRegs]) {
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
      for (int i = 0; i < kPartRegs; ++i) sum0[mb][i] += done[mb][i];
    }
  };
  int prev = -1;  // the stage whose wgmmas may still run
  // tile t: weights into the stage's B tile, wgmmas of part 0 into `cur`;
  // then the previous tile's part-0 sums, in `done`, are folded
  auto tile_step = [&](int t, float (&cur)[kMB][kPartRegs],
                       float (&done)[kMB][kPartRegs]) {
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    uint8_t* stage = base + st * kStageBytes;
    const int p = p_begin + t * kTile + 4 * q;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int r = r0 + 8 * i;
      float l[4], w[4];
      load4(stage + kLogitOff + swizzled(r, q), l);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // the difference is taken before the scaling to log2 units, as in
        // the FP32 kernel, so it stays exact however large the logits
        w[e] = p + e < p_end && l[e] != -INFINITY
                   ? exp2f((l[e] - m[i]) * kLog2e)
                   : 0.f;
        s[i] += w[e];
      }
      uint2 part[3];
      split3(w, part);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        *reinterpret_cast<uint2*>(stage + kWOff + swizzled(r + kJ * k, q)) =
            part[k];
      }
    }
    // the parts, written by threads, are read by the tensor cores' proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
      fence_operands(cur[mb]);
      fence_operands(low[mb]);
    }
    wgmma_fence();
    const uint64_t w0 = sw128_desc(stage + kWOff);
    const uint64_t w12 = sw128_desc(stage + kWOff + kJ * kTile * 2);
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
      if (mb < n_mb) {
        const uint64_t ad = sw128_desc(stage + mb * kATile);
#pragma unroll
        for (int k = 0; k < kTile / 16; ++k) {
          // 16 positions = 32 bytes further along the swizzled rows
          wgmma_m64n24k16(cur[mb], ad + 2 * k, w0 + 2 * k, k > 0);
          wgmma_m64n48k16(low[mb], ad + 2 * k, w12 + 2 * k);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous tile's wgmmas are done
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
      fence_operands(done[mb]);
      fence_operands(low[mb]);
    }
    if (prev >= 0) {
      fold(done);
      mbar_arrive(&empty[prev]);
    }
    prev = st;
    ++it;
  };
  for (int t = 0; t < n_tiles; t += 2) {  // pass 2: weights and sums
    tile_step(t, fresh[0], fresh[1]);
    if (t + 1 < n_tiles) tile_step(t + 1, fresh[1], fresh[0]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb) {
    fence_operands(fresh[0][mb]);
    fence_operands(fresh[1][mb]);
    fence_operands(low[mb]);
  }
  if ((n_tiles - 1) & 1) {
    fold(fresh[1]);
  } else {
    fold(fresh[0]);
  }

#pragma unroll
  for (int i = 0; i < 3; ++i) s[i] = half_warp_sum(s[i]);
  if (q == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ms_s[r0 + 8 * i] = m[i];
      ms_s[kJ + r0 + 8 * i] = s[i];
    }
  }
  consumers_sync();

  // epilogue. Accumulator element 4i + 2h + e of a thread of warp w is
  // row 16w + lane / 4 + 8h, column 8i + 2 (lane % 4) + e: of part 0 in
  // sum0, of part 1 in low and of part 2 kPartRegs elements further.
  const int warp = tid >> 5, lane = tid & 31;
  const bool direct = gridDim.x == 1;
  const int c_all = a.c1 + a.c2;
  const size_t row0 = ((size_t)split * gridDim.y + b) * kJ;  // (split, b)
  if (!direct && z == 0 && tid < kJ) {
    a.ms_part[row0 + tid] = make_float2(ms_s[tid], ms_s[kJ + tid]);
  }
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb) {
    if (mb >= n_mb) continue;
    const int g = kMB * z + mb;
    const bool cam = g >= nf;
    const int cn = cam ? a.c2 : a.c1;
    float* out = cam ? a.out2 : a.out1;
    const int c_off = cam ? a.c1 : 0;
    const int c_base = (cam ? g - nf : g) * kRows + 16 * warp + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c_base + 8 * h;
      if (c >= cn) continue;
#pragma unroll
      for (int i = 0; i < kJ / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 4 * i + 2 * h + e;
          const int j = 8 * i + 2 * (lane & 3) + e;
          const float v =
              (low[mb][k + kPartRegs] + low[mb][k]) + sum0[mb][k];
          if (direct) {
            out[((size_t)b * kJ + j) * cn + c] = v * (1.f / ms_s[kJ + j]);
          } else {
            a.acc_part[(row0 + j) * c_all + c_off + c] = v;
          }
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime, so
// that the library links against nothing but the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// a map of the (B, rows, hw) bf16 tensor at ptr, rows `rs` and frames `bs`
// elements apart, positions contiguous: boxes of kTile positions x
// box_rows rows, 128-byte swizzle, zeros outside the tensor
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int hw,
            int rows, int n_batch, long long rs, long long bs,
            int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)hw, (cuuint64_t)rows,
                              (cuuint64_t)n_batch};
  const cuuint64_t strides[2] = {(cuuint64_t)rs * 2, (cuuint64_t)bs * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kTile, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Launches on `stream` with the caller's plan (ops/keypoint_attention.py::
// launch_plan_bf16) and returns the first error, or 0: cudaErrorNotSupported
// when libcuda has no cuTensorMapEncodeTiled, cudaErrorInvalidValue for
// a plan that does not match this build or a tensor TMA cannot map, else
// cudaGetLastError(). The heatmaps must have kJ = 24 parts. Each tensor is
// (B, rows, HW) with positions contiguous; strides in elements, (batch,
// channel) for each feature tensor and (batch, part) for the heatmaps,
// each a multiple of 8 (16 bytes), and 16-byte aligned pointers. Each
// split covers split_len positions (a multiple of kTile) and chunks of kMB
// m-blocks of 64 channels cover the features' then the cam's m-blocks.
// Scratch from the caller when n_split > 1: ms (n_split * B * kJ float2)
// and acc (n_split * B * kJ * (c1 + c2) floats).
int gaitlab_keypoint_attention_bf16(
    const void* feat, long long fb, long long fc, int c1, const void* cam,
    long long cb, long long cc, int c2, const void* hm, long long hb,
    long long hj, float* out1, float* out2, void* ms, float* acc,
    int n_batch, int hw, int n_split, int split_len, int n_chunk, int smem,
    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_mb = (c1 + kRows - 1) / kRows + (c2 + kRows - 1) / kRows;
  const bool plan_ok =
      c1 > 0 && c2 > 0 && hw > 0 && split_len % kTile == 0 &&
      (long long)n_split * split_len >= hw &&
      (long long)(n_split - 1) * split_len < hw && n_chunk * kMB >= n_mb &&
      (n_chunk - 1) * kMB < n_mb && smem == kSmemBytes &&
      (n_split == 1 || (ms && acc));
  if (!plan_ok) return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap maps[3];
  if (!encode(fn, &maps[0], feat, hw, c1, n_batch, fc, fb, kRows) ||
      !encode(fn, &maps[1], cam, hw, c2, n_batch, cc, cb, kRows) ||
      !encode(fn, &maps[2], hm, hw, kJ, n_batch, hj, hb, kJ)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      attention_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  float2* ms2 = reinterpret_cast<float2*>(ms);
  const Args args{out1, out2, ms2, acc, c1, c2, hw, split_len};
  attention_bf16_kernel<<<dim3(n_split, n_batch, n_chunk), kThreads, smem,
                          s>>>(maps[0], maps[1], maps[2], args);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  return launch_merge(ms2, acc, n_split, (long long)n_batch * kJ, c1, c2,
                      out1, out2, s);
}

const char* gaitlab_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

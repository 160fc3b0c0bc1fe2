// The ViT trunk's linear layers in float32 accuracy on Hopper's tensor
// cores (sm_90a):
//
//   y (M x N) = x (M x K) . W^T + b,   x row-major, W (N x K) row-major
//
// for the four products of each HMR 2.0 ViT block (qkv 1280->3840, proj
// 1280->1280, fc1 1280->5120, fc2 5120->1280) at M = rows x 192 tokens.
// It replaces no TPU kernel: gaitlab leaves these products to XLA. On the
// card they were cuBLAS's FFMA SGEMM, at about 50 TFLOP/s of the FP32
// units' 67, so FFMA has nothing left to give and the tensor cores' TF32
// rate (495 TFLOP/s) is the only room.
//
// Float32 accuracy from TF32 products (3xTF32, as csrc/blendshapes.cu on
// mma.sync): every factor is split into a TF32 hi part and the TF32 part
// lo of what hi leaves, and each product is x_lo.W_hi + x_hi.W_lo +
// x_hi.W_hi; the dropped x_lo.W_lo is about 2^-21 of it (x: hi =
// tf32_rna(x), lo = tf32_rna(x - hi); W below). Three passes make the
// bound 3 x 2MNK / 495 TFLOP/s, a nominal 165 TFLOP/s. The tensor cores'
// FP32 accumulation does not round as an FFMA does
// (csrc/keypoint_attention_bf16.cu: a chain of wgmma accumulations over a
// whole frame errs several times more than FFMA), so each k-tile of kBK =
// 32 sums its three passes into a fresh accumulator, the two small passes
// first, and the tile is added into the block's sum with a rounded FP32
// add: no chain of the tensor cores' accumulation is longer than 12 wgmma
// steps. Against float64 the kernel errs about a fifth as much as cuBLAS
// SGEMM on the ViT's shapes (chip_smoke.py phase 2).
//
// The design for the card:
//   - a persistent grid, one block per SM, walks 128 x 128 output tiles in
//     groups of `group` m-tiles (all n-tiles of a group before the next),
//     so that the blocks in flight share x's and W's k-slices in L2;
//   - one thread of a producer warpgroup keeps TMA loads of the x and W
//     tiles (32 floats = 128 bytes of K a row, the 128-byte swizzle that
//     is wgmma's K-major layout) in flight into a ring of kStages stages
//     of 48 KB, and the next tile's loads start while the consumers
//     finish the last one. The producer gives its registers up
//     (setmaxnreg 40) to the consumers (232): with a producer warp alone
//     (288 threads) ptxas gave every thread 168 registers, as it would
//     384, and the consumers spilled;
//   - two consumer warpgroups each own 64 rows of the tile and issue
//     wgmma.m64n128k8.f32.tf32.tf32: A (x) from registers, B (W) from
//     shared memory. TF32 wgmma takes only K-major operands, which is how
//     the model stores both. Each thread loads its A fragments from the
//     swizzled x tile (conflict-free: the eight rows a load instruction
//     meets lie in eight distinct 16-byte chunks) and splits them in
//     registers, the next k-tile's while the current one's wgmmas run
//     (two sets of fragments; 7-8% faster than loading them after the
//     wait, an H100 80GB HBM3 at 700 W);
//   - W's split is prepared once per weight tensor (ops/vit_linear.py::
//     weight_lo): the tensor cores read a float32 operand as TF32 by
//     ignoring its low 13 mantissa bits, so W itself is W_hi = trunc(W)
//     and the wrapper keeps W_lo = tf32_rna(W - trunc(W)) beside it, which
//     TMA loads into the stage's third slot. Splitting the W tile in shared
//     memory instead (hi in place, lo beside it, a fence to the async proxy
//     and a barrier of both warpgroups each k-tile) ran at 75-83 TFLOP/s
//     nominal against this design's 108-119 on the ViT's shapes (an H100
//     80GB HBM3 at 700 W): the split's shared-memory traffic and the
//     barrier cost more than the low part's reads;
//   - the epilogue adds the bias and stores each thread's fragment as
//     float2s (each quad of lanes writes 32 contiguous bytes of a row),
//     masking rows past M: M = rows x 192 is a multiple of 64, not always
//     of 128, and TMA fills the missing rows of x with zeros. N and K must
//     be multiples of 128 (the wrapper checks).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;                 // rows of an output tile
constexpr int kBN = 128;                 // columns of an output tile
constexpr int kBK = 32;                  // K of a stage: one 128-byte row
constexpr int kStages = 4;               // stages of the TMA ring
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kTileBytes = kBM * kBK * 4;  // 16 KB: x, W hi or W lo
constexpr int kXOff = 0;
constexpr int kHiOff = kTileBytes;
constexpr int kLoOff = 2 * kTileBytes;
constexpr int kStageBytes = 3 * kTileBytes;
constexpr int kBarOff = kStages * kStageBytes;
constexpr int kSmemBytes = kBarOff + 2 * kStages * 8 + 1024;  // + alignment
constexpr int kAcc = kBN / 2;            // accumulators of a thread
static_assert(kBM == kBN, "x's and W's tiles share one size");
static_assert(kBK * 4 == 128, "a tile row is one 128-byte swizzle row");
static_assert(kStageBytes % 1024 == 0, "swizzled tiles on 1024-byte bounds");

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

// box (k, row) of `map` into shared memory at dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k),
      "r"(row)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
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

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of the accumulators, or reusing
// the A fragments' registers, across the asm statements that issue and
// await the wgmmas (which read and write them asynchronously)
template <int kN>
__device__ __forceinline__ void fence_operands(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int kN>
__device__ __forceinline__ void fence_operands(uint32_t (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define GAITLAB_ACC8(i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, FP32) = A (64 x 8, TF32, registers) . B (8 x 128, TF32,
// shared memory through its descriptor), plus d where `accumulate`
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[kAcc],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : GAITLAB_ACC8(0), GAITLAB_ACC8(8), GAITLAB_ACC8(16), GAITLAB_ACC8(24),
        GAITLAB_ACC8(32), GAITLAB_ACC8(40), GAITLAB_ACC8(48),
        GAITLAB_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

#undef GAITLAB_ACC8

// v rounded to TF32 (10 mantissa bits), to nearest, ties away from zero
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// byte offset of float k of row r in a tile of 128-byte rows written with
// the 128-byte swizzle: 16-byte chunk c of row r lies at chunk c ^ (r & 7)
__device__ __forceinline__ int swizzled(int r, int k) {
  return r * 128 + ((((k >> 2) ^ (r & 7)) << 4) | ((k & 3) << 2));
}

// output tile t of the walk: groups of `group` m-tiles, each walked
// m-fastest over all n-tiles (ops/vit_linear.py::tile_coords)
__device__ __forceinline__ void tile_coords(int t, int n_m, int n_n,
                                            int group, int& m, int& n) {
  const int per_group = group * n_n;
  const int g = t / per_group, first = g * group;
  const int rows = min(group, n_m - first);
  const int r = t - g * per_group;
  m = first + r % rows;
  n = r / rows;
}

struct Args {
  float* y;
  const float* bias;  // may be null
  int m, n, k, n_tiles, group;
};

// grid: at most one block per SM, each walking tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...; the maps read x (M, K), W (N, K) and W_lo
// (N, K) in boxes of kBK x 128
__global__ void __launch_bounds__(kThreads, 1)
    vit_linear_kernel(const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap w_map,
                      const __grid_constant__ CUtensorMap lo_map,
                      const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kBarOff);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int n_m = (a.m + kBM - 1) / kBM, n_n = a.n / kBN;
  const int n_k = a.k / kBK;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup: one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers) {
      prefetch_map(&x_map);
      prefetch_map(&w_map);
      prefetch_map(&lo_map);
      int it = 0;
      for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
        int m, n;
        tile_coords(t, n_m, n_n, a.group, m, n);
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int st = it % kStages;
          mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
          uint8_t* stage = base + st * kStageBytes;
          mbar_expect_tx(&full[st], kStageBytes);
          tma_load(stage + kXOff, &x_map, &full[st], kt * kBK, m * kBM);
          tma_load(stage + kHiOff, &w_map, &full[st], kt * kBK, n * kBN);
          tma_load(stage + kLoOff, &lo_map, &full[st], kt * kBK, n * kBN);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // the consumers. Warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile;
  // its A fragment of k8 step s holds, per thread, rows r0 and r0 + 8 at
  // k = 8s + q and 8s + q + 4 (registers a0: (r0, q), a1: (r0 + 8, q),
  // a2: (r0, q + 4), a3: (r0 + 8, q + 4)).
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = 64 * wg + 16 * warp + (lane >> 2), q = lane & 3;
  float acc[kAcc], part[kAcc];
  uint32_t h0[kBK / 8][4], l0[kBK / 8][4], h1[kBK / 8][4], l1[kBK / 8][4];
  int it = 0;
  // the A fragments of the stage at `stage`, split in registers
  auto load_frags = [&](const uint8_t* stage, uint32_t (&h)[kBK / 8][4],
                        uint32_t (&l)[kBK / 8][4]) {
    const uint8_t* xs = stage + kXOff;
#pragma unroll
    for (int s = 0; s < kBK / 8; ++s) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + 8 * (j & 1), k = 8 * s + q + 4 * (j >> 1);
        const float v = *reinterpret_cast<const float*>(xs + swizzled(r, k));
        h[s][j] = tf32_rna(v);
        l[s][j] = tf32_rna(v - __uint_as_float(h[s][j]));
      }
    }
  };
  // k-tile kt on the fragments (ch, cl) of stage it; the next k-tile's
  // fragments (nh, nl) load while its wgmmas run
  auto step = [&](int kt, uint32_t (&ch)[kBK / 8][4],
                  uint32_t (&cl)[kBK / 8][4], uint32_t (&nh)[kBK / 8][4],
                  uint32_t (&nl)[kBK / 8][4]) {
    const int st = it % kStages;
    uint8_t* stage = base + st * kStageBytes;
    const uint64_t bh = sw128_desc(stage + kHiOff);
    const uint64_t bl = sw128_desc(stage + kLoOff);
    fence_operands(part);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBK / 8; ++s) {
      wgmma_m64n128k8(part, cl[s], bh + 2 * s, s > 0);
    }
#pragma unroll
    for (int s = 0; s < kBK / 8; ++s) {
      wgmma_m64n128k8(part, ch[s], bl + 2 * s, 1);
    }
#pragma unroll
    for (int s = 0; s < kBK / 8; ++s) {
      wgmma_m64n128k8(part, ch[s], bh + 2 * s, 1);
    }
    wgmma_commit();
    if (kt + 1 < n_k) {
      const int nst = (it + 1) % kStages;
      mbar_wait(&full[nst], ((it + 1) / kStages) & 1);
      load_frags(base + nst * kStageBytes, nh, nl);
    }
    wgmma_wait_all();
    fence_operands(part);
#pragma unroll
    for (int s = 0; s < kBK / 8; ++s) {
      fence_operands(ch[s]);
      fence_operands(cl[s]);
    }
    mbar_arrive(&empty[st]);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
    ++it;
  };
  for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
    int m, n;
    tile_coords(t, n_m, n_n, a.group, m, n);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
    load_frags(base + (it % kStages) * kStageBytes, h0, l0);
    for (int kt = 0; kt < n_k; kt += 2) {  // n_k is even: K % 128 == 0
      step(kt, h0, l0, h1, l1);
      step(kt + 1, h1, l1, h0, l0);
    }

    // epilogue: accumulator 4i + 2h + e is row r0 + 8h, column
    // 8i + 2q + e of the tile
    const int col0 = n * kBN + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m * kBM + r0 + 8 * h;
      if (row >= a.m) continue;
      float* yr = a.y + (size_t)row * a.n + col0;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        float2 b = make_float2(0.f, 0.f);
        if (a.bias != nullptr) {
          b = *reinterpret_cast<const float2*>(a.bias + col0 + 8 * i);
        }
        *reinterpret_cast<float2*>(yr + 8 * i) =
            make_float2(acc[4 * i + 2 * h] + b.x, acc[4 * i + 2 * h + 1] + b.y);
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

// a map of the row-major (rows, k) float32 tensor at ptr: boxes of kBK
// floats x 128 rows, 128-byte swizzle, zeros past the last row
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rows,
            int k) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)kBM};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// y (m, n) = x (m, k) . w (n, k)^T + bias (n; may be null), with w_lo =
// tf32_rna(w - trunc(w)) beside w, all float32, contiguous and 16-byte
// aligned, launched on `stream` with the caller's plan (ops/vit_linear.py::
// launch_plan). Returns the first error, or 0: cudaErrorNotSupported when
// libcuda has no cuTensorMapEncodeTiled, cudaErrorInvalidValue for a plan
// or a shape that does not match this build (n and k multiples of 128),
// else cudaGetLastError().
int gaitlab_vit_linear(const float* x, const float* w, const float* w_lo,
                       const float* bias, float* y, int m, int n, int k,
                       int n_tiles, int grid, int group, int smem,
                       void* stream) {
  const bool plan_ok =
      m > 0 && n > 0 && k > 0 && n % 128 == 0 && k % 128 == 0 &&
      group > 0 && n_tiles == (m + kBM - 1) / kBM * (n / kBN) && grid > 0 &&
      grid <= n_tiles && smem == kSmemBytes;
  if (!plan_ok) return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap maps[3];
  if (!encode(fn, &maps[0], x, m, k) || !encode(fn, &maps[1], w, n, k) ||
      !encode(fn, &maps[2], w_lo, n, k)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      vit_linear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const Args args{y, bias, m, n, k, n_tiles, group};
  vit_linear_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], args);
  return (int)cudaGetLastError();
}

const char* gaitlab_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// Fused SMPL blendshapes for Hopper (sm_90a).
//
//   out[b, r] = v_template[r] + sum_s shapedirs[r, s] * betas[b, s]
//                             + sum_p posedirs[p, r] * pose[b, p]
//
// over the R = V*3 flattened vertex rows, contracting S = 10 shape and
// P = 207 pose coefficients: one product out (B x R) = coef (B x K) .
// dirs (K x R) + v_template, with K = S + P = 217.
//
// Replaces the Pallas TPU kernel gaitlab/ops/lbs_pallas.py::blendshapes
// (pl.pallas_call at :70). Like it, one pass over posedirs does both
// contractions and the template add, and the result is written once.
//
// Bound on an H100 at B = 128: 2*B*R*K = 1.15 GFLOP is 17 us in FP32 FFMA
// (67 TFLOP/s), against 28 MB of traffic (8.4 us at 3.35 TB/s). The first
// version ran FFMA with one row and 32 batch columns per thread: shared
// loads set its pace (0.0749 ms at B = 128 on an NVIDIA H100 80GB HBM3 at
// a 700 W limit, about 15 TFLOP/s) and posedirs was read once per 32 batch
// columns. With the FMAs at their full rate the FFMA route would leave
// only about 17 us of the 34 us target for the loads, the stores and the
// launch, and a register-tiled FFMA version stayed above the target. So
// this version runs on the tensor cores, in 3xTF32:
//   - every factor x is split into big = tf32(x) and small = tf32(x - big),
//     and each product is small*big + big*small + big*big, summed in FP32
//     by mma.sync m16n8k8. Each part keeps 11 significant bits, so the
//     product keeps about 22 of float32's 24 (the dropped small*small term
//     is 2^-22 of it): float32 parity holds, and no product is rounded to a
//     single TF32. Its bound is the larger of 3 * 1.15 GFLOP at 495 TFLOP/s
//     (7.0 us) and the 28 MB (8.4 us): bytes.
//   - a block owns kRowTile = 160 rows and kBatchTile = 128 batch columns:
//     20,670 rows make 130 blocks, one wave on 132 SMs, and posedirs streams
//     from device memory once per 128 batch columns. Each of its 8 warps
//     computes 64 batch columns x 40 rows (4 x 5 tiles of 16 x 8).
//   - K comes in chunks of kChunk rows of dirs through a cp.async ring of
//     kStages stages: first the shape rows (shapedirs, transposed by 4-byte
//     copies), then the pose rows (posedirs in 16-, 8- or 4-byte copies, as
//     R and the pointers allow: 8 bytes for R = 20,670). The block's rows of
//     betas and pose features are contiguous in memory and come in whole,
//     in 16-byte copies, with the first two chunks. The next chunks load
//     while the current one is multiplied.
//   - the fragment loads hit distinct banks: dirs rows are padded to
//     kDirStride floats (8 banks apart per k).
//   - at the end the output tile is staged in shared memory, so each warp
//     writes whole rows of it (256 contiguous bytes per store) with
//     v_template added, instead of 32-byte pieces from the fragments.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowTile = 160;    // vertex rows per block
constexpr int kBatchTile = 128;  // batch columns per block
constexpr int kThreads = 256;    // 8 warps: 2 (batch) x 4 (rows)
constexpr int kWarpBatch = 64, kWarpRows = 40;
constexpr int kMTiles = kWarpBatch / 16;  // 4 tiles of 16 batch columns
constexpr int kNTiles = kWarpRows / 8;    // 5 tiles of 8 rows
constexpr int kChunk = 16;                // K rows per stage
constexpr int kStages = 4;                // stages of the cp.async ring
constexpr int kDirStride = kRowTile + 8;  // 168: 8 banks apart per k
constexpr int kStageFloats = kChunk * kDirStride;
static_assert(kChunk % 8 == 0, "whole k8 steps");

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

constexpr int kOutStride = kRowTile + 8;  // staged output rows

// the ring, then the block's betas and pose rows as they lie in memory;
// at the end the same memory stages the output tile
__host__ __device__ inline size_t smem_floats(int n_shape, int n_pose) {
  const size_t in = (size_t)kStages * kStageFloats +
                    round4(kBatchTile * n_shape) + round4(kBatchTile * n_pose);
  const size_t staged = (size_t)kBatchTile * kOutStride;
  return in > staged ? in : staged;
}

// copies kVec floats (4, 8 or 16 bytes) to shared memory, or zeroes them
template <int kVec>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 * kVec : 0;  // bytes read; the rest is zeroed
  if constexpr (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(4 * kVec), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// x = big + small, both TF32 (round to nearest), small = tf32(x - big)
__device__ __forceinline__ void split(float x, unsigned& big,
                                      unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// floats [0, n) of src to dst (16-byte aligned): 16-byte copies where src
// is 16-byte aligned, else and for the tail 4-byte copies
__device__ __forceinline__ void copy_run(float* dst, const float* src, int n,
                                         int tid) {
  int done = 0;
  if (((uintptr_t)src & 15) == 0) {
    done = n / 4 * 4;
    for (int i = 4 * tid; i < done; i += 4 * kThreads) {
      cp_async<4>(dst + i, src + i, true);
    }
  }
  for (int i = done + tid; i < n; i += kThreads) {
    cp_async<1>(dst + i, src + i, true);
  }
}

// c += a . b for one 16 x 8 tile, k = 8, TF32 inputs, FP32 sums
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int kVec>
__global__ void __launch_bounds__(kThreads, 1) blendshapes_kernel(
    const float* __restrict__ v_template,  // (R,)
    const float* __restrict__ shapedirs,   // (R, S)
    const float* __restrict__ posedirs,    // (P, R)
    const float* __restrict__ betas,       // (B, S)
    const float* __restrict__ pose,        // (B, P)
    float* __restrict__ out,               // (B, R)
    int rows, int n_batch, int n_shape, int n_pose) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [kStages][kStageFloats]
  float* betas_s = ring + kStages * kStageFloats;  // [b][n_shape]
  float* pose_s = betas_s + round4(kBatchTile * n_shape);  // [b][n_pose]
  const int n_shape_chunks = (n_shape + kChunk - 1) / kChunk;
  const int n_chunk = n_shape_chunks + (n_pose + kChunk - 1) / kChunk;
  const int r0 = blockIdx.x * kRowTile;
  const int b0 = blockIdx.y * kBatchTile;
  const int nb = min(kBatchTile, n_batch - b0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // dirs rows [chunk * kChunk, +kChunk) of K into the chunk's stage, zero
  // past every edge: shape chunks first, then pose chunks
  auto load_chunk = [&](int chunk) {
    float* dir = ring + (chunk % kStages) * kStageFloats;
    if (chunk < n_shape_chunks) {  // shapedirs[r, s], transposed
      const int k0 = chunk * kChunk;
      constexpr int kCopies = kChunk * kRowTile / kThreads;
      static_assert(kChunk * kRowTile % kThreads == 0);
#pragma unroll
      for (int u = 0; u < kCopies; ++u) {
        const int i = tid + u * kThreads;
        const int kk = i / kRowTile, r = i - kk * kRowTile;
        const bool valid = k0 + kk < n_shape && r0 + r < rows;
        cp_async<1>(dir + kk * kDirStride + r,
                    valid ? shapedirs + (size_t)(r0 + r) * n_shape + k0 + kk
                          : shapedirs,
                    valid);
      }
    } else {  // posedirs[p, r], rows of kRowTile / kVec copies
      const int k0 = (chunk - n_shape_chunks) * kChunk;
      constexpr int kPerRow = kRowTile / kVec;
      constexpr int kCopies = (kChunk * kPerRow + kThreads - 1) / kThreads;
#pragma unroll
      for (int u = 0; u < kCopies; ++u) {
        const int i = tid + u * kThreads;
        if (kCopies * kThreads > kChunk * kPerRow && i >= kChunk * kPerRow) {
          break;
        }
        const int kk = i / kPerRow, col = (i - kk * kPerRow) * kVec;
        const bool valid = k0 + kk < n_pose && r0 + col < rows;
        cp_async<kVec>(dir + kk * kDirStride + col,
                       valid ? posedirs + (size_t)(k0 + kk) * rows + r0 + col
                             : posedirs,
                       valid);
      }
    }
  };
  // group 0: the block's betas rows (contiguous, 16-byte copies) and chunk
  // 0; its pose rows come with the first pose chunk (chunk 1 when there is
  // a shape chunk); then one chunk per group
  const int pose_group = n_shape_chunks > 0 ? 1 : 0;
  for (int c = 0; c < kStages - 1; ++c) {
    if (c == 0) {
      copy_run(betas_s, betas + (size_t)b0 * n_shape, nb * n_shape, tid);
    }
    if (c == pose_group) {
      copy_run(pose_s, pose + (size_t)b0 * n_pose, nb * n_pose, tid);
    }
    if (c < n_chunk) load_chunk(c);
    cp_async_commit();
  }

  // this warp: batch columns wb + [0, 64), rows wr + [0, 40); lane (g, t)
  // holds the mma fragments of rows/columns g, g + 8 and k = t, t + 4
  const int wb = (warp & 1) * kWarpBatch, wr = (warp >> 1) * kWarpRows;
  const int g = lane >> 2, t = lane & 3;
  float acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    }
  }

  for (int c = 0; c < n_chunk; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed
    __syncthreads();               // for every thread; chunk c - 1 is done
    if (c + kStages - 1 < n_chunk) load_chunk(c + kStages - 1);
    cp_async_commit();
    const float* dir = ring + (c % kStages) * kStageFloats;
    // this chunk's coefficients: columns k0 + [0, kChunk) of betas or pose
    // rows, zero past K (a row past the batch only feeds its own output)
    const bool shape = c < n_shape_chunks;
    const float* cs = shape ? betas_s : pose_s;
    const int n_k = shape ? n_shape : n_pose;
    const int k0 = shape ? c * kChunk : (c - n_shape_chunks) * kChunk;
#pragma unroll
    for (int k8 = 0; k8 < kChunk; k8 += 8) {
      unsigned bb[kNTiles][2], bs[kNTiles][2];  // dirs: big, small
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        const int r = wr + n * 8 + g;
        split(dir[(k8 + t) * kDirStride + r], bb[n][0], bs[n][0]);
        split(dir[(k8 + t + 4) * kDirStride + r], bb[n][1], bs[n][1]);
      }
      const int ka = k0 + k8 + t, kb = ka + 4;
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        const float* row = cs + (wb + m * 16 + g) * n_k;
        const float* row8 = row + 8 * n_k;
        unsigned ab[4], as[4];  // coefficients: big, small
        split(ka < n_k ? row[ka] : 0.f, ab[0], as[0]);
        split(ka < n_k ? row8[ka] : 0.f, ab[1], as[1]);
        split(kb < n_k ? row[kb] : 0.f, ab[2], as[2]);
        split(kb < n_k ? row8[kb] : 0.f, ab[3], as[3]);
#pragma unroll
        for (int n = 0; n < kNTiles; ++n) {
          mma(acc[m][n], as, bb[n][0], bb[n][1]);
          mma(acc[m][n], ab, bs[n][0], bs[n][1]);
          mma(acc[m][n], ab, bb[n][0], bb[n][1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // The sums go to shared memory ([b][kOutStride]; lane (g, t) holds rows
  // 2t, 2t + 1 of each 8-row tile for batch columns g, g + 8 of each
  // 16-column tile), then each warp writes whole output rows with
  // v_template added: 256 contiguous bytes per store instead of 32.
  __syncthreads();  // every warp is done with the ring and coefficients
  float* out_s = ring;
#pragma unroll
  for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* o = out_s + (wb + m * 16 + g + 8 * h) * kOutStride + wr + 2 * t;
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        *reinterpret_cast<float2*>(o + n * 8) =
            make_float2(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
      }
    }
  }
  __syncthreads();
  // lane l writes rows 2l, 2l + 1 of each 64-row run of the tile
  constexpr int kRuns = (kRowTile + 63) / 64;
  float2 vt[kRuns];
#pragma unroll
  for (int q = 0; q < kRuns; ++q) {
    const int r = r0 + q * 64 + 2 * lane;
    vt[q] = make_float2(r < rows ? v_template[r] : 0.f,
                        r + 1 < rows ? v_template[r + 1] : 0.f);
  }
  for (int b = warp; b < nb; b += kThreads / 32) {
    float* o = out + (size_t)(b0 + b) * rows + r0;
    const float* src = out_s + b * kOutStride;
#pragma unroll
    for (int q = 0; q < kRuns; ++q) {
      const int r = q * 64 + 2 * lane;
      if (r >= kRowTile || r0 + r >= rows) break;
      const float2 v = *reinterpret_cast<const float2*>(src + r);
      if constexpr (kVec >= 2) {  // R even: r, r + 1 stand or fall together
        *reinterpret_cast<float2*>(o + r) =
            make_float2(vt[q].x + v.x, vt[q].y + v.y);
      } else {
        o[r] = vt[q].x + v.x;
        if (r0 + r + 1 < rows) o[r + 1] = vt[q].y + v.y;
      }
    }
  }
}

template <int kVec>
int launch(const float* v_template, const float* shapedirs,
           const float* posedirs, const float* betas, const float* pose,
           float* out, int rows, int n_batch, int n_shape, int n_pose,
           dim3 grid, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      blendshapes_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  blendshapes_kernel<kVec><<<grid, kThreads, smem, stream>>>(
      v_template, shapedirs, posedirs, betas, pose, out, rows, n_batch,
      n_shape, n_pose);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` with the caller's plan (ops/blendshapes.py::
// launch_plan): grid (grid_x, grid_y) of kRowTile x kBatchTile tiles,
// `smem` bytes of dynamic shared memory and copies of `vec` floats.
// Returns cudaErrorInvalidValue if the plan does not cover the problem or
// does not match this build, else the launch's cudaGetLastError().
int gaitlab_blendshapes(const float* v_template, const float* shapedirs,
                        const float* posedirs, const float* betas,
                        const float* pose, float* out, int rows, int n_batch,
                        int n_shape, int n_pose, int grid_x, int grid_y,
                        int smem, int vec, void* stream) {
  const uintptr_t align = (uintptr_t)posedirs | (uintptr_t)out;
  const bool vec_ok = (vec == 1 || vec == 2 || vec == 4) && rows % vec == 0 &&
                      align % (4 * vec) == 0;
  if (!vec_ok || (long long)grid_x * kRowTile < rows ||
      (long long)grid_y * kBatchTile < n_batch ||
      (size_t)smem != smem_floats(n_shape, n_pose) * sizeof(float)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(grid_x, grid_y);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4) {
    return launch<4>(v_template, shapedirs, posedirs, betas, pose, out, rows,
                     n_batch, n_shape, n_pose, grid, smem, s);
  }
  if (vec == 2) {
    return launch<2>(v_template, shapedirs, posedirs, betas, pose, out, rows,
                     n_batch, n_shape, n_pose, grid, smem, s);
  }
  return launch<1>(v_template, shapedirs, posedirs, betas, pose, out, rows,
                   n_batch, n_shape, n_pose, grid, smem, s);
}

const char* gaitlab_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

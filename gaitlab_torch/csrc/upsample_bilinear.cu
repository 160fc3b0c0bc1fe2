// Bilinear resize of NCHW planes with align_corners=True, for Hopper
// (sm_90a): the upsampling head of the HRNet backbone (nn/hrnet.py
// `_up_head`, six 2x resizes a forward) and the resize of its other heads.
//
// Replaces no TPU kernel: gaitlab resizes with two interpolation matmuls
// under XLA (gaitlab/nn/layers.py). The port first ran ATen's NCHW kernel
// (`upsample_bilinear2d_out_frame`), which gives each thread one output
// pixel and loops over every (n, c) plane inside it: 3,136 threads at
// 56x56, one block at 14x14. It took 0.398 ms a row at B = 128 (51.006 ms)
// on an NVIDIA H100 80GB HBM3 at 700 W, under 1% of its bound.
//
// Bound: bytes. The six head resizes read 439,040 and write 1,756,160
// values a row (8.78 MB in float32, 2.62 us at 3.35 TB/s) and take four
// products and three sums a value. So this kernel
//   - parallelises over tiles of whole (n, c) planes (or of output rows of
//     one plane, where a plane is large), so every size fills the card;
//   - stages the tile's input rows in shared memory with 16-byte loads
//     where the source is aligned, once, and reads the taps from there;
//   - computes the tile's source rows and weights once (a table in shared
//     memory) and each thread its columns' once (registers: a thread keeps
//     its column vector through all of its rows);
//   - has each thread write kVec consecutive outputs of a row as one 16-,
//     8- or 4-byte store (a streaming hint, st.global.cs, ran about 2%
//     slower at every head shape: the next convolution reads the output).
// The launch geometry, the staged rows included, is
// ops/upsample_bilinear.py::launch_plan's alone; the launcher checks that
// it covers the problem and that the shared memory holds what it stages.
//
// Arithmetic: ATen's, so that float32 outputs equal its bit for bit. The
// scale is (in - 1) / (out - 1) in float; the source coordinate r =
// scale * dst, i0 = (int)r, the next tap i0 + 1 unless i0 is the last, and
// the weights l1 = r - i0, l0 = 1 - l1. The value is
// h0 (w0 x00 + w1 x01) + h1 (w0 x10 + w1 x11), taken in float with the
// fused multiply-adds that nvcc forms from ATen's source (pinned below
// with intrinsics, so no later contraction changes them), and rounded
// once to the storage type. Equal sizes copy, as ATen does.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;  // threads a block may have

// one source coordinate: the first tap, the step to the second (0 at the
// last input), and the weights of the two
struct Tap {
  int i0;
  int step;
  float l0;
  float l1;
};

__device__ __forceinline__ Tap source_tap(float scale, int dst, int in_size) {
  const float r = __fmul_rn(scale, (float)dst);
  Tap t;
  t.i0 = (int)r;  // r >= 0: truncation is floor
  t.step = t.i0 < in_size - 1 ? 1 : 0;
  t.l1 = __fsub_rn(r, (float)t.i0);
  t.l0 = __fsub_rn(1.f, t.l1);
  return t;
}

__device__ __forceinline__ float lerp2d(float h0, float h1, float w0,
                                        float w1, float x00, float x01,
                                        float x10, float x11) {
  return __fmaf_rn(h0, __fmaf_rn(w0, x00, __fmul_rn(w1, x01)),
                   __fmul_rn(h1, __fmaf_rn(w0, x10, __fmul_rn(w1, x11))));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// the integer type of kBytes bytes that carries a vector to memory
template <int kBytes>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<2> {
  using type = unsigned short;
};

template <typename T, int kVec>
__device__ __forceinline__ void store_vec(T* dst, const float (&v)[kVec]) {
  constexpr int kBytes = kVec * (int)sizeof(T);
  using R = typename Raw<kBytes>::type;
  R raw;
  T* parts = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec; ++j) parts[j] = from_float<T>(v[j]);
  *reinterpret_cast<R*>(dst) = raw;
}

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// shared memory a block uses: its `cap` staged input rows of each of its
// planes (rounded up to 16 bytes), then a table of (top, bottom) offsets
// and (l0, l1) weights for each of its output rows
__host__ __device__ inline size_t smem_layout(int plane_tile, int row_tile,
                                              int cap, int in_w, int elt) {
  return round16((size_t)plane_tile * cap * in_w * elt) +
         (size_t)16 * plane_tile * row_tile;
}

// Block b resizes planes [p0, p0 + plane_tile) x output rows [r0, r0 +
// row_tile) (several planes of whole rows, or rows of one plane), with
// blockDim.x threads over a row's column vectors and blockDim.y over rows.
template <typename T, int kVec>
__global__ void __launch_bounds__(kMaxThreads)
    upsample_kernel(const T* __restrict__ in, T* __restrict__ out, int planes,
                    int in_h, int in_w, int out_h, int out_w, float scale_h,
                    float scale_w, int plane_tile, int row_tile,
                    int row_chunks, int cap, bool copy) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  const int group = blockIdx.x / row_chunks;
  const int chunk = blockIdx.x - group * row_chunks;
  const int p0 = group * plane_tile;
  const int n_planes = min(plane_tile, planes - p0);
  const int r0 = chunk * row_tile;
  const int n_rows = min(row_tile, out_h - r0);

  // the input rows [ih0, ih0 + in_rows) of each plane, contiguous in memory
  int ih0 = 0, in_rows = in_h;
  if (row_chunks > 1) {
    const Tap first = source_tap(scale_h, r0, in_h);
    const Tap last = source_tap(scale_h, r0 + n_rows - 1, in_h);
    ih0 = first.i0;
    in_rows = last.i0 + last.step - ih0 + 1;
    if (in_rows > cap) __trap();  // launch_plan's row bound is wrong
  }
  T* in_s = reinterpret_cast<T*>(smem);
  int2* rows_s = reinterpret_cast<int2*>(
      smem + round16((size_t)plane_tile * cap * in_w * sizeof(T)));
  float2* lam_s = reinterpret_cast<float2*>(rows_s + plane_tile * row_tile);

  const T* src = in + ((size_t)p0 * in_h + ih0) * in_w;
  const size_t n = (size_t)n_planes * in_rows * in_w;
  size_t done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const size_t n16 = n * sizeof(T) / 16;
    const uint4* src16 = reinterpret_cast<const uint4*>(src);
    uint4* dst16 = reinterpret_cast<uint4*>(smem);
    for (size_t i = tid; i < n16; i += n_threads) dst16[i] = __ldg(src16 + i);
    done = n16 * 16 / sizeof(T);
  }
  for (size_t i = done + tid; i < n; i += n_threads) in_s[i] = src[i];

  const int tile_rows = n_planes * n_rows;
  for (int r = tid; r < tile_rows; r += n_threads) {
    const int p = r / n_rows;
    const Tap t = source_tap(scale_h, r0 + r - p * n_rows, in_h);
    const int top = (p * in_rows + t.i0 - ih0) * in_w;
    rows_s[r] = make_int2(top, top + t.step * in_w);
    lam_s[r] = make_float2(t.l0, t.l1);
  }
  __syncthreads();

  // tile row r is output row r0 + r of plane p0 (whole planes follow each
  // other, so the rows of the tile are contiguous in memory)
  T* out_tile = out + ((size_t)p0 * out_h + r0) * out_w;
  const int n_vec = out_w / kVec;
  for (int cv = threadIdx.x; cv < n_vec; cv += blockDim.x) {
    int c0[kVec], c1[kVec];
    float w0[kVec], w1[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const Tap t = source_tap(scale_w, cv * kVec + j, in_w);
      c0[j] = t.i0;
      c1[j] = t.i0 + t.step;
      w0[j] = t.l0;
      w1[j] = t.l1;
    }
    for (int r = threadIdx.y; r < tile_rows; r += blockDim.y) {
      const int2 rr = rows_s[r];
      const float2 lh = lam_s[r];
      float v[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float x00 = to_float(in_s[rr.x + c0[j]]);
        v[j] = copy ? x00
                    : lerp2d(lh.x, lh.y, w0[j], w1[j], x00,
                             to_float(in_s[rr.x + c1[j]]),
                             to_float(in_s[rr.y + c0[j]]),
                             to_float(in_s[rr.y + c1[j]]));
      }
      store_vec<T, kVec>(out_tile + (size_t)r * out_w + cv * kVec, v);
    }
  }
}

template <typename T, int kVec>
int launch(const void* in, void* out, int planes, int in_h, int in_w,
           int out_h, int out_w, int plane_tile, int row_tile, int row_chunks,
           int cap, dim3 block, int grid, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        upsample_kernel<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // ATen's area_pixel_compute_scale with align_corners: a float division
  const float scale_h = out_h > 1 ? (float)(in_h - 1) / (float)(out_h - 1) : 0.f;
  const float scale_w = out_w > 1 ? (float)(in_w - 1) / (float)(out_w - 1) : 0.f;
  upsample_kernel<T, kVec><<<grid, block, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), planes, in_h, in_w,
      out_h, out_w, scale_h, scale_w, plane_tile, row_tile, row_chunks, cap,
      in_h == out_h && in_w == out_w);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(int vec, const void* in, void* out, int planes, int in_h,
               int in_w, int out_h, int out_w, int plane_tile, int row_tile,
               int row_chunks, int cap, dim3 block, int grid, size_t smem,
               cudaStream_t stream) {
#define GAITLAB_UPSAMPLE_LAUNCH(V)                                           \
  return launch<T, V>(in, out, planes, in_h, in_w, out_h, out_w, plane_tile, \
                      row_tile, row_chunks, cap, block, grid, smem, stream)
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) GAITLAB_UPSAMPLE_LAUNCH(8);
  }
  if (vec == 4) GAITLAB_UPSAMPLE_LAUNCH(4);
  if (vec == 2) GAITLAB_UPSAMPLE_LAUNCH(2);
  GAITLAB_UPSAMPLE_LAUNCH(1);
#undef GAITLAB_UPSAMPLE_LAUNCH
}

}  // namespace

extern "C" {

// Resizes `planes` contiguous (in_h, in_w) planes of `in` to (out_h,
// out_w) planes of `out` on `stream`; dtype 0 float32, 1 bfloat16, 2
// float16. The plan is ops/upsample_bilinear.py::launch_plan's, taken as
// given: `vec` outputs a store, `plane_tile` planes x `row_tile` output
// rows a block of block_x x block_y threads, `grid` blocks, `cap` input
// rows of each plane staged, `smem` bytes of dynamic shared memory.
// Returns cudaErrorInvalidValue if the plan does not cover the problem or
// its shared memory does not hold the staged rows, else the launch's
// cudaGetLastError().
int gaitlab_upsample_bilinear(const void* in, void* out, int dtype,
                              int planes, int in_h, int in_w, int out_h,
                              int out_w, int vec, int plane_tile,
                              int row_tile, int block_x, int block_y,
                              int grid, int cap, int smem, void* stream) {
  const int elt = dtype == 0 ? 4 : 2;
  const int row_chunks = row_tile > 0 ? (out_h + row_tile - 1) / row_tile : 0;
  const bool ok =
      (dtype == 0 || dtype == 1 || dtype == 2) && planes > 0 && in_h > 0 &&
      in_w > 0 && out_h > 0 && out_w > 0 &&
      (vec == 1 || vec == 2 || vec == 4 || (vec == 8 && elt == 2)) &&
      out_w % vec == 0 && (uintptr_t)out % (vec * elt) == 0 &&
      block_x >= 1 && block_y >= 1 && block_x * block_y <= kMaxThreads &&
      block_x <= out_w / vec && row_tile >= 1 && row_tile <= out_h &&
      plane_tile >= 1 && (row_chunks == 1 || plane_tile == 1) &&
      (long long)grid ==
          ((long long)planes + plane_tile - 1) / plane_tile * row_chunks &&
      cap >= 1 && cap <= in_h && (row_chunks > 1 || cap == in_h) &&
      smem >= 0 &&
      (size_t)smem >= smem_layout(plane_tile, row_tile, cap, in_w, elt);
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 block(block_x, block_y);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch_vec<float>(vec, in, out, planes, in_h, in_w, out_h, out_w,
                             plane_tile, row_tile, row_chunks, cap, block,
                             grid, smem, s);
  }
  if (dtype == 1) {
    return launch_vec<__nv_bfloat16>(vec, in, out, planes, in_h, in_w, out_h,
                                     out_w, plane_tile, row_tile, row_chunks,
                                     cap, block, grid, smem, s);
  }
  return launch_vec<__half>(vec, in, out, planes, in_h, in_w, out_h, out_w,
                            plane_tile, row_tile, row_chunks, cap, block,
                            grid, smem, s);
}

const char* gaitlab_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// Fused keypoint-attention pooling of the PARE head for Hopper (sm_90a).
//
// For each frame b and part j:
//   attn[j, p]  = softmax over the HW positions p of heatmaps[b, p, j]
//   out1[b,j,c] = sum_p attn[j, p] * features[b, p, c]     (c < C1)
//   out2[b,j,c] = sum_p attn[j, p] * cam_feats[b, p, c]    (c < C2)
//
// Replaces the Pallas TPU kernel gaitlab/ops/attention_pallas.py::
// keypoint_attention_fused (pl.pallas_call at :60). Like it, both poolings
// run in one pass over the features and the attention map never goes to
// device memory. The TPU version padded J to 8, HW to 128 and concatenated
// the two feature tensors into 256 lanes; here the two tensors are read
// through their own pointers and strides (an NCHW tensor goes in without a
// permute copy, the background channel is skipped by an offset view) and
// the ragged edges are masked.
//
// Bound on an H100 at B = 128, HW = 3136, J = 24, C1 + C2 = 192: the
// function must read 347 MB of logits and features, about 0.10 ms at
// 3.35 TB/s, and its 3.7 GFLOP take 0.06 ms of FP32 FMA, so it is bound by
// bytes, with the FMAs not far behind.
//
// The first version took three launches: softmax statistics (a first read
// of the 38 MB of logits), pooling over position splits (a second read),
// and a reduction of about 21 MB of partial sums per split. Its tile loop
// made synchronous loads between two barriers, and each thread did 24 FMAs
// per seven shared loads (0.5247 ms at B = 128 on an NVIDIA H100 80GB HBM3
// at a 700 W limit, 0.67 TB/s). This version
// is split attention in the FlashDecoding pattern, in FP32 FFMA (no TF32):
//   1. split: one block per (position split, frame, chunk of kChanTile
//      channels) streams its positions once, in tiles of kTile positions
//      that a cp.async ring brings in ahead of use. Warp w owns parts
//      [6w, 6w + 6): per tile it takes the parts' running max over the
//      tile's logits (one integer max over the warp), rescales its sums when
//      the max rises and turns the logits into unnormalised weights in
//      place (exp2 of (logit - max) * log2(e)). Each lane keeps
//      6 parts x 6 channels of sums and, per four positions, does 144 FMAs
//      for twelve 16-byte shared loads (feature rows are swizzled so those
//      loads are free of bank conflicts). The block writes its (max, sum)
//      per part and its sums, or, with one split, the normalised outputs.
//   2. merge (only with several splits): adds the splits' partials,
//      rescaled to the common max, in a fixed order, so the result does not
//      depend on scheduling.
// Instruction issue, not bytes, set the pace of the first drafts of this
// design: a copy's address cost tens of instructions. So each stage row's
// source pointer is computed once per block into shared memory, and a copy
// is a few instructions. Two stages of 27 KB and at most 128 registers let
// four blocks (16 warps) share an SM, which hides the loads better than
// deeper rings with fewer warps. The wrapper (ops/keypoint_attention.py::
// launch_plan) sizes the split so that the blocks fill the card in whole
// waves and the partials stay a few per cent of the bytes. Copies are 16
// bytes wide where positions are contiguous and aligned (the head's NCHW
// views), else 4 bytes.

#include <cuda_runtime.h>

#include <cstdint>

#include "attention_merge.cuh"

namespace {

constexpr int kJ = 24;              // parts
constexpr int kWarps = 4;           // each owns kJ / kWarps parts
constexpr int kPartsPerWarp = kJ / kWarps;  // 6
constexpr int kChanPerLane = 6;     // channels lane, lane + 32, ...
constexpr int kChanTile = 32 * kChanPerLane;  // 192 channels per block
constexpr int kThreads = 32 * kWarps;         // 128
constexpr int kTile = 32;           // positions per stage
constexpr int kStages = 2;          // stages of the cp.async ring
constexpr int kMinBlocks = 4;       // blocks per SM (registers and smem)
constexpr int kRowsAll = kChanTile + kJ;      // rows of a stage
constexpr int kStageFloats = kRowsAll * kTile;
static_assert(kTile == 32, "one position per lane in the softmax step");

template <int kWidth>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int n_valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kWidth == 4) {
    // 256 bytes to L2: the rest of the row's run serves the next tile
    asm volatile(
        "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(d),
        "l"(src), "r"(4 * n_valid));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(4 * n_valid));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// feature row c of a stage: the 16-byte group of position t is XOR-ed with
// c & 7, so lanes reading eight consecutive rows hit distinct banks
__device__ __forceinline__ int feat_index(int c, int t) {
  return c * kTile + ((((t >> 2) ^ (c & 7)) << 2) | (t & 3));
}

// float <-> int with the same order, for the warp's integer max
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float warp_max(float x) {
  const int i = __reduce_max_sync(0xffffffffu, ordered(x));
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

struct Tensors {
  const float* feat;
  long long fb, fp, fc;
  int c1;
  const float* cam;
  long long cb, cp, cc;
  int c2;
  const float* hm;
  long long hb, hp, hj;
};

// grid (n_split, B, channel chunks). With gridDim.x == 1 the block writes
// out1/out2; else ms_part[(split * B + b) * kJ + j] = (m, s), m the max of
// the logits over the split and s the sum of exp(logit - m), and
// acc_part[((split * B + b) * kJ + j) * (c1 + c2) + c] = the sums weighted
// by those exponentials (not yet divided by s).
template <int kWidth>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    attention_split_kernel(Tensors x, float* __restrict__ out1,
                           float* __restrict__ out2,
                           float2* __restrict__ ms_part,
                           float* __restrict__ acc_part, int hw,
                           int split_len) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [kStages][kStageFloats]
  const int split = blockIdx.x, b = blockIdx.y;
  const int c_all = x.c1 + x.c2, c0 = blockIdx.z * kChanTile;
  const int p_begin = split * split_len;
  const int p_end = min(hw, p_begin + split_len);
  const int n_tiles = (p_end - p_begin + kTile - 1) / kTile;
  const float* feat_b = x.feat + b * x.fb;
  const float* cam_b = x.cam + b * x.cb;
  const float* hm_b = x.hm + b * x.hb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // each stage row's source (nullptr past C) and position stride, once
  __shared__ const float* row_src[kRowsAll];
  __shared__ long long row_sp[kRowsAll];
  for (int row = tid; row < kRowsAll; row += kThreads) {
    const float* src = nullptr;
    long long sp = 0;
    if (row < kChanTile) {
      const int c = c0 + row;
      if (c < x.c1) {
        src = feat_b + c * x.fc;
        sp = x.fp;
      } else if (c < c_all) {
        src = cam_b + (c - x.c1) * x.cc;
        sp = x.cp;
      }
    } else {
      src = hm_b + (row - kChanTile) * x.hj;
      sp = x.hp;
    }
    row_src[row] = src;
    row_sp[row] = sp;
  }
  __syncthreads();

  // tile `tile` of this split into its stage: kChanTile feature rows
  // (swizzled) then kJ logit rows, zero past the split. Each thread copies
  // the same kWidth positions of rows row0 + k * kRowStep; feature rows
  // past C are left as they are (their sums are never written).
  constexpr int kPerRow = kTile / kWidth;
  constexpr int kRowStep = kThreads / kPerRow;
  constexpr int kPasses = (kRowsAll + kRowStep - 1) / kRowStep;
  const int t_copy = (tid % kPerRow) * kWidth, row0 = tid / kPerRow;
  auto load_tile = [&](int tile) {
    float* st = ring + (tile % kStages) * kStageFloats;
    const int p = p_begin + tile * kTile + t_copy;
    const int n = min(max(p_end - p, 0), kWidth);
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      const int row = row0 + k * kRowStep;
      if (kPasses * kRowStep > kRowsAll && row >= kRowsAll) break;
      const float* src = row_src[row];
      if (src == nullptr) continue;
      src += kWidth == 4 ? p : p * row_sp[row];
      float* dst = st + (row < kChanTile ? feat_index(row, t_copy)
                                         : row * kTile + t_copy);
      cp_async<kWidth>(dst, n > 0 ? src : x.feat, n);
    }
  };
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }

  float acc[kPartsPerWarp][kChanPerLane];
  float m[kPartsPerWarp], s[kPartsPerWarp];  // s: this lane's positions
#pragma unroll
  for (int jj = 0; jj < kPartsPerWarp; ++jj) {
    m[jj] = -INFINITY;
    s[jj] = 0.f;
#pragma unroll
    for (int i = 0; i < kChanPerLane; ++i) acc[jj][i] = 0.f;
  }
  const int j0 = warp * kPartsPerWarp;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();  // this tile has landed
    __syncthreads();               // for all threads; the previous is done
    if (tile + kStages - 1 < n_tiles) load_tile(tile + kStages - 1);
    cp_async_commit();
    const float* f_s = ring + (tile % kStages) * kStageFloats;
    float* w_s = ring + (tile % kStages) * kStageFloats + kChanTile * kTile;

    // softmax step of this warp's parts, one position per lane: m is the
    // running max of the logits; the difference to it is taken before the
    // scaling to log2 units, so it stays exact however large the logits
    const bool valid = p_begin + tile * kTile + lane < p_end;
    float alpha[kPartsPerWarp];
#pragma unroll
    for (int jj = 0; jj < kPartsPerWarp; ++jj) {
      float* row = w_s + (j0 + jj) * kTile;
      const float l = valid ? row[lane] : -INFINITY;
      const float mn = fmaxf(m[jj], warp_max(l));
      alpha[jj] = mn == m[jj] ? 1.f : exp2f((m[jj] - mn) * kLog2e);
      const float w = l == -INFINITY ? 0.f : exp2f((l - mn) * kLog2e);
      m[jj] = mn;
      s[jj] = fmaf(s[jj], alpha[jj], w);
      row[lane] = w;
    }
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < kPartsPerWarp; ++jj) {
#pragma unroll
      for (int i = 0; i < kChanPerLane; ++i) acc[jj][i] *= alpha[jj];
    }

    // sums: per four positions, six feature and six weight float4 loads
    // feed 6 x 6 x 4 FMAs
#pragma unroll 1
    for (int q = 0; q < kTile / 4; ++q) {
      float4 f[kChanPerLane], w[kPartsPerWarp];
#pragma unroll
      for (int i = 0; i < kChanPerLane; ++i) {
        f[i] = *reinterpret_cast<const float4*>(
            f_s + feat_index(lane + 32 * i, 4 * q));
      }
#pragma unroll
      for (int jj = 0; jj < kPartsPerWarp; ++jj) {
        w[jj] = *reinterpret_cast<const float4*>(w_s + (j0 + jj) * kTile +
                                                 4 * q);
      }
#pragma unroll
      for (int jj = 0; jj < kPartsPerWarp; ++jj) {
#pragma unroll
        for (int i = 0; i < kChanPerLane; ++i) {
          float a = acc[jj][i];
          a = fmaf(w[jj].x, f[i].x, a);
          a = fmaf(w[jj].y, f[i].y, a);
          a = fmaf(w[jj].z, f[i].z, a);
          a = fmaf(w[jj].w, f[i].w, a);
          acc[jj][i] = a;
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool direct = gridDim.x == 1;
#pragma unroll
  for (int jj = 0; jj < kPartsPerWarp; ++jj) {
    const int j = j0 + jj;
    const float sum = warp_sum(s[jj]);
    const size_t row = (size_t)split * gridDim.y + b;  // (split, b)
    if (!direct && blockIdx.z == 0 && lane == 0) {
      ms_part[row * kJ + j] = make_float2(m[jj], sum);
    }
    const float scale = direct ? 1.f / sum : 1.f;
#pragma unroll
    for (int i = 0; i < kChanPerLane; ++i) {
      const int c = c0 + lane + 32 * i;
      if (c >= c_all) continue;
      const float v = acc[jj][i] * scale;
      if (!direct) {
        acc_part[(row * kJ + j) * c_all + c] = v;
      } else if (c < x.c1) {
        out1[((size_t)b * kJ + j) * x.c1 + c] = v;
      } else {
        out2[((size_t)b * kJ + j) * x.c2 + (c - x.c1)] = v;
      }
    }
  }
}

template <int kWidth>
int launch_split(const Tensors& x, float* out1, float* out2, float2* ms,
                 float* acc, int n_batch, int hw, int n_split, int split_len,
                 int n_chunk, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_split_kernel<kWidth>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_split_kernel<kWidth>
      <<<dim3(n_split, n_batch, n_chunk), kThreads, smem, s>>>(
          x, out1, out2, ms, acc, hw, split_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` with the caller's plan (ops/keypoint_attention.py::
// launch_plan) and returns the first launch error (cudaGetLastError()), or
// 0. The heatmaps must have kJ = 24 parts. Strides are in elements:
// (batch, position, channel) for each feature tensor and (batch, position,
// part) for the heatmaps, where a position p = h * W + w must be
// addressable with one stride. Each split covers split_len positions (a
// multiple of kTile) and channel chunks of kChanTile cover c1 + c2. Scratch
// from the caller when n_split > 1: ms (n_split * B * kJ float2) and acc
// (n_split * B * kJ * (c1 + c2) floats). width 4 needs every position
// stride 1 and every other stride and pointer 16-byte aligned.
int gaitlab_keypoint_attention(
    const float* feat, long long fb, long long fp, long long fc, int c1,
    const float* cam, long long cb, long long cp, long long cc, int c2,
    const float* hm, long long hb, long long hp, long long hj, float* out1,
    float* out2, void* ms, float* acc, int n_batch, int hw, int n_split,
    int split_len, int n_chunk, int width, int smem, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int c_all = c1 + c2;
  const bool plan_ok =
      split_len % kTile == 0 && (long long)n_split * split_len >= hw &&
      (long long)(n_split - 1) * split_len < hw &&
      (long long)n_chunk * kChanTile >= c_all &&
      (size_t)smem == (size_t)kStages * kStageFloats * sizeof(float) &&
      (width == 1 || width == 4) && (n_split == 1 || (ms && acc));
  if (!plan_ok) return (int)cudaErrorInvalidValue;
  const Tensors x{feat, fb, fp, fc, c1, cam, cb, cp, cc, c2, hm, hb, hp, hj};
  float2* ms2 = reinterpret_cast<float2*>(ms);
  const int err =
      width == 4 ? launch_split<4>(x, out1, out2, ms2, acc, n_batch, hw,
                                   n_split, split_len, n_chunk, smem, s)
                 : launch_split<1>(x, out1, out2, ms2, acc, n_batch, hw,
                                   n_split, split_len, n_chunk, smem, s);
  if (err != 0 || n_split == 1) return err;
  return launch_merge(ms2, acc, n_split, (long long)n_batch * kJ, c1, c2,
                      out1, out2, s);
}

const char* gaitlab_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

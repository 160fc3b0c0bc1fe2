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
// permute copy) and the ragged tile edge is masked.
//
// Bound on an H100 at B = 128, HW = 3136, J = 24, C1 + C2 = 192: the
// function must read 347 MB of logits and features, about 0.10 ms at
// 3.35 TB/s, and its 3.7 GFLOP take 0.06 ms of FP32 FMA, so it is bound by
// bytes. The grid has to keep enough loads in flight on all 132 SMs, which
// one block per frame (128 blocks of 6 warps) does not. So the work is cut
// in three launches:
//   1. stats:  one block per (frame, part) takes the max and the sum of
//              exp of the part's logits (an online softmax merge);
//   2. pool:   one block per (frame, HW split) streams its share of the
//              positions through shared memory in tiles of kTile, turns the
//              logits into normalised weights with the stats, and
//              accumulates the J = 24 sums of one channel per thread in
//              registers (FP32 FFMA, never TF32), written as partial sums;
//   3. reduce: adds the splits' partial sums in a fixed order (the result
//              does not depend on scheduling) into the two outputs.
// The wrapper sizes the split so that about eight blocks per SM are in
// flight. The partial sums add 2 * splits * B * J * (C1 + C2) * 4 bytes of
// traffic (about 12% at B = 128). Tensor cores and TMA are for a later
// version.

#include <cuda_runtime.h>

namespace {

constexpr int kJ = 24;       // parts (registers per thread)
constexpr int kTile = 32;    // positions per shared-memory tile
constexpr int kStatsThreads = 256;
constexpr int kReduceThreads = 256;

// merge the online-softmax pair (m2, s2) into (m, s); m = -inf is empty
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void warp_merge(float& m, float& s) {
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
}

// grid (B, kJ), kStatsThreads threads: stats[b * kJ + j] = (max, 1 / sum)
__global__ void __launch_bounds__(kStatsThreads) attention_stats_kernel(
    const float* __restrict__ hm, long long hb, long long hp, long long hj,
    int hw, float2* __restrict__ stats) {
  const int b = blockIdx.x, j = blockIdx.y;
  const float* h = hm + b * hb + j * hj;
  float m = -INFINITY, s = 0.f;
  for (int p = threadIdx.x; p < hw; p += kStatsThreads) {
    const float l = h[p * hp];
    if (l > m) {
      s = s * expf(m - l) + 1.f;
      m = l;
    } else {
      s += expf(l - m);
    }
  }
  warp_merge(m, s);
  __shared__ float m_s[kStatsThreads / 32], s_s[kStatsThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    m_s[warp] = m;
    s_s[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kStatsThreads / 32 ? m_s[lane] : -INFINITY;
    s = lane < kStatsThreads / 32 ? s_s[lane] : 0.f;
    warp_merge(m, s);
    if (lane == 0) stats[b * kJ + j] = make_float2(m, 1.f / s);
  }
}

// grid (splits, B), one thread per channel (c1 + c2 rounded up to a warp):
// partial[((split * B + b) * kJ + j) * (c1 + c2) + c]
__global__ void attention_pool_kernel(
    const float* __restrict__ feat, long long fb, long long fp, long long fc,
    int c1,
    const float* __restrict__ cam, long long cb, long long cp, long long cc,
    int c2,
    const float* __restrict__ hm, long long hb, long long hp, long long hj,
    const float2* __restrict__ stats, float* __restrict__ partial, int hw,
    int split_len) {
  const int c_all = c1 + c2;
  const int cpad = c_all + 1;  // odd row stride: conflict-free tile stores
  extern __shared__ float4 smem4[];
  float* f_s = reinterpret_cast<float*>(smem4);  // [kTile][cpad]
  float* a_s = f_s + ((kTile * cpad + 3) & ~3);  // [kTile][kJ], 16B aligned
  __shared__ float2 stat_s[kJ];

  const int split = blockIdx.x, b = blockIdx.y;
  const int p_begin = split * split_len;
  const int p_end = min(hw, p_begin + split_len);
  const float* hm_b = hm + b * hb;
  const float* feat_b = feat + b * fb;
  const float* cam_b = cam + b * cb;
  if (threadIdx.x < kJ) stat_s[threadIdx.x] = stats[b * kJ + threadIdx.x];

  const int c = threadIdx.x;
  float acc[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) acc[j] = 0.f;

  for (int p0 = p_begin; p0 < p_end; p0 += kTile) {
    __syncthreads();  // stat_s written / the previous tile consumed
    // t fastest: consecutive threads read consecutive positions (NCHW)
#pragma unroll 4
    for (int i = threadIdx.x; i < kTile * kJ; i += blockDim.x) {
      const int j = i / kTile, t = i - j * kTile;
      const int p = p0 + t;
      const float2 st = stat_s[j];
      a_s[t * kJ + j] =
          p < p_end ? expf(hm_b[p * hp + j * hj] - st.x) * st.y : 0.f;
    }
#pragma unroll 4
    for (int i = threadIdx.x; i < kTile * c_all; i += blockDim.x) {
      const int ch = i / kTile, t = i - ch * kTile;
      const int p = p0 + t;
      float v = 0.f;
      if (p < p_end) {
        v = ch < c1 ? feat_b[p * fp + ch * fc] : cam_b[p * cp + (ch - c1) * cc];
      }
      f_s[t * cpad + ch] = v;
    }
    __syncthreads();
    if (c < c_all) {
#pragma unroll 4
      for (int t = 0; t < kTile; ++t) {
        const float f = f_s[t * cpad + c];
        const float4* a4 = reinterpret_cast<const float4*>(a_s + t * kJ);
#pragma unroll
        for (int q = 0; q < kJ / 4; ++q) {
          const float4 a = a4[q];
          acc[4 * q + 0] = fmaf(a.x, f, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(a.y, f, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(a.z, f, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(a.w, f, acc[4 * q + 3]);
        }
      }
    }
  }

  if (c < c_all) {
    float* o = partial + ((size_t)split * gridDim.y + b) * kJ * c_all + c;
#pragma unroll
    for (int j = 0; j < kJ; ++j) o[(size_t)j * c_all] = acc[j];
  }
}

// one thread per output element e = (b * kJ + j) * (c1 + c2) + c
__global__ void __launch_bounds__(kReduceThreads) attention_reduce_kernel(
    const float* __restrict__ partial, int n_split, long long n_elems,
    int c1, int c2, float* __restrict__ out1, float* __restrict__ out2) {
  const long long e = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= n_elems) return;
  float sum = 0.f;
  for (int s = 0; s < n_split; ++s) sum += partial[s * n_elems + e];
  const int c_all = c1 + c2;
  const long long row = e / c_all;  // b * kJ + j
  const int c = (int)(e - row * c_all);
  if (c < c1) {
    out1[row * c1 + c] = sum;
  } else {
    out2[row * c2 + (c - c1)] = sum;
  }
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream` and returns the first launch
// error (cudaGetLastError()), or 0. The heatmaps must have kJ = 24 parts.
// Strides are in elements: (batch, position, channel) for each feature
// tensor and (batch, position, part) for the heatmaps, where a position
// p = h * W + w must be addressable with one stride. Scratch from the
// caller: stats (B * kJ float2) and partial (n_split * B * kJ * (c1 + c2)
// floats); each split covers split_len positions, a multiple of kTile.
int gaitlab_keypoint_attention(
    const float* feat, long long fb, long long fp, long long fc, int c1,
    const float* cam, long long cb, long long cp, long long cc, int c2,
    const float* hm, long long hb, long long hp, long long hj, float* out1,
    float* out2, void* stats, float* partial, int n_batch, int hw,
    int n_split, int split_len, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int c_all = c1 + c2;
  float2* st = reinterpret_cast<float2*>(stats);
  cudaError_t err;

  attention_stats_kernel<<<dim3(n_batch, kJ), kStatsThreads, 0, s>>>(
      hm, hb, hp, hj, hw, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // above 48 KB of shared memory or 1024 threads the launch is refused and
  // the error is returned
  const size_t smem =
      (((kTile * (c_all + 1) + 3) & ~3) + kTile * kJ) * sizeof(float);
  const int threads = (c_all + 31) / 32 * 32;
  attention_pool_kernel<<<dim3(n_split, n_batch), threads, smem, s>>>(
      feat, fb, fp, fc, c1, cam, cb, cp, cc, c2, hm, hb, hp, hj, st, partial,
      hw, split_len);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const long long n_elems = (long long)n_batch * kJ * c_all;
  const unsigned blocks =
      (unsigned)((n_elems + kReduceThreads - 1) / kReduceThreads);
  attention_reduce_kernel<<<blocks, kReduceThreads, 0, s>>>(
      partial, n_split, n_elems, c1, c2, out1, out2);
  return (int)cudaGetLastError();
}

const char* gaitlab_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

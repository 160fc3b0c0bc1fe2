// The merge of keypoint-attention pooling's position splits, shared by
// csrc/keypoint_attention.cu (FP32 inputs) and
// csrc/keypoint_attention_bf16.cu (bf16 inputs). Each split of a frame
// wrote (m, s) per part, m the max of the part's logits over the split and
// s the sum of exp(logit - m), and its pooled sums weighted by those
// exponentials; the merge rescales the splits to their common max.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMergeThreads = 256;

// one thread per output element e = (b * kJ + j) * (c1 + c2) + c: the
// splits' sums rescaled to their common max, added in split order
__global__ void __launch_bounds__(kMergeThreads) attention_merge_kernel(
    const float2* __restrict__ ms_part, const float* __restrict__ acc_part,
    int n_split, long long n_rows, int c1, int c2, float* __restrict__ out1,
    float* __restrict__ out2) {
  const int c_all = c1 + c2;
  const long long n_elems = n_rows * c_all;
  const long long e = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (e >= n_elems) return;
  const long long row = e / c_all;  // b * kJ + j
  const int c = (int)(e - row * c_all);
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) {
    mx = fmaxf(mx, ms_part[s * n_rows + row].x);
  }
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float2 ms = ms_part[s * n_rows + row];
    const float a = ms.x == -INFINITY ? 0.f : exp2f((ms.x - mx) * kLog2e);
    num = fmaf(a, acc_part[s * n_elems + e], num);
    den = fmaf(a, ms.y, den);
  }
  const float v = num / den;
  if (c < c1) {
    out1[row * c1 + c] = v;
  } else {
    out2[row * c2 + (c - c1)] = v;
  }
}

// the merge's launch on `s` for n_rows = B * parts rows of c1 + c2
// channels; returns cudaGetLastError()
int launch_merge(const float2* ms, const float* acc, int n_split,
                 long long n_rows, int c1, int c2, float* out1, float* out2,
                 cudaStream_t s) {
  const unsigned blocks = (unsigned)((n_rows * (c1 + c2) + kMergeThreads - 1) /
                                     kMergeThreads);
  attention_merge_kernel<<<blocks, kMergeThreads, 0, s>>>(
      ms, acc, n_split, n_rows, c1, c2, out1, out2);
  return (int)cudaGetLastError();
}

}  // namespace

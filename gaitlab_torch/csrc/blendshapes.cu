// Fused SMPL blendshapes for Hopper (sm_90a).
//
//   out[b, r] = v_template[r] + sum_s shapedirs[r, s] * betas[b, s]
//                             + sum_p posedirs[p, r] * pose[b, p]
//
// over the R = V*3 flattened vertex rows, contracting S = 10 shape and
// P = 207 pose coefficients.
//
// Replaces the Pallas TPU kernel gaitlab/ops/lbs_pallas.py::blendshapes
// (pl.pallas_call at :70). Like it, one pass over posedirs does both
// contractions and the template add, and the result is written once: the
// shaped vertices never round-trip through device memory.
//
// Bound on an H100 at B = 128: 17.1 MB of posedirs plus 10.6 MB of output
// is about 9 us of HBM, and 2*B*R*(S+P) = 1.15 GFLOP is about 17 us of FP32
// FMA (67 TFLOP/s outside the tensor cores), so the kernel is bound by
// operations. The design keeps every multiply-add in FP32 FFMA (no TF32):
// each thread owns one row and a chunk of kBatch batch columns, holds their
// sums in registers, reads posedirs[p, r] coalesced across the block and the
// coefficients from shared memory as float4 broadcasts, so the inner loop is
// one global load and eight shared loads per 32 FMAs. Tensor cores are work
// for a later version.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;   // rows per block, one per thread
constexpr int kBatch = 32;   // batch columns per block

__global__ void __launch_bounds__(kRows) blendshapes_kernel(
    const float* __restrict__ v_template,  // (R,)
    const float* __restrict__ shapedirs,   // (R, S)
    const float* __restrict__ posedirs,    // (P, R)
    const float* __restrict__ betas,       // (B, S)
    const float* __restrict__ pose,        // (B, P)
    float* __restrict__ out,               // (B, R)
    int rows, int n_batch, int n_shape, int n_pose) {
  // coefficients of this block's batch chunk, column-minor so that one
  // float4 load brings four batch columns: coef[k * kBatch + j]
  extern __shared__ float4 smem4[];
  float* coef = reinterpret_cast<float*>(smem4);
  float* pose_s = coef;                      // k = p
  float* beta_s = coef + n_pose * kBatch;    // k = s
  const int b0 = blockIdx.y * kBatch;

  for (int i = threadIdx.x; i < n_pose * kBatch; i += blockDim.x) {
    const int j = i / n_pose, p = i - j * n_pose;  // p fastest: coalesced read
    pose_s[p * kBatch + j] =
        (b0 + j < n_batch) ? pose[(size_t)(b0 + j) * n_pose + p] : 0.f;
  }
  for (int i = threadIdx.x; i < n_shape * kBatch; i += blockDim.x) {
    const int j = i / n_shape, s = i - j * n_shape;
    beta_s[s * kBatch + j] =
        (b0 + j < n_batch) ? betas[(size_t)(b0 + j) * n_shape + s] : 0.f;
  }
  __syncthreads();

  const int r = blockIdx.x * kRows + threadIdx.x;
  if (r >= rows) return;

  float acc[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) acc[j] = 0.f;

  for (int s = 0; s < n_shape; ++s) {
    const float d = shapedirs[(size_t)r * n_shape + s];
    const float4* c4 = reinterpret_cast<const float4*>(beta_s + s * kBatch);
#pragma unroll
    for (int q = 0; q < kBatch / 4; ++q) {
      const float4 c = c4[q];
      acc[4 * q + 0] = fmaf(d, c.x, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(d, c.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(d, c.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(d, c.w, acc[4 * q + 3]);
    }
  }
#pragma unroll 4
  for (int p = 0; p < n_pose; ++p) {
    const float d = __ldg(posedirs + (size_t)p * rows + r);
    const float4* c4 = reinterpret_cast<const float4*>(pose_s + p * kBatch);
#pragma unroll
    for (int q = 0; q < kBatch / 4; ++q) {
      const float4 c = c4[q];
      acc[4 * q + 0] = fmaf(d, c.x, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(d, c.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(d, c.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(d, c.w, acc[4 * q + 3]);
    }
  }

  const float vt = v_template[r];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (b0 + j < n_batch) out[(size_t)(b0 + j) * rows + r] = vt + acc[j];
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() of the launch.
int gaitlab_blendshapes(const float* v_template, const float* shapedirs,
                        const float* posedirs, const float* betas,
                        const float* pose, float* out, int rows, int n_batch,
                        int n_shape, int n_pose, void* stream) {
  const dim3 grid((rows + kRows - 1) / kRows, (n_batch + kBatch - 1) / kBatch);
  // above 48 KB the launch is refused and the error is returned
  const size_t smem = (size_t)(n_shape + n_pose) * kBatch * sizeof(float);
  blendshapes_kernel<<<grid, kRows, smem, (cudaStream_t)stream>>>(
      v_template, shapedirs, posedirs, betas, pose, out, rows, n_batch,
      n_shape, n_pose);
  return (int)cudaGetLastError();
}

const char* gaitlab_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// DLRM dot interaction, forward: the packed strict lower triangle of each
// sample's Gram matrix.
//
//   out[b, p] = sum_d E[b, rows[p], d] * E[b, cols[p], d],
//   (rows, cols) = np.tril_indices(F, k=-1), p = 0 .. F(F-1)/2 - 1
//
// E is [B, F, D] (bf16 or f32, contiguous); out is [B, P] in E's type.
// Sums are taken in f32 and rounded once to the output type.
//
// Replaces tpu_tfrecord/models/interaction.py::dot_interaction_pallas (body
// _interaction_kernel). The TPU kernel gathers through two one-hot
// selection matmuls because gathers do not lower to its matrix unit; here
// the gather is a plain shared-memory index, so that workaround is not
// carried over.
//
// Bound on an H100 SXM: memory. At the main-path shape (B=16384, F=27,
// D=32, bf16) the kernel must read 28.3 MB of E and write 11.5 MB of out:
// 39.8 MB / 3.35 TB/s = 11.9 us. The arithmetic, 2*B*P*D = 0.37 GFLOP, is
// 5.5 us even on the f32 CUDA cores.
//
// Design: one block of 256 threads takes a tile of `sb` consecutive
// samples. It reads the tile's [sb, F, D] rows once from device memory
// with coalesced loads, converts them to f32 into shared memory (row stride
// padded to an odd number of words so the rows that one warp reads at the
// same d fall in distinct banks), and then each thread takes (sample, pair)
// outputs strided over sb*P, so neighbouring threads write neighbouring
// outputs. The [B, F, F] Gram matrix never reaches device memory. The pair
// tables come from the caller; p is never inverted with a float sqrt.
// Making it fast (vector loads, mma/wgmma for the Gram) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSamplesPerBlock = 8;
constexpr int kDefaultSmemBytes = 48 * 1024;
constexpr int kMaxSmemBytes = 227 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_interaction_kernel(const T* __restrict__ emb, T* __restrict__ out,
                       const int32_t* __restrict__ rows,
                       const int32_t* __restrict__ cols, int B, int F, int D,
                       int P, int sb, int stride) {
  extern __shared__ float tile[];  // [sb, F, stride]
  const int b0 = blockIdx.x * sb;
  const int n_s = min(sb, B - b0);
  const int fd = F * D;

  const T* src = emb + (size_t)b0 * fd;
  for (int i = threadIdx.x; i < n_s * fd; i += blockDim.x) {
    const int s = i / fd;
    const int rem = i - s * fd;
    const int f = rem / D;
    const int d = rem - f * D;
    tile[(s * F + f) * stride + d] = to_f32(src[i]);
  }
  __syncthreads();

  T* dst = out + (size_t)b0 * P;
  for (int i = threadIdx.x; i < n_s * P; i += blockDim.x) {
    const int s = i / P;
    const int p = i - s * P;
    const float* a = tile + (s * F + rows[p]) * stride;
    const float* c = tile + (s * F + cols[p]) * stride;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(a[d], c[d], acc);
    dst[i] = from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* emb, void* out, const int32_t* rows,
                   const int32_t* cols, int B, int F, int D, int P,
                   cudaStream_t stream) {
  const int stride = D | 1;  // odd word stride: conflict-free row reads
  const int per_sample = F * stride * (int)sizeof(float);
  if (per_sample > kMaxSmemBytes) return cudaErrorInvalidValue;
  int sb = kDefaultSmemBytes / per_sample;
  if (sb > kMaxSamplesPerBlock) sb = kMaxSamplesPerBlock;
  if (sb < 1) sb = 1;
  const int smem = sb * per_sample;
  if (smem > kDefaultSmemBytes) {
    cudaError_t err = cudaFuncSetAttribute(
        dot_interaction_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (B + sb - 1) / sb;
  dot_interaction_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(emb), static_cast<T*>(out), rows, cols, B, F, D, P,
      sb, stride);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); the caller raises on anything else.
extern "C" int dot_interaction_fwd(const void* emb, void* out, const void* rows,
                                   const void* cols, int B, int F, int D, int P,
                                   int dtype, void* stream) {
  if (B <= 0 || P <= 0) return (int)cudaSuccess;
  const int32_t* r = static_cast<const int32_t*>(rows);
  const int32_t* c = static_cast<const int32_t*>(cols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(emb, out, r, c, B, F, D, P, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(emb, out, r, c, B, F, D, P, s);
  return (int)cudaErrorInvalidValue;
}

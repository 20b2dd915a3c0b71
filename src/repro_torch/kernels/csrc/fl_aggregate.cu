// eq.-(4) aggregation on the flat model, hand-written for Hopper (sm_90a).
//
//   out[n] = theta[n] + sum_k coeffs[k] * deltas[k, n]     (fl_aggregate)
//   out[n] =            sum_k coeffs[k] * deltas[k, n]     (fl_delta_reduce)
//
// Replaces the Pallas TPU kernel `fl_aggregate_tpu`
// (src/repro/kernels/fl_aggregate.py, body `_aggregate_kernel`), which
// streams [K, 65536] tiles through VMEM with the coefficients in scalar
// prefetch and zero-pads N up to the block.
//
// What bounds it on the card: bytes.  Each element costs K + 1 reads and
// one write (K + 2 words) against 2K flops, far below the H100's
// operations-per-byte balance, so the kernel is a streaming pass whose
// only job is to keep HBM busy:
//   * a grid-stride loop over N, VEC contiguous elements per thread per
//     trip, loaded and stored as one 16-, 8- or 4-byte vector (the host
//     picks the widest VEC that every row start and pointer is aligned to;
//     N is neither padded nor copied, the tail past the last full vector is
//     handled below by scalar code);
//   * the K coefficients are read once per block into shared memory;
//   * the sum over k runs in f32 whatever the storage type, and the output
//     is written in theta's type (f32 for the theta-less reduce).
// The delta-reduce variant has no theta, so no zero vector is allocated.
//
// Plain C interface (no PyTorch headers, so the build takes seconds): the
// Python wrapper (repro_torch/kernels/fl_aggregate.py) validates devices,
// dtypes, shapes and contiguity, passes raw pointers and the current
// stream, and raises on any non-zero return code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// dynamic shared memory for the coefficients stays under the 48 KB default
constexpr int kMaxK = 12288;

enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// TT: theta type (unused when !HAS_THETA), TD: delta type, TO: output type.
template <typename TT, typename TD, typename TO, int VEC, bool HAS_THETA>
__global__ void __launch_bounds__(kThreads)
    fl_aggregate_kernel(const TT* __restrict__ theta,
                        const TD* __restrict__ deltas,
                        const float* __restrict__ coeffs,
                        TO* __restrict__ out, int k_count, long long n) {
  extern __shared__ float s_coeff[];
  for (int k = threadIdx.x; k < k_count; k += blockDim.x) {
    s_coeff[k] = coeffs[k];
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_vec = n / VEC;

  for (long long i = first; i < n_vec; i += stride) {
    const long long base = i * VEC;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
    const TD* row = deltas + base;
#pragma unroll 4
    for (int k = 0; k < k_count; ++k) {
      const Pack<TD, VEC> d =
          *reinterpret_cast<const Pack<TD, VEC>*>(row + (long long)k * n);
      const float c = s_coeff[k];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = fmaf(c, to_f32(d.v[j]), acc[j]);
    }
    Pack<TO, VEC> o;
    if constexpr (HAS_THETA) {
      const Pack<TT, VEC> t = *reinterpret_cast<const Pack<TT, VEC>*>(
          theta + base);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        o.v[j] = from_f32<TO>(to_f32(t.v[j]) + acc[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) o.v[j] = from_f32<TO>(acc[j]);
    }
    *reinterpret_cast<Pack<TO, VEC>*>(out + base) = o;
  }

  // scalar tail: the n % VEC elements past the last full vector
  for (long long idx = n_vec * VEC + first; idx < n; idx += stride) {
    float acc = 0.0f;
    for (int k = 0; k < k_count; ++k) {
      acc = fmaf(s_coeff[k], to_f32(deltas[(long long)k * n + idx]), acc);
    }
    if constexpr (HAS_THETA) acc += to_f32(theta[idx]);
    out[idx] = from_f32<TO>(acc);
  }
}

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

bool aligned(const void* p, size_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

template <typename TT, typename TD, typename TO, bool HAS_THETA, int VEC>
cudaError_t launch_vec(const void* theta, const void* deltas,
                       const float* coeffs, void* out, int k_count,
                       long long n, cudaStream_t stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long work = n / VEC > 0 ? n / VEC : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 8;  // 8 resident blocks per SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  fl_aggregate_kernel<TT, TD, TO, VEC, HAS_THETA>
      <<<(unsigned)blocks, kThreads, k_count * sizeof(float), stream>>>(
          static_cast<const TT*>(theta), static_cast<const TD*>(deltas),
          coeffs, static_cast<TO*>(out), k_count, n);
  return cudaGetLastError();
}

// Launch with the widest vector (in elements, at most VEC) that every
// pointer and every delta row start is aligned to; rows start at k * n, so
// with K > 1 the width must divide n.  Halves the width until it fits.
template <typename TT, typename TD, typename TO, bool HAS_THETA, int VEC>
cudaError_t launch_aligned(const void* theta, const void* deltas,
                           const float* coeffs, void* out, int k_count,
                           long long n, cudaStream_t stream) {
  if constexpr (VEC > 1) {
    const bool ok =
        aligned(deltas, VEC * sizeof(TD)) && aligned(out, VEC * sizeof(TO)) &&
        (!HAS_THETA || aligned(theta, VEC * sizeof(TT))) &&
        (k_count == 1 || n % VEC == 0);
    if (!ok) {
      return launch_aligned<TT, TD, TO, HAS_THETA, VEC / 2>(
          theta, deltas, coeffs, out, k_count, n, stream);
    }
  }
  return launch_vec<TT, TD, TO, HAS_THETA, VEC>(theta, deltas, coeffs, out,
                                                k_count, n, stream);
}

// Entry for one dtype combination: 16-byte vectors of the widest type.
template <typename TT, typename TD, typename TO, bool HAS_THETA>
cudaError_t launch(const void* theta, const void* deltas, const float* coeffs,
                   void* out, int k_count, long long n, cudaStream_t stream) {
  constexpr int kVec = (int)(
      16 / cmax(sizeof(TD), cmax(sizeof(TO), HAS_THETA ? sizeof(TT) : 1)));
  return launch_aligned<TT, TD, TO, HAS_THETA, kVec>(
      theta, deltas, coeffs, out, k_count, n, stream);
}

cudaError_t check_args(const void* deltas, const float* coeffs,
                       const void* out, int k_count, long long n) {
  if (deltas == nullptr || coeffs == nullptr || out == nullptr || n < 1 ||
      k_count < 1 || k_count > kMaxK) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The largest K the kernel takes (its coefficients live in shared memory).
int fl_aggregate_max_k() { return kMaxK; }

// Readable text of a code returned by the launchers below.
const char* fl_aggregate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// theta [N] (dtype theta_dtype), deltas [K, N] (dtype delta_dtype),
// coeffs [K] f32 -> out [N] in theta_dtype.  Dtype codes: 0 f32, 1 bf16.
// Returns a cudaError_t code (0 on success).
int fl_aggregate_launch(const void* theta, const void* deltas,
                        const float* coeffs, void* out, int k_count,
                        long long n, int theta_dtype, int delta_dtype,
                        void* stream) {
  cudaError_t err = check_args(deltas, coeffs, out, k_count, n);
  if (err != cudaSuccess || theta == nullptr) {
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (theta_dtype == kF32 && delta_dtype == kF32) {
    err = launch<float, float, float, true>(theta, deltas, coeffs, out,
                                            k_count, n, s);
  } else if (theta_dtype == kBF16 && delta_dtype == kBF16) {
    err = launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, true>(
        theta, deltas, coeffs, out, k_count, n, s);
  } else if (theta_dtype == kF32 && delta_dtype == kBF16) {
    err = launch<float, __nv_bfloat16, float, true>(theta, deltas, coeffs,
                                                    out, k_count, n, s);
  } else if (theta_dtype == kBF16 && delta_dtype == kF32) {
    err = launch<__nv_bfloat16, float, __nv_bfloat16, true>(
        theta, deltas, coeffs, out, k_count, n, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// deltas [K, N] (dtype delta_dtype), coeffs [K] f32 -> out [N] f32.
int fl_delta_reduce_launch(const void* deltas, const float* coeffs,
                           void* out, int k_count, long long n,
                           int delta_dtype, void* stream) {
  cudaError_t err = check_args(deltas, coeffs, out, k_count, n);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (delta_dtype == kF32) {
    err = launch<float, float, float, false>(nullptr, deltas, coeffs, out,
                                             k_count, n, s);
  } else if (delta_dtype == kBF16) {
    err = launch<float, __nv_bfloat16, float, false>(nullptr, deltas, coeffs,
                                                     out, k_count, n, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"

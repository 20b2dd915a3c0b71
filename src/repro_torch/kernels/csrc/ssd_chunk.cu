// Mamba-2 SSD within one chunk, hand-written for Hopper (sm_90a).
//
// For each (batch b, head h, chunk c) of length L, with a = -exp(a_log[h])
// and cum_i = sum_{t <= i} dt_t * a (within the chunk):
//
//   y_diag[i, :] = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j
//   state[:, n]  = sum_j x_j * (dt_j * exp(cum_{L-1} - cum_j)) * B_j[n]
//
// Replaces the Pallas TPU kernel `ssd_chunk_tpu`
// (src/repro/kernels/ssd_scan.py:65, body `_ssd_chunk_kernel` :34-62),
// whose grid (B, nh, nc) holds a whole chunk ([L, L] decay and scores,
// [L, N] B and C) in VMEM.  At mamba2-130m's L = 256, N = 128, hd = 64 in
// f32 that is over 500 KB, more than a block's 227 KB of shared memory, so
// here one block owns a (b, h, c) and walks the chunk in 64-row tiles:
// the cumulative decay `cum` (a scan of L values) stays in shared memory,
// each (row tile i, column tile j <= i) pair builds its 64 x 64 block of
// weights and adds it into a 64 x hd output tile, and the [hd, N] state
// is built in a second loop over the j tiles.
//
// seg = cum_i - cum_j is positive above the diagonal (da <= 0), where
// exp(seg) may overflow to inf: the kernel selects 0 there (never
// multiplies by a 0/1 mask, which would give inf * 0 = NaN), as the
// reference's `jnp.where` does.  The work above the diagonal is skipped.
// C B^T does not depend on the head, and the TPU grid recomputes it per
// head; so does this first version.
//
// What bounds it on the card: operations.  At mamba2-130m's serving point
// (B = 4, S = 2048, nh = 24, hd = 64, N = 128, L = 256, f32) the triangle
// of C B^T and W X plus the states is about 13 GFLOP (22.6 GFLOP counting
// the full L x L squares, as the TPU kernel computes them), 0.19 ms at
// the 67 TFLOP/s f32 rate, against about 0.04 ms for the 134 MB moved.
// This first version keeps every operand in shared memory and every
// output element's sum in one thread's register across its inner loop
// (one broadcast and one conflict-free shared load per FMA; rows padded
// by one word); register tiling and tensor cores are later work.
//
// Plain C interface (no PyTorch headers); the Python wrapper
// (repro_torch/kernels/ssd_scan.py) validates the inputs and raises on any
// non-zero return code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // rows of a tile
constexpr int kThreads = 256;

enum DType : int { kF32 = 0, kBF16 = 1 };

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
  return __float2bfloat16(x);
}

struct Params {
  const void* x;       // [B, S, nh, hd]
  const void* dt;      // [B, S, nh]
  const void* a_log;   // [nh]
  const void* b;       // [B, S, N]
  const void* c;       // [B, S, N]
  void* y;             // [B, S, nh, hd], x's dtype
  float* states;       // [B, nc, nh, hd, N], f32
  int batch, seq, nh, hd, n, chunk;
};

__host__ __device__ inline size_t smem_floats(int chunk, int hd, int n) {
  const size_t phase_y = (size_t)kT * (n + 1) + (size_t)kT * (kT + 1) +
                         (size_t)kT * hd;
  const size_t phase_s = (size_t)hd * n;
  return 2 * (size_t)chunk + (size_t)kT * (n + 1) + (size_t)kT * (hd + 1) +
         (phase_y > phase_s ? phase_y : phase_s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(Params p) {
  extern __shared__ float smem[];
  const int L = p.chunk, hd = p.hd, N = p.n;
  const int ldn = N + 1, ldx = hd + 1, ldw = kT + 1;
  float* cum = smem;                  // [L]
  float* s_dt = cum + L;              // [L]
  float* s_b = s_dt + L;              // [kT][N + 1]
  float* s_x = s_b + kT * ldn;        // [kT][hd + 1]
  float* region = s_x + kT * ldx;
  float* s_c = region;                // y phase: [kT][N + 1]
  float* s_w = s_c + kT * ldn;        //          [kT][kT + 1]
  float* s_y = s_w + kT * ldw;        //          [kT][hd]
  float* s_state = region;            // state phase: [hd][N]

  const int h = blockIdx.x;
  const int chunk_id = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nc = p.seq / L;
  const long long row0 = (long long)b * p.seq + (long long)chunk_id * L;

  const T* x = static_cast<const T*>(p.x);
  const T* dt = static_cast<const T*>(p.dt);
  const T* bm = static_cast<const T*>(p.b);
  const T* cm = static_cast<const T*>(p.c);
  T* y = static_cast<T*>(p.y);
  const float a = -expf(to_f32(static_cast<const T*>(p.a_log)[h]));

  for (int i = tid; i < L; i += kThreads) {
    s_dt[i] = to_f32(dt[(row0 + i) * p.nh + h]);
  }
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int i = 0; i < L; ++i) {
      run = __fadd_rn(run, __fmul_rn(s_dt[i], a));
      cum[i] = run;
    }
  }
  __syncthreads();

  // ---- y_diag, one 64-row tile at a time
  for (int i0 = 0; i0 < L; i0 += kT) {
    const int ti = min(kT, L - i0);
    for (int e = tid; e < ti * N; e += kThreads) {
      const int r = e / N, col = e - r * N;
      s_c[r * ldn + col] = to_f32(cm[(row0 + i0 + r) * N + col]);
    }
    for (int e = tid; e < ti * hd; e += kThreads) s_y[e] = 0.f;
    for (int j0 = 0; j0 <= i0; j0 += kT) {
      const int tj = min(kT, L - j0);
      __syncthreads();
      for (int e = tid; e < tj * N; e += kThreads) {
        const int r = e / N, col = e - r * N;
        s_b[r * ldn + col] = to_f32(bm[(row0 + j0 + r) * N + col]);
      }
      for (int e = tid; e < tj * hd; e += kThreads) {
        const int r = e / hd, col = e - r * hd;
        s_x[r * ldx + col] = to_f32(x[((row0 + j0 + r) * p.nh + h) * hd + col]);
      }
      __syncthreads();
      for (int e = tid; e < ti * tj; e += kThreads) {
        const int r = e / tj, q = e - r * tj;
        const int gi = i0 + r, gj = j0 + q;
        float w = 0.f;
        if (gj <= gi) {
          float sc = 0.f;
          for (int k = 0; k < N; ++k) {
            sc = fmaf(s_c[r * ldn + k], s_b[q * ldn + k], sc);
          }
          w = sc * expf(cum[gi] - cum[gj]) * s_dt[gj];
        }
        s_w[r * ldw + q] = w;
      }
      __syncthreads();
      for (int e = tid; e < ti * hd; e += kThreads) {
        const int r = e / hd, col = e - r * hd;
        float acc = s_y[e];
        for (int q = 0; q < tj; ++q) {
          acc = fmaf(s_w[r * ldw + q], s_x[q * ldx + col], acc);
        }
        s_y[e] = acc;
      }
    }
    __syncthreads();
    for (int e = tid; e < ti * hd; e += kThreads) {
      const int r = e / hd, col = e - r * hd;
      y[((row0 + i0 + r) * p.nh + h) * hd + col] = from_f32<T>(s_y[e]);
    }
    __syncthreads();
  }

  // ---- the chunk's end state
  for (int e = tid; e < hd * N; e += kThreads) s_state[e] = 0.f;
  const float cum_end = cum[L - 1];
  for (int j0 = 0; j0 < L; j0 += kT) {
    const int tj = min(kT, L - j0);
    __syncthreads();
    for (int e = tid; e < tj * N; e += kThreads) {
      const int r = e / N, col = e - r * N;
      s_b[r * ldn + col] = to_f32(bm[(row0 + j0 + r) * N + col]);
    }
    for (int e = tid; e < tj * hd; e += kThreads) {
      const int r = e / hd, col = e - r * hd;
      const int gj = j0 + r;
      const float xv = to_f32(x[((row0 + gj) * p.nh + h) * hd + col]);
      s_x[r * ldx + col] = xv * (s_dt[gj] * expf(cum_end - cum[gj]));
    }
    __syncthreads();
    for (int e = tid; e < hd * N; e += kThreads) {
      const int dd = e / N, col = e - dd * N;
      float acc = s_state[e];
      for (int q = 0; q < tj; ++q) {
        acc = fmaf(s_x[q * ldx + dd], s_b[q * ldn + col], acc);
      }
      s_state[e] = acc;
    }
  }
  __syncthreads();
  float* out = p.states +
               (((long long)b * nc + chunk_id) * p.nh + h) * (long long)hd * N;
  for (int e = tid; e < hd * N; e += kThreads) out[e] = s_state[e];
}

template <typename T>
cudaError_t launch_typed(const Params& p, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(p.chunk, p.hd, p.n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.nh, p.seq / p.chunk, p.batch);
  ssd_chunk_kernel<T><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 on success); 1 (cudaErrorInvalidValue) for
// arguments the kernel does not take.
int ssd_chunk_launch(const void* x, const void* dt, const void* a_log,
                     const void* b, const void* c, void* y, float* states,
                     int dtype, int batch, int seq, int nh, int hd, int n,
                     int chunk, void* stream) {
  if (batch <= 0 || seq <= 0 || nh <= 0 || hd <= 0 || n <= 0 || chunk <= 0 ||
      seq % chunk != 0 || seq / chunk > 65535 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.x = x;
  p.dt = dt;
  p.a_log = a_log;
  p.b = b;
  p.c = c;
  p.y = y;
  p.states = states;
  p.batch = batch;
  p.seq = seq;
  p.nh = nh;
  p.hd = hd;
  p.n = n;
  p.chunk = chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return (int)launch_typed<float>(p, s);
  if (dtype == kBF16) return (int)launch_typed<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}

long long ssd_chunk_smem_bytes(int chunk, int hd, int n) {
  return (long long)(sizeof(float) * smem_floats(chunk, hd, n));
}

const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

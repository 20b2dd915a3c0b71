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
// [L, N] B and C) in VMEM and recomputes C B^T for every head.  At
// mamba2-130m's L = 256, N = 128, hd = 64 in f32 that is over 500 KB,
// more than a block's 227 KB of shared memory.
//
// Two passes here, both launched by the wrapper on one stream:
//
// 1. `ssd_scores_kernel`: C B^T does not depend on the head (B and C are
//    [B, S, N]), so it is computed once per (b, chunk), for the tiles of
//    the lower triangle only, into a [B, nc, L, L] f32 scratch the
//    wrapper allocates (8.4 MB at mamba2, it stays in the 50 MB L2).  It
//    is stored transposed, scores[b, c, j, i] = C_i . B_j (0 above the
//    diagonal), so that pass 2 reads it along i.
// 2. `ssd_chunk_kernel`: one block per (b, h, chunk).  The cumulative
//    decay `cum` (a scan of L values, in the order of the plain version)
//    and dt_j exp(cum_{L-1} - cum_j) stay in shared memory.  For each
//    64-row output tile and each 64-row tile j <= i it builds the tile of
//    weights W^T[j][i] = scores * exp(cum_i - cum_j) * dt_j, selecting 0
//    above the diagonal (seg = cum_i - cum_j > 0 there and exp(seg) may
//    overflow to inf: never multiplied by a 0/1 mask), and adds W X into
//    registers; then the [hd, N] state over all j.  Each thread owns a
//    4 x 4 micro-tile of W X and a 4 x 8 micro-tile of the state and reads
//    its operands from shared memory as float4, so each pair of shared
//    loads feeds 16 FMAs.  Shared memory: 2 KB of `cum` and 48 KB of
//    tiles at mamba2, so several blocks fit on an SM.
//
// What bounds it on the card: operations.  At mamba2-130m's serving point
// (B = 4, S = 2048, nh = 24, hd = 64, N = 128, L = 256, f32) the work the
// inputs need is 6.72 GFLOP (C B^T once per (b, chunk) over the triangle,
// W X over the triangle and the states per head), 0.100 ms at the
// 67 TFLOP/s f32 rate, against about 0.04 ms for the 134 MB moved.
// Accumulation is f32; bf16 inputs are converted on load.
//
// Plain C interface (no PyTorch headers); the Python wrapper
// (repro_torch/kernels/ssd_scan.py) validates the inputs, allocates the
// outputs and the scores scratch, and raises on any non-zero return code.

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
  float* scores;       // [B, nc, L, ld] f32 scratch: [b, c, j, i] = C_i . B_j
  int batch, seq, nh, hd, n, chunk;
};

// row stride of the scores scratch: L rounded up to a float4
__host__ __device__ inline int scores_ld(int chunk) { return (chunk + 3) & ~3; }

constexpr int kK = 32;          // depth of one step of the scores product
constexpr int kHd = 64;         // head-dim columns of one W X / state tile
constexpr int kN = 128;         // state columns of one state tile

// cum, dt and the end-decay factor, padded to a float4 boundary
__host__ __device__ inline int vec_floats(int chunk) {
  return (3 * chunk + 3) & ~3;
}

__host__ __device__ inline size_t smem_floats(int chunk) {
  // the vectors, then the larger phase's tiles:
  // W^T [kT][kT] + X [kT][kHd], or X' [kT][kHd] + B [kT][kN]
  const size_t phase_y = (size_t)kT * kT + (size_t)kT * kHd;
  const size_t phase_s = (size_t)kT * kHd + (size_t)kT * kN;
  return (size_t)vec_floats(chunk) + (phase_y > phase_s ? phase_y : phase_s);
}

// ---- pass 1: the lower-triangle tiles of C B^T for one (b, chunk)
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scores_kernel(Params p) {
  __shared__ __align__(16) float s_ct[kK][kT + 4];   // C^T: [n][i]
  __shared__ __align__(16) float s_bt[kK][kT + 4];   // B^T: [n][j]
  const int L = p.chunk, N = p.n;
  // blockIdx.x enumerates the tile pairs (ti, tj), tj <= ti
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= (int)blockIdx.x) ++ti;
  const int tj = (int)blockIdx.x - ti * (ti + 1) / 2;
  const int i0 = ti * kT, j0 = tj * kT;
  const int chunk_id = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;     // columns i0 + 4 tx .. + 3
  const int ty = tid >> 4;     // rows j0 + 4 ty .. + 3
  const int nc = p.seq / L;
  const long long row0 = (long long)b * p.seq + (long long)chunk_id * L;
  const T* bm = static_cast<const T*>(p.b);
  const T* cm = static_cast<const T*>(p.c);

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kK) {
    __syncthreads();
    for (int e = tid; e < kT * kK; e += kThreads) {
      const int r = e / kK, kk = e - r * kK;
      const bool kin = k0 + kk < N;
      const int gi = i0 + r, gj = j0 + r;
      s_ct[kk][r] = (kin && gi < L) ? to_f32(cm[(row0 + gi) * N + k0 + kk])
                                    : 0.f;
      s_bt[kk][r] = (kin && gj < L) ? to_f32(bm[(row0 + gj) * N + k0 + kk])
                                    : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk) {
      const float4 cv = *reinterpret_cast<const float4*>(&s_ct[kk][4 * tx]);
      const float4 bv = *reinterpret_cast<const float4*>(&s_bt[kk][4 * ty]);
      const float cs[4] = {cv.x, cv.y, cv.z, cv.w};
      const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(bs[a], cs[c], acc[a][c]);
    }
  }

  const int ld = scores_ld(L);
  float* out = p.scores + ((long long)b * nc + chunk_id) * L * (long long)ld;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gj = j0 + 4 * ty + a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gi = i0 + 4 * tx + c;
      if (gi < L && gj < L) {
        out[(long long)gj * ld + gi] = gj <= gi ? acc[a][c] : 0.f;
      }
    }
  }
}

// four consecutive values as f32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* ptr) {
  return *reinterpret_cast<const float4*>(ptr);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* ptr) {
  const uint2 u = *reinterpret_cast<const uint2*>(ptr);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}
__device__ __forceinline__ void store4(float* ptr, float4 v) {
  *reinterpret_cast<float4*>(ptr) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* ptr, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(ptr) = u;
}

// ---- pass 2: y_diag and the end state of one (b, h, chunk).  hd and N
// are multiples of 4 (the wrapper checks): rows of x, B, the scores, y
// and the states move 4 values at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int L = p.chunk, hd = p.hd, N = p.n;
  const int ld = scores_ld(L);
  float* cum = smem;                  // [L]
  float* s_dt = cum + L;              // [L]
  float* s_fac = s_dt + L;            // [L]: dt_j exp(cum_{L-1} - cum_j)
  float* region = smem + vec_floats(L);   // 16-byte aligned
  float* s_wt = region;               // y phase: W^T [kT][kT] ([j][i])
  float* s_x = s_wt + kT * kT;        //          X [kT][kHd]
  float* s_xw = region;               // state phase: X' [kT][kHd]
  float* s_b = s_xw + kT * kHd;       //              B [kT][kN]

  const int h = blockIdx.x;
  const int chunk_id = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nc = p.seq / L;
  const long long row0 = (long long)b * p.seq + (long long)chunk_id * L;
  const long long x_ld = (long long)p.nh * hd;   // x and y row stride

  const T* dt = static_cast<const T*>(p.dt);
  const T* x_h = static_cast<const T*>(p.x) + row0 * x_ld + (long long)h * hd;
  const T* b_c = static_cast<const T*>(p.b) + row0 * N;
  T* y_h = static_cast<T*>(p.y) + row0 * x_ld + (long long)h * hd;
  const float* scores =
      p.scores + ((long long)b * nc + chunk_id) * L * (long long)ld;
  const float a = -expf(to_f32(static_cast<const T*>(p.a_log)[h]));
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

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
  const float cum_end = cum[L - 1];
  for (int i = tid; i < L; i += kThreads) {
    s_fac[i] = s_dt[i] * expf(cum_end - cum[i]);
  }

  // ---- y_diag: rows i0 + 4 ty + r, head-dim columns d0 + 4 tx + c
  for (int i0 = 0; i0 < L; i0 += kT) {
    const int ti = min(kT, L - i0);
    for (int d0 = 0; d0 < hd; d0 += kHd) {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int j0 = 0; j0 <= i0; j0 += kT) {
        const int tj = min(kT, L - j0);
        __syncthreads();
        // X [kT][kHd]: thread e takes row e / 16, columns 4 (e % 16) ..
        for (int e = tid; e < kT * kHd / 4; e += kThreads) {
          const int j = e >> 4, dd = 4 * (e & 15);
          store4(&s_x[j * kHd + dd],
                 (j < tj && d0 + dd < hd)
                     ? load4(x_h + (j0 + j) * x_ld + d0 + dd)
                     : zero);
        }
        // W^T [kT][kT]: row j, columns i .. i + 3
        for (int e = tid; e < kT * kT / 4; e += kThreads) {
          const int j = e >> 4, i = 4 * (e & 15);
          const int gi = i0 + i, gj = j0 + j;
          float w[4] = {0.f, 0.f, 0.f, 0.f};
          if (j < tj && i < ti && gj <= gi + 3) {
            const float4 sv = load4(scores + (long long)gj * ld + gi);
            const float sc[4] = {sv.x, sv.y, sv.z, sv.w};
            const float cj = cum[gj], dtj = s_dt[gj];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (i + c < ti && gj <= gi + c) {
                w[c] = sc[c] * expf(cum[gi + c] - cj) * dtj;
              }
            }
          }
          store4(&s_wt[j * kT + i], make_float4(w[0], w[1], w[2], w[3]));
        }
        __syncthreads();
#pragma unroll 8
        for (int j = 0; j < kT; ++j) {
          const float4 wv = *reinterpret_cast<const float4*>(&s_wt[j * kT + 4 * ty]);
          const float4 xv = *reinterpret_cast<const float4*>(&s_x[j * kHd + 4 * tx]);
          const float ws[4] = {wv.x, wv.y, wv.z, wv.w};
          const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ws[r], xs[c], acc[r][c]);
        }
      }
      const int dd = d0 + 4 * tx;
      if (dd < hd) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * ty + r;
          if (i < ti) {
            store4(y_h + (i0 + i) * x_ld + dd,
                   make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
          }
        }
      }
    }
  }

  // ---- the chunk's end state: rows d0 + 4 ty + r, columns
  // n0 + 4 tx + c and n0 + 64 + 4 tx + c
  float* out = p.states +
               (((long long)b * nc + chunk_id) * p.nh + h) * (long long)hd * N;
  for (int d0 = 0; d0 < hd; d0 += kHd) {
    for (int n0 = 0; n0 < N; n0 += kN) {
      float acc[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
      for (int j0 = 0; j0 < L; j0 += kT) {
        const int tj = min(kT, L - j0);
        __syncthreads();
        for (int e = tid; e < kT * kHd / 4; e += kThreads) {
          const int j = e >> 4, dd = 4 * (e & 15);
          float4 v = zero;
          if (j < tj && d0 + dd < hd) {
            v = load4(x_h + (j0 + j) * x_ld + d0 + dd);
            const float f = s_fac[j0 + j];
            v = make_float4(v.x * f, v.y * f, v.z * f, v.w * f);
          }
          store4(&s_xw[j * kHd + dd], v);
        }
        // B [kT][kN]: thread e takes row e / 32, columns 4 (e % 32) ..
        for (int e = tid; e < kT * kN / 4; e += kThreads) {
          const int j = e >> 5, nn = 4 * (e & 31);
          store4(&s_b[j * kN + nn],
                 (j < tj && n0 + nn < N)
                     ? load4(b_c + (long long)(j0 + j) * N + n0 + nn)
                     : zero);
        }
        __syncthreads();
#pragma unroll 8
        for (int j = 0; j < kT; ++j) {
          const float4 xv = *reinterpret_cast<const float4*>(&s_xw[j * kHd + 4 * ty]);
          const float4 b0 = *reinterpret_cast<const float4*>(&s_b[j * kN + 4 * tx]);
          const float4 b1 = *reinterpret_cast<const float4*>(&s_b[j * kN + 64 + 4 * tx]);
          const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
          const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(xs[r], bs[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int dd = d0 + 4 * ty + r;
        if (dd >= hd) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nn = n0 + 64 * half + 4 * tx;
          if (nn < N) {
            store4(out + (long long)dd * N + nn,
                   make_float4(acc[r][4 * half], acc[r][4 * half + 1],
                               acc[r][4 * half + 2], acc[r][4 * half + 3]));
          }
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_scores(const Params& p, cudaStream_t stream) {
  const int nt = (p.chunk + kT - 1) / kT;
  const dim3 grid(nt * (nt + 1) / 2, p.seq / p.chunk, p.batch);
  ssd_scores_kernel<T><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const Params& p, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(p.chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.nh, p.seq / p.chunk, p.batch);
  ssd_chunk_kernel<T><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// the (b, chunk) grid and the rows of B and C both passes read
bool valid(int batch, int seq, int n, int chunk) {
  return batch > 0 && seq > 0 && n > 0 && n % 4 == 0 && chunk > 0 &&
         seq % chunk == 0 && seq / chunk <= 65535 && batch <= 65535;
}

Params make_params(const void* x, const void* dt, const void* a_log,
                   const void* b, const void* c, void* y, float* states,
                   float* scores, int batch, int seq, int nh, int hd, int n,
                   int chunk) {
  Params p;
  p.x = x;
  p.dt = dt;
  p.a_log = a_log;
  p.b = b;
  p.c = c;
  p.y = y;
  p.states = states;
  p.scores = scores;
  p.batch = batch;
  p.seq = seq;
  p.nh = nh;
  p.hd = hd;
  p.n = n;
  p.chunk = chunk;
  return p;
}

}  // namespace

extern "C" {

// Pass 1: scores [B, nc, L, ld] f32 (ld = L rounded up to a multiple of
// 4, `ssd_scores_ld`) from b, c [B, S, N].  Returns a
// cudaError_t code (0 on success); 1 (cudaErrorInvalidValue) for
// arguments the kernel does not take.
int ssd_scores_launch(const void* b, const void* c, float* scores, int dtype,
                      int batch, int seq, int n, int chunk, void* stream) {
  if (!valid(batch, seq, n, chunk)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(nullptr, nullptr, nullptr, b, c, nullptr,
                               nullptr, scores, batch, seq, 1, 1, n, chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return (int)launch_scores<float>(p, s);
  if (dtype == kBF16) return (int)launch_scores<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}

// Pass 2: y_diag and states from x, dt, a_log, b and pass 1's scores.
int ssd_chunk_launch(const void* x, const void* dt, const void* a_log,
                     const void* b, const void* c, void* y, float* states,
                     const float* scores, int dtype, int batch, int seq,
                     int nh, int hd, int n, int chunk, void* stream) {
  if (!valid(batch, seq, n, chunk) || nh <= 0 || nh > 65535 || hd <= 0 ||
      hd % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p = make_params(x, dt, a_log, b, c, y, states,
                               const_cast<float*>(scores), batch, seq, nh, hd,
                               n, chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return (int)launch_typed<float>(p, s);
  if (dtype == kBF16) return (int)launch_typed<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}

int ssd_scores_ld(int chunk) { return scores_ld(chunk); }

long long ssd_chunk_smem_bytes(int chunk) {
  return (long long)(sizeof(float) * smem_floats(chunk));
}

const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

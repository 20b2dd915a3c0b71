// FlashAttention-2 forward, hand-written for Hopper (sm_90a).
//
//   out[b, h, i, :] = sum_j softmax_j(mask(cap(scale * q_i . k_j))) v_j
//
// with GQA (kv head = h / (H / Hkv)), causal and sliding-window masks,
// the gemma2 logit soft-cap, and ragged Sq / Sk masked in the kernel.
// Replaces the Pallas TPU kernel `flash_attention_tpu`
// (src/repro/kernels/flash_attention.py:93, body `_flash_fwd_kernel`
// :39-90), which walks a (B, H, nq, nk) grid with the kv axis innermost
// and carries (m, l, acc) across it in VMEM.  Blocks on the H100 run in
// no order, so here one block owns a (b, h, 64-row query tile) and loops
// over the kv tiles itself, keeping (m, l, acc) in registers.
//
// Order of operations as in the TPU kernel and `ref.mha_reference`:
// scale, then soft-cap, then mask; f32 online softmax and accumulation;
// `l_safe = max(l, 1e-30)`; the output in q's dtype.  Masked logits
// contribute exactly 0 (selected, not exp(NEG_INF - m)), and kv tiles
// that the causal or window mask empties entirely are skipped, so the
// finite NEG_INF = -2e38 never enters a row's sum.  A row with no visible
// key at all (possible only when Sq > Sk + window) returns 0.
//
// What bounds it on the card: operations.  At the serving point (B = 2,
// H = 32, Hkv = 16, S = 4352, D = 128, bf16, causal) QK^T + PV is about
// 310 GFLOP, 0.31 ms at the bf16 tensor-core peak of 989 TFLOP/s, against
// about 0.064 ms for the 214 MB of q, k, v and out at 3.35 TB/s.  This
// first version computes in f32 on the CUDA cores (exact bf16 -> f32
// products, as the plain version does; f32 inputs keep their full
// precision), so its own ceiling is the 67 TFLOP/s f32 rate: it is a
// correct baseline, and a tensor-core (wgmma) version is later work.
// Its design against that ceiling:
//   * 64 x 64 tiles, 256 threads; each thread owns 4 query rows and holds
//     a 4 x 4 block of scores and a 4 x (D/16) block of the output in
//     registers, so every shared-memory load feeds several FMAs;
//   * q, k, v tiles are converted to f32 once, into shared memory (K rows
//     padded by one word so the column reads hit distinct banks); the
//     working set is (3 * 64 * D + 64 * 64) words: 113 KB at D = 128,
//     209 KB at D = 256 (dynamic shared memory);
//   * row max and row sum reduce across the 16 lanes of a row with warp
//     shuffles; the query tiles run latest-first so the long causal rows
//     start early.
//
// Plain C interface (no PyTorch headers, so the build takes seconds); the
// Python wrapper (repro_torch/kernels/flash_attention.py) validates the
// inputs, passes raw pointers, element strides and the current stream,
// and raises on any non-zero return code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kMaxD = 256;
constexpr float kNegInf = -2.0e38f;

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
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int batch, heads, kv_heads, sq, sk, d;
  // element strides of the (batch, head, sequence) axes; the head_dim
  // axis is contiguous
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale, softcap;
  int causal, window;
};

__host__ __device__ inline size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)kBQ * (d + 1) + (size_t)kBK * (d + 1) +
                          (size_t)kBK * d + (size_t)kBQ * (kBK + 1));
}

// MAXJ: the largest D / 16 this instantiation serves (4, 8 or 16).
template <typename T, int MAXJ>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int d_head = p.d;
  const int ld = d_head + 1;
  float* s_q = smem;                   // [kBQ][D + 1]
  float* s_k = s_q + kBQ * ld;         // [kBK][D + 1]
  float* s_v = s_k + kBK * ld;         // [kBK][D]
  float* s_p = s_v + kBK * d_head;     // [kBQ][kBK + 1]

  const int n_qt = (p.sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column lane within a row group
  const int ty = tid >> 4;   // row group: rows 4 * ty .. 4 * ty + 3
  const int nj = d_head / 16;

  const T* q_base = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k_base = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v_base = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* o_base = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBQ * d_head; i += kThreads) {
    const int r = i / d_head;
    const int c = i - r * d_head;
    const int s = q0 + r;
    s_q[r * ld + c] = s < p.sq ? to_f32(q_base[s * p.q_ss + c]) : 0.f;
  }

  // kv range that any row of this tile can see
  const int q_last = min(q0 + kBQ, p.sq) - 1;
  int k_hi = p.sk;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);

  float m[4], l[4], acc[4][MAXJ];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc[a][j] = 0.f;
  }

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's s_k / s_v / s_p reads are done
    for (int i = tid; i < kBK * d_head; i += kThreads) {
      const int r = i / d_head;
      const int c = i - r * d_head;
      const int s = k0 + r;
      const bool in = s < p.sk;
      s_k[r * ld + c] = in ? to_f32(k_base[s * p.k_ss + c]) : 0.f;
      s_v[r * d_head + c] = in ? to_f32(v_base[s * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[a][c] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < d_head; ++dd) {
      float qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = s_q[(ty * 4 + a) * ld + dd];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = s_k[(tx + 16 * c) * ld + dd];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[a][c] = fmaf(qa[a], kc[c], sc[a][c]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + ty * 4 + a;
      float row_max = kNegInf;
      bool ok[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        float x = sc[a][c] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool vis = kpos < p.sk;
        if (p.causal) vis = vis && kpos <= qpos;
        if (p.window > 0) vis = vis && kpos > qpos - p.window;
        ok[c] = vis;
        sc[a][c] = vis ? x : kNegInf;
        row_max = fmaxf(row_max, sc[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[a], row_max);
      const float alpha = expf(m[a] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pv = ok[c] ? expf(sc[a][c] - m_new) : 0.f;
        s_p[(ty * 4 + a) * (kBK + 1) + tx + 16 * c] = pv;
        row_sum += pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[a] = alpha * l[a] + row_sum;
      m[a] = m_new;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) acc[a][j] *= alpha;
    }
    __syncwarp();  // a row's P is written and read by the same 16 lanes

#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = s_p[(ty * 4 + a) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        if (j < nj) {
          const float vv = s_v[c * d_head + tx + 16 * j];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][j] = fmaf(pa[a], vv, acc[a][j]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qpos = q0 + ty * 4 + a;
    if (qpos >= p.sq) continue;
    const float l_safe = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      if (j < nj) {
        o_base[qpos * p.o_ss + tx + 16 * j] = from_f32<T>(acc[a][j] / l_safe);
      }
    }
  }
}

template <typename T, int MAXJ>
cudaError_t launch_typed(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p.d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, MAXJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.heads, p.batch);
  flash_fwd_kernel<T, MAXJ><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const Params& p, cudaStream_t stream) {
  const int nj = p.d / 16;
  if (nj <= 4) return launch_typed<T, 4>(p, stream);
  if (nj <= 8) return launch_typed<T, 8>(p, stream);
  return launch_typed<T, 16>(p, stream);
}

}  // namespace

extern "C" {

// strides: q (b, h, s), k (b, h, s), v (b, h, s), out (b, h, s), in
// elements.  Returns a cudaError_t code (0 on success); 1
// (cudaErrorInvalidValue) for arguments the kernel does not take.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int dtype, int batch, int heads,
                           int kv_heads, int sq, int sk, int d,
                           const long long* strides, float scale,
                           float softcap, int causal, int window,
                           void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      sq <= 0 || sk <= 0 || d <= 0 || d % 16 != 0 || d > kMaxD ||
      batch > 65535 || heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.batch = batch;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.q_ss = strides[2];
  p.k_sb = strides[3];
  p.k_sh = strides[4];
  p.k_ss = strides[5];
  p.v_sb = strides[6];
  p.v_sh = strides[7];
  p.v_ss = strides[8];
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.scale = scale;
  p.softcap = softcap;
  p.causal = causal;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return (int)launch_dim<float>(p, s);
  if (dtype == kBF16) return (int)launch_dim<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}

long long flash_attention_smem_bytes(int d) { return (long long)smem_bytes(d); }

int flash_attention_max_d() { return kMaxD; }

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

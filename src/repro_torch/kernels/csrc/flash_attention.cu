// FlashAttention forward, hand-written for Hopper (sm_90a).
//
//   out[b, h, i, :] = sum_j softmax_j(mask(cap(scale * q_i . k_j))) v_j
//
// with GQA (kv head = h / (H / Hkv)), causal and sliding-window masks,
// the gemma2 logit soft-cap, and ragged Sq / Sk masked in the kernel.
// Replaces the Pallas TPU kernel `flash_attention_tpu`
// (src/repro/kernels/flash_attention.py:93, body `_flash_fwd_kernel`
// :39-90), which walks a (B, H, nq, nk) grid with the kv axis innermost
// and carries (m, l, acc) across it in VMEM.  Blocks on the H100 run in
// no order, so here a block owns a query tile of one (b, h) and loops
// over the kv tiles itself, keeping (m, l, acc) in registers.
//
// Order of operations as in the TPU kernel and `ref.mha_reference`:
// scale, then soft-cap, then mask; f32 online softmax and accumulation;
// `l_safe = max(l, 1e-30)`; the output in q's dtype.  Masked logits
// contribute exactly 0 (selected, never exp(NEG_INF - m)), and kv tiles
// that the causal or window mask empties entirely are skipped.  A row
// with no visible key at all (possible only when Sq > Sk + window)
// returns 0.
//
// What bounds it on the card: operations.  At the serving point (B = 2,
// H = 32, Hkv = 16, S = 4352, D = 128, bf16, causal) QK^T + PV over the
// visible pairs is 310 GFLOP, 0.31 ms at the bf16 tensor-core peak of
// 989 TFLOP/s, against 0.064 ms for the 214 MB of q, k, v and out at
// 3.35 TB/s.  A second floor sits beside it: each of the 606 M visible
// (query, key) pairs needs one exp2 and, with the soft-cap, one tanh on
// the special-function units (16 per SM per clock), about 0.29 ms.
//
// Two paths, chosen by dtype in `flash_attention_launch`:
//
// * bf16 (`flash_fwd_bf16_kernel`, the serving path), on the tensor
//   cores.  A block of two warpgroups owns 128 consecutive query rows of
//   one (b, h); each warpgroup owns 64 of them.  Q and a ring of two K
//   and two V tiles (128 rows at D <= 128, 64 at D = 256) stay in bf16
//   in shared memory in the 128-byte-swizzled layout that `wgmma`
//   descriptors read, filled by `cp.async` one step ahead; columns
//   beyond D (D padded to 64, 128 or 256) are zero-filled and add
//   nothing.  S = Q K^T is `wgmma m64nNk16` with both operands from
//   shared memory.  Each warpgroup pipelines its steps: it issues S_u
//   and then O += P_{u-1} V_{u-1}, waits for S_u alone, and runs the
//   softmax of S_u while the tensor cores finish the P V product.  The
//   softmax runs on the accumulator fragment: the row max of
//   t = tanh.approx(scale * acc / cap) (or of acc without a cap) over
//   the 4 lanes of a quad, p = ex2.approx(k t - m) as one FFMA and one
//   MUFU op (k = cap * log2(e), or scale * log2(e)); the mask is tested
//   only on tiles that cross the causal diagonal, the window edge or Sk.
//   P is rounded to bf16 pairs in registers and is the register A
//   operand of `wgmma m64nDk16`, with V read transposed from shared
//   memory; O stays f32 in registers.  The new roundings against the f32
//   path are P in bf16 (relative 2^-9 per weight) and the approximate
//   tanh (relative about 2^-11).  Shared memory: 32 KB of Q and 128 KB of
//   K/V at D = 128; 255 registers a thread, one block per SM.
// * f32 (`flash_fwd_kernel`, the first version, unchanged), full f32
//   arithmetic on the CUDA cores, the path the f32 card-against-CPU
//   checks run: 64 x 64 tiles,
//   256 threads, each thread owns 4 query rows with a 4 x 4 block of
//   scores and a 4 x (D/16) block of the output in registers; q, k, v in
//   f32 in shared memory (113 KB at D = 128).
//
// An optional second output, `lse` (f32 [B, H, Sq], contiguous), is the
// row's log-sum-exp in natural log, `m + log(max(l, 1e-30))` with m the
// row's largest visible logit: what the JAX package's `_forward`
// (src/repro/models/flash.py:95) returns beside `out`, and what the
// training backward (repro_torch/models/flash.py) recomputes P from.
// Both paths write it in their epilogue when its pointer is not null:
// the f32 path from lane 0 of each row's 16 lanes, the bf16 path from
// lane 0 of each quad after the quad reduction of l (its m is base-2, so
// lse = m ln 2 + log(l)).  The write is a template parameter: serving
// passes null and runs the instantiations without it, the code it ran
// before the output existed (tested at run time instead, the write
// slowed the D = 128 serving kernel on an H100), and nothing else of the
// kernel depends on it, so `out` is the same with or without lse.
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
constexpr int kMaxD = 256;  // D / 16 <= 16: the f32 kernel's largest MAXJ
constexpr float kNegInf = -2.0e38f;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, Sq] f32, or null: not written
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

// MAXJ: the largest D / 16 this instantiation serves (4, 8 or 16); LSE:
// whether it writes p.lse.
template <typename T, int MAXJ, bool LSE>
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
    // m and l are the same in the row's 16 lanes (reduced above)
    if (LSE && tx == 0) {
      p.lse[((long long)b * p.heads + h) * p.sq + qpos] = m[a] + logf(l_safe);
    }
  }
}

template <typename T, int MAXJ, bool LSE>
cudaError_t launch_typed(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p.d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, MAXJ, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.heads, p.batch);
  flash_fwd_kernel<T, MAXJ, LSE><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool LSE>
cudaError_t launch_f32_lse(const Params& p, cudaStream_t stream) {
  const int nj = p.d / 16;
  if (nj <= 4) return launch_typed<float, 4, LSE>(p, stream);
  if (nj <= 8) return launch_typed<float, 8, LSE>(p, stream);
  return launch_typed<float, 16, LSE>(p, stream);
}

cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  return p.lse != nullptr ? launch_f32_lse<true>(p, stream)
                          : launch_f32_lse<false>(p, stream);
}

// ---------------------------------------------------------------------------
// bf16 path: wgmma on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBQ2 = 128;      // query rows per block (two warpgroups)
constexpr float kLog2e = 1.4426950408889634f;

// The padded head dim (64, 128 or 256) and the kv rows per tile come
// from the wrapper (`kernel_path` in kernels/flash_attention.py decides
// them); `launch_bf16` runs the instantiation that matches the pair.

constexpr size_t bf16_smem_bytes(int d_pad, int kv_tile) {
  // Q, two stages of K and V, and 1 KB to align the base to the
  // 1024-byte period of the swizzle
  return (size_t)2 * d_pad * (kBQ2 + 4 * kv_tile) + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Byte offset of the 16-byte chunk `c` (bf16 columns 8c .. 8c + 7) of row
// `r` in a tile of `rows` rows stored as [D_pad / 64][rows][64] bf16 with
// the 128-byte swizzle: chunk c & 7 of a 128-byte row sits at slot
// (c & 7) ^ (r & 7).  wgmma's SWIZZLE_128B descriptors read this layout.
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (uint32_t)((c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// wgmma shared-memory matrix descriptor with the 128-byte swizzle:
// start address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros (rows past S, columns past D)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// make this thread's generic-proxy writes to shared memory visible to the
// async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// registers that an asynchronous wgmma reads or writes: no use of them
// may move across this point (place it after the wait that completes it)
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory
// (K-major, 128-byte swizzle), f32 accumulators in registers.
__device__ __forceinline__ void mma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B from shared memory
// (K-major, 128-byte swizzle), f32 accumulators in registers.
__device__ __forceinline__ void mma_ss_m64n128k16(float (&d)[64], uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (bf16 pairs),
// B from shared memory stored N-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void mma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A from registers (bf16 pairs),
// B from shared memory stored N-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void mma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] * B[16 x 256], A from registers (bf16 pairs),
// B from shared memory stored N-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void mma_rs_m64n256k16(float (&d)[128], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int BKV>
__device__ __forceinline__ void mma_s(float (&s)[BKV / 2], uint64_t da,
                                      uint64_t db, int accumulate);
template <>
__device__ __forceinline__ void mma_s<64>(float (&s)[32], uint64_t da,
                                          uint64_t db, int accumulate) {
  mma_ss_m64n64k16(s, da, db, accumulate);
}
template <>
__device__ __forceinline__ void mma_s<128>(float (&s)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  mma_ss_m64n128k16(s, da, db, accumulate);
}

template <int DP>
__device__ __forceinline__ void mma_pv(float (&o)[DP / 2],
                                       const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void mma_pv<64>(float (&o)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  mma_rs_m64n64k16(o, a, db);
}
template <>
__device__ __forceinline__ void mma_pv<128>(float (&o)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  mma_rs_m64n128k16(o, a, db);
}
template <>
__device__ __forceinline__ void mma_pv<256>(float (&o)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  mma_rs_m64n256k16(o, a, db);
}

// cp.async ROWS rows (sequence positions s0 ..) of a [seq, d] bf16 matrix
// with row stride `ss` into a swizzled [DP / 64][ROWS][64] tile.  Thread
// tid copies chunk tid % (DP / 8) of rows tid / (DP / 8) + k * R, R a
// multiple of 8, so its swizzled slot is the same in every row it copies.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          long long ss, int s0, int seq,
                                          int d, int tid) {
  constexpr int kChunks = DP / 8;
  constexpr int kR = kThreads / kChunks;     // rows per pass: 32, 16 or 8
  const int c = tid % kChunks;
  const int r0 = tid / kChunks;
  const bool col_ok = c * 8 < d;
  const __nv_bfloat16* src = base + (long long)(s0 + r0) * ss + c * 8;
  const uint32_t slot = dst + swz(r0, c, ROWS);
#pragma unroll
  for (int i = 0; i < ROWS / kR; ++i) {
    const bool ok = col_ok && s0 + r0 + i * kR < seq;
    cp_async16(slot + i * kR * 128, ok ? src : base, ok);
    src += kR * ss;
  }
}

// S = Q K^T for this warpgroup's 64 rows against one kv tile (issued,
// committed, not waited)
template <int DP, int BKV>
__device__ __forceinline__ void issue_s(float (&s)[BKV / 2], uint32_t s_q,
                                        uint32_t s_k, int wg) {
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
  pin(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    const uint64_t da = sw128_desc(
        s_q + (kk >> 2) * (kBQ2 * 128) + wg * (64 * 128) + off, 16, 1024);
    const uint64_t db =
        sw128_desc(s_k + (kk >> 2) * (BKV * 128) + off, 16, 1024);
    mma_s<BKV>(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P V for one kv tile, P the bf16 register fragment (issued,
// committed, not waited)
template <int DP, int BKV>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&pa)[BKV / 4],
                                         uint32_t s_v) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                           pa[4 * kk + 3]};
    const uint64_t db = sw128_desc(s_v + kk * (16 * 128), BKV * 128, 1024);
    mma_pv<DP>(o, a, db);
  }
  wgmma_commit();
}

// DP: padded head dim; BKV: kv rows per tile; LSE: whether it writes
// p.lse (serving runs the instantiation without, so its code is the same
// as before the output existed).
//
// Software pipeline within each warpgroup: in step u the warpgroup issues
// S_u = Q K_u^T and then O += P_{u-1} V_{u-1}; it waits for S_u only,
// runs the softmax of S_u while the tensor cores work on P_{u-1} V_{u-1},
// then waits for that, rescales O and keeps P_u in registers for step
// u + 1.  So K_u and V_{u-1} are read in step u: the ring holds two K and
// two V tiles, and at the top of step u (after a barrier, when step u - 1
// is done everywhere) the block starts copying K_{u+1} and V_u.
template <int DP, int BKV, bool LSE>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16_kernel(Params p) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t kTile = BKV * DP * 2;        // bytes of one K or V tile
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_k0 = s_q + kBQ2 * DP * 2;      // K slots 0, 1
  const uint32_t s_v0 = s_k0 + 2 * kTile;          // V slots 0, 1

  // blockIdx.y walks the query tiles latest-first, so the longest causal
  // rows of every (b, h) are dispatched before any short one
  const int n_qt = (p.sq + kBQ2 - 1) / kBQ2;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kBQ2;
  const int h = (int)blockIdx.x % p.heads;
  const int b = (int)blockIdx.x / p.heads;
  const int hk = h / (p.heads / p.kv_heads);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;                // warpgroup: query rows 64 wg ..
  const int lane = tid & 31;
  const int quad = lane & 3;
  // this thread's two rows of the accumulator fragment
  const int rmin = q0 + 64 * wg;
  const int row0 = rmin + 16 * ((tid & 127) >> 5) + (lane >> 2);
  const int row1 = row0 + 8;
  const int rmax = min(rmin + 63, p.sq - 1);

  const __nv_bfloat16* q_base =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k_base =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* v_base =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  __nv_bfloat16* o_base =
      static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  // kv tiles that any row of the block can see
  const int q_last = min(q0 + kBQ2, p.sq) - 1;
  int k_hi = p.sk;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int t_lo = k_lo / BKV;
  const int n_t = max((k_hi + BKV - 1) / BKV - t_lo, 0);

  load_tile<DP, kBQ2>(s_q, q_base, p.q_ss, q0, p.sq, p.d, tid);
  if (n_t > 0) {
    load_tile<DP, BKV>(s_k0, k_base, p.k_ss, t_lo * BKV, p.sk, p.d, tid);
  }
  cp_async_commit();

  // The base-2 logit of a pair is k t: under the soft-cap
  // t = tanh(acc * scale / cap) and k = cap * log2(e); without it t = acc
  // and k = scale * log2(e) (for a scale <= 0, t = acc * scale * log2(e)
  // and k = 1).  k > 0, so the row max is taken on t, and
  // p = exp2(k t - m) is one FFMA and one ex2 per element.
  const bool capped = p.softcap > 0.f;
  const bool raw = !capped && p.scale > 0.f;
  const float mul = capped ? p.scale / p.softcap : p.scale * kLog2e;
  const float kexp = capped ? p.softcap * kLog2e : (raw ? mul : 1.f);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  uint32_t pa[BKV / 4];        // P of the previous step, bf16 pairs
  bool have_p = false;         // this warpgroup owes O += P V for step u - 1
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int u = 0; u < n_t; ++u) {
    const int it = t_lo + u;
    cp_async_wait_all();     // K_u and V_{u-1} arrived
    fence_proxy_async();
    __syncthreads();         // and step u - 1 is done in both warpgroups
    if (u + 1 < n_t) {
      load_tile<DP, BKV>(s_k0 + ((u + 1) & 1) * kTile, k_base, p.k_ss,
                         (it + 1) * BKV, p.sk, p.d, tid);
    }
    load_tile<DP, BKV>(s_v0 + (u & 1) * kTile, v_base, p.v_ss, it * BKV,
                       p.sk, p.d, tid);
    cp_async_commit();

    const int c0 = it * BKV;
    const int cmax = min(c0 + BKV, p.sk) - 1;
    // per warpgroup: 0 skip (nothing visible), 1 all visible, 2 mask
    int mode = 2;
    if (rmin >= p.sq || (p.causal && c0 > rmax) ||
        (p.window > 0 && cmax <= rmin - p.window)) {
      mode = 0;
    } else if (c0 + BKV <= p.sk && (!p.causal || c0 + BKV - 1 <= rmin) &&
               (p.window <= 0 || c0 > rmax - p.window)) {
      mode = 1;
    }

    float s[BKV / 2];
    if (mode != 0) issue_s<DP, BKV>(s, s_q, s_k0 + (u & 1) * kTile, wg);
    if (have_p) issue_pv<DP, BKV>(o, pa, s_v0 + ((u - 1) & 1) * kTile);
    if (mode == 0) {
      if (have_p) {
        wgmma_wait<0>();
        pin(o);
        pin(pa);
      }
      have_p = false;
      continue;
    }
    if (have_p) {
      wgmma_wait<1>();       // S_u is done; P_{u-1} V_{u-1} may still run
    } else {
      wgmma_wait<0>();
    }
    pin(s);

    // s[4j + 2r + e]: row (r ? row1 : row0), column c0 + 8j + 2 quad + e
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      float x = s[i];
      if (capped) {
        x = tanh_approx(x * mul);
      } else if (!raw) {
        x *= mul;
      }
      if (mode == 2) {
        const int col = c0 + 8 * (i >> 2) + 2 * quad + (i & 1);
        const int row = (i & 2) ? row1 : row0;
        bool vis = col < p.sk;
        if (p.causal) vis = vis && col <= row;
        if (p.window > 0) vis = vis && col > row - p.window;
        if (!vis) x = -INFINITY;
      }
      s[i] = x;
      if (i & 2) {
        mx1 = fmaxf(mx1, x);
      } else {
        mx0 = fmaxf(mx0, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, kexp * mx0), mn1 = fmaxf(m1, kexp * mx1);
    // a row that has seen no visible key yet keeps m = -inf; subtract 0
    // then, so that exp2(-inf - m) stays 0 and never NaN
    const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
    const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = exp2_approx(m0 - ms0);
    const float alpha1 = exp2_approx(m1 - ms1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const float pv = exp2_approx(fmaf(s[i], kexp, (i & 2) ? -ms1 : -ms0));
      s[i] = pv;
      if (i & 2) {
        sum1 += pv;
      } else {
        sum0 += pv;
      }
    }
    // per-thread partial row sums; the quad's lanes are summed at the end
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;

    if (have_p) {
      wgmma_wait<0>();       // P_{u-1} V_{u-1} is in O
      pin(o);
      pin(pa);
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j + 0] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
    // the accumulator fragment of S columns 16kk .. 16kk + 15 is the
    // register A fragment of k-step kk of the next P V
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      pa[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    have_p = true;
  }

  // the last step's O += P V: its V tile was copied by every thread
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();
  if (have_p) {
    issue_pv<DP, BKV>(o, pa, s_v0 + ((n_t - 1) & 1) * kTile);
    wgmma_wait<0>();
    pin(o);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  // m is the base-2 logit (k t), the same in the quad's 4 lanes
  if (LSE && quad == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
    float* lse_row = p.lse + ((long long)b * p.heads + h) * p.sq;
    if (row0 < p.sq) lse_row[row0] = m0 * kLn2 + logf(fmaxf(l0, 1e-30f));
    if (row1 < p.sq) lse_row[row1] = m1 * kLn2 + logf(fmaxf(l1, 1e-30f));
  }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * quad;
    if (col < p.d) {
      if (row0 < p.sq) {
        *reinterpret_cast<uint32_t*>(o_base + row0 * p.o_ss + col) =
            pack_bf16(o[4 * j + 0] * inv0, o[4 * j + 1] * inv0);
      }
      if (row1 < p.sq) {
        *reinterpret_cast<uint32_t*>(o_base + row1 * p.o_ss + col) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
    }
  }
}

template <int DP, int BKV, bool LSE>
cudaError_t launch_bf16_lse(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = bf16_smem_bytes(DP, BKV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<DP, BKV, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.batch * p.heads, (p.sq + kBQ2 - 1) / kBQ2);
  flash_fwd_bf16_kernel<DP, BKV, LSE><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int DP, int BKV>
cudaError_t launch_bf16_dim(const Params& p, cudaStream_t stream) {
  return p.lse != nullptr ? launch_bf16_lse<DP, BKV, true>(p, stream)
                          : launch_bf16_lse<DP, BKV, false>(p, stream);
}

cudaError_t launch_bf16(const Params& p, int d_pad, int kv_tile,
                        cudaStream_t stream) {
  // cp.async copies 16 bytes: the base pointers and every row stride
  // must keep 16-byte alignment
  const uintptr_t ptrs = (uintptr_t)p.q | (uintptr_t)p.k | (uintptr_t)p.v |
                         (uintptr_t)p.o;
  const long long strides = p.q_sb | p.q_sh | p.q_ss | p.k_sb | p.k_sh |
                            p.k_ss | p.v_sb | p.v_sh | p.v_ss | p.o_sb |
                            p.o_sh | p.o_ss;
  if ((ptrs & 15) != 0 || (strides & 7) != 0 ||
      (long long)p.sq > 65535LL * kBQ2 || p.d > d_pad) {
    return cudaErrorInvalidValue;
  }
  // the instantiations: kv tiles of 128 where the registers allow it
  // (the S and O accumulators take 64 + 64 floats a thread at D = 128)
  if (d_pad == 64 && kv_tile == 128) {
    return launch_bf16_dim<64, 128>(p, stream);
  }
  if (d_pad == 128 && kv_tile == 128) {
    return launch_bf16_dim<128, 128>(p, stream);
  }
  if (d_pad == 256 && kv_tile == 64) {
    return launch_bf16_dim<256, 64>(p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// strides: q (b, h, s), k (b, h, s), v (b, h, s), out (b, h, s), in
// elements.  lse: a contiguous f32 [batch, heads, sq] buffer, or null
// (serving: no lse).  d_pad, kv_tile: the head dim the kernel computes
// with and its kv rows per tile (d and 64 for f32).  Returns a
// cudaError_t code (0 on success); 1 (cudaErrorInvalidValue) for
// arguments the kernel does not take.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, void* lse, int dtype, int batch,
                           int heads, int kv_heads, int sq, int sk, int d,
                           int d_pad, int kv_tile, const long long* strides,
                           float scale, float softcap, int causal,
                           int window, void* stream) {
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
  p.lse = static_cast<float*>(lse);
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
  if (dtype == kF32 && d_pad == d && kv_tile == kBK) {
    return (int)launch_f32(p, s);
  }
  if (dtype == kBF16) return (int)launch_bf16(p, d_pad, kv_tile, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

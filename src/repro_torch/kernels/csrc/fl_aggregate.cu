// eq.-(4) aggregation over the model's leaves, hand-written for Hopper
// (sm_90a).  For every segment i of a launch (a leaf, or one lane's copy
// of a leaf) with coefficient row r_i of a row-major [R, K] table:
//
//   out_i[n] = theta_i[n] + sum_k coeffs[r_i, k] * delta_i[k, n]  (fl_aggregate)
//   out_i[n] =              sum_k coeffs[r_i, k] * delta_i[k, n]  (fl_delta_reduce)
//
// A one-model call has R = 1 (every row 0); the scenario arena's call
// has one row per lane (R = S lanes, segment (s, leaf) on row s), so
// every lane's eq.-(4) step of a round is one launch.
// Replaces the Pallas TPU kernel `fl_aggregate_tpu`
// (src/repro/kernels/fl_aggregate.py, body `_aggregate_kernel`), which
// streams [K, 65536] tiles of the ravelled model through VMEM with the
// coefficients in scalar prefetch and zero-pads N up to the block.
//
// What bounds it on the card: bytes.  Each element costs K + 1 reads and
// one write (K + 2 words) against 2K flops, far below the H100's
// operations-per-byte balance, so the kernel is a streaming pass whose
// only job is to keep HBM busy.  Its design:
//   * One launch reads the leaves where they lie: the host passes a
//     segment table BY VALUE (a __grid_constant__ struct of at most
//     kMaxSegments leaves: theta, delta [K, size] and out pointers, the
//     size, the vector width and a prefix of tiles).  No ravel copy, no
//     table upload, no allocation and no host synchronisation, so a CUDA
//     graph can capture the call.  A model with more leaves, or leaves of
//     several dtype combinations, takes one launch per table.
//   * Each leaf streams with the widest vector (16, 8 or 4 bytes, or one
//     element) that its pointers and delta row starts allow; the host
//     picks it per leaf, so one small odd leaf no longer narrows the whole
//     model.  The n % VEC elements past the last full vector (only with
//     K = 1) are handled by the leaf's last tile.
//   * Work is cut into tiles of kThreads vectors (one per thread) that
//     never cross a leaf.  A block finds its tile's leaf by a binary search over the
//     table's tile prefix (uniform across the block, in the constant
//     bank).  The grid is min(tiles, resident blocks): one wave for a
//     model of a few hundred tiles, a persistent grid-stride walk beyond.
//   * Each segment carries its coefficient row.  A block keeps the row of
//     the segment it works on in shared memory and reloads it (two
//     barriers, K floats) only when its next tile lies on another row;
//     the row is uniform across the block, so the barriers are too.
//   * Loads in flight: a thread issues theta's load, then the delta rows in
//     batches of kBatch, each batch's loads before its FMAs; K is a
//     template bucket (<= 8, <= 16, or a loop of batches), the rows of a
//     batch are one running pointer apart (no address register per row),
//     and deltas and theta are read with ld.global.nc.L1::no_allocate.
//   * Registers decide the bytes in flight.  A launch is instantiated for
//     the widest vector in its table, so a table of narrow leaves does not
//     carry the registers of the 16-byte path, and a launch whose widest
//     delta vector is 4 bytes or less (a flat bf16 model with N % 4 != 0)
//     asks ptxas for kNarrowRegs registers, enough threads to keep HBM
//     busy.  The sweep that chose these values, and the ones it rejected
//     (two vectors per thread, 256 threads, all 8 rows in one batch, caps
//     on the 16-byte path), is in PERF.md.
//   * One order of arithmetic for every element, whatever its leaf,
//     vector or tile: the sum starts at 0, takes fmaf(coeff_k, delta_k,
//     acc) for k = 0..K-1 in order, adds theta, and rounds once to the
//     output type (theta's; f32 for the reduce).  So a leaf's result does
//     not depend on how the leaves are cut into launches, and the plain
//     ref.aggregate_leaves_fma_reference, which computes that order
//     exactly, is its bitwise reference.
//
// Plain C interface (no PyTorch headers, so the build takes seconds): the
// Python wrapper (repro_torch/kernels/fl_aggregate.py) validates devices,
// dtypes, shapes and contiguity, builds the table, passes it with the
// current stream, and raises on any non-zero return code; the launcher
// checks the table once more before it launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads per block, and vectors per tile
constexpr int kThreads = 128;
// dynamic shared memory for the coefficients stays under the 48 KB default
constexpr int kMaxK = 12288;
// segments per launch: 64 segments of 48 bytes keep the parameter block
// within the 4 KB that every CUDA version accepts (the row index fits in
// the padding after `vec`, so the lane form kept the size)
constexpr int kMaxSegments = 64;
// delta rows whose loads a thread issues together, per vector
constexpr int kBatch = 4;
// registers per thread that __launch_bounds__ asks of ptxas for a launch
// whose widest delta vector is 4 bytes or less
constexpr int kNarrowRegs = 40;

enum DType : int { kNone = -1, kF32 = 0, kBF16 = 1 };
// the columns of one row of the host's int64 segment table
enum Column : int {
  kTheta, kDelta, kOut, kSize, kVec, kTileEnd, kRow, kColumns
};

struct Segment {
  const void* theta;   // [size], nullptr for the reduce
  const void* delta;   // [K, size], row stride size
  void* out;           // [size]
  long long size;      // elements
  long long tile_end;  // tiles of this and every earlier segment
  int vec;             // elements per vector: 1, 2, 4 or 8
  int row;             // coefficient row: coeffs + row * K
};

struct Table {
  Segment seg[kMaxSegments];
  int count;
};

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

// Read-only streaming load of one vector, not allocated in L1.
template <int BYTES>
struct Stream;
template <>
struct Stream<16> {
  static __device__ __forceinline__ uint4 load(const void* p) {
    uint4 r;
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "l"(p));
    return r;
  }
};
template <>
struct Stream<8> {
  static __device__ __forceinline__ uint2 load(const void* p) {
    uint2 r;
    asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
        : "=r"(r.x), "=r"(r.y)
        : "l"(p));
    return r;
  }
};
template <>
struct Stream<4> {
  static __device__ __forceinline__ unsigned load(const void* p) {
    unsigned r;
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(r) : "l"(p));
    return r;
  }
};
template <>
struct Stream<2> {
  static __device__ __forceinline__ unsigned short load(const void* p) {
    unsigned short r;
    asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];" : "=h"(r) : "l"(p));
    return r;
  }
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  using Raw = decltype(Stream<sizeof(T) * V>::load(p));
  static_assert(sizeof(Raw) == sizeof(Pack<T, V>), "vector width");
  Pack<T, V> out;
  *reinterpret_cast<Raw*>(&out) = Stream<sizeof(T) * V>::load(p);
  return out;
}

__host__ __device__ constexpr int bucket_for(int k_count) {
  return k_count <= 8 ? 8 : (k_count <= 16 ? 16 : 0);
}

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
}

// The widest vector (in elements) a dtype combination can take.
template <typename TT, typename TD, typename TO, bool HAS_THETA>
__host__ __device__ constexpr int max_vec() {
  return (int)(16 / cmax(sizeof(TD),
                         cmax(sizeof(TO), HAS_THETA ? sizeof(TT) : 1)));
}

// Resident blocks per SM asked of ptxas.  A stream of 4-byte vectors or
// narrower needs many threads to keep enough bytes in flight, so its
// registers are capped; wider vectors keep theirs (capped, they spill).
template <typename TD, int VMAX>
__host__ __device__ constexpr int min_blocks() {
  return VMAX * sizeof(TD) <= 4
             ? 65536 / (kNarrowRegs * kThreads)
             : 1;
}

// One tile: vectors [tile * kThreads, (tile + 1) * kThreads) of a
// segment, one per thread; the segment's last tile also takes its scalar
// tail.  The K rows go in batches of kBatch: each batch's loads are issued
// before its FMAs, and theta's before the first batch.
template <typename TT, typename TD, typename TO, bool HAS_THETA, int KB,
          int VEC>
__device__ __forceinline__ void run_tile(const Segment& s, long long tile,
                                         bool last, const float* s_coeff,
                                         int k_count) {
  const TT* __restrict__ theta = static_cast<const TT*>(s.theta);
  const TD* __restrict__ delta = static_cast<const TD*>(s.delta);
  TO* __restrict__ out = static_cast<TO*>(s.out);
  const long long n = s.size;
  const long long n_vec = n / VEC;
  const long long v = tile * kThreads + threadIdx.x;
  const bool live = v < n_vec;
  const long long first = v * VEC;

  float acc[VEC];
  Pack<TT, VEC> t;
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
  if constexpr (HAS_THETA) {
    if (live) t = load_pack<TT, VEC>(theta + first);
  }
  const auto batch = [&](int k0) {
    Pack<TD, VEC> d[kBatch];
    const TD* row = delta + (long long)k0 * n + first;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (live && k0 + b < k_count) d[b] = load_pack<TD, VEC>(row);
      row += n;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (k0 + b < k_count) {
        const float c = s_coeff[k0 + b];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          acc[j] = fmaf(c, to_f32(d[b].v[j]), acc[j]);
        }
      }
    }
  };
  if constexpr (KB > 0) {
#pragma unroll
    for (int k0 = 0; k0 < KB; k0 += kBatch) batch(k0);
  } else {
#pragma unroll 1
    for (int k0 = 0; k0 < k_count; k0 += kBatch) batch(k0);
  }

  if (live) {
    Pack<TO, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if constexpr (HAS_THETA) {
        o.v[j] = from_f32<TO>(to_f32(t.v[j]) + acc[j]);
      } else {
        o.v[j] = from_f32<TO>(acc[j]);
      }
    }
    *reinterpret_cast<Pack<TO, VEC>*>(out + first) = o;
  }

  // scalar tail: the n % VEC elements past the last full vector
  if (last) {
    const long long idx = n_vec * VEC + threadIdx.x;
    if (idx < n) {
      float a = 0.0f;
      for (int k = 0; k < k_count; ++k) {
        a = fmaf(s_coeff[k], to_f32(delta[(long long)k * n + idx]), a);
      }
      if constexpr (HAS_THETA) a = to_f32(theta[idx]) + a;
      out[idx] = from_f32<TO>(a);
    }
  }
}

// TT: theta type (unused when !HAS_THETA), TD: delta type, TO: output
// type; KB: the K bucket (8, 16, or 0 for batches of kBatch); VMAX: the
// widest vector of the table, so a launch carries the registers of the
// widths it runs and no more (a 4-byte bf16 stream keeps its occupancy).
template <typename TT, typename TD, typename TO, bool HAS_THETA, int KB,
          int VMAX>
__global__ void __launch_bounds__(kThreads, min_blocks<TD, VMAX>())
    fl_aggregate_kernel(const __grid_constant__ Table table,
                        const float* __restrict__ coeffs, int k_count) {
  extern __shared__ float s_coeff[];
  int loaded = -1;  // the coefficient row in s_coeff

  const long long total = table.seg[table.count - 1].tile_end;
#pragma unroll 1
  for (long long tile = blockIdx.x; tile < total; tile += gridDim.x) {
    int lo = 0, hi = table.count - 1;
    while (lo < hi) {  // the first segment whose tile_end exceeds tile
      const int mid = (lo + hi) >> 1;
      if (table.seg[mid].tile_end > tile) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    const Segment& s = table.seg[lo];
    if (s.row != loaded) {  // uniform across the block
      __syncthreads();      // every thread is done with the old row
      const float* row = coeffs + (long long)s.row * k_count;
      for (int k = threadIdx.x; k < k_count; k += blockDim.x) {
        s_coeff[k] = row[k];
      }
      __syncthreads();
      loaded = s.row;
    }
    const long long local = tile - (lo == 0 ? 0 : table.seg[lo - 1].tile_end);
    const bool last = tile == s.tile_end - 1;
    switch (s.vec) {
      case 8:
        if constexpr (VMAX >= 8) {
          run_tile<TT, TD, TO, HAS_THETA, KB, 8>(s, local, last, s_coeff,
                                                 k_count);
        }
        break;
      case 4:
        if constexpr (VMAX >= 4) {
          run_tile<TT, TD, TO, HAS_THETA, KB, 4>(s, local, last, s_coeff,
                                                 k_count);
        }
        break;
      case 2:
        if constexpr (VMAX >= 2) {
          run_tile<TT, TD, TO, HAS_THETA, KB, 2>(s, local, last, s_coeff,
                                                 k_count);
        }
        break;
      default:
        run_tile<TT, TD, TO, HAS_THETA, KB, 1>(s, local, last, s_coeff,
                                               k_count);
        break;
    }
  }
}

bool aligned(const void* p, long long bytes) {
  return (reinterpret_cast<uintptr_t>(p) % (uintptr_t)bytes) == 0;
}

long long tiles_for(long long size, int vec, int tile_vectors) {
  const long long n_vec = size / vec;
  const long long tiles = (n_vec + tile_vectors - 1) / tile_vectors;
  return tiles > 0 ? tiles : 1;
}

// Copy the host's table into the by-value struct, checking every row
// against what the kernel assumes (pointers present and aligned to the
// row's vector, row starts aligned, the tile prefix exact, the
// coefficient row inside the [coeff_rows, K] table).
template <typename TT, typename TD, typename TO, bool HAS_THETA>
cudaError_t fill_table(const long long* rows, int count, int k_count,
                       int coeff_rows, Table* table) {
  if (rows == nullptr || count < 1 || count > kMaxSegments) {
    return cudaErrorInvalidValue;
  }
  long long tile_end = 0;
  table->count = count;
  for (int i = 0; i < count; ++i) {
    const long long* r = rows + (long long)i * kColumns;
    Segment& s = table->seg[i];
    s.theta = reinterpret_cast<const void*>(r[kTheta]);
    s.delta = reinterpret_cast<const void*>(r[kDelta]);
    s.out = reinterpret_cast<void*>(r[kOut]);
    s.size = r[kSize];
    s.vec = (int)r[kVec];
    s.tile_end = r[kTileEnd];
    if (r[kRow] < 0 || r[kRow] >= coeff_rows) return cudaErrorInvalidValue;
    s.row = (int)r[kRow];
    const int v = s.vec;
    const bool vec_ok =
        (v == 1 || v == 2 || v == 4 || v == 8) &&
        v <= max_vec<TT, TD, TO, HAS_THETA>();
    if (!vec_ok || s.delta == nullptr || s.out == nullptr || s.size < 1 ||
        (HAS_THETA != (s.theta != nullptr))) {
      return cudaErrorInvalidValue;
    }
    if (!aligned(s.delta, v * (long long)sizeof(TD)) ||
        !aligned(s.out, v * (long long)sizeof(TO)) ||
        (HAS_THETA && !aligned(s.theta, v * (long long)sizeof(TT))) ||
        (k_count > 1 && s.size % v != 0)) {
      return cudaErrorMisalignedAddress;
    }
    tile_end += tiles_for(s.size, v, kThreads);
    if (s.tile_end != tile_end) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// Blocks of `kernel` that fit on the device at once (SMs x occupancy).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, long long* out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  *out = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

template <typename TT, typename TD, typename TO, bool HAS_THETA, int KB,
          int VMAX>
cudaError_t launch_kernel(const Table& table, const float* coeffs,
                          int k_count, cudaStream_t stream) {
  auto kernel = fl_aggregate_kernel<TT, TD, TO, HAS_THETA, KB, VMAX>;
  const size_t smem = (size_t)k_count * sizeof(float);
  long long blocks = 0;
  cudaError_t err = resident_blocks(kernel, smem, &blocks);
  if (err != cudaSuccess) return err;
  const long long tiles = table.seg[table.count - 1].tile_end;
  if (blocks > tiles) blocks = tiles;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(table, coeffs,
                                                       k_count);
  return cudaGetLastError();
}

template <typename TT, typename TD, typename TO, bool HAS_THETA, int KB>
cudaError_t launch_widest(const Table& table, int vmax, const float* coeffs,
                          int k_count, cudaStream_t stream) {
  constexpr int kMaxVec = max_vec<TT, TD, TO, HAS_THETA>();
  switch (vmax) {
    case 8:
      if constexpr (kMaxVec >= 8) {
        return launch_kernel<TT, TD, TO, HAS_THETA, KB, 8>(table, coeffs,
                                                           k_count, stream);
      }
      break;
    case 4:
      if constexpr (kMaxVec >= 4) {
        return launch_kernel<TT, TD, TO, HAS_THETA, KB, 4>(table, coeffs,
                                                           k_count, stream);
      }
      break;
    case 2:
      return launch_kernel<TT, TD, TO, HAS_THETA, KB, 2>(table, coeffs,
                                                         k_count, stream);
    case 1:
      return launch_kernel<TT, TD, TO, HAS_THETA, KB, 1>(table, coeffs,
                                                         k_count, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename TT, typename TD, typename TO, bool HAS_THETA>
cudaError_t launch(const long long* rows, int count, const float* coeffs,
                   int coeff_rows, int k_count, cudaStream_t stream) {
  Table table;
  cudaError_t err = fill_table<TT, TD, TO, HAS_THETA>(rows, count, k_count,
                                                      coeff_rows, &table);
  if (err != cudaSuccess) return err;
  int vmax = 1;
  for (int i = 0; i < table.count; ++i) {
    if (table.seg[i].vec > vmax) vmax = table.seg[i].vec;
  }
  switch (bucket_for(k_count)) {
    case 8:
      return launch_widest<TT, TD, TO, HAS_THETA, 8>(table, vmax, coeffs,
                                                     k_count, stream);
    case 16:
      return launch_widest<TT, TD, TO, HAS_THETA, 16>(table, vmax, coeffs,
                                                      k_count, stream);
    default:
      return launch_widest<TT, TD, TO, HAS_THETA, 0>(table, vmax, coeffs,
                                                     k_count, stream);
  }
}

}  // namespace

extern "C" {

// The largest K the kernel takes (its coefficients live in shared memory).
int fl_aggregate_max_k() { return kMaxK; }

// The most leaves one launch takes.
int fl_aggregate_max_segments() { return kMaxSegments; }

// Vectors per tile: the unit of the table's tile prefix.
int fl_aggregate_tile_vectors() { return kThreads; }

// Readable text of a code returned by the launcher below.
const char* fl_aggregate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One launch over `count` segments (rows of kColumns int64: theta, delta
// and out addresses, size, vector width, tile prefix, coefficient row),
// coeffs [coeff_rows, K] f32 row-major.  theta_dtype -1 is the
// theta-less reduce (out f32, theta addresses 0); otherwise out has
// theta's dtype.  Dtype codes: 0 f32, 1 bf16.  Returns a cudaError_t
// code (0 on success).
int fl_aggregate_segments_launch(const long long* rows, int count,
                                 const float* coeffs, int coeff_rows,
                                 int k_count, int theta_dtype,
                                 int delta_dtype, void* stream) {
  if (coeffs == nullptr || k_count < 1 || k_count > kMaxK ||
      coeff_rows < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err = cudaErrorInvalidValue;
  if (theta_dtype == kF32 && delta_dtype == kF32) {
    err = launch<float, float, float, true>(rows, count, coeffs, coeff_rows,
                                           k_count, s);
  } else if (theta_dtype == kBF16 && delta_dtype == kBF16) {
    err = launch<bf16, bf16, bf16, true>(rows, count, coeffs, coeff_rows,
                                        k_count, s);
  } else if (theta_dtype == kF32 && delta_dtype == kBF16) {
    err = launch<float, bf16, float, true>(rows, count, coeffs, coeff_rows,
                                          k_count, s);
  } else if (theta_dtype == kBF16 && delta_dtype == kF32) {
    err = launch<bf16, float, bf16, true>(rows, count, coeffs, coeff_rows,
                                         k_count, s);
  } else if (theta_dtype == kNone && delta_dtype == kF32) {
    err = launch<float, float, float, false>(rows, count, coeffs, coeff_rows,
                                            k_count, s);
  } else if (theta_dtype == kNone && delta_dtype == kBF16) {
    err = launch<float, bf16, float, false>(rows, count, coeffs, coeff_rows,
                                           k_count, s);
  }
  return (int)err;
}

}  // extern "C"

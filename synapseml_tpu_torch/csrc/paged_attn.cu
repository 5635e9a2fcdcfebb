// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel of synapseml_tpu/models/llm/pallas_attn.py:
//
//   K3  paged_decode_attention  (kernel _make_decode_kernel)
//       one decode (S = 1) or speculative-verify (S > 1) step's attention
//       for every slot of the continuous-batching engine, reading only the
//       slot's live K/V span: query j of slot b attends the keys
//       kpos < spans[b] - (S - 1) + j (for S = 1 just the live span), with
//       an f32 online softmax and the GQA query heads of one kv head
//       grouped so each K/V tile is read once per kv head.
//
// Three kernels compute it: the split kernel for bf16 and f16 (the engine's
// types), the f32 split kernel for f32 (the exactness path), and the
// previous kernel, paged_decode_kernel, at every type as the yardstick both
// are timed against and a tuning-table choice.
//
// What all three keep of the Pallas kernel:
//
// - The S * group query rows of a kv head (row r = j * group + g holds query
//   j of head h * group + g, the Pallas kernel's head-major row order) share
//   each K/V tile, split into row chunks of at most kMaxRows.  Key loops have
//   the DYNAMIC bound min(span, max_len): the TPU's power-of-two span buckets
//   and clamped index map existed for XLA's static grid; a CUDA block stops
//   at its slot's span, so short slots cost no reads past it.
// - Scores are q . k / sqrt(D) in f32 (divided, as the reference divides --
//   the scale is not folded into q), masked keys take -FLT_MAX
//   (finfo(f32).min, the reference's fill) so they underflow to probability
//   0 exactly as in the reference, and each row keeps a running max, sum and
//   D-wide accumulator in f32.  The output is acc / max(l, 1e-30) in q's type.
// - A query row with no unmasked key (an inactive slot at span 1 in a
//   verify step with S > 1) gets an unspecified output, as in the reference;
//   the engine discards such rows.
//
// Bound on the H100: bytes.  A step reads each live K and V row once per kv
// head (2 * span * D * itemsize per (slot, kv head)) plus q and writes out;
// the arithmetic is 4 * S * group * span * D flops per (slot, kv head), at
// most ~64 flops per byte at the engine's widths, far below the ~295 at
// which the bf16 tensor cores and not the memory would bound it.  At the
// decode engine's shapes (16 slots x 2048 positions, 32 / 8 heads, D = 64,
// 10,574 live keys) that is ~22 MB and ~6.5 us at 3.35 TB/s.
//
// The split kernel (paged_split_kernel + paged_combine_kernel), and what
// each part of it is for:
//
// - Split of the span (flash-decoding).  Each block takes one chunk of
//   kSplit keys of one slot's span for one row chunk: the shapes above give
//   ~50 chunks x 8 kv heads of work for 132 SMs instead of 128 blocks
//   behind the one 2048-key slot, whose 32 serial tiles set the previous
//   kernel's time.  Each block writes its rows' running max, sum and
//   unnormalised f32 accumulators; paged_combine_kernel rescales the live
//   chunks by exp(m - m_max) and normalises.  Expected: the longest slot
//   no longer sets the time, about 2x at every width.  The combine is its
//   own launch, not the last-arriving block through an atomic counter:
//   that would need a zeroed counter per (slot, kv head, row chunk) kept
//   across calls, and the partials it reads are a few KB.
// - cp.async ring.  A chunk's 64-key K/V tiles come in through a
//   kStages-deep ring of 16-byte cp.async.cg copies in the cache's own type
//   (not widened), so two tiles' bytes are in flight while one is computed.
//   Part of the same 2x: the block no longer waits a full memory latency
//   per tile.
// - mma.sync tensor cores.  Warp w owns 16 query rows (S = 1 gives 4 real
//   rows; the pad rows are computed and never written).  q k^T and P V run
//   as m16n8k16 bf16/f16 products with f32 accumulators, K and V fragments
//   come by ldmatrix (.trans for V), the softmax runs on the score fragments
//   in registers, and two adjacent key n-tiles' scores re-pack as the A
//   fragment of P V without a trip through shared memory.  P is rounded to
//   the compute type before P V (the port's dense rule), not kept in f32 as
//   the Pallas kernel's P V.  Expected: S = 1 is bytes-bound already, but
//   at S = 4 .. 32 the scalar FMA loops of 4 .. 32 times S = 1's arithmetic
//   per byte set the time; on the tensor cores every width costs about
//   what S = 1 costs.  A verify step wider than kMaxRows (S = 32: 128 rows)
//   takes several row chunks, each reading the span: its bytes come from
//   device memory once and, for the later chunks, mostly from L2 (the row
//   chunks of one key chunk are adjacent in the grid).
//
// The f32 split kernel (paged_f32_split_kernel) replaces the previous
// kernel at f32.  It keeps full f32 products: plain FFMA, no mma and no
// TF32, because the f32 engine is held token-exact to the CPU and to the
// dense generate, and the 1e-5 tolerance of f32 rests on full products.
// Bound: bytes.  At S <= 8 a (slot, kv head) does 4 S group D flops a key
// against 8 D bytes, 2-16 flops a byte, below the ~20 at which the f32
// FMAs (67 TFLOP/s) and not the memory (3.35 TB/s) would bound it.  What
// each part of it is for:
//
// - Split of the span over blocks.  Grid (key chunk x row chunk, kv head,
//   slot).  The chunk length C, a multiple of the 64-key tile in
//   [64, SML_PA_SPLIT], is chosen from the shapes alone (B, KV, max_len
//   and the row chunks; never the spans, which live on the device) as the
//   fewest keys at which B * KV * row chunks * ceil(T / C) is at most
//   SML_PA_F32_BLOCKS, about two blocks per SM: 64 keys at 4 slots x 512
//   (256 blocks for the previous kernel's 32), 256 at 16 slots x 2048.
//   A row that would take fewer than 4 chunks and fits one is one chunk
//   (128 keys at 4 slots x 128): there the combine's tail costs more than
//   the split saves.  The longest slot's tiles spread over blocks instead
//   of running one after another in one block; a chunk past its slot's
//   span exits.
// - cp.async ring.  q and the chunk's 64-key K and V tiles come in as
//   16-byte cp.async.cg copies, in f32, through a kStages-deep ring, so
//   two tiles are in flight while one is computed; the ring's is the one
//   block barrier a tile.  Shared rows are D + 4 floats: 16-byte aligned
//   for the copies, and the 8 rows of one quarter-warp's 16-byte reads
//   fall on distinct banks.
// - Warp-level arithmetic.  Four warps each own 16 keys of every tile,
//   with their own online softmax state; a block of one 4-row group of
//   query rows (S = 1 at the engine's GQA groups) has just these, a wider
//   block (at most SML_PA_F32_ACC / D rows) two such sets, one for each
//   half of its rows, so a warp's accumulators take at most 32 registers
//   a lane and twice the warps hide the latencies of the S > 1 loops.
//   Scores: lane (key, half of D) keeps its half K row in registers and
//   runs one FMA chain per query row against q rows read from shared
//   memory (four rows at a time), the halves added by one shuffle.
//   Softmax: lane r owns its warp's row r's running max and sum and
//   rescales the row's 16 scores.  P V: lane owns D / 32 columns (two key
//   groups at D = 16), four keys' V in registers against each row's four
//   probabilities.  The warps merge their states in shared memory once,
//   at the end of the chunk.  Measured on the H100 (tools/chip/
//   k3_f32_chunks.py, one call): the two sets take S = 8 at 4 slots x 512
//   from 0.0244 to 0.0169 ms, and cost S = 1 2-7%, hence one set there.
// - Combine in the last-arriving block.  A chunk of a slot whose span
//   takes several chunks writes its rows' (m, l, acc) to an f32 workspace,
//   fences, and adds one to a counter per (slot, kv head, row chunk); the
//   block that brings it to the slot's live chunk count rescales the
//   partials by exp(m - m_max), normalises, writes out and sets the
//   counter back to 0.  A slot whose span fits one chunk writes out
//   directly.  One launch, and no combine launch after it; the counters
//   belong to the wrapper, are zeroed once and stay zero between calls,
//   so a captured graph replays while the spans change in place.
//
// The previous kernel (paged_decode_kernel) takes one block per (kv head,
// slot, row chunk), walks the slot's whole span in 64-key tiles loaded
// through registers and widens each tile to f32 in shared memory, with
// scalar FMAs and four barriers a tile.  It was f32's kernel until the f32
// split kernel replaced it; it stays, at every type, as the yardstick both
// split kernels are timed against and as a tuning-table choice.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

// The limits come from the build (DEFINES in kernels/_build.py), where the
// Python wrapper reads them too: query rows per block (wider S * group is
// split across blocks) and the largest head width.
#if !defined(SML_PA_MAX_ROWS) || !defined(SML_PA_MAX_D) || \
    !defined(SML_PA_SPLIT) || !defined(SML_PA_F32_BLOCKS) || \
    !defined(SML_PA_F32_ACC) || !defined(SML_PA_F32_MIN_CHUNKS)
#error "build with the -DSML_PA_... limits of kernels/_build.py"
#endif
constexpr int kMaxRows = SML_PA_MAX_ROWS;
constexpr int kMaxD = SML_PA_MAX_D;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // keys per iteration

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch and XLA
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// elements of T in one 16-byte load
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// one 16-byte load of N elements widened to f32 (src 16-byte aligned)
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) dst[i] = to_f32(e[i]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes(int rows) {
  return (2 * kTile * (D + 1) + rows * D + rows * kTile + 3 * rows) *
         sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,            // (B, S, H, D)
                    const T* __restrict__ k,            // (B, T, KV, D)
                    const T* __restrict__ v,            // (B, T, KV, D)
                    const int32_t* __restrict__ spans,  // (B,)
                    T* __restrict__ out,                // (B, S, H, D)
                    int S, int H, int KV, long long T_len, float sqrt_d) {
  constexpr int kVec = Vec<T>::N;
  constexpr int kLd = D + 1;  // padded shared-memory row of K and V
  constexpr int kAcc = kMaxRows * D / kThreads;  // accumulators per thread
  static_assert(D % kVec == 0, "a 16-byte load must not straddle rows");
  static_assert(kAcc >= 1 && kMaxRows * D % kThreads == 0, "row mapping");

  const int h = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // slot
  const int group = H / KV;
  const int r0 = blockIdx.z * kMaxRows;  // this block's first query row
  const int R = min(kMaxRows, S * group - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float sh[];
  float* ks = sh;                   // kTile x kLd
  float* vs = ks + kTile * kLd;     // kTile x kLd
  float* qs = vs + kTile * kLd;     // R x D (local row r is row r0 + r)
  float* ps = qs + R * D;           // R x kTile: scores, then probabilities
  float* ms = ps + R * kTile;       // R running max
  float* ls = ms + R;               // R running sum
  float* as = ls + R;               // R this tile's rescale factor

  for (int e = tid * kVec; e < R * D; e += kThreads * kVec) {
    const int r = e / D, d = e % D;
    const int j = (r0 + r) / group, g = (r0 + r) % group;
    float tmp[kVec];
    load_vec(q + (((long long)b * S + j) * H + h * group + g) * D + d, tmp);
#pragma unroll
    for (int i = 0; i < kVec; ++i) qs[e + i] = tmp[i];
  }
  for (int r = tid; r < R; r += kThreads) {
    ms[r] = -FLT_MAX;
    ls[r] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const int span = spans[b];
  const long long kmax = span < 0 ? 0 : (span < T_len ? span : T_len);
  const long long row = (long long)KV * D;  // elements between keys
  const T* kb = k + (long long)b * T_len * row + (long long)h * D;
  const T* vb = v + (long long)b * T_len * row + (long long)h * D;
  const long long lim0 = (long long)span - (S - 1);  // query j: kpos < lim0 + j

  for (long long t0 = 0; t0 < kmax; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed; q, m, l are set
    for (int e = tid * kVec; e < kTile * D; e += kThreads * kVec) {
      const int kk = e / D, d = e % D;
      float tk[kVec], tv[kVec];
      if (t0 + kk < kmax) {
        load_vec(kb + (t0 + kk) * row + d, tk);
        load_vec(vb + (t0 + kk) * row + d, tv);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) tk[i] = tv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        ks[kk * kLd + d + i] = tk[i];
        vs[kk * kLd + d + i] = tv[i];
      }
    }
    __syncthreads();
    for (int e = tid; e < R * kTile; e += kThreads) {
      const int r = e / kTile, jj = e % kTile;
      float s = -FLT_MAX;
      if (t0 + jj < lim0 + (r0 + r) / group) {
        const float* qr = qs + r * D;
        const float* kr = ks + jj * kLd;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot / sqrt_d;
      }
      ps[e] = s;
    }
    __syncthreads();
    for (int r = warp; r < R; r += kWarps) {
      float* pr = ps + r * kTile;
      float mx = -FLT_MAX;
      for (int jj = lane; jj < kTile; jj += 32) mx = fmaxf(mx, pr[jj]);
      mx = warp_max(mx);
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int jj = lane; jj < kTile; jj += 32) {
        const float p = expf(pr[jj] - m_new);
        pr[jj] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        ms[r] = m_new;
        ls[r] = ls[r] * alpha + sum;
        as[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < R * D) {
        const int r = e / D, d = e % D;
        const float* pr = ps + r * kTile;
        float pv = 0.f;
#pragma unroll 8
        for (int jj = 0; jj < kTile; ++jj) pv = fmaf(pr[jj], vs[jj * kLd + d], pv);
        acc[i] = acc[i] * as[r] + pv;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < R * D) {
      const int r = e / D, d = e % D;
      const int j = (r0 + r) / group, g = (r0 + r) % group;
      const float l = fmaxf(ls[r], 1e-30f);
      out[(((long long)b * S + j) * H + h * group + g) * D + d] =
          from_f32<T>(acc[i] / l);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int32_t* spans,
           void* out, int B, int S, int H, int KV, long long T_len,
           float sqrt_d, cudaStream_t stream) {
  const int rows = S * (H / KV);
  const int chunks = (rows + kMaxRows - 1) / kMaxRows;
  const size_t smem = smem_bytes<D>(rows < kMaxRows ? rows : kMaxRows);
  auto kern = paged_decode_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(KV, B, chunks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), spans, static_cast<T*>(out), S, H, KV, T_len,
      sqrt_d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const int32_t* spans, void* out, int B, int S, int H, int KV,
             long long T_len, float sqrt_d, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, spans, out, B, S, H, KV, T_len, sqrt_d, stream);
    case 32:
      return launch<T, 32>(q, k, v, spans, out, B, S, H, KV, T_len, sqrt_d, stream);
    case 64:
      return launch<T, 64>(q, k, v, spans, out, B, S, H, KV, T_len, sqrt_d, stream);
    case 128:
      return launch<T, 128>(q, k, v, spans, out, B, S, H, KV, T_len, sqrt_d, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The split kernel (bf16, f16): each block takes one chunk of kSplit keys
// of one slot's span; a second kernel combines the chunks.
// ---------------------------------------------------------------------------

constexpr int kSplit = SML_PA_SPLIT;  // keys per block
constexpr int kStages = 3;            // cp.async ring depth, in key tiles
constexpr int kSplitThreads = kMaxRows / 16 * 32;  // a warp per 16 query rows
constexpr int kCombineThreads = 128;
static_assert(kSplit % kTile == 0 && kMaxRows % 16 == 0, "split geometry");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; bytes = 0 fills zeros and reads
// nothing (the source address must still be valid)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared-memory row of K and V in the cache's type: D + 8 elements, a
// multiple of 16 bytes whose stride puts the 8 rows one ldmatrix phase
// reads on distinct banks
template <int D>
__host__ __device__ constexpr int split_ld() {
  return D + 8;
}

template <typename T, int D>
constexpr size_t split_smem_bytes() {
  return kStages * 2 * kTile * split_ld<D>() * sizeof(T);
}

// ldmatrix: four 8 x 8 b16 matrices from shared memory, lanes 8i .. 8i + 7
// naming the rows of matrix i; lane l receives row l / 4, columns
// 2 (l % 4) and + 1 of each (.trans: column l / 4, rows 2 (l % 4) and + 1)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a b for a 16 x 16 A (row-major) and 16 x 8 B (column-major) in T,
// f32 accumulators.  Lane l = 4 g + t holds A rows g, g + 8 at columns
// 2t, 2t + 1 (a[0], a[1]) and 2t + 8, 2t + 9 (a[2], a[3]); B column g at
// rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1); C rows g (c[0], c[1]) and
// g + 8 (c[2], c[3]) at columns 2t, 2t + 1.
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to T, lo in the low half (the lower column of a fragment)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Warp w owns the block's query rows 16 w .. 16 w + 15 (rows past the
// block's R are zero and never written; a warp with no row only copies).
// Per 64-key tile it computes S = q k^T as 8 key n-tiles x D/16 k-steps of
// mma.sync (q's fragments stay in registers for the whole chunk, K's come
// by ldmatrix), scales, masks and runs the online softmax on the score
// fragments (row max and sum over the 4 lanes of a row), rounds P to T
// and re-packs two adjacent key n-tiles' score fragments as the A fragment
// of P V (FlashAttention-2's register reuse), whose B fragments come from
// V by ldmatrix.trans.  Partials of one (slot, kv head, chunk): for each of
// the S * group query rows, the running max m, the sum l and the D
// unnormalised accumulators, f32, at
// ws[(((b * KV + h) * n_split + chunk) * rows + r) * (D + 2)].
template <typename T, int D>
__global__ void __launch_bounds__(kSplitThreads)
paged_split_kernel(const T* __restrict__ q,            // (B, S, H, D)
                   const T* __restrict__ k,            // (B, T, KV, D)
                   const T* __restrict__ v,            // (B, T, KV, D)
                   const int32_t* __restrict__ spans,  // (B,)
                   float* __restrict__ ws,             // partials
                   int S, int H, int KV, long long T_len, int n_split,
                   float sqrt_d) {
  constexpr int kVec = Vec<T>::N;
  constexpr int kLd = split_ld<D>();
  constexpr int kKs = D / 16;     // k-steps of q k^T
  constexpr int kNt = kTile / 8;  // key n-tiles of S
  constexpr int kDt = D / 8;      // d n-tiles of P V
  static_assert(D % 16 == 0 && D % kVec == 0, "head width");

  const int group = H / KV;
  const int rows = S * group;
  const int chunks = (rows + kMaxRows - 1) / kMaxRows;
  const int split = blockIdx.x / chunks;  // row chunks of a split adjacent
  const int r0 = (blockIdx.x % chunks) * kMaxRows;
  const int R = min(kMaxRows, rows - r0);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;

  const int span = spans[b];
  const long long kmax = span < 0 ? 0 : (span < T_len ? span : T_len);
  const long long c0 = (long long)split * kSplit;
  // chunk 0 always writes its partials (all-masked for an empty span)
  if (split > 0 && c0 >= kmax) return;
  const long long c1 = kmax < c0 + kSplit ? kmax : c0 + kSplit;
  const int n_tiles = (int)((c1 - c0 + kTile - 1) / kTile);
  const long long row = (long long)KV * D;  // elements between keys
  const T* kb = k + (long long)b * T_len * row + (long long)h * D;
  const T* vb = v + (long long)b * T_len * row + (long long)h * D;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // kStages x (K tile, V tile)

  // tile i of the chunk into stage i % kStages; keys past the chunk are
  // zero-filled, so a masked key multiplies a finite 0 in P V
  auto load_tile = [&](int i) {
    T* ks = ring + (i % kStages) * 2 * kTile * kLd;
    T* vs = ks + kTile * kLd;
    const long long t0 = c0 + (long long)i * kTile;
    for (int e = tid; e < kTile * (D / kVec); e += kSplitThreads) {
      const int kk = e / (D / kVec), d = (e % (D / kVec)) * kVec;
      const bool in = t0 + kk < c1;
      const long long off = (in ? t0 + kk : 0) * row + d;
      cp_async16(ks + kk * kLd + d, kb + off, in ? 16 : 0);
      cp_async16(vs + kk * kLd + d, vb + off, in ? 16 : 0);
    }
  };
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1);
  cp_async_commit();

  // this lane's two query rows (g and g + 8 of the warp's 16), their
  // key limits (query j: kpos < span - (S - 1) + j, and inside the chunk)
  // and q's A fragments, read once from device memory
  const bool active = warp * 16 < R;
  int rr[2];
  long long lim[2];
  uint32_t qa[kKs][4];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rr[hr] = r0 + warp * 16 + g + 8 * hr;
    const long long l = (long long)span - (S - 1) + rr[hr] / group;
    lim[hr] = l < c1 ? l : c1;
  }
#pragma unroll
  for (int kk = 0; kk < kKs; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int hr = u & 1;  // a[1], a[3]: row g + 8
      // a pad row repeats the block's first row: a zero q would give zero
      // scores, and a zero dividend takes the slow path of IEEE division
      const int r = rr[hr] < r0 + R ? rr[hr] : r0;
      const int j = r / group, gg = r % group;
      qa[kk][u] = *reinterpret_cast<const uint32_t*>(
          q + (((long long)b * S + j) * H + h * group + gg) * D + kk * 16 +
          2 * tq + 8 * (u >> 1));
    }

  float o[kDt][4];
#pragma unroll
  for (int n = 0; n < kDt; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-FLT_MAX, -FLT_MAX};
  float l[2] = {0.f, 0.f};  // this lane's share; summed over the quad at the end

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<1>();  // tile i has landed (one newer group may fly)
    __syncthreads();     // ... for every thread; tile i - 1 is consumed
    if (i + 2 < n_tiles) load_tile(i + 2);
    cp_async_commit();   // an empty group keeps the count uniform
    if (!active) continue;
    const T* ks = ring + (i % kStages) * 2 * kTile * kLd;
    const T* vs = ks + kTile * kLd;
    const long long t0 = c0 + (long long)i * kTile;

    float sc[kNt][4];
#pragma unroll
    for (int n = 0; n < kNt; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int np = 0; np < kNt / 2; ++np)
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        // matrices: keys 16 np + 0..7 at d 16 kk + 0..7 and + 8..15, then
        // keys 16 np + 8..15 at the same d: B of key n-tiles 2 np, 2 np + 1
        uint32_t bf[4];
        ldsm_x4(bf, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                        kk * 16 + (((lane >> 3) & 1) << 3));
        mma16816<T>(sc[2 * np], qa[kk], bf[0], bf[1]);
        mma16816<T>(sc[2 * np + 1], qa[kk], bf[2], bf[3]);
      }

    // scores q . k / sqrt(D), masked keys at -FLT_MAX; the running max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long kpos = t0 + n * 8 + 2 * tq + (u & 1);
        const int hr = u >> 1;
        float x = -FLT_MAX;  // masked keys divide nothing
        if (kpos < lim[hr]) x = sc[n][u] / sqrt_d;
        sc[n][u] = x;
        mx[hr] = fmaxf(mx[hr], x);
      }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = quad_max(mx[hr]);
      alpha[hr] = expf(m[hr] - mx[hr]);
      m[hr] = mx[hr];
      l[hr] *= alpha[hr];
    }
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sc[n][u] = expf(sc[n][u] - m[u >> 1]);
        l[u >> 1] += sc[n][u];
      }
#pragma unroll
    for (int n = 0; n < kDt; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) o[n][u] *= alpha[u >> 1];

    // o += P V, 16 keys per k-step; P rounded to T
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t pa[4] = {pack2<T>(sc[2 * kk][0], sc[2 * kk][1]),
                              pack2<T>(sc[2 * kk][2], sc[2 * kk][3]),
                              pack2<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack2<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kDt / 2; ++dp) {
        // matrices (transposed): keys 16 kk + 0..7 and + 8..15 at d
        // 16 dp + 0..7, then both at + 8..15: B of d n-tiles 2 dp, 2 dp + 1
        uint32_t bf[4];
        ldsm_x4_t(bf, vs + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                               kLd +
                          dp * 16 + ((lane >> 4) << 3));
        mma16816<T>(o[2 * dp], pa, bf[0], bf[1]);
        mma16816<T>(o[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
  }
  if (!active) return;
  float* wsb = ws + ((long long)(b * KV + h) * n_split + split) * rows * (D + 2);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float lsum = quad_sum(l[hr]);
    if (rr[hr] >= r0 + R) continue;
    float* w = wsb + (long long)rr[hr] * (D + 2);
    if (tq == 0) {
      w[0] = m[hr];
      w[1] = lsum;
    }
#pragma unroll
    for (int n = 0; n < kDt; ++n)
      *reinterpret_cast<float2*>(w + 2 + n * 8 + 2 * tq) =
          make_float2(o[n][2 * hr], o[n][2 * hr + 1]);
  }
}

// One thread per (slot, kv head, query row, d): rescales the live chunks'
// partials by exp(m_chunk - m_max) and writes acc / max(l, 1e-30) in T.  A
// chunk whose keys are all masked for the row has m = -FLT_MAX and weight
// exp(-FLT_MAX - m_max) = 0, exactly as the one-pass online softmax.
template <typename T, int D>
__global__ void __launch_bounds__(kCombineThreads)
paged_combine_kernel(const float* __restrict__ ws,
                     const int32_t* __restrict__ spans, T* __restrict__ out,
                     int S, int H, int KV, long long T_len, int n_split) {
  const int group = H / KV;
  const int rows = S * group;
  const int e = blockIdx.x * kCombineThreads + threadIdx.x;
  if (e >= rows * D) return;
  const int r = e / D, d = e % D;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int span = spans[b];
  const long long kmax = span < 0 ? 0 : (span < T_len ? span : T_len);
  const int n_live = kmax > kSplit ? (int)((kmax + kSplit - 1) / kSplit) : 1;
  const long long stride = (long long)rows * (D + 2);  // between chunks
  const float* w = ws + (long long)(b * KV + h) * n_split * stride +
                   (long long)r * (D + 2);
  float m_max = -FLT_MAX;
  for (int c = 0; c < n_live; ++c) m_max = fmaxf(m_max, w[c * stride]);
  float l = 0.f, acc = 0.f;
  for (int c = 0; c < n_live; ++c) {
    const float wt = expf(w[c * stride] - m_max);
    l = fmaf(wt, w[c * stride + 1], l);
    acc = fmaf(wt, w[c * stride + 2 + d], acc);
  }
  const int j = r / group, g = r % group;
  out[(((long long)b * S + j) * H + h * group + g) * D + d] =
      from_f32<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T, int D>
int launch_split(const void* q, const void* k, const void* v,
                 const int32_t* spans, void* out, float* ws, int B, int S,
                 int H, int KV, long long T_len, int n_split, float sqrt_d,
                 cudaStream_t stream) {
  const int rows = S * (H / KV);
  const int chunks = (rows + kMaxRows - 1) / kMaxRows;
  const size_t smem = split_smem_bytes<T, D>();
  auto kern = paged_split_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(n_split * chunks, KV, B), kSplitThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), spans, ws, S, H, KV, T_len, n_split, sqrt_d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_combine_kernel<T, D>
      <<<dim3((rows * D + kCombineThreads - 1) / kCombineThreads, KV, B),
         kCombineThreads, 0, stream>>>(ws, spans, static_cast<T*>(out), S, H,
                                       KV, T_len, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_split_d(int D, const void* q, const void* k, const void* v,
                   const int32_t* spans, void* out, float* ws, int B, int S,
                   int H, int KV, long long T_len, int n_split, float sqrt_d,
                   cudaStream_t st) {
  switch (D) {
    case 16:
      return launch_split<T, 16>(q, k, v, spans, out, ws, B, S, H, KV, T_len,
                                 n_split, sqrt_d, st);
    case 32:
      return launch_split<T, 32>(q, k, v, spans, out, ws, B, S, H, KV, T_len,
                                 n_split, sqrt_d, st);
    case 64:
      return launch_split<T, 64>(q, k, v, spans, out, ws, B, S, H, KV, T_len,
                                 n_split, sqrt_d, st);
    case 128:
      return launch_split<T, 128>(q, k, v, spans, out, ws, B, S, H, KV, T_len,
                                  n_split, sqrt_d, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The f32 split kernel: each block takes one chunk of C keys of one slot's
// span for one row chunk, in full f32 FMAs; the last block of a slot's
// chunks to arrive combines them, in the same launch.
// ---------------------------------------------------------------------------

// warps across a tile's keys; a block of more than one 4-row group of
// query rows has two such sets, one for each half of its rows
constexpr int kF32KeyWarps = 4;
constexpr int kF32Keys = kTile / kF32KeyWarps;  // keys of a tile per warp
constexpr int kF32Ld = kF32Keys + 4;  // a row's scores, its rescale, pad
constexpr long long kF32Blocks = SML_PA_F32_BLOCKS;
static_assert(kF32Keys == 16, "a warp's lanes are 16 keys x 2 halves of D");

// query rows one block keeps at head width D: rows x D accumulators of a
// key quarter, which its row-half warps share
__host__ __device__ constexpr int f32_rows(int D) {
  return SML_PA_F32_ACC / D < kMaxRows ? SML_PA_F32_ACC / D : kMaxRows;
}

// The chunk length from the shapes alone: the fewest keys, a multiple of
// the tile in [kTile, kSplit], at which the grid holds at most kF32Blocks
// blocks; but a cache row that this would cut into fewer than
// SML_PA_F32_MIN_CHUNKS chunks, and that one chunk can take, is one chunk
// (the combine's serial tail costs more than so short a split saves).
// models/llm/paged_attn.py's f32_chunk_keys states the same rule.
__host__ __device__ inline int f32_chunk_keys(long long B, long long KV,
                                              long long T_len,
                                              long long row_chunks) {
  int c = kTile;
  while (c < kSplit && B * KV * row_chunks * ((T_len + c - 1) / c) >
                           kF32Blocks)
    c += kTile;
  const long long whole = (T_len + kTile - 1) / kTile * kTile;
  if ((T_len + c - 1) / c < SML_PA_F32_MIN_CHUNKS && whole <= kSplit)
    return (int)whole;
  return c;
}

// sets of key warps of a block of R4 (padded) query rows, and each warp's
// rows: the block's 4-row groups split between the sets
__host__ __device__ constexpr int f32_row_warps(int R4) {
  return R4 > 4 ? 2 : 1;
}
__host__ __device__ constexpr int f32_warp_rows(int R4) {
  return (R4 / 4 + f32_row_warps(R4) - 1) / f32_row_warps(R4) * 4;
}

// dynamic shared floats: the ring, q (R4 rows), each warp's scores
// (f32_warp_rows x kF32Ld) and the rows' key limits
template <int D>
constexpr size_t f32_smem_bytes(int R4) {
  return ((size_t)kStages * 2 * kTile * (D + 4) + (size_t)R4 * D +
          (size_t)kF32KeyWarps * f32_row_warps(R4) * f32_warp_rows(R4) *
              kF32Ld +
          R4) *
         sizeof(float);
}

// acc / max(l, 1e-30) into out's columns d .. d + 3 of query row rr of
// kv head h (row rr = j * group + g is query j of head h * group + g)
template <int D>
__device__ __forceinline__ void store_row4(float* out, int b, int S, int H,
                                           int group, int h, int rr, int d,
                                           float4 a, float l) {
  const int j = rr / group, g = rr % group;
  l = fmaxf(l, 1e-30f);
  *reinterpret_cast<float4*>(
      out + (((long long)b * S + j) * H + h * group + g) * D + d) =
      make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
}

// Partials of one (slot, kv head, chunk): for each of the S * group query
// rows, the D unnormalised accumulators, m and l, at
// ws[(((b * KV + h) * n_chunks + chunk) * rows + r) * (D + 4)], 16-byte
// aligned; counters[(b * KV + h) * row_chunks + row chunk] counts the
// chunks that wrote theirs.
template <int D, int kRowWarps>
__global__ void __launch_bounds__(kF32KeyWarps * kRowWarps * 32)
paged_f32_split_kernel(const float* __restrict__ q,         // (B, S, H, D)
                       const float* __restrict__ k,         // (B, T, KV, D)
                       const float* __restrict__ v,         // (B, T, KV, D)
                       const int32_t* __restrict__ spans,   // (B,)
                       float* __restrict__ out,             // (B, S, H, D)
                       float* __restrict__ ws, int* __restrict__ counters,
                       int S, int H, int KV, long long T_len, int chunk,
                       int n_chunks, float sqrt_d) {
  constexpr int kRows = f32_rows(D);
  constexpr int kF32Warps = kF32KeyWarps * kRowWarps;
  constexpr int kF32Threads = kF32Warps * 32;
  // the most rows of a warp: one 4-row group for one set of key warps,
  // half the block's rows for two
  constexpr int kRowsW = kRowWarps == 1 ? 4 : kRows / kRowWarps;
  constexpr int kLd = D + 4;           // shared row of K, V
  constexpr int kHalf = D / 2;         // a score lane's share of D
  constexpr int kNc = D >= 32 ? D / 32 : 1;  // P V columns a lane owns
  constexpr int kGroupLanes = D / kNc;       // lanes covering D
  constexpr int kKg = 32 / kGroupLanes;      // P V key groups of a warp
  constexpr int kKq = kF32Keys / (4 * kKg);  // 4-key steps of a group
  constexpr int kW = D + 4;  // a row's D accumulators, m, l and 2 of pad
  constexpr int kQ = D / 4;  // 16-byte groups of a row
  static_assert(kHalf % 4 == 0 && kKg <= 2 && kKq >= 1 && kRowsW % 4 == 0 &&
                    kRowsW <= 32,
                "head width");

  const int group = H / KV;
  const int rows = S * group;
  const int row_chunks = (rows + kRows - 1) / kRows;
  const int ci = blockIdx.x / row_chunks;  // row chunks of a chunk adjacent
  const int rc = blockIdx.x % row_chunks;
  const int r0 = rc * kRows;
  const int R = min(kRows, rows - r0);
  const int R4 = (R + 3) & ~3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kw4 = warp % kF32KeyWarps;  // the warp's key quarter
  // its rows: rb .. rb + nr - 1 (nr4 with the pad rows up to R4)
  const int RW = f32_warp_rows(R4);
  const int rb = warp / kF32KeyWarps * RW;
  const int nr = max(0, min(RW, R - rb));
  const int nr4 = max(0, min(RW, R4 - rb));

  const int span = spans[b];
  const long long kmax = span < 0 ? 0 : (span < T_len ? span : T_len);
  const long long c0 = (long long)ci * chunk;
  // chunk 0 always runs: it writes out for a slot that fits one chunk
  // (an empty span included)
  if (ci > 0 && c0 >= kmax) return;
  const long long c1 = kmax < c0 + chunk ? kmax : c0 + chunk;
  const int n_live = kmax > chunk ? (int)((kmax + chunk - 1) / chunk) : 1;
  const int n_tiles = (int)((c1 - c0 + kTile - 1) / kTile);
  const long long row = (long long)KV * D;  // elements between keys
  const float* kb = k + (long long)b * T_len * row + (long long)h * D;
  const float* vb = v + (long long)b * T_len * row + (long long)h * D;

  extern __shared__ __align__(16) float fsm[];
  float* ring = fsm;                              // kStages x (K, V)
  float* qs = ring + kStages * 2 * kTile * kLd;   // R4 x D
  float* pw = qs + R4 * D + warp * RW * kF32Ld;   // this warp's scores
  int* lims = reinterpret_cast<int*>(qs + R4 * D + kF32Warps * RW * kF32Ld);
  __shared__ int last;

  // q's rows (the pad rows up to R4 zero) and each row's key limit inside
  // the chunk: query j sees kpos < span - (S - 1) + j; pad rows none
  for (int e = tid; e < R4 * (D / 4); e += kF32Threads) {
    const int r = e / (D / 4), d = (e % (D / 4)) * 4;
    const int rr = r0 + (r < R ? r : 0);
    const int j = rr / group, g = rr % group;
    cp_async16(qs + r * D + d,
               q + (((long long)b * S + j) * H + h * group + g) * D + d,
               r < R ? 16 : 0);
  }
  for (int r = tid; r < R4; r += kF32Threads) {
    long long l = r < R ? (long long)span - (S - 1) + (r0 + r) / group : c0;
    l = l < c1 ? l : c1;
    lims[r] = (int)(l - c0);
  }
  // tile i of the chunk into stage i % kStages; keys past the chunk are
  // zero-filled and masked
  auto load_tile = [&](int i) {
    float* ks = ring + (i % kStages) * 2 * kTile * kLd;
    float* vs = ks + kTile * kLd;
    const long long t0 = c0 + (long long)i * kTile;
    for (int e = tid; e < kTile * (D / 4); e += kF32Threads) {
      const int kk = e / (D / 4), d = (e % (D / 4)) * 4;
      const bool in = t0 + kk < c1;
      const long long off = (in ? t0 + kk : 0) * row + d;
      cp_async16(ks + kk * kLd + d, kb + off, in ? 16 : 0);
      cp_async16(vs + kk * kLd + d, vb + off, in ? 16 : 0);
    }
  };
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();  // q rides with tile 0
  if (n_tiles > 1) load_tile(1);
  cp_async_commit();

  const int kj = lane & 15, kh = lane >> 4;  // scores: key, half of D
  const int kg = lane / kGroupLanes;         // P V: key group, columns
  const int cc = (lane % kGroupLanes) * kNc;
  float acc[kRowsW][kNc];  // the warp's rows rb + r
#pragma unroll
  for (int r = 0; r < kRowsW; ++r)
#pragma unroll
    for (int c = 0; c < kNc; ++c) acc[r][c] = 0.f;
  // row rb + lane: running max and sum
  float m_own = -FLT_MAX;
  float l_own = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<1>();  // tile i has landed (one newer group may fly)
    __syncthreads();     // ... for every thread; tile i - 1 is consumed
    if (i + 2 < n_tiles) load_tile(i + 2);
    cp_async_commit();   // an empty group keeps the count uniform
    if (nr == 0) continue;  // a row-half warp with no row only copies
    const float* ks = ring + (i % kStages) * 2 * kTile * kLd;
    const float* vs = ks + kTile * kLd;
    const int kw = kw4 * kF32Keys;          // the warp's first key
    const int kpos = i * kTile + kw + kj;   // this lane's key, from c0

    // scores q . k / sqrt(D), masked keys at -FLT_MAX, into pw
    float kr[kHalf];
#pragma unroll
    for (int t = 0; t < kHalf / 4; ++t) {
      const float4 x = *reinterpret_cast<const float4*>(
          ks + (kw + kj) * kLd + kh * kHalf + 4 * t);
      kr[4 * t] = x.x;
      kr[4 * t + 1] = x.y;
      kr[4 * t + 2] = x.z;
      kr[4 * t + 3] = x.w;
    }
#pragma unroll
    for (int rg = 0; rg < kRowsW / 4; ++rg) {
      if (rg * 4 >= nr) break;
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int t = 0; t < kHalf / 4; ++t)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 qv = *reinterpret_cast<const float4*>(
              qs + (rb + rg * 4 + u) * D + kh * kHalf + 4 * t);
          dot[u] = fmaf(qv.x, kr[4 * t], dot[u]);
          dot[u] = fmaf(qv.y, kr[4 * t + 1], dot[u]);
          dot[u] = fmaf(qv.z, kr[4 * t + 2], dot[u]);
          dot[u] = fmaf(qv.w, kr[4 * t + 3], dot[u]);
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = rg * 4 + u;
        const float full = dot[u] + __shfl_xor_sync(0xffffffffu, dot[u], 16);
        if (kh == 0)
          pw[r * kF32Ld + kj] =
              kpos < lims[rb + r] ? full / sqrt_d : -FLT_MAX;
      }
    }
    __syncwarp();

    // online softmax: lane r rescales row rb + r's 16 scores to
    // probabilities and leaves the row's rescale of its accumulators
    // beside them
    if (lane < nr4) {
      float* pr = pw + lane * kF32Ld;
      float sv[kF32Keys];
#pragma unroll
      for (int t = 0; t < kF32Keys / 4; ++t) {
        const float4 x = *reinterpret_cast<const float4*>(pr + 4 * t);
        sv[4 * t] = x.x;
        sv[4 * t + 1] = x.y;
        sv[4 * t + 2] = x.z;
        sv[4 * t + 3] = x.w;
      }
      float mx = m_own;
#pragma unroll
      for (int jj = 0; jj < kF32Keys; ++jj) mx = fmaxf(mx, sv[jj]);
      const float alpha = expf(m_own - mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kF32Keys; ++jj) {
        sv[jj] = expf(sv[jj] - mx);
        sum += sv[jj];
      }
      m_own = mx;
      l_own = l_own * alpha + sum;
#pragma unroll
      for (int t = 0; t < kF32Keys / 4; ++t)
        *reinterpret_cast<float4*>(pr + 4 * t) = make_float4(
            sv[4 * t], sv[4 * t + 1], sv[4 * t + 2], sv[4 * t + 3]);
      pr[kF32Keys] = alpha;
    }
    __syncwarp();

    // acc = acc * alpha + P V over the lane's key group and columns
#pragma unroll
    for (int r = 0; r < kRowsW; ++r) {
      if (r >= nr) break;
      const float a = pw[r * kF32Ld + kF32Keys];
#pragma unroll
      for (int c = 0; c < kNc; ++c) acc[r][c] *= a;
    }
#pragma unroll
    for (int kq = 0; kq < kKq; ++kq) {
      // key groups interleave by 4 keys, so at D = 16 the two groups'
      // V rows fall on different banks
      const int j0 = (kq * kKg + kg) * 4;
      float vv[4][kNc];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = vs + (kw + j0 + u) * kLd + cc;
        if constexpr (kNc == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vr);
          vv[u][0] = x.x;
          vv[u][1] = x.y;
          vv[u][2] = x.z;
          vv[u][3] = x.w;
        } else if constexpr (kNc == 2) {
          const float2 x = *reinterpret_cast<const float2*>(vr);
          vv[u][0] = x.x;
          vv[u][1] = x.y;
        } else {
          vv[u][0] = vr[0];
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsW; ++r) {
        if (r >= nr) break;
        const float4 p = *reinterpret_cast<const float4*>(pw + r * kF32Ld + j0);
#pragma unroll
        for (int c = 0; c < kNc; ++c) {
          float x = acc[r][c];
          x = fmaf(p.x, vv[0][c], x);
          x = fmaf(p.y, vv[1][c], x);
          x = fmaf(p.z, vv[2][c], x);
          x = fmaf(p.w, vv[3][c], x);
          acc[r][c] = x;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' states now

  if constexpr (kKg == 2) {
#pragma unroll
    for (int r = 0; r < kRowsW; ++r)
#pragma unroll
      for (int c = 0; c < kNc; ++c)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 16);
  }
  // key quarter x R4 rows x (acc, m, l, pad): each row of a quarter is
  // one warp's
  float* mw = ring + (kw4 * R4 + rb) * kW;
  if (lane < nr) {
    mw[lane * kW + D] = m_own;
    mw[lane * kW + D + 1] = l_own;
  }
  if (kg == 0) {
#pragma unroll
    for (int r = 0; r < kRowsW; ++r) {
      if (r >= nr) break;
#pragma unroll
      for (int c = 0; c < kNc; ++c) mw[r * kW + cc + c] = acc[r][c];
    }
  }
  __syncthreads();

  // The warps' states merged, one thread per 4 columns of a row: out
  // directly when the slot's span fits one chunk, else this chunk's
  // partials.
  const bool direct = n_live <= 1;
  const long long bh = (long long)b * KV + h;
  float* wsb = ws + ((bh * n_chunks + ci) * rows + r0) * kW;
  for (int e = tid; e < R * kQ; e += kF32Threads) {
    const int r = e / kQ, d = (e % kQ) * 4;
    float mx = -FLT_MAX;
#pragma unroll
    for (int w = 0; w < kF32KeyWarps; ++w)
      mx = fmaxf(mx, fsm[(w * R4 + r) * kW + D]);
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kF32KeyWarps; ++w) {
      const float* x = fsm + (w * R4 + r) * kW;
      const float wt = expf(x[D] - mx);
      const float4 xa = *reinterpret_cast<const float4*>(x + d);
      l = fmaf(wt, x[D + 1], l);
      a = make_float4(fmaf(wt, xa.x, a.x), fmaf(wt, xa.y, a.y),
                      fmaf(wt, xa.z, a.z), fmaf(wt, xa.w, a.w));
    }
    if (direct) {
      store_row4<D>(out, b, S, H, group, h, r0 + r, d, a, l);
    } else {
      *reinterpret_cast<float4*>(wsb + r * kW + d) = a;
      if (d == 0) {
        wsb[r * kW + D] = mx;
        wsb[r * kW + D + 1] = l;
      }
    }
  }
  if (direct) return;

  // the last of the slot's n_live chunks to arrive combines them
  __threadfence();  // this block's partials are visible before its count
  __syncthreads();
  if (tid == 0) {
    int* cnt = counters + bh * row_chunks + rc;
    last = atomicAdd(cnt, 1) == n_live - 1;
    if (last) *cnt = 0;  // all of this launch's chunks arrived
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // each thread keeps its items' running (m, l, acc) over the chunks, so
  // every chunk's loads of all its items are in flight together
  constexpr int kItems =
      (kRowsW * kRowWarps * kQ + kF32Threads - 1) / kF32Threads;
  const float* wb = ws + (bh * n_chunks * rows + r0) * kW;
  const long long stride = (long long)rows * kW;  // between chunks
  float rm[kItems], rl[kItems];
  float4 ra[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    rm[it] = -FLT_MAX;
    rl[it] = 0.f;
    ra[it] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll 2
  for (int c = 0; c < n_live; ++c) {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int e = tid + it * kF32Threads;
      if (e < R * kQ) {
        const float* w = wb + c * stride + (e / kQ) * kW;
        const float mc = __ldcg(w + D);
        const float lc = __ldcg(w + D + 1);
        const float4 xc =
            __ldcg(reinterpret_cast<const float4*>(w + (e % kQ) * 4));
        const float mn = fmaxf(rm[it], mc);
        const float so = expf(rm[it] - mn), sc = expf(mc - mn);
        rl[it] = fmaf(sc, lc, rl[it] * so);
        ra[it] = make_float4(fmaf(sc, xc.x, ra[it].x * so),
                             fmaf(sc, xc.y, ra[it].y * so),
                             fmaf(sc, xc.z, ra[it].z * so),
                             fmaf(sc, xc.w, ra[it].w * so));
        rm[it] = mn;
      }
    }
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int e = tid + it * kF32Threads;
    if (e < R * kQ)
      store_row4<D>(out, b, S, H, group, h, r0 + e / kQ, (e % kQ) * 4,
                    ra[it], rl[it]);
  }
}

template <int D>
int launch_f32_split(const void* q, const void* k, const void* v,
                     const int32_t* spans, void* out, float* ws,
                     int* counters, int B, int S, int H, int KV,
                     long long T_len, int chunk, int n_chunks, float sqrt_d,
                     cudaStream_t stream) {
  constexpr int kRows = f32_rows(D);
  const int rows = S * (H / KV);
  const int row_chunks = (rows + kRows - 1) / kRows;
  const int R4 = ((rows < kRows ? rows : kRows) + 3) & ~3;
  const size_t smem = f32_smem_bytes<D>(R4);
  const int row_warps = f32_row_warps(R4);
  auto kern = row_warps == 1 ? paged_f32_split_kernel<D, 1>
                             : paged_f32_split_kernel<D, 2>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(n_chunks * row_chunks, KV, B), kF32KeyWarps * row_warps * 32,
         smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), spans, static_cast<float*>(out), ws,
      counters, S, H, KV, T_len, chunk, n_chunks, sqrt_d);
  return (int)cudaGetLastError();
}

static_assert(kMaxD == 128, "head widths are instantiated up to 128");

}  // namespace

extern "C" {

const char* sml_pa_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// q, out (B, S, H, D); k, v (B, T, KV, D); spans (B,) int32; all contiguous
// and 16-byte aligned.  dtype: 0 float32, 1 bfloat16, 2 float16.  sqrt_d is sqrt(D)
// rounded to f32, the divisor of the scores.
int sml_paged_decode_attention(const void* q, const void* k, const void* v,
                               const int32_t* spans, void* out, int B, int S,
                               int H, int KV, int D, long long T_len,
                               int dtype, float sqrt_d, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || T_len < 1 || B > 65535 ||
      (S * (H / KV) + kMaxRows - 1) / kMaxRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, spans, out, B, S, H, KV, T_len, sqrt_d, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, spans, out, B, S, H, KV, T_len,
                                   sqrt_d, st);
  if (dtype == 2)
    return launch_d<__half>(D, q, k, v, spans, out, B, S, H, KV, T_len, sqrt_d, st);
  return (int)cudaErrorInvalidValue;
}

// The split kernel and its combine, for dtype 1 (bfloat16) or 2 (float16).
// ws holds B * KV * n_split * S * (H / KV) * (D + 2) floats, n_split =
// ceil(T / SML_PA_SPLIT); only chunks inside a slot's span are written and
// read.  Other arguments as above.
int sml_paged_decode_attention_split(const void* q, const void* k,
                                     const void* v, const int32_t* spans,
                                     void* out, void* ws, int B, int S, int H,
                                     int KV, int D, long long T_len,
                                     int n_split, int dtype, float sqrt_d,
                                     void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || T_len < 1 || B > 65535 ||
      KV > 65535 || n_split != (T_len + kSplit - 1) / kSplit ||
      (long long)n_split * ((S * (H / KV) + kMaxRows - 1) / kMaxRows) >
          2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* w = static_cast<float*>(ws);
  if (dtype == 1)
    return launch_split_d<__nv_bfloat16>(D, q, k, v, spans, out, w, B, S, H,
                                         KV, T_len, n_split, sqrt_d, st);
  if (dtype == 2)
    return launch_split_d<__half>(D, q, k, v, spans, out, w, B, S, H, KV,
                                  T_len, n_split, sqrt_d, st);
  return (int)cudaErrorInvalidValue;
}


// The f32 split kernel, combine included, for float32.  chunk is the chunk
// length the rule above gives for these shapes (f32_chunk_keys, with the
// row chunks of f32_rows(D)); ws holds B * KV * ceil(T / chunk) * S *
// (H / KV) * (D + 4) floats, only chunks inside a slot's span are written
// and read; counters holds B * KV * row chunks int32, zero before the call
// and zero after it.  Other arguments as above.
int sml_paged_decode_attention_split_f32(const void* q, const void* k,
                                         const void* v, const int32_t* spans,
                                         void* out, void* ws, void* counters,
                                         int B, int S, int H, int KV, int D,
                                         long long T_len, int chunk,
                                         float sqrt_d, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || T_len < 1 || B > 65535 ||
      KV > 65535 || T_len > 2147483647LL || D < 16 || D > kMaxD ||
      (D & (D - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)S * (H / KV);
  const long long row_chunks = (rows + f32_rows(D) - 1) / f32_rows(D);
  if (chunk != f32_chunk_keys(B, KV, T_len, row_chunks))
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = (T_len + chunk - 1) / chunk;
  if (n_chunks * row_chunks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  switch (D) {
    case 16:
      return launch_f32_split<16>(q, k, v, spans, out, w, c, B, S, H, KV,
                                  T_len, chunk, (int)n_chunks, sqrt_d, st);
    case 32:
      return launch_f32_split<32>(q, k, v, spans, out, w, c, B, S, H, KV,
                                  T_len, chunk, (int)n_chunks, sqrt_d, st);
    case 64:
      return launch_f32_split<64>(q, k, v, spans, out, w, c, B, S, H, KV,
                                  T_len, chunk, (int)n_chunks, sqrt_d, st);
    default:
      return launch_f32_split<128>(q, k, v, spans, out, w, c, B, S, H, KV,
                                   T_len, chunk, (int)n_chunks, sqrt_d, st);
  }
}

}  // extern "C"

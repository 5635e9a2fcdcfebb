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
// What the Pallas kernel computes, and how this one differs in form:
//
// - One block per (kv head, slot, chunk of query rows).  The S * group query
//   rows of a kv head (row r = j * group + g holds query j of head
//   h * group + g, the Pallas kernel's head-major row order) are split into
//   chunks of at most kMaxRows; a block keeps its chunk in shared memory as
//   f32 and loops over key tiles of kTile keys with the DYNAMIC bound
//   ceil(min(span, max_len) / kTile).  The TPU's power-of-two span buckets and
//   clamped index map existed for XLA's static grid; a CUDA block simply
//   stops at its slot's span, so short slots cost no reads past their span.
// - Each tile of K and V is read from device memory once per chunk, widened
//   to f32 in shared memory (rows padded to D + 1 floats, so the per-key dot
//   products of one warp hit distinct banks); keys past the span are never
//   read and their shared-memory rows are zero.  Up to kMaxRows rows (the
//   decode step and the engine's usual verify widths) make one chunk, so the
//   span is read once per kv head; a wider verify step reads it once per
//   chunk, the later reads mostly from L2.
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
// the arithmetic is 4 * S * group * span * D flops per (slot, kv head), far
// below the tensor-core rate at the engine's S * group <= 64 rows.  This
// first version is plain: one block per (slot, kv head, row chunk) and no
// copy/compute overlap, so a long
// span is read by one SM at the latency of one tile per iteration; splitting
// the span across blocks (flash-decoding) and TMA/cp.async pipelining are
// left to a later change.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

// The limits come from the build (DEFINES in kernels/_build.py), where the
// Python wrapper reads them too: query rows per block (wider S * group is
// split across blocks) and the largest head width.
#if !defined(SML_PA_MAX_ROWS) || !defined(SML_PA_MAX_D)
#error "build with -DSML_PA_MAX_ROWS=... -DSML_PA_MAX_D=... (kernels/_build.py)"
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

}  // extern "C"

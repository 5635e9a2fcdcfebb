// GBDT histogram kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two Pallas TPU kernels of synapseml_tpu/models/gbdt/pallas_hist.py:
//
//   K1  build_hist_nodes_pallas  (kernel _make_hist_nodes_kernel)
//       node-batched histograms: every row with slot s in [0, S) adds its
//       7 live int8 limbs (g0 g1 g2 h0 h1 h2 count) to hist[f][bin >> shift][s].
//   K2  route_and_hist_pallas    (kernel _make_fused_kernel)
//       one pass per depthwise wave: route each row of leaf[j] left iff
//       x in (rlo, rhi] ? x <= t1 : dflt (x from the pre-gathered split row
//       sel[j]), write its new node id, and add the left children's limbs to
//       the coarse (bin >> shift) histograms of all F features and, when
//       sel_k is given, to the full-resolution histograms of the K refined
//       features -- one routing for both.
//
// What the TPU kernels compute is exact int32 sums of int8 limbs; the
// one-hot x limbs matmul was only the TPU's way to scatter.  Here each block
// scatters with shared-memory int32 atomics and flushes its non-zero cells to
// the (nfeat, width, S, 8) int32 output with global atomics.  Integer sums do
// not depend on order, so the output is bit-identical to the plain PyTorch
// version (index_add_ into int64) whatever order the atomics land in.
//
// Bound on the H100: bytes.  A pass reads each bin once (4 B per feature and
// row), the routing inputs (node id 4 B, one gathered split bin 4 B) and the
// limbs (8 B) per row, and writes the new id (4 B per row) and the small
// histograms; the arithmetic is a few integer adds per byte.  The design
// reads bins coalesced (consecutive threads take consecutive rows of one
// feature row) and keeps every partial sum in shared memory, so device
// memory sees each bin once.  The grid is (row blocks) x (feature groups):
// a feature group is as many features as fit a shared-memory budget, and the
// row-block count is chosen so the grid fills the SMs without flushing a
// histogram per few thousand rows.  Each feature group re-derives its rows'
// slots (K2 re-reads node id, split bin and limbs per group) -- the price of
// keeping one block's histograms in shared memory; fusing further is left to
// a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLive = 7;        // g0 g1 g2 h0 h1 h2 count
constexpr int kLanesOut = 8;    // output lanes (last one is the zero pad)
constexpr int kThreads = 512;
// dynamic shared memory a block asks for when several features fit
constexpr int kTargetSmem = 96 * 1024;

// The limits come from the build (DEFINES in kernels/_build.py), where the
// Python wrappers read them too: most slots per launch, and the dynamic
// shared memory a block may take (the H100's 227 KB less `prm` below).
#if !defined(SML_MAX_SLOTS) || !defined(SML_MAX_SMEM)
#error "build with -DSML_MAX_SLOTS=... -DSML_MAX_SMEM=... (kernels/_build.py)"
#endif
constexpr int kMaxSlots = SML_MAX_SLOTS;
constexpr int kMaxSmem = SML_MAX_SMEM;

struct HistSrc {
  const int32_t* bins;  // (nfeat, N) row-major
  int32_t* out;         // (nfeat, width, S, 8)
  int nfeat;
  int width;            // histogram bins per feature
  int shift;            // bin >> shift before binning into `width`
  int fpb;              // features per block
  int groups;           // ceil(nfeat / fpb)
};

template <bool kRoute>
__global__ void __launch_bounds__(kThreads, 2)
hist_kernel(HistSrc src0, HistSrc src1, long long N, int S,
            const int32_t* __restrict__ slot_in,   // K1: (N,) in [-1, S)
            const int32_t* __restrict__ node_id,   // K2: (N,)
            const int32_t* __restrict__ params,    // K2: (7, S)
            const int32_t* __restrict__ sel,       // K2: (S, N)
            const int8_t* __restrict__ vals,       // (N, 8)
            int32_t* __restrict__ new_id) {        // K2: (N,)
  extern __shared__ int32_t sh[];
  __shared__ int32_t prm[7 * kMaxSlots];  // leaf t1 rlo rhi dflt l_id r_id

  const int gy = blockIdx.y;
  const bool first = gy < src0.groups;
  const HistSrc s = first ? src0 : src1;
  const int f0 = (first ? gy : gy - src0.groups) * s.fpb;
  const int nf = min(s.fpb, s.nfeat - f0);
  const int cells = nf * s.width * S * kLive;

  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0;
  if (kRoute) {
    for (int i = threadIdx.x; i < 7 * S; i += blockDim.x) prm[i] = params[i];
  }
  __syncthreads();

  const bool write_id = kRoute && gy == 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < N;
       r += stride) {
    int slot = -1;
    if (kRoute) {
      // the Pallas kernel's slot loop: later slots win, a row outside every
      // pending leaf keeps its id and gets no slot
      const int nid = node_id[r];
      int nw = nid;
      for (int j = 0; j < S; ++j) {
        if (nid != prm[j]) continue;
        const int xb = sel[(long long)j * N + r];
        const bool in_range = xb > prm[2 * S + j] && xb <= prm[3 * S + j];
        const bool gl = in_range ? (xb <= prm[S + j]) : (prm[4 * S + j] != 0);
        nw = gl ? prm[5 * S + j] : prm[6 * S + j];
        if (gl) slot = j;
      }
      if (write_id) new_id[r] = nw;
    } else {
      slot = slot_in[r];
    }
    if (slot < 0 || slot >= S) continue;

    const char4 a = reinterpret_cast<const char4*>(vals)[2 * r];
    const char4 b = reinterpret_cast<const char4*>(vals)[2 * r + 1];
    const int v[kLive] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z};
    if ((v[0] | v[1] | v[2] | v[3] | v[4] | v[5] | v[6]) == 0) continue;

    for (int fl = 0; fl < nf; ++fl) {
      // a bin outside [0, width) matches no one-hot row on the TPU either
      const unsigned bin =
          (unsigned)(s.bins[(long long)(f0 + fl) * N + r] >> s.shift);
      if (bin >= (unsigned)s.width) continue;
      int32_t* cell = sh + ((fl * s.width + (int)bin) * S + slot) * kLive;
#pragma unroll
      for (int k = 0; k < kLive; ++k) {
        if (v[k]) atomicAdd(cell + k, v[k]);
      }
    }
  }
  __syncthreads();

  // cell i = ((fl * width + bin) * S + slot) * 7 + lane; the output keeps the
  // same (feature, bin, slot) order with 8 lanes
  int32_t* out = s.out + (long long)f0 * s.width * S * kLanesOut;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int32_t x = sh[i];
    if (x == 0) continue;
    atomicAdd(out + (long long)(i / kLive) * kLanesOut + (i % kLive), x);
  }
}

HistSrc make_src(const int32_t* bins, int32_t* out, int nfeat, int width,
                 int shift, int S) {
  HistSrc h{bins, out, nfeat, width, shift, 0, 0};
  if (nfeat <= 0) return h;
  const long long per = (long long)width * S * kLive * 4;
  int fpb = (int)(kTargetSmem / per);
  fpb = fpb < 1 ? 1 : (fpb > nfeat ? nfeat : fpb);
  h.fpb = fpb;
  h.groups = (nfeat + fpb - 1) / fpb;
  return h;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <bool kRoute>
int launch(HistSrc s0, HistSrc s1, long long N, int S, const int32_t* slot,
           const int32_t* node_id, const int32_t* params, const int32_t* sel,
           const int8_t* vals, int32_t* new_id, cudaStream_t stream) {
  if (S < 1 || S > kMaxSlots || N < 0) return (int)cudaErrorInvalidValue;
  long long smem0 = (long long)s0.fpb * s0.width * S * kLive * 4;
  long long smem1 = (long long)s1.fpb * s1.width * S * kLive * 4;
  const long long smem = smem0 > smem1 ? smem0 : smem1;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  const int groups = s0.groups + s1.groups;
  if (groups == 0 || N == 0) return (int)cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      hist_kernel<kRoute>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  // about two resident blocks per SM over the whole grid, and no fewer than
  // 8 rows per thread in a block, so each block's flush is amortized
  long long bx = (2LL * sm_count() + groups - 1) / groups;
  const long long by_rows = (N + 8LL * kThreads - 1) / (8LL * kThreads);
  if (bx > by_rows) bx = by_rows;
  if (bx < 1) bx = 1;
  dim3 grid((unsigned)bx, (unsigned)groups);
  hist_kernel<kRoute><<<grid, kThreads, (size_t)smem, stream>>>(
      s0, s1, N, S, slot, node_id, params, sel, vals, new_id);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sml_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// K1: out (F, Bh, S, 8) int32, zeroed by the caller.
int sml_hist_nodes(const int32_t* bins, int F, long long N,
                   const int32_t* slot, const int8_t* vals, int S, int Bh,
                   int shift, int32_t* out, void* stream) {
  HistSrc s0 = make_src(bins, out, F, Bh, shift, S);
  HistSrc s1 = make_src(nullptr, nullptr, 0, 1, 0, S);
  return launch<false>(s0, s1, N, S, slot, nullptr, nullptr, nullptr, vals,
                       nullptr, (cudaStream_t)stream);
}

// K2: new_id (N,), out (F, Bh, S, 8) and, when K > 0, outf (K, B, S, 8);
// both histogram outputs zeroed by the caller.  params is (7, S) int32:
// leaf, t1, rlo, rhi, dflt, l_id, r_id.
int sml_route_and_hist(const int32_t* bins, int F, long long N,
                       const int32_t* node_id, const int32_t* params, int S,
                       const int32_t* sel, const int8_t* vals,
                       const int32_t* selk, int K, int B, int Bh, int shift,
                       int32_t* new_id, int32_t* out, int32_t* outf,
                       void* stream) {
  HistSrc s0 = make_src(bins, out, F, Bh, shift, S);
  HistSrc s1 = make_src(selk, outf, K, B, 0, S);
  if (F < 1) return (int)cudaErrorInvalidValue;  // new_id rides group 0
  return launch<true>(s0, s1, N, S, nullptr, node_id, params, sel, vals,
                      new_id, (cudaStream_t)stream);
}

}  // extern "C"

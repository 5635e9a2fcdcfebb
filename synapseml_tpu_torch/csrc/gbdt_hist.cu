// GBDT histogram kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two Pallas TPU kernels of synapseml_tpu/models/gbdt/pallas_hist.py:
//
//   K1  build_hist_nodes_pallas  (kernel _make_hist_nodes_kernel)
//       node-batched histograms: every row with slot s in [0, S) adds its
//       7 live int8 limbs (g0 g1 g2 h0 h1 h2 count) to hist[f][bin >> shift][s].
//   K2  route_and_hist_pallas    (kernel _make_fused_kernel)
//       one pass per depthwise wave: route each row of leaf[j] left iff
//       x in (rlo, rhi] ? x <= t1 : dflt (x the row's bin of split feature
//       j), write its new node id, and add the left children's limbs to
//       the coarse (bin >> shift) histograms of all F features and, in
//       two-level mode, to the full-resolution histograms of the K refined
//       features -- one routing for both.
//
// What the TPU kernels compute is exact int32 sums of int8 limbs; the
// one-hot x limbs matmul was only the TPU's way to scatter.  Here a block
// scatters with shared-memory int32 atomics and flushes its non-zero cells
// to the (nfeat, width, S, 8) int32 output with global atomics.  Integer
// sums do not depend on order, so the output is bit-identical to the plain
// PyTorch version (index_add_ into int64) whatever order the atomics land in.
//
// Bound on the H100: bytes.  A wave reads the node id (4 B), one split bin
// (4 B) and, for each row routed left, its limbs (8 B) and one bin per
// feature (4 B), and writes the new id (4 B per row) and the small
// histograms; the arithmetic is a few integer adds per byte.  The design,
// step by step, and what each step does about the bytes and their latency:
//
// 1. Route once (route_kernel).  One pass over the rows computes each row's
//    new node id and left-child slot (the Pallas slot loop: later slots
//    win, a row outside every pending leaf keeps its id) and appends the
//    rows that go left to a compacted list of (row, slot) pairs.  Each
//    block ballots its rows, scans the counts and takes its place in the
//    list with ONE global atomic, so its rows land in ascending order and
//    later gathers stay sector-efficient.  The split bin is read from a row
//    table -- an (R, N) base and an (S,) row index -- so the caller passes
//    the binned matrix and the split features' ids and gathers nothing.
//    K1 compacts through the same kernel from a given slot array.
// 2. One histogram pass for both (hist_rows_kernel).  The grid is (list
//    tiles) x (feature groups); a block walks its tiles of the list, so
//    only rows with a slot cost work and no lane idles on a row that has
//    none.  The previous kernel re-routed every row once per feature group.
// 3. Loads in flight.  A tile's list entries, then the rows' limbs and each
//    group feature's bin, come into shared memory through a cp.async ring:
//    the next tile's gathers (tile x (8 + 4 x features) bytes, ~24-32 KB
//    per SM) fly while the block scatters the current tile from shared
//    memory, so the pass waits on bandwidth, not on one row's chain of
//    dependent loads.
// 4. Histograms in shared memory up to what the ring leaves of the 227 KB
//    a block may take, so the wide levels need few feature groups; a
//    full-resolution feature at 256 bins x 16 slots (114.7 KB) takes a
//    block of its own.  The wrapper (models/gbdt/hist.py, rows_geometry)
//    chooses features per block and the tile and passes them in; blocks
//    spread over the groups in proportion to their features.
//
// The scatter's shared int32 atomics (7 per row and feature) then bound a
// root pass, where every row is listed.  Packing a cell's three g digits
// into one 64-bit word (d0 + d1 * 2^21 + d2 * 2^42, likewise h) would cut
// them to 3, but sm_90a has no native 64-bit shared add: it compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN.64), which measured slower.
//
// The previous kernel (hist_kernel_previous, entry points *_previous) stays
// as a same-run yardstick: grid (row blocks) x (feature groups), each group
// re-deriving every row's slot.  No main path calls it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLive = 7;        // g0 g1 g2 h0 h1 h2 count
constexpr int kLanesOut = 8;    // output lanes (last one is the zero pad)
constexpr int kThreads = 512;
// the previous kernel: dynamic shared memory a block asks for when several
// features fit
constexpr int kTargetSmem = 96 * 1024;

// The limits come from the build (DEFINES in kernels/_build.py), where the
// Python wrappers read them too: most slots per launch, and the dynamic
// shared memory a block may take (the H100's 227 KB less the previous
// kernel's static routing table).
#if !defined(SML_MAX_SLOTS) || !defined(SML_MAX_SMEM)
#error "build with -DSML_MAX_SLOTS=... -DSML_MAX_SMEM=... (kernels/_build.py)"
#endif
constexpr int kMaxSlots = SML_MAX_SLOTS;
constexpr int kMaxSmem = SML_MAX_SMEM;

// route_kernel: 512 threads x 4 rows = 2048 rows per block
constexpr int kRouteThreads = 512;
constexpr int kRouteRows = 4;
constexpr int kRouteWarps = kRouteThreads / 32;
// hist_rows_kernel: most features one block histograms (its feature-row
// table is static shared memory)
constexpr int kMaxFpb = 64;

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

// ---------------------------------------------------------------------------
// Step 1: route once
// ---------------------------------------------------------------------------

// Route mode (node_id given): params is (8, S) int32, rows leaf t1 rlo rhi
// dflt l_id r_id row; row[j] is the row of `base` ((R, N) int32) that holds
// split j's bins.  Writes new_id and appends each row routed left.
// Compact mode (node_id null): appends each row whose slot_in is in [0, S).
// The list holds (row, slot) pairs; *count (zeroed by the caller) ends as
// their number.
__global__ void __launch_bounds__(kRouteThreads)
route_kernel(long long N, int S, const int32_t* __restrict__ node_id,
             const int32_t* __restrict__ params,
             const int32_t* __restrict__ base,
             const int32_t* __restrict__ slot_in,
             int32_t* __restrict__ new_id, int2* __restrict__ list,
             int32_t* __restrict__ count) {
  __shared__ int32_t prm[8 * kMaxSlots];
  __shared__ int32_t woff[kRouteRows][kRouteWarps];
  __shared__ int32_t block_base;
  const bool route = node_id != nullptr;
  if (route) {
    for (int i = threadIdx.x; i < 8 * S; i += blockDim.x) prm[i] = params[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r0 = (long long)blockIdx.x * kRouteThreads * kRouteRows;
  // split j sends bin x left iff x in (rlo, rhi] ? x <= t1 : dflt
  auto goes_left = [&](int x, int j) {
    return (x > prm[2 * S + j] && x <= prm[3 * S + j]) ? x <= prm[S + j]
                                                       : prm[4 * S + j] != 0;
  };
  // each stage issues its rows' loads together, so a thread has up to
  // kRouteRows of them in flight
  int v[kRouteRows];
#pragma unroll
  for (int k = 0; k < kRouteRows; ++k) {
    const long long r = r0 + k * kRouteThreads + threadIdx.x;
    v[k] = r < N ? (route ? node_id[r] : slot_in[r]) : -1;
  }
  int slot[kRouteRows];
  if (route) {
    // the Pallas kernel's slot loop: the last pending leaf holding the row
    // sets its id, the last one that sends it left its slot.  hit bit j:
    // the row is in leaf j; the split bin of the last such leaf is read
    unsigned long long hit[kRouteRows];
    int xb[kRouteRows];
#pragma unroll
    for (int k = 0; k < kRouteRows; ++k) {
      const long long r = r0 + k * kRouteThreads + threadIdx.x;
      hit[k] = 0;
      if (r < N) {
        for (int j = 0; j < S; ++j) {
          if (v[k] == prm[j]) hit[k] |= 1ull << j;
        }
      }
      const int jl = 63 - __clzll(hit[k]);
      xb[k] = hit[k] ? base[(long long)prm[7 * S + jl] * N + r] : 0;
    }
#pragma unroll
    for (int k = 0; k < kRouteRows; ++k) {
      const long long r = r0 + k * kRouteThreads + threadIdx.x;
      int s = -1;
      if (hit[k]) {
        const int jl = 63 - __clzll(hit[k]);
        const bool gl = goes_left(xb[k], jl);
        if (gl) {
          s = jl;
        } else {
          // an earlier slot on the same leaf id may still send it left
          for (unsigned long long m = hit[k] & ~(1ull << jl); m;) {
            const int j = 63 - __clzll(m);
            m &= ~(1ull << j);
            if (goes_left(base[(long long)prm[7 * S + j] * N + r], j)) {
              s = j;
              break;
            }
          }
        }
        new_id[r] = gl ? prm[5 * S + jl] : prm[6 * S + jl];
      } else if (r < N) {
        new_id[r] = v[k];
      }
      slot[k] = s;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRouteRows; ++k) slot[k] = v[k] < S ? v[k] : -1;
  }
  unsigned mask[kRouteRows];
#pragma unroll
  for (int k = 0; k < kRouteRows; ++k) {
    mask[k] = __ballot_sync(0xffffffffu, slot[k] >= 0);
    if (lane == 0) woff[k][warp] = __popc(mask[k]);
  }
  __syncthreads();
  // rows in ascending order: k-major, then warp, then lane
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < kRouteRows; ++k) {
      for (int w = 0; w < kRouteWarps; ++w) {
        const int c = woff[k][w];
        woff[k][w] = total;
        total += c;
      }
    }
    block_base = total ? atomicAdd(count, total) : 0;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kRouteRows; ++k) {
    if (slot[k] < 0) continue;
    const int pos = block_base + woff[k][warp] + __popc(mask[k] & below);
    list[pos] = make_int2((int)(r0 + k * kRouteThreads + threadIdx.x), slot[k]);
  }
}

// ---------------------------------------------------------------------------
// Steps 2-4: one histogram pass over the compacted rows
// ---------------------------------------------------------------------------

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
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct RowsSrc {
  const int32_t* bins;  // (R, N) row-major: the rows features come from
  const int32_t* feat;  // (nfeat,) rows of `bins`, or null: rows 0 .. nfeat-1
  int32_t* out;         // (nfeat, width, S, 8)
  int nfeat;
  int width;            // histogram bins per feature
  int shift;            // bin >> shift before binning into `width`
  int fpb;              // features per block
  int tile;             // list entries per tile, a power of two
  int groups;           // ceil(nfeat / fpb)
  int blocks;           // blocks per group, set at launch
};

// The ring: 3 stages of list entries (tile k + 2 lands while k + 1's rows
// are gathered and k is scattered) and 2 of limbs and bins.
__host__ __device__ inline long long hist_bytes(int fpb, int width, int S) {
  return ((long long)fpb * width * S * kLive * 4 + 15) / 16 * 16;
}
__host__ __device__ inline long long ring_bytes(int fpb, int tile) {
  return (long long)tile * (3 * 8 + 2 * 8 + 2 * 4 * fpb);
}
long long rows_smem(const RowsSrc& s, int S) {
  if (s.groups == 0) return 0;
  return hist_bytes(s.fpb, s.width, S) + ring_bytes(s.fpb, s.tile);
}

__global__ void __launch_bounds__(kThreads, 2)
hist_rows_kernel(RowsSrc src0, RowsSrc src1, long long N, int S,
                 const int2* __restrict__ list,
                 const int32_t* __restrict__ count_ptr,
                 const int8_t* __restrict__ vals) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long fbase[kMaxFpb];

  // blocks [0, groups0 * src0.blocks) take src0's groups, src0.blocks
  // each; the rest src1's
  const int n0 = src0.groups * src0.blocks;
  const bool first = (int)blockIdx.x < n0;
  const RowsSrc s = first ? src0 : src1;
  const int b = first ? blockIdx.x : blockIdx.x - n0;
  const int bx = b % s.blocks;               // this block's place in its group
  const int f0 = (b / s.blocks) * s.fpb;
  const int nf = min(s.fpb, s.nfeat - f0);
  const int T = s.tile;
  const int lgT = __ffs(T) - 1;
  const int count = *count_ptr;
  const int ntiles = (count + T - 1) / T;
  // this block's tiles: bx, bx + blocks, ...
  const int nt = ntiles > bx ? (ntiles - bx + s.blocks - 1) / s.blocks : 0;
  if (nt == 0) return;

  const int cells = nf * s.width * S * kLive;
  int32_t* hist = reinterpret_cast<int32_t*>(smem);
  int2* ent = reinterpret_cast<int2*>(smem + hist_bytes(s.fpb, s.width, S));
  int2* val = ent + 3 * T;                                 // 8 limbs a row
  int32_t* bns = reinterpret_cast<int32_t*>(val + 2 * T);  // (2, fpb, T)
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0;
  for (int i = threadIdx.x; i < nf; i += blockDim.x) {
    fbase[i] = (long long)(s.feat ? s.feat[f0 + i] : f0 + i) * N;
  }

  auto tile_start = [&](int k) -> long long {
    return ((long long)bx + (long long)k * s.blocks) * T;
  };
  auto tile_rows = [&](int k) -> int {
    return (int)min((long long)T, (long long)count - tile_start(k));
  };
  // list entries of tile k -> ent[k % 3], two per 16-byte copy (the list
  // holds two entries past N, so a pair never reads past it)
  auto load_entries = [&](int k) {
    if (k >= nt) return;
    const long long e0 = tile_start(k);
    int2* dst = ent + (k % 3) * T;
    for (int i = threadIdx.x; i < T / 2; i += blockDim.x) {
      const bool in = e0 + 2 * i < count;
      cp_async16(dst + 2 * i, in ? list + e0 + 2 * i : list, in ? 16 : 0);
    }
  };
  // limbs and group bins of tile k's rows -> val / bns[k % 2]
  auto load_rows = [&](int k) {
    if (k >= nt) return;
    const int n = tile_rows(k);
    const int2* e = ent + (k % 3) * T;
    int2* v = val + (k % 2) * T;
    int32_t* b = bns + (k % 2) * s.fpb * T;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      cp_async8(v + i, vals + 8LL * e[i].x);
    }
    for (int i = threadIdx.x; i < (nf << lgT); i += blockDim.x) {
      const int r = i & (T - 1);
      if (r >= n) continue;
      cp_async4(b + i, s.bins + fbase[i >> lgT] + e[r].x);
    }
  };

  load_entries(0);
  cp_async_commit();
  load_entries(1);
  cp_async_commit();
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile 0's entries
  __syncthreads();
  load_rows(0);
  cp_async_commit();

  for (int k = 0; k < nt; ++k) {
    // tile k's rows and tile k + 1's entries have landed, and every thread
    // is past tile k - 1's scatter, whose ring stages the loads below reuse
    cp_async_wait_all();
    __syncthreads();
    load_entries(k + 2);
    load_rows(k + 1);
    cp_async_commit();

    const int n = tile_rows(k);
    const int2* e = ent + (k % 3) * T;
    const int2* v = val + (k % 2) * T;
    const int32_t* b = bns + (k % 2) * s.fpb * T;
    for (int i = threadIdx.x; i < (nf << lgT); i += blockDim.x) {
      const int r = i & (T - 1);
      if (r >= n) continue;
      const int2 w = v[r];
      // lanes 0-6 live; lane 7 (the pad) is ignored
      if ((w.x | (w.y & 0x00ffffff)) == 0) continue;
      const unsigned bin = (unsigned)(b[i] >> s.shift);
      // a bin outside [0, width) matches no one-hot row on the TPU either
      if (bin >= (unsigned)s.width) continue;
      const int fl = i >> lgT;
      int32_t* cell = hist + ((fl * s.width + (int)bin) * S + e[r].y) * kLive;
      const int lv[kLive] = {
          (int)(int8_t)(w.x), (int)(int8_t)(w.x >> 8),
          (int)(int8_t)(w.x >> 16), (int)(int8_t)(w.x >> 24),
          (int)(int8_t)(w.y), (int)(int8_t)(w.y >> 8),
          (int)(int8_t)(w.y >> 16)};
#pragma unroll
      for (int q = 0; q < kLive; ++q) {
        if (lv[q]) atomicAdd(cell + q, lv[q]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // cell i = ((fl * width + bin) * S + slot) * 7 + lane; the output keeps
  // the same (feature, bin, slot) order with 8 lanes
  int32_t* out = s.out + (long long)f0 * s.width * S * kLanesOut;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int32_t x = hist[i];
    if (x == 0) continue;
    atomicAdd(out + (long long)(i / kLive) * kLanesOut + (i % kLive), x);
  }
}

RowsSrc make_rows_src(const int32_t* bins, const int32_t* feat, int32_t* out,
                      int nfeat, int width, int shift, int fpb, int tile) {
  RowsSrc h{bins, feat, out, nfeat, width, shift, fpb, tile, 0, 0};
  if (nfeat > 0 && fpb > 0) h.groups = (nfeat + fpb - 1) / fpb;
  return h;
}

bool rows_src_ok(const RowsSrc& s, int S) {
  if (s.groups == 0) return true;
  return s.fpb >= 1 && s.fpb <= kMaxFpb && s.tile >= 2 && s.tile <= 4096 &&
         (s.tile & (s.tile - 1)) == 0 && s.width >= 1 &&
         rows_smem(s, S) <= kMaxSmem;
}

int launch_route(long long N, int S, const int32_t* node_id,
                 const int32_t* params, const int32_t* base,
                 const int32_t* slot, int32_t* new_id, int2* list,
                 int32_t* count, cudaStream_t stream) {
  if (S < 1 || S > kMaxSlots || N < 0 || N >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const long long per = (long long)kRouteThreads * kRouteRows;
  route_kernel<<<(unsigned)((N + per - 1) / per), kRouteThreads, 0, stream>>>(
      N, S, node_id, params, base, slot, new_id, list, count);
  return (int)cudaGetLastError();
}

int launch_rows(RowsSrc s0, RowsSrc s1, long long N, int S, const int2* list,
                const int32_t* count, const int8_t* vals,
                cudaStream_t stream) {
  if (S < 1 || S > kMaxSlots || N < 0) return (int)cudaErrorInvalidValue;
  if (!rows_src_ok(s0, S) || !rows_src_ok(s1, S))
    return (int)cudaErrorInvalidConfiguration;
  const int groups = s0.groups + s1.groups;
  if (groups == 0 || N == 0) return (int)cudaSuccess;
  const long long m0 = rows_smem(s0, S), m1 = rows_smem(s1, S);
  const int smem = (int)(m0 > m1 ? m0 : m1);
  cudaError_t e = cudaFuncSetAttribute(
      hist_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hist_rows_kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) per_sm = 1;
  // every resident block walks the list: each group gets blocks in
  // proportion to its features (a row costs a block one bin per feature),
  // and no more than the list could have tiles
  const long long resident = (long long)per_sm * sm_count();
  const long long feats = (long long)s0.groups * s0.fpb +
                          (long long)s1.groups * s1.fpb;
  auto set_blocks = [&](RowsSrc& p) {
    if (p.groups == 0) return;
    long long bx = resident * p.fpb / feats;
    const long long tiles = (N + p.tile - 1) / p.tile;
    if (bx > tiles) bx = tiles;
    p.blocks = (int)(bx < 1 ? 1 : bx);
  };
  set_blocks(s0);
  set_blocks(s1);
  const long long blocks = (long long)s0.groups * s0.blocks +
                           (long long)s1.groups * s1.blocks;
  hist_rows_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(
      s0, s1, N, S, list, count, vals);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The previous kernel: a same-run yardstick, on no main path
// ---------------------------------------------------------------------------

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
hist_kernel_previous(HistSrc src0, HistSrc src1, long long N, int S,
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

  int32_t* out = s.out + (long long)f0 * s.width * S * kLanesOut;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int32_t x = sh[i];
    if (x == 0) continue;
    atomicAdd(out + (long long)(i / kLive) * kLanesOut + (i % kLive), x);
  }
}

HistSrc make_src_previous(const int32_t* bins, int32_t* out, int nfeat,
                          int width, int shift, int S) {
  HistSrc h{bins, out, nfeat, width, shift, 0, 0};
  if (nfeat <= 0) return h;
  const long long per = (long long)width * S * kLive * 4;
  int fpb = (int)(kTargetSmem / per);
  fpb = fpb < 1 ? 1 : (fpb > nfeat ? nfeat : fpb);
  h.fpb = fpb;
  h.groups = (nfeat + fpb - 1) / fpb;
  return h;
}

template <bool kRoute>
int launch_previous(HistSrc s0, HistSrc s1, long long N, int S,
                    const int32_t* slot, const int32_t* node_id,
                    const int32_t* params, const int32_t* sel,
                    const int8_t* vals, int32_t* new_id,
                    cudaStream_t stream) {
  if (S < 1 || S > kMaxSlots || N < 0) return (int)cudaErrorInvalidValue;
  long long smem0 = (long long)s0.fpb * s0.width * S * kLive * 4;
  long long smem1 = (long long)s1.fpb * s1.width * S * kLive * 4;
  const long long smem = smem0 > smem1 ? smem0 : smem1;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  const int groups = s0.groups + s1.groups;
  if (groups == 0 || N == 0) return (int)cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      hist_kernel_previous<kRoute>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // about two resident blocks per SM over the whole grid, and no fewer than
  // 8 rows per thread in a block, so each block's flush is amortized
  long long bx = (2LL * sm_count() + groups - 1) / groups;
  const long long by_rows = (N + 8LL * kThreads - 1) / (8LL * kThreads);
  if (bx > by_rows) bx = by_rows;
  if (bx < 1) bx = 1;
  dim3 grid((unsigned)bx, (unsigned)groups);
  hist_kernel_previous<kRoute><<<grid, kThreads, (size_t)smem, stream>>>(
      s0, s1, N, S, slot, node_id, params, sel, vals, new_id);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sml_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Step 1 alone: route (node_id given; params (8, S): leaf t1 rlo rhi dflt
// l_id r_id row, row indexing the (R, N) base) or compact (node_id null,
// slot (N,) given).  list holds N + 2 (row, slot) pairs, count one int32
// zeroed by the caller; new_id (N,) is written in route mode.
int sml_route_rows(long long N, int S, const int32_t* node_id,
                   const int32_t* params, const int32_t* base,
                   const int32_t* slot, int32_t* new_id, int32_t* list,
                   int32_t* count, void* stream) {
  if ((node_id == nullptr) == (slot == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_route(N, S, node_id, params, base, slot, new_id,
                      reinterpret_cast<int2*>(list), count,
                      (cudaStream_t)stream);
}

// K1: out (F, Bh, S, 8) int32, zeroed by the caller; feat (F,) rows of the
// (R, N) bins or null (bins is (F, N)); fpb and tile from the wrapper's
// geometry; list and count as for sml_route_rows.
int sml_hist_nodes(const int32_t* bins, const int32_t* feat, int F,
                   long long N, const int32_t* slot, const int8_t* vals,
                   int S, int Bh, int shift, int fpb, int tile,
                   int32_t* list, int32_t* count, int32_t* out,
                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  RowsSrc s0 = make_rows_src(bins, feat, out, F, Bh, shift, fpb, tile);
  RowsSrc s1 = make_rows_src(nullptr, nullptr, nullptr, 0, 1, 0, 0, 0);
  if (!rows_src_ok(s0, S)) return (int)cudaErrorInvalidConfiguration;
  int2* l = reinterpret_cast<int2*>(list);
  int rc = launch_route(N, S, nullptr, nullptr, nullptr, slot, nullptr, l,
                        count, st);
  if (rc != 0) return rc;
  return launch_rows(s0, s1, N, S, l, count, vals, st);
}

// K2: new_id (N,), out (F, Bh, S, 8) and, when K > 0, outf (K, B, S, 8);
// both histogram outputs zeroed by the caller.  params (8, S) as for
// sml_route_rows, its row entries indexing base (R, N); the K refined
// features are rows kfeat (K,) of kbase.  fpb0/tile0 are the coarse
// groups' geometry, fpb1/tile1 the refined groups'.
int sml_route_and_hist(const int32_t* bins, int F, long long N,
                       const int32_t* node_id, const int32_t* params, int S,
                       const int32_t* base, const int8_t* vals,
                       const int32_t* kbase, const int32_t* kfeat, int K,
                       int B, int Bh, int shift, int fpb0, int tile0,
                       int fpb1, int tile1, int32_t* new_id, int32_t* list,
                       int32_t* count, int32_t* out, int32_t* outf,
                       void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  RowsSrc s0 = make_rows_src(bins, nullptr, out, F, Bh, shift, fpb0, tile0);
  RowsSrc s1 = make_rows_src(kbase, kfeat, outf, K, B, 0, fpb1, tile1);
  if (!rows_src_ok(s0, S) || !rows_src_ok(s1, S))
    return (int)cudaErrorInvalidConfiguration;
  int2* l = reinterpret_cast<int2*>(list);
  int rc = launch_route(N, S, node_id, params, base, nullptr, new_id, l,
                        count, st);
  if (rc != 0) return rc;
  return launch_rows(s0, s1, N, S, l, count, vals, st);
}

// The previous kernel, K1: as sml_hist_nodes with bins (F, N), no list.
int sml_hist_nodes_previous(const int32_t* bins, int F, long long N,
                            const int32_t* slot, const int8_t* vals, int S,
                            int Bh, int shift, int32_t* out, void* stream) {
  HistSrc s0 = make_src_previous(bins, out, F, Bh, shift, S);
  HistSrc s1 = make_src_previous(nullptr, nullptr, 0, 1, 0, S);
  return launch_previous<false>(s0, s1, N, S, slot, nullptr, nullptr,
                                nullptr, vals, nullptr, (cudaStream_t)stream);
}

// The previous kernel, K2: params (7, S) leaf t1 rlo rhi dflt l_id r_id,
// the gathered split rows sel (S, N) and refined rows selk (K, N).
int sml_route_and_hist_previous(const int32_t* bins, int F, long long N,
                                const int32_t* node_id, const int32_t* params,
                                int S, const int32_t* sel, const int8_t* vals,
                                const int32_t* selk, int K, int B, int Bh,
                                int shift, int32_t* new_id, int32_t* out,
                                int32_t* outf, void* stream) {
  HistSrc s0 = make_src_previous(bins, out, F, Bh, shift, S);
  HistSrc s1 = make_src_previous(selk, outf, K, B, 0, S);
  if (F < 1) return (int)cudaErrorInvalidValue;  // new_id rides group 0
  return launch_previous<true>(s0, s1, N, S, nullptr, node_id, params, sel,
                               vals, new_id, (cudaStream_t)stream);
}

}  // extern "C"

// Direct-sum group potential for Hopper (sm_90a), hand-written CUDA.
//
// Replaces the Pallas TPU kernel _pot_kernel of
// velociraptor_stf_tpu/ops/pallas_gravity.py:40.  Plain PyTorch version with
// the same semantics: kernels/potential.py.
//
// For group-sorted slots i: phi_i = sum_j m_j / sqrt(|x_i - x_j|^2 + eps2)
// over j != i with gid_j == gid_i != 0.  The caller multiplies by -G and
// m_i.  With eps2 = 0 coincident particles give +inf, as in the reference.
//
// Layout.  pm = (ns, 4) float32 rows (x, y, z, m), packed by the wrapper.
// win = (ns, 2) int32: row i's partners are the slots [win.x, win.y) of its
// group (ops/gravity_direct.py), (0, 0) for gid 0.  The data is
// group-sorted, so "same nonzero gid" is "inside the row's slot range".
//
// What bounds it on the H100.  One rsqrt per pair on the MUFU, 16 lanes per
// clock per SM: 132 x 16 x 1.98e9 = 4.18e12 pairs/s.  The FP32 pipe does
// the rest: 3 FADD for (dx, dy, dz), 3 FFMA for d^2 and 1 FFMA for the sum,
// 7 of its 128 lanes per clock against the MUFU's 1 of 16 -- so the kernel
// is MUFU and issue bound together, never bound by bytes (a group's rows
// are read once, its columns come from shared memory).  This bound counts
// one rsqrt per ordered pair, sum s(s - 1) over the groups: it assumes no
// use of the pair symmetry r_ij = r_ji.  A kernel that credited both rows
// from one rsqrt (sum s(s - 1) / 2, with partials added in a fixed order to
// stay deterministic) has half the bound; chip_smoke.py prints the share
// under both counts.
//
// Design, point by point:
// * P rows per thread, kept in registers: one column read from shared
//   memory feeds P pairs (the earlier kernel issued five shared loads per
//   pair and ran at about 28% of the MUFU bound).
// * One 16-byte broadcast load (LDS.128) per column: columns are packed
//   (x, y, z, m) float4, staged TILE at a time by cp.async into a two-stage
//   ring, the next tile in flight while the current one is scanned.
// * Slot ranges instead of per-pair group compares: a tile that lies in the
//   range of all P rows of a thread and holds none of them takes the
//   unmasked loop; only tiles at a group edge or holding the thread's own
//   rows take the masked one.  A row block scans the union of its rows'
//   ranges (its span, kernels/potential.py::spans) and each thread only the
//   union of its own rows' ranges, so a block that straddles small groups
//   does not test every row against every group.
// * Load balance: the spans are cut into column chunks of a whole number of
//   tiles, sized so that the launch has about TARGET_ITEMS work items (row
//   block x chunk, kernels/potential.py).  Without the cut, the few hundred
//   row blocks of the largest group at 256^3 run at a few blocks per SM
//   (37% of the bound, against 64% on one 1.2M-member group).
// * FMA in this kernel only: d^2 and the running sum use explicit __fmaf_rn,
//   which -fmad=false (kept for the FOF kernels' link decisions) does not
//   touch.  rsqrt.approx.ftz: one MUFU op; it flushes only a d^2 below
//   1.2e-38, i.e. coincident pairs, which give +inf either way.
// * Summation order and determinism: a float32 sum per tile and row, added
//   into a float64 sum across the tiles of a chunk; each work item writes
//   its float64 partials to scratch, and a second pass adds a row's chunks
//   in chunk order (holds a 10^6-member group well inside rel 1e-4).  No
//   atomics: two runs give the same bits.
// * No tensor cores: TF32's 10-bit mantissa in a |x|^2 + |y|^2 - 2 x.y
//   product cannot hold rel 1e-4 for close pairs.

#include <climits>
#include <cuda_runtime.h>

// The launch geometry has one source, kernels/potential.py, whose numbers
// kernels/_build.py passes to nvcc as these defines.
#if !defined(VR_POT_THREADS) || !defined(VR_POT_ROWS_PER_THREAD) || \
    !defined(VR_POT_TILE)
#error "build with kernels/_build.py: it defines the launch geometry"
#endif

namespace {

constexpr int T = VR_POT_THREADS;          // threads per block
constexpr int P = VR_POT_ROWS_PER_THREAD;  // rows per thread (consecutive)
constexpr int ROWS = T * P;                // rows per block
constexpr int TILE = VR_POT_TILE;          // columns per shared-memory stage
constexpr int STAGES = 2;

__device__ __forceinline__ float rsqrt_mufu(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// stage columns [c0, min(c0 + TILE, end)) of pm into buf
__device__ __forceinline__ void stage_tile(float4* buf,
                                           const float4* __restrict__ pm,
                                           int c0, int end) {
  for (int k = threadIdx.x; k < TILE; k += T) {
    if (c0 + k < end) cp_async16(buf + k, pm + c0 + k);
  }
}

// One work item = one row block x one column chunk [begin, end) of the
// block's span; its f64 partial sums go to scratch[item][ROWS].
__global__ void __launch_bounds__(T)
potential_kernel(const float4* __restrict__ pm, const int2* __restrict__ win,
                 int ns, const int4* __restrict__ items, float eps2,
                 double* __restrict__ scratch) {
  __shared__ float4 tile[STAGES][TILE];
  const int4 item = items[blockIdx.x];  // (row block, begin, end, -)
  const int row0 = item.x * ROWS + threadIdx.x * P;
  float px[P], py[P], pz[P];
  int lo[P], hi[P];
  double acc[P];
  int tlo = INT_MAX, thi = 0;  // this thread's column span
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int r = row0 + p;
    const bool valid = r < ns;
    const float4 a = valid ? pm[r] : make_float4(0.f, 0.f, 0.f, 0.f);
    const int2 w = valid ? win[r] : make_int2(0, 0);
    px[p] = a.x;
    py[p] = a.y;
    pz[p] = a.z;
    lo[p] = w.x;
    hi[p] = w.y;
    acc[p] = 0.0;
    if (w.y > w.x) {
      tlo = min(tlo, w.x);
      thi = max(thi, w.y);
    }
  }
  const int begin = item.y, end = item.z;
  // the range every row of the thread shares (empty if any row has none)
  int all_lo = INT_MIN, all_hi = INT_MAX;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    all_lo = max(all_lo, lo[p]);
    all_hi = min(all_hi, hi[p]);
  }
  const int ntiles = (end - begin + TILE - 1) / TILE;
  if (ntiles > 0) stage_tile(tile[0], pm, begin, end);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int c0 = begin + t * TILE;
    const int c1 = min(c0 + TILE, end);
    if (t + 1 < ntiles) stage_tile(tile[(t + 1) & 1], pm, c1, end);
    cp_async_commit();  // an empty group at the last tile keeps the count
    cp_async_wait_one();
    __syncthreads();
    const float4* buf = tile[t & 1];
    if (thi > c0 && tlo < c1) {
      float part[P];
#pragma unroll
      for (int p = 0; p < P; ++p) part[p] = 0.f;
      const bool own = row0 < c1 && row0 + P > c0;
      if (all_lo <= c0 && c1 <= all_hi && !own) {
        const int n = c1 - c0;
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          const float4 c = buf[k];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const float dx = px[p] - c.x;
            const float dy = py[p] - c.y;
            const float dz = pz[p] - c.z;
            float d2 = __fmaf_rn(dx, dx, eps2);
            d2 = __fmaf_rn(dy, dy, d2);
            d2 = __fmaf_rn(dz, dz, d2);
            part[p] = __fmaf_rn(c.w, rsqrt_mufu(d2), part[p]);
          }
        }
      } else {
        const int k0 = max(c0, tlo) - c0;
        const int k1 = min(c1, thi) - c0;
#pragma unroll 2
        for (int k = k0; k < k1; ++k) {
          const float4 c = buf[k];
          const int j = c0 + k;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const float dx = px[p] - c.x;
            const float dy = py[p] - c.y;
            const float dz = pz[p] - c.z;
            float d2 = __fmaf_rn(dx, dx, eps2);
            d2 = __fmaf_rn(dy, dy, d2);
            d2 = __fmaf_rn(dz, dz, d2);
            const float s = __fmaf_rn(c.w, rsqrt_mufu(d2), part[p]);
            const bool ok = j >= lo[p] && j < hi[p] && j != row0 + p;
            part[p] = ok ? s : part[p];
          }
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] += static_cast<double>(part[p]);
    }
    __syncthreads();  // the stage is overwritten two tiles on
  }
  double* dst = scratch + static_cast<size_t>(blockIdx.x) * ROWS +
                threadIdx.x * P;
#pragma unroll
  for (int p = 0; p < P; ++p) dst[p] = acc[p];
}

// out[r] = the sum of its block's chunk partials, in chunk order
__global__ void potential_sum_kernel(const double* __restrict__ scratch,
                                     const int* __restrict__ first,
                                     int ns, float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= ns) return;
  const int b = r / ROWS;
  const int k0 = first[b], k1 = first[b + 1];
  double acc = 0.0;
  for (int k = k0; k < k1; ++k)
    acc += scratch[static_cast<size_t>(k) * ROWS + (r - b * ROWS)];
  out[r] = static_cast<float>(acc);
}

}  // namespace

extern "C" int vr_potential(const float* pm, const int* win, int ns,
                            const int* items, int nitems, const int* first,
                            float eps2, double* scratch, float* out,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  potential_kernel<<<nitems, T, 0, st>>>(
      reinterpret_cast<const float4*>(pm), reinterpret_cast<const int2*>(win),
      ns, reinterpret_cast<const int4*>(items), eps2, scratch);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  potential_sum_kernel<<<(ns + 255) / 256, 256, 0, st>>>(scratch, first, ns,
                                                         out);
  return static_cast<int>(cudaGetLastError());
}

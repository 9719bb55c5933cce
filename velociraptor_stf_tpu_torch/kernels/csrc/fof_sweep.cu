// FOF neighbour scans for Hopper (sm_90a), hand-written CUDA.
//
// Replaces the Pallas TPU kernels of velociraptor_stf_tpu/ops/pallas_fof.py:
//   vr_fof_detect  <- _detect_kernel_3d (:613)  neighbour count, self included
//   vr_fof_sweep3d <- _sweep_kernel_3d  (:578)  min label over |dx|^2 <= b^2
//   vr_fof_sweep6d <- _sweep_kernel_6d  (:680)  min label over the 6D phase
//                     criterion within the same nonzero 3DFOF group
// Plain PyTorch versions with the same semantics: kernels/fof_sweep.py.
// Particles are cell-sorted on (cx, cy*nz + cz) (ops/fof_sweep.py).
//
// Rounding.  Link decisions must round like the plain version: d2 is built
// from coordinate differences as dx*dx, then + dy*dy, then + dz*dz, every
// step rounded; the library is compiled with -fmad=false so nvcc does not
// contract these into FMAs (an FMA moves pairs across d = b).  The 6D test
// is d2*inv_b2 + dv2*rivs_row <= 1, both products rounded, then the sum.
//
// detect_kernel (not changed by the sweeps' cell windows).  SoA positions
// pos = [x(ns) | y(ns) | z(ns)]; row block b holds rows [b*R, b*R + R) and
// owns NWIN disjoint windows win[b][k] = (start, count) from the block's
// first cell to its last (disjoint, or a column would count twice).  One
// thread block per row block, one row per thread; the block stages R
// columns at a time into shared memory and every thread scans the tile.
//
// sweep3d_kernel, sweep6d_kernel.  Each row scans only its own 27 cells:
// cell[row] numbers the row's occupied cell and win[cell][k] = (start,
// count), k over (dx, dy) in {-1,0,1}^2, is the slot range of cells
// (cx+dx, cy+dy, cz-1..cz+1) -- one z-column each, so the nine are
// disjoint and hold exactly the 27 cells' slots (ops/fof_sweep.py::
// cell_windows).  A row thus tests no column outside its 27 cells, where
// a 256-row block's windows made it test the block's whole z-span.
//   One row per thread, consecutive rows in a warp: neighbouring cells of
// one z-column, so their windows overlap and the columns stay in L1.  An
// occupied cell holds under two slots on average, so a shared-memory tile
// common to many rows would have little to share; columns are read from
// device memory through L1 instead (const __restrict__), one 16-byte load
// per column: packed (x, y, z, .) rows, and for the 6D sweep
// (x, y, z, group bits) -- the group checked before anything else -- and a
// second float4 (vx, vy, vz, rivs) loaded only for a same-group column.
// Labels change every sweep, so they stay a separate int32 array, loaded
// only for a column that links.  No atomics: each thread writes its own
// row's minimum.  A row whose cell has empty windows keeps its label.
//
// What bounds the sweeps on the H100: the needed pairs' lane arithmetic
// over the issue rate of 132 SMs x 128 lanes -- d2 from differences and
// its compare, 9 operations a pair in 3D; d2, dv2, the two products, their
// sum, its compare and the group compare, 21 in 6D (chip_smoke.py).  The
// bytes (positions and labels in, labels out; in 6D also velocities,
// groups and scales) are a smaller bound.  What keeps them from it: rows
// of one warp have windows of different lengths (divergence), and every
// column is a dependent L1 load, with no shared tile to hide its latency
// behind; occupancy is what covers it: 32 registers a thread (-Xptxas -v),
// so 16 blocks of 128 threads fill an SM's 2048 threads.

#include <cuda_runtime.h>

namespace {

constexpr int R = 256;    // detect: rows = threads per block = tile width
constexpr int NWIN = 9;   // windows per row block (detect) or cell (sweeps)
constexpr int SWEEP_THREADS = 128;   // sweeps: one row per thread

__device__ __forceinline__ float dist2(float px, float py, float pz,
                                       float qx, float qy, float qz) {
  const float dx = px - qx;
  float d2 = dx * dx;
  const float dy = py - qy;
  d2 = d2 + dy * dy;
  const float dz = pz - qz;
  d2 = d2 + dz * dz;
  return d2;
}

__global__ void __launch_bounds__(R)
detect_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ z, int ns,
              const int* __restrict__ win, float b2, int* __restrict__ out) {
  __shared__ float sx[R], sy[R], sz[R];
  const int row = blockIdx.x * R + threadIdx.x;
  const bool valid = row < ns;
  const float px = valid ? x[row] : 0.f;
  const float py = valid ? y[row] : 0.f;
  const float pz = valid ? z[row] : 0.f;
  int cnt = 0;
  const int* w = win + (size_t)blockIdx.x * (2 * NWIN);
  for (int k = 0; k < NWIN; ++k) {
    const int start = w[2 * k];
    const int count = w[2 * k + 1];
    for (int t0 = 0; t0 < count; t0 += R) {
      const int m = min(R, count - t0);
      __syncthreads();
      if (threadIdx.x < m) {
        const int j = start + t0 + threadIdx.x;
        sx[threadIdx.x] = x[j];
        sy[threadIdx.x] = y[j];
        sz[threadIdx.x] = z[j];
      }
      __syncthreads();
      for (int t = 0; t < m; ++t) {
        cnt += dist2(px, py, pz, sx[t], sy[t], sz[t]) <= b2;
      }
    }
  }
  if (valid) out[row] = cnt;
}

__global__ void __launch_bounds__(SWEEP_THREADS)
sweep3d_kernel(const float4* __restrict__ pts, const int* __restrict__ labels,
               const int* __restrict__ cell, const int2* __restrict__ win,
               int ns, float b2, int* __restrict__ out) {
  const unsigned row = blockIdx.x * SWEEP_THREADS + threadIdx.x;
  if (row >= static_cast<unsigned>(ns)) return;
  const float4 p = pts[row];
  int best = labels[row];
  const int2* w = win + static_cast<size_t>(cell[row]) * NWIN;
#pragma unroll 1
  for (int k = 0; k < NWIN; ++k) {
    const int2 sc = w[k];
    const int end = sc.x + sc.y;
#pragma unroll 4
    for (int j = sc.x; j < end; ++j) {
      const float4 q = pts[j];
      if (dist2(p.x, p.y, p.z, q.x, q.y, q.z) <= b2) {
        best = min(best, labels[j]);
      }
    }
  }
  out[row] = best;
}

__global__ void __launch_bounds__(SWEEP_THREADS)
sweep6d_kernel(const float4* __restrict__ pts, const float4* __restrict__ vels,
               const int* __restrict__ labels, const int* __restrict__ cell,
               const int2* __restrict__ win, int ns, float inv_b2,
               int* __restrict__ out) {
  const unsigned row = blockIdx.x * SWEEP_THREADS + threadIdx.x;
  if (row >= static_cast<unsigned>(ns)) return;
  const float4 p = pts[row];
  const int g = __float_as_int(p.w);    // group 0 links to nothing
  int best = labels[row];
  if (g > 0) {
    const float4 v = vels[row];         // v.w: the row's rivs
    const int2* w = win + static_cast<size_t>(cell[row]) * NWIN;
#pragma unroll 1
    for (int k = 0; k < NWIN; ++k) {
      const int2 sc = w[k];
      const int end = sc.x + sc.y;
#pragma unroll 4
      for (int j = sc.x; j < end; ++j) {
        const float4 q = pts[j];
        if (__float_as_int(q.w) != g) continue;
        const float4 u = vels[j];
        const float d2 = dist2(p.x, p.y, p.z, q.x, q.y, q.z);
        const float dv2 = dist2(v.x, v.y, v.z, u.x, u.y, u.z);
        if (d2 * inv_b2 + dv2 * v.w <= 1.f) best = min(best, labels[j]);
      }
    }
  }
  out[row] = best;
}

inline int nblocks(int ns) { return (ns + R - 1) / R; }

inline int sweep_blocks(int ns) {
  return static_cast<int>((static_cast<long long>(ns) + SWEEP_THREADS - 1) /
                          SWEEP_THREADS);
}

}  // namespace

extern "C" int vr_fof_detect(const float* pos, int ns, const int* win,
                             float b2, int* out, void* stream) {
  detect_kernel<<<nblocks(ns), R, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, pos + ns, pos + 2 * (size_t)ns, ns, win, b2, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vr_fof_sweep3d(const float* pts, const int* labels,
                              const int* cell, const int* win, int ns,
                              float b2, int* out, void* stream) {
  sweep3d_kernel<<<sweep_blocks(ns), SWEEP_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(pts), labels, cell,
      reinterpret_cast<const int2*>(win), ns, b2, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vr_fof_sweep6d(const float* pts, const float* vels,
                              const int* labels, const int* cell,
                              const int* win, int ns, float inv_b2, int* out,
                              void* stream) {
  sweep6d_kernel<<<sweep_blocks(ns), SWEEP_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(pts),
      reinterpret_cast<const float4*>(vels), labels, cell,
      reinterpret_cast<const int2*>(win), ns, inv_b2, out);
  return static_cast<int>(cudaGetLastError());
}

// FOF neighbour scans for Hopper (sm_90a), hand-written CUDA.
//
// Replaces the Pallas TPU kernels of velociraptor_stf_tpu/ops/pallas_fof.py:
//   vr_fof_detect  <- _detect_kernel_3d (:613)  neighbour count, self included
//   vr_fof_sweep3d <- _sweep_kernel_3d  (:578)  min label over |dx|^2 <= b^2
//   vr_fof_sweep6d <- _sweep_kernel_6d  (:680)  min label over the 6D phase
//                     criterion within the same nonzero 3DFOF group
// Plain PyTorch versions with the same semantics: kernels/fof_sweep.py.
// Particles are cell-sorted on (cx, cy*nz + cz) (ops/fof_sweep.py) and
// come as packed float4 rows, one 16-byte load per column.
//
// Rounding.  Link decisions must round like the plain version: d2 is built
// from coordinate differences as dx*dx, then + dy*dy, then + dz*dz, every
// step rounded; the library is compiled with -fmad=false so nvcc does not
// contract these into FMAs (an FMA moves pairs across d = b).  The 6D test
// is d2*inv_b2 + dv2*rivs_row <= 1, both products rounded, then the sum.
//
// detect_kernel.  It runs once, on the full context: every particle and
// ghost image, most of them background particles alone in their cell, so
// a table per occupied cell (what the sweeps take) would cost more to
// build than the scan itself.  The sort order gives the row's candidates
// without one: the slots of a z-column (cx, cy) are contiguous and sorted
// on their z cell, so the index is one start per z-column, colstart
// (nx*ny + 1 entries, a few MB that stay in L2).  Rows are packed
// (x, y, z, z cell bits), col[row] = cx*ny + cy.  One row per thread,
// consecutive rows in a warp (one z-column, or neighbouring ones: their
// ranges overlap and stay in L1).  For each of its nine z-columns on the
// grid a row reads the column's range, finds by binary search inside it the
// first slot whose z cell is at least cz-1 (ranges hold about ten slots in
// the field and thousands through a halo core; the search keeps a core row
// from scanning its whole column) and scans forward while the z cell is at
// most cz+1: exactly the slots of its 27 cells.  A z-column off the grid
// is skipped (a y offset off the grid would land in the next x-stripe's
// columns).  The z cell rides in the row's fourth lane, so the cell test
// costs no second load.  No shared tile (an occupied cell holds about one
// slot), no atomics: each thread writes its own count.
//   What bounds it: the bytes (positions in, counts out) over the memory
// rate and the needed pairs' lane arithmetic (d2 and its compare, 9
// operations a pair) over the issue rate lie close together; at 256^3
// the bytes are the larger (chip_smoke.py prints both).  What keeps it
// from the bound: a row has about fifteen pairs but nine range reads and
// nine searches of three or four dependent loads each; 28 registers a
// thread, so a full SM of warps covers their latency.
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

constexpr int NWIN = 9;   // windows per cell (sweeps)
constexpr int DETECT_THREADS = 128;  // one row per thread
constexpr int SWEEP_THREADS = 128;   // one row per thread

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

__global__ void __launch_bounds__(DETECT_THREADS)
detect_kernel(const float4* __restrict__ pts, const int* __restrict__ col,
              const int* __restrict__ colstart, int ns, int nx, int ny,
              float b2, int* __restrict__ out) {
  const unsigned row = blockIdx.x * DETECT_THREADS + threadIdx.x;
  if (row >= static_cast<unsigned>(ns)) return;
  const float4 p = pts[row];
  const int zlo = __float_as_int(p.w) - 1;   // z cells zlo..zhi, unclamped:
  const int zhi = zlo + 2;                   // no slot has z cell -1 or nz
  const int c = col[row];
  const int cx = c / ny;
  const int cy = c - cx * ny;
  const int y0 = max(cy - 1, 0);
  const int y1 = min(cy + 1, ny - 1);
  int cnt = 0;
#pragma unroll 1
  for (int x = max(cx - 1, 0); x <= min(cx + 1, nx - 1); ++x) {
#pragma unroll 1
    for (int cc = x * ny + y0; cc <= x * ny + y1; ++cc) {
      int lo = colstart[cc];
      const int end = colstart[cc + 1];
      int hi = end;
      while (lo < hi) {                      // first slot with z cell >= zlo
        const int mid = lo + ((hi - lo) >> 1);
        if (__float_as_int(pts[mid].w) < zlo) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      for (int j = lo; j < end; ++j) {
        const float4 q = pts[j];
        if (__float_as_int(q.w) > zhi) break;
        cnt += dist2(p.x, p.y, p.z, q.x, q.y, q.z) <= b2;
      }
    }
  }
  out[row] = cnt;
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

inline int row_blocks(int ns, int threads) {
  return static_cast<int>((static_cast<long long>(ns) + threads - 1) /
                          threads);
}

}  // namespace

extern "C" int vr_fof_detect(const float* pts, const int* col,
                             const int* colstart, int ns, int nx, int ny,
                             float b2, int* out, void* stream) {
  detect_kernel<<<row_blocks(ns, DETECT_THREADS), DETECT_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(pts), col, colstart, ns, nx, ny, b2,
      out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vr_fof_sweep3d(const float* pts, const int* labels,
                              const int* cell, const int* win, int ns,
                              float b2, int* out, void* stream) {
  sweep3d_kernel<<<row_blocks(ns, SWEEP_THREADS), SWEEP_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(pts), labels, cell,
      reinterpret_cast<const int2*>(win), ns, b2, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vr_fof_sweep6d(const float* pts, const float* vels,
                              const int* labels, const int* cell,
                              const int* win, int ns, float inv_b2, int* out,
                              void* stream) {
  sweep6d_kernel<<<row_blocks(ns, SWEEP_THREADS), SWEEP_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(pts),
      reinterpret_cast<const float4*>(vels), labels, cell,
      reinterpret_cast<const int2*>(win), ns, inv_b2, out);
  return static_cast<int>(cudaGetLastError());
}

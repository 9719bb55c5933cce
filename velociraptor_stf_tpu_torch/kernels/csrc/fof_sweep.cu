// FOF neighbour scans for Hopper (sm_90a), hand-written CUDA.
//
// Replaces the Pallas TPU kernels of velociraptor_stf_tpu/ops/pallas_fof.py:
//   vr_fof_detect  <- _detect_kernel_3d (:613)  neighbour count, self included
//   vr_fof_sweep3d <- _sweep_kernel_3d  (:578)  min label over |dx|^2 <= b^2
//   vr_fof_sweep6d <- _sweep_kernel_6d  (:680)  min label over the 6D phase
//                     criterion within the same nonzero 3DFOF group
// Plain PyTorch versions with the same semantics: kernels/fof_sweep.py.
//
// Layout.  Particles are cell-sorted (ops/fof_sweep.py) and stored as SoA
// rows: pos = [x(ns) | y(ns) | z(ns)], likewise vel.  Row block b holds rows
// [b*R, b*R + R) and owns NWIN disjoint candidate windows
// win[b][k] = (start, count), in slots; together they are an exact superset
// of every neighbour of every row of the block.  Disjointness matters: the
// detect count would see a column twice in overlapping windows.
//
// Design.  One thread block per row block, one row per thread.  The block
// walks its windows and stages R candidate columns at a time into shared
// memory (SoA); every thread scans the tile and keeps a running count or
// minimum.  Blocks are independent, so the TPU kernel's sequential grid and
// double-buffered DMA loop have no counterpart.
//
// Rounding.  Link decisions must round like the plain version: d2 is built
// from coordinate differences as dx*dx, then + dy*dy, then + dz*dz, every
// step rounded; the library is compiled with -fmad=false so nvcc does not
// contract these into FMAs (an FMA moves pairs across d = b).  The 6D test
// is d2*inv_b2 + dv2*rivs_row <= 1 with both factors precomputed in f32.
//
// What bounds it on the H100.  Each pair costs about ten FP32/INT32
// instructions on operands already in shared memory; a column is read from
// device memory once per tile per block.  The scan is bound by instruction
// issue (FP32 pipes), not by bytes.  Left for later PRs: several rows per
// thread to reuse each shared-memory load, cp.async/TMA staging that
// overlaps the next tile with the scan, skipping blocks whose windows saw no
// label change since the last sweep, and a persistent grid.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int R = 256;    // rows per block = threads per block = tile width
constexpr int NWIN = 9;   // windows per row block

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

__global__ void __launch_bounds__(R)
sweep3d_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ z, const int* __restrict__ labels,
               int ns, const int* __restrict__ win, float b2,
               int* __restrict__ out) {
  __shared__ float sx[R], sy[R], sz[R];
  __shared__ int sl[R];
  const int row = blockIdx.x * R + threadIdx.x;
  const bool valid = row < ns;
  const float px = valid ? x[row] : 0.f;
  const float py = valid ? y[row] : 0.f;
  const float pz = valid ? z[row] : 0.f;
  int best = valid ? labels[row] : INT_MAX;
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
        sl[threadIdx.x] = labels[j];
      }
      __syncthreads();
      for (int t = 0; t < m; ++t) {
        if (dist2(px, py, pz, sx[t], sy[t], sz[t]) <= b2) {
          best = min(best, sl[t]);
        }
      }
    }
  }
  if (valid) out[row] = best;
}

__global__ void __launch_bounds__(R)
sweep6d_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ z, const float* __restrict__ vx,
               const float* __restrict__ vy, const float* __restrict__ vz,
               const float* __restrict__ rivs, const int* __restrict__ grp,
               const int* __restrict__ labels, int ns,
               const int* __restrict__ win, float inv_b2,
               int* __restrict__ out) {
  __shared__ float sx[R], sy[R], sz[R], svx[R], svy[R], svz[R];
  __shared__ int sg[R], sl[R];
  const int row = blockIdx.x * R + threadIdx.x;
  const bool valid = row < ns;
  const float px = valid ? x[row] : 0.f;
  const float py = valid ? y[row] : 0.f;
  const float pz = valid ? z[row] : 0.f;
  const float pvx = valid ? vx[row] : 0.f;
  const float pvy = valid ? vy[row] : 0.f;
  const float pvz = valid ? vz[row] : 0.f;
  const float riv = valid ? rivs[row] : 0.f;
  const int g = valid ? grp[row] : 0;   // group 0 links to nothing
  int best = valid ? labels[row] : INT_MAX;
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
        svx[threadIdx.x] = vx[j];
        svy[threadIdx.x] = vy[j];
        svz[threadIdx.x] = vz[j];
        sg[threadIdx.x] = grp[j];
        sl[threadIdx.x] = labels[j];
      }
      __syncthreads();
      if (g > 0) {
        for (int t = 0; t < m; ++t) {
          if (sg[t] != g) continue;
          const float d2 = dist2(px, py, pz, sx[t], sy[t], sz[t]);
          const float dv2 = dist2(pvx, pvy, pvz, svx[t], svy[t], svz[t]);
          if (d2 * inv_b2 + dv2 * riv <= 1.f) best = min(best, sl[t]);
        }
      }
    }
  }
  if (valid) out[row] = best;
}

inline int nblocks(int ns) { return (ns + R - 1) / R; }

}  // namespace

extern "C" int vr_fof_detect(const float* pos, int ns, const int* win,
                             float b2, int* out, void* stream) {
  detect_kernel<<<nblocks(ns), R, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, pos + ns, pos + 2 * (size_t)ns, ns, win, b2, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vr_fof_sweep3d(const float* pos, const int* labels, int ns,
                              const int* win, float b2, int* out,
                              void* stream) {
  sweep3d_kernel<<<nblocks(ns), R, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, pos + ns, pos + 2 * (size_t)ns, labels, ns, win, b2, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vr_fof_sweep6d(const float* pos, const float* vel,
                              const float* rivs, const int* grp,
                              const int* labels, int ns, const int* win,
                              float inv_b2, int* out, void* stream) {
  sweep6d_kernel<<<nblocks(ns), R, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, pos + ns, pos + 2 * (size_t)ns, vel, vel + ns,
      vel + 2 * (size_t)ns, rivs, grp, labels, ns, win, inv_b2, out);
  return static_cast<int>(cudaGetLastError());
}

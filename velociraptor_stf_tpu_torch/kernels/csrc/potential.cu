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
// Layout.  pos = [x(ns) | y(ns) | z(ns)] SoA; row block b holds rows
// [b*R, b*R + R) and owns ONE candidate window win[b] = (start, count)
// covering every group that has a row in the block (ops/gravity_direct.py).
//
// Design.  One thread block per row block, one row per thread; R candidate
// columns at a time are staged into shared memory; each thread sums one
// tile in f32 and adds the tile sum to an f64 accumulator, which keeps a
// 10^6-member group's sum well inside the 1e-4 tolerance without Kahan
// terms.  Rows of group 0 skip the scan.
//
// What bounds it on the H100.  One rsqrtf per pair on the SFU (MUFU) plus
// about ten FP32 instructions; operands come from shared memory, so the
// kernel is bound by FP32/MUFU issue, not by bytes.  Left for later PRs:
// several rows per thread, a tile walk that skips columns of other groups
// (a block straddling two groups scans both), async staging, and the
// O(N log N) tree for the largest groups.

#include <cuda_runtime.h>

namespace {

constexpr int R = 256;    // rows per block = threads per block = tile width

__global__ void __launch_bounds__(R)
potential_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ z, const float* __restrict__ mass,
                 const int* __restrict__ gid, int ns,
                 const int* __restrict__ win, float eps2,
                 float* __restrict__ out) {
  __shared__ float sx[R], sy[R], sz[R], sm[R];
  __shared__ int sg[R];
  const int row = blockIdx.x * R + threadIdx.x;
  const bool valid = row < ns;
  const float px = valid ? x[row] : 0.f;
  const float py = valid ? y[row] : 0.f;
  const float pz = valid ? z[row] : 0.f;
  const int g = valid ? gid[row] : 0;
  const int start = win[2 * blockIdx.x];
  const int count = win[2 * blockIdx.x + 1];
  double acc = 0.0;
  for (int t0 = 0; t0 < count; t0 += R) {
    const int m = min(R, count - t0);
    __syncthreads();
    if (threadIdx.x < m) {
      const int j = start + t0 + threadIdx.x;
      sx[threadIdx.x] = x[j];
      sy[threadIdx.x] = y[j];
      sz[threadIdx.x] = z[j];
      sm[threadIdx.x] = mass[j];
      sg[threadIdx.x] = gid[j];
    }
    __syncthreads();
    if (g > 0) {
      float part = 0.f;
      const int self = row - start - t0;   // tile index of this row, if any
      for (int t = 0; t < m; ++t) {
        if (sg[t] != g || t == self) continue;
        const float dx = px - sx[t];
        float d2 = dx * dx;
        const float dy = py - sy[t];
        d2 = d2 + dy * dy;
        const float dz = pz - sz[t];
        d2 = d2 + dz * dz;
        part = part + sm[t] * rsqrtf(d2 + eps2);
      }
      acc += static_cast<double>(part);
    }
  }
  if (valid) out[row] = static_cast<float>(acc);
}

}  // namespace

extern "C" int vr_potential(const float* pos, const float* mass,
                            const int* gid, int ns, const int* win,
                            float eps2, float* out, void* stream) {
  potential_kernel<<<(ns + R - 1) / R, R, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      pos, pos + ns, pos + 2 * (size_t)ns, mass, gid, ns, win, eps2, out);
  return static_cast<int>(cudaGetLastError());
}

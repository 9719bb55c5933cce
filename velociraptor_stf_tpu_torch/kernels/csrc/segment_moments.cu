// Segmented moments of group-sorted rows for Hopper (sm_90a), hand-written
// CUDA.
//
// Replaces no Pallas kernel: the JAX package's property stage
// (velociraptor_stf_tpu/models/properties.py) is segment sums that XLA
// fuses.  In the port each of those sums was a bincount of the segment
// lengths (two host reads of its input's range), an aligned copy, one
// segment_reduce a column and a stack: some twenty launches and several
// host waits a sum, a few hundred sums a catalog.  This kernel takes every
// sum of one dependent pass of the property stage (every selection --
// particle type, sub-type, radius scope, aperture, profile bin -- and
// every column) in one launch.  Plain PyTorch version with the same
// semantics: kernels/moments.py::segment_moments_ref.
//
// Layout.  rows = (n, F) float32, group-sorted: x, y, z, vx, vy, vz, m,
// then nf per-particle fields (F >= 7 + nf).  off = (ng1 + 1,) int64: group
// g holds rows [off[g], off[g + 1]) (ops/segments.py::group_offsets).
// sel = (n, S) uint8: row r is in selection s where sel[r, s] != 0.  A
// selection s sums about its group's centre C[ci[s], g], velocity
// reference U[ui[s], g] and rotation axis A[ai[s], g], each a (T, ng1, 3)
// float64 table; the per-selection table indices travel in the launch's
// parameters (no copy to the card).  out = (S, ng1, K) float64 with
// K = 25 + 2 nf columns, dx = x - c, dv = v - u, L = dx x dv:
//   0 count        1 m            2-4 m x        5-7 m v
//   8-10 m L       11-16 m dx_i dx_j (xx xy xz yy yz zz)
//   17-22 m dv_i dv_j              23 m |dv|^2
//   24 m/2 (L.a)^2 / max(|dx|^2 - (dx.a)^2, 1e-30)
//   25 + 2j field j, 26 + 2j m field j.
//
// What bounds it on the H100.  Bytes: each row's F floats and S selection
// bytes read once a pass, the (S, ng1, K) sums written once, over 3.35 TB/s.
// The work per byte is small (about 150 float64 operations a row and
// selection, at 67 TFLOP/s).  At the property stage's sizes (1e5-1e6
// tagged rows) one launch moves some megabytes: microseconds.  What it
// saves is the launches and host waits of the sums it replaces.
//
// Design.  One warp per (selection, group): lane l sums rows off[g] + l,
// + 32, ... in order in float64 registers (the products formed from the
// float32 rows and the float64 tables, never stored), then a fixed
// shuffle tree adds the 32 lanes.  No atomics and no shared state between
// groups: a group's sums depend only on its own rows and their order, so
// two runs give the same bits, and a group gives the same bits in a
// shard's block as in the whole set (parallel/distributed_props.py).
// Consecutive warps take consecutive groups of one selection, so a block
// reads neighbouring rows.  -fmad=false: each product rounds as the plain
// version's float64 products do (but for torch.linalg.cross, which may
// fuse a multiply-add: an ulp), so the two differ by the order of the sums.

#include <cuda_runtime.h>

#define VR_MOM_MAX_SEL 128
#define VR_MOM_MAX_FIELDS 6
#define VR_MOM_BASE 25

namespace {

constexpr int WARPS = 4;

struct SelTables {
  int c[VR_MOM_MAX_SEL];
  int u[VR_MOM_MAX_SEL];
  int a[VR_MOM_MAX_SEL];
};

template <int NF>
__global__ void __launch_bounds__(WARPS * 32)
moments_kernel(const float* __restrict__ rows, int F, long long n,
               const long long* __restrict__ off, int ng1,
               const unsigned char* __restrict__ sel, int S, int s0, int ns,
               const SelTables tab, const double* __restrict__ ctab,
               const double* __restrict__ utab,
               const double* __restrict__ atab, double* __restrict__ out) {
  constexpr int K = VR_MOM_BASE + 2 * NF;
  const long long wid =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (wid >= static_cast<long long>(ns) * ng1) return;   // whole warps
  const int sl = static_cast<int>(wid / ng1);
  const int g = static_cast<int>(wid - static_cast<long long>(sl) * ng1);
  const int s = s0 + sl;
  const double* c = ctab + (static_cast<long long>(tab.c[sl]) * ng1 + g) * 3;
  const double* u = utab + (static_cast<long long>(tab.u[sl]) * ng1 + g) * 3;
  const double* a = atab + (static_cast<long long>(tab.a[sl]) * ng1 + g) * 3;
  const double c0 = c[0], c1 = c[1], c2 = c[2];
  const double u0 = u[0], u1 = u[1], u2 = u[2];
  const double a0 = a[0], a1 = a[1], a2 = a[2];

  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;

  // clamped, so a malformed offset table cannot read outside the rows
  const long long lo = min(max(off[g], 0LL), n);
  const long long hi = min(max(off[g + 1], lo), n);
  for (long long r = lo + lane; r < hi; r += 32) {
    if (!sel[r * S + s]) continue;
    const float* row = rows + r * F;
    const double x0 = row[0], x1 = row[1], x2 = row[2];
    const double v0 = row[3], v1 = row[4], v2 = row[5];
    const double m = row[6];
    const double d0 = x0 - c0, d1 = x1 - c1, d2 = x2 - c2;
    const double w0 = v0 - u0, w1 = v1 - u1, w2 = v2 - u2;
    const double L0 = d1 * w2 - d2 * w1;
    const double L1 = d2 * w0 - d0 * w2;
    const double L2 = d0 * w1 - d1 * w0;
    acc[0] += 1.0;
    acc[1] += m;
    acc[2] += m * x0;
    acc[3] += m * x1;
    acc[4] += m * x2;
    acc[5] += m * v0;
    acc[6] += m * v1;
    acc[7] += m * v2;
    acc[8] += m * L0;
    acc[9] += m * L1;
    acc[10] += m * L2;
    acc[11] += d0 * d0 * m;
    acc[12] += d0 * d1 * m;
    acc[13] += d0 * d2 * m;
    acc[14] += d1 * d1 * m;
    acc[15] += d1 * d2 * m;
    acc[16] += d2 * d2 * m;
    acc[17] += w0 * w0 * m;
    acc[18] += w0 * w1 * m;
    acc[19] += w0 * w2 * m;
    acc[20] += w1 * w1 * m;
    acc[21] += w1 * w2 * m;
    acc[22] += w2 * w2 * m;
    acc[23] += m * (w0 * w0 + w1 * w1 + w2 * w2);
    const double jz = L0 * a0 + L1 * a1 + L2 * a2;
    const double da = d0 * a0 + d1 * a1 + d2 * a2;
    const double rp2 = fmax(d0 * d0 + d1 * d1 + d2 * d2 - da * da, 1e-30);
    acc[24] += 0.5 * m * (jz * jz) / rp2;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const double f = row[7 + j];
      acc[VR_MOM_BASE + 2 * j] += f;
      acc[VR_MOM_BASE + 2 * j + 1] += m * f;
    }
  }

  double* o = out + (static_cast<long long>(s) * ng1 + g) * K;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double v = acc[k];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
    if (lane == 0) o[k] = v;
  }
}

template <int NF>
cudaError_t launch(const float* rows, int F, long long n,
                   const long long* off, int ng1, const unsigned char* sel,
                   int S, int s0, int ns, const SelTables& tab,
                   const double* ctab, const double* utab,
                   const double* atab, double* out, cudaStream_t st) {
  const long long warps = static_cast<long long>(ns) * ng1;
  const long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  moments_kernel<NF><<<static_cast<unsigned>(blocks), WARPS * 32, 0, st>>>(
      rows, F, n, off, ng1, sel, S, s0, ns, tab, ctab, utab, atab, out);
  return cudaGetLastError();
}

}  // namespace

// tab = (ns, 3) int32 on the host: each selection's (centre, velocity,
// axis) table index.  Selections s0 .. s0 + ns - 1 of the S columns of sel.
extern "C" int vr_segment_moments(const float* rows, int F, int nf,
                                  long long n, const long long* off, int ng1,
                                  const unsigned char* sel, int S, int s0,
                                  int ns, const int* tab, const double* ctab,
                                  const double* utab, const double* atab,
                                  double* out, void* stream) {
  if (ns < 0 || ns > VR_MOM_MAX_SEL || nf < 0 || nf > VR_MOM_MAX_FIELDS ||
      F < 7 + nf || s0 < 0 || s0 + ns > S || ng1 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ns == 0) return 0;
  SelTables t;
  for (int i = 0; i < ns; ++i) {
    t.c[i] = tab[3 * i];
    t.u[i] = tab[3 * i + 1];
    t.a[i] = tab[3 * i + 2];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (nf) {
    case 0: e = launch<0>(rows, F, n, off, ng1, sel, S, s0, ns, t, ctab, utab, atab, out, st); break;
    case 1: e = launch<1>(rows, F, n, off, ng1, sel, S, s0, ns, t, ctab, utab, atab, out, st); break;
    case 2: e = launch<2>(rows, F, n, off, ng1, sel, S, s0, ns, t, ctab, utab, atab, out, st); break;
    case 3: e = launch<3>(rows, F, n, off, ng1, sel, S, s0, ns, t, ctab, utab, atab, out, st); break;
    case 4: e = launch<4>(rows, F, n, off, ng1, sel, S, s0, ns, t, ctab, utab, atab, out, st); break;
    case 5: e = launch<5>(rows, F, n, off, ng1, sel, S, s0, ns, t, ctab, utab, atab, out, st); break;
    default: e = launch<6>(rows, F, n, off, ng1, sel, S, s0, ns, t, ctab, utab, atab, out, st); break;
  }
  return static_cast<int>(e);
}

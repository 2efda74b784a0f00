// The tail of ECAPA-TDNN's TDNN module in one pass forward and one backward.
//
// Replaces no TPU kernel: the JAX package has no ECAPA-TDNN. It takes the
// place of PyTorch's element-wise and reduction passes behind a masked
// training-mode TDNN (conv bias, ReLU, BatchNorm over the valid frames, the
// frame mask), which read and write each [B, C, T] activation some 50 times
// a step between them.
//
// Given z, the convolution's output without its bias ([B, C, T] float32,
// contiguous), the bias b, the BatchNorm's scale g and shift h, epsilon and
// the frame mask m [B, T] (bytes, 1 at a valid frame):
//
//   forward   r = relu(z + b); n = max(sum m, 1) over B x T;
//             mean = sum m r / n; var = sum m (r - mean)^2 / n (two passes);
//             y = (g (r - mean) rsqrt(var + eps) + h) m;
//             also mean, var and rstd = rsqrt(var + eps) per channel.
//   backward  p = dy m; xhat = (r - mean) rstd, recomputed from z;
//             dh = sum p; dg = sum p xhat;
//             dz = [r > 0] m g rstd (p - dh / n - xhat dg / n); db = sum dz.
//
// All sums run per channel over B x T in float32, in a fixed order: the
// results do not change from run to run.
//
// What bounds it: device memory. The forward reads z once and writes y once,
// the backward reads z and dy once and writes dz once; a [32, 3072, 298]
// activation is 117 MB, 35 us at 3.35 TB/s. The design keeps every other
// pass on chip: a block (or a cluster of blocks) holds a channel's B x T
// values in shared memory, the forward its ReLU outputs (a padded frame as
// -1, which no ReLU output is), the backward p, xhat and a byte that says
// whether dz is nonzero there. Both statistics passes and the write read
// them from there. Where the channels are too few to fill the card (128 of
// them against 132 SMs), or a channel too large for one block's share of
// shared memory, the wrapper splits a channel's rows over a thread-block
// cluster of up to 8 blocks (ops/tdnn_norm.py::cluster_split): each block
// reduces its rows, and the cluster adds the blocks' partial sums in rank
// order through distributed shared memory. Rows of an odd number of frames
// are 4-byte aligned only, so the loads are as wide as the frames allow:
// 16 bytes when T is a multiple of 4, else 8 bytes when T is even (T = 298),
// else 4 bytes. Each thread keeps UNROLL loads in flight.
//
// The kernels launch on the caller's stream, allocate nothing and never
// synchronise, so a CUDA graph captures them. Each launch adds one to a
// counter on the card (ops/tdnn_norm.py::launch_counts), so a launch that a
// CUDA graph replays counts as an eager one does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr int DEFAULT_SMEM = 48 * 1024;
// A padded frame among the forward's held ReLU outputs.
constexpr float PADDED = -1.0f;

template <int VEC>
struct alignas(4 * VEC) Floats {
  float v[VEC];
};

template <int VEC>
struct alignas(VEC) Bytes {
  unsigned char v[VEC];
};

struct Shape {
  int B, C, T;
  int rows;  // rows of the batch a block of the cluster takes
};

struct ForwardArgs {
  const float* z;
  const float* bias;
  const float* scale;
  const float* shift;
  const unsigned char* mask;
  float* y;
  float* mean;
  float* var;
  float* rstd;
  float epsilon;
  Shape shape;
  unsigned long long* launches;  // count_launch
};

struct BackwardArgs {
  const float* z;
  const float* dy;
  const float* bias;
  const float* scale;
  const float* mean;
  const float* rstd;
  const unsigned char* mask;
  float* dz;
  float* dbias;
  float* dscale;
  float* dshift;
  Shape shape;
  unsigned long long* launches;  // count_launch
};

// Adds one to *counter once per launch (the first thread of block 0).
__device__ __forceinline__ void count_launch(unsigned long long* counter) {
  if (counter != nullptr && threadIdx.x == 0 && blockIdx.x == 0)
    atomicAdd(counter, 1ull);
}

// This block's part of channel c: rows [row0, row0 + rows) of the batch.
struct Part {
  int c, rank, rows, vecs_a_row, vecs;
  long long row_stride;  // C * T: one row of the batch to the next
  long long first;       // offset of (row0, c, 0) in z
  long long mask_first;  // offset of (row0, 0) in the mask

  template <int VEC>
  __device__ static Part of(const Shape& s, const cg::cluster_group& cluster) {
    Part p;
    const int k = static_cast<int>(cluster.num_blocks());
    p.rank = static_cast<int>(cluster.block_rank());
    p.c = blockIdx.x / k;
    const int row0 = min(s.B, p.rank * s.rows);
    p.rows = min(s.B - row0, s.rows);
    p.vecs_a_row = s.T / VEC;
    p.vecs = p.rows * p.vecs_a_row;
    p.row_stride = static_cast<long long>(s.C) * s.T;
    p.first = row0 * p.row_stride + static_cast<long long>(p.c) * s.T;
    p.mask_first = static_cast<long long>(row0) * s.T;
    return p;
  }

  // Offset in z of this part's VEC-wide vector v (held at v * VEC).
  template <int VEC>
  __device__ long long at(int v) const {
    const int r = v / vecs_a_row;
    return first + r * row_stride + (v - r * vecs_a_row) * VEC;
  }
};

// Every thread gets the block's sums of v, added in a fixed order.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) scratch[warp * N + i] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += scratch[w * N + i];
    v[i] = s;
  }
  __syncthreads();
}

// Every thread of every block of the cluster gets the cluster's sums of the
// blocks' sums v, added in rank order through distributed shared memory.
// ``slot`` (N floats) is read by the other blocks: the caller syncs the
// cluster once more before its block leaves.
template <int N>
__device__ __forceinline__ void cluster_sum(float (&v)[N], float* slot,
                                            cg::cluster_group& cluster) {
  if (threadIdx.x == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) slot[i] = v[i];
  cluster.sync();
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = 0.f;
  const unsigned k = cluster.num_blocks();
  for (unsigned r = 0; r < k; ++r) {
    const float* part = cluster.map_shared_rank(slot, r);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += part[i];
  }
}

__device__ __forceinline__ float relu(float s) { return s < 0.f ? 0.f : s; }

template <int VEC>
__global__ void __launch_bounds__(THREADS)
    tdnn_norm_forward(const ForwardArgs a) {
  extern __shared__ __align__(16) float held[];  // rows * T ReLU outputs
  __shared__ float scratch[WARPS * 2];
  __shared__ float slots[2][2];
  cg::cluster_group cluster = cg::this_cluster();
  const Part p = Part::of<VEC>(a.shape, cluster);
  count_launch(a.launches);
  const float b = a.bias[p.c];

  float acc[2] = {0.f, 0.f};  // sum of valid r, valid frames
  for (int v0 = threadIdx.x; v0 < p.vecs; v0 += THREADS * UNROLL) {
    Floats<VEC> x[UNROLL];
    Bytes<VEC> keep[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * THREADS;
      if (v < p.vecs) {
        x[u] = *reinterpret_cast<const Floats<VEC>*>(a.z + p.at<VEC>(v));
        keep[u] = *reinterpret_cast<const Bytes<VEC>*>(
            a.mask + p.mask_first + static_cast<long long>(v) * VEC);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * THREADS;
      if (v < p.vecs) {
        Floats<VEC> h;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float r = relu(x[u].v[j] + b);
          if (keep[u].v[j]) {
            acc[0] += r;
            acc[1] += 1.f;
            h.v[j] = r;
          } else {
            h.v[j] = PADDED;
          }
        }
        *reinterpret_cast<Floats<VEC>*>(held + v * VEC) = h;
      }
    }
  }
  block_sum(acc, scratch);
  cluster_sum(acc, slots[0], cluster);
  const float n = fmaxf(acc[1], 1.f);
  const float mean = acc[0] / n;

  float sq[1] = {0.f};
  const int values = p.vecs * VEC;
  for (int i = threadIdx.x; i < values; i += THREADS) {
    const float r = held[i];
    if (r != PADDED) {
      const float d = r - mean;
      sq[0] += d * d;
    }
  }
  block_sum(sq, scratch);
  cluster_sum(sq, slots[1], cluster);
  const float var = sq[0] / n;
  const float rstd = rsqrtf(var + a.epsilon);
  const float mul = rstd * a.scale[p.c], shift = a.shift[p.c];
  if (p.rank == 0 && threadIdx.x == 0) {
    a.mean[p.c] = mean;
    a.var[p.c] = var;
    a.rstd[p.c] = rstd;
  }

  for (int v = threadIdx.x; v < p.vecs; v += THREADS) {
    const Floats<VEC> h =
        *reinterpret_cast<const Floats<VEC>*>(held + v * VEC);
    Floats<VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      out.v[j] = h.v[j] == PADDED ? 0.f : (h.v[j] - mean) * mul + shift;
    *reinterpret_cast<Floats<VEC>*>(a.y + p.at<VEC>(v)) = out;
  }
  cluster.sync();  // no block leaves while another may read its slots
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
    tdnn_norm_backward(const BackwardArgs a) {
  // rows * T each: p, xhat, then one byte a value: dz may be nonzero
  extern __shared__ __align__(16) float held[];
  __shared__ float scratch[WARPS * 3];
  __shared__ float slots[2][3];
  cg::cluster_group cluster = cg::this_cluster();
  const Part p = Part::of<VEC>(a.shape, cluster);
  count_launch(a.launches);
  const int values = p.vecs * VEC;
  float* held_p = held;
  float* held_xhat = held + values;
  unsigned char* live = reinterpret_cast<unsigned char*>(held + 2 * values);
  const float b = a.bias[p.c], mean = a.mean[p.c], rstd = a.rstd[p.c];

  float acc[3] = {0.f, 0.f, 0.f};  // sum p, sum p xhat, valid frames
  for (int v0 = threadIdx.x; v0 < p.vecs; v0 += THREADS * UNROLL) {
    Floats<VEC> x[UNROLL], g[UNROLL];
    Bytes<VEC> keep[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * THREADS;
      if (v < p.vecs) {
        const long long at = p.at<VEC>(v);
        x[u] = *reinterpret_cast<const Floats<VEC>*>(a.z + at);
        g[u] = *reinterpret_cast<const Floats<VEC>*>(a.dy + at);
        keep[u] = *reinterpret_cast<const Bytes<VEC>*>(
            a.mask + p.mask_first + static_cast<long long>(v) * VEC);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * THREADS;
      if (v < p.vecs) {
        Floats<VEC> hp, hx;
        Bytes<VEC> hl;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float r = relu(x[u].v[j] + b);
          const float xhat = (r - mean) * rstd;
          const bool valid = keep[u].v[j] != 0;
          const float pv = valid ? g[u].v[j] : 0.f;
          if (valid) {
            acc[0] += pv;
            acc[1] += pv * xhat;
            acc[2] += 1.f;
          }
          hp.v[j] = pv;
          hx.v[j] = xhat;
          hl.v[j] = valid && !(r <= 0.f);
        }
        *reinterpret_cast<Floats<VEC>*>(held_p + v * VEC) = hp;
        *reinterpret_cast<Floats<VEC>*>(held_xhat + v * VEC) = hx;
        *reinterpret_cast<Bytes<VEC>*>(live + v * VEC) = hl;
      }
    }
  }
  block_sum(acc, scratch);
  cluster_sum(acc, slots[0], cluster);
  const float n = fmaxf(acc[2], 1.f);
  const float mean_p = acc[0] / n, mean_px = acc[1] / n;
  const float mul = a.scale[p.c] * rstd;

  float dsum[1] = {0.f};
  for (int v = threadIdx.x; v < p.vecs; v += THREADS) {
    const Floats<VEC> hp =
        *reinterpret_cast<const Floats<VEC>*>(held_p + v * VEC);
    const Floats<VEC> hx =
        *reinterpret_cast<const Floats<VEC>*>(held_xhat + v * VEC);
    const Bytes<VEC> hl = *reinterpret_cast<const Bytes<VEC>*>(live + v * VEC);
    Floats<VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      out.v[j] = hl.v[j] ? mul * (hp.v[j] - mean_p - hx.v[j] * mean_px) : 0.f;
      dsum[0] += out.v[j];
    }
    *reinterpret_cast<Floats<VEC>*>(a.dz + p.at<VEC>(v)) = out;
  }
  block_sum(dsum, scratch);
  cluster_sum(dsum, slots[1], cluster);
  if (p.rank == 0 && threadIdx.x == 0) {
    a.dbias[p.c] = dsum[0];
    a.dscale[p.c] = acc[1];
    a.dshift[p.c] = acc[0];
  }
  cluster.sync();  // no block leaves while another may read its slots
}

template <typename Args>
cudaError_t launch(void (*kernel)(Args), const Args& args, int cluster,
                   size_t smem, cudaStream_t stream) {
  if (smem > DEFAULT_SMEM) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(args.shape.C * cluster);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&config, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

Shape shape_of(int B, int C, int T, int cluster) {
  return Shape{B, C, T, (B + cluster - 1) / cluster};
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. ``vec`` (1, 2 or
// 4) divides T and the alignment of every pointer of [B, C, T] and of the
// mask; ``cluster`` (1 to 8) is at most B; ``launches`` (or null) gains one
// on the card per launch.
int lidbox_tdnn_norm_forward(const float* z, const float* bias,
                             const float* scale, const float* shift,
                             const unsigned char* mask, float* y, float* mean,
                             float* var, float* rstd, int B, int C, int T,
                             float epsilon, int cluster, int vec,
                             unsigned long long* launches, void* stream) {
  const ForwardArgs args{z, bias, scale, shift, mask, y, mean, var, rstd,
                         epsilon, shape_of(B, C, T, cluster), launches};
  const size_t smem = sizeof(float) * args.shape.rows * T;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4: return launch(tdnn_norm_forward<4>, args, cluster, smem, s);
    case 2: return launch(tdnn_norm_forward<2>, args, cluster, smem, s);
    case 1: return launch(tdnn_norm_forward<1>, args, cluster, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

int lidbox_tdnn_norm_backward(const float* z, const float* dy,
                              const float* bias, const float* scale,
                              const float* mean, const float* rstd,
                              const unsigned char* mask, float* dz,
                              float* dbias, float* dscale, float* dshift,
                              int B, int C, int T, int cluster, int vec,
                              unsigned long long* launches, void* stream) {
  const BackwardArgs args{z, dy, bias, scale, mean, rstd, mask, dz,
                          dbias, dscale, dshift, shape_of(B, C, T, cluster),
                          launches};
  const size_t smem = (2 * sizeof(float) + 1) * args.shape.rows * T;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4: return launch(tdnn_norm_backward<4>, args, cluster, smem, s);
    case 2: return launch(tdnn_norm_backward<2>, args, cluster, smem, s);
    case 1: return launch(tdnn_norm_backward<1>, args, cluster, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* lidbox_tdnn_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Fused waveform -> log-Mel kernel for Hopper (sm_90a) on the tensor cores.
//
// Replaces the TPU kernel lidbox_tpu/ops/logmel.py::_logmel_kernel_packed
// (launched by fused_logmel_packed). It computes the same function:
//
//   out[b, f, m] = log( sum_k |sum_n x[b, f*step + n] W[n, k]|^2 M[k, m] + 1e-6 )
//
// with W the Hann-windowed DFT basis and M the HTK mel matrix, both built on
// the host (lidbox_tpu_torch/ops/logmel.py::kernel_bases). Neither the frame
// tensor nor the power spectrogram goes to device memory.
//
// What bounds it: operations. At b32 x 4 s (25/10 ms, fft 512, 64 mel) the
// two products are 5.41 GFLOP against 11.5 MB of signal in and log-Mel out.
// "highest" runs them as 3xTF32 (three TF32 products per product, the
// multi-pass split the TPU kernel's HIGHEST precision runs on its matrix
// unit): 16.2 GFLOP at 495 TFLOP/s, 33 us. "bf16" runs one bf16 product at
// 989 TFLOP/s, 5.5 us. The bytes take 3.4 us.
//
// Design (warp-level mma.sync, the Ampere instructions sm_90a runs):
//   - One block of 8 warps owns BM = 32 frames of one batch row (16 where
//     the power tile leaves no room in shared memory). The DFT product
//     frames[BM, K] x W[K, 2 * NB] runs over K in chunks of 32 signal
//     columns. Each chunk of the frames is staged in shared memory,
//     double-buffered: the next chunk's loads are issued halfway through
//     this chunk's products. In "highest" the stage splits each sample into
//     TF32 hi and lo once, for all 8 warps. The row pitch is 36 words
//     ("highest") or 40 ("bf16"). The frame step is a multiple of the 32
//     banks (160 samples), so fragments read straight from the signal would
//     put all 8 rows of a fragment in one bank; with these pitches the A
//     fragment loads are conflict-free.
//   - Each warp owns all BM rows and 4 n-tiles (16 bins) a pass; a pass
//     covers 128 bins, so the served 246 bins take 2 passes. Every basis
//     element is used by exactly one warp of the block, so the basis is not
//     staged: each lane loads its B fragment from L2 (1.7 MB, resident) as
//     one 16-byte (TF32 hi|lo) or 8-byte (bf16) load, in the fragment order
//     that ops/logmel.py::mma_fragments lays out.
//   - No mma sits behind a branch. The operands are zero-padded to whole
//     chunks, passes and mel rounds (ops/logmel.py::KERNEL_PADDING): a
//     per-tile guard that the compiler cannot prove warp-uniform makes it
//     fence every mma.sync with a WARPSYNC, which serialised the products.
//   - "highest": mma.sync m16n8k8 TF32 as 3xTF32. The basis arrives split
//     into hi = tf32_rna(W) and lo = tf32_rna(W - hi) from the host; the
//     kernel splits the signal the same way (cvt.rna). hi*hi accumulates
//     in one set of registers and the small terms lo*hi + hi*lo in another,
//     added in float32 when the pass ends: the tensor cores' float32
//     accumulation is not rounded like an FMA, and with one accumulator
//     the small terms were lost against the large partial sums of the
//     low-energy bins (the lowest mel bins then sat further from a float64
//     evaluation than cuBLAS's float32). The two accumulators are why a
//     block has 32 frames: 64 registers a thread, 2 blocks per SM. Each
//     term is issued over all of a warp's tiles before the next, so that
//     dependent products do not queue. "bf16": mma.sync m16n8k16 on samples
//     and basis rounded to bfloat16, float32 accumulation: the rounding
//     points of the TPU kernel and of logmel_plain("bf16").
//   - Bin i's cos and sin are columns 2i and 2i + 1, so each thread's
//     accumulator fragment holds the real and imaginary part of its bins
//     and the power re^2 + im^2 is formed in registers, then written to the
//     on-chip power tile [BM, NB] (rounded to bfloat16 in "bf16").
//   - The mel product power[BM, NB] x M[NB, n_mel] runs on the same
//     mma.sync machinery, A from the power tile (pitch = 4 or 8 mod 32
//     words, conflict-free), and log(. + 1e-6) is applied to the
//     accumulator fragments on their way to device memory.
//
// Geometry is data: the frame step, the basis rows L (min(frame_length,
// fft_length), which reproduces tf.signal's truncation) padded to K, and
// the bin count (bins with nonzero mel weight, Nyquist included when
// fmax > rate / 2) padded to NB, are arguments, so every configuration runs
// here. The signal is never read past T, frames past num_frames are zero
// and never stored. wgmma, TMA and a grid that fills the card at batch 1
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;                         // signal columns a stage
constexpr int kWarpTiles = 4;                      // DFT n-tiles a warp a pass
constexpr int kPassTiles = kWarps * kWarpTiles;    // 32 n-tiles = 128 bins
constexpr int kMelRound = 8;                       // mel n-tiles a round

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One precision mode: the mma depth, the shared-memory row pitch residue
// that keeps its A fragment loads conflict-free, its A fragment (loaded from
// a float32 tile in shared memory), its B fragment (one load a lane) and its
// products (kTerms of them). Callers issue term 0 of every tile, then term
// 1, ...: terms into one accumulator depend on each other, and back to back
// each would wait out the whole latency of the one before.
template <bool BF16>
struct Op;

template <>
struct Op<false> {  // "highest": 3xTF32 on m16n8k8
  static constexpr int kDepth = 8;
  static constexpr int kPitchMod = 4;  // rows 4 words apart: 8 rows x 4 cols
  using B = float4;                    // {hi b0, hi b1, lo b0, lo b1}
  struct A {
    uint32_t hi[4], lo[4];
  };
  // Tile origin s (row 0, column 0 of an m16 x k8 tile), row pitch p.
  __device__ static A load_a(const float* s, int p, int g, int t) {
    const float x[4] = {s[g * p + t], s[(g + 8) * p + t], s[g * p + t + 4],
                        s[(g + 8) * p + t + 4]};
    A a;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a.hi[i] = tf32_rna(x[i]);
      a.lo[i] = tf32_rna(x[i] - __uint_as_float(a.hi[i]));
    }
    return a;
  }
  static constexpr int kTerms = 3;  // lo*hi + hi*lo + hi*hi, small first
  static constexpr int kParts = 2;  // the staged signal: hi tile, lo tile
  __device__ static void stage(float* tile, int i, int part, float v) {
    const uint32_t hi = tf32_rna(v);
    tile[i] = __uint_as_float(hi);
    tile[part + i] = __uint_as_float(tf32_rna(v - __uint_as_float(hi)));
  }
  __device__ static A load_staged(const float* s, int p, int part, int g,
                                  int t) {
    const int o[4] = {g * p + t, (g + 8) * p + t, g * p + t + 4,
                      (g + 8) * p + t + 4};
    A a;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a.hi[i] = __float_as_uint(s[o[i]]);
      a.lo[i] = __float_as_uint(s[part + o[i]]);
    }
    return a;
  }
  __device__ static void mma(float (&d)[4], const A& a, const B& b, int term) {
    const bool lo_b = term == 1;
    mma_tf32(d, term == 0 ? a.lo : a.hi,
             __float_as_uint(lo_b ? b.z : b.x),
             __float_as_uint(lo_b ? b.w : b.y));
  }
  __device__ static float round(float x) { return x; }
};

template <>
struct Op<true> {  // "bf16": one bf16 product on m16n8k16
  static constexpr int kDepth = 16;
  static constexpr int kPitchMod = 8;  // 8-byte loads: rows 8 words apart
  using B = uint2;                     // {b0, b1}, two bf16 each
  struct A {
    uint32_t v[4];
  };
  __device__ static A load_a(const float* s, int p, int g, int t) {
    const float2 x0 = *reinterpret_cast<const float2*>(s + g * p + 2 * t);
    const float2 x1 = *reinterpret_cast<const float2*>(s + (g + 8) * p + 2 * t);
    const float2 x2 = *reinterpret_cast<const float2*>(s + g * p + 2 * t + 8);
    const float2 x3 =
        *reinterpret_cast<const float2*>(s + (g + 8) * p + 2 * t + 8);
    return A{{pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
              pack_bf16(x2.x, x2.y), pack_bf16(x3.x, x3.y)}};
  }
  static constexpr int kTerms = 1;
  static constexpr int kParts = 1;
  __device__ static void stage(float* tile, int i, int, float v) {
    tile[i] = v;
  }
  __device__ static A load_staged(const float* s, int p, int, int g, int t) {
    return load_a(s, p, g, t);
  }
  __device__ static void mma(float (&d)[4], const A& a, const B& b, int) {
    mma_bf16(d, a.v, b.x, b.y);
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// Smallest pitch >= n that is kPitchMod mod 32 words.
__host__ __device__ constexpr int pitch(int n, int mod) {
  return n + ((mod - n) % 32 + 32) % 32;
}

template <bool BF16>
size_t smem_bytes(int BM, int NB) {
  const int mod = Op<BF16>::kPitchMod;
  return ((size_t)2 * Op<BF16>::kParts * BM * pitch(kChunk, mod) +
          (size_t)BM * pitch(NB, mod)) * sizeof(float);
}

template <int MT, bool BF16>
__global__ void __launch_bounds__(kThreads, 2)
logmel_kernel(const float* __restrict__ signal,
              const typename Op<BF16>::B* __restrict__ wfrag,
              const typename Op<BF16>::B* __restrict__ mfrag,
              float* __restrict__ out, int T, int num_frames, int frame_step,
              int L, int K, int NB, int n_mel) {
  using O = Op<BF16>;
  constexpr int BM = 16 * MT;
  constexpr int P = pitch(kChunk, O::kPitchMod);
  constexpr int kTile = BM * P;                    // one part of one chunk
  constexpr int kRowsPerPass = kThreads / kChunk;  // staging: 8 frames a pass
  constexpr int kLoads = BM / kRowsPerPass;
  constexpr int kSteps = kChunk / O::kDepth;       // k-steps a chunk
  extern __shared__ __align__(16) float smem[];
  float* chunks = smem;                            // [2][kParts][BM][P]
  float* power = smem + 2 * O::kParts * kTile;     // [BM][PP]
  const int PP = pitch(NB, O::kPitchMod);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, f0 = blockIdx.x * BM;
  const int nf = min(BM, num_frames - f0);
  const float* sig = signal + (size_t)b * T + (size_t)f0 * frame_step;

  // Whole chunks and passes (KERNEL_PADDING): no mma below is guarded.
  const int NT = NB / 4;  // 8-column DFT tiles: 2 * NB columns
  const int nchunks = K / kChunk;
  const int steps = NT / kPassTiles * nchunks;

  // Staging: a warp reads 32 consecutive samples of one frame (coalesced)
  // and stores them to one row (no conflicts), split into TF32 hi and lo in
  // "highest". Samples of column >= L (zero basis rows) and of frames >= nf
  // are zero, and the signal is never read past T: every frame < nf ends at
  // or before (num_frames - 1) * step + L <= T.
  const int sc = threadIdx.x % kChunk, sr = threadIdx.x / kChunk;
  float staged[kLoads];
  auto fetch = [&](int chunk) {
    const int n = chunk * kChunk + sc;
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {
      const int f = sr + kRowsPerPass * e;
      staged[e] = (f < nf && n < L) ? sig[(size_t)f * frame_step + n] : 0.f;
    }
  };

  // acc takes hi*hi; sml the small terms of 3xTF32 (zero in bf16).
  float acc[MT][kWarpTiles][4], sml[MT][kWarpTiles][4];
  fetch(0);
  for (int it = 0; it < steps; ++it) {
    const int pass = it / nchunks, chunk = it - pass * nchunks;
    float* tile = chunks + (it & 1) * O::kParts * kTile;
#pragma unroll
    for (int e = 0; e < kLoads; ++e)
      O::stage(tile, (sr + kRowsPerPass * e) * P + sc, kTile, staged[e]);
    __syncthreads();
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int q = 0; q < kWarpTiles; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][q][r] = sml[i][q][r] = 0.f;
    }
    const int j0 = pass * kPassTiles + warp * kWarpTiles;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      if (ks == kSteps / 2 && it + 1 < steps) fetch((it + 1) % nchunks);
      const typename O::B* wp =
          wfrag + ((size_t)(chunk * kSteps + ks) * NT + j0) * 32 + lane;
      typename O::B w[kWarpTiles];
#pragma unroll
      for (int q = 0; q < kWarpTiles; ++q) w[q] = __ldg(wp + q * 32);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const typename O::A a = O::load_staged(
            tile + i * 16 * P + ks * O::kDepth, P, kTile, g, t);
#pragma unroll
        for (int term = 0; term < O::kTerms; ++term)
#pragma unroll
          for (int q = 0; q < kWarpTiles; ++q)
            O::mma(term + 1 < O::kTerms ? sml[i][q] : acc[i][q], a, w[q],
                   term);
      }
    }
    if (chunk == nchunks - 1) {
      // Columns 2t, 2t + 1 of tile j are cos and sin of bin 4j + t.
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int q = 0; q < kWarpTiles; ++q) {
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][q][r] += sml[i][q][r];
          float* p = power + (i * 16 + g) * PP + (j0 + q) * 4 + t;
          p[0] = O::round(acc[i][q][0] * acc[i][q][0] +
                          acc[i][q][1] * acc[i][q][1]);
          p[8 * PP] = O::round(acc[i][q][2] * acc[i][q][2] +
                               acc[i][q][3] * acc[i][q][3]);
        }
    }
  }
  __syncthreads();

  // Mel product, in rounds of 8 mel tiles (the fragments are padded to
  // whole rounds): warp w takes m-tile w % MT and MT of the round's tiles,
  // kWarps / MT apart; log on the way out.
  constexpr int G = kWarps / MT;
  const int mi = warp % MT, ng = warp / MT;
  const int NTM = (n_mel + 8 * kMelRound - 1) / (8 * kMelRound) * kMelRound;
  const int KM = NB / O::kDepth;
  const float* pa = power + mi * 16 * PP;
  for (int j8 = 0; j8 < NTM; j8 += kMelRound) {
    float mac[MT][4];
#pragma unroll
    for (int q = 0; q < MT; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) mac[q][r] = 0.f;
    const typename O::B* mp = mfrag + (size_t)(j8 + ng) * 32 + lane;
    for (int s = 0; s < KM; ++s) {
      typename O::B cur[MT];
#pragma unroll
      for (int q = 0; q < MT; ++q)
        cur[q] = __ldg(mp + ((size_t)s * NTM + q * G) * 32);
      const typename O::A a = O::load_a(pa + s * O::kDepth, PP, g, t);
#pragma unroll
      for (int term = 0; term < O::kTerms; ++term)
#pragma unroll
        for (int q = 0; q < MT; ++q) O::mma(mac[q], a, cur[q], term);
    }
#pragma unroll
    for (int q = 0; q < MT; ++q) {
      const int m = (j8 + ng + q * G) * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int f = mi * 16 + g + (r >> 1) * 8, mm = m + (r & 1);
        if (f < nf && mm < n_mel)
          out[((size_t)b * num_frames + f0 + f) * n_mel + mm] =
              logf(mac[q][r] + 1e-6f);
      }
    }
  }
}

template <int MT, bool BF16>
cudaError_t launch(const float* signal, const void* wfrag, const void* mfrag,
                   float* out, int B, int T, int num_frames, int frame_step,
                   int L, int K, int NB, int n_mel, cudaStream_t stream) {
  const size_t smem = smem_bytes<BF16>(16 * MT, NB);
  // Above 48 KB the launch is refused unless the kernel opts in.
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel<MT, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((num_frames + 16 * MT - 1) / (16 * MT), B);
  using W = typename Op<BF16>::B;
  logmel_kernel<MT, BF16><<<grid, kThreads, smem, stream>>>(
      signal, static_cast<const W*>(wfrag), static_cast<const W*>(mfrag), out,
      T, num_frames, frame_step, L, K, NB, n_mel);
  return cudaGetLastError();
}

// 32-frame blocks, or 16 where the power tile leaves no room.
template <bool BF16>
cudaError_t pick(size_t fits, const float* signal, const void* wfrag,
                 const void* mfrag, float* out, int B, int T, int num_frames,
                 int frame_step, int L, int K, int NB, int n_mel,
                 cudaStream_t s) {
  if (smem_bytes<BF16>(32, NB) <= fits)
    return launch<2, BF16>(signal, wfrag, mfrag, out, B, T, num_frames,
                           frame_step, L, K, NB, n_mel, s);
  if (smem_bytes<BF16>(16, NB) <= fits)
    return launch<1, BF16>(signal, wfrag, mfrag, out, B, T, num_frames,
                           frame_step, L, K, NB, n_mel, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// signal [B, T] float32; wfrag and mfrag: W [K, 2 * NB] and M [NB, n_mel
// padded to a multiple of 64] in mma fragment order
// (ops/logmel.py::mma_fragments: float32 hi|lo for "highest", bfloat16 for
// "bf16"); out [B, num_frames, n_mel] float32; all contiguous, on the
// current device. L <= K signal columns a frame; K a multiple of 32 and NB
// of 128 (whole chunks and passes, ops/logmel.py::KERNEL_PADDING). Returns the
// CUDA error of the launch (0 on success), cudaErrorInvalidValue when no
// frame tile fits the device's shared memory.
int lidbox_logmel(const float* signal, const void* wfrag, const void* mfrag,
                  float* out, int B, int T, int num_frames, int frame_step,
                  int L, int K, int NB, int n_mel, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int device, max_smem;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (bf16)
    return pick<true>((size_t)max_smem, signal, wfrag, mfrag, out, B, T,
                      num_frames, frame_step, L, K, NB, n_mel, s);
  return pick<false>((size_t)max_smem, signal, wfrag, mfrag, out, B, T,
                     num_frames, frame_step, L, K, NB, n_mel, s);
}

const char* lidbox_logmel_variant(int bf16) {
  return bf16 ? "mma.sync m16n8k16 bf16 x bf16 -> f32, one product"
              : "mma.sync m16n8k8 tf32 x tf32 -> f32, 3xTF32 "
                "(lo*hi + hi*lo + hi*hi)";
}

const char* lidbox_logmel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Fused waveform -> log-Mel kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel lidbox_tpu/ops/logmel.py::_logmel_kernel_packed
// (launched by fused_logmel_packed). It computes the same function:
//
//   out[b, f, m] = log( sum_k |sum_n x[b, f*step + n] W[n, k]|^2 M[k, m] + 1e-6 )
//
// with W the Hann-windowed DFT basis (cos | sin) and M the HTK mel matrix,
// both built on the host (lidbox_tpu_torch/ops/logmel.py). Neither the
// frame tensor nor the power spectrogram goes to device memory: one block
// owns FT frames of one batch row and keeps both in shared memory.
//
// What bounds it: the DFT contraction, about 2 * frames * L * 2 * NB
// operations (4.2 GFLOP at b32 x 3 s, 25/10 ms, fft 512, 64 mel) against
// 8.5 MB of input and output, so it is bound by operations. This first
// version runs them on the float32 CUDA cores (no tensor cores):
//   - the block's frames are staged transposed, xs[n][f], so one 16-byte
//     broadcast shared load feeds 8 FMAs and shared memory is not the limit;
//   - each thread owns one frequency bin (cos and sin columns) for all FT
//     frames, 2 * FT register accumulators, and reads its basis column with
//     coalesced loads (the basis stays in L2);
//   - the power tile [FT, NB] stays in shared memory for the mel contraction.
// wgmma, TMA and 3xTF32 are left for later work.
//
// Modes: bf16 = 0 is float32 throughout. bf16 = 1 has the TPU kernel's
// rounding points: samples rounded to bfloat16 as they are staged, basis and
// mel matrix rounded on the host, products of bfloat16 values accumulated in
// float32, and the power rounded to bfloat16 before the mel contraction.
//
// Geometry is data: the frame step, the basis rows L (min(frame_length,
// fft_length), which reproduces tf.signal's truncation) and the bin count NB
// (the bins with nonzero mel weight, Nyquist included when fmax > rate / 2)
// are arguments, so every configuration runs here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int FT>
__global__ void __launch_bounds__(kThreads)
logmel_kernel(const float* __restrict__ signal, const float* __restrict__ basis,
              const float* __restrict__ mel, float* __restrict__ out, int T,
              int num_frames, int frame_step, int L, int NB, int n_mel,
              int bf16) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                        // [L][FT] frames, transposed
  float* pw = smem + (size_t)L * FT;       // [FT][NB] power
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FT;
  const int nf = min(FT, num_frames - f0);
  const float* sig = signal + (size_t)b * T + (size_t)f0 * frame_step;

  // Consecutive threads take consecutive frames, so the shared stores do not
  // conflict; frames past the end are zero and never written out.
  for (int i = threadIdx.x; i < L * FT; i += kThreads) {
    const int f = i % FT, n = i / FT;
    float v = f < nf ? sig[(size_t)f * frame_step + n] : 0.f;
    xs[i] = bf16 ? round_bf16(v) : v;
  }
  __syncthreads();

  const size_t ld = 2 * (size_t)NB;
  for (int k = threadIdx.x; k < NB; k += kThreads) {
    float re[FT], im[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      re[f] = 0.f;
      im[f] = 0.f;
    }
    const float* wc = basis + k;
    const float* ws = basis + NB + k;
    for (int n = 0; n < L; ++n) {
      const float c = __ldg(wc + n * ld);
      const float s = __ldg(ws + n * ld);
      const float4* xv = reinterpret_cast<const float4*>(xs + (size_t)n * FT);
#pragma unroll
      for (int q = 0; q < FT / 4; ++q) {
        const float4 x = xv[q];
        re[4 * q + 0] = fmaf(x.x, c, re[4 * q + 0]);
        im[4 * q + 0] = fmaf(x.x, s, im[4 * q + 0]);
        re[4 * q + 1] = fmaf(x.y, c, re[4 * q + 1]);
        im[4 * q + 1] = fmaf(x.y, s, im[4 * q + 1]);
        re[4 * q + 2] = fmaf(x.z, c, re[4 * q + 2]);
        im[4 * q + 2] = fmaf(x.z, s, im[4 * q + 2]);
        re[4 * q + 3] = fmaf(x.w, c, re[4 * q + 3]);
        im[4 * q + 3] = fmaf(x.w, s, im[4 * q + 3]);
      }
    }
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      const float p = re[f] * re[f] + im[f] * im[f];
      pw[f * NB + k] = bf16 ? round_bf16(p) : p;
    }
  }
  __syncthreads();

  // A warp covers consecutive mel bins of one frame: the power reads are
  // shared-memory broadcasts and the mel-matrix reads are coalesced.
  for (int i = threadIdx.x; i < nf * n_mel; i += kThreads) {
    const int f = i / n_mel, m = i % n_mel;
    const float* p = pw + f * NB;
    float acc = 0.f;
    for (int k = 0; k < NB; ++k) {
      acc = fmaf(p[k], __ldg(mel + (size_t)k * n_mel + m), acc);
    }
    out[((size_t)b * num_frames + f0 + f) * n_mel + m] = logf(acc + 1e-6f);
  }
}

// Shared memory of one block of FT frames: the frames and the power tile.
size_t smem_bytes(int FT, int L, int NB) {
  return ((size_t)L * FT + (size_t)FT * NB) * sizeof(float);
}

template <int FT>
cudaError_t launch(const float* signal, const float* basis, const float* mel,
                   float* out, int B, int T, int num_frames, int frame_step,
                   int L, int NB, int n_mel, int bf16, cudaStream_t stream) {
  const size_t smem = smem_bytes(FT, L, NB);
  // Above 48 KB the launch is refused unless the kernel opts in.
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel<FT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((num_frames + FT - 1) / FT, B);
  logmel_kernel<FT><<<grid, kThreads, smem, stream>>>(
      signal, basis, mel, out, T, num_frames, frame_step, L, NB, n_mel, bf16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// signal [B, T], basis [L, 2 * NB], mel [NB, n_mel], out [B, num_frames,
// n_mel]: float32, contiguous, on the current device. Runs the largest frame
// tile (32, 16, 8 or 4) whose shared memory fits one block of the device.
// Returns the CUDA error of the launch (0 on success), cudaErrorInvalidValue
// when no tile fits.
int lidbox_logmel(const float* signal, const float* basis, const float* mel,
                  float* out, int B, int T, int num_frames, int frame_step,
                  int L, int NB, int n_mel, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int device, max_smem;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t fits = (size_t)max_smem;
  if (smem_bytes(32, L, NB) <= fits)
    return launch<32>(signal, basis, mel, out, B, T, num_frames, frame_step,
                      L, NB, n_mel, bf16, s);
  if (smem_bytes(16, L, NB) <= fits)
    return launch<16>(signal, basis, mel, out, B, T, num_frames, frame_step,
                      L, NB, n_mel, bf16, s);
  if (smem_bytes(8, L, NB) <= fits)
    return launch<8>(signal, basis, mel, out, B, T, num_frames, frame_step,
                     L, NB, n_mel, bf16, s);
  if (smem_bytes(4, L, NB) <= fits)
    return launch<4>(signal, basis, mel, out, B, T, num_frames, frame_step,
                     L, NB, n_mel, bf16, s);
  return (int)cudaErrorInvalidValue;
}

const char* lidbox_logmel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

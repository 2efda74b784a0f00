// Fused waveform -> log-Mel kernel for Hopper (sm_90a): wgmma fed by a ring
// of bulk-copied basis tiles.
//
// Replaces the TPU kernel lidbox_tpu/ops/logmel.py::_logmel_kernel_packed
// (launched by fused_logmel_packed). It computes the same function:
//
//   out[b, f, m] = log( sum_k |sum_n x[b, f*step + n] W[n, k]|^2 M[k, m] + 1e-6 )
//
// with W the Hann-windowed DFT basis and M the HTK mel matrix, both built and
// laid out on the host (lidbox_tpu_torch/ops/logmel.py: kernel_bases,
// basis_tiles, mel_tiles, kernel_plan). Neither the frame tensor nor the
// power spectrogram goes to device memory, nor even to shared memory.
//
// What bounds it on an H100. Operations: at b32 x 4 s (25/10 ms, fft 512,
// 64 mel) the two products are 5.41 GFLOP; "highest" runs them as 3xTF32,
// 16.2 GFLOP at 495 TFLOP/s = 33 us; "bf16" as one bf16 product at 989
// TFLOP/s = 5.5 us. Bytes from device memory: 11.5 MB of signal in and
// log-Mel out, 3.4 us. Bytes from L2: the basis (hi|lo float32 in
// "highest", 416 x 512 x 8 B = 1.7 MB) is read by every block. With blocks
// of 32 frames (the mma.sync kernel this one replaces) that was 709 MB a
// launch at b32 x 4 s, ~5 TB/s of L2 for 0.14 ms: the basis stream, not the
// tensor cores, set the time.
//
// Design:
//   - A block is one producer warpgroup and two consumer warpgroups (one
//     where the signal span does not fit twice in shared memory). Each
//     consumer owns a tile of 64 consecutive frames of one batch row (the
//     wgmma M); the block's two tiles are consecutive in the flattened list
//     of tiles and may come from two rows. So every basis byte fetched from
//     L2 serves 128 frames: 112 blocks read 206 MB at b32 x 4 s (the
//     mma.sync kernel's blocks of 32 frames read 709 MB).
//   - The basis moves through shared memory by the TMA engine. The host
//     lays out each (bin pass, 32-row chunk) tile of W^T contiguously in the
//     order wgmma's no-swizzle K-major descriptor reads it (core matrices of
//     8 columns x 16 bytes), hi then lo, so one 1-D cp.async.bulk copies a
//     tile (16 KB in "highest", 4 KB in "bf16") and needs no tensor map. One
//     thread of the producer keeps a ring of stages (two passes' tiles
//     each) in flight with full/empty mbarriers; the mel rows of each pass
//     come the same way into a ring of two slots.
//   - The signal is read once per tile: each consumer stages the span of its
//     64 frames (63 steps + K samples, 42 KB at 25/10 ms) into shared memory
//     with 4-byte cp.async (a row's start is not 16-byte aligned for odd T),
//     zero past T, in rows of frame_step samples with a pitch of 4 mod 32
//     words ("highest") or 8 ("bf16"). The frame step, 160 samples, is 0 mod
//     32 banks; in these rows the A fragment loads of a k-step touch 32
//     distinct banks (8 frames x 4 columns). A table of K span offsets
//     ((k / step) * pitch + k % step, each lane's columns of a k-step side
//     by side) is built once per block, so any step works and a lane finds
//     a k-step's offsets in one 8- or 16-byte load.
//   - "highest": wgmma m64n64k8 tf32 with A from registers (the signal split
//     into TF32 hi and lo by cvt.rna as it is loaded) and B from the ring,
//     3xTF32: hi*hi in one accumulator, lo*hi + hi*lo in another, added when
//     a pass of 32 bins ends. The tensor cores' float32 accumulation is not
//     rounded like an FMA: with one accumulator the small terms were lost
//     against the large partial sums of quiet bins. The DFT is summed in
//     the order of the mma.sync kernel this one replaces. "bf16": wgmma
//     m64n64k16 on samples and basis rounded to bfloat16, the even and odd
//     k-steps in two float32 accumulators, the rounding points of
//     logmel_plain("bf16").
//   - The mel product is folded into each pass in registers. Bin 4i + t's
//     cos and sin are columns 8i + 2t, 8i + 2t + 1 of a pass, so lane (g, t)
//     of a warp holds the power of bin 4i + t at rows g and g + 8: in
//     "highest" exactly the A fragment of the m64nNk8 tf32 k-step over bins
//     8s..8s + 7 (chunks 2s and 2s + 1); in "bf16" the k16 fragment wants
//     bins {2t, 2t + 1, 2t + 8, 2t + 9} where the lane holds {t, 4 + t, 8 + t,
//     12 + t}, so the host permutes M's rows within each 16-bin step. The
//     power (rounded to bfloat16 in "bf16") is multiplied by the pass's rows
//     of M (one wgmma of N = 32 * MC) into a mel accumulator that lives
//     across passes: one accumulator with all three 3xTF32 products, as
//     every term of the mel sum is non-negative. log(. + 1e-6) is applied on
//     the way out.
//   - Two bin passes a chunk: a ring stage holds the chunk's tiles of two
//     passes, and the A fragments a consumer loads and splits feed both
//     passes' products. Loading and splitting a chunk's (16 samples a lane,
//     cvt.rna emulated in four instructions) took longer than one pass's
//     12 wgmmas on it; shared by two passes, the tensor cores wait less.
//     "highest" loads a chunk in two halves (6 wgmmas a pass each), and a
//     consumer waits for its products before it loads the next half into
//     the same registers: the other consumer's products fill that time.
//   - Registers: 4 x 32 for the two passes' DFT accumulators, 16 for half
//     a chunk's A fragments ("highest" loads a chunk in two halves), 16 * MC
//     for a pass's mel product while it is folded; the running mel sum
//     waits in shared memory. setmaxnreg gives the consumers 232 registers
//     and leaves the producer 40. Above 64 mel columns (MC > 2) a chunk
//     feeds one pass, so that nothing spills.
//   - Where the frame tiles cannot fill the card (a streaming chunk is 4
//     tiles), the bin passes of a tile are split over blockIdx.y. Each pass's
//     mel product starts from zero and the passes are added in pass order,
//     rounded to nearest: an unsplit block adds them in registers; split,
//     the first split writes the sum of its passes and the others each
//     pass's sums to a [passes - pps + 1, B, frames, n_mel] buffer, and
//     logmel_reduce adds the slices in the same order and takes the log. So
//     the result depends neither on the order blocks ran in nor on the
//     batch a row came in. More than 128 mel bins run in rounds over
//     blockIdx.z (each recomputes the DFT).
//
// Geometry is data (frame step, basis rows L padded to K, bins, mel bins,
// the span pitch): kernel_plan computes it on the host and passes it in, so
// every configuration runs here. The signal is never read past T, frames
// past num_frames are computed on zeros and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;       // basis rows (signal columns) of a ring stage
constexpr int kTileFrames = 64;  // frames of a consumer warpgroup: wgmma M
constexpr int kMelSlots = 2;
constexpr int kMaxConsumers = 2;
constexpr int kThreads = 128 * (1 + kMaxConsumers);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Both modes' tile geometry. A core matrix is 8 rows of 16 bytes; within a
// k-step the two K halves are kLbo apart and the 8-column groups 128 bytes.
template <bool BF16>
struct Mode {
  static constexpr int kDepth = BF16 ? 16 : 8;          // wgmma K
  static constexpr int kSteps = kChunk / kDepth;        // k-steps a stage
  static constexpr int kStepBytes = 2048;               // 64 cols x k-step
  static constexpr int kTileBytes = kSteps * kStepBytes * (BF16 ? 1 : 2);
  static constexpr int kStageBytes = 2 * kTileBytes;  // two passes' tiles
  static constexpr int kStages = BF16 ? 4 : 2;
  // passes whose products share a chunk's A fragments: two, one where
  // more than 64 mel columns leave no registers for a second pass's
  // accumulators
  __host__ __device__ static constexpr int group(int mc) {
    return mc <= 2 ? 2 : 1;
  }
  static constexpr int kMelChunkBytes = BF16 ? 2048 : 8192;  // 32 mel cols
};

struct Params {
  const float* signal;
  const char* wtiles;
  const char* mtiles;
  float* out;
  float* partial;
  unsigned long long* launches;  // [2] launch counts (count_launch)
  int B, T, F, step, K, nchunks, passes, pps, splits, n_mel, mc, rounds,
      tiles_per_row, total_tiles, nwg, pitch, rows, cols, span_floats, smem;
};
constexpr int kGeoInts = 20;  // the ints of Params, in order, from the host

// Adds one to *counter once per launch (the first thread of block 0), so
// that a launch replayed from a CUDA graph counts as an eager one does.
__device__ __forceinline__ void count_launch(unsigned long long* counter) {
  if (counter != nullptr && threadIdx.x == 0 && blockIdx.x == 0 &&
      blockIdx.y == 0 && blockIdx.z == 0)
    atomicAdd(counter, 1ull);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// cvt.rna.tf32 of a finite x (rounding half away from zero at bit 13), in
// two integer operations where the instruction takes four. Only for the lo
// half of a split: when x is inf or NaN the hi half already carries it.
__device__ __forceinline__ uint32_t tf32_rna_finite(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// --- mbarriers and bulk copies ---------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Waits for the phase of `parity` to complete. A wait of more than ~10 s
// (a barrier that can never complete) traps: the launch then fails with an
// error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > 20000000000LL) __trap();
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 4 bytes global -> shared; zero when src_bytes is 0
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// --- wgmma ------------------------------------------------------------------

// No-swizzle K-major shared-memory descriptor: start address, leading byte
// offset (the two K halves of a k-step), stride byte offset (8-column groups),
// all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma operands across
// the asynchronous instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// D[64 x N] (+)= A[64 x k] (registers) B[k x N] (shared memory). Warp w of the
// warpgroup holds rows 16w..16w + 15; lane 4g + t holds A (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4) for tf32 and the pairs (g, 2t..2t + 1), (g + 8,
// ...), (g, 2t + 8..2t + 9), (g + 8, ...) for bf16, and D[4i + 2h + e] =
// (g + 8h, 8i + 2t + e). scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n96(float (&d)[48], const uint32_t (&a)[4],
                                                   uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n32(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n96(float (&d)[48], const uint32_t (&a)[4],
                                                   uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// The mel product's wgmma: N = 32 * MC columns; `keep` 0 starts D anew.
template <int MC, bool BF16>
__device__ __forceinline__ void wgmma_mel(float (&d)[16 * MC],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int keep) {
  if constexpr (BF16) {
    if constexpr (MC == 1) wgmma_bf16_n32(d, a, desc, keep);
    else if constexpr (MC == 2) wgmma_bf16_n64(d, a, desc, keep);
    else if constexpr (MC == 3) wgmma_bf16_n96(d, a, desc, keep);
    else wgmma_bf16_n128(d, a, desc, keep);
  } else {
    if constexpr (MC == 1) wgmma_tf32_n32(d, a, desc, keep);
    else if constexpr (MC == 2) wgmma_tf32_n64(d, a, desc, keep);
    else if constexpr (MC == 3) wgmma_tf32_n96(d, a, desc, keep);
    else wgmma_tf32_n128(d, a, desc, keep);
  }
}

// The A fragments of kSteps k-steps of a chunk (16 frames a warp) and
// their products. "highest": 2 k-steps (half a chunk) of TF32 hi and lo;
// "bf16": 2 k-steps (a whole chunk) of bfloat16 pairs. Lane (g, t) reads frames g (row0) and g + 8 (row1) at the
// span offsets of its columns, kCols offsets a k-step from the table kt.
template <bool BF16>
struct Chunk;

template <>
struct Chunk<false> {
  static constexpr int kSteps = 2;  // half a stage: 16 registers
  static constexpr int kCols = 2;   // columns t, t + 4 of a k-step
  uint32_t hi[kSteps][4], lo[kSteps][4];
  __device__ __forceinline__ void load(const float* row0, const float* row1,
                                       const int* kt) {
    int2 o[kSteps];
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      o[ks] = *reinterpret_cast<const int2*>(kt + ks * 4 * kCols);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const float x[4] = {row0[o[ks].x], row1[o[ks].x], row0[o[ks].y],
                          row1[o[ks].y]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[ks][i] = tf32_rna(x[i]);
        lo[ks][i] = tf32_rna_finite(x[i] - __uint_as_float(hi[ks][i]));
      }
    }
  }
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      fence_regs(hi[ks]);
      fence_regs(lo[ks]);
    }
  }
  // hi*hi into acc, lo*hi + hi*lo into sml; `keep` 0 starts both anew.
  // desc: this half's first k-step; the tile's lo half lies kLo further.
  __device__ __forceinline__ void issue(float (&acc)[32], float (&sml)[32],
                                        uint64_t desc, bool keep) {
    constexpr uint64_t kLo = 4 * 2048 >> 4;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const uint64_t dhi = desc + (ks * 2048 >> 4);
      wgmma_tf32_n64(sml, lo[ks], dhi, keep || ks > 0);
      wgmma_tf32_n64(acc, hi[ks], dhi, keep || ks > 0);
      wgmma_tf32_n64(sml, hi[ks], dhi + kLo, 1);
    }
  }
};

template <>
struct Chunk<true> {
  static constexpr int kSteps = 2;  // a whole stage: 8 registers
  static constexpr int kCols = 4;   // columns 2t, 2t + 1, 2t + 8, 2t + 9
  uint32_t a[2][4];
  __device__ __forceinline__ void load(const float* row0, const float* row1,
                                       const int* kt) {
    int4 o[2];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      o[ks] = *reinterpret_cast<const int4*>(kt + ks * 4 * kCols);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      a[ks][0] = pack_bf16(row0[o[ks].x], row0[o[ks].y]);
      a[ks][1] = pack_bf16(row1[o[ks].x], row1[o[ks].y]);
      a[ks][2] = pack_bf16(row0[o[ks].z], row0[o[ks].w]);
      a[ks][3] = pack_bf16(row1[o[ks].z], row1[o[ks].w]);
    }
  }
  __device__ __forceinline__ void fence() {
    fence_regs(a[0]);
    fence_regs(a[1]);
  }
  // k-step 0 into acc, 1 into acc2: two chains of dependent wgmmas
  __device__ __forceinline__ void issue(float (&acc)[32], float (&acc2)[32],
                                        uint64_t desc, bool keep) {
    wgmma_bf16_n64(acc, a[0], desc, keep);
    wgmma_bf16_n64(acc2, a[1], desc + (2048 >> 4), keep);
  }
};

template <bool BF16, int MC>
__global__ void __launch_bounds__(kThreads, 1) logmel_kernel(const Params p) {
  using O = Mode<BF16>;
  constexpr int S = O::kStages, G = O::group(MC);
  constexpr int kMelTile = MC * O::kMelChunkBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;                         // [S][2 tiles]
  unsigned char* mslots = ring + S * O::kStageBytes;  // [2][mel tile]
  float* spans = reinterpret_cast<float*>(mslots + kMelSlots * kMelTile);
  int* tables = reinterpret_cast<int*>(spans + p.nwg * p.span_floats);
  float* totals = reinterpret_cast<float*>(tables + p.nwg * p.K);
  uint64_t* full = reinterpret_cast<uint64_t*>(totals + p.nwg * 128 * 16 * MC);
  uint64_t* empty = full + S;
  uint64_t* mfull = empty + S;
  uint64_t* mempty = mfull + kMelSlots;

  const int wg = threadIdx.x / 128;  // 0: producer; 1..nwg: consumers
  const int tile0 = blockIdx.x * p.nwg;
  const int active = min(p.nwg, p.total_tiles - tile0);
  const int split = blockIdx.y, round = blockIdx.z;
  const int pass0 = split * p.pps, pass1 = min(p.passes, pass0 + p.pps);
  count_launch(p.launches);

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * active);  // one arrive a consumer warp
    }
    for (int i = 0; i < kMelSlots; ++i) {
      mbar_init(&mfull[i], 1);
      mbar_init(&mempty[i], 4 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread streams every (pass, chunk) tile of this split
    // through the ring, and each pass's mel rows into the mel slots.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const char* msrc = p.mtiles + (size_t)round * p.passes * kMelTile;
      int s = 0, ms = 0;
      uint32_t ph = 0, mph = 0;
      for (int pass = pass0; pass < pass1; pass += G) {
        const int n = min(G, pass1 - pass);  // passes of this group
        for (int c = 0; c < p.nchunks; ++c) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], n * O::kTileBytes);
          for (int j = 0; j < n; ++j)
            bulk_copy(ring + s * O::kStageBytes + j * O::kTileBytes,
                      p.wtiles + ((size_t)(pass + j) * p.nchunks + c) *
                                     O::kTileBytes,
                      O::kTileBytes, &full[s]);
          if (++s == S) {
            s = 0;
            ph ^= 1;
          }
        }
        for (int j = 0; j < n; ++j) {
          mbar_wait(&mempty[ms], mph ^ 1);
          mbar_expect_tx(&mfull[ms], kMelTile);
          bulk_copy(mslots + ms * kMelTile,
                    msrc + (size_t)(pass + j) * kMelTile, kMelTile,
                    &mfull[ms]);
          if (++ms == kMelSlots) {
            ms = 0;
            mph ^= 1;
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int cw = wg - 1;
  if (cw >= active) return;

  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = tile0 + cw;
  const int b = tile / p.tiles_per_row;
  const int f0 = (tile - b * p.tiles_per_row) * kTileFrames;
  const int nf = min(kTileFrames, p.F - f0);
  float* span = spans + cw * p.span_floats;

  // The span of the tile's frames, rows of `step` samples (`cols` of them
  // kept) at `pitch`; zero past T.
  {
    const float* sig = p.signal + (size_t)b * p.T;
    const long long s0 = (long long)f0 * p.step;
    for (int r = warp; r < p.rows; r += 4) {
      const long long sr = s0 + (long long)r * p.step;
      for (int c = lane; c < p.cols; c += 32) {
        const bool in = sr + c < p.T;
        cp_async4(span + r * p.pitch + c, in ? sig + sr + c : sig, in ? 4 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // The offset table: for k-step j and lane column t, the span offsets of
  // its kCols columns k, at (k / step) * pitch + k % step, in load order.
  constexpr int NC = Chunk<BF16>::kCols;
  int* table = tables + cw * p.K;
  for (int e = tid; e < p.K; e += 128) {
    const int i = e % NC, lt = e / NC % 4, j = e / (4 * NC);
    const int k = j * O::kDepth +
                  (BF16 ? 2 * lt + (i & 1) + 8 * (i >> 1) : lt + 4 * i);
    const int q = k / p.step;
    table[e] = q * p.pitch + k - q * p.step;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");

  const float* row0 = span + (warp * 16 + g) * p.pitch;  // frame 16w + g
  const float* row1 = row0 + 8 * p.pitch;                // frame 16w + g + 8
  const uint32_t ring_addr = smem_u32(ring), mel_addr = smem_u32(mslots);
  // this lane's table entries of chunk c: kt0 + c * kChunkInts
  const int* kt0 = table + t * NC;
  constexpr int kChunkInts = O::kSteps * 4 * NC;
  // loads (and waits) a stage: 2 in "highest", 1 in "bf16"
  constexpr int H = O::kSteps / Chunk<BF16>::kSteps;
  constexpr int kPartInts = kChunkInts / H;

  // The mel sum of the block's passes, rows 16w + g (+ 8) by the round's
  // 32 * MC columns, in shared memory ([register][thread]: no bank
  // conflicts) to leave the registers to the DFT: each pass's product
  // starts from zero and the passes are added in order, rounded to
  // nearest, as logmel_reduce adds the passes of a split launch. So a row's
  // log-Mel is the same bits whatever the batch, the split or the row's
  // place in the batch.
  float* mel = totals + cw * 128 * 16 * MC + tid;

  // Rows 16w + g (+ 8) of the tile and this round's columns of v to dst
  // [B, F, n_mel], through log(. + 1e-6) when `take_log`.
  auto store = [&](float* dst, const float (&v)[16 * MC], bool take_log) {
#pragma unroll
    for (int i = 0; i < 4 * MC; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = warp * 16 + g + 8 * h;
        if (f >= nf) continue;
        float* o = dst + ((size_t)b * p.F + f0 + f) * p.n_mel;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int mm = round * MC * 32 + 8 * i + 2 * t + e;
          const float x = v[4 * i + 2 * h + e];
          if (mm < p.n_mel) o[mm] = take_log ? logf(x + 1e-6f) : x;
        }
      }
  };
  int s = 0, ms = 0;
  uint32_t ph = 0, mph = 0;
  // A pass's power, already in the layout of the mel product's A
  // fragments: n8 group i of the accumulator holds bin 4i + t of rows g
  // (registers 4i, 4i + 1) and g + 8 (4i + 2, 4i + 3).
  auto power = [&](const float (&acc)[32], const float (&sml)[32],
                   float (&pw)[8][2]) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 4 * i + 2 * h;
        const float re = acc[r] + sml[r], im = acc[r + 1] + sml[r + 1];
        const float v = re * re + im * im;
        pw[i][h] = BF16 ? round_bf16(v) : v;
      }
  };
  // One pass's power times its rows of M, added to mel (in a later split,
  // written to the pass's slice of the partial sums).
  auto fold = [&](const float (&pw)[8][2], int pass) {
    // Every term of a pass's mel product is non-negative, so the three
    // 3xTF32 products share one accumulator.
    float part[16 * MC];
    // The pass's rows of M: k-steps MC * 1024 bytes apart, hi then lo.
    const uint64_t mel_desc =
        make_desc(mel_addr + ms * kMelTile, MC * 512, 128);
    constexpr int kMelStep = MC * 1024 >> 4;
    if constexpr (BF16) {
      // k16 step q: bins 16q + {t, 4 + t, 8 + t, 12 + t} from groups 4q..4q + 3
      uint32_t a[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        a[q][0] = pack_bf16(pw[4 * q][0], pw[4 * q + 1][0]);
        a[q][1] = pack_bf16(pw[4 * q][1], pw[4 * q + 1][1]);
        a[q][2] = pack_bf16(pw[4 * q + 2][0], pw[4 * q + 3][0]);
        a[q][3] = pack_bf16(pw[4 * q + 2][1], pw[4 * q + 3][1]);
      }
      mbar_wait(&mfull[ms], mph);
      fence_regs(a[0]);
      fence_regs(a[1]);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 2; ++q)
        wgmma_mel<MC, true>(part, a[q], mel_desc + q * kMelStep, q > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
    } else {
      // k8 step q: bins 8q + t (group 2q) and 8q + 4 + t (group 2q + 1)
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x[4] = {pw[2 * q][0], pw[2 * q][1], pw[2 * q + 1][0],
                            pw[2 * q + 1][1]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hi[q][i] = tf32_rna(x[i]);
          lo[q][i] = tf32_rna_finite(x[i] - __uint_as_float(hi[q][i]));
        }
      }
      mbar_wait(&mfull[ms], mph);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        fence_regs(hi[q]);
        fence_regs(lo[q]);
      }
      wgmma_fence();
      constexpr int kLo = 4 * kMelStep;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint64_t dhi = mel_desc + q * kMelStep;
        wgmma_mel<MC, false>(part, lo[q], dhi, q > 0);
        wgmma_mel<MC, false>(part, hi[q], dhi + kLo, 1);
        wgmma_mel<MC, false>(part, hi[q], dhi, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
    }
    if (lane == 0) mbar_arrive(&mempty[ms]);
    if (++ms == kMelSlots) {
      ms = 0;
      mph ^= 1;
    }
    if (split == 0) {
#pragma unroll
      for (int r = 0; r < 16 * MC; ++r)
        mel[r * 128] = pass == pass0 ? part[r] : mel[r * 128] + part[r];
    } else {  // slice 0 is split 0's sum, then one slice a pass
      store(p.partial + (size_t)(pass - p.pps + 1) * p.B * p.F * p.n_mel,
            part, false);
    }
  };
  // Passes run in groups of two: each chunk's A fragments feed both passes'
  // products (the stage holds both tiles), which halves the loads and
  // splits a product needs. A split's last group may have one pass.
  for (int pass = pass0; pass < pass1; pass += G) {
    const bool two = G == 2 && pass + 1 < pass1;
    // "highest": acc hi*hi, sml lo*hi + hi*lo; "bf16": acc and sml the
    // even and odd k-steps. Their sum is the pass's product; acc2, sml2
    // the second pass's.
    float acc[32], sml[32], acc2[G == 2 ? 32 : 1], sml2[G == 2 ? 32 : 1];
    auto issue = [&](Chunk<BF16>& a, bool keep, int part) {
      fence_regs(acc);
      fence_regs(sml);
      fence_regs(acc2);
      fence_regs(sml2);
      wgmma_fence();
      const uint64_t desc =
          make_desc(ring_addr + s * O::kStageBytes, 1024, 128) +
          (part * Chunk<BF16>::kSteps * O::kStepBytes >> 4);
      a.issue(acc, sml, desc, keep);
      if constexpr (G == 2)
        if (two) a.issue(acc2, sml2, desc + (O::kTileBytes >> 4), keep);
      wgmma_commit();
    };
    // One buffer of A fragments: while this consumer waits for its
    // products and loads the next ones, the other consumer's run.
    Chunk<BF16> f;
    f.load(row0, row1, kt0);
    for (int c = 0; c < p.nchunks; ++c) {
      mbar_wait(&full[s], ph);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        f.fence();
        issue(f, c > 0 || h > 0, h);
        wgmma_wait<0>();
        f.fence();
        if (h + 1 < H) {
          f.load(row0, row1, kt0 + c * kChunkInts + (h + 1) * kPartInts);
        } else {
          if (lane == 0) mbar_arrive(&empty[s]);
          if (c + 1 < p.nchunks)
            f.load(row0, row1, kt0 + (c + 1) * kChunkInts);
        }
      }
      if (++s == S) {
        s = 0;
        ph ^= 1;
      }
    }
    fence_regs(acc);
    fence_regs(sml);
    fence_regs(acc2);
    fence_regs(sml2);
    // both passes' power first: the DFT accumulators die before the folds
    float pw[8][2], pw2[8][2];
    power(acc, sml, pw);
    if constexpr (G == 2) power(acc2, sml2, pw2);
    fold(pw, pass);
    if constexpr (G == 2)
      if (two) fold(pw2, pass + 1);
  }

  // Epilogue: log on the way out; split, the first split's sum to slice 0.
  if (split == 0) {
    float v[16 * MC];
#pragma unroll
    for (int r = 0; r < 16 * MC; ++r) v[r] = mel[r * 128];
    store(p.splits == 1 ? p.out : p.partial, v, p.splits == 1);
  }
}

// out[i] = log(sum over s, in order, of partial[s, i] + 1e-6): the mel sums
// of a split launch (the first split's, then each later pass's), added as
// an unsplit block adds its passes
__global__ void logmel_reduce(const float* __restrict__ partial,
                              float* __restrict__ out, int splits, size_t n,
                              unsigned long long* launches) {
  count_launch(launches);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = partial[i];
    for (int s = 1; s < splits; ++s) v += partial[(size_t)s * n + i];
    out[i] = logf(v + 1e-6f);
  }
}

cudaError_t reduce(const float* partial, float* out, int splits, size_t n,
                   unsigned long long* launches, cudaStream_t stream) {
  const size_t threads = 256, blocks = (n + threads - 1) / threads;
  logmel_reduce<<<(unsigned)(blocks < 4096 ? blocks : 4096), threads, 0,
                  stream>>>(partial, out, splits, n, launches);
  return cudaGetLastError();
}

template <bool BF16>
size_t smem_bytes(const Params& p) {
  using O = Mode<BF16>;
  return (size_t)O::kStages * O::kStageBytes +
         (size_t)kMelSlots * p.mc * O::kMelChunkBytes +
         (size_t)p.nwg * p.span_floats * sizeof(float) +
         (size_t)p.nwg * p.K * sizeof(int) +
         (size_t)p.nwg * 128 * 16 * p.mc * sizeof(float) +
         (size_t)(2 * O::kStages + 2 * kMelSlots) * sizeof(uint64_t);
}

template <bool BF16, int MC>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.total_tiles + p.nwg - 1) / p.nwg, p.splits, p.rounds);
  logmel_kernel<BF16, MC><<<grid, 128 * (1 + p.nwg), p.smem, stream>>>(p);
  return cudaGetLastError();
}

// Above 48 KB a launch is refused unless the kernel opts in: done once per
// device for every instance (lidbox_logmel_setup), so a launch makes no
// other runtime call and a CUDA graph can capture it.
template <bool BF16, int MC>
cudaError_t opt_in(int max_smem) {
  return cudaFuncSetAttribute(logmel_kernel<BF16, MC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              max_smem);
}

template <bool BF16>
cudaError_t pick(const Params& p, cudaStream_t s) {
  switch (p.mc) {
    case 1: return launch<BF16, 1>(p, s);
    case 2: return launch<BF16, 2>(p, s);
    case 3: return launch<BF16, 3>(p, s);
    case 4: return launch<BF16, 4>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The current device's SM count and the shared memory a block may opt in
// to; kernel_plan sizes the grid and the tiles from them.
int lidbox_logmel_device(int* sms, int* max_smem) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err;
}

// Let every instance of logmel_kernel use up to max_smem bytes of dynamic
// shared memory on the current device (its opt-in limit, from
// lidbox_logmel_device). Once per device, before its first launch.
int lidbox_logmel_setup(int max_smem) {
  const cudaError_t errs[] = {
      opt_in<false, 1>(max_smem), opt_in<false, 2>(max_smem),
      opt_in<false, 3>(max_smem), opt_in<false, 4>(max_smem),
      opt_in<true, 1>(max_smem),  opt_in<true, 2>(max_smem),
      opt_in<true, 3>(max_smem),  opt_in<true, 4>(max_smem)};
  for (cudaError_t err : errs)
    if (err != cudaSuccess) return err;
  return cudaSuccess;
}

// signal [B, T] float32; wtiles and mtiles from ops/logmel.py::basis_tiles
// and mel_tiles (float32 hi|lo for "highest", bfloat16 for "bf16"); out
// [B, F, n_mel] float32; partial [passes - pps + 1, B, F, n_mel] float32
// (unused when splits is 1); all contiguous, on the current device. geo: the kGeoInts
// ints of kernel_plan, in Params' order; max_smem the device's opt-in limit
// (lidbox_logmel_setup ran with it); launches null or int64 [2] on the
// device, to which each launch of logmel_kernel adds one in [0] and each of
// logmel_reduce in [1]. Launches the kernel and, when
// splits > 1, logmel_reduce after it on the same stream, and makes no other
// runtime call: legal inside a stream capture. Returns the CUDA error of
// the launches, cudaErrorInvalidValue when the plan is inconsistent or its
// shared memory exceeds the device's.
int lidbox_logmel(const float* signal, const void* wtiles, const void* mtiles,
                  float* out, float* partial, const int* geo, int bf16,
                  int max_smem, void* launches, void* stream) {
  Params p;
  p.signal = signal;
  p.wtiles = static_cast<const char*>(wtiles);
  p.mtiles = static_cast<const char*>(mtiles);
  p.out = out;
  p.partial = partial;
  p.launches = static_cast<unsigned long long*>(launches);
  int* const fields[kGeoInts] = {
      &p.B, &p.T, &p.F, &p.step, &p.K, &p.nchunks, &p.passes, &p.pps,
      &p.splits, &p.n_mel, &p.mc, &p.rounds, &p.tiles_per_row,
      &p.total_tiles, &p.nwg, &p.pitch, &p.rows, &p.cols, &p.span_floats,
      &p.smem};
  for (int i = 0; i < kGeoInts; ++i) *fields[i] = geo[i];
  const size_t need = bf16 ? smem_bytes<true>(p) : smem_bytes<false>(p);
  if (need != (size_t)p.smem || p.smem > max_smem || p.nwg < 1 ||
      p.nwg > kMaxConsumers || (p.splits > 1 && partial == nullptr) ||
      p.span_floats % 4 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? pick<true>(p, s) : pick<false>(p, s);
  if (err != cudaSuccess || p.splits == 1) return err;
  return reduce(partial, out, p.passes - p.pps + 1,
                (size_t)p.B * p.F * p.n_mel,
                p.launches == nullptr ? nullptr : p.launches + 1, s);
}

// out [n] = log(sum over the `splits` slices of partial [splits, n] + 1e-6),
// the slices added in order; launch null or an int64 on the device that the
// launch adds one to.
int lidbox_logmel_reduce(const float* partial, float* out, int splits,
                         long long n, void* launch, void* stream) {
  return reduce(partial, out, splits, (size_t)n,
                static_cast<unsigned long long*>(launch),
                static_cast<cudaStream_t>(stream));
}

const char* lidbox_logmel_variant(int bf16) {
  return bf16
      ? "wgmma m64n64k16 bf16 x bf16 -> f32 (A from registers), two bin "
        "passes a chunk, mel folded in as m64n64k16; 2 x 64-frame "
        "warpgroup tiles a block; ring of 4 x 8 KB stages (two passes' "
        "basis tiles) by cp.async.bulk + mbarrier"
      : "wgmma m64n64k8 tf32 x tf32 -> f32 (A from registers), 3xTF32 "
        "(lo*hi + hi*lo | hi*hi), two bin passes a chunk, mel folded in as "
        "m64n64k8; 2 x 64-frame warpgroup tiles a block; ring of 2 x 32 KB "
        "stages (two passes' basis tiles) by cp.async.bulk + mbarrier";
}

const char* lidbox_logmel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

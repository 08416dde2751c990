// Int8 implicit-GEMM convolution for Hopper (sm_90a), K4: int8 NHWC
// activations x int8 [Co, kh, kw, Ci] weights, summed in int32 on the
// tensor cores, then the fused epilogue: dequantize, bias, cast to the
// compute dtype, frozen-BN affine, the bottleneck's residual add, ReLU,
// into float32 or bfloat16 NHWC, and the per-image max |y| of what it
// stores (the next conv's quantizer, K5, then reads y once).
//
// Replaces the int32 convolution of the JAX package's Int8Conv
// (deepemia_tpu/models/quant.py:105, lax.conv_general_dilated with
// preferred_element_type=jnp.int32): an XLA int8 convolution, not a Pallas
// kernel, followed there by the dequantize of quant.py:113-119 and, in the
// trunk, the frozen norm and ReLU that XLA fuses into it. Its plain
// counterpart is deepemia_tpu_torch/kernels/int8_conv.py:int8_conv2d_plain.
//
// The GEMM: M = N*Ho*Wo output pixels, N = Co, K = kh*kw*Ci with k ordered
// (r, s, c) as the weights are, so an output pixel's row of the implicit
// im2col matrix is kh*kw runs of Ci contiguous input bytes. Both operands
// are K-major, the one layout wgmma takes for 8-bit types.
//
// Bound (chip_smoke.py:conv_work): per conv the larger of 2*M*N*K over
// 1,979 int8 TOPS and the int8 input, weights and per-image and
// per-channel maxima read once, the residual read once where the epilogue
// adds one, and the output (and the per-image max) written once over
// 3.35 TB/s; bytes at most shapes of an R50 trunk forward (most are 1x1
// convs with K = 64-1024 bytes, whose bf16 output, and the conv3s'
// residual, are most of the traffic; PERF.md).
//
// What held the first design (mma.sync) to 23 % of that bound, and
// what this one does about each:
//   * mma.sync m16n8k32 from 32-bit shared loads into 164 registers a
//     thread (one 8-warp block per SM): wgmma.mma_async m64nNk32 s8 reads
//     both operands from shared memory through descriptors, N = 128, or 64
//     for the Co = 64 convs (stem, res2 conv1/conv2).
//   * two cp.async stages and a __syncthreads per 64-byte K step: a ring
//     of stages of 128 bytes of K (4 for N = 128 and 6 for N = 64 in bf16;
//     2 and 4 in float32, whose output tiles take more shared memory), each
//     with a full and an empty mbarrier, between one producer warpgroup and
//     two consumer warpgroups; setmaxnreg moves registers from the producer
//     (72) to the consumers (216).
//   * weights: TMA (cp.async.bulk.tensor) from a 2D tensor map over
//     [Co, K] with 128-byte swizzle, out-of-range rows and K read as zeros.
//     The maps are encoded on the host through the runtime's
//     cudaGetDriverEntryPoint("cuTensorMapEncodeTiled"), so the build
//     links nothing beyond the runtime.
//   * activations: a 1x1 stride-1 conv without padding reads a plain
//     [M, Ci] matrix, loaded by TMA like the weights. Every other conv's
//     implicit im2col is 16-byte cp.async with zero fill, through L1 (.ca:
//     a tile reads each input pixel for several taps), issued by the
//     producer warpgroup into the 128-byte-swizzled slot and completed on
//     the stage's full barrier by cp.async.mbarrier.arrive.noinc; a tap
//     table (K chunk -> offset, r, s) and a per-tile row table in shared
//     memory replace the divisions. Chosen over TMA's im2col mode because
//     a 128-byte K step spans 8 taps of the stem and 2 of res2's 3x3 (Ci =
//     64) and a tile's 128 rows cross output rows and images: per-thread
//     addresses take every Ci % 16 == 0 with one code path, and padding,
//     ragged M and ragged K read as zeros. These loads, not the products,
//     hold the 3x3 convs (PERF.md, Findings).
//   * the stem's 4-byte loads of 3 channels: K reads whole 16-byte channel
//     groups (Ci % 16 == 0; the wrapper raises on other counts), and the
//     module runs the stem as a 4x4 stride-1 conv over 2x2 blocks of
//     pixels, 16 channels (12 values and 4 zeros, exact: zero products add
//     nothing; models/quant.py:space_to_depth_weights, K5 writes that
//     layout), K = 256 where the 7x7 on 3 channels padded to 16 would take
//     784.
//   * an epilogue storing 4-byte bf16 pairs row by row, half of each
//     32-byte sector: each consumer warpgroup stages its output tile in
//     shared memory (128-byte swizzle, no bank conflicts) and one thread
//     writes it with TMA stores, which the hardware coalesces.
//   * no overlap of a tile's epilogue with the next tile's loads: the grid
//     is one persistent block per SM walking the output tiles (N tiles
//     innermost, so neighbouring blocks share activation rows in L2); the
//     producer runs up to the ring's depth ahead across tile boundaries,
//     the consumers take tiles in turn (pingpong, below) so one's epilogue
//     runs beside the other's products, and the TMA stores drain while the
//     next tile's products run.
//   * the frozen-BN affine and ReLU as separate bf16 passes: fused here,
//     in bf16 pair instructions, with the tile's per-channel vectors staged
//     once in shared memory and no branch in the unrolled epilogue. The
//     dequantization scale is made there too, from the per-image and
//     per-channel maxima, and the bias and norm vectors are read as the
//     module holds them (float32 or bf16, length Co): no host-side tensor
//     op runs before a launch.
//   * the bottleneck's relu(conv3 + shortcut) as a torch pass over the
//     block output (read twice, written once), and the quantizer's max
//     pass over every map it quantizes (a second read of each): both in
//     the epilogue, chosen per launch (Epilogue, a template argument, so
//     the convs that take neither run the unchanged code). The residual
//     tile has the output tile's layout, so the consumer's first thread
//     loads it by TMA into the warpgroup's staging tile (the output's map,
//     over the residual) as the tile's products start, and each thread
//     adds the element it then overwrites. The max is taken as the bits of
//     the stored values with the sign cleared (non-negative floats order
//     as unsigned integers: exact, and independent of the order), per row,
//     then per warp over its rows of the tile's one or two images, and
//     one red.max per warp and image goes to a [N] slot the host zeroes
//     on the same stream; every value starts at the bits of 1e-12, so the
//     slot holds the floored max, models/quant.py:_floor. A tile of maps
//     below 128 pixels can span more images: each thread then adds its
//     rows' maxima on their own.
//
// Hang guard: every mbarrier wait traps after 2e10 SM cycles (~10 s at
// 1.98 GHz; a wait of the ring lasts microseconds). A trap is a sticky
// error: it ends the CUDA context, so the serving process must restart.
// Only a fault in this kernel's protocol waits that long: time-slicing
// with another process stops the waiting warps and the warps they wait for
// alike, and would have to hold the card for 10 s within one wait.
//
// Exactness: int8 products summed in int32 are exact in any order
// (|acc| <= 127^2 * 4608 < 2^31). The epilogue rounds as the unfused torch
// ops do (models/quant.py:Int8Conv2d, models/resnet.py:FrozenBatchNorm):
// float(acc) * scale[n][co], + bias[co], each rounded on its own
// (__int2float_rn, __fmul_rn, __fadd_rn: nvcc would contract a * b + c into
// one FMA, which rounds once); a round-to-nearest-even cast to the compute
// dtype; then y * w and + b with w and b cast to that dtype first and each
// result rounded to it (two roundings, not an FMA; mul.rn/add.rn.bf16x2
// round each product and sum once, as float32 arithmetic followed by a cast
// does for bf16 operands); then max(y, 0). scale[n][co] = a_scale[n] *
// w_scale[co] is made from the floored maxima in the order XLA computes it
// for the JAX package (kernels/int8_conv.py:DequantScale), each product
// rounded on its own; or it is read from a [N, Co] table the caller gives.
// The residual is added to the value rounded to the compute dtype, in
// float32 and rounded once (add.rn.bf16x2 for bf16: for two bf16 operands
// the float32 sum of torch's add is exact wherever a second rounding could
// differ), before the ReLU, as F.relu(y + shortcut) does.
// So the output equals the plain version's bit for bit, and the max is the
// plain version's per-image max of that output.

#include <cuda.h>  // CUtensorMap and its enums; the driver entry point comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_state.cuh"

namespace {

constexpr int kBM = 128;       // output pixels per tile, all of one consumer warpgroup
constexpr int kBK = 128;       // bytes of K per stage: one 128-byte swizzle row
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 72;
constexpr int kConsumerRegs = 216;
// the register file the block must hold for setmaxnreg to move registers
// between the warpgroups without waiting: 128 * 72 + 256 * 216 = 384 * 168
constexpr int kKernelRegs = (128 * kProducerRegs + 256 * kConsumerRegs) / kThreads;
constexpr int kMaxKChunks = 1024;  // 16-byte chunks of K the producer's tap table holds: K <= 16384
constexpr long long kWaitTrapCycles = 20000000000LL;  // ~10 s: a wait that never ends traps (see the note)
constexpr float kInv127 = 1.0f / 127.0f;  // float32(1/127), rounded at compile time, as K5's
constexpr uint32_t kFloorBits = 0x2B8CBCCCu;  // the bits of float32(1e-12), the quantizer's floor of the max

// What the epilogue adds to the norm and the ReLU: nothing; the per-image
// max of what it stores; or the residual before the ReLU and the max.
enum Epilogue { kPlain = 0, kMax = 1, kResidualMax = 2 };

template <int BN, typename OutT>
struct Tile {
  // the ring fills what the two staging tiles leave of the 227 KB
  static constexpr int kStages = sizeof(OutT) == 2 ? (BN == 128 ? 4 : 6) : (BN == 128 ? 2 : 4);
  static constexpr int kABytes = kBM * kBK;
  static constexpr int kBBytes = BN * kBK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kAcc = BN / 2;  // int32 accumulators of one m64 half a consumer thread holds
  static constexpr int kBoxCols = 128 / (int)sizeof(OutT);  // output columns per 128-byte swizzle row
  static constexpr int kBoxes = BN / kBoxCols;
  static constexpr int kStagingBytes = 2 * kBM * BN * (int)sizeof(OutT);  // one output tile per consumer
  static constexpr int kKTabOffset = kStages * kStageBytes + kStagingBytes;  // int2 [kMaxKChunks]
  static constexpr int kRowTabOffset = kKTabOffset + 8 * kMaxKChunks;        // int4 [kBM]
  // per consumer, the epilogue's vectors for each pair of the tile's columns (ColumnPair)
  static constexpr int kColTabOffset = kRowTabOffset + 16 * kBM;
  static constexpr int kColTabBytes = (BN / 2) * (sizeof(OutT) == 2 ? 32 : 48);
  static constexpr int kBarrierOffset = kColTabOffset + 2 * kColTabBytes;
  // full[kStages], empty[kStages], order[2], residual[2]; + 1024 to align the base
  static constexpr int kSmemBytes = kBarrierOffset + 16 * kStages + 32 + 1024;
};

struct Params {
  CUtensorMap w_map;    // [Co, K] int8, box {128, BN}, 128-byte swizzle
  CUtensorMap out_map;  // [M, Co] OutT, box {128 / sizeof(OutT), 128}, 128-byte swizzle
  CUtensorMap a_map;    // 1x1 stride-1 unpadded convs: x as [M, Ci] int8, box {128, 128}
  CUtensorMap res_map;  // kResidualMax: the residual [M, Co] OutT, as out_map
  const int8_t* x;      // [N, H, W, Ci]
  // the dequantization scale: a [N, Co] table, or null and then made from
  // the floored maxima a_amax [N] and w_amax [Co]
  const float* scale;
  const float* a_amax;
  const float* w_amax;
  const float* bias;    // [Co] or null
  const void* norm_w;   // [Co] float32 or bf16 (norm_bf16), or null (then norm_b is null too)
  const void* norm_b;
  uint32_t* amax;       // kMax, kResidualMax: [N] zeroed, or null (no max taken)
  int norm_bf16;
  int n, h, w_in, ci, co, kw, stride, pad, ho, wo, k, m;
  int relu;
  int a_tma;  // A is a plain [M, K] matrix (1x1, stride 1, no padding): loaded by TMA too
  int n_tiles, tiles, k_steps;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of parity `parity` to complete; traps rather than
// spin forever if it never does (the hang guard of the note at the top).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kWaitTrapCycles) __trap();
  }
}

// through L1 (.ca): the implicit im2col reads each input pixel for several
// taps and rows of a tile, so most of its loads hit L1 and not L2
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// one arrival on `bar` once every cp.async this thread issued before it has landed
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows with
// 128-byte swizzle: 8-row atoms 1024 bytes apart (SBO), base 1024-aligned
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// keeps the compiler from moving accumulator reads across wgmma_wait
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t a, uint64_t b, int acc) { wgmma_n128(d, a, b, acc); }
__device__ __forceinline__ void wgmma(int (&d)[32], uint64_t a, uint64_t b, int acc) { wgmma_n64(d, a, b, acc); }

// ---- producer warpgroup: weights by TMA, the implicit im2col by cp.async ----
template <int BN, typename OutT>
__device__ __forceinline__ void produce(const Params& p, uint32_t stages, uint32_t bars, int2* ktab, int4* rowtab) {
  using T = Tile<BN, OutT>;
  const int t = threadIdx.x;  // 0..127
  int stage = 0;
  uint32_t phase = 0;
  if (p.a_tma) {  // both operands by TMA, from one thread
    if (t != 0) return;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.n_tiles) * kBM;
      const int n0 = (tile % p.n_tiles) * BN;
      for (int ks = 0; ks < p.k_steps; ++ks) {
        const uint32_t full = bars + 8 * stage;
        mbar_wait(bars + 8 * (T::kStages + stage), phase ^ 1);  // the consumers freed this slot
        const uint32_t a_dst = stages + stage * T::kStageBytes;
        mbar_arrive_expect_tx(full, T::kABytes + T::kBBytes);
        tma_load_2d(a_dst, &p.a_map, full, ks * kBK, m0);
        tma_load_2d(a_dst + T::kABytes, &p.w_map, full, ks * kBK, n0);
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  // the tap table: 16-byte chunk kc of K -> {offset of its input bytes from
  // the window's first pixel, (r << 16) | s}, made once
  const int kchunks = p.k / 16;
  for (int kc = t; kc < kchunks; kc += 128) {
    const int tap = kc * 16 / p.ci;
    const int r = tap / p.kw, s = tap - r * p.kw;
    ktab[kc] = make_int2((r * p.w_in + s) * p.ci + (kc * 16 - tap * p.ci), (r << 16) | s);
  }
  named_barrier(3, 128);
  const int chunk = t & 7;  // 16-byte chunk of the 128-byte K row this thread loads
  const int row0 = t >> 3;  // and its rows row0 + 16 i of the tile (row & 7 == row0 & 7)
  const uint32_t swz = (uint32_t)((chunk ^ (row0 & 7)) << 4);
  const int hw = p.ho * p.wo;
  const unsigned h = p.h, w = p.w_in;
  const int8_t* const x = p.x;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int m0 = (tile / p.n_tiles) * kBM;
    const int n0 = (tile % p.n_tiles) * BN;
    {  // thread t finds row t's window: its first pixel (hi0, wi0) and that pixel's byte offset;
       // rows past M get a window that no tap reaches
      const int m = m0 + t;
      int hi0 = -16384, wi0 = 0, base = 0;
      if (m < p.m) {
        const int img = m / hw;
        const int rem = m - img * hw;
        const int oy = rem / p.wo;
        hi0 = oy * p.stride - p.pad;
        wi0 = (rem - oy * p.wo) * p.stride - p.pad;
        base = ((img * p.h + hi0) * p.w_in + wi0) * p.ci;
      }
      rowtab[t] = make_int4(hi0, wi0, base, 0);
    }
    named_barrier(3, 128);
    int hi0[8], wi0[8];
    const int8_t* corner[8];  // the window's first pixel (outside x where the window starts in the padding)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int4 v = rowtab[row0 + 16 * i];
      hi0[i] = v.x;
      wi0[i] = v.y;
      corner[i] = x + v.z;
    }
    named_barrier(3, 128);  // the table is free for the next tile
    for (int ks = 0; ks < p.k_steps; ++ks) {
      const uint32_t full = bars + 8 * stage;
      mbar_wait(bars + 8 * (T::kStages + stage), phase ^ 1);  // the consumers freed this slot
      const uint32_t a_dst = stages + stage * T::kStageBytes;
      if (t == 0) {
        mbar_arrive_expect_tx(full, T::kBBytes);
        tma_load_2d(a_dst + T::kABytes, &p.w_map, full, ks * kBK, n0);
      }
      const int kc = ks * (kBK / 16) + chunk;
      const bool k_ok = kc < kchunks;
      const int2 tap = k_ok ? ktab[kc] : make_int2(0, 0);
      const int r = tap.y >> 16, s = tap.y & 0xFFFF;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool ok = k_ok && (unsigned)(hi0[i] + r) < h && (unsigned)(wi0[i] + s) < w;
        // inside x whenever ok; else nothing is read, from x itself
        cp_async16_zfill(a_dst + (uint32_t)((row0 + 16 * i) * kBK) + swz, ok ? corner[i] + tap.x : x, ok);
      }
      cp_async_arrive_noinc(full);
      if (++stage == T::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- consumer warpgroups: wgmma over the ring, then the fused epilogue ----

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // cvt.rn.bf16x2.f32: round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16 pair ops with one rounding each; an explicit .rn is never contracted into an FMA
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The epilogue's vectors for a pair of neighbouring columns, in shared
// memory for the tile: the scale table's rows of the tile's first image and
// of the next, the bias and the frozen norm's weight and bias (rounded to
// OutT). Where a step does not apply its operand is neutral, so every
// element takes the same instructions: bias -0 (y + -0 == y), norm weight 1
// and bias -0, and the ReLU a max with 0 or with -inf.
template <typename OutT>
struct ColumnPair;

template <>
struct ColumnPair<__nv_bfloat16> {
  float2 s0, s1, b;
  uint32_t w2, nb2;  // bf16 pairs
};

template <>
struct ColumnPair<float> {
  float2 s0, s1, b, w, nb;
  float pad_[2];
};

static_assert(sizeof(ColumnPair<__nv_bfloat16>) == 32 && sizeof(ColumnPair<float>) == 48,
              "Tile::kColTabBytes assumes these sizes");

__device__ __forceinline__ float2 to_out2(float2 v, float) { return v; }
__device__ __forceinline__ float2 to_out2(float2 v, __nv_bfloat16) {
  return __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
}

__device__ __forceinline__ void set_norm(ColumnPair<__nv_bfloat16>& c, float2 w, float2 nb) {
  c.w2 = bf16x2_bits(w.x, w.y);  // round to nearest even, as w.to(bf16)
  c.nb2 = bf16x2_bits(nb.x, nb.y);
}

__device__ __forceinline__ void set_norm(ColumnPair<float>& c, float2 w, float2 nb) {
  c.w = w;
  c.nb = nb;
}

// scale[img][col], scale[img][col + 1]: from the table, or as
// DequantScale.table() makes it, (a_amax * 1/127) * (w_amax * 1/127), and
// w_amax * (a_amax * (1/127)^2) for one image, each product rounded
__device__ __forceinline__ float2 scale2(const Params& p, int img, int col) {
  if (p.scale != nullptr) return __ldg(reinterpret_cast<const float2*>(p.scale + (long long)img * p.co + col));
  const bool one = p.n == 1;
  const float a = __fmul_rn(__ldg(p.a_amax + img), one ? __fmul_rn(kInv127, kInv127) : kInv127);
  float2 w = __ldg(reinterpret_cast<const float2*>(p.w_amax + col));
  if (!one) w = make_float2(__fmul_rn(w.x, kInv127), __fmul_rn(w.y, kInv127));
  return make_float2(__fmul_rn(w.x, a), __fmul_rn(w.y, a));
}

// elements col, col + 1 of a float32 or bf16 vector, in float32 (exact)
__device__ __forceinline__ float2 vec2(const void* v, int bf16, int col) {
  if (bf16) return __bfloat1622float2(*(reinterpret_cast<const __nv_bfloat162*>(v) + col / 2));
  return __ldg(reinterpret_cast<const float2*>(v) + col / 2);
}

// float(acc) * scale + bias, each rounded on its own: the dequantized conv in float32
__device__ __forceinline__ float dequant(int acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}

// one pair of output elements of one row into the staged tile: the
// dequantized conv cast to OutT, the frozen norm (each step rounded to
// OutT), with kResidualMax the residual pair staged at `at` (the bytes it
// then overwrites), and the ReLU; bf16: the cast, the norm, the add and
// the ReLU as bf16 pair instructions. Plain stores, so the compiler
// interleaves the pairs. Returns the larger |value| of the pair as
// non-negative float32 bits (with kPlain, 0: the compiler drops it).
template <int kEpi>
__device__ __forceinline__ uint32_t store_pair(uint8_t* at, int a0, int a1, float2 s,
                                               const ColumnPair<__nv_bfloat16>& c, uint32_t relu_floor2, float) {
  uint32_t v = add_bf16x2(mul_bf16x2(bf16x2_bits(dequant(a0, s.x, c.b.x), dequant(a1, s.y, c.b.y)), c.w2), c.nb2);
  if constexpr (kEpi == kResidualMax) v = add_bf16x2(v, *reinterpret_cast<const uint32_t*>(at));
  v = max_bf16x2(v, relu_floor2);
  *reinterpret_cast<uint32_t*>(at) = v;
  if constexpr (kEpi == kPlain) return 0u;
  return max((v << 16) & 0x7FFFFFFFu, v & 0x7FFF0000u);  // a bf16 is the top half of its float32
}

template <int kEpi>
__device__ __forceinline__ uint32_t store_pair(uint8_t* at, int a0, int a1, float2 s, const ColumnPair<float>& c,
                                               uint32_t, float relu_floor) {
  float y0 = __fadd_rn(__fmul_rn(dequant(a0, s.x, c.b.x), c.w.x), c.nb.x);
  float y1 = __fadd_rn(__fmul_rn(dequant(a1, s.y, c.b.y), c.w.y), c.nb.y);
  if constexpr (kEpi == kResidualMax) {
    const float2 r = *reinterpret_cast<const float2*>(at);
    y0 = __fadd_rn(y0, r.x);
    y1 = __fadd_rn(y1, r.y);
  }
  y0 = fmaxf(y0, relu_floor);
  y1 = fmaxf(y1, relu_floor);
  *reinterpret_cast<float2*>(at) = make_float2(y0, y1);
  if constexpr (kEpi == kPlain) return 0u;
  return max(__float_as_uint(y0) & 0x7FFFFFFFu, __float_as_uint(y1) & 0x7FFFFFFFu);
}

__device__ __forceinline__ uint32_t warp_max(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

// Pingpong: consumer warpgroup c takes every other tile of the block (the
// block's tiles i = c, c + 2, ...), all 128 rows of it as two m64 halves, so
// one warpgroup's epilogue runs while the other's products run. The ring
// holds the block's k-steps in order: tile i's step ks is the ring's entry
// q = i * k_steps + ks, in slot q % kStages, phase (q / kStages) & 1. A
// parity names a phase only while the barrier is at most one phase short
// of it, so the warpgroups take turns: tile i's products start once the
// other warpgroup has seen every full barrier of tile i - 1 (order[c]).
template <int BN, typename OutT, int kEpi>
__device__ __forceinline__ void consume(const Params& p, uint32_t stages, uint32_t staging_all, uint32_t bars,
                                        uint8_t* staging_ptr_all, uint8_t* coltab_all) {
  using T = Tile<BN, OutT>;
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup 0 or 1
  const int ct = threadIdx.x % 128;
  const int warp = ct / 32, lane = ct % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int hw = p.ho * p.wo;
  const uint32_t staging = staging_all + cw * (kBM * BN * (int)sizeof(OutT));
  uint8_t* const staging_ptr = staging_ptr_all + cw * (kBM * BN * (int)sizeof(OutT));
  ColumnPair<OutT>* const cols = reinterpret_cast<ColumnPair<OutT>*>(coltab_all + cw * T::kColTabBytes);
  const float relu_floor = p.relu ? 0.f : -INFINITY;
  const uint32_t relu_floor2 = p.relu ? 0u : 0xFF80FF80u;  // bf16 pairs of 0 or -inf
  int acc[2][T::kAcc];  // rows 0-63 and 64-127 of the tile
  const uint32_t order = bars + 8 * (2 * T::kStages);  // order[c] at order + 8 c
  const uint32_t res_bar = bars + 8 * (2 * T::kStages + 2 + cw);  // residual[c]
  uint32_t order_phase = 0, res_phase = 0;
  for (int i = cw;; i += 2) {
    const int tile = blockIdx.x + i * gridDim.x;
    if (tile >= p.tiles) break;
    const int m0 = (tile / p.n_tiles) * kBM;
    const int n0 = (tile % p.n_tiles) * BN;
    const int img0 = m0 / hw;
    if constexpr (kEpi == kResidualMax) {
      // the tile's residual into the staging tile once its last TMA store has read it: in flight
      // while the products run (rows past M read as zeros, boxes past Co are not loaded)
      if (ct == 0) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        int boxes = 0;
#pragma unroll
        for (int box = 0; box < T::kBoxes; ++box) boxes += n0 + box * T::kBoxCols < p.co;
        mbar_arrive_expect_tx(res_bar, boxes * kBM * 128);
#pragma unroll
        for (int box = 0; box < T::kBoxes; ++box) {
          if (n0 + box * T::kBoxCols < p.co) {
            tma_load_2d(staging + box * (kBM * 128), &p.res_map, res_bar, n0 + box * T::kBoxCols, m0);
          }
        }
      }
    }
    if (i > 0) {  // the other warpgroup is through tile i - 1's full barriers
      mbar_wait(order + 8 * cw, order_phase);
      order_phase ^= 1;
    }
    if (ct < BN / 2) {  // the tile's column table (read after the epilogue's first barrier)
      const int col = n0 + 2 * ct;
      const bool in = col < p.co;  // Co is even: col + 1 too; columns past Co are never stored
      ColumnPair<OutT> c;
      c.s0 = in ? scale2(p, img0, col) : make_float2(0.f, 0.f);
      c.s1 = in ? scale2(p, min(img0 + 1, p.n - 1), col) : make_float2(0.f, 0.f);
      c.b = in && p.bias != nullptr ? __ldg(reinterpret_cast<const float2*>(p.bias + col)) : make_float2(-0.f, -0.f);
      if (in && p.norm_w != nullptr) {
        set_norm(c, to_out2(vec2(p.norm_w, p.norm_bf16, col), OutT()),
                 to_out2(vec2(p.norm_b, p.norm_bf16, col), OutT()));
      } else {
        set_norm(c, make_float2(1.f, 1.f), make_float2(-0.f, -0.f));
      }
      cols[ct] = c;
    }
    int q = i * p.k_steps;
    int prev = -1;
    for (int ks = 0; ks < p.k_steps; ++ks, ++q) {
      const int slot = q % T::kStages;
      mbar_wait(bars + 8 * slot, (uint32_t)(q / T::kStages) & 1u);
      if (!p.a_tma) fence_proxy_async();  // the cp.async writes, seen through the barrier, to the async proxy
      const uint32_t a = stages + slot * T::kStageBytes;
      const uint64_t da = smem_desc(a);
      const uint64_t db = smem_desc(a + T::kABytes);
      wgmma_fence();
      // all four 32-byte steps, also past K: the zero bytes there add nothing, and
      // a wgmma under a branch would be serialized
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        wgmma(acc[0], da + 2 * kk, db + 2 * kk, (ks | kk) != 0);
        wgmma(acc[1], da + (64 * kBK >> 4) + 2 * kk, db + 2 * kk, (ks | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: free its slot
      if (prev >= 0 && lane == 0) mbar_arrive(bars + 8 * (T::kStages + prev));
      prev = slot;
    }
    if (ct == 0) mbar_arrive(order + 8 * (1 - cw));  // the other warpgroup's turn
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    if (lane == 0) mbar_arrive(bars + 8 * (T::kStages + prev));

    // epilogue: the staging tile is free once this warpgroup's last TMA store has read it
    if (ct == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    named_barrier(1 + cw, 128);
    if constexpr (kEpi == kResidualMax) {  // the residual tile has landed in it
      mbar_wait(res_bar, res_phase);
      res_phase ^= 1;
    }
    // this thread's rows 16 warp + g + {0, 8, 64, 72} of the tile and its column pairs
    // 4 j + t4 (columns 8 j + 2 t4), j = 0 .. BN / 8 - 1
    int rows[4];
    bool next[4];  // the row lies in image img0 + 1
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      rows[h] = warp * 16 + g + (h & 1) * 8 + (h >> 1) * 64;
      next[h] = m0 + rows[h] >= (img0 + 1) * hw;
    }
    uint32_t mx[4] = {0u, 0u, 0u, 0u};  // kMax, kResidualMax: max |value| of each row's stored pairs
    // the pairs of column pair 4 j + t4 of this thread's rows; scale(h, c) is the row's scale
    auto stage_tile = [&](auto scale) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const ColumnPair<OutT> c = cols[4 * j + t4];
        const int cc = 8 * j + 2 * t4;  // tile column of this thread's pairs
        const int box = cc / T::kBoxCols;
        const int byte = (cc % T::kBoxCols) * (int)sizeof(OutT);
        uint8_t* const at = staging_ptr + box * (kBM * 128) + ((((byte >> 4) ^ g) << 4) | (byte & 15));
#pragma unroll
        for (int h = 0; h < 4; ++h) {  // row & 7 == g for each
          mx[h] = max(mx[h], store_pair<kEpi>(at + rows[h] * 128, acc[h >> 1][4 * j + 2 * (h & 1)],
                                              acc[h >> 1][4 * j + 2 * (h & 1) + 1], scale(h, c, n0 + cc), c,
                                              relu_floor2, relu_floor));
        }
      }
    };
    // one branch a tile, none in the unrolled loop: every row in image img0 or img0 + 1
    // (always when Ho*Wo >= 128), or else each row's own scale
    const int img_last = (min(m0 + kBM, p.m) - 1) / hw;
    if (img_last <= img0 + 1) {
      stage_tile([&](int h, const ColumnPair<OutT>& c, int) { return next[h] ? c.s1 : c.s0; });
    } else {
      stage_tile([&](int h, const ColumnPair<OutT>&, int col) {
        const int m = min(m0 + rows[h], p.m - 1);
        return col < p.co ? scale2(p, m / hw, col) : make_float2(0.f, 0.f);
      });
    }
    if constexpr (kEpi != kPlain) {
      // the per-image max of the stored rows (not those past M), each value floored at 1e-12; columns
      // past Co hold zeros
      if (p.amax != nullptr) {
        if (img_last <= img0 + 1) {  // per warp: one red.max for each of the tile's images
          uint32_t v0 = kFloorBits, v1 = kFloorBits;
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const uint32_t m = m0 + rows[h] < p.m ? mx[h] : 0u;
            v0 = max(v0, next[h] ? 0u : m);
            v1 = max(v1, next[h] ? m : 0u);
          }
          v0 = warp_max(v0);
          v1 = warp_max(v1);
          if (lane == 0) {
            atomicMax(p.amax + img0, v0);
            if (img_last > img0) atomicMax(p.amax + img0 + 1, v1);
          }
        } else {  // rows of three or more images: each row's own
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            if (m0 + rows[h] < p.m) atomicMax(p.amax + (m0 + rows[h]) / hw, max(mx[h], kFloorBits));
          }
        }
      }
    }
    fence_proxy_async();  // the staged tile, to the TMA store
    named_barrier(1 + cw, 128);
    if (ct == 0) {
#pragma unroll
      for (int box = 0; box < T::kBoxes; ++box) {
        if (n0 + box * T::kBoxCols < p.co) {
          tma_store_2d(&p.out_map, staging + box * (kBM * 128), n0 + box * T::kBoxCols, m0);
        }
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (ct == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int BN, typename OutT, int kEpi>
__global__ void __launch_bounds__(kThreads, 1) int8_conv_kernel(const __grid_constant__ Params p) {
  using T = Tile<BN, OutT>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t stages = (raw + 1023u) & ~1023u;  // 128-byte swizzle atoms are 1024-aligned
  const uint32_t staging = stages + T::kStages * T::kStageBytes;
  const uint32_t bars = stages + T::kBarrierOffset;  // full[s] at 8 s, empty[s] at 8 (kStages + s)
  uint8_t* base_ptr = smem_raw + (stages - raw);
  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&p.w_map)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&p.out_map)) : "memory");
    if (p.a_tma) asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&p.a_map)) : "memory");
    if (kEpi == kResidualMax) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&p.res_map)) : "memory");
    }
    for (int s = 0; s < T::kStages; ++s) {
      // the producers' cp.async arrivals + the TMA's expect_tx, or that alone
      mbar_init(bars + 8 * s, p.a_tma ? 1 : 128 + 1);
      mbar_init(bars + 8 * (T::kStages + s), 4);  // one arrival per warp of the consuming warpgroup
    }
    mbar_init(bars + 8 * (2 * T::kStages), 1);  // order[0], order[1]
    mbar_init(bars + 8 * (2 * T::kStages + 1), 1);
    mbar_init(bars + 8 * (2 * T::kStages + 2), 1);  // residual[0], residual[1]: the TMA's expect_tx
    mbar_init(bars + 8 * (2 * T::kStages + 3), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();
  // one if/else for the whole kernel: the two paths never reconverge
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    produce<BN, OutT>(p, stages, bars, reinterpret_cast<int2*>(base_ptr + T::kKTabOffset),
                      reinterpret_cast<int4*>(base_ptr + T::kRowTabOffset));
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<BN, OutT, kEpi>(p, stages, staging, bars, base_ptr + (staging - stages), base_ptr + T::kColTabOffset);
  }
}

// ---- host side ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled's address is one for the process: looked up once, safely across threads
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// a 2D map over a row-major [rows, cols] array, boxes of box_rows x box_cols, 128-byte swizzle
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, long long rows, long long cols,
               int esize, int box_cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(cols * esize)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, typename OutT, int kEpi>
int launch_epilogue(Params& p, const void* w, void* out, const void* residual, int dev, cudaStream_t stream) {
  using T = Tile<BN, OutT>;
  void (*kernel)(const Params) = int8_conv_kernel<BN, OutT, kEpi>;
  // setmaxnreg.inc waits for registers the block does not hold unless the
  // kernel was compiled at kKernelRegs: refuse rather than hang. The
  // shared-memory attribute belongs to each device's context.
  static device_state::Once setup;
  const cudaError_t ready = device_state::once_per_device(setup, dev, [kernel] {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return err;
    if (fa.numRegs < kKernelRegs) return cudaErrorInvalidConfiguration;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  });
  if (ready != cudaSuccess) return (int)ready;
  const CUtensorMapDataType out_type =
      sizeof(OutT) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_2d(&p.w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, p.co, p.k, 1, kBK, BN) ||
      !encode_2d(&p.out_map, out_type, out, p.m, p.co, (int)sizeof(OutT), T::kBoxCols, kBM) ||
      (p.a_tma && !encode_2d(&p.a_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.x, p.m, p.k, 1, kBK, kBM)) ||
      (kEpi == kResidualMax &&
       !encode_2d(&p.res_map, out_type, residual, p.m, p.co, (int)sizeof(OutT), T::kBoxCols, kBM))) {
    return (int)cudaErrorInvalidValue;
  }
  const int m_tiles = (p.m + kBM - 1) / kBM;
  p.n_tiles = (p.co + BN - 1) / BN;
  const long long tiles = (long long)m_tiles * p.n_tiles;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  p.k_steps = (p.k + kBK - 1) / kBK;
  const int sms = device_state::num_sms(dev);
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = p.tiles < sms ? p.tiles : sms;
  if (p.amax != nullptr) {  // the max's slots start at 0 (below every value's bits)
    const cudaError_t err = cudaMemsetAsync(p.amax, 0, sizeof(uint32_t) * p.n, stream);
    if (err != cudaSuccess) return (int)err;
  }
  int8_conv_kernel<BN, OutT, kEpi><<<grid, kThreads, T::kSmemBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int BN, typename OutT>
int launch(Params& p, const void* w, void* out, const void* residual, int dev, cudaStream_t stream) {
  if (residual != nullptr) return launch_epilogue<BN, OutT, kResidualMax>(p, w, out, residual, dev, stream);
  if (p.amax != nullptr) return launch_epilogue<BN, OutT, kMax>(p, w, out, residual, dev, stream);
  return launch_epilogue<BN, OutT, kPlain>(p, w, out, residual, dev, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch, or a CUDA error code for
// arguments the kernel does not take (the wrapper raises on either):
// cudaErrorInvalidDevice when x does not lie on the thread's current device,
// which is the device the launch goes to. x, w,
// out and residual must be 16-byte aligned, the vectors 8-byte aligned and
// amax 4-byte aligned; Ci a multiple of 16, Co a multiple of 8 (the TMA
// store's row pitch), H and W below 16384, K = kh*kw*Ci at most 16384 and
// N*H*W*Ci below 2^31. The scale: a float32 [N, Co] table, or null and the
// floored maxima a_amax [N] and w_amax [Co]; bias float32 [Co] or null;
// norm_w and norm_b [Co] (float32, or bf16 with norm_bf16 1) or both null;
// residual: null, or [N, Ho, Wo, Co] of the output's type, added before
// the ReLU; amax: null, or [N] float32 that receives the floored
// per-image max |out| (zeroed on the stream first).
extern "C" int int8_conv(const void* x, const void* w, const void* scale, const void* a_amax, const void* w_amax,
                         const void* bias, const void* norm_w, const void* norm_b, int norm_bf16, const void* residual,
                         void* out, void* amax, int n, int h, int w_in, int ci, int co, int kh, int kw, int stride,
                         int pad, int ho, int wo, int relu, int out_code, void* stream) {
  const long long m = (long long)n * ho * wo;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)w % 16 == 0) && ((uintptr_t)out % 16 == 0) &&
                       (uintptr_t)residual % 16 == 0 && (uintptr_t)amax % 4 == 0 &&
                       (uintptr_t)scale % 8 == 0 && (uintptr_t)w_amax % 8 == 0 && (uintptr_t)bias % 8 == 0 &&
                       (uintptr_t)norm_w % 8 == 0 && (uintptr_t)norm_b % 8 == 0;
  const bool scaled = scale != nullptr ? a_amax == nullptr && w_amax == nullptr : a_amax != nullptr && w_amax != nullptr;
  if (!aligned || !scaled || n < 1 || ho < 1 || wo < 1 || ci < 16 || ci % 16 != 0 || co < 8 || co % 8 != 0 ||
      stride < 1 || pad < 0 || pad >= 16384 || h >= 16384 || w_in >= 16384 ||
      (long long)n * h * w_in * ci > 0x7fffffffLL || m > 0x7fffffffLL || (long long)kh * kw * ci > 16 * kMaxKChunks ||
      (norm_w == nullptr) != (norm_b == nullptr) || (norm_bf16 != 0 && norm_bf16 != 1) ||
      (out_code != 0 && out_code != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.scale = static_cast<const float*>(scale);
  p.a_amax = static_cast<const float*>(a_amax);
  p.w_amax = static_cast<const float*>(w_amax);
  p.bias = static_cast<const float*>(bias);
  p.norm_w = norm_w;
  p.norm_b = norm_b;
  p.amax = static_cast<uint32_t*>(amax);
  p.norm_bf16 = norm_bf16;
  p.n = n;
  p.h = h;
  p.w_in = w_in;
  p.ci = ci;
  p.co = co;
  p.kw = kw;
  p.stride = stride;
  p.pad = pad;
  p.ho = ho;
  p.wo = wo;
  p.k = kh * kw * ci;
  p.m = (int)m;
  p.relu = relu != 0;
  p.a_tma = kh == 1 && kw == 1 && stride == 1 && pad == 0;
  const int dev = device_state::launch_device(x);
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (co <= 64) {
    return out_code == 0 ? launch<64, float>(p, w, out, residual, dev, s)
                         : launch<64, __nv_bfloat16>(p, w, out, residual, dev, s);
  }
  return out_code == 0 ? launch<128, float>(p, w, out, residual, dev, s)
                       : launch<128, __nv_bfloat16>(p, w, out, residual, dev, s);
}

// Int8 implicit-GEMM convolution for Hopper (sm_90a), K4: int8 NHWC
// activations x int8 [Co, kh, kw, Ci] weights, summed in int32 on the
// tensor cores, dequantized in the epilogue to float32 or bfloat16 NHWC.
//
// Replaces the int32 convolution of the JAX package's Int8Conv
// (deepemia_tpu/models/quant.py:105, lax.conv_general_dilated with
// preferred_element_type=jnp.int32): an XLA int8 convolution, not a Pallas
// kernel. PyTorch has no int8 convolution on CUDA, and torch._int_mm would
// need an explicit im2col of 9x to 49x the activation and cannot take the
// stem's K = 147. Its plain counterpart is
// deepemia_tpu_torch/kernels/int8_conv.py:int8_conv2d_plain.
//
// The GEMM: M = N*Ho*Wo output pixels, N = Co, K = kh*kw*Ci with k ordered
// (r, s, c) as the weights are, so an output pixel's row of the implicit
// im2col matrix is kh*kw runs of Ci contiguous input bytes.
//
// Bound: one R50 trunk forward over a 16-tile batch of 1024² inputs is
// ~2.7 T int8 operations, ~1.4 ms at the card's 1,979 TOPS, but most of its
// convs are 1x1 and bound by bytes (int8 in, bf16 out, at 3.35 TB/s): the
// sum of each conv's larger bound is ~3.4 ms (PERF.md, K4). Reaching it
// needs wgmma fed by a TMA ring and the quantizer fused; this first
// version is simple and right: mma.sync m16n8k32 (s8 x s8 -> s32, which
// runs on sm_90), a 128 x 128 x 64 block tile in 8 warps (a warp owns 64 x
// 32), both operand tiles double-buffered in shared memory through
// cp.async with zero fill (padding, the ragged edges of M, N and K, and
// the stem's K = 196 after its channels are padded 3 -> 4 by the wrapper
// all read as zeros, which add nothing to an integer sum). Rows of a tile
// are 80 bytes apart, so the 32-bit fragment reads of a warp fall in 32
// different banks.
//
// Exactness: int8 products summed in int32 are exact in any order
// (|acc| <= 127^2 * 4608 < 2^31). The epilogue follows quant.py:113-119:
// float(acc) * scale[n][co], then + bias[co], each rounded on its own
// (__int2float_rn, __fmul_rn, __fadd_rn: nvcc would contract a * b + c into
// one FMA, which rounds once), then a round-to-nearest-even cast to
// bfloat16 where the output is bf16. The [N, Co] table of a_scale[n] *
// w_scale[co] comes from the wrapper (models/quant.py:dequant_scale), in
// the order XLA computes it for the JAX package.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // output pixels per block
constexpr int kBN = 128;  // output channels per block
constexpr int kBK = 64;   // bytes of K per stage
constexpr int kThreads = 256;
constexpr int kPitch = kBK + 16;  // bytes between tile rows in shared memory
constexpr int kWarpM = 64, kWarpN = 32;
constexpr int kWarpsN = kBN / kWarpN;  // 4 (x 2 along M)
constexpr int kMT = kWarpM / 16;       // m16 tiles a warp holds
constexpr int kNT = kWarpN / 8;        // n8 tiles a warp holds

struct Params {
  const int8_t* x;        // [N, H, W, Ci]
  const int8_t* w;        // [Co, K]
  const float* scale;     // [N, Co]: a_scale[n] * w_scale[co]
  const float* bias;      // [Co] or null
  void* out;              // [N, Ho, Wo, Co]
  int h, w_in, ci, co, kw, stride, pad, ho, wo, k;
  int m;                  // N * Ho * Wo
};

template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src, bool valid) {
  const int src_size = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_size));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(kBytes),
                 "r"(src_size));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two neighbouring channels (Co is even, so the pair is aligned)
__device__ __forceinline__ void store2(float* out, long long i, float y0, float y1) {
  *reinterpret_cast<float2*>(out + i) = make_float2(y0, y1);
}

__device__ __forceinline__ void store2(__nv_bfloat16* out, long long i, float y0, float y1) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(y0);
  v.y = __float2bfloat16_rn(y1);
  *reinterpret_cast<__nv_bfloat162*>(out + i) = v;
}

// kVec: bytes per cp.async (16 when Ci % 16 == 0, else 4 with Ci % 4 == 0),
// so that no load straddles two taps (r, s).
template <int kVec, typename OutT>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(const Params p) {
  constexpr int kChunks = kBK / kVec;           // loads per tile row
  constexpr int kRowsPerPass = kThreads / kChunks;
  constexpr int kPasses = kBM / kRowsPerPass;   // == kBN / kRowsPerPass
  static_assert(kBM == kBN, "A and B tiles share one load plan");

  __shared__ __align__(16) int8_t a_tile[2][kBM][kPitch];
  __shared__ __align__(16) int8_t b_tile[2][kBN][kPitch];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int chunk = tid % kChunks;
  const int row0 = tid / kChunks;

  // this thread's rows of the A tile: the input pixel its output pixel's
  // window starts at, and the image's base offset; rows past M never pass
  // the bounds test
  int hi0[kPasses], wi0[kPasses];
  long long base[kPasses];
  const int hw_out = p.ho * p.wo;
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int m = m0 + row0 + i * kRowsPerPass;
    if (m < p.m) {
      const int img = m / hw_out;
      const int rem = m - img * hw_out;
      const int oy = rem / p.wo;
      const int ox = rem - oy * p.wo;
      hi0[i] = oy * p.stride - p.pad;
      wi0[i] = ox * p.stride - p.pad;
      base[i] = (long long)img * p.h * p.w_in * p.ci;
    } else {
      hi0[i] = -(1 << 28);
      wi0[i] = 0;
      base[i] = 0;
    }
  }

  auto load_stage = [&](int stage, int k0) {
    const int kk = k0 + chunk * kVec;
    const bool k_ok = kk < p.k;
    int tap = 0, c = 0, r = 0, s = 0;
    if (k_ok) {
      tap = kk / p.ci;
      c = kk - tap * p.ci;
      r = tap / p.kw;
      s = tap - r * p.kw;
    }
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int row = row0 + i * kRowsPerPass;
      const int hi = hi0[i] + r;
      const int wi = wi0[i] + s;
      const bool ok = k_ok && (unsigned)hi < (unsigned)p.h && (unsigned)wi < (unsigned)p.w_in;
      const int8_t* src = ok ? p.x + base[i] + ((long long)hi * p.w_in + wi) * p.ci + c : p.x;
      cp_async_zfill<kVec>((uint32_t)__cvta_generic_to_shared(&a_tile[stage][row][chunk * kVec]), src, ok);
      const int co = n0 + row;
      const bool w_ok = k_ok && co < p.co;
      const int8_t* wsrc = w_ok ? p.w + (long long)co * p.k + kk : p.w;
      cp_async_zfill<kVec>((uint32_t)__cvta_generic_to_shared(&b_tile[stage][row][chunk * kVec]), wsrc, w_ok);
    }
    cp_async_commit();
  };

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // groupID
  const int t4 = lane % 4;  // threadID_in_group
  const int wm = (warp / kWarpsN) * kWarpM;
  const int wn = (warp % kWarpsN) * kWarpN;
  const bool warp_active = n0 + wn < p.co;  // uniform over the warp

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  const int k_tiles = (p.k + kBK - 1) / kBK;
  load_stage(0, 0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < k_tiles) {
      load_stage(stage ^ 1, (kt + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_active) {
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 32) {
        uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const int row = wm + i * 16 + g;
          a[i][0] = *reinterpret_cast<const uint32_t*>(&a_tile[stage][row][ks + t4 * 4]);
          a[i][1] = *reinterpret_cast<const uint32_t*>(&a_tile[stage][row + 8][ks + t4 * 4]);
          a[i][2] = *reinterpret_cast<const uint32_t*>(&a_tile[stage][row][ks + 16 + t4 * 4]);
          a[i][3] = *reinterpret_cast<const uint32_t*>(&a_tile[stage][row + 8][ks + 16 + t4 * 4]);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int col = wn + j * 8 + g;
          b[j][0] = *reinterpret_cast<const uint32_t*>(&b_tile[stage][col][ks + t4 * 4]);
          b[j][1] = *reinterpret_cast<const uint32_t*>(&b_tile[stage][col][ks + 16 + t4 * 4]);
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], a[i], b[j]);
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

  if (!warp_active) return;
  OutT* out = reinterpret_cast<OutT*>(p.out);
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + g + half * 8;
      if (m >= p.m) continue;
      const float* scale = p.scale + (long long)(m / hw_out) * p.co;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = n0 + wn + j * 8 + t4 * 2;
        if (col >= p.co) continue;
        float y[2];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          float yv = __fmul_rn(__int2float_rn(acc[i][j][half * 2 + v]), scale[col + v]);
          if (p.bias != nullptr) yv = __fadd_rn(yv, p.bias[col + v]);
          y[v] = yv;
        }
        store2(out, (long long)m * p.co + col, y[0], y[1]);
      }
    }
  }
}

template <int kVec, typename OutT>
int launch(const Params& p, cudaStream_t stream) {
  dim3 grid((p.m + kBM - 1) / kBM, (p.co + kBN - 1) / kBN);
  int8_conv_kernel<kVec, OutT><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take (the wrapper raises on either).
extern "C" int int8_conv(const void* x, const void* w, const void* scale, const void* bias, void* out, int n, int h, int w_in, int ci, int co, int kh,
                         int kw, int stride, int pad, int ho, int wo, int vec, int out_code,
                         void* stream) {
  const long long m = (long long)n * ho * wo;
  const bool vec_ok = (vec == 16 && ci % 16 == 0) || (vec == 4 && ci % 4 == 0);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)w % 16 == 0);
  if (!vec_ok || !aligned || n < 1 || ho < 1 || wo < 1 || co < 2 || co % 2 != 0 || stride < 1 || pad < 0 ||
      m > 0x7fffffffLL || (m + kBM - 1) / kBM > 0x7fffffffLL || (long long)kh * kw * ci > (1 << 20) ||
      (out_code != 0 && out_code != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 16) {
    return out_code == 0 ? launch<16, float>(p, s) : launch<16, __nv_bfloat16>(p, s);
  }
  return out_code == 0 ? launch<4, float>(p, s) : launch<4, __nv_bfloat16>(p, s);
}

// Stride-1 SAME 3x3x3 conv with a fused epilogue, channels-last, for Hopper.
//
// Replaces the TPU Pallas kernel segmentation3d_tpu/ops/pallas_conv.py:
// thin_conv3d (body _conv_kernel). Same function:
//   out = q(act2(x + act(conv(x, w) + b)))
// with bf16 operands, f32 accumulation and an f32 epilogue: `act` none /
// relu / prelu(alpha); the optional residual tail act2(x + .) (cin == cout,
// identity = the conv's own bf16 input); optional int8 requant
// clip(rint(acc * inv_sa), -127, 127), round half to even as jnp.round.
// Output bf16, f32 or int8.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): per output
// voxel the conv does 2*27*Cin*Cout FLOPs and moves (Cin + Cout) elements.
// The V-Net stem (Cin 1..4 -> 16) and head (32 -> num_classes) do a few
// hundred FLOPs per byte or less and are memory-bound; the 32-channel
// full-resolution residual convs sit near the balance point; the 64..256
// channel convs are compute-bound.
//
// What the design does about it:
// - wide sites (Cin % 32 == 0, any Cout): an implicit GEMM on wgmma
//   (m64nNk16 bf16 -> f32, N = 8, 32 or 64 output channels per block), the
//   shared mainloop of conv_wgmma.cuh: the output box's input halo comes
//   into shared memory once per 16-channel slice by TMA, and the 27 taps are
//   descriptor offsets into it; the weights, repacked K-major by the wrapper,
//   come by bulk copy through a ring of mbarrier-tracked stages. The head
//   (32 -> 2) runs here too, N padded to 8: it is bound by its bytes.
// - thin sites (Cin not a multiple of 32: the stem, Cin 1..4): a direct
//   conv on the CUDA cores, one thread per output voxel x up to 16 output
//   channels, weights staged in shared memory, runs of 8 output channels
//   written by one vector store. No channel is padded.
// - the epilogue runs on the f32 accumulators in registers and writes the
//   output once, two adjacent channels per store; the residual identity is
//   read straight from the input.
// The TPU kernel's lane packing (L = 128 // Cout x-positions per lane), its
// y-tiling and its z-chunk split exist only for the TPU and are not copied.
//
// Plain C interface, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_wgmma.cuh"

namespace {

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_PRELU = 2 };
enum { OUT_BF16 = 0, OUT_F32 = 1, OUT_I8 = 2 };

struct ConvArgs {
  const __nv_bfloat16* x;  // [B, D, H, W, cin]
  const __nv_bfloat16* w;  // [3, 3, 3, cin, cout]
  const float* bias;       // [cout]
  void* out;               // [B, D, H, W, cout]
  int D, H, W, cin, cout;
  long long nvox;          // B * D * H * W
  int act;
  float alpha;
  int residual;            // 0: no tail, else the tail's act (ACT_RELU/PRELU)
  float res_alpha;
  int out_kind;
  float inv_sa;
};

__device__ __forceinline__ float activate(float v, int kind, float a) {
  if (kind == ACT_RELU) return fmaxf(v, 0.0f);
  if (kind == ACT_PRELU) return v >= 0.0f ? v : a * v;
  return v;
}

// acc: the f32 conv sum for (vox, co) without bias; returns the value
// before the output conversion.
__device__ __forceinline__ float epilogue_value(const ConvArgs& p, long long vox,
                                                int co, float acc) {
  acc = acc + p.bias[co];
  acc = activate(acc, p.act, p.alpha);
  if (p.residual != ACT_NONE) {
    acc = acc + __bfloat162float(p.x[vox * p.cin + co]);
    acc = activate(acc, p.residual, p.res_alpha);
  }
  return acc;
}

__device__ __forceinline__ int8_t requant(const ConvArgs& p, float acc) {
  float q = rintf(acc * p.inv_sa);
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(q);
}

__device__ __forceinline__ void store_value(const ConvArgs& p, long long o,
                                            float acc) {
  if (p.out_kind == OUT_I8) {
    static_cast<int8_t*>(p.out)[o] = requant(p, acc);
  } else if (p.out_kind == OUT_F32) {
    static_cast<float*>(p.out)[o] = acc;
  } else {
    static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(acc);
  }
}

__device__ __forceinline__ void epilogue(const ConvArgs& p, long long vox,
                                         int co, float acc) {
  store_value(p, vox * p.cout + co, epilogue_value(p, vox, co, acc));
}

// ---------------------------------------------------------------------------
// Tensor-core path: the shared wgmma mainloop (conv_wgmma.cuh), bf16 -> f32.
// ---------------------------------------------------------------------------

struct ThinOp {
  using Acc = float;
  using Args = ConvArgs;

  // one m64nNk16 bf16 wgmma, A and B K-major in shared memory
  template <int N>
  static __device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t a,
                                             uint64_t b) {
    if constexpr (N == 8) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
          : CONVWG_ACC4("+f", d, 0)
          : "l"(a), "l"(b), "r"(1));
    } else if constexpr (N == 32) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
          "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
          : CONVWG_ACC16("+f", d, 0)
          : "l"(a), "l"(b), "r"(1));
    } else {
      static_assert(N == 64, "N is 8, 32 or 64");
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
          "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
          "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
          : CONVWG_ACC32("+f", d, 0)
          : "l"(a), "l"(b), "r"(1));
    }
  }

  // channels co .. co + n - 1 (n <= 8) of voxel vox, from the staged
  // accumulators a; one vector store where all 8 are there and aligned
  static __device__ __forceinline__ void store8(const ConvArgs& p, long long vox,
                                                int co, const float* a, int n) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = e < n ? epilogue_value(p, vox, co + e, a[e]) : 0.0f;
    const long long o = vox * p.cout + co;
    if (n < 8 || (p.cout & 7) != 0) {
      for (int e = 0; e < n; ++e) store_value(p, o + e, v[e]);
    } else if (p.out_kind == OUT_I8) {
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        w[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(requant(p, v[e])))
                     << (8 * (e & 3));
      *reinterpret_cast<uint2*>(static_cast<int8_t*>(p.out) + o) =
          make_uint2(w[0], w[1]);
    } else if (p.out_kind == OUT_F32) {
      float4* d = reinterpret_cast<float4*>(static_cast<float*>(p.out) + o);
      d[0] = make_float4(v[0], v[1], v[2], v[3]);
      d[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      __nv_bfloat162 h[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) + o) =
          *reinterpret_cast<const uint4*>(h);
    }
  }
};

// ---------------------------------------------------------------------------
// CUDA-core direct conv for thin channel counts.
// ---------------------------------------------------------------------------

constexpr int CI_CHUNK = 16;  // input channels of weights staged per pass

template <int CO>
__global__ void __launch_bounds__(128) conv_direct_kernel(ConvArgs p) {
  __shared__ float ws[27 * CI_CHUNK * CO];  // [tap][ci][co], f32
  const int co0 = blockIdx.y * CO;
  const long long vox = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool active = vox < p.nvox;
  int x = 0, y = 0, z = 0;
  long long b = 0;
  if (active) {
    long long t = vox;
    x = static_cast<int>(t % p.W); t /= p.W;
    y = static_cast<int>(t % p.H); t /= p.H;
    z = static_cast<int>(t % p.D);
    b = t / p.D;
  }
  float acc[CO];
#pragma unroll
  for (int j = 0; j < CO; ++j) acc[j] = 0.0f;

  for (int ci0 = 0; ci0 < p.cin; ci0 += CI_CHUNK) {
    const int cc = min(CI_CHUNK, p.cin - ci0);
    __syncthreads();
    for (int i = threadIdx.x; i < 27 * cc * CO; i += blockDim.x) {
      const int j = i % CO, r = i / CO;
      const int ci = r % cc, tap = r / cc;
      const int co = co0 + j;
      ws[(tap * CI_CHUNK + ci) * CO + j] =
          co < p.cout ? __bfloat162float(
                            p.w[(static_cast<long long>(tap) * p.cin + ci0 + ci) * p.cout + co])
                      : 0.0f;
    }
    __syncthreads();
    if (!active) continue;
    for (int dz = 0; dz < 3; ++dz) {
      const int zz = z + dz - 1;
      if (zz < 0 || zz >= p.D) continue;
      for (int dy = 0; dy < 3; ++dy) {
        const int yy = y + dy - 1;
        if (yy < 0 || yy >= p.H) continue;
        for (int dx = 0; dx < 3; ++dx) {
          const int xx = x + dx - 1;
          if (xx < 0 || xx >= p.W) continue;
          const __nv_bfloat16* xp =
              p.x + ((((b * p.D + zz) * p.H + yy) * p.W + xx) * p.cin + ci0);
          const float* wp = ws + ((dz * 3 + dy) * 3 + dx) * CI_CHUNK * CO;
          int ci = 0;
          if ((p.cin & 7) == 0) {
            // 8 channels per 16-byte load (xp is 16-byte aligned here)
            for (; ci < cc; ci += 8) {
              const int4 v = *reinterpret_cast<const int4*>(xp + ci);
              const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const float2 f = __bfloat1622float2(h[k]);
#pragma unroll
                for (int j = 0; j < CO; ++j) {
                  acc[j] += f.x * wp[(ci + 2 * k) * CO + j];
                  acc[j] += f.y * wp[(ci + 2 * k + 1) * CO + j];
                }
              }
            }
          }
          for (; ci < cc; ++ci) {
            const float xv = __bfloat162float(xp[ci]);
#pragma unroll
            for (int j = 0; j < CO; ++j) acc[j] += xv * wp[ci * CO + j];
          }
        }
      }
    }
  }
  if (!active) return;
  if (CO % 8 == 0 && co0 + CO <= p.cout) {
    // whole runs of 8 channels: one vector store each (the stem)
#pragma unroll
    for (int j = 0; j < CO; j += 8) ThinOp::store8(p, vox, co0 + j, acc + j, 8);
  } else {
#pragma unroll
    for (int j = 0; j < CO; ++j)
      if (co0 + j < p.cout) epilogue(p, vox, co0 + j, acc[j]);
  }
}

template <int CO>
void launch_direct(const ConvArgs& p, cudaStream_t s) {
  dim3 grid(static_cast<unsigned>((p.nvox + 127) / 128), (p.cout + CO - 1) / CO);
  conv_direct_kernel<CO><<<grid, 128, 0, s>>>(p);
}

ConvArgs make_args(const void* x, const void* w, const void* bias, void* out,
                   int B, int D, int H, int W, int cin, int cout, int act,
                   float alpha, int residual, float res_alpha, int out_kind,
                   float inv_sa) {
  ConvArgs p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.D = D; p.H = H; p.W = W; p.cin = cin; p.cout = cout;
  p.nvox = static_cast<long long>(B) * D * H * W;
  p.act = act; p.alpha = alpha;
  p.residual = residual; p.res_alpha = res_alpha;
  p.out_kind = out_kind; p.inv_sa = inv_sa;
  return p;
}

}  // namespace

extern "C" {

// 1 when (cin, cout) takes the tensor-core (wgmma) path, 0 for the direct
// path.
int thin_conv3d_uses_tensor_cores(int cin, int cout) {
  return (cin % 32 == 0 && cout >= 1) ? 1 : 0;
}

// The direct path, w as [3, 3, 3, cin, cout]. A tensor-core site is
// refused (cudaErrorInvalidValue): it needs its plan and packed weights,
// thin_conv3d_launch_wgmma.
int thin_conv3d_launch(const void* x, const void* w, const void* bias,
                       void* out, int B, int D, int H, int W, int cin,
                       int cout, int act, float alpha, int residual,
                       float res_alpha, int out_kind, float inv_sa,
                       void* stream) {
  const ConvArgs p = make_args(x, w, bias, out, B, D, H, W, cin, cout, act,
                               alpha, residual, res_alpha, out_kind, inv_sa);
  if (p.nvox == 0) return 0;
  if (thin_conv3d_uses_tensor_cores(cin, cout))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout >= 16) {
    launch_direct<16>(p, s);
  } else if (cout > 4) {
    launch_direct<8>(p, s);
  } else if (cout > 2) {
    launch_direct<4>(p, s);
  } else if (cout == 2) {
    launch_direct<2>(p, s);
  } else {
    launch_direct<1>(p, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core path: wp is the weights packed by ops/conv_plan.py
// (pack_weights), plan its int32 plan (PLAN_LEN entries, host memory).
int thin_conv3d_launch_wgmma(const void* x, const void* wp, const void* bias,
                             void* out, int B, int D, int H, int W, int cin,
                             int cout, int act, float alpha, int residual,
                             float res_alpha, int out_kind, float inv_sa,
                             const int* plan, void* stream) {
  const ConvArgs p = make_args(x, wp, bias, out, B, D, H, W, cin, cout, act,
                               alpha, residual, res_alpha, out_kind, inv_sa);
  if (p.nvox == 0) return 0;
  if (!thin_conv3d_uses_tensor_cores(cin, cout))
    return static_cast<int>(cudaErrorInvalidValue);
  return convwg::launch<ThinOp>(x, wp, p, B, D, H, W, cin * 2, cout, plan,
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"

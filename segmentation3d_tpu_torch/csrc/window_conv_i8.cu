// int8 x int8 -> int32 stride-1 SAME 3x3x3 conv with a fused f32 epilogue,
// channels-last, for Hopper.
//
// Replaces the TPU Pallas kernel segmentation3d_tpu/ops/pallas_i8win.py:
// window_conv_i8_pallas (body _kernel). Same function, in the value order
// of the int8 V-Net forward (models/packed_vnet.py, default route), so that
// an int8 output is bit-exact against the plain version:
//   acc = sum over taps and input channels of x * w      (int32, exact)
//   a   = act(f32(acc) * scale[co] + bias[co])           (f32, no FMA)
//   tail (optional): a = res_act(f32(identity) * s_id + a)
//   out = clip(rint(a * inv_out), -127, 127) as int8 (round half to even,
//         as jnp.round), or a as bf16 / f32.
// Every multiply and add of the epilogue is written with an _rn intrinsic:
// nvcc would otherwise contract a * s + b into one FMA, which rounds once
// instead of twice and moves some outputs by one int8 step.
// int32 cannot overflow: |acc| <= 27 * 256 * 127^2 < 1.2e8.
// Unlike the TPU kernel, cin may differ from cout (the 32 -> num_classes
// head is quantized too), and the residual identity is its own tensor, so
// the tail of a multi-conv chain fuses into the chain's last conv.
//
// What bounds it on the H100 (1,979 TOPS int8 dense, 3.35 TB/s, 1 byte per
// activation element): per output voxel 2 * 27 * cin * cout operations
// against cin + cout (+ cout identity) bytes. The 32-channel residual convs
// do ~600-860 operations per byte, about the card's balance point (590);
// the 64..256-channel ones are compute-bound; the 32 -> 2 head does ~100
// and is memory-bound.
//
// What the design does about it:
// - wide sites (cin % 32 == 0, any cout): an implicit GEMM on wgmma
//   (m64nNk32 s8 -> s32, N = 8, 32 or 64 output channels per block), the
//   shared mainloop of conv_wgmma.cuh: the output box's input halo comes
//   into shared memory once per 32-channel slice by TMA, and the 27 taps are
//   descriptor offsets into it; the weights, repacked K-major by the wrapper
//   (s8 wgmma takes only K-major operands), come by bulk copy through a ring
//   of mbarrier-tracked stages. The 32 -> 2 head runs here too, N padded to
//   8: it is bound by its bytes.
// - thin sites (cin not a multiple of 32): a direct conv on the CUDA
//   cores, one thread per output voxel x up to 16 output channels, with
//   __dp4a (4 exact int8 multiply-adds per instruction) on 4 packed input
//   channels; weights staged in shared memory as packed words.
// - the epilogue runs on the int32 accumulators in registers and writes the
//   output once, two adjacent channels per store; no f32 intermediate
//   reaches device memory.
// The TPU kernel's 128-lane packing, its y-tiling and its row gather exist
// only for the TPU and are not copied.
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

struct Args {
  const int8_t* x;         // [B, D, H, W, cin]
  const int8_t* w;         // [3, 3, 3, cin, cout]
  const float* scale;      // [cout] dequant multiplier
  const float* bias;       // [cout]
  const int8_t* identity;  // [B, D, H, W, cout] or nullptr (no tail)
  void* out;               // [B, D, H, W, cout]
  int D, H, W, cin, cout;
  long long nvox;          // B * D * H * W
  int act;
  float alpha;
  int res_act;
  float res_alpha;
  float s_id;
  int out_kind;
  float inv_out;
};

__device__ __forceinline__ float activate(float v, int kind, float a) {
  if (kind == ACT_RELU) return fmaxf(v, 0.0f);
  if (kind == ACT_PRELU) return v >= 0.0f ? v : __fmul_rn(a, v);
  return v;
}

// acc: the int32 conv sum for (vox, co); returns the value before the
// output conversion.
__device__ __forceinline__ float epilogue_value(const Args& p, long long vox,
                                                int co, int acc) {
  float a = __fadd_rn(__fmul_rn(__int2float_rn(acc), p.scale[co]), p.bias[co]);
  a = activate(a, p.act, p.alpha);
  if (p.identity != nullptr) {
    const float id =
        __int2float_rn(static_cast<int>(p.identity[vox * p.cout + co]));
    a = activate(__fadd_rn(__fmul_rn(id, p.s_id), a), p.res_act, p.res_alpha);
  }
  return a;
}

__device__ __forceinline__ int8_t requant(const Args& p, float a) {
  float q = rintf(__fmul_rn(a, p.inv_out));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(q);
}

__device__ __forceinline__ void store_value(const Args& p, long long o, float a) {
  if (p.out_kind == OUT_I8) {
    static_cast<int8_t*>(p.out)[o] = requant(p, a);
  } else if (p.out_kind == OUT_F32) {
    static_cast<float*>(p.out)[o] = a;
  } else {
    static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(a);
  }
}

__device__ __forceinline__ void epilogue(const Args& p, long long vox, int co,
                                         int acc) {
  store_value(p, vox * p.cout + co, epilogue_value(p, vox, co, acc));
}

// ---------------------------------------------------------------------------
// Tensor-core path: the shared wgmma mainloop (conv_wgmma.cuh), s8 -> s32.
// ---------------------------------------------------------------------------

struct I8Op {
  using Acc = int;
  using Args = ::Args;

  // one m64nNk32 s8 wgmma, A and B K-major in shared memory
  template <int N>
  static __device__ __forceinline__ void mma(int (&d)[N / 2], uint64_t a,
                                             uint64_t b) {
    if constexpr (N == 8) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
          "{%0, %1, %2, %3}, %4, %5, p;\n}\n"
          : CONVWG_ACC4("+r", d, 0)
          : "l"(a), "l"(b), "r"(1));
    } else if constexpr (N == 32) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
          "%15}, %16, %17, p;\n}\n"
          : CONVWG_ACC16("+r", d, 0)
          : "l"(a), "l"(b), "r"(1));
    } else {
      static_assert(N == 64, "N is 8, 32 or 64");
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
          "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
          "%28, %29, %30, %31}, %32, %33, p;\n}\n"
          : CONVWG_ACC32("+r", d, 0)
          : "l"(a), "l"(b), "r"(1));
    }
  }

  // channels co .. co + n - 1 (n <= 8) of voxel vox, from the staged
  // accumulators a; one vector store where all 8 are there and aligned
  static __device__ __forceinline__ void store8(const Args& p, long long vox,
                                                int co, const int* a, int n) {
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
// CUDA-core direct conv (__dp4a) for thin channel counts.
// ---------------------------------------------------------------------------

constexpr int CI_CHUNK = 32;            // input channels staged per pass
constexpr int CW_CHUNK = CI_CHUNK / 4;  // packed weight words per pass

// 4 input channels of one voxel as a packed word (zeros past ``n``).
__device__ __forceinline__ int load_word(const int8_t* xp, int n, bool aligned) {
  if (aligned) return *reinterpret_cast<const int*>(xp);
  unsigned w = 0;
  for (int e = 0; e < 4 && e < n; ++e)
    w |= static_cast<unsigned>(static_cast<uint8_t>(xp[e])) << (8 * e);
  return static_cast<int>(w);
}

template <int CO>
__global__ void __launch_bounds__(128) conv_i8_direct_kernel(Args p) {
  __shared__ int ws[27 * CW_CHUNK * CO];  // [tap][ci / 4][co], 4 x int8
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
  int acc[CO];
#pragma unroll
  for (int j = 0; j < CO; ++j) acc[j] = 0;
  const bool vec16 = (p.cin & 15) == 0, vec4 = (p.cin & 3) == 0;

  for (int ci0 = 0; ci0 < p.cin; ci0 += CI_CHUNK) {
    const int cc = min(CI_CHUNK, p.cin - ci0);
    const int nw = (cc + 3) / 4;
    __syncthreads();
    for (int i = threadIdx.x; i < 27 * nw * CO; i += blockDim.x) {
      const int j = i % CO, r = i / CO;
      const int g = r % nw, tap = r / nw;
      const int co = co0 + j;
      unsigned word = 0;
      for (int e = 0; e < 4; ++e) {
        const int ci = g * 4 + e;
        if (ci < cc && co < p.cout) {
          const int8_t v =
              p.w[(static_cast<long long>(tap) * p.cin + ci0 + ci) * p.cout + co];
          word |= static_cast<unsigned>(static_cast<uint8_t>(v)) << (8 * e);
        }
      }
      ws[(tap * CW_CHUNK + g) * CO + j] = static_cast<int>(word);
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
          const int8_t* xp =
              p.x + ((((b * p.D + zz) * p.H + yy) * p.W + xx) * p.cin + ci0);
          const int* wp = ws + ((dz * 3 + dy) * 3 + dx) * CW_CHUNK * CO;
          int g = 0;
          if (vec16) {
            // 16 channels per 16-byte load (xp is 16-byte aligned here)
            for (; g < nw; g += 4) {
              const int4 v = *reinterpret_cast<const int4*>(xp + 4 * g);
              const int xw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int j = 0; j < CO; ++j)
                  acc[j] = __dp4a(xw[k], wp[(g + k) * CO + j], acc[j]);
            }
          }
          for (; g < nw; ++g) {
            const int xw = load_word(xp + 4 * g, cc - 4 * g, vec4);
#pragma unroll
            for (int j = 0; j < CO; ++j)
              acc[j] = __dp4a(xw, wp[g * CO + j], acc[j]);
          }
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < CO; ++j)
    if (co0 + j < p.cout) epilogue(p, vox, co0 + j, acc[j]);
}

template <int CO>
void launch_direct(const Args& p, cudaStream_t s) {
  dim3 grid(static_cast<unsigned>((p.nvox + 127) / 128), (p.cout + CO - 1) / CO);
  conv_i8_direct_kernel<CO><<<grid, 128, 0, s>>>(p);
}

Args make_args(const void* x, const void* w, const void* scale,
               const void* bias, const void* identity, void* out, int B, int D,
               int H, int W, int cin, int cout, int act, float alpha,
               int res_act, float res_alpha, float s_id, int out_kind,
               float inv_out) {
  Args p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.identity = static_cast<const int8_t*>(identity);
  p.out = out;
  p.D = D; p.H = H; p.W = W; p.cin = cin; p.cout = cout;
  p.nvox = static_cast<long long>(B) * D * H * W;
  p.act = act; p.alpha = alpha;
  p.res_act = res_act; p.res_alpha = res_alpha; p.s_id = s_id;
  p.out_kind = out_kind; p.inv_out = inv_out;
  return p;
}

}  // namespace

extern "C" {

// 1 when (cin, cout) takes the tensor-core (wgmma) path, 0 for the direct
// path.
int window_conv_i8_uses_tensor_cores(int cin, int cout) {
  return (cin % 32 == 0 && cout >= 1) ? 1 : 0;
}

// The direct path, w as [3, 3, 3, cin, cout]. A tensor-core site is
// refused (cudaErrorInvalidValue): it needs its plan and packed weights,
// window_conv_i8_launch_wgmma.
int window_conv_i8_launch(const void* x, const void* w, const void* scale,
                          const void* bias, const void* identity, void* out,
                          int B, int D, int H, int W, int cin, int cout,
                          int act, float alpha, int res_act, float res_alpha,
                          float s_id, int out_kind, float inv_out,
                          void* stream) {
  const Args p = make_args(x, w, scale, bias, identity, out, B, D, H, W, cin,
                           cout, act, alpha, res_act, res_alpha, s_id,
                           out_kind, inv_out);
  if (p.nvox == 0) return 0;
  if (window_conv_i8_uses_tensor_cores(cin, cout))
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
int window_conv_i8_launch_wgmma(const void* x, const void* wp, const void* scale,
                                const void* bias, const void* identity,
                                void* out, int B, int D, int H, int W, int cin,
                                int cout, int act, float alpha, int res_act,
                                float res_alpha, float s_id, int out_kind,
                                float inv_out, const int* plan, void* stream) {
  const Args p = make_args(x, wp, scale, bias, identity, out, B, D, H, W, cin,
                           cout, act, alpha, res_act, res_alpha, s_id,
                           out_kind, inv_out);
  if (p.nvox == 0) return 0;
  if (!window_conv_i8_uses_tensor_cores(cin, cout))
    return static_cast<int>(cudaErrorInvalidValue);
  return convwg::launch<I8Op>(x, wp, p, B, D, H, W, cin, cout, plan,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"

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
// What the design does about it (a first, simple version; no TMA, wgmma or
// warp specialisation yet):
// - wide sites (Cin % 32 == 0 and Cout % 32 == 0): an implicit GEMM on the
//   tensor cores (WMMA bf16 16x16x16, f32 accumulators). A block owns 64
//   output voxels x 32 or 64 output channels; the K loop walks the 27 taps
//   x 32-channel slices, gathering the shifted input rows (zeros outside
//   the volume) and the matching weight slice into shared memory.
// - thin sites (anything else, e.g. the stem and the head): a direct conv on
//   the CUDA cores, one thread per output voxel x up to 16 output channels,
//   weights staged in shared memory. No channel is padded: a Cout = 2 head
//   computes 2 channels, a Cin = 1 stem reads 1 channel.
// - the epilogue runs on the f32 accumulators in registers / shared memory
//   and writes the output once; the residual identity is read straight
//   from the input.
// The TPU kernel's lane packing (L = 128 // Cout x-positions per lane), its
// y-tiling and its z-chunk split exist only for the TPU and are not copied.
//
// Plain C interface, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

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

// acc: the f32 conv sum for (vox, co) without bias.
__device__ __forceinline__ void epilogue(const ConvArgs& p, long long vox,
                                         int co, float acc) {
  acc = acc + p.bias[co];
  acc = activate(acc, p.act, p.alpha);
  if (p.residual != ACT_NONE) {
    acc = acc + __bfloat162float(p.x[vox * p.cin + co]);
    acc = activate(acc, p.residual, p.res_alpha);
  }
  const long long o = vox * p.cout + co;
  if (p.out_kind == OUT_I8) {
    float q = rintf(acc * p.inv_sa);
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    static_cast<int8_t*>(p.out)[o] = static_cast<int8_t>(q);
  } else if (p.out_kind == OUT_F32) {
    static_cast<float*>(p.out)[o] = acc;
  } else {
    static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(acc);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core implicit GEMM: M = voxels, N = cout, K = 27 * cin.
// ---------------------------------------------------------------------------

constexpr int BM = 64;       // output voxels per block (4 warps x 16 rows)
constexpr int KC = 32;       // input channels per K step
constexpr int A_LD = KC + 8;  // padded smem strides (multiples of 8 bf16)

template <int BN>
__global__ void __launch_bounds__(128) conv_wmma_kernel(ConvArgs p) {
  constexpr int B_LD = BN + 8;
  constexpr int C_LD = BN + 4;
  constexpr int NF = BN / 16;
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[KC * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // Each thread gathers 16-byte pieces of two A rows: rows tid/4 and
  // tid/4 + 32, piece tid%4 (8 channels) of the 32-channel slice.
  const int part = tid & 3;
  int rz[2], ry[2], rx[2];
  long long rb[2];
  bool rok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long vox = m0 + (tid >> 2) + 32 * i;
    rok[i] = vox < p.nvox;
    long long t = rok[i] ? vox : 0;
    rx[i] = static_cast<int>(t % p.W); t /= p.W;
    ry[i] = static_cast<int>(t % p.H); t /= p.H;
    rz[i] = static_cast<int>(t % p.D);
    rb[i] = t / p.D;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int tap = 0; tap < 27; ++tap) {
    const int dz = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dx = tap % 3 - 1;
    const __nv_bfloat16* src[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int z = rz[i] + dz, y = ry[i] + dy, x = rx[i] + dx;
      const bool ok = rok[i] && z >= 0 && z < p.D && y >= 0 && y < p.H &&
                      x >= 0 && x < p.W;
      src[i] = ok ? p.x + ((((rb[i] * p.D + z) * p.H + y) * p.W + x) *
                               p.cin + part * 8)
                  : nullptr;
    }
    for (int k0 = 0; k0 < p.cin; k0 += KC) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        int4 v = make_int4(0, 0, 0, 0);
        if (src[i] != nullptr) v = *reinterpret_cast<const int4*>(src[i] + k0);
        *reinterpret_cast<int4*>(&As[((tid >> 2) + 32 * i) * A_LD + part * 8]) = v;
      }
      const __nv_bfloat16* wsrc =
          p.w + (static_cast<long long>(tap) * p.cin + k0) * p.cout + n0;
      for (int c = tid; c < KC * BN / 8; c += 128) {
        const int r = c / (BN / 8), q = c % (BN / 8);
        *reinterpret_cast<int4*>(&Bs[r * B_LD + q * 8]) =
            *reinterpret_cast<const int4*>(wsrc + static_cast<long long>(r) * p.cout + q * 8);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, &As[(warp * 16) * A_LD + kk], A_LD);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, &Bs[kk * B_LD + j * 16], B_LD);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < NF; ++j)
    wmma::store_matrix_sync(&Cs[(warp * 16) * C_LD + j * 16], acc[j], C_LD,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += 128) {
    const int r = i / BN, c = i % BN;
    const long long vox = m0 + r;
    if (vox < p.nvox) epilogue(p, vox, n0 + c, Cs[r * C_LD + c]);
  }
}

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
#pragma unroll
  for (int j = 0; j < CO; ++j)
    if (co0 + j < p.cout) epilogue(p, vox, co0 + j, acc[j]);
}

template <int CO>
void launch_direct(const ConvArgs& p, cudaStream_t s) {
  dim3 grid(static_cast<unsigned>((p.nvox + 127) / 128), (p.cout + CO - 1) / CO);
  conv_direct_kernel<CO><<<grid, 128, 0, s>>>(p);
}

}  // namespace

extern "C" {

// 1 when (cin, cout) takes the tensor-core path, 0 for the direct path.
int thin_conv3d_uses_tensor_cores(int cin, int cout) {
  return (cin % KC == 0 && cout % 32 == 0) ? 1 : 0;
}

int thin_conv3d_launch(const void* x, const void* w, const void* bias,
                       void* out, int B, int D, int H, int W, int cin,
                       int cout, int act, float alpha, int residual,
                       float res_alpha, int out_kind, float inv_sa,
                       void* stream) {
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
  if (p.nvox == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (thin_conv3d_uses_tensor_cores(cin, cout)) {
    const unsigned gm = static_cast<unsigned>((p.nvox + BM - 1) / BM);
    if (cout % 64 == 0)
      conv_wmma_kernel<64><<<dim3(gm, cout / 64), 128, 0, s>>>(p);
    else
      conv_wmma_kernel<32><<<dim3(gm, cout / 32), 128, 0, s>>>(p);
  } else if (cout >= 16) {
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

}  // extern "C"

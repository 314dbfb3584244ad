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
// What the design does about it (a first, simple version; no TMA, wgmma or
// pipelined K loop yet):
// - wide sites (cin % 32 == 0 and cout % 32 == 0): an implicit GEMM on the
//   int8 tensor cores (WMMA s8 16x16x16, int32 accumulators). A block owns
//   64 output voxels x 32 or 64 output channels; the K loop walks 27 taps x
//   32-channel slices, gathering each voxel's 32-byte shifted input row with
//   two 16-byte loads (zeros outside the volume) and the weight slice into
//   shared memory.
// - thin sites (anything else, e.g. the head): a direct conv on the CUDA
//   cores, one thread per output voxel x up to 16 output channels, with
//   __dp4a (4 exact int8 multiply-adds per instruction) on 4 packed input
//   channels; weights staged in shared memory as packed words. No channel
//   is padded: a cout = 2 head computes 2 channels.
// - the epilogue runs on the int32 accumulators and writes the output once;
//   no f32 intermediate reaches device memory.
// The TPU kernel's 128-lane packing, its y-tiling and its row gather exist
// only for the TPU and are not copied.
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

__device__ __forceinline__ void epilogue(const Args& p, long long vox, int co,
                                         int acc) {
  float a = __fadd_rn(__fmul_rn(__int2float_rn(acc), p.scale[co]), p.bias[co]);
  a = activate(a, p.act, p.alpha);
  const long long o = vox * p.cout + co;
  if (p.identity != nullptr) {
    const float id = __int2float_rn(static_cast<int>(p.identity[o]));
    a = activate(__fadd_rn(__fmul_rn(id, p.s_id), a), p.res_act, p.res_alpha);
  }
  if (p.out_kind == OUT_I8) {
    float q = rintf(__fmul_rn(a, p.inv_out));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    static_cast<int8_t*>(p.out)[o] = static_cast<int8_t>(q);
  } else if (p.out_kind == OUT_F32) {
    static_cast<float*>(p.out)[o] = a;
  } else {
    static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(a);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core implicit GEMM: M = voxels, N = cout, K = 27 * cin.
// ---------------------------------------------------------------------------

constexpr int BM = 64;  // output voxels per block (4 warps x 16 rows)
constexpr int KC = 32;  // input channels per K step (two WMMA k-slices)

// Shared tiles are kept as 16-byte-wide slices ([slice][row][16]) so that
// every WMMA fragment starts on a 32-byte boundary, as load_matrix_sync
// requires: A as two k-halves of [BM][16], B as BN/16 column blocks of
// [KC][16].
template <int BN>
__global__ void __launch_bounds__(128) conv_i8_wmma_kernel(Args p) {
  constexpr int NF = BN / 16;
  constexpr int C_LD = BN + 4;
  __shared__ __align__(128) signed char As[2 * BM * 16];
  __shared__ __align__(128) signed char Bs[NF * KC * 16];
  __shared__ __align__(128) int Cs[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // Each thread gathers one 16-byte half (tid & 1) of row tid / 2's
  // 32-channel slice.
  const int row = tid >> 1, half = tid & 1;
  const long long vox = m0 + row;
  const bool rok = vox < p.nvox;
  long long t = rok ? vox : 0;
  const int rx = static_cast<int>(t % p.W); t /= p.W;
  const int ry = static_cast<int>(t % p.H); t /= p.H;
  const int rz = static_cast<int>(t % p.D);
  const long long rb = t / p.D;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0);

  for (int tap = 0; tap < 27; ++tap) {
    const int dz = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dx = tap % 3 - 1;
    const int z = rz + dz, y = ry + dy, x = rx + dx;
    const bool ok = rok && z >= 0 && z < p.D && y >= 0 && y < p.H &&
                    x >= 0 && x < p.W;
    const int8_t* src =
        ok ? p.x + ((((rb * p.D + z) * p.H + y) * p.W + x) * p.cin + half * 16)
           : nullptr;
    for (int k0 = 0; k0 < p.cin; k0 += KC) {
      int4 v = make_int4(0, 0, 0, 0);
      if (src != nullptr) v = *reinterpret_cast<const int4*>(src + k0);
      *reinterpret_cast<int4*>(&As[(half * BM + row) * 16]) = v;
      const int8_t* wsrc =
          p.w + (static_cast<long long>(tap) * p.cin + k0) * p.cout + n0;
      for (int c = tid; c < NF * KC; c += 128) {
        const int q = c / KC, r = c % KC;
        *reinterpret_cast<int4*>(&Bs[(q * KC + r) * 16]) =
            *reinterpret_cast<const int4*>(wsrc + static_cast<long long>(r) * p.cout + q * 16);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
        wmma::load_matrix_sync(a, &As[(kk * BM + warp * 16) * 16], 16);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b;
          wmma::load_matrix_sync(b, &Bs[(j * KC + kk * 16) * 16], 16);
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
    const long long v = m0 + r;
    if (v < p.nvox) epilogue(p, v, n0 + c, Cs[r * C_LD + c]);
  }
}

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

}  // namespace

extern "C" {

// 1 when (cin, cout) takes the tensor-core path, 0 for the direct path.
int window_conv_i8_uses_tensor_cores(int cin, int cout) {
  return (cin % KC == 0 && cout % 32 == 0) ? 1 : 0;
}

int window_conv_i8_launch(const void* x, const void* w, const void* scale,
                          const void* bias, const void* identity, void* out,
                          int B, int D, int H, int W, int cin, int cout,
                          int act, float alpha, int res_act, float res_alpha,
                          float s_id, int out_kind, float inv_out,
                          void* stream) {
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
  if (p.nvox == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (window_conv_i8_uses_tensor_cores(cin, cout)) {
    const unsigned gm = static_cast<unsigned>((p.nvox + BM - 1) / BM);
    if (cout % 64 == 0)
      conv_i8_wmma_kernel<64><<<dim3(gm, cout / 64), 128, 0, s>>>(p);
    else
      conv_i8_wmma_kernel<32><<<dim3(gm, cout / 32), 128, 0, s>>>(p);
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

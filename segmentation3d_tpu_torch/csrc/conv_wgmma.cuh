// Shared Hopper mainloop of the stride-1 SAME 3x3x3 convs (thin_conv3d.cu,
// window_conv_i8.cu): an implicit GEMM on wgmma with the input's halo in
// shared memory, loaded by TMA.
//
// Geometry (planned in Python, segmentation3d_tpu_torch/ops/conv_plan.py,
// and passed to the launch as an int32 array of PLAN_LEN entries):
// - A block computes an output box of 8 (x) x 8 (y) x MT (z) voxels for BN
//   output channels. Each z plane of the box is one 64-row wgmma tile:
//   row r is the voxel (x = r % 8, y = r / 8) of that plane.
// - K runs over 32-byte slices of the input channels (16 bf16 or 32 int8
//   channels: one wgmma k-step) and, inside a slice, over the 27 taps.
// - For each slice the block loads the box's halo, (8+2) x (8+2) x (MT+2)
//   voxels, as two 16-byte channel planes [chunk][z][y][x][16 B] with two
//   5-D TMA loads (box (16 B, Xh, Yh, Zh, 1) at (c, x0-1, y0-1, z0-1, b));
//   voxels outside the volume arrive as zeros, which is the SAME padding.
//   That is wgmma's no-swizzle K-major layout: a core matrix is 8
//   consecutive x positions x 16 B, SBO (next 8 rows = next y) is Xh * 16 B,
//   LBO (next 16-byte K chunk) is the plane. Every tap of the slice reads
//   the same planes through a descriptor whose start moves by the tap's
//   offset ((dz * Yh + dy) * Xh + dx) * 16 B: no gather, and each input
//   voxel is read ~(10 * 10 * (MT+2)) / (64 * MT) times instead of 27.
// - The weights are repacked by the wrapper to [nblk][ks][27][2][BN][16 B]
//   (K-major, N padded with zeros), so one slice's 27 taps for one block of
//   BN channels are one contiguous run, brought by one bulk copy.
// - A ring of `stages` slots (halo planes + weights) with a full and an
//   empty mbarrier each (the 27 tap offsets follow the barriers); one producer thread keeps the copies in flight
//   while the consumer warpgroup runs 27 * MT wgmma per slice, one slice's
//   group still in flight while the next one starts.
// - The epilogue stages each 64-row tile's accumulators in shared memory
//   (the ring is free by then); each thread then hands a run of 8 channels
//   of one voxel to the kernel's own epilogue (Op::store8: its f32 ops in
//   their order, one 16-byte bf16 or 8-byte int8 store). Rows outside the
//   volume and channels past cout are masked.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace convwg {

// Indices of the plan array (ops/conv_plan.py: PLAN_FIELDS, same order).
enum {
  P_BN, P_MT, P_NBX, P_NBY, P_NBZ, P_NBLK, P_KS, P_XH, P_YH, P_ZH,
  P_PLANE_BYTES, P_W_STAGE_BYTES, P_STAGE_BYTES, P_STAGES, P_TX_BYTES,
  P_SMEM_BYTES,
  P_LBO_A, P_SBO_A, P_LBO_B, P_SBO_B, P_TILE_A, P_GRID_X, P_GRID_Y,
  P_TAP0, PLAN_LEN = P_TAP0 + 27
};

constexpr int kConsumers = 128;             // one warpgroup
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kMaxSmem = 232448;            // 227 KB per block on sm_90

struct Geom {
  const uint8_t* wp;  // packed weights
  int B, D, H, W, cout;
  int nbx, nby, nbz, ks;
  int plane, wstage, stage, stages, tx;
  int lbo_a, sbo_a, lbo_b, sbo_b, tile_a;
  int tap[27];
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
// The spin loop stays inside the PTX, so the compiler sees no divergent
// path around the wgmma that follow.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3, int c4,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, no swizzle: start, LBO, SBO in 16 B units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// barrier of the consumer warpgroup alone (the producer warp has left)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// ---------------------------------------------------------------------------
// The mainloop kernel. Op supplies Acc (float / int), mma<BN>() (one
// m64nBNk(32 bytes) wgmma) and store8() (the epilogue of up to 8 channels).
// ---------------------------------------------------------------------------

template <class Op, int BN, int MT>
__global__ void __launch_bounds__(kThreads, 1)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap halo_map,
                      const typename Op::Args p, const Geom g) {
  using Acc = typename Op::Acc;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 127u) & ~127u;
  const uint32_t full = base + g.stages * g.stage;  // full[s] = full + 8 s
  const uint32_t empty = full + 8 * g.stages;       // empty[s] = empty + 8 s
  // the plan's 27 tap offsets, after the barriers
  int* taps = reinterpret_cast<int*>(smem_raw + (empty + 8 * g.stages -
                                                 smem_u32(smem_raw)));

  long long t = blockIdx.x;
  const int bx = static_cast<int>(t % g.nbx); t /= g.nbx;
  const int by = static_cast<int>(t % g.nby); t /= g.nby;
  const int bz = static_cast<int>(t % g.nbz);
  const int b = static_cast<int>(t / g.nbz);
  const int x0 = bx * 8, y0 = by * 8, z0 = bz * MT;

  if (threadIdx.x < 27) taps[threadIdx.x] = g.tap[threadIdx.x];
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  // the role, uniform across each warp (the consumer warpgroup's wgmma
  // must not sit in a path the compiler thinks divergent)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / kConsumers, 0);
  if (role != 0) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == kConsumers) {
      const uint8_t* wsrc =
          g.wp + static_cast<long long>(blockIdx.y) * g.ks * g.wstage;
      for (int ks = 0; ks < g.ks; ++ks) {
        const int s = ks % g.stages, round = ks / g.stages;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        const uint32_t slot = base + s * g.stage, bar = full + 8 * s;
        mbar_expect_tx(bar, g.tx);
        tma_load_5d(slot, &halo_map, ks * 32, x0 - 1, y0 - 1, z0 - 1, b, bar);
        tma_load_5d(slot + g.plane, &halo_map, ks * 32 + 16, x0 - 1, y0 - 1,
                    z0 - 1, b, bar);
        bulk_load(slot + 2 * g.plane, wsrc + static_cast<long long>(ks) * g.wstage,
                  g.wstage, bar);
      }
    }
    return;
  }

  // consumers: one warpgroup, MT tiles of 64 rows x BN
  Acc acc[MT][BN / 2];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[j][i] = Acc(0);

  for (int ks = 0; ks < g.ks; ++ks) {
    const int s = ks % g.stages;
    mbar_wait(full + 8 * s, (ks / g.stages) & 1);
    const uint32_t slot = base + s * g.stage;
    const uint32_t wbase = slot + 2 * g.plane;
    wg_fence();
    // the 27 taps x MT tiles of this slice, all in flight at once
#pragma unroll 1
    for (int tap = 0; tap < 27; ++tap) {
      const uint64_t db = make_desc(wbase + tap * (2 * BN * 16), g.lbo_b, g.sbo_b);
      const uint32_t a0 = slot + taps[tap];
#pragma unroll
      for (int j = 0; j < MT; ++j)
        Op::template mma<BN>(acc[j], make_desc(a0 + j * g.tile_a, g.lbo_a, g.sbo_a),
                             db);
    }
    wg_commit();
    if (g.stages == 1) {
      // one slot: it is free only once this slice's group is done
      wg_wait0();
      mbar_arrive(empty);
    } else {
      // keep this slice's group in flight; the previous slice's is done,
      // so its slot goes back to the producer
      wg_wait1();
      if (ks > 0) mbar_arrive(empty + 8 * ((ks - 1) % g.stages));
    }
  }
  wg_wait0();

  // epilogue: each 64-row tile's accumulators go to shared memory (the
  // ring is free now: every slot has been consumed), then each thread
  // finishes runs of 8 channels of one voxel (Op::store8: 16-byte stores
  // of bf16, 8-byte of int8). Accumulator j, element 4 q + 2 h + e is row
  // 16 warp + lane / 4 + 8 h, column 8 q + 2 (lane % 4) + e.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  constexpr int LD = BN + 4;  // staged row stride, in accumulators
  Acc* tile = reinterpret_cast<Acc*>(smem_raw + (base - smem_u32(smem_raw)));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < MT; ++j) {
#pragma unroll
    for (int q = 0; q < BN / 8; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + (lane >> 2) + 8 * h, c = 8 * q + 2 * (lane & 3);
        tile[r * LD + c] = acc[j][4 * q + 2 * h];
        tile[r * LD + c + 1] = acc[j][4 * q + 2 * h + 1];
      }
    consumer_sync();
    const int z = z0 + j;
    for (int i = threadIdx.x; i < 8 * BN; i += kConsumers) {
      const int r = i / (BN / 8), col = (i % (BN / 8)) * 8;
      const int x = x0 + (r & 7), y = y0 + (r >> 3);
      const int co = blockIdx.y * BN + col;
      if (z < g.D && y < g.H && x < g.W && co < g.cout) {
        const long long vox =
            ((static_cast<long long>(b) * g.D + z) * g.H + y) * g.W + x;
        Op::store8(p, vox, co, tile + r * LD + col, min(8, g.cout - co));
      }
    }
    consumer_sync();
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the process has already
// loaded (no link against libcuda needed).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (h != nullptr)
      fn = reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// The halo map: the input [B, D, H, W, cbytes] as bytes, box
// (16, Xh, Yh, Zh, 1), zeros outside.
inline bool encode_halo_map(CUtensorMap* map, const void* x, int B, int D, int H,
                            int W, int cbytes, const int* plan) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(cbytes),
                              static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(B)};
  // byte strides of dims 1..4 (W, H, D, B); dim 0 is contiguous
  const cuuint64_t row = static_cast<cuuint64_t>(cbytes);
  const cuuint64_t strides[4] = {row, row * W, row * W * H, row * W * H * D};
  const cuuint32_t box[5] = {16, static_cast<cuuint32_t>(plan[P_XH]),
                             static_cast<cuuint32_t>(plan[P_YH]),
                             static_cast<cuuint32_t>(plan[P_ZH]), 1};
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, const_cast<void*>(x), dims,
            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class Op, int BN, int MT>
int launch_one(const CUtensorMap& map, const typename Op::Args& p, const Geom& g,
               const int* plan, cudaStream_t s) {
  auto kern = conv_wgmma_kernel<Op, BN, MT>;
  const int smem = plan[P_SMEM_BYTES];
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(plan[P_GRID_X], plan[P_GRID_Y]), kThreads, smem, s>>>(map, p, g);
  return static_cast<int>(cudaGetLastError());
}

// Checks the plan, encodes the halo map and launches the (BN, MT)
// instance. Returns a CUDA error code, or cudaErrorInvalidValue for a plan
// the kernel does not take.
template <class Op>
int launch(const void* x, const void* wpacked, const typename Op::Args& p, int B,
           int D, int H, int W, int cbytes, int cout, const int* plan,
           cudaStream_t s) {
  const int bn = plan[P_BN], mt = plan[P_MT];
  if (plan[P_SMEM_BYTES] > kMaxSmem || plan[P_STAGES] < 1 || cbytes % 32 != 0 ||
      plan[P_KS] * 32 != cbytes || plan[P_XH] != 10 || plan[P_YH] != 10 ||
      plan[P_ZH] != mt + 2 || plan[P_NBLK] != plan[P_GRID_Y] ||
      static_cast<long long>(plan[P_NBLK]) * bn < cout)
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  g.wp = static_cast<const uint8_t*>(wpacked);
  g.B = B; g.D = D; g.H = H; g.W = W; g.cout = cout;
  g.nbx = plan[P_NBX]; g.nby = plan[P_NBY]; g.nbz = plan[P_NBZ]; g.ks = plan[P_KS];
  g.plane = plan[P_PLANE_BYTES]; g.wstage = plan[P_W_STAGE_BYTES]; g.stage = plan[P_STAGE_BYTES];
  g.stages = plan[P_STAGES]; g.tx = plan[P_TX_BYTES];
  g.lbo_a = plan[P_LBO_A]; g.sbo_a = plan[P_SBO_A];
  g.lbo_b = plan[P_LBO_B]; g.sbo_b = plan[P_SBO_B]; g.tile_a = plan[P_TILE_A];
  for (int i = 0; i < 27; ++i) g.tap[i] = plan[P_TAP0 + i];
  CUtensorMap map;
  if (!encode_halo_map(&map, x, B, D, H, W, cbytes, plan))
    return static_cast<int>(cudaErrorInvalidValue);
#define CONVWG_CASE(N, M) \
  if (bn == N && mt == M) return launch_one<Op, N, M>(map, p, g, plan, s);
  // the instances ops/conv_plan.py may plan (MT_CHOICES)
  CONVWG_CASE(8, 8) CONVWG_CASE(8, 1)
  CONVWG_CASE(32, 4) CONVWG_CASE(32, 1)
  CONVWG_CASE(64, 4) CONVWG_CASE(64, 2) CONVWG_CASE(64, 1)
#undef CONVWG_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace convwg

// Operand lists of the accumulators for the kernels' wgmma wrappers.
#define CONVWG_ACC4(c, d, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define CONVWG_ACC8(c, d, i) CONVWG_ACC4(c, d, i), CONVWG_ACC4(c, d, i + 4)
#define CONVWG_ACC16(c, d, i) CONVWG_ACC8(c, d, i), CONVWG_ACC8(c, d, i + 8)
#define CONVWG_ACC32(c, d, i) CONVWG_ACC16(c, d, i), CONVWG_ACC16(c, d, i + 16)

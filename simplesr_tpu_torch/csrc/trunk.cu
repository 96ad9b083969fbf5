// Residual trunk of the BN-free SRResNet, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel srresnet_trunk_pallas
// (simplesr_tpu/ops/pallas/trunk_kernel.py). Per residual block:
//   y = bf16(PReLU(conv3x3(x) + b1; alpha))
//   x = bf16(f32(x) + conv3x3(y) + b2)
// with 3x3 SAME zero padding, bf16 operands and bf16 storage between the
// convs, f32 accumulation, and the bias / PReLU / residual add done in f32
// before the single rounding to bf16: the rounding points of the TPU kernel.
//
// Bound on the H100: operations. One 3x3 64->64 conv does 73,728 FLOP per
// pixel and moves 256 bytes of activations per pixel, about 290 FLOP/byte,
// right at the bf16 ridge of the card. So the design feeds the tensor cores
// through wgmma and keeps every load off their critical path:
//
// - One launch per conv (both convs of a block do not fit on chip at C = 64:
//   full-width rows need (R + 4) x 194 x 128 B for x alone). The grid is
//   persistent: one CTA per SM walks the output tiles t = blockIdx.x +
//   k * gridDim.x. A tile is 4 output rows x 64 pixels, all 64 channels.
// - The conv's weights (73,728 B) reach shared memory once per CTA, by bulk
//   asynchronous copies, already in the layout wgmma's descriptor reads: per
//   tap, 64 rows (output channels) of 64 input channels, K-major, with the
//   16-byte chunk j of row r at chunk j ^ (r & 7) (128-byte swizzle). The
//   host builds that image (ops/kernels/trunk.py: swizzle_trunk_weights); it
//   also orders the rows so that each thread's accumulators hold 16
//   consecutive output channels, for 16-byte stores in the epilogue.
// - Each tile's (4+2) x (64+2) x 64 halo is one TMA box at (0, x0-1, y0-1, n)
//   with 128-byte swizzle; TMA's out-of-bounds zero fill is the SAME
//   padding. A producer warp keeps a ring of kStages boxes in flight, each
//   with a "full" and an "empty" mbarrier, while the consumers compute.
// - Two consumer warpgroups own 2 of the tile's 4 rows each and run
//   wgmma.m64n64k16 (M = 64 pixels of one row, N = 64 output channels,
//   K = 16 input channels of one tap): 36 k-steps per row. A comes from
//   registers, loaded with ldmatrix.x4 from the swizzled halo (pixel p's
//   chunk j lies at p*128 + (j ^ (p & 7))*16, so a tap's shift is address
//   arithmetic and 8 consecutive pixels hit 8 different banks); each loaded
//   fragment serves both rows where their taps overlap. B comes from the
//   weight image through a descriptor.
// - The epilogue works in registers: bias and PReLU (conv 1), or bias and
//   the residual x read at the same pixels (conv 2, in place, its loads
//   issued before the last products finish); one rounding to bf16, 16-byte
//   stores, ragged right and bottom edges masked.

#include <cuda.h>  // CUtensorMap and its enums only: the driver is reached at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>

#include <mutex>

namespace {

constexpr int kC = 64;                                   // trunk width
constexpr int kTileRows = 4;                             // output rows per tile
constexpr int kTileCols = 64;                            // output pixels per row: wgmma's M
constexpr int kBoxRows = kTileRows + 2;
constexpr int kBoxCols = kTileCols + 2;
constexpr int kPixelBytes = kC * 2;                      // one 128-byte swizzle row
constexpr int kBoxBytes = kBoxRows * kBoxCols * kPixelBytes;      // 50,688
constexpr int kStageBytes = (kBoxBytes + 1023) / 1024 * 1024;     // 51,200: swizzle atoms aligned
constexpr int kStages = 3;
constexpr int kTapBytes = kC * kC * 2;                   // 8,192
constexpr int kWeightBytes = 9 * kTapBytes;              // 73,728
constexpr int kBarriers = 2 * kStages + 1;               // full[], empty[], weights
constexpr int kSmemBytes = 1024 /* alignment slack */ + kWeightBytes + kStages * kStageBytes
                           + kBarriers * 8;              // 228,408 of 232,448
constexpr int kConsumers = 256;                          // two warpgroups
constexpr int kThreads = 128 + kConsumers;               // producer warpgroup first
constexpr int kMaxDevices = 64;

constexpr int kBiasPrelu = 0;     // conv 1 of a block: y = PReLU(conv + b1)
constexpr int kBiasResidual = 1;  // conv 2 of a block: x = x + conv + b2, in place

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for the phase of the given parity to complete. A barrier that does
// not complete in 10 s traps, so a fault shows as a launch failure and not as
// a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t since = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 0xFFFu) == 0) {
      const uint64_t now = global_ns();
      if (since == 0) {
        since = now;
      } else if (now - since > 10000000000ull) {
        __trap();
      }
    }
  }
}

// One TMA box of the (C, W, H, N) activation map into shared memory.
__device__ __forceinline__ void tma_load_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int c, int x, int y, int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(x), "r"(y), "r"(n)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// Descriptor of a K-major bf16 B operand with 128-byte swizzle: rows of 128 B,
// 8-row groups 1024 B apart (the leading byte offset is unused in this mode).
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 pixels x 64 channels, f32) += a (64 x 16, bf16, registers) * B (16 x 64, shared).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc) {
  const int scale_d = 1;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// src_map: TMA map over the conv's input (n, h, w, 64) bf16. dst: the output,
// same shape; for kBiasResidual it holds the block's input x, and each thread
// reads and then overwrites only its own pixels while the conv reads src
// (= y), so the update in place is safe. image: this conv's swizzled weight
// image (9 x 8 KB). bias, alpha: (64,) f32 (alpha unused for kBiasResidual).
template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_c64_kernel(const __grid_constant__ CUtensorMap src_map, __nv_bfloat16* dst,
                   const __nv_bfloat16* __restrict__ image, const float* __restrict__ bias,
                   const float* __restrict__ alpha, int h, int w, int tiles_x, int tiles_y,
                   int num_tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t weights = base;
  const uint32_t stages = base + kWeightBytes;
  const uint32_t bars = stages + kStages * kStageBytes;
  const uint32_t weight_bar = bars + 2 * kStages * 8;
  auto full_bar = [&](int s) { return bars + s * 8; };
  auto empty_bar = [&](int s) { return bars + (kStages + s) * 8; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), kConsumers);
    }
    mbar_init(weight_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&src_map))
                   : "memory");
      mbar_expect_tx(weight_bar, kWeightBytes);
      for (int tap = 0; tap < 9; ++tap) {
        bulk_load(weights + tap * kTapBytes, image + tap * (kTapBytes / 2), kTapBytes,
                  weight_bar);
      }
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
        const int tx = t % tiles_x;
        const int rest = t / tiles_x;
        const int ty = rest % tiles_y;
        const int img = rest / tiles_y;
        mbar_wait(empty_bar(s), phase ^ 1);  // a fresh barrier passes at once
        mbar_expect_tx(full_bar(s), kBoxBytes);
        tma_load_box(stages + s * kStageBytes, &src_map, full_bar(s), 0,
                     tx * kTileCols - 1, ty * kTileRows - 1, img);
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumer warpgroups.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int ct = threadIdx.x - 128;
  const int row0 = 2 * (ct >> 7);  // this warpgroup's first row of the tile
  const int warp = (ct >> 5) & 3;  // rows 16*warp .. 16*warp+15 of each product
  const int lane = ct & 31;
  // ldmatrix.x4: lanes 0-7 address pixels 0-7 at k 0-7, lanes 8-15 pixels
  // 8-15 at k 0-7, lanes 16-31 the same at k 8-15.
  const int a_pixel = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_chunk = lane >> 4;
  // Accumulator element 4i + 2hh + e: pixel 16*warp + g + 8*hh, weight-image
  // row 8i + 2q + e, which holds output channel 16q + 2i + e.
  const int g = lane >> 2;
  const int q = lane & 3;

  float bias_r[16], alpha_r[16];
#pragma unroll
  for (int i = 0; i < 16; i += 4) {
    const float4 b = __ldg(reinterpret_cast<const float4*>(bias + 16 * q + i));
    bias_r[i] = b.x, bias_r[i + 1] = b.y, bias_r[i + 2] = b.z, bias_r[i + 3] = b.w;
    if (kMode == kBiasPrelu) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(alpha + 16 * q + i));
      alpha_r[i] = a.x, alpha_r[i + 1] = a.y, alpha_r[i + 2] = a.z, alpha_r[i + 3] = a.w;
    }
  }
  const uint64_t desc0 = b_descriptor(weights);
  mbar_wait(weight_bar, 0);

  int s = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const int tx = t % tiles_x;
    const int rest = t / tiles_x;
    const int ty = rest % tiles_y;
    const int img = rest / tiles_y;

    float acc[2][32];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[r][i] = 0.0f;
    fence_acc(acc[0]);
    fence_acc(acc[1]);

    mbar_wait(full_bar(s), phase);
    const uint32_t box = stages + s * kStageBytes;
    // Halo row row0 + hr feeds output row row0 through tap row dy = hr and
    // output row row0 + 1 through dy = hr - 1.
#pragma unroll
    for (int hr = 0; hr < 4; ++hr) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int p = (row0 + hr) * kBoxCols + a_pixel + dx;
        const uint32_t pixel = box + p * kPixelBytes;
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          ldmatrix_x4(pixel + (((2 * kk + a_chunk) ^ (p & 7)) << 4), a[kk]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (hr < 3) {
            wgmma_m64n64k16(acc[0], a[kk], desc0 + (((hr * 3 + dx) * kTapBytes + kk * 32) >> 4));
          }
          if (hr > 0) {
            wgmma_m64n64k16(acc[1], a[kk],
                            desc0 + ((((hr - 1) * 3 + dx) * kTapBytes + kk * 32) >> 4));
          }
        }
        wgmma_commit();
        wgmma_wait<1>();
      }
    }
    mbar_arrive(empty_bar(s));  // every fragment of the box is in registers
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }

    // Epilogue: pixel 16*warp + g + 8*hh of rows y0 + row0 + r, channels
    // 16q .. 16q+15.
    const int y = ty * kTileRows + row0;
    const int x = tx * kTileCols + 16 * warp + g;
    uint4 prev[2][2][2];
    if (kMode == kBiasResidual) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (y + r < h && x + 8 * hh < w) {
            const uint4* src = reinterpret_cast<const uint4*>(
                dst + ((static_cast<size_t>(img) * h + y + r) * w + x + 8 * hh) * kC + 16 * q);
            prev[r][hh][0] = src[0];
            prev[r][hh][1] = src[1];
          }
        }
    }
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (y + r >= h || x + 8 * hh >= w) continue;
        float v[16];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) v[2 * i + e] = acc[r][4 * i + 2 * hh + e] + bias_r[2 * i + e];
        if (kMode == kBiasPrelu) {
#pragma unroll
          for (int i = 0; i < 16; ++i) v[i] = v[i] >= 0.0f ? v[i] : alpha_r[i] * v[i];
        } else {
          const uint32_t* pw = reinterpret_cast<const uint32_t*>(prev[r][hh]);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float2 x2 = unpack_bf16(pw[i]);
            v[2 * i] = x2.x + v[2 * i];
            v[2 * i + 1] = x2.y + v[2 * i + 1];
          }
        }
        uint4 out[2];
        uint32_t* po = reinterpret_cast<uint32_t*>(out);
#pragma unroll
        for (int i = 0; i < 8; ++i) po[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
        uint4* o = reinterpret_cast<uint4*>(
            dst + ((static_cast<size_t>(img) * h + y + r) * w + x + 8 * hh) * kC + 16 * q);
        o[0] = out[0];
        o[1] = out[1];
      }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Error codes of this file beside CUDA's (which are positive).
constexpr int kErrNoEncoder = -1;        // the driver entry point was not found
constexpr int kErrEncodeBase = -1000;    // -1000 - CUresult of a refused tensor map
constexpr int kErrDevice = -2;           // device ordinal out of range

std::mutex setup_lock;
EncodeTiled encode_tiled = nullptr;
bool encoder_looked_up = false;
int device_sms[kMaxDevices] = {};  // 0 until the device is set up

// Once per process: the encoder. Once per device: the kernels' shared-memory
// attribute and the SM count, into *sms. Returns 0 or an error code.
int setup_for_current_device(int* sms) {
  std::lock_guard<std::mutex> guard(setup_lock);
  if (!encoder_looked_up) {
    encoder_looked_up = true;
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess && fn != nullptr) {
      encode_tiled = reinterpret_cast<EncodeTiled>(fn);
    } else {
      fprintf(stderr,
              "trunk kernel: cuTensorMapEncodeTiled not found through the CUDA runtime's "
              "driver entry-point query (error %d, result %d)\n",
              static_cast<int>(err), static_cast<int>(found));
    }
  }
  if (encode_tiled == nullptr) return kErrNoEncoder;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return kErrDevice;
  if (device_sms[dev] == 0) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(conv3x3_c64_kernel<kBiasPrelu>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(conv3x3_c64_kernel<kBiasResidual>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    }
    if (err != cudaSuccess) return err;
    device_sms[dev] = count;
  }
  *sms = device_sms[dev];
  return 0;
}

// The TMA map over an (n, h, w, 64) bf16 NHWC tensor, in boxes of
// (64, kBoxCols, kBoxRows, 1) with 128-byte swizzle and zero fill.
int encode_activation_map(CUtensorMap* map, void* base, int n, int h, int w) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kC), static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(kPixelBytes),
                                 static_cast<cuuint64_t>(kPixelBytes) * w,
                                 static_cast<cuuint64_t>(kPixelBytes) * w * h};
  const cuuint32_t box[4] = {kC, kBoxCols, kBoxRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides,
                                  box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase - static_cast<int>(r);
}

struct Geometry {
  int tiles_x, tiles_y, num_tiles, grid;
};

Geometry geometry(int n, int h, int w, int sms) {
  Geometry g;
  g.tiles_x = (w + kTileCols - 1) / kTileCols;
  g.tiles_y = (h + kTileRows - 1) / kTileRows;
  g.num_tiles = g.tiles_x * g.tiles_y * n;
  g.grid = g.num_tiles < sms ? g.num_tiles : sms;
  return g;
}

int launch_conv(int mode, const CUtensorMap& src_map, __nv_bfloat16* dst,
                const __nv_bfloat16* image, const float* bias, const float* alpha, int h,
                int w, const Geometry& g, cudaStream_t stream) {
  if (mode == kBiasPrelu) {
    conv3x3_c64_kernel<kBiasPrelu><<<g.grid, kThreads, kSmemBytes, stream>>>(
        src_map, dst, image, bias, alpha, h, w, g.tiles_x, g.tiles_y, g.num_tiles);
  } else {
    conv3x3_c64_kernel<kBiasResidual><<<g.grid, kThreads, kSmemBytes, stream>>>(
        src_map, dst, image, bias, alpha, h, w, g.tiles_x, g.tiles_y, g.num_tiles);
  }
  return cudaGetLastError();
}

}  // namespace

// Runs num_blocks residual blocks in place on x.
//   x: (n, h, w, 64) bf16 NHWC, the trunk input; holds the output on return.
//   y: scratch of the same shape and type.
//   image: (num_blocks, 2, 9, 64, 64) bf16, the swizzled weight image of
//     ops/kernels/trunk.py: swizzle_trunk_weights.
//   b1, b2, alpha: (num_blocks, 64) f32.
// x, y and image must be 16-byte aligned. Launches 2 * num_blocks kernels on
// `stream` and returns the first error (a CUDA error code, or one of this
// file's negative codes; ssr_error_string names both), or 0.
extern "C" int ssr_trunk_forward(void* x, void* y, const void* image, const void* b1,
                                 const void* b2, const void* alpha, int n, int h, int w,
                                 int num_blocks, void* stream) {
  int sms = 0;
  int err = setup_for_current_device(&sms);
  if (err != 0) return err;
  CUtensorMap x_map, y_map;
  err = encode_activation_map(&x_map, x, n, h, w);
  if (err != 0) return err;
  err = encode_activation_map(&y_map, y, n, h, w);
  if (err != 0) return err;
  const Geometry g = geometry(n, h, w, sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* xb = static_cast<__nv_bfloat16*>(x);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  const __nv_bfloat16* img = static_cast<const __nv_bfloat16*>(image);
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  const float* af = static_cast<const float*>(alpha);
  const size_t conv_elems = kWeightBytes / 2;
  for (int blk = 0; blk < num_blocks; ++blk) {
    err = launch_conv(kBiasPrelu, x_map, yb, img + (2 * blk) * conv_elems, b1f + blk * kC,
                      af + blk * kC, h, w, g, s);
    if (err != 0) return err;
    err = launch_conv(kBiasResidual, y_map, xb, img + (2 * blk + 1) * conv_elems,
                      b2f + blk * kC, nullptr, h, w, g, s);
    if (err != 0) return err;
  }
  return 0;
}

// One conv of a block: mode 0 writes dst = PReLU(conv(src) + bias; alpha),
// mode 1 updates dst += conv(src) + bias in place. image: that conv's 9 x 8 KB
// of the swizzled weight image. Shapes and alignment as ssr_trunk_forward.
extern "C" int ssr_trunk_conv(const void* src, void* dst, const void* image, const void* bias,
                              const void* alpha, int mode, int n, int h, int w, void* stream) {
  int sms = 0;
  int err = setup_for_current_device(&sms);
  if (err != 0) return err;
  CUtensorMap map;
  err = encode_activation_map(&map, const_cast<void*>(src), n, h, w);
  if (err != 0) return err;
  return launch_conv(mode == 0 ? kBiasPrelu : kBiasResidual, map,
                     static_cast<__nv_bfloat16*>(dst), static_cast<const __nv_bfloat16*>(image),
                     static_cast<const float*>(bias), static_cast<const float*>(alpha), h, w,
                     geometry(n, h, w, sms), static_cast<cudaStream_t>(stream));
}

// The trunk kernels' resources, from cudaFuncGetAttributes:
// out = {registers per thread, local (spill) bytes per thread, static shared
// bytes, dynamic shared bytes per launch, threads per block}, for conv 1's
// instantiation if which == 0, conv 2's otherwise. Returns a CUDA error, or 0.
extern "C" int ssr_trunk_attributes(int which, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      which == 0 ? cudaFuncGetAttributes(&a, conv3x3_c64_kernel<kBiasPrelu>)
                 : cudaFuncGetAttributes(&a, conv3x3_c64_kernel<kBiasResidual>);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = kSmemBytes;
  out[4] = kThreads;
  return 0;
}

extern "C" const char* ssr_error_string(int code) {
  static thread_local char message[160];
  if (code == kErrNoEncoder) {
    return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint "
           "(the driver is older than the toolkit?)";
  }
  if (code == kErrDevice) return "device ordinal beyond the trunk kernel's table";
  if (code <= kErrEncodeBase) {
    snprintf(message, sizeof message,
             "cuTensorMapEncodeTiled refused the activation map (CUresult %d)",
             kErrEncodeBase - code);
    return message;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

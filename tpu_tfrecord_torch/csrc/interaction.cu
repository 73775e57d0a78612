// DLRM dot interaction, forward: the packed strict lower triangle of each
// sample's Gram matrix.
//
//   out[b, p] = sum_d E[b, r, d] * E[b, c, d],  p = r(r-1)/2 + c,  0 <= c < r < F
//
// which is the order of np.tril_indices(F, k=-1). E is [B, F, D] (bf16 or
// f32, contiguous); out is [B, P], P = F(F-1)/2, in E's type. Sums are taken
// in f32 and rounded once to the output type.
//
// Replaces tpu_tfrecord/models/interaction.py::dot_interaction_pallas (body
// _interaction_kernel). The TPU kernel gathers through two one-hot [F, P]
// selection matmuls because gathers do not lower to its matrix unit; here
// the rows are indexed in shared memory, so that workaround is not carried
// over.
//
// Two instances. The wrapper (models/interaction.py) picks one by E's type
// and passes the launch geometry that _interaction_plan computes there.
//
// bf16, the DLRM's main path: dot_interaction_mma_kernel.
//   Bound on an H100 SXM: device memory. At (16384, 27, 32) the kernel must
//   read 28.3 MB of E and write 11.5 MB of out: 11.9 us at 3.35 TB/s. The
//   Gram is 0.38 GFLOP, 0.4 us on the tensor cores.
//   A scalar design (one thread per output, a 32-step dot over rows staged in
//   shared memory) is held back by shared memory instead: each output reads
//   both rows again, 90 KB of shared-memory reads per sample. The staging
//   also pays for 2-byte loads with runtime divisions, and the loads do not
//   overlap the compute. This design answers each of those:
//   - Persistent grid, double-buffered: 4 blocks of 4 warps per SM, each
//     walking tiles of `tile` samples (4 at the main shape, ~8 KB of E). It
//     copies a tile's rows with 16-byte cp.async.cg into a padded layout
//     while the previous tile computes. A thread computes the shared-memory
//     offset of its chunk once per tile, not once per sample.
//   - Layout of a staged sample: Fp = ceil16(F) rows of `stride` =
//     ceil16(D) + 8 bf16. The 16 extra bytes per row put the 8 rows that one
//     ldmatrix reads into 8 different 16-byte bank groups: no conflicts.
//     Rows >= F and columns >= D are zeroed once per block and never written
//     again. The column pad enters every sum, so it must be zero.
//   - One warp per sample: mma.sync m16n8k16 (bf16 in, f32 sums), only on
//     the 16x8 tiles of the Gram that touch the strict lower triangle (6 of
//     8 at F=27, 2 k-steps each). A row-major [f][d] tile is both the
//     row-major A and the column-major B, so ldmatrix loads both without
//     .trans. A 16-row strip's A fragments stay in registers across its
//     column tiles: about 5 KB of shared-memory reads per sample at F=27.
//     The k-steps (Dp / 16) are a template parameter, so the loops unroll
//     with no predicates. bf16 x bf16 products are exact in f32; only the
//     order of the sums differs from the plain version.
//   - Epilogue: the accumulator at (r, c), c < r < F, goes to its pair
//     p = r(r-1)/2 + c (no index tables; the row offsets are computed once
//     per strip, two sums are rounded by one bf16x2 convert) in a staging
//     buffer. The tile's outputs are one contiguous span of `out`; it is
//     stored with 16-byte vector stores, and with scalar stores only where
//     the span begins or ends inside a 16-byte chunk.
//   When a row of E is not a multiple of 16 bytes (D % 8 != 0) or E's base
//   is not 16-byte aligned, the same kernel stages with scalar loads into the
//   same layout (kVecLoads = false).
//   What is left to the bound (tpu_tfrecord_torch/interaction_sweep.py
//   times it): each of copy, Gram and store costs a few microseconds that
//   the other two do not hide, because a block runs them one after another
//   between its barriers; a plain copy_ reaches ~2.7 TB/s on the card, not
//   3.35. A 3-stage ring, more or fewer blocks per SM, larger tiles and one
//   barrier per tile with warp-private output staging were each measured
//   and were not faster.
//
// f32: dot_interaction_tiled_kernel.
//   Bound on an H100 SXM: device memory. At (16384, 27, 32) the kernel must
//   read 56.6 MB of E and write 23.0 MB of out: 23.8 us at 3.35 TB/s. The
//   Gram is 0.37 GFLOP of f32 FMAs, 5.5 us at 67 TFLOP/s. TF32 or bf16 tensor
//   cores would round E once and break the f32 tolerance, so the products
//   are f32 FMAs on the CUDA cores, the same products as the plain version's.
//   A one-thread-per-output design reads both rows of every pair from shared
//   memory again (90 KB per sample at (27, 32), twice the byte bound's time
//   in shared-memory traffic alone). This design:
//   - Persistent grid, double-buffered, as the bf16 instance: 3 blocks of 8
//     warps per SM walk tiles of `tile` samples (8 at the main shape,
//     27.6 KB of E), copied with 16-byte cp.async.cg while the previous tile
//     computes. With D % 4 == 0 a sample's rows are contiguous in shared
//     memory too, so chunk j of a sample lands at j * 4: no division.
//   - Layout of a staged sample: Fp = ceil4(F) rows of `stride` =
//     ceil4(D) floats, then kSamplePad floats, so a sample is an odd number
//     of 16-byte chunks. Row and column pads are zeroed once per block.
//   - Register blocking: a thread takes one 4x4 block (4R..4R+3, 4C..4C+3),
//     C <= R, of one sample's Gram: 16 sums in registers, 8 float4 reads of
//     shared memory per 4 columns (29 KB of shared-memory reads per sample
//     at (27, 32), 28 blocks of 8 rows of 128 B). Work items are numbered
//     sample-fastest, so the 8 threads of a quarter-warp read the same row
//     and column of 8 consecutive samples: with the odd sample stride these
//     fall in 8 different bank groups, no conflicts (for tile % 8 == 0).
//     The block comes from the item's number by a triangular root, with no
//     index tables; the pair is p = r(r-1)/2 + c.
//   - Epilogue as the bf16 one: pairs c < r < F go to a staging buffer, the
//     tile's span of `out` leaves in 16-byte stores, scalar only at its ends.
//   Rows that are not whole 16-byte chunks (D % 4 != 0) or an E whose base is
//   not 16-byte aligned are staged with scalar loads into the same layout.
//   What is left to the bound (interaction_sweep.py times it): with the Gram
//   taken out, copy and store alone run near what copy_ reaches on the card
//   for the same bytes; the Gram adds the rest, since a block runs copy,
//   Gram and store one after another between its barriers. 2 and 3 blocks
//   per SM, and tiles of 4 to 24 samples, were measured; none was clearly
//   faster than the plan's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDefaultSmemBytes = 48 * 1024;

// ------------------------------------------------------ bf16, tensor cores

constexpr int kMmaThreads = 128;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMmaMinBlocks = 4;  // models/interaction.py: _MMA_BLOCKS_PER_SM
constexpr int kMaxKSteps = 8;     // Dp <= 128; models/interaction.py: _MMA_MAX_DP
constexpr int kStages = 2;        // tiles of rows in flight; models/interaction.py: _STAGES

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest kStages - 1 groups of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// c += a (16x16, row-major) * b (16x8, column-major), f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy samples [t0, t0 + n_s) of E into `buf` ([tile][Fp][stride]); rows
// < F, columns < D only. With kVecLoads the copies are asynchronous 16-byte
// chunks, the caller commits them as one group.
template <bool kVecLoads>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* buf,
                                           const __nv_bfloat16* __restrict__ emb,
                                           long long t0, int n_s, int F, int D,
                                           int sample, int stride) {
  const int fd = F * D;
  const __nv_bfloat16* src = emb + t0 * fd;
  if (kVecLoads) {
    const int cpr = D / 8;  // 16-byte chunks per row
    for (int j = threadIdx.x; j < F * cpr; j += kMmaThreads) {
      // chunk j of a sample is at j*8 in E and at f*stride + (j - f*cpr)*8
      // in shared memory; consecutive threads read consecutive chunks
      const int f = j / cpr;
      const uint32_t dst = smem_addr(buf + j * 8 + f * (stride - D));
      const __nv_bfloat16* g = src + j * 8;
      for (int s = 0; s < n_s; ++s)
        cp_async_16(dst + s * sample * 2, g + (size_t)s * fd);
    }
  } else {
    for (int j = threadIdx.x; j < fd; j += kMmaThreads) {
      const int off = j + (j / D) * (stride - D);
      for (int s = 0; s < n_s; ++s) buf[s * sample + off] = src[(size_t)s * fd + j];
    }
  }
}

// One warp: the strict lower triangle of one staged sample's Gram into
// stg[p], p = r(r-1)/2 + c. kNks = Dp / 16 k-steps of 16.
template <int kNks>
__device__ __forceinline__ void gram_sample(const __nv_bfloat16* smp,
                                            __nv_bfloat16* stg, int F, int Fp,
                                            int stride, int lane) {
  const uint32_t base = smem_addr(smp);
  const int row_bytes = stride * 2;
  const int g = lane >> 2, t2 = 2 * (lane & 3);  // accumulator row, first column
  // ldmatrix row addresses: A x4 = rows 0-15 at k 0-7, then at k 8-15;
  // B x2 = rows 0-7 at k 0-7, then at k 8-15
  const uint32_t a_lane = (lane & 15) * row_bytes + (lane >> 4) * 16;
  const uint32_t b_lane = (lane & 7) * row_bytes + ((lane >> 3) & 1) * 16;
  for (int mt = 0; mt < Fp / 16; ++mt) {
    // column tiles with some c < r <= r_hi: 8 nt <= r_hi - 1 (r_hi >= 1: F >= 2)
    const int n_nt = (min(16 * mt + 15, F - 1) - 1) / 8 + 1;
    uint32_t a[kNks][4];
    const uint32_t a_addr = base + 16 * mt * row_bytes + a_lane;
#pragma unroll
    for (int ks = 0; ks < kNks; ++ks) ldmatrix_x4(a[ks], a_addr + ks * 32);
    // this lane's accumulator rows r0 (acc 0, 1) and r1 (acc 2, 3); a row
    // past F keeps no pair
    const int r0 = 16 * mt + g, r1 = r0 + 8;
    const int lim0 = r0 < F ? r0 : 0, lim1 = r1 < F ? r1 : 0;  // keep c < lim
    __nv_bfloat16* row0 = stg + r0 * (r0 - 1) / 2;
    __nv_bfloat16* row1 = stg + r1 * (r1 - 1) / 2;
    for (int nt = 0; nt < n_nt; ++nt) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const uint32_t b_addr = base + 8 * nt * row_bytes + b_lane;
#pragma unroll
      for (int ks = 0; ks < kNks; ++ks) {
        uint32_t b[2];
        ldmatrix_x2(b, b_addr + ks * 32);
        mma_bf16(acc, a[ks], b);
      }
      // acc is G[r0][c], G[r0][c+1], G[r1][c], G[r1][c+1]
      const int c = 8 * nt + t2;
      const __nv_bfloat162 v0 = __floats2bfloat162_rn(acc[0], acc[1]);
      const __nv_bfloat162 v1 = __floats2bfloat162_rn(acc[2], acc[3]);
      if (c < lim0) row0[c] = v0.x;
      if (c + 1 < lim0) row0[c + 1] = v0.y;
      if (c < lim1) row1[c] = v1.x;
      if (c + 1 < lim1) row1[c + 1] = v1.y;
    }
  }
}

template <bool kVecLoads, int kNks>
__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks)
dot_interaction_mma_kernel(const __nv_bfloat16* __restrict__ emb,
                           __nv_bfloat16* __restrict__ out, int B, int F, int D,
                           int P, int Fp, int stride, int tile) {
  // [kStages][tile][Fp][stride] staged rows, then [8 + tile * P] staged outputs
  extern __shared__ __align__(16) unsigned char smem[];
  const int sample = Fp * stride;
  const int buf_elems = tile * sample;
  __nv_bfloat16* bufs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* stg = bufs + kStages * buf_elems;
  const int n_tiles = (B + tile - 1) / tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // zero the row buffers once: the row and column pads stay zero
  uint4* z = reinterpret_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < kStages * buf_elems / 8; i += kMmaThreads)
    z[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // tile k of this block is blockIdx.x + k * gridDim.x, staged in buffer
  // k % kStages; kStages - 1 tiles are in flight ahead of the one computed
  auto stage = [&](int k) {
    const int tt = blockIdx.x + k * gridDim.x;
    if (tt < n_tiles)
      stage_tile<kVecLoads>(bufs + (k % kStages) * buf_elems, emb, (long long)tt * tile,
                            min(tile, B - tt * tile), F, D, sample, stride);
    cp_async_commit();  // one group per tile, empty or not
  };
  for (int k = 0; k < kStages - 1; ++k) stage(k);
  for (int k = 0, t = blockIdx.x; t < n_tiles; ++k, t += gridDim.x) {
    // buffer (k - 1) % kStages was last read before the previous tile's
    // second barrier, so tile k + kStages - 1 may be copied into it now
    stage(k + kStages - 1);
    cp_async_wait_oldest();
    __syncthreads();

    const long long e0 = (long long)t * tile * P;  // first output of the tile
    const int phase = (int)(e0 & 7);               // its place in a 16-byte chunk
    const int n_s = min(tile, B - t * tile);
    const __nv_bfloat16* buf = bufs + (k % kStages) * buf_elems;
    for (int s = warp; s < n_s; s += kMmaWarps)
      gram_sample<kNks>(buf + s * sample, stg + phase + s * P, F, Fp, stride, lane);
    __syncthreads();

    // stg[i] belongs at out[e0 - phase + i], phase <= i < phase + n_s * P;
    // both sides are 16-byte aligned at i = 0 (out is a fresh allocation)
    const int n = phase + n_s * P;
    __nv_bfloat16* dst = out + (e0 - phase);
    for (int lo = threadIdx.x * 8; lo < n; lo += kMmaThreads * 8) {
      const int hi = min(lo + 8, n);
      if (lo >= phase && hi - lo == 8) {
        *reinterpret_cast<uint4*>(dst + lo) = *reinterpret_cast<const uint4*>(stg + lo);
      } else {
        for (int i = max(lo, phase); i < hi; ++i) dst[i] = stg[i];
      }
    }
  }
}

using MmaKernel = void (*)(const __nv_bfloat16*, __nv_bfloat16*, int, int, int, int, int,
                           int, int);

template <bool kVecLoads>
MmaKernel mma_kernel(int nks) {
  switch (nks) {
    case 1: return dot_interaction_mma_kernel<kVecLoads, 1>;
    case 2: return dot_interaction_mma_kernel<kVecLoads, 2>;
    case 3: return dot_interaction_mma_kernel<kVecLoads, 3>;
    case 4: return dot_interaction_mma_kernel<kVecLoads, 4>;
    case 5: return dot_interaction_mma_kernel<kVecLoads, 5>;
    case 6: return dot_interaction_mma_kernel<kVecLoads, 6>;
    case 7: return dot_interaction_mma_kernel<kVecLoads, 7>;
    case 8: return dot_interaction_mma_kernel<kVecLoads, 8>;
  }
  return nullptr;
}

// ------------------------------------------------ f32, register-blocked FMAs

constexpr int kTiledThreads = 256;
constexpr int kTiledMinBlocks = 3;  // models/interaction.py: _TILED_BLOCKS_PER_SM
constexpr int kSamplePad = 4;       // floats after a staged sample; models/interaction.py: _TILED_SAMPLE_PAD

// Copy samples [t0, t0 + n_s) of E into `buf` ([tile][sample]: Fp rows of
// `stride` floats, then kSamplePad); rows < F, columns < D only. With
// kVecLoads (D % 4 == 0, so stride == D) the copies are asynchronous 16-byte
// chunks, the caller commits them as one group.
template <bool kVecLoads>
__device__ __forceinline__ void stage_tile_f32(float* buf, const float* __restrict__ emb,
                                               long long t0, int n_s, int F, int D,
                                               int sample, int stride) {
  const int fd = F * D;
  const float* src = emb + t0 * fd;
  if (kVecLoads) {
    // chunk j of a sample is at j*4 on both sides; consecutive threads read
    // consecutive chunks
    for (int j = threadIdx.x; j < fd / 4; j += kTiledThreads) {
      const uint32_t dst = smem_addr(buf + j * 4);
      const float* g = src + j * 4;
      for (int s = 0; s < n_s; ++s) cp_async_16(dst + s * sample * 4, g + (size_t)s * fd);
    }
  } else {
    for (int j = threadIdx.x; j < fd; j += kTiledThreads) {
      const int off = j + (j / D) * (stride - D);
      for (int s = 0; s < n_s; ++s) buf[s * sample + off] = src[(size_t)s * fd + j];
    }
  }
}

// R of the 4x4 block number blk = R(R+1)/2 + C, 0 <= C <= R
__device__ __forceinline__ int block_row(int blk) {
  int r = (int)((sqrtf(8.f * blk + 1.f) - 1.f) * 0.5f);
  if ((r + 1) * (r + 2) / 2 <= blk) ++r;
  if (r * (r + 1) / 2 > blk) --r;
  return r;
}

// One thread: rows 4R..4R+3 against rows 4C..4C+3 of one staged sample,
// f32 FMAs over the padded columns in order; the pairs c < r < F into
// stg[p], p = r(r-1)/2 + c.
__device__ __forceinline__ void gram_block(const float* smp, float* stg, int R, int C, int F,
                                           int stride) {
  const float* a = smp + 4 * R * stride;
  const float* b = smp + 4 * C * stride;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < stride; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = *reinterpret_cast<const float4*>(a + i * stride + d);
      y[i] = *reinterpret_cast<const float4*>(b + i * stride + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * R + i;
    if (r >= F) break;
    float* row = stg + r * (r - 1) / 2;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * C + j < r) row[4 * C + j] = acc[i][j];
  }
}

template <bool kVecLoads>
__global__ void __launch_bounds__(kTiledThreads, kTiledMinBlocks)
dot_interaction_tiled_kernel(const float* __restrict__ emb, float* __restrict__ out, int B,
                             int F, int D, int P, int Fp, int stride, int tile) {
  // [kStages][tile][sample] staged rows, then [4 + tile * P] staged outputs
  extern __shared__ __align__(16) unsigned char smem[];
  const int sample = Fp * stride + kSamplePad;
  const int buf_elems = tile * sample;
  float* bufs = reinterpret_cast<float*>(smem);
  float* stg = bufs + kStages * buf_elems;
  const int n_tiles = (B + tile - 1) / tile;
  const int nb = Fp / 4;
  const int n_items = tile * (nb * (nb + 1) / 2);  // (4x4 block, sample), sample fastest

  // zero the row buffers once: the row and column pads stay zero
  float4* z = reinterpret_cast<float4*>(smem);
  for (int i = threadIdx.x; i < kStages * buf_elems / 4; i += kTiledThreads)
    z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // tile k of this block is blockIdx.x + k * gridDim.x, staged in buffer
  // k % kStages; kStages - 1 tiles are in flight ahead of the one computed
  auto load_tile = [&](int k) {
    const int tt = blockIdx.x + k * gridDim.x;
    if (tt < n_tiles)
      stage_tile_f32<kVecLoads>(bufs + (k % kStages) * buf_elems, emb, (long long)tt * tile,
                                min(tile, B - tt * tile), F, D, sample, stride);
    cp_async_commit();  // one group per tile, empty or not
  };
  for (int k = 0; k < kStages - 1; ++k) load_tile(k);
  for (int k = 0, t = blockIdx.x; t < n_tiles; ++k, t += gridDim.x) {
    // buffer (k - 1) % kStages was last read before the previous tile's
    // second barrier, so tile k + kStages - 1 may be copied into it now
    load_tile(k + kStages - 1);
    cp_async_wait_oldest();
    __syncthreads();

    const long long e0 = (long long)t * tile * P;  // first output of the tile
    const int phase = (int)(e0 & 3);               // its place in a 16-byte chunk
    const int n_s = min(tile, B - t * tile);
    const float* buf = bufs + (k % kStages) * buf_elems;
    for (int it = threadIdx.x; it < n_items; it += kTiledThreads) {
      const int blk = it / tile, s = it - blk * tile;
      if (s >= n_s) continue;
      const int R = block_row(blk);
      gram_block(buf + s * sample, stg + phase + s * P, R, blk - R * (R + 1) / 2, F, stride);
    }
    __syncthreads();

    // stg[i] belongs at out[e0 - phase + i], phase <= i < phase + n_s * P;
    // both sides are 16-byte aligned at i = 0 (out is a fresh allocation)
    const int n = phase + n_s * P;
    float* dst = out + (e0 - phase);
    for (int lo = threadIdx.x * 4; lo < n; lo += kTiledThreads * 4) {
      const int hi = min(lo + 4, n);
      if (lo >= phase && hi - lo == 4) {
        *reinterpret_cast<float4*>(dst + lo) = *reinterpret_cast<const float4*>(stg + lo);
      } else {
        for (int i = max(lo, phase); i < hi; ++i) dst[i] = stg[i];
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= kDefaultSmemBytes) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// The launches below return cudaGetLastError() after the launch (0 on
// success); the caller raises on anything else. The geometry comes from
// models/interaction.py::_interaction_plan.

extern "C" int dot_interaction_bf16(const void* emb, void* out, int B, int F, int D,
                                    int P, int Fp, int Dp, int stride, int tile,
                                    int smem, int grid, int vec_loads, void* stream) {
  if (B < 1 || F < 2 || D < 1 || P != F * (F - 1) / 2 || Fp % 16 || Fp < F || Dp % 16 || Dp < D ||
      Dp > 16 * kMaxKSteps || stride != Dp + 8 || tile < 1 || grid < 1 ||
      (vec_loads && D % 8) ||
      smem < 2 * (kStages * (long long)tile * Fp * stride + 8 + (long long)tile * P))
    return (int)cudaErrorInvalidValue;
  const MmaKernel kernel = vec_loads ? mma_kernel<true>(Dp / 16) : mma_kernel<false>(Dp / 16);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kMmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(emb), static_cast<__nv_bfloat16*>(out), B, F, D, P,
      Fp, stride, tile);
  return (int)cudaGetLastError();
}

extern "C" int dot_interaction_f32(const void* emb, void* out, int B, int F, int D, int P,
                                   int Fp, int Dp, int stride, int tile, int smem, int grid,
                                   int vec_loads, void* stream) {
  if (B < 1 || F < 2 || D < 1 || P != F * (F - 1) / 2 || Fp % 4 || Fp < F || Dp % 4 ||
      Dp < D || stride != Dp || tile < 1 || grid < 1 || (vec_loads && D % 4) ||
      smem < 4 * (kStages * (long long)tile * (Fp * stride + kSamplePad) + 4 + (long long)tile * P))
    return (int)cudaErrorInvalidValue;
  using TiledKernel = void (*)(const float*, float*, int, int, int, int, int, int, int);
  const TiledKernel kernel =
      vec_loads ? dot_interaction_tiled_kernel<true> : dot_interaction_tiled_kernel<false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kTiledThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emb), static_cast<float*>(out), B, F, D, P, Fp, stride, tile);
  return (int)cudaGetLastError();
}

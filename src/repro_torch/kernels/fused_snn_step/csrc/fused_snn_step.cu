// fused_snn_step: one spiking FC layer over all T timesteps in one launch,
// for Hopper (sm_90a).
//
// Replaces `repro/kernels/fused_snn_step/kernel.py::_snn_kernel` (the Pallas
// TPU kernel dispatched by `fused_snn_pallas`). Per timestep t, lane b and
// output column j, with V carried across all T steps from 0:
//   v = clamp(v + sum_k s[t, b, k] * W[k, j])           (AccW2V, int32)
//   LIF: v = clamp(v - leak)                             (AccV2V)
//   fired = SpikeCheck(v, th)
//   RMP: v = clamp(fired ? v - th : v); IF/LIF: v = fired ? reset : v
//   out[t, b, j] = fired
// and the final V is written once. clamp is the 11-bit V word: saturate to
// [-1024, 1023], or wrap (floored modulo 2048); in wrap mode SpikeCheck
// tests wrap(v - th) >= 0. Unlike the fused-network kernel, the IF/LIF
// reset value is a parameter.
//
// Design. AccW2V does not depend on V: acc[t, b, j] is an int8 product over
// all (t, b) rows, known before the scan, exactly as the TPU kernel takes
// `dot` before it clamps. Only the clamp, leak, SpikeCheck and reset chain
// is serial in t, and it is a few integer operations per (t, b, j). So the
// kernel takes the products on the tensor cores, off the serial chain, and
// each thread scans its own V in registers.
//
// - A CTA owns `lanes` (1 to 8) batch lanes by `cols` (1 to 32) output
//   columns for the whole T loop (no grid axis over T, so V never leaves
//   the CTA); one warp per 8 columns. The CTA tile is the kernel's own: it
//   does not change results, so the JAX signature's block_b / block_n only
//   describe the TPU kernel's grid. At the IMDB layer (B = 8, N_out = 128)
//   that is 4 CTAs of 4 warps, one warp per SM scheduler.
// - AccW2V is `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`: exact, int8
//   x int8 into int32. The 16 A rows are two timesteps (t, t + 1) of the 8
//   lanes, K is the fan-in, and B is the transposed W tile (a column's
//   fan-in contiguous, which is the "col" layout). A thread's accumulator
//   fragment then holds lane g = lane / 4 at steps t and t + 1 for columns
//   2 (lane % 4) and 2 (lane % 4) + 1, the same (lane, columns) at every t,
//   so the V scan runs straight from the fragments. `wgmma` was not used:
//   its 64-row tile would put consecutive timesteps in different warps and
//   force V across warps at every step, and at B = 8 it would waste 7/8 of
//   its rows.
// - Spikes are staged by chunk: the lane rows of `tc` timesteps go to
//   shared memory by 16-byte cp.async, double-buffered where shared memory
//   allows, each into a slot of `row_ld` bytes (16 modulo 32, so that an MMA
//   tile's 8 rows hit different banks) at its global offset modulo 16, so
//   an A word at any byte offset is one funnel shift of two aligned shared
//   words. Per chunk, every k-step loads its B fragment once and issues the
//   chunk's tc / 2 independent MMAs; then each thread scans its two columns
//   over the chunk's steps in registers and writes the spikes into a shared
//   output tile, which the CTA stores with 16-byte stores where the rows
//   allow. Two barriers per chunk.
// - Padding. The fan-in pads to the MMA's 32-byte k-step: the last k-step's
//   A bytes past the fan-in are masked to 0, so whatever lies past a W row
//   or a spike row (the neighbouring rows' bytes a 16-byte copy brings
//   along) adds nothing. Lanes pad to the MMA's 8 rows and columns
//   to the warp's 8: a missing lane or column reads lane 0's spikes or the
//   last real column's weights and its results are never stored, and an odd
//   chunk's step t + 1 reads step t again. So block sizes, ragged B and
//   N_out and odd T run through one code path.
//
// The shared-memory layout and the launch plan (lanes, cols, tc and the
// buffers, from the 232,448-byte budget, down to tc = 1 single-buffered)
// are computed by the Python binding and mirrored by `fused_snn_step_plan`
// below, which the binding checks when the library loads.
//
// Bound. One call moves T*B*N_in input bytes, N_in*N_out weight bytes,
// T*B*N_out output bytes and 4*B*N_out bytes of V, and does
// 2*T*B*N_in*N_out int8 operations: at most about
// 2*N_in*N_out/(N_in + N_out) operations per byte (128 at 128 x 128), below
// the H100's int8 ridge (~590), so the function is bound by memory. At the
// shapes its callers use (a few CTAs of 4 warps, T = 120) the kernel is
// bound by latency: each warp issues its chunk's staging, products and
// scan alone on its scheduler.
//
// Signed overflow is undefined in C++ while the reference wraps, so every
// V addition goes through uint32_t; the wrap clamp uses a mask, not C's
// truncating %.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_COLS 32              // columns of a CTA: 4 warps of 8
#define MAX_LANES 8              // lanes of a CTA: the MMA's 8 rows
#define TC_MAX 16                // timesteps of a chunk
#define SMEM_LIMIT 232448        // bytes of shared memory a Hopper block can use
#define SEG_SLACK 48             // bytes the A loads read past the last row

enum { NEURON_IF = 0, NEURON_LIF = 1, NEURON_RMP = 2 };

struct StepArgs {
  const int8_t* spikes;     // (T, B, N_in) {0, 1}
  const int8_t* w;          // (N_in, N_out) row-major
  int8_t* out;              // (T, B, N_out)
  int32_t* v_out;           // (B, N_out)
  int timesteps;
  int batch;
  int n_in;
  int n_out;
  int lanes;                // lanes per CTA (1 .. MAX_LANES)
  int cols;                 // columns per CTA (1 .. MAX_COLS)
  int tc;                   // timesteps per chunk (1 .. TC_MAX)
  int nbuf;                 // chunk buffers (1 or 2)
  int grid_b;               // lane tiles (the grid's minor index)
  int wt_ld;                // W^T row stride in 32-bit words (odd)
  int spk_off;              // smem byte offset of the spike runs
  int seg_ld;               // bytes per staged step (lanes x row_ld)
  int row_ld;               // bytes per staged lane row (16 mod 32)
  int out_off;              // smem byte offset of the output tile
  int out_ld;               // output tile row stride in bytes (16-aligned)
  int neuron;               // NEURON_*
  int wrap;                 // 0 saturate, 1 wrap
  int threshold;
  int leak;
  int reset;
};

__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int sub_wrap(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}

template <int WRAP>
__device__ __forceinline__ int clamp_v(int v) {
  if (WRAP) return (int)(((uint32_t)v + 1024u) & 2047u) - 1024;
  return min(max(v, -1024), 1023);
}

// One step of one neuron: V update from the step's AccW2V sum; returns
// whether it fired.
template <int NEURON, int WRAP>
__device__ __forceinline__ bool neuron_step(int& v, int acc, int th, int leak,
                                            int reset) {
  int vv = clamp_v<WRAP>(add_wrap(v, acc));
  if (NEURON == NEURON_LIF) vv = clamp_v<WRAP>(sub_wrap(vv, leak));
  const bool fired = WRAP ? clamp_v<1>(sub_wrap(vv, th)) >= 0 : vv >= th;
  if (fired) vv = NEURON == NEURON_RMP ? clamp_v<WRAP>(sub_wrap(vv, th)) : reset;
  v = vv;
  return fired;
}

// The low n bytes of a word set (n clipped to [0, 4]).
__device__ __forceinline__ uint32_t byte_mask(int n) {
  return n >= 4 ? 0xffffffffu : n <= 0 ? 0u : (1u << (8 * n)) - 1u;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Global address of the spikes of lane b at step t.
__device__ __forceinline__ const int8_t* spike_row(const StepArgs& a, int t,
                                                   int b) {
  return a.spikes + ((size_t)t * a.batch + b) * a.n_in;
}

// Walks the flat index ((s * nb) + b) * width + x of a (len, nb, width)
// grid from threadIdx.x in steps of blockDim.x, with no division a step:
// (s, b, x) advance by a precomputed (ds, db, dx) with carries.
struct GridWalk {
  int s, b, x, ds, db, dx, nb, width;
  __device__ GridWalk(int nb_, int width_) : nb(nb_), width(width_) {
    const int r = threadIdx.x / width, dr = blockDim.x / width;
    x = threadIdx.x - r * width;
    dx = blockDim.x - dr * width;
    s = r / nb;
    b = r - s * nb;
    ds = dr / nb;
    db = dr - ds * nb;
  }
  __device__ void next() {
    x += dx;
    int carry = 0;
    if (x >= width) { x -= width; carry = 1; }
    b += db + carry;
    s += ds;
    if (b >= nb) { b -= nb; ++s; }
  }
};

// Issue the copies of chunk c into its buffer: lane b's row of step s goes
// to byte s * seg_ld + b * row_ld of the buffer plus its global offset
// modulo 16, the threads over all (row, aligned 16-byte block) pairs of the
// chunk. A block is one cp.async, also where it holds bytes of the neighbouring
// rows: they land in this row's slot (row_ld >= N_in + 31) and are masked
// where they are read. Only a block that leaves the raster itself (its
// first or last row) goes by plain loads of the row's bytes.
__device__ void stage_chunk(const StepArgs& a, unsigned char* smem, int c,
                            int b0, int nb) {
  const int t0 = c * a.tc, len = min(a.tc, a.timesteps - t0);
  unsigned char* buf = smem + a.spk_off + (c % a.nbuf) * a.tc * a.seg_ld;
  const uintptr_t lo = (uintptr_t)a.spikes;
  const uintptr_t hi = lo + (size_t)a.timesteps * a.batch * a.n_in;
  const int blocks = (a.n_in + 15) / 16 + 1;       // blocks a row can touch
  for (GridWalk w(nb, blocks); w.s < len; w.next()) {
    const int s = w.s, b = w.b, i = w.x;
    const uintptr_t g0 = (uintptr_t)spike_row(a, t0 + s, b0 + b);
    const uintptr_t g1 = g0 + a.n_in;
    const uintptr_t blk = (g0 & ~(uintptr_t)15) + 16 * (uintptr_t)i;
    if (blk >= g1) continue;
    unsigned char* dst = buf + s * a.seg_ld + b * a.row_ld + 16 * i;
    if (blk >= lo && blk + 16 <= hi) {
      cp_async16(dst, (const void*)blk);
    } else {
      for (int j = 0; j < 16; ++j)
        if (blk + j >= g0 && blk + j < g1)
          dst[j] = *reinterpret_cast<const unsigned char*>(blk + j);
    }
  }
  cp_async_commit();
}

// Asking for one resident CTA an SM (the callers' shapes run a few CTAs)
// lets ptxas keep a chunk's accumulators and A offsets in registers (about
// 165, still three CTAs an SM) where it spilled at 128.
template <int NEURON, int WRAP>
__global__ void __launch_bounds__(32 * MAX_COLS / 8, 1)
fused_snn_step_kernel(const StepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;           // MMA group and quad index
  const int b0 = (blockIdx.x % a.grid_b) * a.lanes;
  const int j0 = (blockIdx.x / a.grid_b) * a.cols;
  const int nb = min(a.lanes, a.batch - b0);      // real lanes of the tile
  const int ncols = min(a.cols, a.n_out - j0);    // real columns of the tile
  const int ldb = a.wt_ld * 4;
  const int ksteps = (a.n_in + 31) >> 5;
  unsigned char* out_tile = smem + a.out_off;

  const int n_chunks = (a.timesteps + a.tc - 1) / a.tc;
  for (int c = 0; c < min(a.nbuf, n_chunks); ++c) stage_chunk(a, smem, c, b0, nb);

  // the W column tile, transposed: byte k of W^T row jj is W[k, j0 + jj],
  // 0 past the fan-in; lane jj of a warp reads column jj (ncols <= 32) of
  // 8 fan-in rows before it stores them, so that 8 loads are in flight
  const int nwarps = blockDim.x >> 5;
  for (int k0 = warp; k0 < ldb; k0 += 8 * nwarps) {
    int8_t x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = k0 + u * nwarps;
      x[u] = (lane < ncols && k < a.n_in)
                 ? a.w[(size_t)k * a.n_out + j0 + lane] : (int8_t)0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (lane < ncols && k0 + u * nwarps < ldb)
        smem[lane * ldb + k0 + u * nwarps] = x[u];
  }

  // this thread's MMA rows and columns: lane gl's spikes (lane 0 for a
  // missing lane) and the weights of column jb (the last real column for a
  // missing one); its results are lane g, columns jc and jc + 1
  const int gl = g < nb ? g : 0;
  const int jb = min(warp * 8 + g, ncols - 1);
  const int jc = warp * 8 + 2 * q;
  const uint32_t* wrow = reinterpret_cast<const uint32_t*>(smem + jb * ldb);
  const int klast = (ksteps - 1) * 32;
  const uint32_t mlo = byte_mask(a.n_in - (klast + 4 * q));
  const uint32_t mhi = byte_mask(a.n_in - (klast + 16 + 4 * q));
  const int th = a.threshold, leak = a.leak, reset = a.reset;
  unsigned char* optr = out_tile + g * a.out_ld + jc;   // lane g's out bytes
  const int ostride = a.lanes * a.out_ld;               // a step of the tile
  int v0 = 0, v1 = 0;

  for (int c = 0; c < n_chunks; ++c) {
    if (a.nbuf == 2 && c + 1 < n_chunks) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    const int t0 = c * a.tc, len = min(a.tc, a.timesteps - t0);
    const int buf = a.spk_off + (c % a.nbuf) * a.tc * a.seg_ld;

    // AccW2V of the whole chunk: pair p is steps 2p (rows 0-7) and 2p + 1
    // (rows 8-15); steps past the chunk's end read its last step again, so
    // all TC_MAX / 2 products issue without a branch. This thread's A bytes
    // at step s start at 32-bit word wb[s] of shared memory, shifted by
    // sh[s] bits.
    int acc[TC_MAX / 2][4];
    int wb[TC_MAX];
    unsigned sh[TC_MAX];
#pragma unroll
    for (int s = 0; s < TC_MAX; ++s) {
      const int ss = s < len ? s : len - 1;
      const uintptr_t g0 = (uintptr_t)spike_row(a, t0 + ss, b0 + gl);
      const int off = buf + ss * a.seg_ld + gl * a.row_ld + (int)(g0 & 15) + 4 * q;
      wb[s] = off >> 2;
      sh[s] = (unsigned)(off & 3) * 8u;
    }
#pragma unroll
    for (int p = 0; p < TC_MAX / 2; ++p)
      acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0;
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(smem);
    for (int ks = 0; ks < ksteps; ++ks) {
      const uint32_t b_lo = wrow[ks * 8 + q], b_hi = wrow[ks * 8 + 4 + q];
      const uint32_t m_lo = ks == ksteps - 1 ? mlo : 0xffffffffu;
      const uint32_t m_hi = ks == ksteps - 1 ? mhi : 0xffffffffu;
#pragma unroll
      for (int p = 0; p < TC_MAX / 2; ++p) {
        const uint32_t* r0 = sw + wb[2 * p] + ks * 8;
        const uint32_t* r1 = sw + wb[2 * p + 1] + ks * 8;
        const unsigned s0 = sh[2 * p], s1 = sh[2 * p + 1];
        mma_s8(acc[p], __funnelshift_r(r0[0], r0[1], s0) & m_lo,
               __funnelshift_r(r1[0], r1[1], s1) & m_lo,
               __funnelshift_r(r0[4], r0[5], s0) & m_hi,
               __funnelshift_r(r1[4], r1[5], s1) & m_hi, b_lo, b_hi);
      }
    }

    // the V scan over the chunk, in registers; both columns' spikes into
    // the out tile as one 16-bit store a step (the tile's rows are padded,
    // so a missing column lands in the padding and is never stored)
#pragma unroll
    for (int s = 0; s < TC_MAX; ++s) {
      if (s >= len) break;
      const int c0 = acc[s >> 1][(s & 1) * 2], c1 = acc[s >> 1][(s & 1) * 2 + 1];
      const bool f0 = neuron_step<NEURON, WRAP>(v0, c0, th, leak, reset);
      const bool f1 = neuron_step<NEURON, WRAP>(v1, c1, th, leak, reset);
      if (g < nb)
        *reinterpret_cast<uint16_t*>(optr + s * ostride) =
            (uint16_t)(f0 | (f1 << 8));
    }
    __syncthreads();

    // the chunk's spikes out: one run of ncols bytes per (step, lane)
    const bool vec = (ncols & 15) == 0 && (a.n_out & 15) == 0 &&
                     (j0 & 15) == 0 && ((uintptr_t)a.out & 15) == 0;
    const int piece = vec ? 16 : 1;
    for (GridWalk w(nb, ncols / piece); w.s < len; w.next()) {
      const int s = w.s, b = w.b, x = w.x * piece;
      const unsigned char* src = out_tile + (s * a.lanes + b) * a.out_ld + x;
      int8_t* dst = a.out + ((size_t)(t0 + s) * a.batch + b0 + b) * a.n_out +
                    j0 + x;
      if (vec) *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
      else *dst = (int8_t)*src;
    }
    if (c + a.nbuf < n_chunks) stage_chunk(a, smem, c + a.nbuf, b0, nb);
  }

  if (g < nb) {
    int32_t* vo = a.v_out + (size_t)(b0 + g) * a.n_out + j0 + jc;
    if (jc < ncols) vo[0] = v0;
    if (jc + 1 < ncols) vo[1] = v1;
  }
}

namespace {

int align16(int n) { return (n + 15) / 16 * 16; }

int odd_words(int n_bytes) { return ((n_bytes + 3) / 4) | 1; }

// A staged lane row: the fan-in and its two ragged 16-byte blocks (N_in +
// 31), rounded up to 16 modulo 32 bytes, so that 8 rows' words fall in
// different banks. The A loads of a row read up to 18 bytes into the next
// one (masked to 0).
int row_ld_of(int n_in) { return (n_in + 46) / 32 * 32 + 16; }

// Shared-memory bytes of a CTA of `lanes` x `cols` with `tc` steps a chunk
// in `nbuf` buffers; the offsets the kernel needs, when asked for.
long long smem_bytes(int n_in, int cols, int lanes, int tc, int nbuf,
                     StepArgs* a) {
  const int ld = odd_words(n_in);
  const long long spk_off = align16(cols * ld * 4);
  const long long seg_ld = (long long)lanes * row_ld_of(n_in);
  const long long out_off = spk_off + (long long)nbuf * tc * seg_ld + SEG_SLACK;
  const int out_ld = align16(cols);
  if (a) {
    a->wt_ld = ld;
    a->spk_off = (int)spk_off;
    a->seg_ld = (int)seg_ld;
    a->row_ld = row_ld_of(n_in);
    a->out_off = (int)out_off;
    a->out_ld = out_ld;
  }
  return out_off + align16(tc * lanes * out_ld);
}

// The launch plan: the widest column tile (32, 16, 8, then fewer) at
// min(B, 8) lanes, then fewer lanes at one column; for each, the longest
// chunk (16, 8, 4, 2, 1 steps, at most T), double-buffered before single.
// Fills lanes, cols, tc, nbuf and the layout; returns the shared-memory
// bytes, or -1 when nothing fits.
long long plan(int T, int B, int n_in, int n_out, StepArgs* a) {
  const int lanes0 = min(B, MAX_LANES);
  int cands[16][2], n = 0;
  const int widths[6] = {32, 16, 8, 4, 2, 1};
  for (int i = 0; i < 6; ++i) {
    const int c = min(n_out, widths[i]);
    if (n == 0 || cands[n - 1][1] != c) { cands[n][0] = lanes0; cands[n][1] = c; ++n; }
  }
  for (int l = lanes0 - 1; l >= 1; --l) { cands[n][0] = l; cands[n][1] = 1; ++n; }
  const int chunks[5] = {16, 8, 4, 2, 1};
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < 5; ++j) {
      const int tc = min(chunks[j], T);
      if (j > 0 && tc == min(chunks[j - 1], T)) continue;
      for (int nbuf = 2; nbuf >= 1; --nbuf) {
        if (nbuf == 2 && tc >= T) continue;        // one chunk: one buffer
        const long long bytes = smem_bytes(n_in, cands[i][1], cands[i][0],
                                           tc, nbuf, nullptr);
        if (bytes <= SMEM_LIMIT) {
          a->lanes = cands[i][0];
          a->cols = cands[i][1];
          a->tc = tc;
          a->nbuf = nbuf;
          return smem_bytes(n_in, a->cols, a->lanes, tc, nbuf, a);
        }
      }
    }
  }
  return -1;
}

template <int NEURON, int WRAP>
cudaError_t launch(const StepArgs& a, int grid, int threads, int smem,
                   cudaStream_t stream) {
  auto kernel = fused_snn_step_kernel<NEURON, WRAP>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_snn_step_args_size() { return (int)sizeof(StepArgs); }

const char* fused_snn_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The launch plan of a (T, B, N_in, N_out) layer: out[0..4] = lanes, cols,
// tc, nbuf, shared-memory bytes. Returns 0, or cudaErrorInvalidValue when
// no plan fits a Hopper block's shared memory.
int fused_snn_step_plan(int T, int B, int n_in, int n_out, int* out) {
  StepArgs a = {};
  const long long bytes = plan(T, B, n_in, n_out, &a);
  if (bytes < 0) return (int)cudaErrorInvalidValue;
  out[0] = a.lanes;
  out[1] = a.cols;
  out[2] = a.tc;
  out[3] = a.nbuf;
  out[4] = (int)bytes;
  return 0;
}

// Launch the kernel for `args` (plan fields filled by the caller, who
// checked them against `fused_snn_step_plan`) on `stream` with
// `smem_bytes` of dynamic shared memory. Returns the CUDA error code of
// the launch.
int fused_snn_step_launch(const StepArgs* args, int smem_bytes, void* stream) {
  const StepArgs& a = *args;
  const long long grid = (long long)a.grid_b * ((a.n_out + a.cols - 1) / a.cols);
  if (grid < 1 || grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int threads = 32 * ((a.cols + 7) / 8);
  cudaStream_t st = (cudaStream_t)stream;
  const int g = (int)grid;
  if (a.wrap) {
    if (a.neuron == NEURON_IF) return (int)launch<NEURON_IF, 1>(a, g, threads, smem_bytes, st);
    if (a.neuron == NEURON_LIF) return (int)launch<NEURON_LIF, 1>(a, g, threads, smem_bytes, st);
    if (a.neuron == NEURON_RMP) return (int)launch<NEURON_RMP, 1>(a, g, threads, smem_bytes, st);
  } else {
    if (a.neuron == NEURON_IF) return (int)launch<NEURON_IF, 0>(a, g, threads, smem_bytes, st);
    if (a.neuron == NEURON_LIF) return (int)launch<NEURON_LIF, 0>(a, g, threads, smem_bytes, st);
    if (a.neuron == NEURON_RMP) return (int)launch<NEURON_RMP, 0>(a, g, threads, smem_bytes, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

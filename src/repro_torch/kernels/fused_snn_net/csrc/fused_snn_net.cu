// fused_snn_net: the whole integer SNN fc stack over T timesteps in one
// launch, for Hopper (sm_90a), in three modes, one __global__ kernel each.
//
// Replaces `repro/kernels/fused_snn_net/kernel.py::_net_kernel` (the Pallas
// TPU kernel dispatched by `fused_snn_net_pallas`):
//   fused_snn_net_kernel  -- dense mode (`accumulate`, kernel.py:289-293);
//   fused_snn_net_gated   -- row-block gated mode (`sparse=True`,
//                            kernel.py:294-317);
//   fused_snn_net_events  -- event-list mode (`events=True`,
//                            `accumulate_events`, kernel.py:222-274).
// All three compute the same function. Per timestep t and per layer i:
//   acc = sum_k s[b, k] * W_i[k, j]          (AccW2V, int32)
//   spiking layer: v = clamp(v + acc); LIF: v = clamp(v - leak);
//                  fired = SpikeCheck(v, th);
//                  RMP: v = clamp(fired ? v - th : v), IF/LIF: v = fired ? 0 : v;
//                  the fired vector is the next layer's input
//   readout layer: v += acc, unclamped
// clamp is the 11-bit V word: saturate to [-1024, 1023], or wrap (floored
// modulo 2048). In wrap mode SpikeCheck tests wrap(v - th) >= 0.
//
// Dense mode (`dense_body`, 256 threads). AccW2V does not depend on V: a
// layer's products for a chunk of `tc` timesteps are known once its input
// spikes for the chunk are, so they go onto the int8 tensor cores before
// the V scan, and only the clamp / leak / SpikeCheck / reset chain stays
// serial in t, a few integer operations per (t, lane, column). A CTA owns
// its own tile of `lanes` batch lanes (a multiple of 8, or 4, 2 or 1 where
// 8 do not fit; `dense_plan.h` picks it and `tc` from (widths, T, B),
// spreading the lane groups over at most 132 CTAs; block_b does not change
// results and does not tile this mode) for the whole T loop, so V never
// leaves the CTA. Per chunk the
// input frames are staged by 16-byte cp.async (a row of 100 or 686 bytes
// in a slot of 16 mod 32 bytes at its global offset modulo 16) and, once
// landed, moved to the start of their slots in place, so every layer
// reads aligned rows; then the layers run in turn, one barrier after each:
//   (a) AccW2V of every (t, lane) row of the chunk with
//       `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` (exact): 16 A rows
//       are steps (t, t + 1) of 8 lanes, loaded by `ldmatrix.x4`; B is the
//       layer's W^T in shared memory, its bytes past the fan-in masked in
//       the last k-step; the warps take the layer's (lane group, 16-column)
//       units, each A fragment serving two 8-column tiles;
//   (b) a thread's accumulator fragments hold one lane and the same
//       columns at every step of the chunk, so it scans its V in registers
//       with no shuffle; V enters from the carried state and leaves to V
//       out once, through the layer's V tile between chunks;
//   (c) the fired bits go, int8, into the layer's spike chunk (rows of 16
//       mod 32 bytes), the next layer's A operand: spikes never touch
//       device memory;
//   (d) with rasters on, the previous layer's spike chunk is stored after
//       the next layer's units, 16 bytes a store.
// The readout adds its products into V unclamped: summed over the chunk
// they are the products of its input's spike counts over the chunk, which
// the last spiking layer leaves in a counts tile, so the readout takes one
// MMA step. The next chunk's frames are staged after the
// first layer's barrier, behind the other layers. Missing lanes of a
// ragged tile and missing columns compute junk that nothing stores; an
// odd chunk's last pair reads its last step twice. `wgmma` is not used:
// its 64-row tile would spread consecutive timesteps over warps and force
// V across warps at every step.
//
// Gated mode (`net_body<MODE_GATED>`). One CTA of 256 threads owns a tile
// of `block_b` batch lanes for the whole T loop (no grid axis over T, as
// the TPU kernel's fori_loop keeps V resident). Every layer's weights sit
// in shared memory at their logical widths, transposed so that a thread
// reads 4 fan-in rows of its output column as one 32-bit word and issues
// __dp4a against 4 packed spikes; row strides are an odd number of words,
// so a warp's 32 columns hit 32 different banks. Every layer's V tile and
// the two ping-pong spike buffers also sit in shared memory, so membrane
// potentials and inter-layer spikes never touch device memory: device
// memory sees the input raster, the weights once per CTA, V in (when
// streaming) and out, the rasters when asked for, and the gate counters
// once per CTA at the end. The shared-memory layout (offsets, strides,
// total bytes) is computed and checked once, by the Python binding, and
// passed in `NetArgs`.
//
// Gated mode. A layer's fan-in splits into blocks of `gate_bw` rows (128/G
// for G in {2, 4, 8}, the macro's 128-row fan-in cut in G; the whole layer
// at G = 1). Block starts are multiples of 4 rows at every G, so a block is
// a run of 32-bit words of the transposed weights and of the spike rows, and
// no block crosses a 128-row (32-word) segment. Per (t, layer) every warp
// computes the same occupancy masks from the spike buffer, which the barrier
// before the layer has already published: lane q ORs word q of the tile's
// block_b lanes (bytes past the fan-in masked off), a __ballot_sync gathers
// the 32 words of a segment, and a fold and a multiply spread each nonzero
// word over its block. The first segment's mask stays in registers; the
// others (fan-in above 128) go to the warp's own words of shared memory,
// behind a __syncwarp only: no CTA-wide barrier, no atomics. Each (lane,
// column) thread then runs __dp4a over the runs of occupied words only,
// four independent words at a time (the masks are CTA-uniform, so nothing
// diverges; when every block of the layer is occupied, as on most iid
// frames, it runs the dense loop itself), adds the sum into V once,
// unclamped, and the one clamp follows, exactly the dense
// clamp-after-accumulate; integer addition commutes, so this equals adding
// each occupied block's partial in turn. A thread of the last warps owns
// each block and adds its skip to shared column skip_off[i] + g when the
// block is silent, written to the CTA's own row of the skip output at the
// end.
//
// Event-list mode (its own body, `events_body`, and a block of 1,024
// threads). The inputs of a layer over a chunk of `tc` timesteps (a whole
// K = 10 megastep where shared memory allows, down to one step) are known
// before its V scan, so the chunk runs layer by layer, each layer in two
// passes with one barrier after each. Pass 1 compacts every (t, lane) row of
// the chunk into an ascending active-row list, warps in parallel over rows
// (one __ballot_sync per byte position of 32 spike words), and from the
// same words adds the per-row event counts and each step's tile total
// (shared atomics). Pass 2 gives each (lane, column) thread its sums over
// the chunk's steps, each gathered from its lane's list (8 entries a
// 16-byte load) or, for a step whose tile total is above the layer's
// `dense_thr` (strict >), the dense __dp4a sum with one fallback counted,
// and scans its V over the steps, writing the spikes into the other chunk
// buffer, the next layer's input. The input frames of a chunk are staged
// with 16-byte loads. Per-row and fallback counts add up in shared memory
// and are written once at the end. The gather reads single bytes of the
// transposed weights (consecutive columns sit an odd number of words apart,
// so a warp's reads hit 32 banks); no second, untransposed copy is kept.
//
// In the gated and event-list modes the ragged tile's missing lanes
// (b >= nb) count as silent in every occupancy test, count and list (the
// TPU kernel's `mask_pad`); the dense mode leaves their junk spikes, which
// no output reads.
//
// Bound. One call moves T*B*N0 input bytes, sum N_i*N_{i+1} weight bytes,
// 4*B*sum N_{i+1} bytes of V out (and in, with v_init) and T*B*sum N_i
// raster bytes, and does 2*T*B*sum N_i*N_{i+1} int8 operations (the gated
// and event modes fewer, in proportion to the occupied blocks or events).
// At IMDB widths (100-128-128-1, T = 10) that is 100 to 200 operations per
// byte, below the H100's ridge of 1,979 int8 TOP/s over 3.35 TB/s (~590
// operations per byte), so the function is bound by memory. The dense
// mode is bound by latency inside its few CTAs: per (chunk, layer) its
// products wait on `ldmatrix` traffic from shared memory (every warp loads
// the chunk's A rows for its own columns) and its V scans on instruction
// issue (about ten instructions per neuron and step), with a barrier
// between layers; a one-chunk launch at serving batch sizes also waits on
// its weights' loads and on the first fetch of each code region. The
// gated mode is bound by the latency of its serial T x L loop: one barrier
// per layer-step and the chain of shared-memory loads into __dp4a of each
// (lane, column) thread, plus one mask pass a layer-step, less the words
// of silent blocks. The event-list mode takes two barriers per (chunk,
// layer) and is bound by issuing its gathers, about four instructions per
// event and column. TMA and persistent CTAs are not used.
//
// Signed overflow is undefined in C++ while the reference wraps, so every
// V addition goes through uint32_t. The wrap clamp uses a mask, not C's
// truncating %. Integer addition commutes, so the gathered and the gated
// sums equal the dense sum exactly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_plan.h"

#define MAX_LAYERS 16
#define THREADS 256                     // the gated kernel's block
#define EVENT_THREADS 1024              // the event-list kernel's block
#define DENSE_THREADS 256               // the dense kernel's block
#define DENSE_WARPS (DENSE_THREADS / 32)

enum { NEURON_IF = 0, NEURON_LIF = 1, NEURON_RMP = 2 };
enum { MODE_DENSE = 0, MODE_GATED = 1, MODE_EVENTS = 2 };

struct NetArgs {
  const int8_t* spikes;                 // (T, B, N0) {0, 1}
  const int8_t* w[MAX_LAYERS];          // (N_i, N_{i+1}) row-major
  const int32_t* v_init[MAX_LAYERS];    // (B, N_{i+1}), null without v_init
  int32_t* v_out[MAX_LAYERS];           // (B, N_{i+1})
  int8_t* raster[MAX_LAYERS];           // (T, B, N_{i+1}) spiking layers, or null
  int width[MAX_LAYERS + 1];            // logical widths N_0 .. N_L
  int threshold[MAX_LAYERS];            // spiking layers
  int leak[MAX_LAYERS];
  int wt_off[MAX_LAYERS];               // smem byte offset of layer i's W^T
  int wt_ld[MAX_LAYERS];                // W^T row stride in 32-bit words (odd)
  int v_off[MAX_LAYERS];                // smem byte offset of layer i's V tile
  int spk_off[2];                       // smem byte offsets of the spike buffers
  int spk_ld;                           // spike row stride in 32-bit words (odd)
  int n_layers;
  int n_spiking;                        // n_layers - 1 with a readout, else n_layers
  int timesteps;
  int batch;
  int block_b;
  int neuron;                           // NEURON_*
  int wrap;                             // 0 saturate, 1 wrap
  int emit_rasters;
  int has_v_init;
  // gated and event-list modes
  int cnt_off;                          // smem byte offset of the int32 counters
  int n_counters;                       // int32 counters in shared memory
  // gated mode: skip counters are columns 0 .. n_skip_cols - 1
  int gate_bw;                          // fan-in rows per gate block
  int skip_off[MAX_LAYERS];             // column of layer i's first block
  int n_skip_cols;
  int gate_off;                         // smem byte offset of the warps' masks
  int gate_ld;                          // mask words per warp (128-row segments)
  int32_t* skips;                       // (B / block_b tiles, n_skip_cols)
  // event-list mode: row counters of layer i at counter row_off[i], then
  // one fallback counter per layer at fb_off
  int row_off[MAX_LAYERS];
  int fb_off;
  int dense_thr[MAX_LAYERS];            // dense fallback when events > this
  int list_off;                         // smem byte offset of the active lists
  int list_ld;                          // uint16 entries per (t, lane) list (x 8)
  int lcount_off;                       // smem byte offset of the list lengths
  int32_t* row_counts[MAX_LAYERS];      // (tiles, N_i)
  int32_t* fallbacks;                   // (tiles, n_layers)
  int tc;                               // timesteps per chunk
  int chunk_off[2];                     // smem byte offsets of the chunk buffers
  int chunk_ld;                         // bytes per timestep in a chunk buffer
  int ttot_off;                         // smem byte offset of the per-t totals
  // dense mode (`dense_plan.h`): block_b is the plan's lanes and tc its
  // chunk; wt_off, wt_ld and v_off place its W^T and its V tiles
  int in_off;                           // smem byte offset of the input chunk
  int in_ld;                            // bytes per staged input row
  int out_off[2];                       // smem byte offsets of the spike chunks
  int out_ld[2];                        // bytes per row of each spike chunk
  int counts_off;                       // smem byte offset of the counts
  int counts_ld;                        // bytes per row of the counts
};

__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int sub_wrap(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ int clamp_v(int v, int wrap) {
  if (wrap) return (int)(((uint32_t)v + 1024u) & 2047u) - 1024;
  return min(max(v, -1024), 1023);
}

// Gated mode: bit q of a segment's mask set for every word of a gate block
// of `bwq` words (4, 8 or 16) that holds a nonzero word of `m`. Blocks are
// aligned to their size within the segment, so a fold to the block's first
// bit and a multiply by the block's ones fill each one without carries.
__device__ __forceinline__ unsigned spread_blocks(unsigned m, int bwq) {
  unsigned x = m | (m >> 1);
  x |= x >> 2;                                  // bit 4k: OR of bits 4k..4k+3
  unsigned first = 0x11111111u;
  if (bwq >= 8) { x |= x >> 4; first = 0x01010101u; }
  if (bwq >= 16) { x |= x >> 8; first = 0x00010001u; }
  return (x & first) * ((1u << bwq) - 1u);
}

// Gated mode, layer i: this warp's occupancy masks of the input buffer
// `in_w`, one word per 128-row segment: the first returned in `m0`, the
// others (fan-in above 128) written to the warp's own words `wm`; then the
// skip counts of the silent blocks, counted by the last warps (the first
// ones carry the readout's few elements). Returns whether every block is
// occupied (warp-uniform, and the same in every warp). Needs no barrier:
// the buffer is already published and `wm` is the warp's own.
__device__ __forceinline__ bool gate_masks(const NetArgs& a, int i,
                                           const int32_t* in_w, unsigned* wm,
                                           unsigned& m0, int32_t* cnt) {
  const int lane = threadIdx.x & 31;
  const int n_in = a.width[i];
  const int n_words = (n_in + 3) >> 2;
  const int bwq = a.gate_bw >> 2;               // words a block; 0 at G = 1
  unsigned any = 0;
  bool full = true;
  for (int s0 = 0; s0 < n_words; s0 += 32) {
    const int q = s0 + lane;
    unsigned word = 0;
    if (q < n_words) {
#pragma unroll 8
      for (int b = 0; b < a.block_b; ++b)
        word |= (unsigned)in_w[b * a.spk_ld + q];
      if (4 * q + 4 > n_in)                     // bytes past the fan-in
        word &= (1u << (8 * (n_in & 3))) - 1u;
    }
    unsigned m = __ballot_sync(0xffffffffu, word != 0);
    any |= m;
    if (bwq) {
      m = spread_blocks(m, bwq);
      if (s0 == 0) m0 = m;
      else if (lane == 0) wm[s0 >> 5] = m;
      const int nw = min(32, n_words - s0);     // words of this segment
      full &= (nw == 32 ? m : m & ((1u << nw) - 1u)) ==
              (nw == 32 ? ~0u : (1u << nw) - 1u);
    }
  }
  if (!bwq) {                                    // G = 1: one block a layer
    full = any != 0;
    m0 = any ? ~0u : 0u;
    for (int s = 1 + lane; s < (n_words + 31) >> 5; s += 32) wm[s] = m0;
  }
  if (n_words > 32) __syncwarp();
  const int n_blocks = bwq ? (n_words + bwq - 1) / bwq : 1;
  for (int g = THREADS - 1 - threadIdx.x; g < n_blocks; g += THREADS) {
    const int q0 = g * bwq;
    const unsigned m = q0 < 32 ? m0 : wm[q0 >> 5];
    if (!((m >> (q0 & 31)) & 1u)) cnt[a.skip_off[i] + g] += 1;
  }
  return full;
}

// Gated mode: the AccW2V sum of one (lane, column) over the runs of
// occupied words in the masks (`m0`, then `wm`).
__device__ __forceinline__ int gated_dot(const int32_t* srow,
                                         const int32_t* wrow, unsigned m0,
                                         const unsigned* wm, int n_words) {
  int acc = 0;
  for (int s0 = 0; s0 < n_words; s0 += 32) {
    unsigned m = s0 == 0 ? m0 : wm[s0 >> 5];
    while (m) {
      const int lo = __ffs(m) - 1;              // a run of set bits from lo
      const unsigned rest = ~(m >> lo);
      const int hi = rest ? lo + __ffs(rest) - 1 : 32;
      const int q1 = min(s0 + hi, n_words);
      int q = s0 + lo;
      for (; q + 4 <= q1; q += 4) {               // blocks are >= 4 words
        const int s_0 = srow[q], s_1 = srow[q + 1], s_2 = srow[q + 2],
                  s_3 = srow[q + 3];
        const int w_0 = wrow[q], w_1 = wrow[q + 1], w_2 = wrow[q + 2],
                  w_3 = wrow[q + 3];
        acc = __dp4a(s_0, w_0, acc);
        acc = __dp4a(s_1, w_1, acc);
        acc = __dp4a(s_2, w_2, acc);
        acc = __dp4a(s_3, w_3, acc);
      }
      for (; q < q1; ++q) acc = __dp4a(srow[q], wrow[q], acc);
      m = hi == 32 ? 0u : m & ~((1u << hi) - 1u);
    }
  }
  return acc;
}

// Every layer's V tile, seeded from the carried state or 0.
template <int NT>
__device__ __forceinline__ void init_v(const NetArgs& a, unsigned char* smem,
                                       int b0, int nb) {
  for (int i = 0; i < a.n_layers; ++i) {
    const int n_out = a.width[i + 1];
    int32_t* v = reinterpret_cast<int32_t*>(smem + a.v_off[i]);
    for (int e = threadIdx.x; e < a.block_b * n_out; e += NT) {
      const bool real = e < nb * n_out;
      v[e] = (a.has_v_init && real) ? a.v_init[i][(size_t)b0 * n_out + e] : 0;
    }
  }
}

// Gated mode: every layer's weights into shared memory,
// transposed (byte k of W^T row j is W[k, j]; fan-in padding is 0), and
// every layer's V tile.
__device__ __forceinline__ void stage_weights_and_v(const NetArgs& a,
                                                    unsigned char* smem,
                                                    int b0, int nb) {
  const int tid = threadIdx.x;
  for (int i = 0; i < a.n_layers; ++i) {
    const int n_in = a.width[i], n_out = a.width[i + 1];
    const int row_bytes = a.wt_ld[i] * 4;
    int8_t* wt = reinterpret_cast<int8_t*>(smem + a.wt_off[i]);
    for (int e = tid; e < n_in * n_out; e += THREADS) {
      const int k = e / n_out, j = e - k * n_out;
      wt[j * row_bytes + k] = a.w[i][e];
    }
    const int pad = row_bytes - n_in;
    for (int e = tid; e < n_out * pad; e += THREADS) {
      const int j = e / pad;
      wt[j * row_bytes + n_in + (e - j * pad)] = 0;
    }
  }
  init_v<THREADS>(a, smem, b0, nb);
}

// Every layer's final V tile out, for the tile's real lanes.
template <int NT>
__device__ __forceinline__ void write_v_out(const NetArgs& a,
                                            const unsigned char* smem, int b0,
                                            int nb) {
  for (int i = 0; i < a.n_layers; ++i) {
    const int n_out = a.width[i + 1];
    const int32_t* v = reinterpret_cast<const int32_t*>(smem + a.v_off[i]);
    for (int e = threadIdx.x; e < nb * n_out; e += NT)
      a.v_out[i][(size_t)b0 * n_out + e] = v[e];
  }
}

// Event-list mode: every layer's transposed weights (as
// `stage_weights_and_v`), a warp per fan-in row, its lanes over the row's
// columns: coalesced loads, four in flight a lane.
__device__ __forceinline__ void events_weights(const NetArgs& a,
                                               unsigned char* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = 0; i < a.n_layers; ++i) {
    const int n_in = a.width[i], n_out = a.width[i + 1];
    const int row_bytes = a.wt_ld[i] * 4;
    int8_t* wt = reinterpret_cast<int8_t*>(smem + a.wt_off[i]);
    for (int k = warp; k < row_bytes; k += EVENT_THREADS / 32) {
      const int8_t* src = a.w[i] + (size_t)k * n_out;
      for (int j0 = 0; j0 < n_out; j0 += 128) {
        int8_t x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + 32 * u + lane;
          x[u] = (k < n_in && j < n_out) ? src[j] : (int8_t)0;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + 32 * u + lane;
          if (j < n_out) wt[j * row_bytes + k] = x[u];
        }
      }
    }
  }
}

// Event-list mode, pass 1 of layer i over a chunk of `len` timesteps:
// warps in parallel over the (t, lane) rows of `in` (the chunk buffer),
// one ballot per byte position of 32 spike words. Writes each real lane's
// ascending active-row list and its length, adds each row's events to the
// layer's row counts and each step's total to `ttot` (shared atomics; no
// two lanes of a warp hit one address). Missing lanes count as silent;
// bytes past the fan-in are masked (the buffer holds older bytes there).
__device__ __forceinline__ void events_lists(const NetArgs& a, int i, int len,
                                             int nb, const unsigned char* in,
                                             unsigned short* lists,
                                             int* lcount, int* ttot,
                                             int32_t* cnt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_in = a.width[i];
  const int n_words = (n_in + 3) >> 2;
  const unsigned lt = (1u << lane) - 1u;
  int32_t* rows = cnt + a.row_off[i];
  for (int r = warp; r < len * a.block_b; r += EVENT_THREADS / 32) {
    const int t = r / a.block_b, b = r - t * a.block_b;
    if (b >= nb) {                              // a missing lane: silent
      if (lane == 0) lcount[r] = 0;
      continue;
    }
    const uint32_t* srow = reinterpret_cast<const uint32_t*>(
        in + t * a.chunk_ld + b * a.spk_ld * 4);
    unsigned short* list = lists + (size_t)r * a.list_ld;
    int base = 0;
    for (int s0 = 0; s0 < n_words; s0 += 32) {
      const int q = s0 + lane;
      uint32_t x = 0;
      if (q < n_words) {
        x = srow[q];
        if (4 * q + 4 > n_in) x &= (1u << (8 * (n_in & 3))) - 1u;
        x |= x >> 4;                            // bit 8i: byte i is nonzero
        x |= x >> 2;
        x |= x >> 1;
        x &= 0x01010101u;
      }
      int pre = base, total = 0;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const unsigned m = __ballot_sync(0xffffffffu, (x >> (8 * y)) & 1u);
        pre += __popc(m & lt);
        total += __popc(m);
      }
#pragma unroll
      for (int y = 0; y < 4; ++y)
        if ((x >> (8 * y)) & 1u) {
          list[pre++] = (unsigned short)(4 * q + y);
          atomicAdd(rows + 4 * q + y, 1);
        }
      base += total;
    }
    // pad the list to a multiple of 8 entries with copies of its first
    // one (pass 2 subtracts them again), so that every 16-byte load of it
    // is whole
    __syncwarp();
    if ((base & 7) && lane < 8 - (base & 7)) list[base + lane] = list[0];
    if (lane == 0) {
      lcount[r] = base;
      atomicAdd(ttot + t, base);
    }
  }
}

// Event-list mode: the input frames of steps t0 .. t0 + len - 1 into the
// chunk buffer `buf`, row b of step s at s * chunk_ld + b * spk_ld * 4. A
// step's real lanes are one run of nb * N0 bytes of global memory; each
// thread moves an aligned 16-byte block of it (one 16-byte load, or byte
// loads where the block leaves the raster) and places the run's bytes of it
// row by row. No
// padding is written: missing lanes and the bytes past the fan-in are
// masked where they are read.
__device__ __forceinline__ void events_stage(const NetArgs& a, int t0, int len,
                                             int b0, int nb,
                                             unsigned char* buf) {
  const int n0 = a.width[0];
  const int run = nb * n0;
  const int blocks = (run + 15) / 16 + 1;       // blocks a run can touch
  const uintptr_t lo_all = (uintptr_t)a.spikes;
  const uintptr_t hi_all = lo_all + (size_t)a.timesteps * a.batch * n0;
  for (int e = threadIdx.x; e < len * blocks; e += EVENT_THREADS) {
    const int s = e / blocks, i = e - s * blocks;
    const int8_t* g0 = a.spikes + ((size_t)(t0 + s) * a.batch + b0) * n0;
    const uintptr_t lo = (uintptr_t)g0, hi = lo + run;
    const uintptr_t blk = (lo & ~(uintptr_t)15) + 16 * (uintptr_t)i;
    if (blk >= hi) continue;
    const int first = blk < lo ? (int)(lo - blk) : 0;
    const int last = blk + 16 > hi ? (int)(hi - blk) : 16;
    uint32_t w[4] = {0, 0, 0, 0};
    if (blk >= lo_all && blk + 16 <= hi_all) {    // inside the raster
      const int4 v = *reinterpret_cast<const int4*>(blk);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
#pragma unroll
      for (int x = 0; x < 16; ++x)
        if (x >= first && x < last)
          w[x >> 2] |= (uint32_t)*reinterpret_cast<const uint8_t*>(blk + x)
                       << (8 * (x & 3));
    }
    const int off = (int)(blk + first - lo);
    int b = off / n0, k = off - b * n0;
    unsigned char* dst = buf + s * a.chunk_ld;
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      if (x < first || x >= last) continue;
      dst[b * a.spk_ld * 4 + k] = (unsigned char)(w[x >> 2] >> (8 * (x & 3)));
      if (++k == n0) { k = 0; ++b; }
    }
  }
}

// Event-list mode. For each chunk of `tc` timesteps the input frames are
// staged, and then the layers run in order, each in two passes with one
// barrier after each: (1) `events_lists` over all (t, lane) rows of the
// chunk; (2) each (lane, column) thread runs over the chunk's steps in
// order: the step's AccW2V sum, gathered from its lane's list (8 entries a
// 16-byte broadcast load, their weight bytes loaded independently; the
// list's padding subtracted once), or the
// dense __dp4a sum when the step's tile total is above dense_thr (one
// fallback counted), then the V update, the spike into the other chunk
// buffer (the next layer's input) and the raster when asked for; the
// readout adds its sums unclamped. The block is 1,024 threads (32 warps an
// SM, at most two (lane, column) elements a thread at IMDB widths), so other
// warps hide the latency of a thread's dependent list and weight loads.
__device__ void events_body(const NetArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * a.block_b;
  const int nb = min(a.block_b, a.batch - b0);  // real lanes of this tile
  int32_t* cnt = reinterpret_cast<int32_t*>(smem + a.cnt_off);
  unsigned short* lists = reinterpret_cast<unsigned short*>(smem + a.list_off);
  int* lcount = reinterpret_cast<int*>(smem + a.lcount_off);
  int* ttot = reinterpret_cast<int*>(smem + a.ttot_off);   // [2][tc]

  events_weights(a, smem);
  init_v<EVENT_THREADS>(a, smem, b0, nb);
  for (int e = tid; e < a.n_counters; e += EVENT_THREADS) cnt[e] = 0;

  for (int t0 = 0; t0 < a.timesteps; t0 += a.tc) {
    const int len = min(a.tc, a.timesteps - t0);
    events_stage(a, t0, len, b0, nb, smem + a.chunk_off[0]);
    for (int t = tid; t < len; t += EVENT_THREADS) ttot[t] = 0;
    __syncthreads();

    for (int i = 0; i < a.n_layers; ++i) {
      const unsigned char* in = smem + a.chunk_off[i & 1];
      unsigned char* out = smem + a.chunk_off[(i & 1) ^ 1];
      const int* tot = ttot + (i & 1) * a.tc;
      events_lists(a, i, len, nb, in, lists, lcount,
                   ttot + (i & 1) * a.tc, cnt);
      __syncthreads();

      const int n_words = (a.width[i] + 3) >> 2;
      const int n_out = a.width[i + 1];
      const int ldw = a.wt_ld[i];
      const int32_t* wt = reinterpret_cast<const int32_t*>(smem + a.wt_off[i]);
      int32_t* v = reinterpret_cast<int32_t*>(smem + a.v_off[i]);
      const bool spiking = i < a.n_spiking;
      const int th = spiking ? a.threshold[i] : 0;
      const int leak = spiking ? a.leak[i] : 0;
      const int thr = a.dense_thr[i];
      if (tid == 0) {                           // fallbacks of this layer
        int n_fb = 0;
        for (int t = 0; t < len; ++t) n_fb += tot[t] > thr;
        cnt[a.fb_off + i] += n_fb;
      }
      int* next_tot = ttot + ((i & 1) ^ 1) * a.tc;  // the next layer's totals
      for (int t = tid; t < len; t += EVENT_THREADS) next_tot[t] = 0;

      for (int e = tid; e < a.block_b * n_out; e += EVENT_THREADS) {
        const int b = e / n_out, j = e - b * n_out;
        const int8_t* wrow = reinterpret_cast<const int8_t*>(wt + j * ldw);
        int vv = v[e];
        for (int t = 0; t < len; ++t) {
          int acc = 0;
          if (tot[t] > thr) {                   // dense fallback (CTA-uniform)
            const int32_t* srow = reinterpret_cast<const int32_t*>(
                in + t * a.chunk_ld + b * a.spk_ld * 4);
            const int32_t* wrow_w = wt + j * ldw;
            for (int q = 0; q < n_words; ++q)
              acc = __dp4a(srow[q], wrow_w[q], acc);
          } else {
            const int r = t * a.block_b + b;
            const int n = lcount[r];
            const uint4* ids = reinterpret_cast<const uint4*>(
                lists + (size_t)r * a.list_ld);
#pragma unroll 2
            for (int p = 0; p < n; p += 8) {    // padded to whole loads
              const uint4 e8 = ids[p >> 3];
              acc += wrow[e8.x & 0xffffu] + wrow[e8.x >> 16] +
                     wrow[e8.y & 0xffffu] + wrow[e8.y >> 16] +
                     wrow[e8.z & 0xffffu] + wrow[e8.z >> 16] +
                     wrow[e8.w & 0xffffu] + wrow[e8.w >> 16];
            }
            if (n & 7)                          // the padding's copies
              acc -= (8 - (n & 7)) * wrow[lists[(size_t)r * a.list_ld]];
          }
          if (!spiking) {                       // readout: no clamp
            vv = add_wrap(vv, acc);
            continue;
          }
          vv = clamp_v(add_wrap(vv, acc), a.wrap);
          if (a.neuron == NEURON_LIF) vv = clamp_v(sub_wrap(vv, leak), a.wrap);
          const bool fired = a.wrap ? clamp_v(sub_wrap(vv, th), 1) >= 0 : vv >= th;
          if (fired) vv = (a.neuron == NEURON_RMP) ? clamp_v(sub_wrap(vv, th), a.wrap) : 0;
          out[t * a.chunk_ld + b * a.spk_ld * 4 + j] = (fired && b < nb) ? 1 : 0;
          if (a.emit_rasters && b < nb)
            a.raster[i][((size_t)(t0 + t) * a.batch + b0 + b) * n_out + j] = fired ? 1 : 0;
        }
        v[e] = vv;
      }
      __syncthreads();
    }
  }

  write_v_out<EVENT_THREADS>(a, smem, b0, nb);
  for (int i = 0; i < a.n_layers; ++i) {
    const int n_in = a.width[i];
    for (int k = tid; k < n_in; k += EVENT_THREADS)
      a.row_counts[i][(size_t)blockIdx.x * n_in + k] = cnt[a.row_off[i] + k];
  }
  for (int i = tid; i < a.n_layers; i += EVENT_THREADS)
    a.fallbacks[(size_t)blockIdx.x * a.n_layers + i] = cnt[a.fb_off + i];
}

// ---------------------------------------------------------------- dense mode

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// D = A x B + D, A 16 x 32 int8 (row), B 32 x 8 int8 (col), D int32: exact.
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The low n bytes of a word set (n clipped to [0, 4]).
__device__ __forceinline__ uint32_t byte_mask(int n) {
  return n >= 4 ? 0xffffffffu : n <= 0 ? 0u : (1u << (8 * n)) - 1u;
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

// Dense mode: issue the copies of the input frames of steps t0 .. t0 +
// len - 1 into the input chunk. Lane b's row of step s goes to byte
// (s * lanes + b) * in_ld of it plus the row's global offset modulo 16, the
// threads over all (row, aligned 16-byte block) pairs. A block is one
// cp.async, also where it holds bytes of the neighbouring rows: they land
// in this row's slot (in_ld >= N0 + 31) and meet masked weights. Only a
// block that leaves the raster goes by plain loads of the row's bytes.
// Missing lanes are not staged.
__device__ void dense_stage(const NetArgs& a, unsigned char* smem, int t0,
                            int len, int b0, int nb) {
  const int n0 = a.width[0];
  unsigned char* buf = smem + a.in_off;
  const uintptr_t lo = (uintptr_t)a.spikes;
  const uintptr_t hi = lo + (size_t)a.timesteps * a.batch * n0;
  const int blocks = (n0 + 15) / 16 + 1;            // blocks a row can touch
  for (GridWalk w(nb, blocks); w.s < len; w.next()) {
    const uintptr_t g0 = (uintptr_t)(
        a.spikes + ((size_t)(t0 + w.s) * a.batch + b0 + w.b) * n0);
    const uintptr_t g1 = g0 + n0;
    const uintptr_t blk = (g0 & ~(uintptr_t)15) + 16 * (uintptr_t)w.x;
    if (blk >= g1) continue;
    unsigned char* dst =
        buf + (w.s * a.block_b + w.b) * a.in_ld + 16 * w.x;
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

// Dense mode: every layer's weights into shared memory, transposed (word q
// of W^T row j holds W[4q .. 4q + 3, j], 0 past the fan-in; the words past
// the fan-in up to a whole 16 bytes are 0 too, and the k-steps mask the
// rest). The warps take (4-word block, 32-column block) items: a lane loads
// its column's 16 fan-in bytes (every load unconditional, its address
// clamped into the matrix and its value masked, so all 16 are in flight; a
// warp's load is 32 consecutive bytes of a row) and stores them as one
// 16-byte store to its W^T row, whose 16-byte pieces a warp's 8-lane
// phases spread over all 32 banks (rows of 16 mod 32 bytes). With compact
// rows (an odd word count) it stores word by word.
__device__ void dense_weights(const NetArgs& a, unsigned char* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = 0; i < a.n_layers; ++i) {
    const int n_in = a.width[i], n_out = a.width[i + 1], ld = a.wt_ld[i];
    const int nw = (n_in + 3) >> 2;
    const int njb = (n_out + 31) >> 5;
    const int items = ((nw + 3) >> 2) * njb;
    const int8_t* w = a.w[i];
    uint32_t* wt = reinterpret_cast<uint32_t*>(smem + a.wt_off[i]);
    for (int it = warp; it < items; it += DENSE_WARPS) {
      const int qb = it / njb, j = (it - qb * njb) * 32 + lane;
      const int jj = min(j, n_out - 1);
      uint32_t x[4];
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        x[y] = 0;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = 16 * qb + 4 * y + r;
          const uint32_t v =
              (uint8_t)__ldg(w + (size_t)min(k, n_in - 1) * n_out + jj);
          x[y] |= (k < n_in ? v : 0u) << (8 * r);
        }
      }
      if (j >= n_out) continue;
      uint32_t* dst = wt + j * ld + 4 * qb;
      if ((ld & 3) == 0) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(x[0], x[1], x[2], x[3]);
      } else {
#pragma unroll
        for (int y = 0; y < 4; ++y)
          if (4 * qb + y < nw) dst[y] = x[y];
      }
    }
  }
}

// Dense mode: the staged input rows of the chunk moved to the start of
// their slots, so that every layer reads aligned rows. A warp takes four
// rows at a time and moves them 32 words a pass in ascending order; a pass
// reads words at or past the ones it writes, and writes only words below
// the next pass's reads, so a row moves in place behind one __syncwarp a
// pass.
__device__ void dense_align(const NetArgs& a, unsigned char* smem, int t0,
                            int len, int b0, int nb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = a.width[0], nw = (n0 + 3) >> 2;
  const int rows = len * nb;
  for (int r0 = 4 * warp; r0 < rows; r0 += 4 * DENSE_WARPS) {
    uint32_t* row[4];
    int o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = min(r0 + u, rows - 1);
      const int s = r / nb, b = r - s * nb;
      o[u] = r0 + u < rows
                 ? (int)((uintptr_t)(a.spikes + ((size_t)(t0 + s) * a.batch +
                                                  b0 + b) * n0) & 15)
                 : 0;
      row[u] = reinterpret_cast<uint32_t*>(
          smem + a.in_off + (s * a.block_b + b) * a.in_ld);
    }
    for (int w0 = 0; w0 < nw; w0 += 32) {
      const int x = w0 + lane;
      uint32_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t* src = row[u] + x + (o[u] >> 2);
        v[u] = __funnelshift_r(src[0], src[1], (unsigned)(o[u] & 3) * 8u);
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (o[u] != 0 && x < nw) row[u][x] = v[u];
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// Dense mode: AccW2V of one (lane group, two 8-column tiles) unit over the
// chunk's 2 * NP steps (steps past `len` read step len - 1 again, and are
// never used), as 2 NP independent int8 MMAs per k-step, each A fragment
// serving both tiles: pair p's 16 A rows are the group's 8 lanes at steps
// 2p and 2p + 1, loaded by one ldmatrix.x4 (lane l gives the address of
// row l % 8 of matrix l / 8: steps 2p and 2p + 1 of the first 16 bytes of
// the k-step, then of the last 16). This lane's row of step s starts at
// shared address `row + s * seg`. B is a tile's column's W^T row (`wrow0`,
// `wrow1`), its bytes past the fan-in masked in the last k-step (`mlo`,
// `mhi`), so whatever the A rows hold there adds nothing.
template <int NP>
__device__ __forceinline__ void dense_mma(int (&acc)[2][NP][4],
                                          unsigned row, int seg, int len,
                                          const uint32_t* wrow0,
                                          const uint32_t* wrow1, int ksteps,
                                          uint32_t mlo, uint32_t mhi, int q) {
  const int odd = (threadIdx.x >> 3) & 1;         // matrices 1 and 3
  unsigned ad[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int s = min(2 * p + odd, len - 1);
    ad[p] = row + s * seg;
#pragma unroll
    for (int t = 0; t < 2; ++t)
      acc[t][p][0] = acc[t][p][1] = acc[t][p][2] = acc[t][p][3] = 0;
  }
  // not unrolled: each k-step's 2 NP MMAs already overlap
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t b0_lo = wrow0[ks * 8 + q], b0_hi = wrow0[ks * 8 + 4 + q];
    uint32_t b1_lo = wrow1[ks * 8 + q], b1_hi = wrow1[ks * 8 + 4 + q];
    if (ks == ksteps - 1) {
      b0_lo &= mlo;
      b0_hi &= mhi;
      b1_lo &= mlo;
      b1_hi &= mhi;
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      uint32_t x[4];
      ldmatrix_x4(x, ad[p] + ks * 32);
      mma_s8(acc[0][p], x[0], x[1], x[2], x[3], b0_lo, b0_hi);
      mma_s8(acc[1][p], x[0], x[1], x[2], x[3], b1_lo, b1_hi);
    }
  }
}

// One step of one spiking neuron (reset to 0): V update from the step's
// AccW2V sum; returns whether it fired. In wrap mode SpikeCheck tests
// wrap(v - th) >= 0, that is ((v - th + 1024) mod 2048) >= 1024: bit 10 of
// v - th clear.
template <int NEURON, int WRAP>
__device__ __forceinline__ bool neuron_step(int& v, int acc, int th,
                                            int leak) {
  int vv = clamp_v(add_wrap(v, acc), WRAP);
  if (NEURON == NEURON_LIF) vv = clamp_v(sub_wrap(vv, leak), WRAP);
  const int d = sub_wrap(vv, th);
  const bool fired = WRAP ? (d & 1024) == 0 : vv >= th;
  if (fired) vv = NEURON == NEURON_RMP ? clamp_v(d, WRAP) : 0;
  v = vv;
  return fired;
}

// Dense mode, layer i over chunk c (its `len` steps in NP = ceil(len / 2)
// MMA pairs): the warps take the layer's (lane group, 16-column block)
// units; each runs the chunk's products for its two 8-column tiles
// (`dense_mma`), then its thread (lane g, columns jc, jc + 1 and jc + 8,
// jc + 9) scans V over the chunk's steps straight from the accumulator
// fragments (the same lane and columns at every step) and writes the
// spikes into the layer's spike chunk, the next layer's A operand, two
// bytes a store (the last spiking layer before a readout also writes its
// spike counts over the chunk into the counts tile); the readout adds the
// steps' sums into V unclamped. V comes from the carried state (or 0) at the first
// chunk and goes to V out at the last one, in between through the layer's
// V tile, which each thread alone reads and writes. A missing column reads
// the last real column's weights and a missing lane junk rows; neither is
// stored anywhere but its own padding.
template <int NP, int NEURON, int WRAP>
__device__ __forceinline__ void dense_units(const NetArgs& a,
                                            unsigned char* smem, int i, int c,
                                            int n_chunks, int len, int b0,
                                            int nb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;          // MMA group and quad index
  const int n_in = a.width[i], n_out = a.width[i + 1];
  const int groups = (a.block_b + 7) >> 3;       // lane groups (of up to 8)
  const int units = groups * ((n_out + 15) >> 4);
  const int ksteps = (n_in + 31) >> 5;
  const int klast = (ksteps - 1) * 32;
  const uint32_t mlo = byte_mask(n_in - (klast + 4 * q));
  const uint32_t mhi = byte_mask(n_in - (klast + 16 + 4 * q));
  const bool spiking = i < a.n_spiking;
  // with counts in the plan, the last spiking layer before a readout also
  // counts its spikes, and the readout (past the first layer) reads them
  const bool counts = a.counts_ld > 0 && a.n_layers > a.n_spiking;
  const bool count = counts && i + 1 == a.n_spiking;
  const bool by_counts = counts && i == a.n_spiking && i > 0;
  const int th = spiking ? a.threshold[i] : 0;
  const int leak = spiking ? a.leak[i] : 0;
  // the spike chunks by value (an index into the parameters would take
  // their addresses)
  const bool odd = i & 1;
  const int out_off = odd ? a.out_off[1] : a.out_off[0];
  const int out_ld = odd ? a.out_ld[1] : a.out_ld[0];
  const int in_ld = i == 0 ? a.in_ld
                    : by_counts ? a.counts_ld
                    : odd ? a.out_ld[0] : a.out_ld[1];
  const int in_off = i == 0 ? a.in_off
                     : by_counts ? a.counts_off
                     : odd ? a.out_off[0] : a.out_off[1];
  const uint32_t* wt = reinterpret_cast<const uint32_t*>(smem + a.wt_off[i]);
  const unsigned smem_base = (unsigned)__cvta_generic_to_shared(smem);
  int32_t* vt = reinterpret_cast<int32_t*>(smem + a.v_off[i]);
  const int ostride = a.block_b * out_ld;
  for (int u = warp; u < units; u += DENSE_WARPS) {
    const int gi = u % groups, j0 = 16 * (u / groups);
    const int b = 8 * gi + g;                     // this thread's lane
    const bool own = b < a.block_b;               // a lane of the tile
    const int jc = j0 + 2 * q;                    // its result columns: jc,
                                                  // jc + 1, jc + 8, jc + 9
    // this lane's ldmatrix row: lane 8 gi + lane % 8 (the tile's last lane
    // past its lanes), first or last 16 bytes of the k-step
    const unsigned row =
        smem_base + in_off +
        min(8 * gi + (lane & 7), a.block_b - 1) * in_ld + ((lane >> 4) << 4);
    int acc[2][NP][4];
    dense_mma<NP>(acc, row, a.block_b * in_ld, len,
                  wt + min(j0 + g, n_out - 1) * a.wt_ld[i],
                  wt + min(j0 + 8 + g, n_out - 1) * a.wt_ld[i], ksteps, mlo,
                  mhi, q);

    const bool real = b < nb;
    int32_t* vp = vt + b * n_out + jc;
    int v[4];                                     // columns jc, +1, +8, +9
    {
      const int32_t* vi =
          c > 0 ? (own ? vp : nullptr)
                : (a.has_v_init && real)
                      ? a.v_init[i] + (size_t)(b0 + b) * n_out + jc
                      : nullptr;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int dj = (x & 1) + 8 * (x >> 1);
        v[x] = (vi && jc + dj < n_out) ? vi[dj] : 0;
      }
    }
    if (!spiking) {                               // readout: no clamp
#pragma unroll
      for (int s = 0; s < 2 * NP; ++s) {
        if (s == 2 * NP - 1 && s >= len) break;   // odd len: the last step
#pragma unroll
        for (int x = 0; x < 4; ++x)
          v[x] = add_wrap(v[x], acc[x >> 1][s >> 1][(s & 1) * 2 + (x & 1)]);
      }
    } else {
      unsigned char* optr = smem + out_off + b * out_ld + jc;
      unsigned n[2] = {0, 0};                     // spikes over the chunk
#pragma unroll
      for (int s = 0; s < 2 * NP; ++s) {
        if (s == 2 * NP - 1 && s >= len) break;   // odd len: the last step
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const bool f0 = neuron_step<NEURON, WRAP>(
              v[2 * t], acc[t][s >> 1][(s & 1) * 2], th, leak);
          const bool f1 = neuron_step<NEURON, WRAP>(
              v[2 * t + 1], acc[t][s >> 1][(s & 1) * 2 + 1], th, leak);
          const unsigned f = f0 | (f1 << 8);
          if (own)
            *reinterpret_cast<uint16_t*>(optr + s * ostride + 8 * t) =
                (uint16_t)f;
          n[t] += f;
        }
      }
      if (count && own) {
        unsigned char* cptr = smem + a.counts_off + b * a.counts_ld + jc;
        *reinterpret_cast<uint16_t*>(cptr) = (uint16_t)n[0];
        *reinterpret_cast<uint16_t*>(cptr + 8) = (uint16_t)n[1];
      }
    }
    if ((c < n_chunks - 1 && own) || real) {
      int32_t* vo = c < n_chunks - 1
                        ? vp : a.v_out[i] + (size_t)(b0 + b) * n_out + jc;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int dj = (x & 1) + 8 * (x >> 1);
        if (jc + dj < n_out) vo[dj] = v[x];
      }
    }
  }
}

static_assert(DENSE_TC_MAX == 16, "dense_layer's cases cover 1 to 8 MMA pairs");

// `dense_units` of layer i for the chunk's ceil(len / 2) MMA pairs. The
// readout's products summed over the chunk are the products of its input's
// spike counts over the chunk (integer arithmetic, and no clamp between
// the steps), so with counts in the plan it takes one step: the counts the
// last spiking layer left.
template <int NEURON, int WRAP>
__device__ __forceinline__ void dense_layer(const NetArgs& a,
                                            unsigned char* smem, int i, int c,
                                            int n_chunks, int len, int b0,
                                            int nb) {
  if (i >= a.n_spiking && i > 0 && a.counts_ld > 0) {
    dense_units<1, NEURON, WRAP>(a, smem, i, c, n_chunks, 1, b0, nb);
    return;
  }
#define DENSE_UNITS_CASE(N)                                                 \
  case N:                                                                   \
    dense_units<N, NEURON, WRAP>(a, smem, i, c, n_chunks, len, b0, nb);     \
    break;
  switch ((len + 1) >> 1) {
    DENSE_UNITS_CASE(1) DENSE_UNITS_CASE(2) DENSE_UNITS_CASE(3)
    DENSE_UNITS_CASE(4) DENSE_UNITS_CASE(5) DENSE_UNITS_CASE(6)
    DENSE_UNITS_CASE(7) DENSE_UNITS_CASE(8)
  }
#undef DENSE_UNITS_CASE
}

// Dense mode: layer i's spikes of the chunk (steps t0 .. t0 + len - 1, in
// its spike chunk) into its raster. Where N_{i+1} is whole 16-byte pieces
// and the raster 16-byte aligned, a thread copies a piece of a row at a
// time. Else a step's real lanes are one run of nb * N_{i+1} bytes of
// global memory; each thread gathers an aligned 16-byte block of it from
// shared memory a byte at a time and stores it with one 16-byte store; the
// run's ragged end blocks, which neighbouring lanes or steps share, go byte
// by byte.
__device__ void dense_raster(const NetArgs& a, int i, const unsigned char* smem,
                             int t0, int len, int b0, int nb) {
  const int n = a.width[i + 1];
  const unsigned char* buf = smem + ((i & 1) ? a.out_off[1] : a.out_off[0]);
  const int ld = (i & 1) ? a.out_ld[1] : a.out_ld[0];
  if ((n & 15) == 0 && ((uintptr_t)a.raster[i] & 15) == 0) {
    for (GridWalk w(nb, n >> 4); w.s < len; w.next()) {
      const int4 v = *reinterpret_cast<const int4*>(
          buf + (w.s * a.block_b + w.b) * ld + 16 * w.x);
      *reinterpret_cast<int4*>(
          a.raster[i] + ((size_t)(t0 + w.s) * a.batch + b0 + w.b) * n +
          16 * w.x) = v;
    }
    return;
  }
  const int run = nb * n;
  const int blocks = (run + 15) / 16 + 1;         // blocks a run can touch
  for (int e = threadIdx.x; e < len * blocks; e += DENSE_THREADS) {
    const int s = e / blocks, x = e - s * blocks;
    const uintptr_t lo = (uintptr_t)(
        a.raster[i] + ((size_t)(t0 + s) * a.batch + b0) * n);
    const uintptr_t hi = lo + run;
    const uintptr_t blk = (lo & ~(uintptr_t)15) + 16 * (uintptr_t)x;
    if (blk >= hi) continue;
    const int first = blk < lo ? (int)(lo - blk) : 0;
    const int last = blk + 16 > hi ? (int)(hi - blk) : 16;
    const int off = (int)(blk + first - lo);
    int b = off / n, k = off - b * n;
    const unsigned char* src = buf + s * a.block_b * ld;
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int y = 0; y < 16; ++y) {
      if (y < first || y >= last) continue;
      w[y >> 2] |= (uint32_t)src[b * ld + k] << (8 * (y & 3));
      if (++k == n) { k = 0; ++b; }
    }
    if (first == 0 && last == 16) {
      *reinterpret_cast<int4*>(blk) =
          make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
    } else {
#pragma unroll
      for (int y = 0; y < 16; ++y)
        if (y >= first && y < last)
          *reinterpret_cast<uint8_t*>(blk + y) =
              (uint8_t)(w[y >> 2] >> (8 * (y & 3)));
    }
  }
}

// Dense mode. The weights and the first chunk's frames are loaded at once;
// then per chunk of `tc` timesteps the layers run in order, one barrier
// after each: the layer's units (`dense_layer`), with the previous layer's
// raster stored beside them; after the first layer's barrier, the next
// chunk's frames are staged behind the other layers' work.
template <int NEURON, int WRAP>
__device__ __forceinline__ void dense_body(const NetArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b0 = blockIdx.x * a.block_b;
  const int nb = min(a.block_b, a.batch - b0);   // real lanes of this tile
  const int n_chunks = (a.timesteps + a.tc - 1) / a.tc;
  if (n_chunks == 0) {                           // no frames: V out is V in
    for (int i = 0; i < a.n_layers; ++i) {
      const int n_out = a.width[i + 1];
      for (int e = threadIdx.x; e < nb * n_out; e += DENSE_THREADS)
        a.v_out[i][(size_t)b0 * n_out + e] =
            a.has_v_init ? a.v_init[i][(size_t)b0 * n_out + e] : 0;
    }
    return;
  }
  dense_stage(a, smem, 0, min(a.tc, a.timesteps), b0, nb);
  dense_weights(a, smem);
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * a.tc, len = min(a.tc, a.timesteps - t0);
    cp_async_wait_all();
    __syncthreads();
    dense_align(a, smem, t0, len, b0, nb);
    __syncthreads();
    for (int i = 0; i < a.n_layers; ++i) {
      dense_layer<NEURON, WRAP>(a, smem, i, c, n_chunks, len, b0, nb);
      if (i > 0 && i - 1 < a.n_spiking && a.emit_rasters)
        dense_raster(a, i - 1, smem, t0, len, b0, nb);
      __syncthreads();
      if (i == 0 && c + 1 < n_chunks)
        dense_stage(a, smem, t0 + a.tc, min(a.tc, a.timesteps - t0 - a.tc),
                    b0, nb);
    }
    if (a.emit_rasters && a.n_layers - 1 < a.n_spiking)
      dense_raster(a, a.n_layers - 1, smem, t0, len, b0, nb);
  }
}

// ---------------------------------------------------------------- gated mode

template <int MODE>
__device__ __forceinline__ void net_body(const NetArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * a.block_b;
  const int nb = min(a.block_b, a.batch - b0);   // real lanes of this tile
  int32_t* cnt = reinterpret_cast<int32_t*>(smem + a.cnt_off);
  unsigned* wm = reinterpret_cast<unsigned*>(smem + a.gate_off)
                 + (tid >> 5) * a.gate_ld;      // this warp's gate masks

  stage_weights_and_v(a, smem, b0, nb);
  if (MODE != MODE_DENSE)
    for (int e = tid; e < a.n_counters; e += THREADS) cnt[e] = 0;

  const int n0 = a.width[0];
  const int spk_row_bytes = a.spk_ld * 4;
  for (int t = 0; t < a.timesteps; ++t) {
    // input frame t; padded lanes and the ragged batch edge read as silent
    int8_t* s0 = reinterpret_cast<int8_t*>(smem + a.spk_off[0]);
    const int8_t* frame = a.spikes + ((size_t)t * a.batch + b0) * n0;
    for (int e = tid; e < a.block_b * spk_row_bytes; e += THREADS) {
      const int b = e / spk_row_bytes, k = e - b * spk_row_bytes;
      s0[e] = (b < nb && k < n0) ? frame[b * n0 + k] : 0;
    }
    __syncthreads();

    int cur = 0;
    for (int i = 0; i < a.n_layers; ++i) {
      const int n_words = (a.width[i] + 3) >> 2;
      const int n_out = a.width[i + 1];
      const int ldw = a.wt_ld[i];
      const int32_t* wt = reinterpret_cast<const int32_t*>(smem + a.wt_off[i]);
      const int32_t* in = reinterpret_cast<const int32_t*>(smem + a.spk_off[cur]);
      int8_t* out = reinterpret_cast<int8_t*>(smem + a.spk_off[cur ^ 1]);
      int32_t* v = reinterpret_cast<int32_t*>(smem + a.v_off[i]);
      const bool spiking = i < a.n_spiking;
      const int th = spiking ? a.threshold[i] : 0;
      const int leak = spiking ? a.leak[i] : 0;
      bool dense = MODE == MODE_DENSE;
      unsigned m0 = 0;                            // gated: first segment's mask
      if (MODE == MODE_GATED) dense = gate_masks(a, i, in, wm, m0, cnt);
      for (int e = tid; e < a.block_b * n_out; e += THREADS) {
        const int b = e / n_out, j = e - b * n_out;
        int acc = 0;
        if (dense) {
          const int32_t* srow = in + b * a.spk_ld;
          const int32_t* wrow = wt + j * ldw;
          for (int q = 0; q < n_words; ++q) acc = __dp4a(srow[q], wrow[q], acc);
        } else if (MODE == MODE_GATED) {
          acc = gated_dot(in + b * a.spk_ld, wt + j * ldw, m0, wm, n_words);
        }
        if (!spiking) {                               // readout: no clamp
          v[e] = add_wrap(v[e], acc);
          continue;
        }
        int vv = clamp_v(add_wrap(v[e], acc), a.wrap);
        if (a.neuron == NEURON_LIF) vv = clamp_v(sub_wrap(vv, leak), a.wrap);
        const bool fired = a.wrap ? clamp_v(sub_wrap(vv, th), 1) >= 0 : vv >= th;
        if (fired) vv = (a.neuron == NEURON_RMP) ? clamp_v(sub_wrap(vv, th), a.wrap) : 0;
        v[e] = vv;
        out[b * spk_row_bytes + j] = (fired && (MODE == MODE_DENSE || b < nb)) ? 1 : 0;
        if (a.emit_rasters && b < nb)
          a.raster[i][((size_t)t * a.batch + b0 + b) * n_out + j] = fired ? 1 : 0;
      }
      __syncthreads();
      cur ^= 1;
    }
  }

  write_v_out<THREADS>(a, smem, b0, nb);
  if (MODE == MODE_GATED)
    for (int c = tid; c < a.n_skip_cols; c += THREADS)
      a.skips[(size_t)blockIdx.x * a.n_skip_cols + c] = cnt[c];
}

// One resident CTA of 256 threads an SM leaves ptxas up to 255 registers a
// thread: a chunk's accumulators of two tiles and their A addresses stay in
// registers (at 512 threads, 128 registers, it spilled).
__global__ void __launch_bounds__(DENSE_THREADS, 1)
fused_snn_net_kernel(const NetArgs a) {
  // one body per (neuron, clamp): a launch runs the code of one of them
  switch (a.neuron * 2 + a.wrap) {
    case NEURON_IF * 2: dense_body<NEURON_IF, 0>(a); break;
    case NEURON_IF * 2 + 1: dense_body<NEURON_IF, 1>(a); break;
    case NEURON_LIF * 2: dense_body<NEURON_LIF, 0>(a); break;
    case NEURON_LIF * 2 + 1: dense_body<NEURON_LIF, 1>(a); break;
    case NEURON_RMP * 2: dense_body<NEURON_RMP, 0>(a); break;
    default: dense_body<NEURON_RMP, 1>(a);
  }
}

// The gated body needs more than the 32 registers ptxas settles on for
// the others (it spilled there); asking for two CTAs an SM, not eight,
// gives it 76 and no spills, at the cost of fewer resident CTAs at very
// large batch.
__global__ void __launch_bounds__(THREADS, 2)
fused_snn_net_gated(const NetArgs a) { net_body<MODE_GATED>(a); }

__global__ void __launch_bounds__(EVENT_THREADS, 1)
fused_snn_net_events(const NetArgs a) { events_body(a); }

extern "C" {

int fused_snn_net_args_size() { return (int)sizeof(NetArgs); }

int fused_snn_net_threads() { return THREADS; }

int fused_snn_net_max_layers() { return MAX_LAYERS; }

int fused_snn_net_event_threads() { return EVENT_THREADS; }

int fused_snn_net_dense_threads() { return DENSE_THREADS; }

const char* fused_snn_net_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launch the kernel of `mode` (MODE_*) on `stream` with `smem_bytes` of
// dynamic shared memory (computed and checked by the caller). Returns the
// CUDA error code of the launch.
int fused_snn_net_launch(const NetArgs* args, int mode, int grid,
                         int smem_bytes, void* stream) {
  void (*kernel)(const NetArgs);
  if (mode == MODE_DENSE) kernel = fused_snn_net_kernel;
  else if (mode == MODE_GATED) kernel = fused_snn_net_gated;
  else if (mode == MODE_EVENTS) kernel = fused_snn_net_events;
  else return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = mode == MODE_EVENTS  ? EVENT_THREADS
                      : mode == MODE_DENSE ? DENSE_THREADS
                                           : THREADS;
  kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

}  // extern "C"

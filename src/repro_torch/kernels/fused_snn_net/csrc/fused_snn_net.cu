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
// Design. One CTA owns a tile of `block_b` batch lanes for the whole T loop
// (no grid axis over T, as the TPU kernel's fori_loop keeps V resident).
// Every layer's weights sit in shared memory at their logical widths,
// transposed so that a thread reads 4 fan-in rows of its output column as
// one 32-bit word and issues __dp4a against 4 packed spikes; row strides are
// an odd number of words, so a warp's 32 columns hit 32 different banks.
// Every layer's V tile and the two ping-pong spike buffers also sit in
// shared memory, so membrane potentials and inter-layer spikes never touch
// device memory: device memory sees the input raster, the weights once per
// CTA, V in (when streaming) and out, the rasters when asked for, and the
// gate or event counters once per CTA at the end. The shared-memory layout
// (offsets, strides, total bytes) is computed and checked once, by the
// Python binding, and passed in `NetArgs`.
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
// operations per byte), so the function is bound by memory. At serving
// batch sizes (a few CTAs) the dense and gated modes are in fact bound by
// the latency of their serial T x L loop: one barrier per layer-step and
// the chain of shared-memory loads into __dp4a of each (lane, column)
// thread. The gated mode adds one mask pass a layer-step to the dense
// mode's work and takes away the words of silent blocks. The event-list
// mode takes two barriers per (chunk, layer) and is bound by issuing its
// gathers, about four instructions per event and column. Tensor-core MMA,
// TMA and persistent CTAs are later work.
//
// Signed overflow is undefined in C++ while the reference wraps, so every
// V addition goes through uint32_t. The wrap clamp uses a mask, not C's
// truncating %. Integer addition commutes, so the gathered and the gated
// sums equal the dense sum exactly.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LAYERS 16
#define THREADS 256
#define EVENT_THREADS 1024              // the event-list kernel's block

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

// Dense and gated modes: every layer's weights into shared memory,
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

__global__ void __launch_bounds__(THREADS)
fused_snn_net_kernel(const NetArgs a) { net_body<MODE_DENSE>(a); }

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
  const int threads = mode == MODE_EVENTS ? EVENT_THREADS : THREADS;
  kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

}  // extern "C"

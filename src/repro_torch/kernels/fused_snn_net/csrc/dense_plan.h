// The dense fused-network kernel's launch plan and shared-memory layout, in
// plain C++ (host code only): `fused_snn_net.cu` includes it, and the
// Python binding's `kernel.dense_plan` is its mirror, checked against
// `fused_snn_net_dense_plan` on `DENSE_PLAN_PROBES` when the library loads.
//
// A CTA owns `lanes` batch lanes (a multiple of 8: an MMA row tile is two
// timesteps of 8 lanes; or 4, 2 or 1 where 8 do not fit) for the whole T
// loop and stages `tc` timesteps a chunk. Its shared memory, in order (every offset a multiple of 16):
//   W^T of every layer   n_out rows of `wt_ld` words (16 mod 32 bytes, so
//                        the 8 rows of a B fragment hit different banks, or
//                        in a compact plan the odd word count of the gated
//                        layout); a row holds the fan-in, bytes past it are
//                        masked off when read;
//   the input chunk      tc x lanes rows of `in_ld` bytes (>= N0 + 31 and
//                        16 mod 32), a row at its global offset modulo 16;
//   two spike chunks     tc x lanes rows each; chunk k holds the outputs of
//                        the layers i with i % 2 == k, its rows `out_ld[k]`
//                        bytes (16 mod 32) for the widest of them; the
//                        second only with two layers or more;
//   the counts           with two layers or more, lanes rows of `counts_ld`
//                        bytes (16 mod 32): layer L - 2's spike counts over
//                        the chunk, a readout's input (none in a plan
//                        without counts: counts_ld is 0, and a readout sums
//                        its input's spike rows);
//   V of every layer     lanes x N_{i+1} int32;
//   16 bytes of slack.
// The k-steps read up to 16 bytes past a spike or counts row (28 past a
// weight row); past a region's last row that lands in the next region or
// the slack, never past the end.
//
// The plan spreads ceil(B / 8) lane groups over at most DENSE_SMS CTAs
// (H100 SXM has 132 SMs) and takes the longest chunk (16, 8, 4, 2, 1
// steps, at most T), then the most lane groups, whose layout fits; where
// none does, the same with compact weight rows, then also without counts,
// then with 4, 2 or 1 lanes.

#ifndef FUSED_SNN_NET_DENSE_PLAN_H_
#define FUSED_SNN_NET_DENSE_PLAN_H_

#define DENSE_MAX_LAYERS 16
#define DENSE_TC_MAX 16                 // timesteps of a chunk
#define DENSE_SMS 132                   // CTAs the plan spreads lanes over
#define DENSE_SMEM_LIMIT 232448         // bytes a Hopper block can use

struct DensePlan {
  int lanes, tc, bytes;
  int in_off, in_ld;                    // input chunk: offset, row bytes
  int out_off[2], out_ld[2];            // spike chunks: offsets, row bytes
  int counts_off, counts_ld;            // counts: offset, row bytes
  int wt_off[DENSE_MAX_LAYERS], wt_ld[DENSE_MAX_LAYERS];   // bytes, words
  int v_off[DENSE_MAX_LAYERS];                              // bytes
};

// Bytes of a row that k-steps read n bytes of: whole 16-byte blocks, an odd
// number of them (16 mod 32 bytes).
static inline long long dense_kstep_row(int n) {
  long long blocks = (n + 15) / 16;
  if (blocks % 2 == 0) ++blocks;
  return 16 * blocks;
}

// Bytes of a staged input row: N0 and the two ragged 16-byte blocks a row
// at any offset touches (N0 + 31), rounded up to 16 modulo 32.
static inline long long dense_in_row(int n0) { return (n0 + 46) / 32 * 32 + 16; }

// The layout of `n_layers` layers of `widths` (N_0 .. N_L) at `lanes` and
// `tc` (with compact weight rows when `compact`, with the counts when
// `counts`); returns its bytes (filling `p`, when given).
static inline long long dense_layout(int n_layers, const int* widths,
                                     int lanes, int tc, bool compact,
                                     bool counts, DensePlan* p) {
  long long off = 0;
  for (int i = 0; i < n_layers; ++i) {
    const long long ld = compact ? (((widths[i] + 3) / 4) | 1)
                                 : dense_kstep_row(widths[i]) / 4;
    if (p) { p->wt_off[i] = (int)off; p->wt_ld[i] = (int)ld; }
    off += (widths[i + 1] * 4 * ld + 15) / 16 * 16;
  }
  const long long in_ld = dense_in_row(widths[0]);
  if (p) { p->in_off = (int)off; p->in_ld = (int)in_ld; }
  off += (long long)tc * lanes * in_ld;
  for (int k = 0; k < 2; ++k) {
    int widest = 1;                     // of the outputs chunk k holds
    for (int i = k; i < n_layers; i += 2)
      widest = widths[i + 1] > widest ? widths[i + 1] : widest;
    const long long ld = dense_kstep_row(widest);
    if (p) { p->out_off[k] = (int)off; p->out_ld[k] = (int)ld; }
    if (k == 0 || n_layers > 1) off += (long long)tc * lanes * ld;
  }
  const long long counts_ld =
      n_layers > 1 && counts ? dense_kstep_row(widths[n_layers - 1]) : 0;
  if (p) { p->counts_off = (int)off; p->counts_ld = (int)counts_ld; }
  off += lanes * counts_ld;
  for (int i = 0; i < n_layers; ++i) {
    if (p) p->v_off[i] = (int)off;
    off += 4LL * lanes * widths[i + 1];
  }
  off = (off + 15) / 16 * 16 + 16;      // the slack
  if (p) { p->lanes = lanes; p->tc = tc; p->bytes = (int)off; }
  return off;
}

// The plan of a (T, B) call; returns 0, or -1 when not even one lane and
// one timestep fit.
static inline int dense_plan(int n_layers, const int* widths, int T, int B,
                             DensePlan* p) {
  const long long groups = (B + 7LL) / 8;
  long long want = (groups + DENSE_SMS - 1) / DENSE_SMS;
  if (want < 1) want = 1;
  const int steps = T > 1 ? T : 1;
  const int chunks[5] = {DENSE_TC_MAX, 8, 4, 2, 1};
  for (int tier = 0; tier < 3; ++tier) {    // (compact, counts) ladder
    const bool compact = tier > 0, counts = tier < 2;
    int prev = 0;
    for (int j = 0; j < 5; ++j) {
      const int tc = chunks[j] < steps ? chunks[j] : steps;
      if (tc == prev) continue;
      prev = tc;
      for (long long g = want; g >= 1; --g) {
        const int lanes = (int)(8 * g);
        if (dense_layout(n_layers, widths, lanes, tc, compact, counts,
                         nullptr) <= DENSE_SMEM_LIMIT) {
          dense_layout(n_layers, widths, lanes, tc, compact, counts, p);
          return 0;
        }
      }
    }
  }
  for (int lanes = 4; lanes >= 1; lanes /= 2) {
    int prev = 0;
    for (int j = 0; j < 5; ++j) {
      const int tc = chunks[j] < steps ? chunks[j] : steps;
      if (tc == prev) continue;
      prev = tc;
      if (dense_layout(n_layers, widths, lanes, tc, true, false, nullptr) <=
          DENSE_SMEM_LIMIT) {
        dense_layout(n_layers, widths, lanes, tc, true, false, p);
        return 0;
      }
    }
  }
  return -1;
}

// `dense_plan` as 11 + 3 DENSE_MAX_LAYERS ints: lanes, tc, bytes, in_off,
// in_ld, out_off[0], out_off[1], out_ld[0], out_ld[1], counts_off,
// counts_ld, then per layer slot (DENSE_MAX_LAYERS each, unused ones 0)
// wt_off, wt_ld, v_off. Returns 0, or -1 when nothing fits or the stack is
// not 1 to DENSE_MAX_LAYERS layers.
extern "C" int fused_snn_net_dense_plan(int n_layers, const int* widths,
                                        int T, int B, int* out) {
  if (n_layers < 1 || n_layers > DENSE_MAX_LAYERS) return -1;
  DensePlan p = {};
  if (dense_plan(n_layers, widths, T, B, &p) != 0) return -1;
  const int head[11] = {p.lanes, p.tc, p.bytes, p.in_off, p.in_ld,
                        p.out_off[0], p.out_off[1], p.out_ld[0], p.out_ld[1],
                        p.counts_off, p.counts_ld};
  for (int x = 0; x < 11; ++x) out[x] = head[x];
  for (int i = 0; i < DENSE_MAX_LAYERS; ++i) {
    out[11 + i] = p.wt_off[i];
    out[11 + DENSE_MAX_LAYERS + i] = p.wt_ld[i];
    out[11 + 2 * DENSE_MAX_LAYERS + i] = p.v_off[i];
  }
  return 0;
}

#endif  // FUSED_SNN_NET_DENSE_PLAN_H_

// wkv6: the RWKV6 recurrence over a whole prompt in one launch, for Hopper
// (sm_90a).
//
// Replaces `repro/kernels/wkv6/kernel.py::_wkv6_kernel` (the Pallas TPU
// kernel dispatched by `wkv6_pallas`, kernel.py:24). Per head-batch row bh,
// with state S (K x V) carried across all T steps:
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] = w_t[i] * S[i][j] + k_t[i] * v_t[j]
// in float32, on the (B*H, T, K/V) layout, from the initial state s0; it
// writes every y_t and the final state. Any T >= 1, K and V each in
// {16, 32, 64}.
//
// Not the TPU kernel's chunked form. That form scales k by exp(-L), L the
// summed log-decay over a 64-step chunk, which overflows float32 once
// L < -88.7; the model's decay clip allows w = exp(-e) per step, so L can
// reach -174 (`repro/kernels/wkv6/ref.py:72-76`). Here every step is the
// sequential update, whose factors are all in (0, 1]: nothing overflows
// that the recurrence itself does not. No tensor-core form either: TF32 or
// bf16 products keep about 1e-3 relative precision, against the 2e-4 the
// reference holds the kernel to.
//
// What bounds the function on this card: bytes. Device memory sees r, k, w
// and v once, y once and the state twice (0.0257 ms at B*H = 64, T = 1,024,
// K = V = 64, at 3.35 TB/s); the float32 arithmetic (4 operations per state
// element a step, 0.016 ms at 67 TFLOP/s) is below that. The first form of
// this kernel ran one warp per block, a whole state column per thread (208
// registers), and loaded each chunk between two barriers: one warp per SM
// at batch 1, every step and every chunk load on its critical path, 15x
// the bound.
//
// Design. A block owns COLS = min(V, 32) state columns of one bh and all K
// rows of them. Each thread keeps a tile of ROWS x CPT = 4 x 4 state
// elements in registers (rows g*4 .. g*4+3 of row group g, four adjacent
// columns), with u of its rows. At K = V = 64 a block is 16 row groups x 8
// threads = 4 warps, one per scheduler of an SM, and the grid of
// B*H * V/COLS blocks fills 128 SMs at batch 1. A step reads, per thread,
// one float4 each of r, k and w (the same words for the 8 threads of a row
// group: broadcasts) and one float4 of v, and writes one float4 of partial
// y: 1.25 shared-memory words per state element, against 3.25 for a
// column per thread. Each row group's partial y_t (the sum over its rows)
// goes to a shared [K / ROWS][CHUNK][COLS] buffer; one pass after the next
// barrier sums the groups in a fixed order and stores y with 16-byte
// stores. The step loop is what bounds the kernel now: with one warp a
// scheduler, its shared-memory traffic (about 10 KB an SM a step) and the
// latency of its loads set the pace, not device memory.
//
// Staging. CHUNK = 32 steps of r, k, w (each CHUNK x K) and the block's v
// columns go to shared memory with 16-byte cp.async copies, double
// buffered: chunk c + 1 is in flight while chunk c runs. The partial-y
// buffer is double buffered too, so a chunk needs one barrier: after it,
// the block issues the next chunk's copies, reduces the previous chunk's
// partials and runs this chunk's steps. A ragged last chunk (and T < CHUNK,
// a short prompt in a single chunk) is copied and run for its n steps
// only. The V / COLS blocks of one bh read the same r, k and w: once from
// device memory and otherwise from L2 (the column blocks of one bh are
// adjacent in the grid, so they run together).
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 32;   // steps staged in shared memory at a time
constexpr int ROWS = 4;     // state rows of a thread's tile
constexpr int CPT = 4;      // state columns of a thread's tile (one float4)

__host__ __device__ constexpr int cols_of(int V) { return V < 32 ? V : 32; }

__host__ __device__ constexpr int threads_of(int K, int V) {
  return (K / ROWS) * (cols_of(V) / CPT);
}

// floats of shared memory: two stages of r, k, w and v, two partial-y
// buffers
__host__ __device__ constexpr int smem_floats(int K, int V) {
  return 2 * (3 * CHUNK * K + CHUNK * cols_of(V))
         + 2 * (K / ROWS) * CHUNK * cols_of(V);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void unpack4(float4 q, float* out) {
  out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
}

template <int K, int COLS>
struct Stage {
  float r[CHUNK * K];
  float k[CHUNK * K];
  float w[CHUNK * K];
  float v[CHUNK * COLS];
};

// Issue the copies of steps [t0, t0 + n) into `st`: r, k, w rows whole,
// v only the block's columns.
template <int K, int COLS, int NT>
__device__ __forceinline__ void stage_chunk(
    Stage<K, COLS>& st, const float* r, const float* k, const float* w,
    const float* v, size_t row_k, size_t row_v, int col0, int t0, int n,
    int V) {
  const int tid = threadIdx.x;
  const size_t base = row_k + (size_t)t0 * K;
  for (int q = tid; q < n * K / 4; q += NT) {
    cp_async16(st.r + 4 * q, r + base + 4 * q);
    cp_async16(st.k + 4 * q, k + base + 4 * q);
    cp_async16(st.w + 4 * q, w + base + 4 * q);
  }
  for (int q = tid; q < n * COLS / 4; q += NT) {
    const int tt = q / (COLS / 4), c4 = 4 * (q - tt * (COLS / 4));
    cp_async16(st.v + tt * COLS + c4,
               v + row_v + (size_t)(t0 + tt) * V + col0 + c4);
  }
  cp_async_commit();
}

// y for the n steps of a chunk from t0: the row groups' partials summed in
// group order, 16-byte stores.
template <int K, int COLS, int NT>
__device__ __forceinline__ void reduce_chunk(const float* yb, float* y,
                                             size_t row_v, int col0, int t0,
                                             int n, int V) {
  constexpr int G = K / ROWS;
  for (int q = threadIdx.x; q < n * COLS / 4; q += NT) {
    const int tt = q / (COLS / 4), c4 = 4 * (q - tt * (COLS / 4));
    float4 s = *reinterpret_cast<const float4*>(yb + tt * COLS + c4);
#pragma unroll
    for (int g = 1; g < G; ++g) {
      const float4 p = *reinterpret_cast<const float4*>(
          yb + (g * CHUNK + tt) * COLS + c4);
      s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
    }
    *reinterpret_cast<float4*>(y + row_v + (size_t)(t0 + tt) * V + col0 +
                               c4) = s;
  }
}

template <int K, int COLS>
__global__ void __launch_bounds__((K / ROWS) * (COLS / CPT))
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int T, int V) {
  constexpr int G = K / ROWS;                    // row groups
  constexpr int LPG = COLS / CPT;                // threads a row group
  constexpr int NT = G * LPG;
  extern __shared__ __align__(16) float smem[];
  Stage<K, COLS>* st = reinterpret_cast<Stage<K, COLS>*>(smem);
  float* ybuf = smem + 2 * (sizeof(Stage<K, COLS>) / sizeof(float));

  const int n_cb = V / COLS;
  const int bh = blockIdx.x / n_cb;
  const int col0 = (blockIdx.x - bh * n_cb) * COLS;
  const int c = CPT * (threadIdx.x % LPG);       // first column in the block
  const int g = threadIdx.x / LPG;               // row group
  const size_t row_k = (size_t)bh * T * K;       // r, k, w rows of this bh
  const size_t row_v = (size_t)bh * T * V;       // v, y rows of this bh
  const int n_chunks = (T + CHUNK - 1) / CHUNK;

  stage_chunk<K, COLS, NT>(st[0], r, k, w, v, row_k, row_v, col0, 0,
                           min(CHUNK, T), V);
  float S[ROWS][CPT], uu[ROWS];
#pragma unroll
  for (int e = 0; e < ROWS; ++e) {
    const int i = g * ROWS + e;
    const float4 s4 = *reinterpret_cast<const float4*>(
        s0 + ((size_t)bh * K + i) * V + col0 + c);
    S[e][0] = s4.x; S[e][1] = s4.y; S[e][2] = s4.z; S[e][3] = s4.w;
    uu[e] = u[(size_t)bh * K + i];
  }

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * CHUNK, n = min(CHUNK, T - t0);
    cp_async_wait_all();                         // this thread's copies of ch
    __syncthreads();                             // everyone's; ch - 1 is done
    if (ch + 1 < n_chunks)
      stage_chunk<K, COLS, NT>(st[(ch + 1) & 1], r, k, w, v, row_k, row_v,
                               col0, t0 + CHUNK, min(CHUNK, T - t0 - CHUNK),
                               V);
    if (ch > 0)
      reduce_chunk<K, COLS, NT>(ybuf + ((ch - 1) & 1) * G * CHUNK * COLS, y,
                                row_v, col0, t0 - CHUNK, CHUNK, V);

    const Stage<K, COLS>& cur = st[ch & 1];
    float* yb = ybuf + (ch & 1) * G * CHUNK * COLS + g * CHUNK * COLS;
#pragma unroll 2
    for (int tt = 0; tt < n; ++tt) {
      const float4 v4 = *reinterpret_cast<const float4*>(cur.v + tt * COLS + c);
      const float vv[CPT] = {v4.x, v4.y, v4.z, v4.w};
      const int at = tt * K + g * ROWS;          // this step's rows
      float rr[ROWS], kk[ROWS], ww[ROWS];
#pragma unroll
      for (int q = 0; q < ROWS / 4; ++q) {
        unpack4(*reinterpret_cast<const float4*>(cur.r + at + 4 * q), rr + 4 * q);
        unpack4(*reinterpret_cast<const float4*>(cur.k + at + 4 * q), kk + 4 * q);
        unpack4(*reinterpret_cast<const float4*>(cur.w + at + 4 * q), ww + 4 * q);
      }
      float acc[CPT] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < ROWS; ++e) {
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          const float kv = kk[e] * vv[cc];
          acc[cc] = fmaf(rr[e], fmaf(uu[e], kv, S[e][cc]), acc[cc]);
          S[e][cc] = fmaf(ww[e], S[e][cc], kv);
        }
      }
      *reinterpret_cast<float4*>(yb + tt * COLS + c) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  }
  __syncthreads();
  reduce_chunk<K, COLS, NT>(ybuf + ((n_chunks - 1) & 1) * G * CHUNK * COLS, y,
                            row_v, col0, (n_chunks - 1) * CHUNK,
                            T - (n_chunks - 1) * CHUNK, V);
#pragma unroll
  for (int e = 0; e < ROWS; ++e)
    *reinterpret_cast<float4*>(s_out + ((size_t)bh * K + g * ROWS + e) * V +
                               col0 + c) =
        make_float4(S[e][0], S[e][1], S[e][2], S[e][3]);
}

template <int K, int COLS>
cudaError_t launch_kc(const float* r, const float* k, const float* v,
                      const float* w, const float* u, const float* s0,
                      float* y, float* s_out, int bh, int T, int V,
                      cudaStream_t stream) {
  const int bytes = smem_floats(K, V) * (int)sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel<K, COLS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
  }
  wkv6_kernel<K, COLS><<<bh * (V / COLS), threads_of(K, V), bytes, stream>>>(
      r, k, v, w, u, s0, y, s_out, T, V);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_k(const float* r, const float* k, const float* v,
                     const float* w, const float* u, const float* s0,
                     float* y, float* s_out, int bh, int T, int V,
                     cudaStream_t stream) {
  if (V == 16)
    return launch_kc<K, 16>(r, k, v, w, u, s0, y, s_out, bh, T, V, stream);
  return launch_kc<K, 32>(r, k, v, w, u, s0, y, s_out, bh, T, V, stream);
}

}  // namespace

extern "C" {

// The launch plan of (K, V): threads a block, state columns a block, bytes
// of dynamic shared memory, steps a chunk. Returns 0, or
// cudaErrorInvalidValue for a K or V outside {16, 32, 64}.
int wkv6_plan(int K, int V, int* threads, int* cols, int* smem_bytes,
              int* chunk) {
  if ((K != 16 && K != 32 && K != 64) || (V != 16 && V != 32 && V != 64))
    return (int)cudaErrorInvalidValue;
  *threads = threads_of(K, V);
  *cols = cols_of(V);
  *smem_bytes = smem_floats(K, V) * (int)sizeof(float);
  *chunk = CHUNK;
  return 0;
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launch the kernel on `stream`: r, k, w (bh, T, K), v and y (bh, T, V),
// u (bh, K), s0 and s_out (bh, K, V), all float32, contiguous and 16-byte
// aligned (checked by the caller). Returns the CUDA error code of the
// launch; cudaErrorInvalidValue for a K or V outside {16, 32, 64}.
int wkv6_launch(const float* r, const float* k, const float* v,
                const float* w, const float* u, const float* s0, float* y,
                float* s_out, int bh, int T, int K, int V, void* stream) {
  if ((V != 16 && V != 32 && V != 64) || bh < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 16: return (int)launch_k<16>(r, k, v, w, u, s0, y, s_out, bh, T, V, st);
    case 32: return (int)launch_k<32>(r, k, v, w, u, s0, y, s_out, bh, T, V, st);
    case 64: return (int)launch_k<64>(r, k, v, w, u, s0, y, s_out, bh, T, V, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

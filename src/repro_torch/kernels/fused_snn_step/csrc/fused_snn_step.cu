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
// Design. One CTA owns a tile of `block_b` lanes by `tile_n` output columns
// (the TPU kernel's (block_b, block_n) grid) for the whole T loop: no grid
// axis over T, so V never leaves the CTA. The W column tile sits in shared
// memory at its logical fan-in, transposed so that a thread reads 4 fan-in
// rows of its column as one 32-bit word and issues __dp4a against 4 packed
// spikes; the row stride is an odd number of words, so a warp's columns hit
// different banks. Each thread keeps the V of its (lane, column) elements in
// registers (at most MAX_PER_THREAD) across all T steps. Per step the CTA
// stages the tile's spike rows in shared memory (the ragged tile's missing
// lanes and the word padding as 0), every thread accumulates and updates its
// elements and writes their spikes of step t; V goes out once at the end.
// The shared-memory layout is computed and checked by the Python binding.
//
// Bound. One call moves T*B*N_in input bytes, N_in*N_out weight bytes,
// T*B*N_out output bytes and 4*B*N_out bytes of V, and does
// 2*T*B*N_in*N_out int8 operations: at most about
// 2*N_in*N_out/(N_in + N_out) operations per byte (128 at 128 x 128), below
// the H100's int8 ridge (~590), so the function is bound by memory. At the shapes its callers use (one or a
// few CTAs, a serial T loop with two barriers per step) the kernel is in
// fact bound by latency; tensor-core MMA over many lanes and a pipelined
// spike stage are later work.
//
// Signed overflow is undefined in C++ while the reference wraps, so every
// V addition goes through uint32_t; the wrap clamp uses a mask, not C's
// truncating %.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_PER_THREAD 32

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
  int block_b;              // lanes per CTA
  int tile_n;               // output columns per CTA
  int wt_ld;                // W^T row stride in 32-bit words (odd)
  int spk_off;              // smem byte offset of the spike rows
  int spk_ld;               // spike row stride in 32-bit words (odd)
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

__device__ __forceinline__ int clamp_v(int v, int wrap) {
  if (wrap) return (int)(((uint32_t)v + 1024u) & 2047u) - 1024;
  return min(max(v, -1024), 1023);
}

__global__ void __launch_bounds__(THREADS)
fused_snn_step_kernel(const StepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * a.block_b;
  const int j0 = blockIdx.y * a.tile_n;
  const int nb = min(a.block_b, a.batch - b0);      // real lanes of the tile
  const int ncols = min(a.tile_n, a.n_out - j0);    // real columns of the tile
  const int row_bytes = a.wt_ld * 4;
  const int spk_row_bytes = a.spk_ld * 4;
  int8_t* wt = reinterpret_cast<int8_t*>(smem);
  int8_t* spk = reinterpret_cast<int8_t*>(smem + a.spk_off);
  const int32_t* wt_w = reinterpret_cast<const int32_t*>(smem);
  const int32_t* spk_w = reinterpret_cast<const int32_t*>(smem + a.spk_off);

  // the W column tile, transposed: byte k of W^T row jj is W[k, j0 + jj];
  // the fan-in padding of each row is 0
  for (int e = tid; e < a.n_in * ncols; e += THREADS) {
    const int k = e / ncols, jj = e - k * ncols;
    wt[jj * row_bytes + k] = a.w[(size_t)k * a.n_out + j0 + jj];
  }
  const int pad = row_bytes - a.n_in;
  for (int e = tid; e < ncols * pad; e += THREADS) {
    const int jj = e / pad;
    wt[jj * row_bytes + a.n_in + (e - jj * pad)] = 0;
  }

  const int n_elems = a.block_b * a.tile_n;
  const int n_words = (a.n_in + 3) >> 2;
  int v[MAX_PER_THREAD];
#pragma unroll
  for (int r = 0; r < MAX_PER_THREAD; ++r) v[r] = 0;

  for (int t = 0; t < a.timesteps; ++t) {
    // spike rows of step t; missing lanes and the word padding read as 0
    const int8_t* frame = a.spikes + ((size_t)t * a.batch + b0) * a.n_in;
    for (int e = tid; e < a.block_b * spk_row_bytes; e += THREADS) {
      const int b = e / spk_row_bytes, k = e - b * spk_row_bytes;
      spk[e] = (b < nb && k < a.n_in) ? frame[b * a.n_in + k] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MAX_PER_THREAD; ++r) {
      // the guard keeps every v[r] index a constant, so V stays in registers
      const int e = tid + r * THREADS;
      const int b = e / a.tile_n, jj = e - b * a.tile_n;
      if (e >= n_elems || b >= nb || jj >= ncols) continue;
      const int32_t* srow = spk_w + b * a.spk_ld;
      const int32_t* wrow = wt_w + jj * a.wt_ld;
      int acc = 0;
      for (int q = 0; q < n_words; ++q) acc = __dp4a(srow[q], wrow[q], acc);
      int vv = clamp_v(add_wrap(v[r], acc), a.wrap);
      if (a.neuron == NEURON_LIF) vv = clamp_v(sub_wrap(vv, a.leak), a.wrap);
      const bool fired = a.wrap ? clamp_v(sub_wrap(vv, a.threshold), 1) >= 0
                                : vv >= a.threshold;
      if (fired)
        vv = (a.neuron == NEURON_RMP)
                 ? clamp_v(sub_wrap(vv, a.threshold), a.wrap) : a.reset;
      v[r] = vv;
      a.out[((size_t)t * a.batch + b0 + b) * a.n_out + j0 + jj] = fired ? 1 : 0;
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < MAX_PER_THREAD; ++r) {
    const int e = tid + r * THREADS;
    const int b = e / a.tile_n, jj = e - b * a.tile_n;
    if (e < n_elems && b < nb && jj < ncols)
      a.v_out[(size_t)(b0 + b) * a.n_out + j0 + jj] = v[r];
  }
}

extern "C" {

int fused_snn_step_args_size() { return (int)sizeof(StepArgs); }

int fused_snn_step_threads() { return THREADS; }

int fused_snn_step_max_per_thread() { return MAX_PER_THREAD; }

const char* fused_snn_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launch the kernel on `stream` over a (grid_b, grid_n) grid with
// `smem_bytes` of dynamic shared memory (computed and checked by the
// caller). Returns the CUDA error code of the launch.
int fused_snn_step_launch(const StepArgs* args, int grid_b, int grid_n,
                          int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_snn_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  fused_snn_step_kernel<<<dim3(grid_b, grid_n), THREADS, smem_bytes,
                          (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

}  // extern "C"

// K2: the reference migration exchange (src/migration.jl:11-91), launched
// by the sampler before each K1 window whose first iteration's gate its
// plan finds open (the gates are a pure function of the Philox counter),
// and still gated on the device-side flag K1 wrote the iteration before:
// a plan that disagreed with the device would show as a difference from
// one-iteration launches, never as a silent skip.
//
// Replaces the TPU kernel's in-kernel migration, demcmc_tpu/ops/
// fused_step.py _mig_apply_sorted (:946) with _rank_cycle (:763) -- and
// its [G, G] one-hot fallback _mig_apply (:563) -- reached through
// build_fused_step under pl.when(fire) (:2061-2101) and standalone through
// build_migration_kernel (:1144).  Semantics, draw for draw:
//   * group g's sort key is the uniform of its leader chain's word in row 0;
//     groups rank by (key, group index) ascending;
//   * N = 2 + (word of row 1, chain 0) mod (G - 1) groups are active;
//   * each group's victim is argmax(gumbel - w), first index on ties, with
//     gumbel = -log(-log(max(u, FLT_MIN))) from its chain's row-2 word;
//   * rank r < N receives the victim of rank (r - 1) mod N; theta and w
//     move as exact copies (+-inf included).  Like the TPU kernel's
//     additive victim broadcast, a victim value passes through "+ 0.0f",
//     which turns -0.0 into +0.0 and leaves every other value unchanged.
//
// Design: one CTA.  Keys and group indices sit in shared memory and are
// ordered by a bitonic sort (G up to 8,192, padded to a power of two with
// +inf keys); victims are found and staged in shared memory before any
// write, so a group's slot can be both read and overwritten in one pass.
// What bounds it on an H100: the exchange touches (D + 1) floats of at most
// 2G chains plus G log^2 G compare-exchanges in shared memory -- a few
// microseconds at G = 256 and only on the alpha = 0.1 share of iterations
// that fire; an unfired launch returns after reading one int.  Launch
// latency dominates; the flag stays on the device so the host loop never
// synchronises.
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

#include "philox.cuh"

namespace demcmc {

constexpr size_t kMaxSmem = 232448;  // H100 per-block shared memory

__global__ void migrate_kernel(float* theta, float* w, const int* fire,
                               WordSource W, int G, int Np, int D, int P) {
  if (*fire == 0) return;
  extern __shared__ float smem[];
  float* key = smem;                      // [P] sort keys
  int* idx = (int*)(key + P);             // [P] group index, sorted along
  int* vid = idx + P;                     // [G] victim slot per group
  float* vals = (float*)(vid + G);        // [G, D + 1] victim theta, w
  const int T = blockDim.x, tid = threadIdx.x;

  for (int g = tid; g < P; g += T) {
    if (g < G) {
      key[g] = to_uni(W(0, g * Np));
      idx[g] = g;
    } else {
      key[g] = INFINITY;
      idx[g] = INT_MAX;
    }
  }
  for (int g = tid; g < G; g += T) {
    int best = 0;
    float bs = 0.0f;
    for (int q = 0; q < Np; ++q) {
      const int c = g * Np + q;
      const float gum = -logf(-logf(fmaxf(to_uni(W(2, c)), FLT_MIN)));
      const float s = gum - w[c];
      if (q == 0 || s > bs) {
        bs = s;
        best = q;
      }
    }
    vid[g] = best;
    const int c = g * Np + best;
    for (int i = 0; i < D; ++i)
      vals[g * (D + 1) + i] = theta[(size_t)c * D + i] + 0.0f;
    vals[g * (D + 1) + D] = w[c] + 0.0f;
  }
  __syncthreads();

  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P; i += T) {
        const int l = i ^ j;
        if (l > i) {
          const float ki = key[i], kl = key[l];
          const int ii = idx[i], il = idx[l];
          const bool i_after = (ki > kl) || (ki == kl && ii > il);
          if (i_after == ((i & k) == 0)) {
            key[i] = kl;
            key[l] = ki;
            idx[i] = il;
            idx[l] = ii;
          }
        }
      }
      __syncthreads();
    }
  }

  const int N = (int)(W(1, 0) % (uint32_t)(G - 1)) + 2;
  for (int r = tid; r < G; r += T) {
    const int dst = idx[r];
    const int src = r < N ? idx[(r + N - 1) % N] : dst;
    const int c = dst * Np + vid[dst];
    for (int i = 0; i < D; ++i)
      theta[(size_t)c * D + i] = vals[src * (D + 1) + i];
    w[c] = vals[src * (D + 1) + D];
  }
}

}  // namespace demcmc

// Migration of theta [G*Np, D] / w [G*Np] in place when *fire != 0; words
// from rows 0-2 of the iteration's draws (bits-in buffer [n_words, G*Np],
// or Philox(seed, it)).  Returns cudaGetLastError() after the launch.
extern "C" int migrate_f32(float* theta, float* w, const int* fire,
                           const uint32_t* bits, uint32_t seed_lo,
                           uint32_t seed_hi, int it, int G, int Np, int D,
                           void* stream) {
  if (G < 2 || G > 8192 || Np < 1 || D < 1) return (int)cudaErrorInvalidValue;
  int P = 1;
  while (P < G) P <<= 1;
  const size_t smem = (size_t)P * 8 + (size_t)G * 4 + (size_t)G * (D + 1) * 4;
  if (smem > demcmc::kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        demcmc::migrate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = P < 32 ? 32 : (P > 1024 ? 1024 : P);
  const demcmc::WordSource W{bits, G * Np, seed_lo, seed_hi, (uint32_t)it};
  demcmc::migrate_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      theta, w, fire, W, G, Np, D, P);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

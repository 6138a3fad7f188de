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
//     Every group's victim slot is rewritten: a group of rank >= N gets
//     back its own victim plus 0.0f.
//
// Two forms, bit for bit the same exchange; the wrapper (ops/migration.py)
// picks one by the chain count G Np.
//
// The one-CTA form (up to 1,024 chains): keys and group indices sit in
// shared memory and are ordered by a bitonic sort (G up to 8,192, padded to
// a power of two with +inf keys); victims are found and staged in shared
// memory before any write, so a group's slot can be both read and
// overwritten in one pass.
// At G = 4,096 this runs on one of the card's 132 SMs: 65,536 Philox blocks
// and 131,072 logf on 1,024 threads, then 78 barrier-separated sort stages.
//
// The spread form (more chains) runs the same work on every SM, as three
// launches on the stream, each returning at once when *fire is 0:
//   1. victims: L lanes of a warp a group (L = the power of two >= Np, at
//      most 32), each lane its chains q = l, l + L, ..., then a first-index
//      argmax over the lanes by shuffles (exact: it only compares).  The
//      victim rows (+ 0.0f), the victim slots and the rank keys go to a
//      scratch buffer the wrapper owns.  A key is word >> 9: to_uni is
//      exact and rising in it, so keys order as the uniforms do.
//   2. ranks by counting, no sort: rank(g) = #{h : key_h < key_g, or
//      key_h = key_g and h < g}, the sort's order.  32 groups a block and
//      32 warps over the h range, every key in shared memory and read as a
//      warp-wide broadcast; h outside the block's 32 groups lies wholly
//      before or after each of them, so one compare settles it (<= or <).
//      perm[rank] = g, and N.
//   3. scatter: a thread per (group, value) writes the victim slot from the
//      staged row of perm[(rank - 1) mod N], or its own.
// Stream-ordered launches rather than one cooperative launch: each phase
// needs the whole previous phase (all victims staged before any slot is
// written, all keys before a rank), a launch boundary is that barrier with
// no co-residency limit on the grid, and on the alpha = 0.1 share of
// iterations that fire three queued launches cost a few microseconds.
//
// What bounds it on an H100: the exchange touches (D + 1) floats of at most
// 2G chains and every w, plus a Philox block and two logf a chain -- well
// under a microsecond at G = 4,096; launch latency dominates.  The flag
// stays on the device so the host loop never synchronises.
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

#include "philox.cuh"

namespace demcmc {

constexpr size_t kMaxSmem = 232448;  // H100 per-block shared memory

// One exchange over G groups of Np chains by one CTA, on the words W
// (chain c of theta/w is W's chain c): the one-CTA form's body.
__device__ __forceinline__ void exchange_cta(float* theta, float* w,
                                             const WordSource& W, int G,
                                             int Np, int D, int P,
                                             float* smem) {
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

__global__ void migrate_kernel(float* theta, float* w, const int* fire,
                               WordSource W, int G, int Np, int D, int P) {
  if (*fire == 0) return;
  extern __shared__ float smem[];
  exchange_cta(theta, w, W, G, Np, D, P, smem);
}

// The segmented form (replicated runs): CTA r runs replication r's
// exchanges on its G groups (chains r G Np ..), words keyed by row r of
// the key table, its chain words local to the replication (local) or the
// population's.  With fire ([R], sample_replicated) one exchange where
// fire[r], on the words of iteration it; with ev (a packed run's window:
// counts [R], then the event iterations [R, E] as offsets from it) ev[r]
// exchanges in order, event j on the words of iteration it + its[r, j] in
// namespace ns.  Each exchange is the one-CTA form's, so replication r's
// result is the solo K2's on its chains, word for word.
__global__ void migrate_segments_kernel(float* theta, float* w,
                                        const int* fire, const int* ev,
                                        int E, const uint32_t* keys,
                                        uint32_t it, uint32_t ns, int local,
                                        int R, int G, int Np, int D, int P) {
  extern __shared__ float smem[];
  const int r = blockIdx.x;
  const int n_ev = fire != nullptr ? (fire[r] != 0) : ev[r];
  const size_t c0 = (size_t)r * G * Np;
  WordSource W{nullptr, G * Np, keys[2 * r], keys[2 * r + 1], it, ns,
               local ? 0u : (uint32_t)c0};
  for (int j = 0; j < n_ev; ++j) {
    if (fire == nullptr) W.it = it + (uint32_t)ev[R + r * E + j];
    exchange_cta(theta + c0 * D, w + c0, W, G, Np, D, P, smem);
    __syncthreads();  // the next event reads this one's writes
  }
}

// ---------------------------------------------------------- spread form

constexpr int kMaxGroups = 8192;  // G at most (the keys in shared memory)
constexpr int kSpreadThreads = 256;
constexpr int kRankGroups = 32;  // groups a rank block (a warp's lanes)
// warps a rank block, over the h range: 32 hide the shared-memory latency
// of each warp's compare loop (8 ran it ~30 cycles an iteration)
constexpr int kRankSplit = 32;

// The victim order of the sequential scan "q == 0 || s > best": a NaN score
// at q = 0 is kept whatever follows (class 2), a NaN later never replaces
// (class 0), else the larger score, then the smaller index.  A total order
// on the candidates, so any reduction tree gives the scan's victim.
__device__ __forceinline__ bool victim_before(int ka, float sa, int qa, int kb,
                                              float sb, int qb) {
  if (qb < 0) return qa >= 0;
  if (qa < 0) return false;
  if (ka != kb) return ka > kb;
  if (sa > sb) return true;
  if (sb > sa) return false;
  return qa < qb;
}

__global__ void __launch_bounds__(kSpreadThreads)
    migrate_victims_kernel(const float* theta, const float* w,
                           const int* fire, WordSource W, int G, int Np,
                           int D, int L, uint32_t* key, int* vid,
                           float* vals) {
  if (*fire == 0) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = t / L, l = t & (L - 1);
  const bool valid = g < G;
  int kb = 0, qb = -1;
  float sb = 0.0f;
  uint32_t w0 = 0;
  for (int q = l; valid && q < Np; q += L) {
    const int c = g * Np + q;
    ChainWords cw(W, c);
    const float gum = -logf(-logf(fmaxf(to_uni(cw(2)), FLT_MIN)));
    if (q == 0) w0 = cw(0);
    const float s = gum - w[c];
    const int k = isnan(s) ? (q == 0 ? 2 : 0) : 1;
    if (victim_before(k, s, q, kb, sb, qb)) {
      kb = k;
      sb = s;
      qb = q;
    }
  }
  // the whole warp is here (full blocks): the L lanes of a group reduce
  for (int o = L >> 1; o > 0; o >>= 1) {
    const int k = __shfl_xor_sync(0xFFFFFFFFu, kb, o, L);
    const float s = __shfl_xor_sync(0xFFFFFFFFu, sb, o, L);
    const int q = __shfl_xor_sync(0xFFFFFFFFu, qb, o, L);
    if (victim_before(k, s, q, kb, sb, qb)) {
      kb = k;
      sb = s;
      qb = q;
    }
  }
  if (!valid) return;
  const size_t c = (size_t)g * Np + qb;
  float* row = vals + (size_t)g * (D + 1);
  for (int i = l; i < D; i += L) row[i] = theta[c * D + i] + 0.0f;
  if (l == 0) {
    row[D] = w[c] + 0.0f;
    vid[g] = qb;
    key[g] = w0 >> 9;
  }
}

__global__ void __launch_bounds__(kRankGroups * kRankSplit)
    migrate_rank_kernel(const int* fire, WordSource W, int G,
                        const uint32_t* key, int* rank, int* perm,
                        int* n_active) {
  if (*fire == 0) return;
  __shared__ __align__(16) uint32_t sk[kMaxGroups];
  __shared__ int part[kRankSplit][kRankGroups];
  // every key into shared memory, 16 bytes a load, the loads of a thread
  // issued together
  const int n4 = G >> 2;
#pragma unroll 8
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    reinterpret_cast<uint4*>(sk)[i] = reinterpret_cast<const uint4*>(key)[i];
  for (int h = 4 * n4 + threadIdx.x; h < G; h += blockDim.x) sk[h] = key[h];
  __syncthreads();
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * kRankGroups, g = t0 + lane;
  const uint32_t kg = g < G ? sk[g] : 0xFFFFFFFFu;
  const int chunk = (G + kRankSplit - 1) / kRankSplit;
  const int h0 = min(G, wp * chunk), h1 = min(G, h0 + chunk);
  // the warp's h below the block's groups all precede g (a tie counts),
  // those above all follow it (a tie does not): one compare each
  const int a = min(h1, max(h0, t0));
  const int b = max(a, min(h1, t0 + kRankGroups));
  int cnt = 0;
#pragma unroll 8
  for (int h = h0; h < a; ++h) cnt += sk[h] <= kg;
  for (int h = a; h < b; ++h) {
    const uint32_t kh = sk[h];
    cnt += kh < kg || (kh == kg && h < g);
  }
#pragma unroll 8
  for (int h = b; h < h1; ++h) cnt += sk[h] < kg;
  part[wp][lane] = cnt;
  __syncthreads();
  if (wp == 0 && g < G) {
    int r = 0;
    for (int k = 0; k < kRankSplit; ++k) r += part[k][lane];
    rank[g] = r;
    perm[r] = g;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *n_active = (int)(W(1, 0) % (uint32_t)(G - 1)) + 2;
}

__global__ void __launch_bounds__(kSpreadThreads)
    migrate_scatter_kernel(float* theta, float* w, const int* fire, int G,
                           int Np, int D, const int* vid, const int* rank,
                           const int* perm, const int* n_active,
                           const float* vals) {
  if (*fire == 0) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = t / (D + 1), i = t - g * (D + 1);
  if (g >= G) return;
  const int N = *n_active, r = rank[g];
  const int src = r < N ? perm[(r + N - 1) % N] : g;
  const float v = vals[(size_t)src * (D + 1) + i];
  const size_t c = (size_t)g * Np + vid[g];
  if (i < D)
    theta[c * D + i] = v;
  else
    w[c] = v;
}

// Bytes of the spread form's scratch: keys [G] uint32, victim slots, ranks
// and perm [G] int, N, then the victim rows [G, D + 1] float.
__host__ __device__ constexpr size_t scratch_bytes(int G, int D) {
  return ((size_t)G * 4 + 1) * 4 + (size_t)G * (D + 1) * 4;
}

}  // namespace demcmc

extern "C" int migrate_scratch_bytes(int G, int D) {
  return (int)demcmc::scratch_bytes(G, D);
}

// Migration of theta [G*Np, D] / w [G*Np] in place when *fire != 0; words
// from rows 0-2 of the iteration's draws (bits-in buffer [n_words, G*Np],
// or Philox(seed, it)).  spread != 0: the spread form, on `scratch`
// (migrate_scratch_bytes(G, D) bytes, 16-byte aligned); else the one-CTA
// form.  Returns cudaGetLastError() after the launches.
extern "C" int migrate_f32(float* theta, float* w, const int* fire,
                           const uint32_t* bits, uint32_t seed_lo,
                           uint32_t seed_hi, int it, int G, int Np, int D,
                           void* scratch, int spread, void* stream) {
  if (G < 2 || G > demcmc::kMaxGroups || Np < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const demcmc::WordSource W{bits, G * Np, seed_lo, seed_hi, (uint32_t)it};
  const cudaStream_t st = (cudaStream_t)stream;
  if (spread) {
    if (scratch == nullptr || ((uintptr_t)scratch & 15u))
      return (int)cudaErrorInvalidValue;
    uint32_t* key = (uint32_t*)scratch;
    int* vid = (int*)(key + G);
    int* rank = vid + G;
    int* perm = rank + G;
    int* n_active = perm + G;
    float* vals = (float*)(n_active + 1);
    int L = 1;
    while (L < Np && L < 32) L <<= 1;
    const int T = demcmc::kSpreadThreads;
    demcmc::migrate_victims_kernel<<<(G * L + T - 1) / T, T, 0, st>>>(
        theta, w, fire, W, G, Np, D, L, key, vid, vals);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    demcmc::migrate_rank_kernel<<<(G + demcmc::kRankGroups - 1) /
                                      demcmc::kRankGroups,
                                  demcmc::kRankGroups * demcmc::kRankSplit, 0,
                                  st>>>(fire, W, G, key, rank, perm,
                                        n_active);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int n = G * (D + 1);
    demcmc::migrate_scatter_kernel<<<(n + T - 1) / T, T, 0, st>>>(
        theta, w, fire, G, Np, D, vid, rank, perm, n_active, vals);
    return (int)cudaGetLastError();
  }
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
  demcmc::migrate_kernel<<<1, threads, smem, st>>>(theta, w, fire, W, G, Np,
                                                   D, P);
  return (int)cudaGetLastError();
}

// Replication-local migration of theta [R G Np, D] / w [R G Np] in place,
// one CTA a replication (the segmented form above): fire [R] (each
// replication's gate) or ev (counts [R], then [R, E] event offsets), keys
// [R, 2] uint32, the words' iteration it and namespace ns, local != 0 for
// chain words local to each replication.  A replication must fit the
// one-CTA form.  Returns cudaGetLastError() after the launch.
extern "C" int migrate_segments_f32(float* theta, float* w, const int* fire,
                                    const int* ev, int E,
                                    const uint32_t* keys, int it, int ns,
                                    int local, int R, int G, int Np, int D,
                                    void* stream) {
  if (R < 1 || G < 2 || G > demcmc::kMaxGroups || Np < 1 || D < 1 ||
      (fire == nullptr) == (ev == nullptr) || (ev != nullptr && E < 1))
    return (int)cudaErrorInvalidValue;
  int P = 1;
  while (P < G) P <<= 1;
  const size_t smem = (size_t)P * 8 + (size_t)G * 4 + (size_t)G * (D + 1) * 4;
  if (smem > demcmc::kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        demcmc::migrate_segments_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = P < 32 ? 32 : (P > 1024 ? 1024 : P);
  demcmc::migrate_segments_kernel<<<R, threads, smem,
                                    (cudaStream_t)stream>>>(
      theta, w, fire, ev, E, keys, (uint32_t)it, (uint32_t)ns, local, R, G,
      Np, D, P);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

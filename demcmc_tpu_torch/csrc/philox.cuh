// Counter-based Philox4x32-10 words for the DE kernels.
//
// Word (seed, iteration, row, chain) is lane (row & 3) of the Philox block
// with counter (chain, row >> 2, iteration, namespace) and key
// (seed & 0xffffffff, seed >> 32) -- bit for bit the plain torch version in
// demcmc_tpu_torch/rng.py.  Kernels read their words through WordSource,
// which in bits-in mode (a test mode) reads a [n_words, C] uint32 buffer
// per iteration instead, so kernel and plain version can be fed identical
// words;
// ChainWords reads one chain's rows and generates each block only once;
// several threads that share a chain (ChainLanes) each read their own
// blocks of it.
//
// The chain of a word is its index in the whole population.  A launch on
// one shard of a population split over a chain mesh holds chains chain0 ..
// of it in its own memory at 0 ..: WordSource adds chain0 to a chain of
// the launch (operator(), ChainWords), so each shard draws the columns of
// the unsharded draw; global() reads a chain by its population index (the
// migration gate, drawn from chain 0's word by every shard).  In bits-in
// mode the buffer holds the whole population's columns, C of them.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace demcmc {

constexpr uint32_t kStepNs = 0;      // rng.STEP_NS
constexpr uint32_t kResampleNs = 3;  // rng.RESAMPLE_NS

// The Philox4x32-10 block with counter (chain, blk, it, ns): the words of
// rows 4 blk .. 4 blk + 3.
__device__ __forceinline__ uint4 philox_block(uint32_t k0, uint32_t k1,
                                              uint32_t it, uint32_t blk,
                                              uint32_t chain, uint32_t ns) {
  uint32_t c0 = chain, c1 = blk, c2 = it, c3 = ns;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t lane(const uint4& b, uint32_t row) {
  switch (row & 3u) {
    case 0: return b.x;
    case 1: return b.y;
    case 2: return b.z;
    default: return b.w;
  }
}

__device__ __forceinline__ uint32_t philox_word(uint32_t k0, uint32_t k1,
                                                uint32_t it, uint32_t row,
                                                uint32_t chain, uint32_t ns) {
  return lane(philox_block(k0, k1, it, row >> 2, chain, ns), row);
}

// The TPU kernel's bit-to-uniform map: 23 mantissa bits, [0, 1).
__device__ __forceinline__ float to_uni(uint32_t b) {
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

struct WordSource {
  const uint32_t* bits;  // [n_words, C] in bits-in mode, else nullptr
  int C;                 // the population's chains (a row of bits)
  uint32_t k0, k1, it;
  uint32_t ns = kStepNs;  // Philox namespace
  uint32_t chain0 = 0;    // the launch's first chain in the population

  // word (row, chain) of the population's chain
  __device__ __forceinline__ uint32_t global(int row, uint32_t chain) const {
    if (bits != nullptr) return bits[(size_t)row * C + chain];
    return philox_word(k0, k1, it, (uint32_t)row, chain, ns);
  }

  // word (row, chain) of the launch's chain
  __device__ __forceinline__ uint32_t operator()(int row, int chain) const {
    return global(row, chain0 + (uint32_t)chain);
  }

  // The words of iteration it_k, the k-th of a window: Philox counter it_k,
  // or in bits-in mode the k-th [n_words, C] block of a [K n_words, C]
  // buffer.
  __device__ __forceinline__ WordSource at(int k, uint32_t it_k,
                                           int n_words) const {
    WordSource s = *this;
    s.it = it_k;
    if (bits != nullptr) s.bits = bits + (size_t)k * n_words * C;
    return s;
  }
};

// The words of one chain, read in rising row order: in Philox mode each
// block of four rows is generated once and its lanes are reused.
struct ChainWords {
  const WordSource& src;
  uint32_t chain;  // in the population
  uint32_t blk = 0xFFFFFFFFu;
  uint4 cur;

  // chain c of the launch
  __device__ __forceinline__ ChainWords(const WordSource& s, int c)
      : src(s), chain(s.chain0 + (uint32_t)c) {}

  __device__ __forceinline__ uint32_t operator()(int row) {
    if (src.bits != nullptr) return src.bits[(size_t)row * src.C + chain];
    const uint32_t b = (uint32_t)row >> 2;
    if (b != blk) {
      blk = b;
      cur = philox_block(src.k0, src.k1, src.it, b, chain, src.ns);
    }
    return lane(cur, (uint32_t)row);
  }

  // rows 4 b .. 4 b + 3 at once (all four must lie in the buffer in
  // bits-in mode); the row cache is left as it is
  __device__ __forceinline__ uint4 block(uint32_t b) const {
    if (src.bits != nullptr) {
      const uint32_t* p = src.bits + (size_t)(4u * b) * src.C + chain;
      return make_uint4(p[0], p[src.C], p[2 * (size_t)src.C],
                        p[3 * (size_t)src.C]);
    }
    return philox_block(src.k0, src.k1, src.it, b, chain, src.ns);
  }
};

// The n adjacent threads of one warp that share a chain (n a power of two,
// at most 32): this thread's lane, n, and the warp mask of the n threads.
struct ChainLanes {
  int lane, n;
  unsigned mask;

  // the sum of v over the n lanes, in every lane
  __device__ __forceinline__ int sum(int v) const {
    for (int o = n >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o, n);
    return v;
  }
};

}  // namespace demcmc

// Definitions shared by the shared-L2 engine's kernels (shl2_requester,
// shl2_home_start, shl2_requester_fill).
//
// Replaces the shared-L2 constants and packed-entry helpers of
// graphite_tpu/memory/engine_shl2.py (:95-131: DATA_INVALID,
// DIR_EXCLUSIVE, the embedded directory word's fields) and
// graphite_tpu/memory/state.py:51 (MSG_EXCL_REP).  Plain versions:
// graphite_tpu_torch/memory/{state,common}.py.
#pragma once

#include "mem_common.cuh"

// the plain values every shared-L2 kernel's argument block holds before
// `MemConsts` (graphite_tpu_torch/ops/shl2_requester.py `shl2_values`)
struct Shl2Consts {
    int64_t mesi;          // 1: pr_l1_sh_l2_mesi
    int64_t sync_l1_net;   // L1-D -> MEMORY net synchronization, cycles
};

#define MSG_EXCL_REP 12
#define DIR_EXCLUSIVE 4
#define ST_EXCLUSIVE 3
#define DATA_INVALID 5     // the slice's line while its DRAM fetch flies
#define SHL2_ID_MASK ((1LL << 13) - 1)
#define SHL2_OWNER_SHIFT 3
#define SHL2_NSH_SHIFT 16

// the embedded directory word: bits 0..2 state, 3..15 owner + 1,
// 16..28 sharer count, 29..30 the caching component (kept by every
// write below)
__device__ __forceinline__ int sw_state(int64_t w) { return (int)(w & 7); }
__device__ __forceinline__ int32_t sw_owner(int64_t w) {
    return (int32_t)((w >> SHL2_OWNER_SHIFT) & SHL2_ID_MASK) - 1;
}
__device__ __forceinline__ int32_t sw_nsh(int64_t w) {
    return (int32_t)((w >> SHL2_NSH_SHIFT) & SHL2_ID_MASK);
}
__device__ __forceinline__ int64_t sw_set(int64_t w, int st, int64_t owner,
                                          int64_t nsh) {
    const int64_t keep = ~(7LL | (SHL2_ID_MASK << SHL2_OWNER_SHIFT) |
                           (SHL2_ID_MASK << SHL2_NSH_SHIFT));
    return (w & keep) | (st & 7) |
           (((owner + 1) & SHL2_ID_MASK) << SHL2_OWNER_SHIFT) |
           ((nsh & SHL2_ID_MASK) << SHL2_NSH_SHIFT);
}
__device__ __forceinline__ int64_t sw_set_nsh(int64_t w, int64_t nsh) {
    return (w & ~(SHL2_ID_MASK << SHL2_NSH_SHIFT)) |
           ((nsh & SHL2_ID_MASK) << SHL2_NSH_SHIFT);
}

// bit b of a sharer row's int32 words (uint32 bit patterns)
__device__ __forceinline__ bool bit_test(const int32_t* w, int b) {
    return ((uint32_t)w[b / 32] >> (b % 32)) & 1u;
}

// Queue-model pieces shared by the contention-NoC kernels (noc_route,
// atac_route): the packed [N, 10] queue columns, the M/G/1 waiting time,
// and the network-clock conversions.
//
// Plain versions: graphite_tpu_torch/models/queue_models.py and
// graphite_tpu_torch/time_types.py.
#pragma once

#include "common.cuh"

// QueueArrays.data columns (models/queue_models.py COL_*)
#define COL_QT 0
#define COL_WS 1
#define COL_NEWEST 2
#define COL_SUM_ST 3
#define COL_SUM_ST2 4
#define COL_N_ARR 5
#define COL_REQS 6
#define COL_UTIL 7
#define COL_DELAY 8
#define COL_ANA 9
#define N_COLS 10

// `_mg1_wait` (queue_model_m_g_1.cc:18-47) in float64.  Every product,
// sum and quotient is a separately rounded IEEE operation in the order of
// the JAX expression: nvcc would otherwise contract a*b + c into one
// fused multiply-add, which XLA's and PyTorch's CPU code do not.
__device__ __forceinline__ double max_d(double a, double b) {
    return a > b ? a : b;      // NaN never reaches here: integer moments
}

__device__ int64_t mg1_wait(int64_t n_arrivals, int64_t sum_st,
                            int64_t sum_st2, int64_t newest) {
    if (n_arrivals <= 0) return 0;
    const double n = (double)n_arrivals;
    const double mean = __ddiv_rn((double)sum_st, n);
    const double var = __dsub_rn(__ddiv_rn((double)sum_st2, n),
                                 __dmul_rn(mean, mean));
    const double service = __ddiv_rn(1.0, max_d(mean, 1e-12));
    double arrival = __ddiv_rn(n, max_d((double)newest, 1e-12));
    const double cap = __dmul_rn(0.999, service);
    arrival = arrival < cap ? arrival : cap;
    const double num = __dmul_rn(
        __dmul_rn(__dmul_rn(0.5, service), arrival),
        __dadd_rn(__ddiv_rn(1.0, __dmul_rn(service, service)), var));
    return (int64_t)ceil(__ddiv_rn(num, __dsub_rn(service, arrival)));
}

// Latency::toPicosec / Time::toCycles on the network clock
__device__ __forceinline__ int64_t cyc_to_ps(int64_t cycles, int64_t f) {
    return ceil_div_i64(cycles * 1000000, f);
}

__device__ __forceinline__ int64_t ps_to_cyc(int64_t ps, int64_t f) {
    return ceil_div_i64(ps * f, 1000000);
}

// floor division (Python `//`) of int64, b > 0
__device__ __forceinline__ int64_t floor_div_i64(int64_t a, int64_t b) {
    int64_t q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}

// mem_net_route: one set of coherence messages through the MEMORY net's
// contention model, in packet form — the routes of the memory engine's
// plain phases 4 (the sharers' INV / FLUSH / WB acks) and 5 (the homes'
// replies), captured in their CUDA graphs.
//
// Replaces (XLA unit): graphite_tpu/memory/engine.py `mem_net_send`
// (:251-277) as :1975 and :2175 call it, over graphite_tpu/models/
// network_hop_by_hop.py `route_hop_by_hop` (:123-185, `_dense_contention`
// :188-377) under `memory = emesh_hop_by_hop` and graphite_tpu/models/
// network_atac.py `route_atac` (:176-243) under `memory = atac`.  Plain
// version: graphite_tpu_torch/memory/net.py mem_net_send (wrapper
// ops/mem_net_route.py).
//
// Per packet i (src, dst, bits, t0, mask): the arrival in ps (t0 for a
// packet masked out or while models are off), the queues committed in
// place.  Design: one CTA, a thread a packet (at most 1,024), the route of
// net_route.cuh (`hbh_send`: the walk's reductions into a global scratch,
// a barrier, the fold; `atac_send`: the hub rows staged in shared
// memory), so that it captures into a CUDA graph as a plain launch.
//
// Bound: bytes.  Five inputs and one output a packet, each touched queue
// row read and written once: ~50 KB at T = 1024 if every tile sends
// (~15 ns at 3.35 TB/s); one CTA's chain of round trips (the inputs, the
// path's rows, the barrier, the accumulators, the rows) and the launch
// set its time.
#include "mem_common.cuh"

#define MAX_PACKETS 1024

// Argument block = graphite_tpu_torch/ops/mem_net_route.py `_pack`.
struct RouteArgs {
    const int64_t* src;
    const int64_t* dst;
    const int64_t* bits;
    const int64_t* t0;
    const bool* mask;
    const bool* enabled;
    int64_t* arrival;
    int64_t T, kind;
    NetConsts n;
};

template <int NET>
__global__ void __launch_bounds__(MAX_PACKETS)
mem_net_route_kernel(const RouteArgs a) {
    extern __shared__ long long net_rows[];
    const int T = (int)a.T;
    const int i = threadIdx.x;
    const bool valid = i < T;
    const int u = valid ? i : 0;
    const int src = (int)a.src[u];
    const int dst = min(max((int)a.dst[u], 0), T - 1);
    const int64_t bits = a.bits[u], t0 = a.t0[u];
    const bool mask = valid && a.mask[u];
    const bool en = *a.enabled;
    int64_t arrival;
    if constexpr (NET == NET_HBH) {
        arrival = hbh_send(a.n, src, dst, bits, t0, mask && en);
    } else {
        arrival = atac_send(a.n, net_rows, valid, src, dst, bits, t0, mask,
                            en);
    }
    if (valid) a.arrival[i] = arrival;
}

template <int NET>
static int launch(const RouteArgs* args, cudaStream_t stream) {
    const int T = (int)args->T;
    const size_t smem = net_smem(NET, args->n);
    static size_t smem_set = 0;    // the opt-in beyond the static default
    if (smem > smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            mem_net_route_kernel<NET>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_set = smem;
    }
    mem_net_route_kernel<NET><<<1, (T + 31) / 32 * 32, smem, stream>>>(
        *args);
    return (int)cudaGetLastError();
}

extern "C" int gt_mem_net_route(const RouteArgs* args, cudaStream_t stream) {
    static_assert(sizeof(RouteArgs) == (7 + 2 + 22) * 8,
                  "RouteArgs: 7 pointers, T, kind and NetConsts");
    if (args->kind == NET_ATAC) return launch<NET_ATAC>(args, stream);
    return launch<NET_HBH>(args, stream);
}
